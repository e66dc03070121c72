"""PyTorch port: static FP8 weights against JAX.

``quantize_params`` turns the eligible matmul weights into FP8 codes with
one scale each.  The reference quantizes its stacked block weights per
block; the port quantizes each layer's tensor per tensor, and the codes
and scales must be the same, bit for bit.  Integer results (codes,
scales, decoded weights) are compared bitwise; float32 matmul sums within
rtol = atol = 1e-6 of their magnitude (the exact products summed in
another order); token streams of the Engine exactly (greedy sampling on
float32 parameters, whose logits agree to ~1e-5, far inside the random
models' top-2 gaps).  JAX's quantized matmuls run as the JAX package's own
tests run them on the CPU (Pallas in interpret mode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as jnumerics
from repro.configs import get_config as jget_config
from repro.core.quant import QTensor as JQTensor
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro.models.quantize import quantize_params as jquantize_params
from repro.models.quantize import resolve_weight as jresolve_weight
from repro.numerics import OpPolicy as JOpPolicy
from repro.numerics import Override as JOverride
from repro.numerics import get_policy as jget_policy
from repro_torch import numerics
from repro_torch.configs import get_config
from repro_torch.core.quant import QTensor
from repro_torch.kernels import lns_matmul as lm
from repro_torch.launch import serve
from repro_torch.models import params_from_jax
from repro_torch.models.quantize import (QUANT_WEIGHT_NAMES, as_qtensor,
                                         quantize_params, resolve_weight)
from repro_torch.numerics import OpPolicy, Override, get_policy

ARCHS = ["qwen2-0.5b", "qwen3-14b", "gemma2-27b", "gemma3-12b"]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _assert_trees_bitwise(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    n_q = 0
    for path, x in la.items():
        y = lb[path]
        assert isinstance(x, QTensor) == isinstance(y, QTensor), path
        if isinstance(x, QTensor):
            n_q += 1
            assert x.fmt == y.fmt, path
            assert torch.equal(x.codes, y.codes), path
            assert x.scale.shape == y.scale.shape == (), path
            assert torch.equal(x.scale, y.scale), path
        else:
            assert torch.equal(x, y), path
    return n_q


def _weights_policies():
    """serve_fp8_paged (E4M3 weights) and one whose weights override puts
    the MLP of pattern position 1 in E5M2, which names the sites."""
    site = JOverride("weights", "blocks.1.ffn.*",
                     JOpPolicy(fmt="e5m2", mode="rne", impl="auto",
                               accum="bf16"))
    jmixed = jget_policy("serve_fp8_paged").replace(
        name="mixed", overrides=(site,))
    mixed = get_policy("serve_fp8_paged").replace(
        name="mixed", overrides=(Override(
            "weights", "blocks.1.ffn.*",
            OpPolicy(fmt="e5m2", mode="rne", impl="auto", accum="bf16")),))
    return [(jget_policy("serve_fp8_paged"), get_policy("serve_fp8_paged")),
            (jmixed, mixed), ("e5m2", "e5m2"), (None, None)]


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_per_layer_equals_reference_per_block(arch, which):
    """Codes and scales bitwise: the port's per-layer quantization of each
    layer against the reference's per-block quantization of the stacked
    tree, carried across by ``params_from_jax``."""
    jpol, pol = _weights_policies()[which]
    jcfg = jget_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(3))
    want = params_from_jax(
        jax.tree.map(np.asarray, jquantize_params(jparams, jpol)), cfg)
    got = quantize_params(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg), pol,
                          period=cfg.layer_pattern_period)
    n_q = _assert_trees_bitwise(got, want)
    assert n_q == 7 * cfg.n_layers + (0 if cfg.tie_embeddings else 1)
    assert not isinstance(got["embed"], QTensor)
    if which == 1:  # the override reaches pattern position 1 only
        period = cfg.layer_pattern_period
        for i, layer in enumerate(got["blocks"]):
            fmt = "e5m2" if i % period == 1 else "e4m3"
            assert layer["ffn"]["w_up"].fmt == fmt
            assert layer["attn"]["wq"].fmt == "e4m3"


def test_quantize_params_names_the_reference_weights():
    from repro.models.quantize import QUANT_WEIGHT_NAMES as JNAMES

    assert QUANT_WEIGHT_NAMES == JNAMES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_resolve_and_dequantize_weight_bitwise(fmt, dtype):
    """``resolve_weight`` of a QTensor and of the legacy {"codes", "scale"}
    dict, and ``numerics.dequantize_weight`` (the dict's format from the
    policy), bitwise equal to the reference's; plain tensors pass
    through."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((48, 40)) * 0.3).astype(np.float32)
    codes = rng.integers(0, 256, size=(48, 40)).astype(np.uint8)
    jq = jnumerics_quantize(w, fmt)
    q = QTensor(codes=torch.from_numpy(np.array(jq.codes)),
                scale=torch.from_numpy(np.array(jq.scale)), fmt=fmt)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def same(got, want):
        want = np.asarray(want.astype(jnp.float32))
        assert np.array_equal(got.to(torch.float32).numpy(), want)

    same(resolve_weight(q, dtype=tdt), jresolve_weight(jq, dtype=jdt))
    # every code, subnormal, NaN and inf patterns included
    jraw = {"codes": jnp.asarray(codes), "scale": jnp.float32(0.125)}
    raw = {"codes": torch.from_numpy(codes), "scale": torch.tensor(0.125)}
    same(resolve_weight(raw, fmt, tdt), jresolve_weight(jraw, fmt, jdt))
    same(resolve_weight(raw, dtype=tdt), jresolve_weight(jraw, dtype=jdt))
    jpol = jget_policy("serve_fp8_paged").replace(weights=JOpPolicy(
        fmt=fmt, mode="rne", impl="auto", accum="bf16"))
    pol = get_policy("serve_fp8_paged").replace(weights=OpPolicy(
        fmt=fmt, mode="rne", impl="auto", accum="bf16"))
    same(numerics.dequantize_weight(raw, pol, tdt),
         jnumerics.dequantize_weight(jraw, jpol, jdt))
    same(numerics.dequantize_weight(q, None, tdt),
         jnumerics.dequantize_weight(jq, None, jdt))
    assert numerics.is_quantized_weight(q) and numerics.is_quantized_weight(raw)
    plain = torch.from_numpy(w)
    assert not numerics.is_quantized_weight(plain)
    assert resolve_weight(plain) is plain
    assert numerics.dequantize_weight(plain, pol) is plain


def jnumerics_quantize(w, fmt):
    from repro.core.quant import quantize

    return quantize(jnp.asarray(w), fmt)


def _matmul_policy(impl):
    kw = dict(fmt="e4m3", mode="rne", impl=impl, accum="f32")
    return (jget_policy("serve_fp8_paged").replace(matmul=JOpPolicy(**kw)),
            get_policy("serve_fp8_paged").replace(matmul=OpPolicy(**kw)))


@pytest.mark.parametrize("w_fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("impl", ["xla", "lns", "lns_loop", "fused_dequant"])
def test_static_matmul_2d_matches_reference(impl, w_fmt):
    """``static_matmul_2d`` under an E4M3 matmul policy: x quantized per
    tensor (in an E5M2 weight's format for the single-format LNS products,
    mixed formats otherwise), multiplied against the stored codes; on the
    CPU the port runs each kernel's plain version.  float32 sums within
    rtol = atol = 1e-6 of the output's magnitude."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) * 0.2).astype(np.float32)
    jq = jnumerics_quantize(w, w_fmt)
    q = QTensor(codes=torch.from_numpy(np.array(jq.codes)),
                scale=torch.from_numpy(np.array(jq.scale)), fmt=w_fmt)
    jpol, pol = _matmul_policy(impl)
    want = np.asarray(jnumerics.api.static_matmul_2d(jnp.asarray(x), jq,
                                                     jpol))
    got = numerics.static_matmul_2d(torch.from_numpy(x), q, pol).numpy()
    tol = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=tol)
    # the legacy dict carrier, through the one converter, in the
    # policy's weight format (E4M3 under serve_fp8_paged)
    raw = {"codes": q.codes, "scale": q.scale}
    assert as_qtensor(q) is q
    assert as_qtensor(raw, w_fmt).fmt == w_fmt
    assert as_qtensor(raw).fmt == "e4m3"
    if w_fmt == "e4m3":
        assert np.array_equal(
            numerics.matmul(torch.from_numpy(x), raw, pol).numpy(), got)
    # through the one matmul entry point, bias and dtype included
    b = torch.ones(40)
    y = numerics.matmul(torch.from_numpy(x)[None], q, pol, bias=b)
    assert y.shape == (1, 5, 40) and y.dtype == torch.float32
    assert torch.equal(y[0], torch.from_numpy(got) + b)


def test_static_matmul_reaches_the_kernels_launch_path(monkeypatch):
    """Under ``fused_dequant`` and ``lns`` the stored codes go through
    ``lns_matmul``'s K2/K3 entry (its plain version for CPU tensors) with
    the per-layer scalar scale; an unquantized matmul decodes instead."""
    seen = []
    real = lm.lns_matmul

    def spy(x, w, **kw):
        seen.append((kw["impl"], x.dtype, w.dtype, tuple(w.shape)))
        return real(x, w, **kw)

    monkeypatch.setattr("repro_torch.kernels.ops.lns_matmul", spy)
    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.standard_normal((32, 24)) * 0.1)
                         .astype(np.float32))
    q = quantize_params({"wq": w}, get_policy("serve_fp8_paged"))["wq"]
    assert q.scale.shape == ()
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    for impl in ("fused_dequant", "lns"):
        numerics.matmul(x, q, _matmul_policy(impl)[1])
    assert seen == [("fused_dequant", torch.uint8, torch.uint8, (32, 24)),
                    ("lns", torch.uint8, torch.uint8, (32, 24))]
    y = numerics.matmul(x, q, get_policy("serve_fp8_paged"))
    assert len(seen) == 2
    assert torch.equal(y, x @ resolve_weight(q, dtype=torch.float32))


def _static_engines(numerics_kw, lively, cache_impl="paged"):
    """A reference Engine whose (optionally redrawn) float32 weights are
    quantized as ``Engine(static_weights=True)`` quantizes them, and the
    port's Engine on the same codes."""
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b", smoke=True,
                                           **numerics_kw),
                               param_dtype="float32")
    jeng = jserve.Engine(jcfg, slots=2, max_seq=24, page_size=4,
                         cache_impl=cache_impl)
    if lively:
        rng = np.random.default_rng(9)
        jeng.params = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype),
            jeng.params)
    jeng.params = jquantize_params(jeng.params,
                                   jnumerics.as_policy(jcfg.policy))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True,
                                         **numerics_kw),
                              param_dtype="float32")
    eng = serve.Engine(cfg, slots=2, max_seq=24, page_size=4,
                       cache_impl=cache_impl, device="cpu")
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    return jeng, eng


QUEUE = [np.arange(3) + 5, np.arange(9) + 17, np.arange(5) + 40,
         np.arange(1) + 99]


@pytest.mark.parametrize("scheduler", ["continuous", "bucketed"])
@pytest.mark.parametrize("pages", ["fp8", "float"])
def test_static_weight_engine_streams_match_reference(pages, scheduler):
    """Static weights under the dequantizing route, on FP8 pages
    (serve_fp8_paged) and on float pages (the default policy): the port's
    token streams equal the reference Engine's."""
    numerics_kw = (dict(policy="serve_fp8_paged") if pages == "fp8"
                   else dict(quant="none"))
    jeng, eng = _static_engines(numerics_kw, lively=True)
    assert isinstance(jeng.params["blocks"][0]["attn"]["wq"], JQTensor)
    ref, _ = jserve.run(jeng, QUEUE, gen=6, chunk=4, quiet=True,
                        scheduler=scheduler)
    port, _ = serve.run(eng, QUEUE, gen=6, chunk=4, quiet=True,
                        scheduler=scheduler)
    assert any(len(set(o)) > 1 for o in ref.values())
    assert port == ref


@pytest.mark.parametrize("impl", ["fused_dequant", "lns"])
def test_static_weights_through_the_kernels_match_reference(impl):
    """Static weights under a policy that quantizes matmuls (the K2 and K3
    route; their plain versions on the CPU): the first bucketed prefill's
    logits and the next dense decode step's within rtol = atol = 2e-4 of
    the reference's (whose matmuls run the Pallas kernels interpreted),
    and the same greedy tokens."""
    jpol, pol = _matmul_policy(impl)
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b", smoke=True),
                               numerics=jpol, param_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              numerics=pol, param_dtype="float32")
    jeng = jserve.Engine(jcfg, slots=2, max_seq=12, cache_impl="dense",
                         static_weights=True)
    eng = serve.Engine(cfg, slots=2, max_seq=12, cache_impl="dense",
                       device="cpu")
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    prompts = [np.arange(5) + 7, np.arange(5) + 30]
    jfirst, _ = jeng.prefill_batch(prompts, [0, 1])
    first, _ = eng.prefill_batch(prompts, [0, 1])
    assert first.tolist() == jfirst.tolist()
    pos = np.asarray([5, 5])
    want = jeng.decode(np.asarray(jfirst), pos)
    got = eng.decode(first, pos)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert got.argmax(-1).tolist() == want.argmax(-1).tolist()


def test_engine_static_weights_quantizes_its_own_draw():
    """``Engine(static_weights=True)``: the engine's parameters are
    ``quantize_params`` of the same seed's float draw, the embedding and
    norms left float; the weight bytes are about half."""
    cfg = get_config("qwen3-14b", smoke=True, policy="serve_fp8_paged")
    plain = serve.Engine(cfg, slots=1, max_seq=8, device="cpu")
    static = serve.Engine(cfg, slots=1, max_seq=8, static_weights=True,
                          device="cpu")
    want = quantize_params(plain.params, cfg.policy,
                           period=cfg.layer_pattern_period)
    _assert_trees_bitwise(static.params, want)
    assert isinstance(static.params["unembed"], QTensor)
    assert static.params["embed"].dtype == cfg.pdtype

    def nbytes(tree):
        return sum((t.codes.numel() + 4) if isinstance(t, QTensor)
                   else t.numel() * t.element_size()
                   for _, t in _leaves(tree))

    ratio = nbytes(static.params) / nbytes(plain.params)
    assert 0.5 <= ratio < 0.75
