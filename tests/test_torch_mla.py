"""PyTorch port: deepseek-v2-lite-16b (MLA attention with MoE, shared
experts and a leading dense layer) against JAX and against the port's
own bitwise contracts.

The same numpy inputs, from a seed, go through the reference's functions
and the port's at deepseek's smoke widths (d_model 64, 4 heads, latent
32, qk 16 + 8, v 16; 8 experts top-2 of d_ff 64, 2 shared; one leading
dense layer of d_ff 128, then one MoE layer):

* ``mla_forward`` and ``mla_decode`` (per-slot positions, FP8 latents,
  with and without static ``w_uk``/``w_uv``): outputs within
  ``F32_TOL`` of the largest magnitude in float32 (the same products
  summed in another order), within two bf16 ulps of it in bf16; the FP8
  latent codes bitwise, and bitwise whenever the port encodes the
  reference's own float latents;
* the MoE layer with shared experts under both dispatch modes: the
  output within two bf16 ulps of the largest magnitude, the aux losses
  within rtol 1e-5;
* the prefix layer's sites and ``params_from_jax``; ``quantize_params``'
  codes and scales bitwise, a site override on the prefix included;
* the engine's first-step logits on FP8 and float32 latents (float32
  parameters) within ``LOGIT_TOL``;
* the reference's own scheduler contract
  (``tests/test_scheduler.py::test_continuous_matches_bucketed_dense_entry_families``,
  its settings): continuous == bucketed in the port and both equal the
  JAX engine's token streams.

Then the port's contracts on lively weights (every leaf at std 0.5, so
that streams follow the context), each bitwise: a rerun, preempt/restore
== a worst-case pool, bucketed on the paged cache == on the dense cache,
static weights == the bf16 weights decoded from the same codes, a
snapshot round trip, a chaos kill's survivors; the static products per
layer that reach K2; no KV noise for a stack without pages; what is
refused (the prefix cache, a mesh) and that training runs
(``test_torch_mla_train.py`` holds it against JAX).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quant import quantize as jquantize
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro.models import attention as jatt
from repro.models import moe as jmoe
from repro.models.quantize import quantize_params as jquantize_params
from repro.numerics import OpPolicy as JOpPolicy
from repro.numerics import Override as JOverride
from repro.numerics import get_policy as jget_policy
from repro_torch import numerics
from repro_torch.configs import get_config
from repro_torch.core.quant import QTensor, quantize
from repro_torch.kernels import lns_matmul as lm
from repro_torch.launch import serve, train
from repro_torch.models import Model, attention, moe, params_from_jax
from repro_torch.models.quantize import quantize_params, resolve_weight
from repro_torch.models.transformer import layer_site
from repro_torch.numerics import OpPolicy, Override, get_policy
from repro_torch.optim import adamw
from repro_torch.runtime import fault, steps
from repro_torch.serving import (ContinuousScheduler, FaultPlan, Request,
                                 load_snapshot, save_snapshot)
from test_torch_mesh import _stand_in
from torch_cpu_threads import one_torch_thread  # noqa: F401

ARCH = "deepseek-v2-lite-16b"
F32_TOL = 1e-5     # x the largest |output|: float32 sums in another order
BF16_ULPS = 2.0**-7  # two bf16 ulps of the largest |output|
LOGIT_TOL = 2e-4
AUX_RTOL = 1e-5


def _cfgs(policy="serve_fp8_paged", **changes):
    kw = dict(policy=policy) if policy else dict(quant="none")
    return (dataclasses.replace(jget_config(ARCH, smoke=True, **kw),
                                **changes),
            dataclasses.replace(get_config(ARCH, smoke=True, **kw),
                                **changes))


def _conv(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _jf(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    want = _jf(want)
    tol = (F32_TOL if dtype == "float32" else BF16_ULPS) * np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol)


def _mla_params(jcfg, static: bool):
    """The reference's MLA leaves (weights x25, so the latents and scores
    are of order 1) in both packages; with ``static``, ``w_uk`` and
    ``w_uv`` as E4M3 codes (the reference's and the port's quantize)."""
    jp = {k: (v * 25 if k != "kv_norm" else v)
          for k, v in jatt.mla_init(jax.random.PRNGKey(0), jcfg).items()}
    p = {k: _conv(v) for k, v in jp.items()}
    if static:
        for n in ("w_uk", "w_uv"):
            jp[n] = jquantize(jp[n], "e4m3")
            p[n] = quantize(p[n], "e4m3")
            assert torch.equal(p[n].codes, _conv(jp[n].codes))
    return jp, p


# --------------------------------------------------------------------------- #
# MLA
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["serve_fp8_paged", None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches_jax(dtype, policy):
    """The full-sequence forward (keys and values expanded, qk 24 and v 16
    through ``chunked_attention``, so dv != hd) and its cache entries:
    FP8 latent codes bitwise, float latents within tolerance."""
    jcfg, cfg = _cfgs(policy, param_dtype=dtype)
    jp, p = _mla_params(jcfg, static=False)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 7, cfg.d_model)), jcfg.pdtype)
    pos = np.broadcast_to(np.arange(7), (2, 7)).copy()
    jy, jc = jatt.mla_forward(jp, x, jcfg, positions=jnp.asarray(pos))
    y, c = attention.mla_forward(p, _conv(x), cfg,
                                 positions=torch.from_numpy(pos),
                                 want_cache=True)
    _close(y, jy, dtype)
    for name in ("ckv", "kpe"):
        if policy:
            assert c[name].dtype == torch.uint8
            np.testing.assert_array_equal(c[name].numpy(),
                                          np.asarray(jc[name]))
        else:
            _close(c[name], jc[name], dtype)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(dtype, static):
    """The absorbed decode at per-slot positions (3, 9, 0) against an FP8
    latent cache: the output within tolerance, every cache row (the new
    ones included) bitwise; with static ``w_uk``/``w_uv``, decoded into
    x's dtype first."""
    jcfg, cfg = _cfgs(param_dtype=dtype)
    jp, p = _mla_params(jcfg, static)
    rng = np.random.default_rng(1)
    B, S = 3, 12
    cache = {n: np.asarray(jatt._kv_store(jnp.asarray(
        2 * rng.standard_normal((B, S, w)), jcfg.pdtype), jcfg))
        for n, w in (("ckv", cfg.kv_lora_rank), ("kpe", cfg.qk_rope_dim))}
    pos = np.array([3, 9, 0], np.int32)
    x = jnp.asarray(rng.standard_normal((B, 1, cfg.d_model)), jcfg.pdtype)
    jy, jc = jatt.mla_decode(jp, x, jcfg,
                             cache={n: jnp.asarray(v) for n, v in
                                    cache.items()}, pos=jnp.asarray(pos))
    tc = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    y = attention.mla_decode(p, _conv(x), cfg, cache=tc,
                             pos=torch.from_numpy(pos.astype(np.int64)))
    _close(y, jy, dtype)
    for name in tc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def test_latent_codes_bitwise_on_the_reference_latents():
    """The port's store (``numerics.kv_encode``: E5M2 at scale 1, RNE,
    since the dense store has no key) of the reference's own float
    latents gives the reference's codes, bf16 and float32, with values
    spanning the format's range and the rounding boundaries."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(param_dtype=dtype)
        jp, _ = _mla_params(jcfg, static=False)
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.standard_normal((2, 9, cfg.d_model)) * 4.0,
                        jcfg.pdtype)
        pos = jnp.broadcast_to(jnp.arange(9), (2, 9))
        ckv, kpe = jatt._mla_latent(jp, x, jcfg, pos)
        extra = jnp.asarray(np.concatenate([
            np.exp2(rng.uniform(-20, 16, 4096)) * rng.choice([-1, 1], 4096),
            [0.0, 57344.0, 61440.0, 1e6, 2.0**-16, 2.0**-17]]), jcfg.pdtype)
        assert cfg.policy.kv_write.mode == "stochastic"
        for v in (ckv, kpe, extra):
            want = np.asarray(jatt._kv_store(v, jcfg))
            got = numerics.kv_encode(_conv(v), cfg.policy)
            np.testing.assert_array_equal(got.numpy(), want)


def test_masked_decode_keeps_the_old_rows():
    """A masked sub-step (``active``): every active slot's output and new
    row equal the unmasked call's bitwise, and an inactive slot's cache
    rows stay as they were, as the reference's select keeps them."""
    _, cfg = _cfgs(param_dtype="float32")
    p = Model(cfg).init(torch.Generator().manual_seed(0))["blocks"][0]["attn"]
    g = torch.Generator().manual_seed(1)
    cache = {"ckv": torch.randint(0, 120, (3, 8, cfg.kv_lora_rank),
                                  generator=g, dtype=torch.uint8),
             "kpe": torch.randint(0, 120, (3, 8, cfg.qk_rope_dim),
                                  generator=g, dtype=torch.uint8)}
    x = torch.randn((3, 1, cfg.d_model), generator=g)
    pos = torch.tensor([2, 5, 7])
    full = {n: t.clone() for n, t in cache.items()}
    y_full = attention.mla_decode(p, x, cfg, cache=full, pos=pos)
    masked = {n: t.clone() for n, t in cache.items()}
    active = torch.tensor([True, False, True])
    y = attention.mla_decode(p, x, cfg, cache=masked, pos=pos, active=active)
    assert torch.equal(y[active], y_full[active])
    for n in cache:
        assert torch.equal(masked[n][active], full[n][active])
        assert torch.equal(masked[n][~active], cache[n][~active])


# --------------------------------------------------------------------------- #
# Shared experts, the prefix layer, static weights
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dispatch", ["grouped", "sorted_global"])
def test_moe_with_shared_experts_matches_jax(dispatch):
    """The routed experts plus the shared experts' gated MLP (Fs = 2 x
    64), bf16: routing decided (adjacent top-3 probabilities > 1e-6
    apart), output within two bf16 ulps, aux within rtol 1e-5."""
    jcfg, cfg = _cfgs(moe_dispatch=dispatch)
    jp = jmoe.moe_init(jax.random.PRNGKey(4), jcfg)
    assert set(jp["shared"]) == {"w_gate", "w_up", "w_down"}
    assert jp["shared"]["w_up"].shape == (cfg.d_model, 2 * cfg.moe_d_ff)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((3, 5, cfg.d_model)), jnp.bfloat16)
    probs = jax.nn.softmax(x.astype(jnp.float32) @ jp["router"], axis=-1)
    top = -np.sort(-np.asarray(probs), axis=-1)[..., :cfg.top_k + 1]
    assert np.diff(-top, axis=-1).min() > 1e-6
    p = jax.tree.map(_conv, jp)
    out, aux = moe.moe_ffn(p, _conv(x), cfg)
    jout, jaux = jmoe.moe_ffn(jp, x, jcfg)
    assert out.dtype == torch.bfloat16
    _close(out, jout, "bfloat16")
    for name in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=AUX_RTOL)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _flat(sub, path + (i,)).items()}
    return {path: tree}


def test_prefix_sites_and_params_from_jax():
    """The reference's ``prefix`` tuple comes across as the list
    ``prefix``, the body as ``blocks``; ``Model.init`` draws the same
    tree; the policy sites are the reference's (``prefix.0``, then
    ``blocks.{j % period}``); an MoE layer's ``shared`` leaves are 2-D."""
    jcfg, cfg = _cfgs()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert len(params["prefix"]) == cfg.first_dense == 1
    assert len(params["blocks"]) == cfg.n_layers - 1
    assert set(params["prefix"][0]["ffn"]) == {"w_gate", "w_up", "w_down"}
    assert params["prefix"][0]["ffn"]["w_up"].shape == (cfg.d_model,
                                                        cfg.d_ff)
    for path, t in _flat(params["prefix"][0]).items():
        np.testing.assert_array_equal(
            _np(t), _jf(_flat(jparams["prefix"][0])[path]))
    shared = params["blocks"][0]["ffn"]["shared"]
    np.testing.assert_array_equal(
        _np(shared["w_down"]),
        _jf(jparams["blocks"][0]["ffn"]["shared"]["w_down"][0]))
    own = Model(cfg).init(torch.Generator().manual_seed(0))
    assert {p: (tuple(t.shape), t.dtype) for p, t in _flat(own).items()} \
        == {p: (tuple(t.shape), t.dtype) for p, t in _flat(params).items()}
    assert [layer_site(cfg, i) for i in range(cfg.n_layers)] == \
        ["prefix.0", "blocks.0"]
    full = get_config(ARCH)
    assert [layer_site(full, i) for i in (0, 1, 26)] == \
        ["prefix.0", "blocks.0", "blocks.0"]


def _site_policies():
    """serve_fp8_paged, and one whose weights override puts the prefix
    layer's MLP in E5M2 (the site names the leading dense layer)."""
    jover = JOverride("weights", "prefix.0.ffn.*",
                      JOpPolicy(fmt="e5m2", mode="rne", impl="auto",
                                accum="bf16"))
    over = Override("weights", "prefix.0.ffn.*",
                    OpPolicy(fmt="e5m2", mode="rne", impl="auto",
                             accum="bf16"))
    return [(jget_policy("serve_fp8_paged"), get_policy("serve_fp8_paged")),
            (jget_policy("serve_fp8_paged").replace(
                overrides=(jover,)),
             get_policy("serve_fp8_paged").replace(overrides=(over,)))]


@pytest.mark.parametrize("which", [0, 1], ids=["serve_fp8_paged",
                                               "prefix_override"])
def test_static_codes_bitwise_equal_quantize_params(which):
    """Every eligible leaf (MLA's wq, w_dkv, w_uk, w_uv, wo; the prefix
    MLP; the routed and shared experts; unembed) as codes and a scale
    bitwise equal to the reference's ``quantize_params`` (per block there,
    per layer here: the same tensor)."""
    jpol, pol = _site_policies()[which]
    jcfg, cfg = _cfgs()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(3))
    want = params_from_jax(jax.tree.map(np.asarray,
                                        jquantize_params(jparams, jpol)),
                           cfg)
    got = quantize_params(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg), pol,
                          period=cfg.layer_pattern_period)
    flat_w, n_q = _flat(want), 0
    for path, w in _flat(got).items():
        v = flat_w[path]
        assert isinstance(w, QTensor) == isinstance(v, QTensor), path
        if isinstance(w, QTensor):
            n_q += 1
            assert w.fmt == v.fmt, path
            assert torch.equal(w.codes, v.codes), path
            assert torch.equal(w.scale, v.scale), path
        else:
            assert torch.equal(w, v), path
    # per layer: 5 MLA weights; the prefix MLP's 3, or the 3 experts and
    # the 3 shared; the unembed
    assert n_q == 5 * 2 + 3 + 6 + 1
    fmt = got["prefix"][0]["ffn"]["w_up"].fmt
    assert fmt == ("e4m3", "e5m2")[which]
    assert got["blocks"][0]["ffn"]["shared"]["w_up"].fmt == "e4m3"


# --------------------------------------------------------------------------- #
# The engine against the JAX engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("latents", ["fp8", "float32"])
def test_engine_first_step_logits_match_jax_engine(latents):
    """A prefill chunk (4 and 3 tokens) and one decode step of the smoke
    engine on the JAX engine's float32 parameters, FP8 latents (policy
    serve_fp8_paged) or float32 latents: logits within 2e-4."""
    policy = "serve_fp8_paged" if latents == "fp8" else None
    jcfg, cfg = _cfgs(policy, param_dtype="float32")
    jeng = jserve.Engine(jcfg, slots=2, max_seq=16, page_size=8,
                         rng_seed=3)
    eng = serve.Engine(cfg, slots=2, max_seq=16, page_size=8, rng_seed=3,
                       device="cpu")
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 4)).astype(np.int32)
    got, want = [], []
    for e, out in ((jeng, want), (eng, got)):
        e.pool.ensure_capacity_batch(np.asarray([4, 3]))
        out.append(e.step_chunk(toks, np.zeros(2, np.int32),
                                np.asarray([4, 3], np.int32)))
        out.append(e.step_chunk(toks[:, :1], np.asarray([4, 3], np.int32),
                                np.asarray([1, 1], np.int32)))
    np.testing.assert_allclose(np.stack(got), np.stack(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for name in ("ckv", "kpe"):
        want_dt = torch.uint8 if latents == "fp8" else torch.float32
        assert eng.cache[name].dtype == want_dt
        assert eng.cache[name].shape[:2] == (cfg.n_layers, 2)


def test_continuous_matches_bucketed_and_the_jax_engine():
    """The reference's contract for families with dense per-slot entries,
    at its settings (``quant="fp8_w8kv8"``, 2 slots, max_seq 10, page 4,
    deterministic KV rounding, chunk 2, 4 generated, 3 prompts of 3 and 5
    tokens): continuous == bucketed in the port, and both equal the JAX
    engine's streams on the same parameters."""
    jcfg = jget_config(ARCH, smoke=True, quant="fp8_w8kv8")
    cfg = get_config(ARCH, smoke=True, quant="fp8_w8kv8")
    rng = np.random.default_rng(1)
    queue = [rng.integers(0, cfg.vocab, size=3 + 2 * (i % 2))
             for i in range(3)]
    geo = dict(slots=2, max_seq=10, page_size=4, stochastic_kv=False,
               cache_impl="paged")
    jeng = jserve.Engine(jcfg, **geo)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    outs = {}
    for sched in ("bucketed", "continuous"):
        e = jserve.Engine(jcfg, **geo)
        outs["jax", sched], _ = jserve.run(e, [q.copy() for q in queue],
                                           gen=4, quiet=True,
                                           scheduler=sched, chunk=2)
        eng = serve.Engine(cfg, device="cpu", **geo)
        eng.params = params
        outs["port", sched], _ = serve.run(eng, [q.copy() for q in queue],
                                           gen=4, quiet=True,
                                           scheduler=sched, chunk=2)
    assert outs["port", "continuous"] == outs["port", "bucketed"]
    assert outs["port", "continuous"] == outs["jax", "continuous"]
    assert outs["port", "bucketed"] == outs["jax", "bucketed"]


# --------------------------------------------------------------------------- #
# The port's own bitwise contracts
# --------------------------------------------------------------------------- #
def _lively(params, seed=0):
    g = torch.Generator().manual_seed(seed)

    def redraw(t):
        if isinstance(t, dict):
            return {k: redraw(v) for k, v in t.items()}
        if isinstance(t, list):
            return [redraw(v) for v in t]
        return (torch.randn(t.shape, generator=g) * 0.5).to(t.dtype)

    return redraw(params)


def _prompts(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(s))
            for s in rng.integers(3, 14, size=n)]


@pytest.fixture(scope="module", params=["serve_fp8_paged", None],
            ids=["fp8", "bf16"])
def lively(request):
    _, cfg = _cfgs(request.param)
    params = _lively(Model(cfg).init(torch.Generator().manual_seed(0)))
    return cfg, params


def _engine(cfg, params, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 24)
    kw.setdefault("page_size", 4)
    eng = serve.Engine(cfg, rng_seed=0, device="cpu", **kw)
    eng.params = params
    return eng


def _run(cfg, params, queue, scheduler="continuous", **kw):
    eng = _engine(cfg, params, **kw)
    return serve.run(eng, [q.copy() for q in queue], gen=8, quiet=True,
                     scheduler=scheduler)


def _static_pair(cfg, params, queue):
    codes = quantize_params(params, cfg.policy,
                            period=cfg.layer_pattern_period)
    decoded = {p: resolve_weight(w, dtype=cfg.pdtype)
               if isinstance(w, QTensor) else w
               for p, w in _flat(codes).items()}

    def unflat(tree, path=()):
        if isinstance(tree, dict):
            return {k: unflat(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [unflat(v, path + (i,)) for i, v in enumerate(tree)]
        return decoded[path]

    (a, _), (b, _) = (_run(cfg, codes, queue, static_weights=True),
                      _run(cfg, unflat(codes), queue))
    return a, b


CONTRACTS = ["rerun", "preempt", "bucketed-paged-dense", "static", "chaos"]


@pytest.mark.parametrize("contract", CONTRACTS)
def test_bitwise_contracts_hold_on_deepseek(contract, lively, tmp_path):
    """Each pair of token streams bitwise equal on lively weights, both
    latent kinds; the streams vary."""
    cfg, params = lively
    queue = _prompts(cfg)
    if contract == "rerun":
        (a, _), (b, _) = (_run(cfg, params, queue) for _ in range(2))
    elif contract == "preempt":
        (a, sa), (b, _) = (_run(cfg, params, queue, num_pages=n)
                           for n in (6, None))
        assert sa["preemptions"] >= 1 and sa["restores"] >= 1
    elif contract == "bucketed-paged-dense":
        (a, _), (b, _) = (_run(cfg, params, queue, "bucketed",
                               cache_impl=impl) for impl in ("paged", "dense"))
    elif contract == "static":
        a, b = _static_pair(cfg, params, queue)
    else:
        def make():
            return _engine(cfg, params, max_seq=24)
        b, _ = fault.run_serving(make, queue, gen=8, log=lambda *x: None)
        a, stats = fault.run_serving(
            make, queue, gen=8, log=lambda *x: None,
            chaos=FaultPlan(kill_at_step=9), ckpt_dir=tmp_path / "ck",
            snapshot_every=3)
        assert stats["restarts"] == 1 and stats["chaos"]["killed"] == 1
        assert stats["terminal"]["finished"] == len(queue)
    assert a == b
    assert sum(len(set(o)) > 1 for o in b.values()) >= len(b) - 1


def test_snapshot_roundtrip_while_preempted(lively, tmp_path):
    """A snapshot taken while a request sits PREEMPTED (its latents'
    rows spilled to the host) restores into a fresh engine: every cache
    leaf and spill tensor ``torch.equal``, and both finish alike."""
    cfg, params = lively
    queue = _prompts(cfg, n=4, seed=3)

    def build():
        eng = _engine(cfg, params, num_pages=6)
        return eng, ContinuousScheduler(eng, chunk=4)

    eng, sched = build()
    for i, p in enumerate(queue):
        sched.add(Request(rid=i, prompt=p.copy(), gen=8))
    for _ in range(200):
        sched.step()
        if sched.preempted:
            break
    else:
        pytest.fail("the pool never forced a preemption")
    save_snapshot(tmp_path, eng, sched)
    eng2, sched2 = build()
    assert load_snapshot(tmp_path, eng2, sched2) == sched.steps
    assert set(eng2.cache) == {"ckv", "kpe"}
    for name, t in eng.cache.items():
        assert torch.equal(eng2.cache[name], t), name
    for r, r2 in zip(sched.preempted, sched2.preempted):
        assert set(r.spill["state"]) == {"ckv", "kpe"}
        for name, t in r.spill["state"].items():
            assert t.shape[:2] == (cfg.n_layers, 1)
            assert torch.equal(r2.spill["state"][name], t), name
    assert sched2.run() == sched.run()


def test_static_products_per_layer_reach_k2():
    """Static weights under a policy that quantizes matmuls
    (``fused_dequant``): each decode model call multiplies 6 products a
    layer as codes through K2's wrapper (wq, w_dkv, wo, and the prefix
    MLP's or the shared experts' three); ``w_uk``, ``w_uv``, the routed
    experts and the unembed are decoded first, as in the reference."""
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, numerics=get_policy(
        "serve_fp8_paged").replace(matmul=OpPolicy(
            fmt="e4m3", mode="rne", impl="fused_dequant", accum="f32")))
    eng = serve.Engine(cfg, slots=2, max_seq=16, page_size=4,
                       static_weights=True, device="cpu")
    real, calls = lm.dequant_matmul, []

    def counted(x, w, **kw):
        calls.append(tuple(w.shape))
        return real(x, w, **kw)

    lm.dequant_matmul = counted
    try:
        eng.pool.ensure_capacity_batch(np.asarray([3, 3]))
        eng.step_chunk(np.ones((2, 3), np.int32), np.zeros(2, np.int32),
                       np.asarray([3, 3], np.int32))
    finally:
        lm.dequant_matmul = real
    assert len(calls) == 3 * 6 * cfg.n_layers   # 3 sub-steps
    D, H = cfg.d_model, cfg.n_heads
    assert (D, H * (cfg.qk_nope_dim + cfg.qk_rope_dim)) in calls
    assert (cfg.d_ff, D) in calls and (2 * cfg.moe_d_ff, D) in calls


def test_no_kv_noise_without_paged_layers():
    """FP8 latents are stored RNE at scale 1 (the dense store has no
    key): the engine keeps its stochastic stream key, but no step draws
    KV noise, and no per-layer write keys are derived."""
    _, cfg = _cfgs()
    eng = serve.Engine(cfg, slots=2, max_seq=16, page_size=4, device="cpu")
    assert eng._token_key is not None
    pos = torch.zeros((4, 2), dtype=torch.int32)
    assert eng.model.kv_noise(eng._token_key, pos) is None
    eng.pool.ensure_capacity_batch(np.asarray([2, 2]))
    eng.step_chunk(np.ones((2, 2), np.int32), np.zeros(2, np.int32),
                   np.asarray([2, 2], np.int32))
    assert eng.model._key_cache is None


def test_cli_serves_both_latent_kinds(capsys):
    """``--arch deepseek-v2-lite-16b`` through the serve CLI on the CPU,
    FP8 latents and the default bf16 ones, continuous and bucketed."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--gen", "4", "--prompt-len", "3,7"]
    runs = [serve.main(base + extra) for extra in (
        ["--policy", "serve_fp8_paged"], [],
        ["--scheduler", "bucketed", "--cache-impl", "dense"])]
    for outputs in runs:
        assert sorted(outputs) == [0, 1, 2]
        assert all(len(o) == 4 for o in outputs.values())


# --------------------------------------------------------------------------- #
# What is refused
# --------------------------------------------------------------------------- #
def test_prefix_cache_and_mesh_are_refused_and_deepseek_trains(tmp_path):
    """As in the reference: the prefix cache and mesh serving need a
    pure-GQA paged cache (MLA keeps dense per-slot latents).  Training
    deepseek, refused until ROADMAP.md Queue 1 item 11b-train, runs: a
    step of ``steps.build_train_step`` and the training CLI give finite
    terms; FSDP/TP training (``--mesh``) and ``remat_policy="dots"`` stay
    refused (item 12)."""
    jcfg, cfg = _cfgs()
    for eng_cls, kw in ((jserve.Engine, {}), (serve.Engine,
                                               dict(device="cpu"))):
        with pytest.raises(ValueError, match="pure-GQA paged KV cache"):
            eng_cls(jcfg if eng_cls is jserve.Engine else cfg, slots=2,
                    max_seq=8, prefix_cache=True, **kw)
    for mod, c in ((jserve, jcfg), (serve, cfg)):
        with pytest.raises(ValueError, match="pure-GQA paged cache"):
            mod.Engine._validate_mesh(c, _stand_in(2), "paged")
    model = Model(_cfgs(None)[1])
    batch = {"tokens": torch.arange(8, dtype=torch.int64).view(1, 8),
             "labels": torch.arange(1, 9, dtype=torch.int64).view(1, 8)}
    _, metrics = steps.build_train_step(model, adamw.OptConfig())(
        steps.make_train_state(model, torch.Generator().manual_seed(0)),
        batch)
    assert all(bool(torch.isfinite(metrics[k]))
               for k in ("loss", "moe_lb", "moe_z", "grad_norm"))
    history = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "1", "--batch", "1", "--seq", "8",
                          "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in history] == [1]
    assert np.isfinite(history[0]["loss"]) and history[0]["moe_z"] > 0
    with pytest.raises(NotImplementedError, match="item 12"):
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--mesh", "1x2", "--ckpt-dir", str(tmp_path)])
    dots = Model(dataclasses.replace(model.cfg, remat_policy="dots"))
    with pytest.raises(NotImplementedError, match="item 12"):
        steps.build_train_step(dots, adamw.OptConfig())(
            steps.make_train_state(dots, torch.Generator().manual_seed(0)),
            batch)