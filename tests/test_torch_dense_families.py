"""PyTorch port: the dense GQA family (qwen3-14b, gemma2-27b, gemma3-12b)
against JAX.

These configs bring the branches qwen2-0.5b never drives: qwen3's and
gemma3's per-head qk RMSNorm, gemma's sandwich norms and sqrt(d_model)
embedding scale, local/global attention windows (gemma2 alternates, gemma3
runs 5 local layers then 1 global), gemma2's attention softcap of 50 and
final softcap of 30, GeLU, and a layer pattern whose period (2, 6) orders
the reference's stacked blocks.  Every check runs at ``smoke()`` size with
float32 parameters carried across by ``params_from_jax``, and every prompt
runs past the smoke window of 32, so the local layers mask.

Tolerances are the qwen2 tests' (``tests/test_torch_model.py``,
``tests/test_torch_train.py``): logits rtol = atol = 2e-4, at least 99.9 %
of the FP8 page codes equal and the page scales exactly; losses rtol 1e-5
and every gradient leaf within 1e-5 of its largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.launch import serve
from repro_torch.models import Model, params_from_jax
from repro_torch.optim.adamw import tree_leaves, tree_map
from torch_cpu_threads import one_torch_thread  # noqa: F401

ARCHS = ["qwen3-14b", "gemma2-27b", "gemma3-12b"]
RTOL = ATOL = 2e-4
NUMERICS = {"fp8": dict(policy="serve_fp8_paged"), "float": dict(quant="none")}
FULL = {  # layers, d_model, heads, KV heads, hd, d_ff, padded vocab, period
    "qwen3-14b": (40, 5120, 40, 8, 128, 17408, 153600, 1),
    "gemma2-27b": (46, 4608, 32, 16, 128, 36864, 256000, 2),
    "gemma3-12b": (48, 3840, 16, 8, 256, 15360, 262144, 6),
}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal_reference(arch, smoke):
    for kw in NUMERICS.values():
        ref = jget_config(arch, smoke=smoke, **kw)
        port = get_config(arch, smoke=smoke, **kw)
        rd = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)
              if f.name not in ("quant", "numerics")}
        pd = {f.name: getattr(port, f.name)
              for f in dataclasses.fields(port) if f.name != "numerics"}
        assert rd == pd
        for prop in ("hd", "vocab_padded", "layer_pattern_period"):
            assert getattr(ref, prop) == getattr(port, prop), prop
        assert [port.is_global_attn_layer(i) for i in range(port.n_layers)] \
            == [ref.is_global_attn_layer(i) for i in range(ref.n_layers)]
        assert port.policy.to_dict() == ref.policy.to_dict()
    if not smoke:
        assert (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads,
                port.hd, port.d_ff, port.vocab_padded,
                port.layer_pattern_period) == FULL[arch]


def _models(arch, numerics="float", max_seq=64):
    kw = NUMERICS[numerics]
    jcfg = dataclasses.replace(jget_config(arch, smoke=True, **kw),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True, **kw),
                              param_dtype="float32")
    jm = JModel(jcfg, max_seq=max_seq)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jm, jparams, Model(cfg, max_seq=max_seq), params


@pytest.mark.parametrize("arch", ARCHS)
def test_init_parameter_set_equals_reference(arch):
    """``Model.init`` draws the reference's tree: q_norm/k_norm where the
    config has qk-norm, ln1_post/ln2_post under sandwich norms, no qkv
    bias, an unembed only when the embeddings are untied; same shapes
    and dtypes, gains zero, weights at std 0.02."""
    jm, jparams, model, params = _models(arch)
    cfg = model.cfg
    own = model.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: (tuple(a.shape), a.dtype), params)
    assert shapes == jax.tree.map(lambda a: (tuple(a.shape), a.dtype), own)
    attn = set(own["blocks"][0]["attn"])
    assert ({"q_norm", "k_norm"} <= attn) == cfg.qk_norm
    assert not attn & {"bq", "bk", "bv"}
    layer = set(own["blocks"][0])
    assert ({"ln1_post", "ln2_post"} <= layer) == cfg.sandwich_norm
    assert ("unembed" in own) == (not cfg.tie_embeddings)
    assert all(float(own["blocks"][i][g].abs().max()) == 0.0
               for i in range(cfg.n_layers) for g in layer - {"attn", "ffn"})
    std = float(own["blocks"][0]["ffn"]["w_up"].std())
    assert 0.018 < std < 0.022


@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-12b"])
def test_params_from_jax_unstacks_the_layer_pattern(arch):
    """Periods 2 and 6: the reference stacks layer ``b * period + j`` as
    block ``[j][b]``; the port's layer list is that order, and each
    layer's window (local or global) is the reference pattern's."""
    jm, jparams, model, params = _models(arch)
    cfg = model.cfg
    period = cfg.layer_pattern_period
    assert period == {"gemma2-27b": 2, "gemma3-12b": 6}[arch]
    assert len(jparams["blocks"]) == period
    n_blocks = cfg.n_layers // period
    assert n_blocks == 2 and len(params["blocks"]) == cfg.n_layers
    for b in range(n_blocks):
        for j in range(period):
            layer = params["blocks"][b * period + j]
            want = jax.tree.map(lambda a, b=b: np.asarray(a[b]),
                                jparams["blocks"][j])
            got = jax.tree.map(lambda t: t.numpy(), layer)
            assert jax.tree.structure(got) == jax.tree.structure(want)
            for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(x, y)
            assert cfg.is_global_attn_layer(b * period + j) == \
                jm.pattern[j].attn_global


@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-12b"])
def test_embed_scale_is_the_bf16_sqrt_d_model(arch):
    """Full width, bf16: the embedding rows times sqrt(d_model) rounded to
    bf16 (62.0 for gemma3's 3840, 68.0 for gemma2's 4608), bitwise."""
    cfg = get_config(arch)
    jcfg = jget_config(arch)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((64, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, 64, (2, 5)).astype(np.int32)
    got = Model(cfg)._embed(
        {"embed": torch.from_numpy(emb).to(torch.bfloat16)},
        torch.from_numpy(toks).long())
    want = JModel(jcfg)._embed({"embed": jnp.asarray(emb, jnp.bfloat16)},
                               jnp.asarray(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("numerics", ["fp8", "float"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_paged_teacher_forced_logits_match_reference(arch, numerics):
    """Mixed prefill+decode steps past the smoke window: slot 0 prefills a
    40-token prompt in chunks of 8 then decodes, slot 1 joins with 12
    tokens at the third step; FP8 pages with stochastic writes, or float32
    pages."""
    jm, jparams, model, params = _models(arch, numerics)
    cfg = model.cfg
    page, P = 8, 17
    jcache = jm.make_paged_cache(2, P, page)
    cache = model.make_paged_cache(P, page, "cpu")
    bt = np.zeros((2, 8), np.int32)
    bt[0, :6] = [16, 15, 14, 13, 12, 11]
    bt[1, :6] = [10, 9, 8, 7, 6, 5]
    fp8 = numerics == "fp8"
    jkey = jax.random.fold_in(jax.random.PRNGKey(17), 0) if fp8 else None
    key = fold_in(prng_key(17), 0) if fp8 else None
    jstep = jax.jit(jm.step_paged, static_argnames=("page_size",))
    rng = np.random.default_rng(0)
    steps = [([8, 0], [0, 0], 8), ([8, 0], [8, 0], 8), ([8, 8], [16, 0], 8),
             ([8, 4], [24, 8], 8), ([8, 1], [32, 12], 8),
             ([1, 1], [40, 13], 1), ([1, 1], [41, 14], 1)]
    codes_eq = codes_n = 0
    for n_new, lengths, T in steps:
        toks = rng.integers(0, cfg.vocab, (2, T)).astype(np.int32)
        jl, jcache = jstep(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(lengths),
            jnp.asarray(n_new), jnp.asarray(bt), page_size=page, key=jkey)
        pl, cache = model.step_paged(
            params, cache, torch.from_numpy(toks),
            torch.tensor(lengths, dtype=torch.int32),
            torch.tensor(n_new, dtype=torch.int32), torch.from_numpy(bt),
            page_size=page, key=key)
        act = np.asarray(n_new) > 0
        np.testing.assert_allclose(pl.numpy()[act], np.asarray(jl)[act],
                                   rtol=RTOL, atol=ATOL)
    jself = [jcache["blocks"][j]["self"] for j in range(len(jcache["blocks"]))]
    period = len(jself)
    for name in ("kp", "vp", "ks", "vs"):
        # port layer b * period + j is the reference's block [j][b]
        want = np.stack([np.asarray(jself[i % period][name])[i // period]
                         for i in range(cfg.n_layers)])[:, 1:]
        got = cache[name].numpy()[:, 1:]
        if name in ("ks", "vs"):
            np.testing.assert_array_equal(got, want)
        elif fp8:
            codes_eq += int((got == want).sum())
            codes_n += got.size
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert codes_eq >= 0.999 * codes_n, (codes_eq, codes_n)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_and_gradients_match_reference(arch):
    """The training loss over 40 positions (past the window) and every
    gradient leaf."""
    jm, jparams, model, params = _models(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab, (2, 40)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, 3] = -1
    batch = {"tokens": toks, "labels": labels}
    (jloss, jaux), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    req = tree_map(lambda p: p.clone().requires_grad_(True), params)
    loss, aux = model.loss_fn(req, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(req))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(jaux["ce"]),
                               rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg)
    for a, b in zip(grads, tree_leaves(want)):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max() + 1e-12)


ENGINE_QUEUE = [np.arange(37) * 5 % 251, np.arange(3) + 7,
                np.arange(34) * 11 % 253, np.arange(6) + 90]


@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-12b"])
def test_engine_token_streams_match_reference_engine(arch):
    """``run_continuous`` end to end with prompts past the window on the
    CLI's default float pages, every parameter redrawn at std 0.5 and the
    embedding at 0.5 / sqrt(d_model), so that it is 0.5 after gemma's
    embedding scale (at 0.5 the scaled embedding drowns every layer and
    greedy decoding repeats each prompt's last token; this way the streams
    follow the context): the port's streams equal the reference
    engine's."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               param_dtype="float32")
    jeng = jserve.Engine(jcfg, slots=2, max_seq=48, page_size=8)
    rng = np.random.default_rng(9)
    lively = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype),
        jeng.params)
    lively["embed"] = lively["embed"] / jcfg.d_model**0.5
    jeng.params = lively
    ref, _ = jserve.run_continuous(jeng, ENGINE_QUEUE, gen=6, chunk=4,
                                   quiet=True)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="float32")
    eng = serve.Engine(cfg, slots=2, max_seq=48, page_size=8, device="cpu")
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    port, _ = serve.run_continuous(eng, ENGINE_QUEUE, gen=6, chunk=4,
                                   quiet=True)
    assert any(len(set(o)) > 1 for o in ref.values())
    assert port == ref
