"""PyTorch port: policy, config, layers and the paged model against JAX.

The model check runs ``Model.step_paged`` of both packages teacher-forced
(the same tokens each step, each package keeping its own page cache) at
``smoke()`` size with float32 parameters carried across by
``params_from_jax``.  Logits must agree to rtol = atol = 2e-4: the float32
matmuls, norms and softmax sum in different orders in XLA and torch
(~1e-6 relative per op over 2 layers and a dozen sub-steps).  The page
codes are stochastic-rounding encodes of K/V that differ by those ulps, so
a code flips only when a value sits within an ulp of a rounding boundary;
at least 99.9% of the codes must be equal and the page scales exactly so.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.numerics import policy as jpolicy
from repro_torch.configs import get_config
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.models import Model, layers, params_from_jax
from repro_torch.numerics import policy

RTOL = ATOL = 2e-4


def test_policy_presets_equal_reference():
    assert policy.available_policies() == jpolicy.available_policies()
    for name in policy.available_policies():
        assert policy.get_policy(name).to_dict() == \
            jpolicy.get_policy(name).to_dict(), name
    p = policy.get_policy("serve_fp8_paged")
    assert policy.Policy.from_json(p.to_json()) == p
    with pytest.raises(ValueError):
        policy.OpPolicy(fmt="e3m4")


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equal_reference(smoke):
    ref = jget_config("qwen2-0.5b", smoke=smoke, policy="serve_fp8_paged")
    port = get_config("qwen2-0.5b", smoke=smoke, policy="serve_fp8_paged")
    rd = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)
          if f.name not in ("quant", "numerics")}
    pd = {f.name: getattr(port, f.name) for f in dataclasses.fields(port)
          if f.name != "numerics"}
    assert rd == pd
    for prop in ("hd", "vocab_padded", "layer_pattern_period"):
        assert getattr(ref, prop) == getattr(port, prop), prop
    assert port.policy.to_dict() == ref.policy.to_dict()
    if not smoke:
        assert (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads,
                port.hd, port.d_ff, port.vocab_padded) == \
            (24, 896, 14, 2, 64, 4864, 153600)


def test_unported_architectures_raise():
    """whisper-base (ROADMAP.md Queue 1 item 11e) and llava-next-mistral-7b
    (item 11f) are refused by name; deepseek-v2-lite-16b (item 11b),
    mamba2-780m (item 11c) and jamba-v0.1-52b (item 11d), refused here
    before, are served since."""
    for arch, item in (("whisper-base", "11e"),
                       ("llava-next-mistral-7b", "11f")):
        with pytest.raises(NotImplementedError, match=item):
            get_config(arch)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4, 64)).astype(np.float32)
    s = (rng.standard_normal(64) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s))),
        rtol=1e-5, atol=1e-6)
    pos = rng.integers(0, 4096, (3, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-4, atol=1e-4)


def _setup(fused=True):
    jcfg = jget_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    jcfg = dataclasses.replace(jcfg, param_dtype="float32")
    cfg = get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    jm = JModel(jcfg, max_seq=32)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jm, jparams, Model(cfg, max_seq=32), params


def test_params_from_jax_unstacks_blocks_keeping_names():
    jcfg, cfg, _, jparams, model, params = _setup()
    assert len(params["blocks"]) == cfg.n_layers
    for i, layer in enumerate(params["blocks"]):
        assert set(layer) == set(jparams["blocks"][0])
        assert set(layer["attn"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
        assert set(layer["ffn"]) == {"w_gate", "w_up", "w_down"}
        np.testing.assert_array_equal(
            layer["ffn"]["w_gate"].numpy(),
            np.asarray(jparams["blocks"][0]["ffn"]["w_gate"][i]))
    own = model.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), params)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), own)


def test_step_paged_teacher_forced_logits_match_reference():
    """Mixed prefill+decode steps: slot 0 prefills a 7-token prompt in
    chunks of 4 then decodes, slot 1 joins later, slot 2 stays idle."""
    jcfg, cfg, jm, jparams, model, params = _setup()
    page, P = 4, 16
    jcache = jm.make_paged_cache(3, P, page)
    cache = model.make_paged_cache(P, page, "cpu")
    bt = np.zeros((3, 8), np.int32)
    bt[0, :5] = [15, 14, 13, 12, 11]
    bt[1, :5] = [10, 9, 8, 7, 6]
    jkey = jax.random.fold_in(jax.random.PRNGKey(17), 0)
    key = fold_in(prng_key(17), 0)
    rng = np.random.default_rng(0)
    # (tokens [3, T], lengths [3], n_new [3]) per engine step
    steps = [
        ([4, 0, 0], [0, 0, 0], 4),
        ([3, 4, 0], [4, 0, 0], 4),
        ([1, 2, 0], [7, 4, 0], 4),
        ([1, 1, 0], [8, 6, 0], 1),
        ([1, 1, 0], [9, 7, 0], 1),
        ([1, 1, 0], [10, 8, 0], 1),
    ]
    codes_eq = codes_n = 0
    for n_new, lengths, T in steps:
        toks = rng.integers(0, cfg.vocab, (3, T)).astype(np.int32)
        jl, jcache = jm.step_paged(
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
        jself = jcache["blocks"][0]["self"]
        for name in ("kp", "vp"):
            a, b = cache[name].numpy()[:, 1:], np.asarray(jself[name])[:, 1:]
            codes_eq += int((a == b).sum())
            codes_n += a.size
        for name in ("ks", "vs"):
            np.testing.assert_array_equal(cache[name].numpy()[:, 1:],
                                          np.asarray(jself[name])[:, 1:])
    assert codes_eq >= 0.999 * codes_n, (codes_eq, codes_n)


def test_fused_and_unfused_model_steps_bitwise():
    _, cfg, _, _, model, params = _setup()
    key = fold_in(prng_key(17), 0)
    page = 4
    bt = torch.zeros((2, 6), dtype=torch.int32)
    bt[0, :3] = torch.tensor([1, 2, 3])
    bt[1, :3] = torch.tensor([4, 5, 6])
    outs = []
    for fused in (True, False):
        cache = model.make_paged_cache(8, page, "cpu")
        logits = []
        for lengths, n_new in (([0, 0], [4, 3]), ([4, 3], [4, 1]),
                               ([8, 4], [1, 1])):
            T = max(n_new)
            toks = torch.arange(2 * T, dtype=torch.int64).reshape(2, T) + 5
            lg, cache = model.step_paged(
                params, cache, toks, torch.tensor(lengths, dtype=torch.int32),
                torch.tensor(n_new, dtype=torch.int32), bt, page_size=page,
                key=key, fused=fused)
            logits.append(lg)
        outs.append((logits, cache))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    for name in ("kp", "vp", "ks", "vs"):
        assert torch.equal(outs[0][1][name][:, 1:], outs[1][1][name][:, 1:])


def test_decode_step_paged_matches_reference():
    jcfg, cfg, jm, jparams, model, params = _setup()
    page, P = 4, 8
    jcache = jm.make_paged_cache(2, P, page)
    cache = model.make_paged_cache(P, page, "cpu")
    bt = np.asarray([[1, 2, 0], [3, 4, 0]], np.int32)
    toks = np.asarray([3, 9], np.int32)
    lengths = np.asarray([0, 5], np.int32)
    jl, _ = jm.decode_step_paged(jparams, jcache, jnp.asarray(toks),
                                 jnp.asarray(lengths), jnp.asarray(bt),
                                 page_size=page, key=None)
    pl, _ = model.decode_step_paged(params, cache, torch.from_numpy(toks),
                                    torch.from_numpy(lengths),
                                    torch.from_numpy(bt), page_size=page)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    assert (pl[:, cfg.vocab:] == -1.0e30).all()
