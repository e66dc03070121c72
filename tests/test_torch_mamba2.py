"""PyTorch port: mamba2-780m (Mamba2's SSD mixer, an attention-free stack)
served, against JAX and against the port's own bitwise contracts.

The same numpy inputs, from a seed, go through the reference's functions
and the port's at mamba2's smoke widths (d_model 64, d_inner 128, 8 SSD
heads of 16, d_state 16, conv width 4, 2 layers):

* ``ssd_forward`` (output, ``conv`` and ``state``) over two chunks and
  over one, and ``ssd_decode`` over four tokens from its cache, in float32
  within ``F32_TOL`` of the largest magnitude (the same products summed
  in another order) and in bf16 within ``BF16_TOL`` of it (the conv's
  chain of bf16 products and adds, which XLA may fuse at a wider
  precision than torch's op-by-op rounding, then every later product of
  the rounded inputs); softplus as the reference's ``logaddexp(x, 0)``;
* ``params_from_jax`` on the mamba leaves (float32 ``A_log``, ``Dskip``,
  ``dt_bias`` as they are) and ``Model.init``'s tree;
* the static weights' codes and scales bitwise against
  ``quantize_params`` (``w_z``, ``w_x``, ``w_B``, ``w_C``, ``w_dt``,
  ``out_proj``); the engine's logits with those codes through the plain
  K2 and K3 against the reference's, and 6 K2 calls a layer a sub-step;
* the engine's first-step logits (float32 parameters) and its token
  streams under each scheduler and both cache kinds, with ``fp8_w8kv8``
  (the reference test's policy) and ``serve_fp8_paged``, each against the
  JAX engine's run of the same scheduler (the reference's own continuous
  and bucketed streams differ, ``tests/test_scheduler.py``, so their
  equality is no oracle).

Then the port's contracts on lively weights (every leaf at std 0.5, so
that streams follow the context), each bitwise: a rerun, preempt/restore
== a worst-case pool, bucketed on the paged cache == on the dense cache,
fused == unfused, a chaos kill's survivors; a snapshot round trip while
PREEMPTED; and what is refused: the prefix cache and a mesh (as in the
reference).  Training: ``test_torch_mamba2_train.py``.
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
from repro.models import mamba2 as jmamba
from repro.models.quantize import quantize_params as jquantize_params
from repro.numerics import as_policy as jas_policy
from repro_torch.configs import get_config
from repro_torch.core.quant import QTensor
from repro_torch.kernels import lns_matmul as lm
from repro_torch.launch import serve
from repro_torch.models import Model, mamba2, params_from_jax, transformer
from repro_torch.models.quantize import quantize_params
from repro_torch.optim import adamw
from repro_torch.runtime import fault, steps
from repro_torch.serving import (ContinuousScheduler, FaultPlan, Request,
                                 load_snapshot, save_snapshot)
from test_torch_mesh import _stand_in
from test_torch_mla import _conv, _flat, _jf, _lively, _np
from test_torch_static_weights import _matmul_policy
from torch_cpu_threads import one_torch_thread  # noqa: F401

ARCH = "mamba2-780m"
F32_TOL = 1e-5     # x the largest |output|: float32 sums in another order
BF16_TOL = 2.0**-6  # four bf16 ulps of the largest |output|
LOGIT_TOL = 2e-4


def _cfgs(policy="serve_fp8_paged", **changes):
    kw = dict(policy=policy) if policy else dict(quant="none")
    return (dataclasses.replace(jget_config(ARCH, smoke=True, **kw),
                                **changes),
            dataclasses.replace(get_config(ARCH, smoke=True, **kw),
                                **changes))


def _close(got, want, tol):
    want = _jf(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def _mixer_params(jcfg, seed=0):
    """The reference's mixer leaves, with ``A_log``, ``dt_bias`` and the
    conv bias drawn too (their init is constant), so that the decays,
    ``dt`` and the conv's bias all vary across heads and channels."""
    jp = dict(jmamba.mamba2_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    nh = jp["A_log"].shape[0]
    jp["A_log"] = jnp.asarray(rng.uniform(-1.0, 1.0, nh), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.uniform(-2.0, 1.0, nh), jnp.float32)
    jp["conv_b"] = jnp.asarray(
        0.1 * rng.standard_normal(jp["conv_b"].shape), jcfg.pdtype)
    jp["norm"] = jnp.asarray(
        0.1 * rng.standard_normal(jp["norm"].shape), jcfg.pdtype)
    return jp, {k: _conv(v) for k, v in jp.items()}


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


# --------------------------------------------------------------------------- #
# The SSD mixer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("chunk", [4, 128], ids=["two_chunks", "one_chunk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_forward_matches_jax(dtype, chunk):
    """The chunked full-sequence SSD over S = 8 (two chunks of 4, so the
    inter-chunk recurrence runs, or one): y, the conv cache (the last
    three pre-activation inputs) and the end state."""
    jcfg, cfg = _cfgs(param_dtype=dtype)
    jp, p = _mixer_params(jcfg)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 8, cfg.d_model)), jcfg.pdtype)
    jy, jc = jax.jit(lambda p_, x_: jmamba.ssd_forward(p_, x_, jcfg,
                                                       chunk=chunk))(jp, x)
    y, c = mamba2.ssd_forward(p, _conv(x), cfg, chunk=chunk)
    assert y.dtype == cfg.pdtype and c["state"].dtype == torch.float32
    assert c["conv"].shape == (2, cfg.ssm_conv_width - 1,
                               2 * cfg.d_model + 2 * cfg.ssm_state)
    _close(y, jy, _tol(dtype))
    _close(c["state"], jc["state"], _tol(dtype))
    _close(c["conv"], jc["conv"], _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_matches_jax(dtype):
    """Four decode tokens from the reference's prefill cache, each step in
    both packages from the reference's cache of the step before: y and
    the new conv and state within the dtype's tolerance (the conv rows
    move along bitwise)."""
    jcfg, cfg = _cfgs(param_dtype=dtype)
    jp, p = _mixer_params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((3, 5, cfg.d_model)), jcfg.pdtype)
    _, jcache = jax.jit(lambda p_, x_: jmamba.ssd_forward(p_, x_, jcfg))(
        jp, x)
    jdecode = jax.jit(lambda p_, x_, c_: jmamba.ssd_decode(p_, x_, jcfg, c_))
    for t in range(4):
        xt = jnp.asarray(rng.standard_normal((3, 1, cfg.d_model)),
                         jcfg.pdtype)
        cache = {k: _conv(v) for k, v in jcache.items()}
        y, c = mamba2.ssd_decode(p, _conv(xt), cfg, cache)
        jy, jcache = jdecode(jp, xt, jcache)
        _close(y, jy, _tol(dtype))
        _close(c["state"], jcache["state"], _tol(dtype))
        np.testing.assert_array_equal(_np(c["conv"][:, :-1]),
                                      _jf(jcache["conv"][:, :-1]))
        _close(c["conv"], jcache["conv"], _tol(dtype))


def test_ssd_forward_refuses_a_ragged_chunk():
    """``S % chunk`` must be 0, as the reference asserts: nothing is
    padded."""
    jcfg, cfg = _cfgs()
    jp, p = _mixer_params(jcfg)
    x = np.zeros((1, 6, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jmamba.ssd_forward(jp, jnp.asarray(x, jcfg.pdtype), jcfg, chunk=4)
    with pytest.raises(ValueError, match="S % chunk"):
        mamba2.ssd_forward(p, torch.from_numpy(x).to(cfg.pdtype), cfg,
                           chunk=4)


def test_softplus_is_the_references_logaddexp():
    """Above torch's ``softplus`` threshold (20) too: ``logaddexp(x, 0)``
    at every x, as ``jax.nn.softplus``."""
    x = np.concatenate([np.linspace(-40, 40, 801), [15.0, 19.5, 20.5, 88.0]])
    x = x.astype(np.float32)
    np.testing.assert_allclose(
        mamba2.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2e-7, atol=0)


def test_masked_decode_keeps_the_old_entry():
    """A masked sub-step (``paged["active"]``): an active slot's new
    conv and state equal the unmasked sub-step's bitwise, an inactive
    slot's stay as they were, written in place."""
    _, cfg = _cfgs(param_dtype="float32")
    p = Model(cfg).init(torch.Generator().manual_seed(0))["blocks"][0]
    g = torch.Generator().manual_seed(1)
    entry = Model(cfg)._ssd_entry((3,), "cpu")
    entry = {k: torch.randn(v.shape, generator=g) for k, v in entry.items()}
    x = torch.randn((3, 1, cfg.d_model), generator=g)
    kw = dict(mixer="mamba", ffn="none", site="blocks.0")
    full = {k: v.clone() for k, v in entry.items()}
    y_full = transformer.sublayer_decode(p, x, cfg, cache=full, **kw)
    masked = {k: v.clone() for k, v in entry.items()}
    active = torch.tensor([True, False, True])
    y = transformer.sublayer_decode(p, x, cfg, cache=masked,
                                    paged={"active": active}, **kw)
    assert torch.equal(y[active], y_full[active])
    for k in entry:
        assert not torch.equal(full[k][1], entry[k][1])
        assert torch.equal(masked[k][active], full[k][active])
        assert torch.equal(masked[k][~active], entry[k][~active])


# --------------------------------------------------------------------------- #
# Parameters, static weights
# --------------------------------------------------------------------------- #
def test_config_params_from_jax_and_init():
    """``get_config`` returns the reference's config; the reference's tree
    comes across leaf for leaf (float32 ``A_log``, ``Dskip``,
    ``dt_bias``); ``Model.init`` draws the same tree of shapes and dtypes;
    the full config has no FFN (``d_ff = 0``)."""
    full = get_config(ARCH)
    ref = jget_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.ssm_state,
            full.ssm_head_dim, full.ssm_conv_width, full.vocab,
            full.attn_impl, full.d_ff, full.tie_embeddings) == \
        (ref.family, 48, 1536, 128, 64, 4, 50280, "none", 0, True)
    assert mamba2.dims(full) == (3072, 48, 64, 128)
    assert [transformer.ffn_kind(full, i) for i in (0, 47)] == ["none"] * 2
    jcfg, cfg = _cfgs()
    jparams = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert len(params["blocks"]) == cfg.n_layers
    # the reference's smoke config keeps an MLP of d_ff 128 in each layer
    assert set(params["blocks"][0]) == {"ln1", "mamba", "ln2", "ffn"}
    mix = params["blocks"][1]["mamba"]
    for name in ("A_log", "Dskip", "dt_bias"):
        assert mix[name].dtype == torch.float32
    for path, t in _flat(params["blocks"][1]).items():
        np.testing.assert_array_equal(
            _np(t), _jf(_flat(jparams["blocks"][0])[path][1]))
    own = Model(cfg).init(torch.Generator().manual_seed(0))
    assert {p: (tuple(t.shape), t.dtype) for p, t in _flat(own).items()} \
        == {p: (tuple(t.shape), t.dtype) for p, t in _flat(params).items()}
    assert torch.equal(own["blocks"][0]["mamba"]["Dskip"],
                       torch.ones(cfg.ssm_expand * cfg.d_model
                                  // cfg.ssm_head_dim))


def test_static_codes_bitwise_equal_quantize_params():
    """The six projections of every layer as codes and a scale bitwise
    equal to the reference's ``quantize_params`` (per block there, per
    layer here); the conv weights, norms and float32 leaves stay float.
    ``d_ff = 0`` as in the full config (the smoke config keeps an MLP)."""
    jcfg, cfg = _cfgs(d_ff=0)
    jparams = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(3))
    want = params_from_jax(jax.tree.map(np.asarray, jquantize_params(
        jparams, jas_policy(jcfg.policy))), cfg)
    got = quantize_params(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg), cfg.policy,
                          period=cfg.layer_pattern_period)
    flat_w, quantized = _flat(want), set()
    for path, w in _flat(got).items():
        v = flat_w[path]
        assert isinstance(w, QTensor) == isinstance(v, QTensor), path
        if isinstance(w, QTensor):
            quantized.add(path[-1])
            assert w.fmt == v.fmt == "e4m3", path
            assert torch.equal(w.codes, v.codes), path
            assert torch.equal(w.scale, v.scale), path
        else:
            assert torch.equal(w, v), path
    assert quantized == {"w_z", "w_x", "w_B", "w_C", "w_dt", "out_proj"}
    n_q = sum(isinstance(w, QTensor) for w in _flat(got).values())
    assert n_q == 6 * cfg.n_layers


@pytest.mark.parametrize("impl", ["fused_dequant", "lns"])
def test_static_weights_through_the_kernels_match_reference(impl):
    """Static codes under a policy that quantizes matmuls (K2 for
    ``fused_dequant``, K3 for ``lns``; their plain versions on the CPU,
    the reference's Pallas kernels interpreted): a bucketed prefill's
    logits and the next dense decode step's within rtol = atol = 2e-4 of
    the reference's, and the same greedy tokens."""
    jpol, pol = _matmul_policy(impl)
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True),
                               numerics=jpol, param_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), numerics=pol,
                              param_dtype="float32")
    jeng = jserve.Engine(jcfg, slots=2, max_seq=12, cache_impl="dense",
                         static_weights=True)
    eng = serve.Engine(cfg, slots=2, max_seq=12, cache_impl="dense",
                       device="cpu")
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    assert isinstance(eng.params["blocks"][0]["mamba"]["w_dt"], QTensor)
    prompts = [np.arange(4) + 7, np.arange(4) + 30]
    jfirst, _ = jeng.prefill_batch(prompts, [0, 1])
    first, _ = eng.prefill_batch(prompts, [0, 1])
    assert first.tolist() == jfirst.tolist()
    pos = np.asarray([4, 4])
    want = jeng.decode(np.asarray(jfirst), pos)
    got = eng.decode(first, pos)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert got.argmax(-1).tolist() == want.argmax(-1).tolist()


def test_static_products_per_layer_reach_k2():
    """Static weights under ``fused_dequant``: every sub-step multiplies
    the six projections of each layer as codes through K2's wrapper
    (``w_dt``'s N = 8 heads among them), and nothing else; ``d_ff = 0``
    as in the full config."""
    _, pol = _matmul_policy("fused_dequant")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), numerics=pol,
                              d_ff=0)
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
    D = cfg.d_model
    di, nh, _, N = mamba2.dims(cfg)
    assert sorted(set(calls)) == sorted({(D, di), (D, N), (D, nh), (di, D)})


# --------------------------------------------------------------------------- #
# The engine against the JAX engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["serve_fp8_paged", None],
                         ids=["serve_fp8_paged", "default"])
def test_engine_first_step_logits_match_jax_engine(policy):
    """A prefill chunk (4 and 3 tokens) and one decode step of the smoke
    engine on the JAX engine's float32 parameters: logits within 2e-4;
    the states are dense per-slot leaves [n_layers, slots, ...], and no
    KV noise is drawn, the stochastic stream key notwithstanding."""
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
    assert set(eng.cache) == {"conv", "state"}
    assert eng.cache["state"].dtype == torch.float32
    assert eng.cache["conv"].shape[:2] == (cfg.n_layers, 2)
    # a stack without pages draws no KV noise and derives no write keys
    assert (eng._token_key is not None) == (policy is not None)
    assert eng.model.kv_noise(eng._token_key,
                              torch.zeros((4, 2), dtype=torch.int32)) is None
    assert eng.model._key_cache is None


STREAM_CASES = [("continuous", "paged"), ("bucketed", "paged"),
                ("bucketed", "dense")]


def _stream_setup(quant, slots):
    kw = (dict(quant=quant) if quant == "fp8_w8kv8"
          else dict(policy=quant))
    jcfg = jget_config(ARCH, smoke=True, **kw)
    cfg = get_config(ARCH, smoke=True, **kw)
    rng = np.random.default_rng(1)
    queue = [rng.integers(0, cfg.vocab, size=3 + 2 * (i % 2))
             for i in range(3)]
    geo = dict(slots=slots, max_seq=10, page_size=4, stochastic_kv=False)
    return jcfg, cfg, queue, geo


def _streams(jcfg, cfg, queue, geo, cases, params=None):
    """{(package, scheduler, cache kind): streams} on the JAX engine's
    parameters, chunk 2, 4 generated."""
    out = {}
    for sched, impl in cases:
        jeng = jserve.Engine(jcfg, cache_impl=impl, **geo)
        if params is None:
            params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                     cfg)
        out["jax", sched, impl], _ = jserve.run(
            jeng, [q.copy() for q in queue], gen=4, quiet=True,
            scheduler=sched, chunk=2)
        eng = serve.Engine(cfg, device="cpu", cache_impl=impl, **geo)
        eng.params = params
        out["port", sched, impl], _ = serve.run(
            eng, [q.copy() for q in queue], gen=4, quiet=True,
            scheduler=sched, chunk=2)
    return out


@pytest.mark.parametrize("quant", ["fp8_w8kv8", "serve_fp8_paged"])
def test_each_scheduler_matches_the_jax_engine(quant):
    """The reference test's settings (max_seq 10, page 4, deterministic KV
    rounding, chunk 2, 4 generated, 3 prompts of 3 and 5 tokens) with a
    slot for each request, so that no request starts in a slot another
    one used: each scheduler and cache kind of the port gives the JAX
    engine's streams of the same scheduler and cache kind on the same
    parameters."""
    out = _streams(*_stream_setup(quant, slots=3), STREAM_CASES)
    for sched, impl in STREAM_CASES:
        assert out["port", sched, impl] == out["jax", sched, impl], \
            (sched, impl)


def test_a_reused_slot_starts_from_the_zero_state(monkeypatch):
    """The reference test's own settings (2 slots, so the third request
    takes a slot the first one used).  The reference's continuous
    scheduler never resets a slot's SSD state at an admission, so that
    request starts from its predecessor's state, and the reference's
    continuous streams part from its bucketed ones (its failing
    ``test_continuous_matches_bucketed_dense_entry_families[mamba2-780m]``).
    The port zeroes the slot's dense per-slot leaves at every admission:
    its continuous streams equal its bucketed ones and the JAX engine's
    bucketed ones; with that reset taken out, they are the JAX engine's
    continuous streams, bitwise."""
    jcfg, cfg, queue, geo = _stream_setup("fp8_w8kv8", slots=2)
    out = _streams(jcfg, cfg, queue, geo, STREAM_CASES[:2])
    assert out["jax", "continuous", "paged"] != out["jax", "bucketed", "paged"]
    assert out["port", "continuous", "paged"] == \
        out["port", "bucketed", "paged"] == out["jax", "bucketed", "paged"]
    monkeypatch.setattr(serve.Engine, "_clear_slot", lambda self, slot: None)
    leaky = _streams(jcfg, cfg, queue, geo, STREAM_CASES[:1])
    assert leaky["port", "continuous", "paged"] == \
        out["jax", "continuous", "paged"]


# --------------------------------------------------------------------------- #
# The port's own bitwise contracts
# --------------------------------------------------------------------------- #
def _prompts(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(s))
            for s in rng.integers(4, 14, size=n)]


@pytest.fixture(scope="module")
def lively():
    _, cfg = _cfgs()
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


CONTRACTS = ["rerun", "preempt", "bucketed-paged-dense", "fused-unfused",
             "chaos"]


@pytest.mark.parametrize("contract", CONTRACTS)
def test_bitwise_contracts_hold_on_mamba2(contract, lively, tmp_path):
    """Each pair of token streams bitwise equal on lively weights; the
    streams vary."""
    cfg, params = lively
    queue = _prompts(cfg)
    if contract == "rerun":
        (a, _), (b, _) = (_run(cfg, params, queue) for _ in range(2))
    elif contract == "preempt":
        (a, sa), (b, _) = (_run(cfg, params, queue, num_pages=6)
                           , _run(cfg, params, queue))
        assert sa["preemptions"] >= 1 and sa["restores"] >= 1
    elif contract == "bucketed-paged-dense":
        (a, _), (b, _) = (_run(cfg, params, queue, "bucketed",
                               cache_impl=impl) for impl in ("paged", "dense"))
    elif contract == "fused-unfused":
        (a, _), (b, _) = (_run(cfg, params, queue, fused_decode=f)
                          for f in (True, False))
    else:
        def make():
            return _engine(cfg, params)
        b, _ = fault.run_serving(make, queue, gen=8, log=lambda *x: None)
        a, stats = fault.run_serving(
            make, queue, gen=8, log=lambda *x: None,
            chaos=FaultPlan(kill_at_step=9), ckpt_dir=tmp_path / "ck",
            snapshot_every=3)
        assert stats["restarts"] == 1 and stats["chaos"]["killed"] == 1
        assert stats["terminal"]["finished"] == len(queue)
    assert a == b
    assert sum(len(set(o)) > 1 for o in b.values()) >= len(b) - 1


def test_preempt_spills_and_restores_the_state_verbatim(lively):
    """A preempted slot's conv and state rows leave as copies of the
    cache's rows at the spill and come back into another slot bitwise."""
    cfg, params = lively
    eng = _engine(cfg, params)
    eng.pool.ensure_capacity_batch(np.asarray([5, 5]))
    eng.step_chunk(np.arange(10).reshape(2, 5).astype(np.int32),
                   np.zeros(2, np.int32), np.asarray([5, 5], np.int32))
    before = {k: t[:, 0].clone() for k, t in eng.cache.items()}
    record = eng.preempt_slot(0)
    assert set(record["state"]) == {"conv", "state"}
    for k, t in record["state"].items():
        assert t.shape[:2] == (cfg.n_layers, 1)
        assert torch.equal(t[:, 0], before[k])
    eng.release(1)
    for t in eng.cache.values():
        t.zero_()
    eng.restore_slot(1, record)
    for k, t in eng.cache.items():
        assert torch.equal(t[:, 1], before[k])


def test_snapshot_roundtrip_while_preempted(lively, tmp_path):
    """A snapshot taken while a request sits PREEMPTED (its conv and state
    rows spilled to the host; bf16 conv through its 16-bit pattern)
    restores into a fresh engine: every cache leaf and spill tensor
    ``torch.equal``, and both finish alike."""
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
    assert eng2.cache["conv"].dtype == torch.bfloat16
    for name, t in eng.cache.items():
        assert torch.equal(eng2.cache[name], t), name
    for r, r2 in zip(sched.preempted, sched2.preempted):
        assert set(r.spill["state"]) == {"conv", "state"}
        for name, t in r.spill["state"].items():
            assert torch.equal(r2.spill["state"][name], t), name
    assert sched2.run() == sched.run()


def test_cli_serves_mamba2(capsys):
    """``--arch mamba2-780m`` through the serve CLI on the CPU, the
    default policy and FP8 (whose KV settings an SSM stack never reads),
    continuous and bucketed on the dense cache."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--gen", "4", "--prompt-len", "3,7"]
    runs = [serve.main(base + extra) for extra in (
        [], ["--policy", "serve_fp8_paged"],
        ["--scheduler", "bucketed", "--cache-impl", "dense"])]
    for outputs in runs:
        assert sorted(outputs) == [0, 1, 2]
        assert all(len(o) == 4 for o in outputs.values())
    assert "[serve:continuous:cpu] 3 requests" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# What is refused
# --------------------------------------------------------------------------- #
def test_prefix_cache_mesh_and_training_are_refused():
    """As in the reference: the prefix cache and mesh serving need a
    pure-GQA paged cache (an SSM keeps dense per-slot states).  Training
    mamba2, refused here until ROADMAP.md Queue 1 item 11c-train, trains
    since: ``test_torch_mamba2_train.py`` holds it against JAX and runs
    the training CLI."""
    jcfg, cfg = _cfgs()
    for eng_cls, c, kw in ((jserve.Engine, jcfg, {}),
                           (serve.Engine, cfg, dict(device="cpu"))):
        with pytest.raises(ValueError, match="pure-GQA paged KV cache"):
            eng_cls(c, slots=2, max_seq=8, prefix_cache=True, **kw)
    for mod, c in ((jserve, jcfg), (serve, cfg)):
        with pytest.raises(ValueError, match="pure-GQA paged cache"):
            mod.Engine._validate_mesh(c, _stand_in(2), "paged")
    steps.build_train_step(Model(cfg), adamw.OptConfig())
