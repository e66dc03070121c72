"""PyTorch port: the bucketed scheduler, the dense cache and the prefill
splice, against JAX and against the reference's own contracts.

* ``Model.prefill`` (logits and the dense cache entries) and
  ``Model.decode_step`` on the dense cache, run past the smoke window of
  32 so the local layers' ring buffers wrap: float32 parameters carried
  across by ``params_from_jax``; logits within rtol = atol = 2e-4 (the
  dense-family tests' tolerance), float cache rows within it, FP8 cache
  codes at least 99.9 % equal (an RNE code flips on a ~1e-6 difference).
* ``rescale_codes`` and ``write_prefill_pages`` bitwise, stochastic carry
  bits drawn from the same keys; the splice's per-step and per-block keys
  bitwise.
* ``run_bucketed`` on the dense and the paged cache, and
  ``Engine.tail_prefill`` (the prefix cache on): token streams equal the
  reference Engine's, and so do the engine step counts and cache bytes.
* The reference's contracts within the port: continuous == bucketed with
  deterministic KV writes, dense == paged, bucketed prefix on == off,
  rejection, deadlines and cancellation, and the CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.quant import encode as jencode
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro.serving import page_pool as jpp
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.models import Model, params_from_jax
from repro_torch.runtime.steps import build_decode_step, build_prefill_step
from repro_torch.serving import ServeControl, page_pool as pp
from torch_cpu_threads import one_torch_thread  # noqa: F401

RTOL = ATOL = 2e-4
NUMERICS = {"fp8": dict(policy="serve_fp8_paged"), "float": dict(quant="none")}


def _models(arch, numerics, seed=0):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True,
                                           **NUMERICS[numerics]),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True,
                                         **NUMERICS[numerics]),
                              param_dtype="float32")
    jm = JModel(jcfg, max_seq=48)
    jparams = jm.init(jax.random.PRNGKey(seed))
    # lively weights: every leaf redrawn at std 0.5 (embedding at 0.5 /
    # sqrt(d_model) under an embedding scale) so the layers matter
    rng = np.random.default_rng(seed + 11)
    jparams = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype),
        jparams)
    if jcfg.emb_scale:
        jparams["embed"] = jparams["embed"] / jcfg.d_model**0.5
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jm, jparams, Model(cfg, max_seq=48), params


def _close_cache(got, want, fp8):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if fp8:
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("numerics", ["fp8", "float"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-27b", "gemma3-12b"])
def test_prefill_logits_and_caches_match_reference(arch, numerics):
    jm, jparams, m, params = _models(arch, numerics)
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab, size=(2, 40))
    jlogits, jcache = jax.jit(jm.prefill)(jparams,
                                          {"tokens": jnp.asarray(toks)})
    logits, caches = build_prefill_step(m)(
        params, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    period = m.cfg.layer_pattern_period
    assert len(caches) == m.cfg.n_layers
    for i, c in enumerate(caches):
        b, j = divmod(i, period)
        for name in ("k", "v"):
            _close_cache(c[name], jcache["blocks"][j]["self"][name][b],
                         numerics == "fp8")


@pytest.mark.parametrize("numerics", ["fp8", "float"])
@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-12b"])
def test_dense_decode_past_the_window_matches_reference(arch, numerics):
    """44 decode steps of two slots at different positions (0 and 3 on)
    against the dense cache of 48 positions: the local layers keep a ring
    buffer of the window's 32 rows, written at ``pos mod 32``, and admit
    every row once ``pos >= 32``.  Logits and cache rows of every step
    against the reference's ``decode_step``."""
    jm, jparams, m, params = _models(arch, numerics, seed=2)
    cfg = m.cfg
    jcache = jm.make_cache(2, 48)
    cache = m.make_cache(2, 48)
    period = cfg.layer_pattern_period
    widths = [c["k"].shape[1] for c in cache]
    assert widths == [48 if cfg.is_global_attn_layer(i) else 32
                      for i in range(cfg.n_layers)]
    for i, c in enumerate(cache):
        b, j = divmod(i, period)
        assert c["k"].shape == jcache["blocks"][j]["self"]["k"].shape[1:]
    jstep = jax.jit(jm.decode_step)
    step = build_decode_step(m)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(44, 2))
    offs = np.asarray([0, 3])
    for t in range(44):
        pos = offs + t
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[t]),
                           jnp.asarray(pos))
        logits, cache = step(params, cache, torch.as_tensor(toks[t]),
                             torch.as_tensor(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
    for i, c in enumerate(cache):
        b, j = divmod(i, period)
        for name in ("k", "v"):
            _close_cache(c[name], jcache["blocks"][j]["self"][name][b],
                         numerics == "fp8")


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("fmt", ["e5m2", "e4m3"])
def test_rescale_codes_bitwise(fmt, batch):
    """The paper's integer-add multiply by a page scale's reciprocal, with
    stochastic carry-ins (RD or RU per element by one drawn bit): a ratio
    that is not a power of two, so the carries matter; one key, or one per
    leading row.  E4M3 has no directed mul expressions and falls back to
    RNE in both packages."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 256, size=(3, 5, 4, 2, 8)).astype(np.uint8)
    inv = np.float32(0.3)
    key = jax.random.PRNGKey(7)
    if batch:
        keys = jax.random.split(key, 3)
        want = jax.vmap(lambda c, k: jpp.rescale_codes(
            c, inv, fmt, "stochastic", key=k))(jnp.asarray(codes), keys)
        tkey = torch.from_numpy(np.asarray(keys).astype(np.int64))
    else:
        want = jpp.rescale_codes(jnp.asarray(codes), inv, fmt, "stochastic",
                                 key=key)
        tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    got = pp.rescale_codes(torch.from_numpy(codes), torch.tensor(inv), fmt,
                           "stochastic", key=tkey)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for mode in ("rne", "rz"):
        want = jpp.rescale_codes(jnp.asarray(codes), inv, fmt, mode)
        got = pp.rescale_codes(torch.from_numpy(codes), torch.tensor(inv),
                               fmt, mode)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["stochastic", "rne"])
def test_write_prefill_pages_bitwise(mode):
    """A prefill row of 13 scale-1 E5M2 codes spliced into 4 pages of 4:
    each page's pow2 scale from its whole content, the codes rescaled to
    it; for one layer, and for 3 stacked layers with one key each (the
    splice's per-block keys), against the reference's ``vmap``."""
    rng = np.random.default_rng(5)
    src = rng.standard_normal((3, 13, 2, 8)).astype(np.float32)
    src = src * np.asarray([1e-3, 1.0, 300.0], np.float32)[:, None, None,
                                                            None]
    codes = np.asarray(jencode(jnp.asarray(src), "e5m2"))
    pages = np.zeros((3, 9, 4, 2, 8), np.uint8)
    scales = np.ones((3, 9), np.float32)
    ids = np.asarray([5, 2, 7, 1], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    kw = {} if mode == "rne" else {"key": keys}

    def jwrite(p, s, c, k=None):
        return jpp.write_prefill_pages(p, s, c, jnp.asarray(ids), fmt="e5m2",
                                       mode=mode, key=k)

    if mode == "rne":
        want_p, want_s = jax.vmap(jwrite)(jnp.asarray(pages),
                                          jnp.asarray(scales),
                                          jnp.asarray(codes))
    else:
        want_p, want_s = jax.vmap(jwrite)(jnp.asarray(pages),
                                          jnp.asarray(scales),
                                          jnp.asarray(codes), keys)
    tkw = {k: torch.from_numpy(np.asarray(v).astype(np.int64))
           for k, v in kw.items()}
    got_p, got_s = pp.write_prefill_pages(
        torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy()),
        torch.from_numpy(codes.copy()), torch.from_numpy(ids), fmt="e5m2",
        mode=mode, **tkw)
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    # one layer with its own key, and float pages (a cast, scales kept)
    one = pp.write_prefill_pages(
        torch.from_numpy(pages[1].copy()), torch.from_numpy(scales[1].copy()),
        torch.from_numpy(codes[1].copy()), torch.from_numpy(ids), fmt="e5m2",
        mode=mode, **{k: v[1] for k, v in tkw.items()})
    assert torch.equal(one[0], got_p[1]) and torch.equal(one[1], got_s[1])
    fp, fs = pp.write_prefill_pages(
        torch.zeros((9, 4, 2, 8)), torch.ones(9), torch.from_numpy(src[1]),
        torch.from_numpy(ids), fmt=None)
    jp, js = jpp.write_prefill_pages(jnp.zeros((9, 4, 2, 8)), jnp.ones(9),
                                     jnp.asarray(src[1]), jnp.asarray(ids),
                                     fmt=None)
    assert np.array_equal(fp.numpy(), np.asarray(jp))
    assert np.array_equal(fs.numpy(), np.asarray(js))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma2-27b", "gemma3-12b"])
def test_splice_keys_match_reference(arch):
    """The splice's stream key at engine step s is fold_in(fold_in(key,
    1), s); prefill row i's K and V keys fold in 2 i and 2 i + 1 and split
    over the blocks, so every layer of block b takes split(...)[b]."""
    jcfg = jget_config(arch, smoke=True, policy="serve_fp8_paged")
    cfg = get_config(arch, smoke=True, policy="serve_fp8_paged")
    jeng = jserve.Engine(jcfg, slots=1, max_seq=8, page_size=4)
    eng = serve.Engine(cfg, slots=1, max_seq=8, page_size=4, device="cpu")
    period = cfg.layer_pattern_period
    nb = cfg.n_layers // period
    for step in (0, 1, 17):
        jeng._step = eng._step = step
        jkey = jeng._splice_key()
        key = eng._splice_key()
        assert np.array_equal(key.numpy(), np.asarray(jkey))
        for fold in (0, 1, 4, 5):
            want = np.asarray(jax.random.split(
                jax.random.fold_in(jkey, fold), nb))
            got = eng._layer_keys(prng.fold_in(key, fold)).numpy()
            assert np.array_equal(got, np.repeat(want, period, axis=0))
    assert serve.Engine(cfg, slots=1, max_seq=8, stochastic_kv=False,
                        device="cpu")._splice_key() is None


QUEUE = [np.arange(3) + 5, np.arange(9) + 17, np.arange(5) + 40,
         np.arange(1) + 99, np.arange(5) + 60]


def _engine_pair(arch, numerics, cache_impl, **kw):
    """A reference Engine on float32 weights redrawn at std 0.5 (so that
    greedy streams follow the context) and the port's on the same."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True,
                                           **NUMERICS[numerics]),
                               param_dtype="float32")
    jeng = jserve.Engine(jcfg, slots=2, max_seq=24, page_size=4,
                         cache_impl=cache_impl, **kw)
    rng = np.random.default_rng(9)
    jeng.params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype),
        jeng.params)
    cfg = dataclasses.replace(get_config(arch, smoke=True,
                                         **NUMERICS[numerics]),
                              param_dtype="float32")
    eng = serve.Engine(cfg, slots=2, max_seq=24, page_size=4,
                       cache_impl=cache_impl, device="cpu", **kw)
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    return jeng, eng


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
@pytest.mark.parametrize("numerics", ["fp8", "float"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-12b"])
def test_bucketed_streams_match_reference(arch, numerics, cache_impl):
    """``run_bucketed`` (batched prefill of each length bucket, the splice,
    one decode step for all slots) with stochastic KV writes on FP8 pages:
    token streams, engine steps and cache bytes equal the reference's."""
    jeng, eng = _engine_pair(arch, numerics, cache_impl)
    ref, rstats = jserve.run(jeng, QUEUE, gen=6, quiet=True,
                             scheduler="bucketed")
    port, stats = serve.run(eng, QUEUE, gen=6, quiet=True,
                            scheduler="bucketed")
    assert any(len(set(o)) > 1 for o in ref.values())
    assert port == ref
    assert stats["steps"] == rstats["steps"] and eng._step == jeng._step
    assert stats["cache_bytes"] == rstats["cache_bytes"] \
        == jserve.cache_bytes(jeng.cache)
    assert stats["cache_bytes_per_token"] == rstats["cache_bytes_per_token"]
    assert stats["terminal"] == {"finished": len(QUEUE)}
    if cache_impl == "paged":
        eng.pool.assert_invariants()
        assert eng.pool.used_pages == 0


@pytest.mark.parametrize("numerics", ["fp8", "float"])
def test_bucketed_tail_prefill_streams_match_reference(numerics):
    """The bucketed scheduler with the prefix cache on: every admission
    prefills its uncached tail through ``tail_prefill`` (shared masked
    mixed steps), hits map cached pages; streams, hit tokens and prefix
    stats equal the reference's."""
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b", smoke=True,
                                           **NUMERICS[numerics]),
                               param_dtype="float32")
    rng = np.random.default_rng(1)
    head = rng.integers(0, jcfg.vocab, size=8)
    queue = [np.concatenate([head, rng.integers(0, jcfg.vocab, size=t)])
             for t in (4, 6, 4, 5)]
    jeng, eng = _engine_pair("qwen2-0.5b", numerics, "paged",
                             prefix_cache=True)
    ref, rstats = jserve.run(jeng, queue, gen=5, quiet=True,
                             scheduler="bucketed")
    port, stats = serve.run(eng, queue, gen=5, quiet=True,
                            scheduler="bucketed")
    assert port == ref
    assert stats["prefix_hit_tokens"] == rstats["prefix_hit_tokens"] > 0
    assert stats["prefix"] == rstats["prefix"]
    eng.pool.assert_invariants()


# --------------------------------------------------------------------------- #
# The reference's contracts within the port
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def cfg():
    return get_config("qwen2-0.5b", smoke=True, quant="fp8_w8kv8")


def _engine(cfg, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_seq", 16)
    kw.setdefault("cache_impl", "paged")
    kw.setdefault("page_size", 4)
    kw.setdefault("stochastic_kv", False)
    return serve.Engine(cfg, device="cpu", **kw)


def test_continuous_matches_bucketed_tokens(cfg):
    """The reference's ``tests/test_scheduler.py`` contract: same queue,
    greedy sampling, deterministic KV writes: the two schedulers emit the
    same tokens (page codes can differ: chunked prefill sets a page's
    scale from its first token, the splice from the whole page; not
    enough to flip an argmax of the seed's weights at this size.  On
    redrawn weights both packages' streams part, the same way:
    ``test_bucketed_streams_match_reference``)."""
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, size=4 + 3 * (i % 2))
             for i in range(5)]
    outs = {}
    for sched in ("bucketed", "continuous"):
        eng = _engine(cfg)
        outs[sched], stats = serve.run(eng, [q.copy() for q in queue],
                                       gen=6, quiet=True, scheduler=sched)
        assert stats["steps"] > 0
        assert eng.pool.free_pages == eng.pool.num_pages - 1
    assert outs["continuous"] == outs["bucketed"]


def test_paged_engine_matches_dense_engine(cfg):
    """The reference's ``tests/test_paged_serving.py`` contract: greedy
    outputs agree between the cache backends (stochastic KV writes on the
    paged one, as there), and the paged engine admits mixed-length
    prompts."""
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, size=4 + 3 * (i % 2))
             for i in range(5)]
    outs = {}
    for impl in ("dense", "paged"):
        eng = serve.Engine(cfg, slots=3, max_seq=15, cache_impl=impl,
                           page_size=4, device="cpu")
        outs[impl], stats = serve.run(eng, [q.copy() for q in queue], gen=6,
                                      quiet=True)
        assert stats["steps"] > 0
    assert len(outs["paged"]) == 5
    assert outs["dense"] == outs["paged"]


def test_dense_cache_bytes_and_capacity(cfg):
    """The dense cache holds slots x max_seq rows per global layer (codes
    under an FP8 KV policy) and the same capacity in tokens."""
    eng = _engine(cfg, cache_impl="dense")
    assert eng.pool is None
    per_row = cfg.n_kv_heads * cfg.hd * 2  # K and V, one byte a code
    assert eng.kv_cache_bytes() == serve.cache_bytes(eng.cache) \
        == cfg.n_layers * 3 * 16 * per_row
    assert eng.kv_capacity_tokens() == 3 * 16
    with pytest.raises(ValueError, match="continuous scheduler"):
        serve.run(eng, [np.arange(3)], gen=2, quiet=True,
                  scheduler="continuous")
    with pytest.raises(ValueError, match="unknown scheduler"):
        serve.run(eng, [np.arange(3)], gen=2, quiet=True, scheduler="x")
    with pytest.raises(ValueError, match="unknown cache_impl"):
        _engine(cfg, cache_impl="sparse")


def test_prefix_cache_matches_bucketed_tokens():
    """The reference's ``tests/test_prefix_cache.py`` contract under the
    bucketed scheduler: cache off prefills through the batched splice,
    cache on prefills the tails through ``tail_prefill``; deterministic KV
    writes, equal tokens, hits with the cache on."""
    pcfg = get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    rng = np.random.default_rng(1)
    head = rng.integers(0, pcfg.vocab, size=8)
    queue = [np.concatenate([head, rng.integers(0, pcfg.vocab, size=t)])
             for t in (4, 6, 4, 5)]
    outs = {}
    for pc in (False, True):
        eng = _engine(pcfg, slots=2, max_seq=32, prefix_cache=pc)
        outs[pc], stats = serve.run(eng, [q.copy() for q in queue], gen=5,
                                    quiet=True, scheduler="bucketed")
        eng.pool.assert_invariants()
        assert (stats["prefix_hit_tokens"] > 0) == pc
    assert outs[True] == outs[False]


@pytest.mark.parametrize("sched", ["continuous", "bucketed"])
def test_single_oversized_request_rejected(cfg, sched):
    eng = _engine(cfg, slots=2, max_seq=16, num_pages=3)  # 2 usable pages
    outs, stats = serve.run(eng, [np.arange(10) % cfg.vocab], gen=8,
                            quiet=True, scheduler=sched)
    assert outs == {}
    state, reason = stats["statuses"][0]
    assert state == "rejected" and "pages" in reason
    assert stats["terminal"] == {"rejected": 1}
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    eng.pool.assert_invariants()


@pytest.mark.parametrize("cache_impl", ["paged", "dense"])
def test_bucketed_deadline_expiry_isolates_survivors(cfg, cache_impl):
    """Requests that blow their step budget time out on their own; the
    ones that finish emit the fault-free run's tokens (stochastic KV
    writes on)."""
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, size=6) for _ in range(3)]
    kw = dict(slots=1, stochastic_kv=True, cache_impl=cache_impl)
    want, _ = serve.run(_engine(cfg, **kw), [q.copy() for q in queue],
                        gen=4, quiet=True, scheduler="bucketed")
    eng = _engine(cfg, **kw)
    got, stats = serve.run(eng, [q.copy() for q in queue], gen=4,
                           quiet=True, scheduler="bucketed",
                           deadline_steps=5)
    assert stats["terminal"].get("timed_out", 0) >= 1 and got
    for rid, toks in got.items():
        assert toks == want[rid], rid
    for rid, (state, reason) in stats["statuses"].items():
        assert state == ("finished" if rid in got else "timed_out")
        if rid not in got:
            assert "deadline" in reason
    if eng.pool is not None:
        eng.pool.assert_invariants()
        assert eng.pool.used_pages == 0


def test_bucketed_cancellation_via_control(cfg):
    rng = np.random.default_rng(2)
    queue = [rng.integers(0, cfg.vocab, size=4) for _ in range(3)]
    want, _ = serve.run(_engine(cfg, slots=2, stochastic_kv=True),
                        [q.copy() for q in queue], gen=6, quiet=True,
                        scheduler="bucketed")
    control = ServeControl()

    def on_token(rid, tok, step):
        if rid == 1:
            control.cancel(1)

    eng = _engine(cfg, slots=2, stochastic_kv=True)
    got, stats = serve.run(eng, [q.copy() for q in queue], gen=6,
                           quiet=True, scheduler="bucketed",
                           control=control, on_token=on_token)
    assert stats["statuses"][1][0] == "cancelled"
    assert sorted(got) == [0, 2]
    for rid in got:
        assert got[rid] == want[rid], rid
    eng.pool.assert_invariants()
    assert eng.pool.used_pages == 0


def test_bucketed_arrivals_and_max_tokens(cfg):
    """Requests arriving later wait (steps pass with nothing in flight),
    and ``max_tokens`` caps every stream."""
    rng = np.random.default_rng(4)
    queue = [rng.integers(0, cfg.vocab, size=4) for _ in range(3)]
    eng = _engine(cfg, slots=2, cache_impl="dense")
    outs, stats = serve.run(eng, queue, gen=10, quiet=True,
                            scheduler="bucketed", arrivals=[0, 6, 20],
                            max_tokens=3)
    assert sorted(outs) == [0, 1, 2]
    assert all(len(v) == 3 for v in outs.values())
    assert stats["steps"] >= 20


def test_prefix_cache_needs_the_paged_cache():
    cfg = get_config("qwen2-0.5b", smoke=True)
    with pytest.raises(ValueError, match="cache_impl='paged'"):
        serve.Engine(cfg, slots=1, max_seq=16, cache_impl="dense",
                     prefix_cache=True, device="cpu")


@pytest.mark.parametrize("argv", [
    ["--scheduler", "bucketed", "--cache-impl", "dense"],
    ["--cache-impl", "dense", "--policy", "serve_fp8_paged"],
    ["--scheduler", "bucketed", "--prefix-cache", "on", "--shared-prefix",
     "8", "--page-size", "4"],
])
def test_cli_bucketed_on_cpu(capsys, argv):
    outputs = serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device",
                          "cpu", "--requests", "3", "--slots", "2",
                          "--gen", "3", "--prompt-len", "2,6"] + argv)
    assert sorted(outputs) == [0, 1, 2]
    out = capsys.readouterr().out
    assert "[serve:bucketed:" in out
    if "--scheduler" not in argv:
        assert "falling back to the bucketed scheduler" in out
    if "--prefix-cache" in argv:
        assert "prefix hit tokens" in out
