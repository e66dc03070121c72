"""PyTorch port: ref-counted prefix caching against the JAX package.

* The pool is checked differentially: one random sequence of allocations,
  shares, matches (peeking and not), registrations, copy-on-writes, spills
  that pin registered pages, restores, unpins, evictions and frees drives
  the port's pool and the reference's; block tables, owner lists,
  refcounts, the free list, the LRU order, the pins, the index and
  ``prefix_stats`` must stay identical after every operation.
* The reference's prefix-cache tests that apply to the continuous
  scheduler are ported (``tests/test_prefix_cache.py``): cache on == off
  bit for bit with stochastic KV writes, the whole-prompt COW,
  preempt-while-shared, the admission budget of revived LRU pages, the
  refcount/LRU/COW/pin unit cases, the partition invariant through a
  contended workload, position-addressed KV writes, the guard rails.
* The Engine's page hashes equal the reference Engine's hex strings, and
  its prefix-on token streams equal the reference's prefix-on streams.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.serving import PagePool as JPagePool
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import params_from_jax
from repro_torch.serving import ContinuousScheduler, PagePool, Request


@pytest.fixture(scope="module")
def cfg():
    return get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")


def _engine(cfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 32)
    kw.setdefault("page_size", 4)
    return serve.Engine(cfg, device="cpu", **kw)


def _shared_prefix_queue(cfg, seed, *, shared=12, tails=(4, 5, 6, 4, 7)):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab, size=shared)
    return [np.concatenate([head, rng.integers(0, cfg.vocab, size=t)])
            for t in tails]


def _lively(eng, seed=0):
    """Every parameter redrawn at std 0.5, the embedding at 0.5 /
    sqrt(d_model) under gemma's embedding scale, so that greedy streams
    follow the context."""
    g = torch.Generator().manual_seed(seed)

    def redraw(t):
        if isinstance(t, dict):
            return {k: redraw(v) for k, v in t.items()}
        if isinstance(t, list):
            return [redraw(v) for v in t]
        return (torch.randn(t.shape, generator=g) * 0.5).to(t.dtype)

    eng.params = redraw(eng.params)
    if eng.cfg.emb_scale:
        eng.params["embed"] = eng.params["embed"] / eng.cfg.d_model**0.5
    return eng


# --------------------------------------------------------------------------- #
# The pool against the reference's
# --------------------------------------------------------------------------- #
def _pool_state(p):
    return (p.block_tables.tolist(), [list(map(int, x)) for x in p.pages_of],
            p.ref.tolist(), [int(x) for x in p._free], list(p._lru),
            dict(p._pinned), dict(p._index), p.prefix_stats(), p.free_pages,
            p.used_pages, p.cached_pages, p.writable_mask().tolist(),
            p.version, p.spills, p.restores, p.peak_used_pages)


@pytest.mark.parametrize("seed", range(4))
def test_pool_prefix_differential_against_reference(seed):
    rng = np.random.default_rng(200 + seed)
    geo = dict(num_pages=14, page_size=4, slots=3, max_pages_per_slot=5)
    a, b = PagePool(**geo), JPagePool(**geo)
    keys = [f"k{i}" for i in range(10)]
    records = []   # spill records: (n spilled, pinned)
    seen = set()
    for i in range(400):
        op = int(rng.integers(0, 10))
        slot = int(rng.integers(0, 3))
        owned = a.pages_of[slot]
        if op == 0:
            n = int(rng.integers(1, 3))
            calls = [lambda p: p.alloc(slot, n)]
        elif op == 1:
            calls = [lambda p: p.free_slot(slot)]
        elif op == 2 and owned:
            key = keys[int(rng.integers(0, len(keys)))]
            pid = owned[int(rng.integers(0, len(owned)))]
            calls = [lambda p: p.register_prefix(key, pid)]
        elif op == 3:
            probe = [keys[j] for j in rng.integers(0, len(keys), size=3)]
            peek = bool(rng.integers(0, 2))
            calls = [lambda p: p.match_prefix(probe, peek=peek)]
        elif op == 4:
            probe = [keys[j] for j in rng.permutation(len(keys))[:2]]
            ids = a.match_prefix(probe, peek=True)
            calls = [lambda p: p.share(slot, ids)]
        elif op == 5 and owned:
            logical = int(rng.integers(0, len(owned)))
            calls = [lambda p: p.cow_page(slot, logical)]
        elif op == 6 and owned:
            calls = [lambda p: p.spill_slot(slot)]
        elif op == 7 and records and not owned:
            n, pinned = records[0]
            if not a.can_alloc(n) or n + len(pinned) > 5:
                continue
            records.pop(0)
            calls = [lambda p: p.restore_slot(slot, n, pinned)]
        elif op == 8 and records:
            _, pinned = records.pop(int(rng.integers(0, len(records))))
            calls = [lambda p: p.unpin(pinned)]
        elif op == 9:
            want = rng.integers(0, 21, size=3)
            calls = [lambda p: p.ensure_capacity_batch(want)]
        else:
            continue
        got = []
        for pool in (a, b):
            try:
                got.append(("ok", calls[0](pool)))
            except (RuntimeError, AssertionError) as e:
                got.append(("raised", type(e).__name__ == "RuntimeError"
                            and "exhausted" in str(e)))
        assert got[0] == got[1], f"op {i} ({op}): {got}"
        if op == 6:
            spilled, pinned = got[0][1]
            records.append((len(spilled), pinned))
            seen.add("pinned" if pinned else "spilled")
        if op == 5 and got[0][0] == "ok":
            seen.add("cow")
        assert _pool_state(a) == _pool_state(b), f"op {i} ({op})"
        a.assert_invariants()
        b.assert_invariants()
    assert a.evictions > 0 and a.prefix_hits > 0 and a.cow_copies > 0
    assert seen >= {"pinned", "cow"} and a.restores > 0


def test_share_and_release_refcounts():
    pool = PagePool(num_pages=10, page_size=4, slots=3, max_pages_per_slot=4)
    a = pool.alloc(0, 2)
    for i, pid in enumerate(a):
        pool.register_prefix(f"h{i}", pid)
    pool.share(1, a)
    assert pool.ref[a[0]] == 2 and pool.ref[a[1]] == 2
    assert not pool.writable(a[0])  # shared: never written into
    pool.free_slot(0)
    assert pool.ref[a[0]] == 1  # still referenced by slot 1
    pool.free_slot(1)
    # last reference dropped: registered pages park in the LRU, matchable
    assert pool.ref[a[0]] == 0
    assert pool.match_prefix(["h0", "h1"]) == a
    assert pool.free_pages == 9  # parked pages are allocatable (evictable)
    pool.assert_invariants()
    pool.share(2, a)  # re-share revives them out of the LRU
    assert pool.ref[a[0]] == 1
    pool.assert_invariants()


def test_eviction_takes_lru_never_referenced_pages():
    pool = PagePool(num_pages=6, page_size=4, slots=2, max_pages_per_slot=5)
    a = pool.alloc(0, 3)
    for i, pid in enumerate(a):
        pool.register_prefix(f"h{i}", pid)
    pool.free_slot(0)          # 3 registered pages parked, LRU order a[0..2]
    keep = pool.match_prefix(["h0"])
    pool.share(1, keep)        # a[0] referenced again
    got = pool.alloc(1, 4)     # needs eviction: only 2 free + 2 evictable
    assert pool.evictions == 2
    assert a[0] not in got     # the referenced page survived
    assert pool.match_prefix(["h0"], peek=True) == [a[0]]
    assert pool.match_prefix(["h1"], peek=True) == []  # evicted
    pool.assert_invariants()
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(0, 1)  # nothing evictable is left


def test_cow_page_replaces_mapping_and_derefs_source():
    pool = PagePool(num_pages=8, page_size=4, slots=2, max_pages_per_slot=3)
    a = pool.alloc(0, 2)
    pool.register_prefix("h0", a[0])
    pool.register_prefix("h1", a[1])
    pool.share(1, a)
    old, new = pool.cow_page(1, 1)
    assert old == a[1] and new not in a
    assert pool.pages_of[1] == [a[0], new]
    assert pool.block_tables[1, 1] == new
    assert pool.ref[old] == 1 and pool.ref[new] == 1
    assert pool.writable(new) and not pool.writable(old)
    assert pool.cow_copies == 1
    pool.assert_invariants()


def test_spill_pins_registered_pages_and_frees_exclusive_exactly_once():
    pool = PagePool(num_pages=10, page_size=4, slots=2, max_pages_per_slot=4)
    a = pool.alloc(0, 4)
    pool.register_prefix("h0", a[0])
    pool.register_prefix("h1", a[1])
    spilled, pinned = pool.spill_slot(0)
    assert spilled == a[2:] and pinned == [(0, a[0]), (1, a[1])]
    # exclusive ids appear exactly once on the free list, at the front
    assert pool._free[:2] == a[2:]
    assert sorted(pool._free) == sorted(set(pool._free))
    # pinned pages are resident but neither free, owned, nor evictable
    pool.assert_invariants()
    assert pool.free_pages == 7
    assert not pool.writable_mask()[[a[0], a[1]]].any()
    churn = pool.alloc(1, 4)  # churn cannot evict or reuse the pinned pages
    assert set(churn).isdisjoint({a[0], a[1]})
    fresh = pool.restore_slot(0, 2, pinned)
    assert pool.pages_of[0][:2] == [a[0], a[1]]
    assert pool.pages_of[0][2:] == fresh and len(fresh) == 2
    assert pool.ref[a[0]] == 1 and not pool._pinned
    pool.assert_invariants()


def test_unpin_parks_the_last_pin_in_the_lru():
    pool = PagePool(num_pages=8, page_size=4, slots=2, max_pages_per_slot=3)
    a = pool.alloc(0, 2)
    pool.register_prefix("h0", a[0])
    pool.share(1, a[:1])
    _, pinned0 = pool.spill_slot(0)
    _, pinned1 = pool.spill_slot(1)
    assert pool._pinned == {a[0]: 2}
    pool.unpin(pinned0)
    assert pool._pinned == {a[0]: 1} and a[0] not in pool._lru
    pool.unpin(pinned1)
    assert not pool._pinned and list(pool._lru) == [a[0]]
    assert pool.match_prefix(["h0"], peek=True) == [a[0]]
    pool.assert_invariants()


# --------------------------------------------------------------------------- #
# End-to-end bit-identity (the acceptance contract)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["serve_fp8_paged", None])
def test_prefix_cache_bit_identical_continuous_stochastic(policy):
    """Cache on == cache off, token for token, with stochastic KV writes
    on FP8 pages (and on float pages): exact, because KV rounding is
    addressed by (layer, position), so a cached page holds bit for bit
    the codes the request would have written itself."""
    cfg = get_config("qwen2-0.5b", smoke=True, policy=policy)
    queue = _shared_prefix_queue(cfg, 0)
    arrivals = [0, 1, 3, 4, 6]
    outs, stats = {}, {}
    for pc in (False, True):
        eng = _lively(_engine(cfg, prefix_cache=pc))
        assert (eng._token_key is not None) == (policy is not None)
        outs[pc], stats[pc] = serve.run_continuous(
            eng, [q.copy() for q in queue], gen=6, quiet=True,
            arrivals=arrivals, chunk=4)
        eng.pool.assert_invariants()
    assert outs[True] == outs[False]
    assert any(len(set(o)) > 1 for o in outs[True].values())
    assert stats[True]["prefix_hit_tokens"] > 0
    assert stats[True]["prefill_tokens"] < stats[False]["prefill_tokens"]
    assert stats[True]["prefix"]["hit_rate"] > 0
    assert stats[False]["prefix_hit_tokens"] == 0


@pytest.mark.parametrize("fused", [True, False])
def test_fully_cached_prompt_takes_cow_and_stays_bit_identical(cfg, fused):
    """Identical prompts whose length is a whole number of pages: the whole
    prompt is cached, admission clones the last matched page copy-on-write
    and recomputes only the final token; outputs still bit-identical to
    the cache off, stochastic KV on."""
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab, size=8)  # 2 full pages of 4
    queue = [prompt.copy() for _ in range(3)]
    outs = {}
    for pc in (False, True):
        eng = _engine(cfg, slots=1, prefix_cache=pc, fused_decode=fused)
        outs[pc], stats = serve.run_continuous(
            eng, [q.copy() for q in queue], gen=5, quiet=True)
        eng.pool.assert_invariants()
        if pc:
            assert stats["prefix"]["cow_copies"] == 2  # requests 2 and 3
            # each later request prefills exactly the recomputed token
            assert stats["prefill_tokens"] == 8 + 1 + 1
    assert outs[True] == outs[False]
    assert outs[True][0] == outs[True][1] == outs[True][2]


def test_copy_page_copies_every_layer_in_place(cfg):
    eng = _engine(cfg)
    g = torch.Generator().manual_seed(0)
    for t in eng.cache.values():
        t.copy_(torch.randint(0, 200, t.shape, generator=g).to(t.dtype))
    before = {k: v.clone() for k, v in eng.cache.items()}
    ptrs = {k: v.data_ptr() for k, v in eng.cache.items()}
    eng._copy_page(3, 5)
    for k, v in eng.cache.items():
        assert v.data_ptr() == ptrs[k]
        assert torch.equal(v[:, 5], before[k][:, 3])
        keep = [p for p in range(v.shape[1]) if p != 5]
        assert torch.equal(v[:, keep], before[k][:, keep])


@pytest.mark.parametrize("policy", ["serve_fp8_paged", None])
def test_preempt_while_shared_restores_bit_identically(policy):
    """A pool too small for the shared-prefix stream preempts slots that
    map shared pages: the spill pins them in place (no copy, no free), and
    the streams equal the uncontended run's exactly."""
    cfg = get_config("qwen2-0.5b", smoke=True, policy=policy)
    queue = _shared_prefix_queue(cfg, 3, shared=8, tails=(3, 4, 3, 4))
    want, _ = serve.run_continuous(
        _lively(_engine(cfg, slots=3, prefix_cache=True)),
        [q.copy() for q in queue], gen=6, quiet=True)
    eng = _lively(_engine(cfg, slots=3, prefix_cache=True, num_pages=9))
    pinned = []
    real = eng.pool.spill_slot

    def spill(slot):
        out = real(slot)
        pinned.append(len(out[1]))
        return out

    eng.pool.spill_slot = spill
    got, stats = serve.run_continuous(eng, [q.copy() for q in queue], gen=6,
                                      quiet=True)
    eng.pool.assert_invariants()
    assert stats["preemptions"] > 0 and max(pinned) > 0
    assert got == want


def test_admission_budget_charges_revived_lru_pages(cfg):
    """The admission check charges the matched pages the request will
    revive out of the LRU (they count as free until its own share): with
    the free list drained and the cached prompt's pages the only evictable
    ones, a fully-cached admission defers instead of running the pool
    dry in ``cow_page``."""
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, size=8)  # 2 full pages of 4
    eng = _engine(cfg, slots=2, max_seq=16, num_pages=7, prefix_cache=True)
    sched = ContinuousScheduler(eng, chunk=4)
    sched.add(Request(rid=0, prompt=prompt.copy(), gen=2))
    first = sched.run()  # caches the prompt; its 2 pages park in the LRU
    assert len(eng.pool._lru) == 2
    eng.pool.alloc(1, 4)  # another request holds the entire free list
    assert eng.pool.free_pages == 2  # exactly the parked matched pages
    sched.add(Request(rid=1, prompt=prompt.copy(), gen=2))
    sched.step()  # fully-cached plan needs revive(2) + COW(1) > 2: defer
    assert sched.queued and not sched.active
    eng.pool.assert_invariants()
    eng.pool.free_slot(1)
    while sched.pending():
        sched.step()
    eng.pool.assert_invariants()
    assert sched.outputs[1] == first[0]  # same prompt, greedy: same tokens
    assert sched.prefix_hit_tokens > 0


def test_pool_invariants_through_serving_workload(cfg):
    """The partition invariant holds at every scheduler step of a
    contended prefix-cache workload (admissions, COW, preemption, spills,
    restores, evictions, releases)."""
    queue = _shared_prefix_queue(cfg, 4, shared=8, tails=(4, 4, 5, 4, 6))
    eng = _engine(cfg, slots=3, prefix_cache=True, num_pages=10)
    sched = ContinuousScheduler(eng, chunk=4)
    for i, p in enumerate(queue):
        sched.add(Request(rid=i, prompt=p, gen=5, arrival=i))
    while sched.pending():
        sched.step()
        eng.pool.assert_invariants()
    assert sorted(sched.outputs) == list(range(len(queue)))
    assert sched.prefix_hit_tokens > 0


def test_token_write_keys_are_position_addressed(cfg):
    """Two engines, one of which ran steps on another slot first, write
    bit-identical KV codes for the same (token, position): page codes
    depend on content, never on when the step ran (the prefix cache's
    soundness condition)."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, size=6)
    runs = []
    for warm in (False, True):
        eng = _engine(cfg, slots=2, max_seq=16)
        if warm:
            eng.pool.ensure_capacity(1, 4)
            toks = np.zeros((2, 4), np.int32)
            toks[1] = rng.integers(0, cfg.vocab, size=4)
            eng.step_chunk(toks, np.zeros(2, np.int32),
                           np.array([0, 4], np.int32))
            eng.release(1)
        eng.pool.ensure_capacity(0, 6)
        toks = np.zeros((2, 6), np.int32)
        toks[0] = prompt
        eng.step_chunk(toks, np.zeros(2, np.int32),
                       np.array([6, 0], np.int32))
        ids = list(eng.pool.pages_of[0])
        runs.append({k: eng.cache[k][:, ids].clone()
                     for k in ("kp", "vp", "ks", "vs")})
    for k in ("kp", "vp", "ks", "vs"):
        assert torch.equal(runs[0][k], runs[1][k]), k


def test_prompt_hashes_follow_a_preempted_request_into_another_slot(cfg):
    """The spill record carries the prompt's page hashes: a request
    preempted mid-prefill and restored into another slot registers its
    later pages under its own hashes, never under those of the slot's
    earlier occupant (whose hashes ``release`` dropped), and its pinned
    first page comes back at logical index 0."""
    eng = _engine(cfg, slots=2, prefix_cache=True)
    rng = np.random.default_rng(8)
    a, c = (rng.integers(0, cfg.vocab, size=12) for _ in range(2))
    assert eng.admit_prefix(1, c) == 0   # slot 1 held c, never prefilled
    eng.release(1)
    assert eng.admit_prefix(0, a) == 0
    eng.pool.ensure_capacity(0, 4)
    toks = np.zeros((2, 4), np.int32)
    toks[0] = a[:4]
    eng.step_chunk(toks, np.zeros(2, np.int32), np.array([4, 0], np.int32))
    eng.note_prefilled(0, 4)
    first = eng.pool.pages_of[0][0]
    record = eng.preempt_slot(0)
    assert record["pinned"] == [(0, first)] and record["n_pages"] == 0
    eng.restore_slot(1, record)
    assert eng.pool.pages_of[1] == [first]
    eng.pool.ensure_capacity(1, 12)
    toks = np.zeros((2, 8), np.int32)
    toks[1] = a[4:]
    eng.step_chunk(toks, np.array([0, 4], np.int32),
                   np.array([0, 8], np.int32))
    eng.note_prefilled(1, 12)
    pool = eng.pool
    assert pool.match_prefix(eng.prompt_hashes(a), peek=True) == \
        pool.pages_of[1]
    assert pool.match_prefix(eng.prompt_hashes(c), peek=True) == []
    pool.assert_invariants()


# --------------------------------------------------------------------------- #
# Against the reference Engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["serve_fp8_paged", None])
def test_prompt_hashes_equal_reference_engine(policy):
    """The chained page hashes are the reference's hex strings: the same
    root (``name|seed|page|policy JSON``, the default policy's JSON too)
    and the same chunk bytes."""
    kw = dict(policy=policy) if policy else dict(quant="none")
    jeng = jserve.Engine(jget_config("qwen2-0.5b", smoke=True, **kw),
                         slots=1, max_seq=32, page_size=4, rng_seed=3,
                         prefix_cache=True)
    eng = serve.Engine(get_config("qwen2-0.5b", smoke=True, **kw), slots=1,
                       max_seq=32, page_size=4, rng_seed=3,
                       prefix_cache=True, device="cpu")
    assert eng.cfg.policy.to_json() == jeng.cfg.policy.to_json()
    prompt = np.random.default_rng(0).integers(0, 256, size=27)
    assert eng.prompt_hashes(prompt) == jeng.prompt_hashes(prompt)
    assert len(eng.prompt_hashes(prompt)) == 6
    assert _engine(get_config("qwen2-0.5b", smoke=True, **kw),
                   prefix_cache=False).prompt_hashes(prompt) == []


@pytest.mark.parametrize("arch,policy", [("qwen2-0.5b", "serve_fp8_paged"),
                                         ("gemma3-12b", None)])
def test_prefix_streams_match_reference_engine(arch, policy):
    """Prefix on, a shared prompt past the window: the port's token
    streams, hit tokens and prefix stats equal the reference engine's
    (float32 parameters carried across; gemma3 on lively weights)."""
    kw = dict(policy=policy) if policy else dict(quant="none")
    jcfg = dataclasses.replace(jget_config(arch, smoke=True, **kw),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True, **kw),
                              param_dtype="float32")
    shared = 36 if cfg.window else 12
    queue = _shared_prefix_queue(cfg, 11, shared=shared, tails=(3, 6, 2, 5))
    geo = dict(slots=2, max_seq=48, page_size=4, prefix_cache=True)
    jeng = jserve.Engine(jcfg, **geo)
    if policy is None:
        rng = np.random.default_rng(9)
        lively = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype),
            jeng.params)
        lively["embed"] = lively["embed"] / jcfg.d_model**0.5
        jeng.params = lively
    eng = serve.Engine(cfg, device="cpu", **geo)
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    ref, rstats = jserve.run_continuous(jeng, [q.copy() for q in queue],
                                        gen=5, chunk=4, quiet=True)
    port, pstats = serve.run_continuous(eng, [q.copy() for q in queue],
                                        gen=5, chunk=4, quiet=True)
    assert pstats["prefix_hit_tokens"] == rstats["prefix_hit_tokens"] > 0
    assert pstats["prefix"] == rstats["prefix"]
    if policy is None:
        assert any(len(set(o)) > 1 for o in ref.values())
    assert port == ref


# --------------------------------------------------------------------------- #
# Guard rails and the CLI
# --------------------------------------------------------------------------- #
def test_prefix_cache_rejects_unsupported_configs():
    mla = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              attn_impl="mla")
    assert not serve.Engine.prefix_cache_supported(mla)
    with pytest.raises(ValueError, match="pure-GQA"):
        serve.Engine(mla, slots=1, max_seq=16, page_size=4,
                     prefix_cache=True, device="cpu")
    for arch in ("qwen2-0.5b", "qwen3-14b", "gemma2-27b", "gemma3-12b"):
        assert serve.Engine.prefix_cache_supported(get_config(arch))
    with pytest.raises(ValueError, match="cache_impl='paged'"):
        serve.Engine(get_config("qwen2-0.5b", smoke=True), slots=1,
                     max_seq=16, cache_impl="dense", prefix_cache=True,
                     device="cpu")


def test_step_chunk_refuses_writes_into_shared_pages(cfg):
    """The host-side guard behind the device write mask: driving the
    engine into a shared page write trips the assertion instead of
    corrupting the cache for other readers."""
    eng = _engine(cfg, slots=2, prefix_cache=True)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab, size=8)
    eng.pool.ensure_capacity(0, 8)
    eng._slot_hash[0] = eng._prompt_hashes(prompt)
    eng._slot_registered[0] = 0
    toks = np.zeros((2, 8), np.int32)
    toks[0] = prompt
    eng.step_chunk(toks, np.zeros(2, np.int32), np.array([8, 0], np.int32))
    eng.note_prefilled(0, 8)  # both pages published
    assert eng.pool.cached_pages == 2
    # map slot 1 onto slot 0's registered page directly and try to write
    eng.pool.share(1, [eng.pool.pages_of[0][0]])
    bad = np.zeros((2, 1), np.int32)
    with pytest.raises(AssertionError, match="non-exclusive"):
        eng.step_chunk(bad, np.array([0, 0], np.int32),
                       np.array([0, 1], np.int32))


@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma2-27b", "gemma3-12b"])
def test_cli_prefix_cache_on_equals_off(arch, capsys):
    """``--prefix-cache on --shared-prefix 16 --page-size 4``: prefix hit
    tokens > 0 on the summary line and the tokens of ``--prefix-cache
    off``."""
    cli = ["--arch", arch, "--smoke", "--device", "cpu", "--shared-prefix",
           "16", "--page-size", "4", "--requests", "4", "--slots", "2",
           "--gen", "6"]
    outs, lines = {}, {}
    for mode in ("on", "off"):
        outs[mode] = serve.main(cli + ["--prefix-cache", mode])
        lines[mode] = capsys.readouterr().out.splitlines()
    hits = [ln for ln in lines["on"] if "prefix hit tokens" in ln]
    assert hits and " 0 prefix hit tokens" not in hits[0]
    assert " 0 prefix hit tokens" in "\n".join(lines["off"])
    assert outs["on"] == outs["off"]
    assert [ln for ln in lines["on"] if ln.startswith("  req")] == \
        [ln for ln in lines["off"] if ln.startswith("  req")]
