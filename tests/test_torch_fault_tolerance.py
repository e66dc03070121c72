"""PyTorch port: fault-tolerant serving against the JAX package.

* The checkpoint store keeps bf16 leaves bit for bit (NaN payloads, signed
  zeros, subnormals, infinities) through numpy.
* The pool's seizures and snapshot state are checked differentially: one
  random sequence of allocations, growths, shares, spills, restores,
  seizures and releases drives the port's pool and the reference's, and
  their ``state_dict``s stay equal; ``load_state_dict`` round-trips; the
  refcount-corruption drill is detected, and a seized page is a state of
  its own.
* The port's ``ChaosHarness`` injects the reference's faults at the
  reference's steps, and ``run_serving`` reproduces BENCH_5's chaos run
  (``benchmarks/run.py::serve_chaos``) against the reference's: equal
  outputs, terminal counts, restarts, snapshots and fault counts, and
  every survivor bitwise equal to the fault-free run.
* Within the port: a kill at step N restores bitwise with the prefix
  cache on and off, a kill with no snapshot replays cold, a snapshot
  taken while a request is PREEMPTED round-trips bitwise on FP8 and bf16
  pages, a sampled run restores its sampler, and any other error
  propagates out of ``run_serving``.  No CPU run counts a kernel launch.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.runtime import fault as jfault
from repro.serving import ChaosHarness as JChaosHarness
from repro.serving import ContinuousScheduler as JContinuousScheduler
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import PagePool as JPagePool
from repro.serving import Request as JRequest
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve
from repro_torch.models import params_from_jax
from repro_torch.runtime import fault
from repro_torch.serving import (ChaosHarness, ContinuousScheduler,
                                 EngineKilled, FaultPlan, PagePool, Request,
                                 load_snapshot, save_snapshot)


def _lively(eng, seed=0):
    """Every parameter redrawn at std 0.5, so that greedy streams follow
    the context (the seed init repeats each prompt's last token)."""
    g = torch.Generator().manual_seed(seed)

    def redraw(t):
        if isinstance(t, dict):
            return {k: redraw(v) for k, v in t.items()}
        if isinstance(t, list):
            return [redraw(v) for v in t]
        return (torch.randn(t.shape, generator=g) * 0.5).to(t.dtype)

    eng.params = redraw(eng.params)
    return eng


def _engine(policy="serve_fp8_paged", **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_seq", 16)
    kw.setdefault("page_size", 4)
    cfg = get_config("qwen2-0.5b", smoke=True, policy=policy)
    return _lively(serve.Engine(cfg, stochastic_kv=True, device="cpu", **kw))


def _pool_clean(eng):
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    eng.pool.assert_invariants()


def _quiet(*_):
    pass


# --------------------------------------------------------------------------- #
# The checkpoint store
# --------------------------------------------------------------------------- #
def test_store_keeps_bf16_bits_and_other_dtypes(tmp_path):
    """A bf16 leaf holding NaN payloads, +-0, subnormals and infinities
    comes back with the same 16 bits, through ``restore_raw`` and
    ``restore``; uint8, int32 and float32 leaves beside it too."""
    bits = torch.tensor([0x0000, 0x8000, 0x0001, 0x807F, 0x7F80, 0xFF80,
                         0x7FC0, 0x7F81, 0xFFFF, 0x7FA5, 0x3F80, 0x0080],
                        dtype=torch.int32).to(torch.int16)
    state = {"pages": [bits.view(torch.bfloat16).reshape(3, 4),
                       torch.arange(6, dtype=torch.uint8)],
             "scales": {"k": torch.tensor([0.5, 2.0]),
                        "n": torch.tensor([7], dtype=torch.int32)}}
    store.save(tmp_path, state, step=3, data_state={"x": 1}).result()
    flat, manifest = store.restore_raw(tmp_path)
    assert manifest["step"] == 3 and manifest["data_state"] == {"x": 1}
    assert sorted(flat) == ["pages/0", "pages/1", "scales/k", "scales/n"]
    assert manifest["leaves"]["pages/0"]["dtype"] == "bfloat16"
    got = flat["pages/0"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16).reshape(-1), bits)
    restored, step, _ = store.restore(tmp_path, state)
    assert step == 3
    assert torch.equal(restored["pages"][0].view(torch.int16).reshape(-1),
                       bits)
    for key in ("pages/1", "scales/k", "scales/n"):
        a = flat[key]
        b = store._flatten(state)[key]
        assert a.dtype == b.dtype and torch.equal(a, b), key
    assert store.path_key(("cache", "kp")) == "cache/kp"
    assert store.path_key(("spills", 7, "vs")) == "spills/7/vs"


def test_store_host_copy_is_taken_at_save(tmp_path):
    """``save`` copies a CPU tensor before returning, so an in-place
    update after it cannot reach the file being written."""
    t = torch.zeros(4)
    pending = store.save(tmp_path, {"t": t}, step=1)
    t.fill_(1.0)
    pending.result()
    flat, _ = store.restore_raw(tmp_path)
    assert torch.equal(flat["t"], torch.zeros(4))


# --------------------------------------------------------------------------- #
# The pool: seizures and snapshot state, against the reference's
# --------------------------------------------------------------------------- #
def _state(pool):
    return json.loads(json.dumps(pool.state_dict()))


@pytest.mark.parametrize("seed", range(3))
def test_pool_state_dict_differential_against_reference(seed):
    """One random sequence of allocations, growths, registrations, shares,
    spills, restores, unpins, seizures, releases and frees on both pools:
    equal ``state_dict``s, the same seized ids, invariants on both; every
    25 operations the port's state loads into a fresh pool, which gives
    the same ``state_dict`` with the seizures released."""
    rng = np.random.default_rng(300 + seed)
    geo = dict(num_pages=14, page_size=4, slots=3, max_pages_per_slot=5)
    a, b = PagePool(**geo), JPagePool(**geo)
    keys = [f"k{i}" for i in range(8)]
    records, seizures, seen = [], [], set()
    for i in range(400):
        op = int(rng.integers(0, 10))
        slot = int(rng.integers(0, 3))
        owned = a.pages_of[slot]
        if op == 0:
            n = int(rng.integers(1, 3))
            call = lambda p: p.alloc(slot, n)  # noqa: E731
        elif op == 1:
            tokens = int(rng.integers(0, 21))
            call = lambda p: p.ensure_capacity(slot, tokens)  # noqa: E731
        elif op == 2 and owned:
            key = keys[int(rng.integers(0, len(keys)))]
            pid = owned[int(rng.integers(0, len(owned)))]
            call = lambda p: p.register_prefix(key, pid)  # noqa: E731
        elif op == 3:
            probe = [keys[j] for j in rng.permutation(len(keys))[:2]]
            call = lambda p: p.share(slot, p.match_prefix(probe))  # noqa: E731
        elif op == 4 and owned:
            call = lambda p: p.spill_slot(slot)  # noqa: E731
        elif op == 5 and records and not owned:
            n, pinned = records[0]
            if not a.can_alloc(n) or n + len(pinned) > 5:
                continue
            records.pop(0)
            call = lambda p: p.restore_slot(slot, n, pinned)  # noqa: E731
        elif op == 6:
            n = int(rng.integers(1, 4))
            call = lambda p: p.seize(n)  # noqa: E731
        elif op == 7 and seizures:
            ids = seizures.pop(int(rng.integers(0, len(seizures))))
            call = lambda p: p.release_seized(ids)  # noqa: E731
        elif op == 8 and records:
            _, pinned = records.pop(int(rng.integers(0, len(records))))
            call = lambda p: p.unpin(pinned)  # noqa: E731
        elif op == 9:
            call = lambda p: p.free_slot(slot)  # noqa: E731
        else:
            continue
        got = []
        for pool in (a, b):
            try:
                got.append(("ok", call(pool)))
            except RuntimeError as e:
                got.append(("raised", "exhausted" in str(e)))
        assert got[0] == got[1], f"op {i} ({op}): {got}"
        if op == 4:
            spilled, pinned = got[0][1]
            records.append((len(spilled), pinned))
            seen.add("pinned" if pinned else "spilled")
        if op == 6 and got[0][1]:
            seizures.append(got[0][1])
            seen.add("seized")
        assert _state(a) == _state(b), f"op {i} ({op})"
        assert a._seized == b._seized
        a.assert_invariants()
        b.assert_invariants()
        if i % 25 == 0:
            c = PagePool(**geo)
            c.load_state_dict(a.state_dict())
            assert c.version == 1 and not c._seized
            assert _state(c) == _state(a)
            assert c.free_pages == a.free_pages + len(a._seized)
            assert c.block_tables.tolist() == a.block_tables.tolist()
            assert list(c._lru) == list(a._lru)
            assert c._page_key == a._page_key
    assert seen >= {"pinned", "spilled", "seized"}
    assert a.restores > 0 and a.evictions > 0 and a.prefix_hits > 0


def test_pool_seize_release_and_state_dict_roundtrip():
    pool = PagePool(num_pages=8, page_size=4, slots=2, max_pages_per_slot=4)
    pool.alloc(0, 2)
    ids = pool.seize(3)
    assert len(ids) == 3 and pool.free_pages == 2
    pool.assert_invariants()
    sd = pool.state_dict()  # seizures are transient: recorded as free
    assert sorted(sd["free"])[-3:] == sorted(ids)
    pool2 = PagePool(num_pages=8, page_size=4, slots=2, max_pages_per_slot=4)
    pool2.load_state_dict(sd)
    assert pool2.free_pages == 5
    assert pool2.pages_of == pool.pages_of
    assert pool2.block_tables.tolist() == pool.block_tables.tolist()
    pool.release_seized(ids)
    pool.assert_invariants()
    assert pool.free_pages == 5
    with pytest.raises(RuntimeError, match="not seized"):
        pool.release_seized(ids[:1])
    bad = pool.state_dict()
    bad["geometry"] = [9, 4, 2, 4]
    with pytest.raises(ValueError, match="geometry"):
        pool2.load_state_dict(bad)


def test_seized_pages_are_a_state_of_their_own():
    """A seized page is neither reported as leaked nor allowed to sit in
    a second state: a page dropped from the seized set without returning
    to the free list, or seized and freed at once, fails the check."""
    pool = PagePool(num_pages=6, page_size=4, slots=2, max_pages_per_slot=4)
    ids = pool.seize(2)
    pool.assert_invariants()
    pool._seized.discard(ids[0])  # a real leak
    with pytest.raises(AssertionError, match=f"page {ids[0]}"):
        pool.assert_invariants()
    pool._seized.add(ids[0])
    pool._free.append(ids[1])  # seized and free at once
    with pytest.raises(AssertionError, match="seized=True"):
        pool.assert_invariants()


def test_corruption_drill_is_detected_and_repaired():
    """The refcount-corruption drill is caught by ``assert_invariants``,
    repaired and re-verified, with seized pages in the pool; a checker
    that missed it would make the drill raise."""

    class _Sched:
        def __init__(self, pool):
            self.pool, self.steps, self.active = pool, 0, {}

    pool = PagePool(num_pages=8, page_size=4, slots=2, max_pages_per_slot=4)
    pool.alloc(0, 2)
    pool.seize(2)
    h = ChaosHarness(_Sched(pool), FaultPlan(corruption=1.0))
    h._inject_corruption()
    assert h.counts["corruption"] == 1
    pool.assert_invariants()
    pool.assert_invariants = lambda: None  # a checker that sees nothing
    with pytest.raises(RuntimeError, match="MISSED"):
        h._inject_corruption()


# --------------------------------------------------------------------------- #
# The harness and run_serving against the reference's
# --------------------------------------------------------------------------- #
def _pair(geo, policy="serve_fp8_paged"):
    """(make reference engine, make port engine) on equal float32
    parameters, the reference's redrawn at std 0.5 (as ``_lively``)."""
    jcfg = dataclasses.replace(
        jget_config("qwen2-0.5b", smoke=True, policy=policy),
        param_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True,
                                         policy=policy),
                              param_dtype="float32")
    rng = np.random.default_rng(9)
    jp = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype),
        jserve.Engine(jcfg, **geo).params)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)

    def jmake():
        eng = jserve.Engine(jcfg, **geo)
        eng.params = jp
        return eng

    def make():
        eng = serve.Engine(cfg, device="cpu", **geo)
        eng.params = tp
        return eng

    return jmake, make


def test_harness_schedule_equals_reference():
    """The same plan on the same stream: the port's harness injects the
    same fault kinds at the same steps, with the same arguments, as the
    reference's, and the runs emit the same tokens."""
    geo = dict(slots=3, max_seq=16, page_size=4, num_pages=9,
               stochastic_kv=True)
    jmake, make = _pair(geo)
    rng = np.random.default_rng(7)
    queue = [rng.integers(0, 256, size=5) for _ in range(5)]
    kw = dict(seed=3, pool_exhaustion=0.4, exhaustion_pages=2,
              exhaustion_hold=2, preemption_storm=0.3, corruption=0.3,
              overrun=0.3)
    runs = []
    for mk, Sched, Req, Harness, Plan in (
            (jmake, JContinuousScheduler, JRequest, JChaosHarness,
             JFaultPlan),
            (make, ContinuousScheduler, Request, ChaosHarness, FaultPlan)):
        eng = mk()
        sched = Sched(eng, chunk=4)
        for i, p in enumerate(queue):
            sched.add(Req(rid=i, prompt=p.copy(), gen=5))
        wd = fault.StepWatchdog(3600.0)
        h = Harness(sched, Plan(**kw), wd)
        while sched.pending():
            wd.start()
            h.step()
            wd._t0 = None
        h.release_all_seizures()
        eng.pool.assert_invariants()
        events = [(e["name"], e["args"])
                  for e in sched.tel.to_chrome_trace()["traceEvents"]
                  if e["name"].startswith("chaos/")]
        runs.append((events, dict(h.counts), sched.outputs, sched.steps))
    assert runs[0] == runs[1]
    counts = runs[1][1]
    assert all(counts[k] > 0 for k in ("exhaustion", "storm", "corruption",
                                       "overrun"))


BENCH5_PLENS = [6, 10, 4, 8, 12, 6, 4, 10]


def test_bench5_chaos_run_equals_reference(tmp_path):
    """BENCH_5's run (``benchmarks/run.py::serve_chaos``: 8 Poisson
    arrivals, 3 slots, a pool of 10 pages, deadlines of 26 steps, a queue
    of 6, the seed-1 plan, a kill at step 12, a snapshot every 4 steps)
    through the port's ``run_serving`` and the reference's, on equal
    float32 parameters: equal fault-free and chaos outputs, terminal
    counts, restarts, snapshots, steps, preemptions and fault counts,
    BENCH_5.json's counts, and every survivor bitwise equal to the
    fault-free run (``survivors_equal = 1``).  The CPU runs count no
    kernel launch."""
    geo = dict(slots=3, max_seq=24, cache_impl="paged", page_size=4,
               num_pages=10, stochastic_kv=True)
    jmake, make = _pair(geo)
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, 256, size=n) for n in BENCH5_PLENS]
    arrivals = np.floor(np.cumsum(
        rng.exponential(1.5, size=len(BENCH5_PLENS)))).astype(int)
    knobs = dict(gen=8, arrivals=arrivals, chunk=4, deadline_steps=26,
                 max_queue=6, watermark_high=0.95, watermark_low=0.6,
                 log=_quiet)
    plan = dict(seed=1, pool_exhaustion=0.25, exhaustion_pages=2,
                exhaustion_hold=3, preemption_storm=0.15, corruption=0.15,
                overrun=0.2, kill_at_step=12)
    launches = (pa.paged_attend.launches, pa.paged_attend.float_launches)
    results = {}
    for name, mod, mk, Plan in (("ref", jfault, jmake, JFaultPlan),
                                ("port", fault, make, FaultPlan)):
        base, base_stats = mod.run_serving(mk, [q.copy() for q in queue],
                                           **knobs)
        out, stats = mod.run_serving(
            mk, [q.copy() for q in queue], **knobs, chaos=Plan(**plan),
            ckpt_dir=tmp_path / name, snapshot_every=4,
            step_deadline_s=3600.0)
        results[name] = (base, base_stats, out, stats)
    assert (pa.paged_attend.launches,
            pa.paged_attend.float_launches) == launches
    jbase, jbase_stats, jout, jstats = results["ref"]
    base, base_stats, out, stats = results["port"]
    assert base == jbase and out == jout
    assert base_stats["terminal"] == jbase_stats["terminal"] == {
        "finished": 8}
    for key in ("terminal", "restarts", "snapshots", "chaos", "steps",
                "preemptions", "shed", "watchdog_overruns"):
        assert stats[key] == jstats[key], key
    # BENCH_5.json: 7 finished, 1 timed out, 1 restart after 9 snapshots,
    # 21 faults (exhaustion 6, storm 1, corruption 5, overrun 8, killed 1)
    assert stats["terminal"] == {"finished": 7, "timed_out": 1}
    assert stats["restarts"] == 1 and stats["snapshots"] == 9
    assert stats["chaos"] == {"exhaustion": 6, "storm": 1, "corruption": 5,
                              "overrun": 8, "killed": 1}
    assert stats["restored_from"] == 12
    survivors_equal = len(out) > 0 and all(out[r] == base[r] for r in out)
    assert survivors_equal
    assert sum(len(set(o)) > 1 for o in base.values()) == len(base)
    tel = stats["telemetry"]
    assert tel.counter_value("fault_restarts_total") == 1
    assert tel.counter_value("chaos_faults_total", kind="overrun") == 8
    assert tel.counter_value("snapshot_restores_total") == 1
    beat = json.loads((tmp_path / "port" / "heartbeat.json").read_text())
    assert beat["step"] == stats["steps"]


# --------------------------------------------------------------------------- #
# Crash recovery within the port
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("prefix", [False, True])
def test_kill_at_step_n_recovery_bit_identical(prefix, tmp_path):
    """Engine killed at step N, rebuilt, restored from the latest
    snapshot: every request's output, the tokens generated after the
    restore included, equals the uninterrupted run's bit for bit,
    stochastic KV rounding on, prefix cache on and off."""
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 256, size=4)
    queue = [np.concatenate([shared, rng.integers(0, 256, size=4)])
             for _ in range(4)]

    def make_engine():
        return _engine(slots=2, prefix_cache=prefix)

    base, base_stats = fault.run_serving(make_engine, queue, gen=6,
                                         log=_quiet)
    assert base_stats["restarts"] == 0
    out, stats = fault.run_serving(
        make_engine, queue, gen=6, log=_quiet,
        chaos=FaultPlan(kill_at_step=7), ckpt_dir=tmp_path / "ck",
        snapshot_every=3)
    assert stats["restarts"] == 1 and stats["chaos"]["killed"] == 1
    assert stats["snapshots"] >= 2 and stats["restored_from"] == 6
    assert out == base
    assert stats["terminal"]["finished"] == 4
    assert sum(len(set(o)) > 1 for o in base.values()) >= 3


def test_kill_without_snapshot_cold_replays(tmp_path):
    """No snapshot on disk at the kill: the stream is replayed cold and
    still gives the fault-free outputs."""
    rng = np.random.default_rng(10)
    queue = [rng.integers(0, 256, size=5) for _ in range(3)]

    def make_engine():
        return _engine(slots=2)

    base, _ = fault.run_serving(make_engine, queue, gen=5, log=_quiet)
    out, stats = fault.run_serving(make_engine, queue, gen=5, log=_quiet,
                                   chaos=FaultPlan(kill_at_step=4))
    assert stats["restarts"] == 1 and stats["restored_from"] is None
    assert out == base


@pytest.mark.parametrize("policy", ["serve_fp8_paged", None])
def test_snapshot_roundtrip_mid_preemption(policy, tmp_path):
    """A snapshot taken while a request sits PREEMPTED restores into a
    fresh engine: every cache tensor and every spill tensor bitwise equal
    (FP8 codes and scales, or bf16 rows), the pool, hashes and step
    equal, and both engines finish identically."""
    rng = np.random.default_rng(8)
    queue = [rng.integers(0, 256, size=6) for _ in range(4)]

    def build():
        eng = _engine(policy, num_pages=7, prefix_cache=True)
        return eng, ContinuousScheduler(eng, chunk=4)

    eng, sched = build()
    for i, p in enumerate(queue):
        sched.add(Request(rid=i, prompt=p.copy(), gen=6))
    for _ in range(200):
        sched.step()
        if sched.preempted:
            break
    else:
        pytest.fail("the pool never forced a preemption")
    save_snapshot(tmp_path, eng, sched)
    eng2, sched2 = build()
    assert load_snapshot(tmp_path, eng2, sched2) == sched.steps
    want = torch.bfloat16 if policy is None else torch.uint8
    assert eng2.cache["kp"].dtype == want
    for name, t in eng.cache.items():
        assert torch.equal(eng2.cache[name], t), name
    assert ([r.rid for r in sched2.preempted]
            == [r.rid for r in sched.preempted])
    for r, r2 in zip(sched.preempted, sched2.preempted):
        for name, t in r.spill["state"].items():
            t2 = r2.spill["state"][name]
            assert t2.dtype == t.dtype and torch.equal(t2, t), name
        assert r2.spill["pinned"] == r.spill["pinned"]
        assert r2.spill["hashes"] == r.spill["hashes"]
    assert _state(eng2.pool) == _state(eng.pool)
    assert eng2._slot_hash == eng._slot_hash and eng2._step == eng._step
    assert eng2.pool.version != eng2._bt_version  # tables re-uploaded
    out1 = sched.run()
    out2 = sched2.run()
    assert out2 == out1 and sched2.steps == sched.steps
    _pool_clean(eng2)


def test_snapshot_refuses_another_geometry(tmp_path):
    eng = _engine(slots=2)
    save_snapshot(tmp_path, eng, ContinuousScheduler(eng))
    other = _engine(slots=2, num_pages=5)
    with pytest.raises(ValueError, match="cache/kp"):
        load_snapshot(tmp_path, other, ContinuousScheduler(other))


def test_sampler_state_survives_the_kill(tmp_path):
    """``temperature > 0``: the snapshot carries the sampler's Generator,
    so the sampled streams after a kill equal the uninterrupted run's."""
    rng = np.random.default_rng(11)
    queue = [rng.integers(0, 256, size=5) for _ in range(3)]

    def make_engine():
        return _engine(slots=2)

    kw = dict(gen=6, temperature=1.0, seed=5, log=_quiet)
    base, _ = fault.run_serving(make_engine, queue, **kw)
    out, stats = fault.run_serving(make_engine, queue, **kw,
                                   chaos=FaultPlan(kill_at_step=5),
                                   ckpt_dir=tmp_path, snapshot_every=2)
    assert stats["restarts"] == 1 and stats["restored_from"] == 4
    assert out == base
    greedy, _ = fault.run_serving(make_engine, queue, gen=6, log=_quiet)
    assert base != greedy


def test_other_errors_propagate(tmp_path):
    """A ``RuntimeError`` that is not ``EngineKilled`` (a failed kernel
    launch, say) ends ``run_serving`` at once: no restart hides it."""
    built = []

    def make_engine():
        eng = _engine(slots=2)
        step_chunk = eng.step_chunk

        def failing(*args, **kw):
            if len(built) == 1 and eng._step == 2:
                raise RuntimeError("CUDA error: an illegal memory access")
            return step_chunk(*args, **kw)

        eng.step_chunk = failing
        built.append(eng)
        return eng

    queue = [np.arange(5), np.arange(3) + 7]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        fault.run_serving(make_engine, queue, gen=4, log=_quiet,
                          ckpt_dir=tmp_path, snapshot_every=1,
                          step_deadline_s=3600.0,
                          chaos=FaultPlan(overrun=1.0))
    assert len(built) == 1
    assert issubclass(EngineKilled, RuntimeError)


def test_watchdog_inject_overrun():
    wd = fault.StepWatchdog(1000.0)
    assert not wd.inject_overrun()  # no step in flight
    wd.start()
    assert wd.inject_overrun()
    with pytest.raises(TimeoutError):
        wd.check()
    assert wd.tripped
