"""PyTorch port: page pool, continuous scheduler and Engine on the CPU.

* The pool is checked differentially: one random op sequence drives the
  port's pool and the reference's, and block tables, owner lists,
  refcounts, free lists and versions must stay identical.
* The Engine runs ``run_continuous`` end to end at ``smoke()`` size with
  ``device="cpu"`` (plain versions of the kernels), fused on and off, on
  FP8 pages (``serve_fp8_paged``) and on float pages (the default policy,
  ``quant="none"``), and with a pool small enough that the scheduler
  preempts: preempt/restore == uninterrupted, bit for bit.
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
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve
from repro_torch.models import params_from_jax
from repro_torch.serving import PagePool, Telemetry


def _pool_state(p):
    return (p.block_tables.tolist(), [list(map(int, x)) for x in p.pages_of],
            p.ref.tolist(), [int(x) for x in p._free], p.free_pages,
            p.used_pages, p.writable_mask().tolist())


@pytest.mark.parametrize("seed", range(3))
def test_pool_differential_against_reference(seed):
    rng = np.random.default_rng(seed)
    geo = dict(num_pages=17, page_size=4, slots=4, max_pages_per_slot=5)
    a, b = PagePool(**geo), JPagePool(**geo)
    for i in range(250):
        op = int(rng.integers(0, 4))
        slot = int(rng.integers(0, 4))
        n = int(rng.integers(1, 3))
        tokens = rng.integers(0, 21, size=4)
        errors = []
        for pool in (a, b):
            try:
                if op == 0:
                    pool.alloc(slot, n)
                elif op == 1:
                    pool.ensure_capacity(slot, int(tokens[0]))
                elif op == 2:
                    pool.ensure_capacity_batch(tokens)
                else:
                    pool.free_slot(slot)
                errors.append(None)
            except RuntimeError as e:  # exhaustion / slot overflow
                errors.append(str(e))
        assert errors[0] == errors[1], f"op {i}"
        assert _pool_state(a) == _pool_state(b), f"op {i}"
        assert a.version == b.version
        a.assert_invariants()


@pytest.mark.parametrize("seed", range(3))
def test_pool_spill_restore_differential_against_reference(seed):
    """Spill/restore bookkeeping: one random sequence of allocations,
    frees, spills and restores drives both pools; the spilled and fresh
    ids, block tables, owners, refcounts, free lists (spilled ids go to
    its front), versions and the spill/restore counts stay identical."""
    rng = np.random.default_rng(100 + seed)
    geo = dict(num_pages=13, page_size=4, slots=3, max_pages_per_slot=4)
    a, b = PagePool(**geo), JPagePool(**geo)
    records = []
    for i in range(300):
        op = int(rng.integers(0, 5))
        slot = int(rng.integers(0, 3))
        if op == 0:
            want = int(rng.integers(1, 17))
            if (a.pages_needed(want) - len(a.pages_of[slot])
                    <= a.free_pages and a.pages_needed(want) <= 4):
                for pool in (a, b):
                    pool.ensure_capacity(slot, want)
        elif op == 1:
            for pool in (a, b):
                pool.free_slot(slot)
        elif op in (2, 3) and a.pages_of[slot]:
            got = [pool.spill_slot(slot) for pool in (a, b)]
            assert got[0] == got[1] and got[0][1] == [], f"op {i}"
            records.append(len(got[0][0]))
        elif op == 4 and records and not a.pages_of[slot]:
            n = records[0]
            if a.can_alloc(n):
                records.pop(0)
                got = [pool.restore_slot(slot, n, ()) for pool in (a, b)]
                assert got[0] == got[1], f"op {i}"
        assert _pool_state(a) == _pool_state(b), f"op {i}"
        assert (a.version, a.spills, a.restores) == \
            (b.version, b.spills, b.restores)
        a.assert_invariants()
    assert a.spills > 3 and a.restores > 3


def test_pool_refuses_pins_it_cannot_hold():
    """A slot with no registered page spills everything and pins nothing;
    a record that names pins the pool does not hold is refused by
    ``unpin`` and ``restore_slot``, before any state moves."""
    pool = PagePool(num_pages=5, page_size=4, slots=2, max_pages_per_slot=2)
    pool.alloc(0, 2)
    assert pool.spill_plan(0) == (pool.pages_of[0], [])
    spilled, pinned = pool.spill_slot(0)
    assert pinned == [] and pool.free_pages == 4
    assert pool._free[:2] == spilled
    pool.unpin(())
    with pytest.raises(RuntimeError, match="spill pins"):
        pool.unpin([(0, 3)])
    with pytest.raises(RuntimeError, match="spill pins"):
        pool.restore_slot(1, 1, [(0, 3)])
    assert pool.free_pages == 4 and not pool.pages_of[1]
    pool.alloc(1, 1)
    with pytest.raises(RuntimeError, match="not empty"):
        pool.restore_slot(1, 1)


def test_pool_batched_growth_is_one_version_bump():
    pool = PagePool(num_pages=9, page_size=4, slots=2, max_pages_per_slot=4)
    v0 = pool.version
    pool.ensure_capacity_batch(np.asarray([9, 5]))
    assert pool.version == v0 + 1
    pool.ensure_capacity_batch(np.asarray([9, 5]))
    assert pool.version == v0 + 1
    with pytest.raises(RuntimeError):
        pool.ensure_capacity_batch(np.asarray([17, 0]))
    pool.assert_invariants()


def _engine(fused=True, **kw):
    cfg = get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    return serve.Engine(cfg, slots=2, max_seq=24, page_size=4,
                        fused_decode=fused, device="cpu", **kw)


QUEUE = [np.arange(3) + 5, np.arange(9) + 17, np.arange(5) + 40,
         np.arange(1) + 99]


def test_engine_run_continuous_cpu_smoke():
    eng = _engine()
    outputs, stats = serve.run_continuous(eng, QUEUE, gen=6, chunk=4,
                                          quiet=True)
    assert sorted(outputs) == [0, 1, 2, 3]
    assert all(len(o) == 6 for o in outputs.values())
    assert all(0 <= t < eng.cfg.vocab for o in outputs.values() for t in o)
    assert stats["terminal"] == {"finished": 4}
    # each step uploads the block tables at most once
    assert eng.tel.counter_value("host_transfers_total") <= stats["steps"]
    assert eng.tel.counter_value("serve_substeps_total") >= stats["steps"]
    eng.pool.assert_invariants()
    assert eng.pool.used_pages == 0


def test_engine_fused_on_off_token_streams_bitwise():
    streams = []
    for fused in (True, False):
        eng = _engine(fused=fused)
        outputs, _ = serve.run_continuous(eng, QUEUE, gen=6, chunk=4,
                                          quiet=True)
        streams.append((outputs, eng.cache))
    assert streams[0][0] == streams[1][0]
    for name in ("kp", "vp", "ks", "vs"):
        assert torch.equal(streams[0][1][name][:, 1:],
                           streams[1][1][name][:, 1:])


def _streams_against_reference_engine(numerics, lively):
    jcfg = dataclasses.replace(
        jget_config("qwen2-0.5b", smoke=True, **numerics),
        param_dtype="float32")
    jeng = jserve.Engine(jcfg, slots=2, max_seq=24, page_size=4)
    if lively:
        rng = np.random.default_rng(9)
        jeng.params = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype),
            jeng.params)
    ref, _ = jserve.run_continuous(jeng, QUEUE, gen=6, chunk=4, quiet=True)
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b", smoke=True, **numerics),
        param_dtype="float32")
    eng = serve.Engine(cfg, slots=2, max_seq=24, page_size=4, device="cpu")
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    port, _ = serve.run_continuous(eng, QUEUE, gen=6, chunk=4, quiet=True)
    return port, ref, eng


def test_engine_token_streams_match_reference_engine():
    """With float32 parameters carried across, the port's token streams
    equal the reference engine's (greedy sampling; the logits agree to
    ~1e-5, far inside the random model's top-2 gaps)."""
    port, ref, eng = _streams_against_reference_engine(
        dict(policy="serve_fp8_paged"), lively=False)
    assert eng.cache["kp"].dtype == torch.uint8
    assert port == ref


def test_engine_token_streams_match_reference_engine_float_pages():
    """The reference CLI's default ``quant="none"``: float32 pages, every
    parameter redrawn at std 0.5 (as ``_lively`` does) so the streams
    follow the context; the port's streams equal the reference
    engine's."""
    port, ref, eng = _streams_against_reference_engine(
        dict(quant="none"), lively=True)
    assert eng.cache["kp"].dtype == torch.float32
    assert any(len(set(o)) > 1 for o in ref.values())
    assert port == ref


def _lively(eng, seed=0):
    """Redraw every parameter at std 0.5 so that greedy tokens follow the
    context (the seed init's zero gains and 0.02 weights repeat the last
    prompt token), which makes token streams a sharp test."""
    g = torch.Generator().manual_seed(seed)

    def redraw(t):
        if isinstance(t, dict):
            return {k: redraw(v) for k, v in t.items()}
        if isinstance(t, list):
            return [redraw(v) for v in t]
        return (torch.randn(t.shape, generator=g) * 0.5).to(t.dtype)

    eng.params = redraw(eng.params)
    return eng


PREEMPT_QUEUE = [np.arange(n) * 7 % 97 + 3 for n in (5, 11, 3, 8, 2, 9)]


@pytest.mark.parametrize("policy", ["serve_fp8_paged", None])
@pytest.mark.parametrize("fused", [True, False])
def test_preempt_restore_equals_uninterrupted(policy, fused):
    """A pool below the worst case makes the scheduler preempt (spill a
    slot's pages, codes and scales or float rows, verbatim to the host)
    and restore (into fresh page ids): the token streams equal the same
    run with a worst-case pool bit for bit, on FP8 and on float pages."""
    cfg = get_config("qwen2-0.5b", smoke=True, policy=policy)
    runs = []
    for pages in (None, 8):
        eng = _lively(serve.Engine(cfg, slots=3, max_seq=24, page_size=4,
                                   num_pages=pages, fused_decode=fused,
                                   device="cpu"))
        outputs, stats = serve.run_continuous(eng, PREEMPT_QUEUE, gen=10,
                                              chunk=4, quiet=True)
        assert stats["terminal"] == {"finished": len(PREEMPT_QUEUE)}
        eng.pool.assert_invariants()
        assert eng.pool.used_pages == 0
        runs.append((outputs, stats))
    (full, s_full), (small, s_small) = runs
    assert s_full["preemptions"] == s_full["restores"] == 0
    assert s_small["preemptions"] >= 1
    assert s_small["restores"] == s_small["preemptions"]
    assert len({tuple(o) for o in full.values()}) > 1
    assert any(len(set(o)) > 1 for o in full.values())
    assert small == full


def test_preempt_slot_copies_pages_verbatim_into_fresh_ids():
    """One slot spilled and restored by hand: the record holds the slot's
    pages from every layer (copies, not views of the cache); the restore
    lands them, bitwise, at other page ids."""
    eng = _lively(_engine())
    eng.pool.ensure_capacity_batch(np.asarray([7, 3]))
    eng.step_chunk(np.arange(8).reshape(2, 4) + 1, np.zeros(2, np.int32),
                   np.asarray([4, 3], np.int32))
    eng.step_chunk(np.arange(8).reshape(2, 4) + 9, np.asarray([4, 3]),
                   np.asarray([3, 0], np.int32))
    old = list(eng.pool.pages_of[0])
    before = {k: v[:, old].clone() for k, v in eng.cache.items()}
    rec = eng.preempt_slot(0)
    assert rec["n_pages"] == len(old) == 2 and rec["pinned"] == []
    for k, v in rec["state"].items():
        assert torch.equal(v, before[k])
        eng.cache[k][:, old] = 0          # the freed pages get reused
    eng.pool.alloc(1, 2)                   # take the spilled ids first
    eng.restore_slot(0, rec)
    new = eng.pool.pages_of[0]
    assert not set(new) & set(old)
    for k, v in eng.cache.items():
        assert torch.equal(v[:, new], before[k])
    assert (eng.pool.spills, eng.pool.restores) == (1, 1)
    eng.pool.assert_invariants()


def test_engine_stochastic_kv_override():
    """``stochastic_kv`` defaults to the policy's kv_write mode; False
    drops the write stream (deterministic writes), True keeps it even for
    float pages, which draw no noise from it."""
    fp8 = get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    assert _engine()._token_key is not None
    assert serve.Engine(fp8, slots=1, max_seq=8, stochastic_kv=False,
                        device="cpu")._token_key is None
    flt = get_config("qwen2-0.5b", smoke=True)
    assert serve.Engine(flt, slots=1, max_seq=8, device="cpu")._token_key \
        is None
    eng = serve.Engine(flt, slots=2, max_seq=16, page_size=4,
                       stochastic_kv=True, device="cpu")
    assert eng._token_key is not None
    assert eng.model.kv_noise(eng._token_key,
                              torch.zeros(2, dtype=torch.int32)) is None
    outputs, _ = serve.run_continuous(eng, QUEUE[:2], gen=2, quiet=True)
    assert sorted(outputs) == [0, 1]


def test_engine_block_tables_upload_once_per_mutating_step():
    eng = _engine()
    t = eng.tel
    eng.pool.ensure_capacity_batch(np.asarray([4, 4]))
    eng.step_chunk(np.ones((2, 4), np.int32), np.zeros(2, np.int32),
                   np.asarray([4, 4], np.int32))
    assert t.counter_value("host_transfers_total") == 1
    eng.step_chunk(np.ones((2, 1), np.int32), np.asarray([3, 3], np.int32),
                   np.asarray([1, 1], np.int32))
    assert t.counter_value("host_transfers_total") == 1  # unchanged tables
    eng.pool.ensure_capacity_batch(np.asarray([5, 5]))
    eng.step_chunk(np.ones((2, 1), np.int32), np.asarray([4, 4], np.int32),
                   np.asarray([1, 1], np.int32))
    assert t.counter_value("host_transfers_total") == 2


def test_engine_cpu_runs_count_no_kernel_launch():
    before = pa.paged_attend.launches
    serve.run_continuous(_engine(), QUEUE[:2], gen=2, quiet=True)
    assert pa.paged_attend.launches == before


def test_engine_defaults_to_cuda_and_refuses_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Engine(cfg, slots=1, max_seq=8)


@pytest.mark.parametrize("kw", [dict(family="encdec", n_enc_layers=2,
                                     enc_context=32)])
def test_later_slice_features_raise(kw):
    """The model families of ROADMAP.md Queue 1 item 11 still raise
    (encoder-decoder stacks: whisper, item 11e).  The dense cache
    (``tests/test_torch_bucketed.py``), tensor-parallel serving (item 9,
    ``tests/test_torch_mesh.py``), experts (granite, item 11a,
    ``tests/test_torch_moe.py``), MLA attention (deepseek, item 11b,
    ``tests/test_torch_mla.py``), SSM stacks (mamba2, item 11c,
    ``tests/test_torch_mamba2.py``) and hybrid stacks (jamba, item 11d,
    ``tests/test_torch_jamba.py``), which raised here before, are served
    since."""
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged"), **kw)
    with pytest.raises(NotImplementedError, match="item 11e"):
        serve.Engine(cfg, slots=1, max_seq=8, device="cpu")


def test_cli_on_cpu(capsys):
    outputs = serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device",
                          "cpu", "--requests", "3", "--slots", "2",
                          "--gen", "3", "--prompt-len", "2,6", "--stream"])
    assert sorted(outputs) == [0, 1, 2]
    assert "req2:" in capsys.readouterr().out


class _Recorded(serve.Engine):
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _Recorded.made.append(self)


CLI = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--requests",
       "5", "--slots", "2", "--gen", "8", "--prompt-len", "3,9,5",
       "--page-size", "4"]


def _cli(monkeypatch, *extra):
    _Recorded.made.clear()
    monkeypatch.setattr(serve, "Engine", _Recorded)
    outputs = serve.main(CLI + list(extra))
    (eng,) = _Recorded.made
    return outputs, eng


def test_cli_defaults_serve_float_pages(monkeypatch, capsys):
    """The reference CLI's defaults: no policy, ``--quant none``: float
    pages of the model's dtype (bf16), no stochastic write stream; the
    deprecated ``--quant none`` is the same run, and ``--policy
    serve_fp8_paged`` serves FP8 pages."""
    outputs, eng = _cli(monkeypatch)
    assert eng.cache["kp"].dtype == torch.bfloat16
    assert eng._token_key is None and not eng.cfg.policy.kv_quantized
    again, _ = _cli(monkeypatch, "--quant", "none")
    assert again == outputs
    _, fp8 = _cli(monkeypatch, "--policy", "serve_fp8_paged")
    assert fp8.cache["kp"].dtype == torch.uint8
    assert "preemptions" in capsys.readouterr().out


def test_cli_small_pool_preempts_and_restores(monkeypatch, capsys):
    """``--pages`` below the worst case: the run reports preemptions and
    restores, and prints the same tokens as with a worst-case pool."""
    full, _ = _cli(monkeypatch)
    out_full = capsys.readouterr().out
    small, eng = _cli(monkeypatch, "--pages", "6")
    out_small = capsys.readouterr().out
    assert "0 preemptions, 0 restores" in out_full
    assert eng.pool.spills >= 1 and eng.pool.restores == eng.pool.spills
    assert f"{eng.pool.spills} preemptions, {eng.pool.restores} restores" \
        in out_small
    assert small == full
    tokens = [line for line in out_small.splitlines()
              if line.startswith("  req")]
    assert tokens == [line for line in out_full.splitlines()
                      if line.startswith("  req")]


def test_cli_policy_and_quant_are_exclusive(monkeypatch):
    with pytest.raises(SystemExit):
        serve.main(CLI + ["--policy", "serve_fp8_paged", "--quant",
                          "fp8_lns"])


def test_cli_lifecycle_flags(monkeypatch, capsys):
    """``--max-tokens`` caps every request's budget; ``--deadline-steps``
    times requests out; ``--max-queue`` sheds; the watermarks and
    ``--profile-spans`` reach the scheduler and the telemetry."""
    capped, eng = _cli(monkeypatch, "--max-tokens", "3", "--profile-spans",
                       "--watermark-high", "0.9", "--watermark-low", "0.5")
    assert eng.tel.profile
    assert sorted(capped) == list(range(5))
    assert all(len(o) == 3 for o in capped.values())
    _cli(monkeypatch, "--deadline-steps", "2")
    assert "timed_out" in capsys.readouterr().out
    _cli(monkeypatch, "--max-queue", "1")
    assert "rejected" in capsys.readouterr().out


def test_telemetry_profile_spans_use_torch_profiler():
    tel = Telemetry(profile=True)
    with tel.span("decode"):
        pass
    assert tel.phase_seconds()["decode"]["count"] == 1
