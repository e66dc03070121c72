"""PyTorch port: page pool, continuous scheduler and Engine on the CPU.

* The pool is checked differentially: one random op sequence drives the
  port's pool and the reference's, and block tables, owner lists,
  refcounts, free lists and versions must stay identical.
* The Engine runs ``run_continuous`` end to end at ``smoke()`` size with
  ``device="cpu"`` (plain versions of the kernels), fused on and off.
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


def test_engine_token_streams_match_reference_engine():
    """With float32 parameters carried across, the port's token streams
    equal the reference engine's (greedy sampling; the logits agree to
    ~1e-5, far inside the random model's top-2 gaps)."""
    jcfg = dataclasses.replace(
        jget_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged"),
        param_dtype="float32")
    jeng = jserve.Engine(jcfg, slots=2, max_seq=24, page_size=4)
    ref, _ = jserve.run_continuous(jeng, QUEUE, gen=6, chunk=4, quiet=True)
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged"),
        param_dtype="float32")
    eng = serve.Engine(cfg, slots=2, max_seq=24, page_size=4, device="cpu")
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    port, _ = serve.run_continuous(eng, QUEUE, gen=6, chunk=4, quiet=True)
    assert port == ref


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
    before = pa.paged_partials.launches
    serve.run_continuous(_engine(), QUEUE[:2], gen=2, quiet=True)
    assert pa.paged_partials.launches == before


def test_engine_defaults_to_cuda_and_refuses_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Engine(cfg, slots=1, max_seq=8)


@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(cache_impl="dense")])
def test_later_slice_features_raise(kw):
    with pytest.raises(NotImplementedError):
        _engine(**kw)


def test_preemption_raises_until_ported():
    eng = _engine()
    with pytest.raises(NotImplementedError):
        eng.preempt_slot(0)


def test_engine_refuses_float_kv_policy():
    cfg = get_config("qwen2-0.5b", smoke=True, policy="train_bf16")
    with pytest.raises(NotImplementedError):
        serve.Engine(cfg, slots=1, max_seq=8, device="cpu")


def test_cli_on_cpu(capsys):
    outputs = serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device",
                          "cpu", "--requests", "3", "--slots", "2",
                          "--gen", "3", "--prompt-len", "2,6", "--stream"])
    assert sorted(outputs) == [0, 1, 2]
    assert "req2:" in capsys.readouterr().out


def test_telemetry_profile_spans_use_torch_profiler():
    tel = Telemetry(profile=True)
    with tel.span("decode"):
        pass
    assert tel.phase_seconds()["decode"]["count"] == 1
