"""PyTorch port: serving faults on a tensor-parallel mesh.

The reference's ``tests/test_serving_distributed.py`` contracts beyond the
steady state, on 2 spawned gloo ranks (``launch.mesh.run_ranks``, a
``FileStore`` in ``tmp_path``, one intra-op thread a rank, a hard time
limit), qwen2-0.5b smoke under ``serve_fp8_paged`` with stochastic KV
writes on lively weights:

* a tight pool forces a spill on the mesh engine, and a snapshot taken
  while a request sits PREEMPTED restores into a fresh mesh engine; both
  finish with the uninterrupted TP=1 run's tokens;
* a chaos kill at step 7, the engine rebuilt on the mesh and restored from
  the latest snapshot (gathered over the ranks, written by rank 0): every
  request's tokens equal the fault-free TP=1 run's;
* elastic snapshots: a run snapshotted mid-decode on TP=1 restores into a
  TP=2 engine and one snapshotted on TP=2 into a TP=1 engine, and both
  finish with the uninterrupted run's tokens (the layout is
  mesh-independent).

One case carries the ``cuda`` marker and skips without a card: the
preemption case with both ranks on one card (gloo, as ``chip_smoke.py``'s
mesh runs) and collectives that refuse tensors off the card, as NCCL
does, so the snapshot's gather of the host spills is held to NCCL's rule.
"""
import pytest
import torch

import torch_mesh_workers as workers
from repro_torch.launch.mesh import run_ranks

SPAWN_TIMEOUT = 150.0  # the spawned mesh run, spawn to join


@pytest.fixture(scope="module")
def faults(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_faults")
    ranks = run_ranks(workers.fault_suite, 2, init_file=root / "store",
                      backend="gloo", args=(str(root),),
                      timeout=SPAWN_TIMEOUT)
    return ranks


def test_preempt_restore_mid_decode_on_mesh(faults):
    for rank in faults:
        p = rank["preempt"]
        assert p["spilled"] >= 1, "the pool never forced a preemption"
        step, at, preempted = p["restored"]
        assert step == at and preempted == p["spilled"]
        assert p["kv_heads"] == 1
        assert p["spill_device"] == ["cpu"]  # the snapshot gathers host spills
        assert p["out2"] == p["out1"] == p["base"]
        assert any(len(set(o)) > 1 for o in p["base"].values())


@pytest.mark.cuda
def test_snapshot_while_preempted_on_card_mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import cuda_build

    cuda_build.build(["paged_attention"])  # once, before the ranks start
    ranks = run_ranks(workers.card_preempt_case, 2,
                      init_file=tmp_path / "store", backend="gloo",
                      device="cuda:0", args=(str(tmp_path / "ckpt"),),
                      timeout=SPAWN_TIMEOUT)
    for p in ranks:
        assert p["mesh_device"] == "cuda:0"
        assert p["spilled"] >= 1, "the pool never forced a preemption"
        assert p["spill_device"] == ["cpu"]
        step, at, preempted = p["restored"]
        assert step == at and preempted == p["spilled"]
        assert p["out2"] == p["out1"] == p["base"]


def test_chaos_kill_and_restore_on_mesh_bitwise(faults):
    for rank in faults:
        c = rank["chaos"]
        assert c["base_restarts"] == 0
        assert c["restarts"] == 1 and c["killed"] == 1
        assert c["restored_from"] is not None
        assert c["finished"] == 4 and c["out"] == c["base"]
        assert c["heartbeat"]  # rank 0 writes it


@pytest.mark.parametrize("tag", ["1->2", "2->1"])
def test_elastic_snapshot_reshard_tp1_tp2_both_ways(faults, tag):
    for rank in faults:
        r = rank["reshard"]["runs"][tag]
        assert r["pending"], "the snapshot must land mid-stream"
        assert r["step"] == r["at"]
        assert r["out"] == rank["reshard"]["base"]
