"""Device meshes over ``torch.distributed``: one process per shard.

Port of ``repro.launch.mesh``.  JAX lays a mesh over the devices of one
process; the port runs one process per shard instead, each holding its
own slice of the weights and the cache, and joins them with the two exact
collectives tensor-parallel serving needs (``parallel.hints``):

* :meth:`Mesh.all_gather` concatenates the shards in rank order;
* :meth:`Mesh.all_max` takes an elementwise maximum, which does not
  depend on the order the ranks arrive in.

No collective sums values, so a TP=N engine computes every contraction
whole, on every rank, and its token stream is the TP=1 stream bit for
bit.

**Transport.**  The process group's backend is the caller's choice, made
in its own ``torch.distributed.init_process_group`` call; the mesh reads
it and never picks another:

* ``gloo`` with CPU tensors (the tests, ``--device cpu``);
* ``nccl`` with one card per rank (``cuda:LOCAL_RANK``);
* ``gloo`` with CUDA tensors, for ranks that share one card.  NCCL refuses
  two ranks on one device ("Duplicate GPU detected", NCCL 2.28 on an
  H100), while gloo takes CUDA tensors for ``all_gather``, ``all_reduce``
  and ``broadcast`` (PyTorch 2.11) and copies them through host memory
  inside the collective, which waits for the card.  ``chip_smoke.py``'s
  two-rank run on one H100 takes this route and prints
  :attr:`Mesh.transport`.

Every collective runs on tensors on the rank's device (:attr:`Mesh.device`):
a tensor held elsewhere, such as a preempted request's spill, which
``Engine.preempt_slot`` keeps in host memory while the mesh runs on the
card, is copied there, and the result is copied back to where the tensor
was.  NCCL takes tensors on the rank's card only.

On the card, TP=N equals TP=1 bit for bit only when cuBLAS computes a
product's columns the same way whatever their number: with the default
workspace it picks, for some widths, an algorithm that splits the inner
dimension (gemma3-12b's ``wq``, [4, 3840] x [3840, 4096], differs from its
two [3840, 2048] halves), and with ``CUBLAS_WORKSPACE_CONFIG=:0:0`` it
does not.  So every card engine, mesh or not, runs without split-K
(:func:`require_column_stable_cublas`, called by ``Engine`` and the serve
CLI): a plain run and a ``--mesh`` run print the same tokens.

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch qwen2-0.5b --smoke --device cpu --mesh 1x2

:func:`run_ranks` spawns the ranks of one mesh from a Python caller (the
tests, ``chip_smoke.py``) over a ``FileStore``, with a hard time limit.
"""
from __future__ import annotations

import math
import os
import queue as queue_mod
import time
import traceback
from datetime import timedelta
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_production_mesh", "parse_mesh_arg", "run_ranks",
           "CUBLAS_DETERMINISTIC", "require_column_stable_cublas"]

# cuBLAS without split-K workspaces: a product's column block is computed
# as it is inside the whole product (see the module docstring)
CUBLAS_DETERMINISTIC = ":0:0"
# a spawned rank's limit on any one collective: a hung peer fails it
COLLECTIVE_TIMEOUT_S = 60.0


def require_column_stable_cublas(device) -> None:
    """Make this process's cuBLAS run without split-K workspaces before
    its first product on ``device`` (nothing for a CPU device): set
    ``CUBLAS_WORKSPACE_CONFIG`` to :data:`CUBLAS_DETERMINISTIC` while the
    process has not initialised CUDA, the one state in which no cuBLAS
    product can have run yet.  (On an H100 the variable still took effect
    when set after CUDA's initialisation and after a small product,
    ``scripts/cublas_workspace_ab.py --probe``; PyTorch promises no such
    moment, so none is relied on.)  Raises ``RuntimeError`` when the
    variable holds another value, or is unset once CUDA is initialised:
    that process may already run cuBLAS with split-K, and its products
    would not be the ones a mesh engine's shards compute."""
    if torch.device(device).type != "cuda":
        return
    name, want = "CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC
    have = os.environ.get(name)
    if have == want:
        return
    if have is None and not torch.cuda.is_initialized():
        os.environ[name] = want
        return
    why = (f"it is {have!r}" if have is not None else
           "it is unset and CUDA is already initialised in this process")
    raise RuntimeError(
        f"card engines run cuBLAS without split-K: set {name}={want} before "
        f"this process's first CUDA call ({why}); with split-K a product's "
        "column block is not computed as inside the whole product, and "
        "tensor-parallel streams part from single-device ones")


class Mesh:
    """One rank's view of a serving mesh: ``shape`` ({"data": 1, "model":
    2}), ``axis_names``, ``rank`` (within the model axis), ``tp`` (the
    model axis's size), ``device``, the model axis's process ``group``
    (the default group, every axis but ``model`` being 1) and its
    ``backend`` and ``transport``."""

    def __init__(self, shape: Dict[str, int], *, device):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.tp = self.shape.get("model", 1)
        self.group = None
        self.device = torch.device(device)
        self.rank = dist.get_rank() if self.tp > 1 else 0
        self.backend = dist.get_backend() if self.tp > 1 else "none"
        self.transport = (f"{self.backend} on {self.device.type} tensors"
                          if self.tp > 1 else "none (one shard)")

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"transport={self.transport!r})")

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order
        (on ``x``'s device)."""
        if self.tp == 1:
            return x
        y = x.to(self.device).contiguous()
        parts = [torch.empty_like(y) for _ in range(self.tp)]
        dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.to(self.device, memory_format=torch.contiguous_format,
                 copy=True)
        dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.device)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of every rank's ``x`` (a new tensor)."""
        if self.tp == 1:
            return x
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's ``x``: not exact across
        shard counts, so nothing on the bitwise serving path calls it
        (only ``kernels.paged_attention.combine_partials_psum``)."""
        if self.tp == 1:
            return x
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (a view)."""
        if self.tp == 1:
            return x
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.rank * n, n)

    def barrier(self) -> None:
        if self.tp > 1:
            dist.barrier(group=self.group)


def make_production_mesh(*, shape: Sequence[int], device=None) -> Mesh:
    """This process's :class:`Mesh` over the initialised default process
    group: ``shape`` is ``(data, model)`` (``(pod, data, model)`` for
    three factors), e.g. ``(1, 2)`` for TP=2.  The world must hold
    exactly one process per shard, and every axis but ``model`` must be 1
    (serving is tensor-parallel only: data-parallel serving replicates
    whole engines).  ``device``: the rank's device (default the CPU under
    gloo, the current CUDA device under nccl)."""
    shape = tuple(int(s) for s in shape)
    if any(s < 1 for s in shape) or len(shape) not in (2, 3):
        raise ValueError(f"mesh shape must be 2 or 3 positive factors, got "
                         f"{shape}")
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    sizes = dict(zip(axes, shape))
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"need {n} processes for mesh {sizes}, have {world} — run under "
            f"torchrun --nproc-per-node {n} (one process per shard), or "
            "initialise torch.distributed with that many ranks")
    if world > n:
        raise RuntimeError(
            f"mesh {sizes} has {n} shards but the process group has {world} "
            "ranks: every rank must hold one shard")
    if n != sizes["model"]:
        raise ValueError(
            f"mesh {sizes}: serving is tensor-parallel only, every axis but "
            "'model' must have size 1")
    if device is None:
        backend = dist.get_backend() if n > 1 else "gloo"
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(sizes, device=device)


def parse_mesh_arg(spec: str) -> Tuple[int, ...]:
    """Parse a CLI mesh spec like ``"1x2"`` into an int shape tuple."""
    try:
        shape = tuple(int(p) for p in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"bad mesh spec {spec!r}: expected DATAxMODEL, e.g. 1x2")
    if len(shape) != 2 or any(s < 1 for s in shape):
        raise ValueError(
            f"bad mesh spec {spec!r}: expected two positive factors "
            "DATAxMODEL, e.g. 1x2")
    return shape


# --------------------------------------------------------------------------- #
# Spawned ranks
# --------------------------------------------------------------------------- #
def _rank_entry(fn, rank, world, backend, init_method, device, threads,
                timeout_s, args, results, collected) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        try:
            mesh = make_production_mesh(shape=(1, world), device=device)
            out = fn(mesh, *args)
            results.put((rank, True, out))
            # tensors in the result travel as shared memory that this
            # process hands over: it stays until the parent holds them
            collected.wait(timeout_s)
        finally:
            dist.destroy_process_group()
    except BaseException:
        # reported to the parent, which raises it with this traceback
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, *, init_file, backend: str,
              device="cpu", args: tuple = (), timeout: float = 120.0,
              threads: int = 1) -> List:
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks of a ``(1,
    world)`` mesh and return their results in rank order.

    The ranks meet through a ``FileStore`` at ``init_file`` (no TCP port,
    so concurrent callers cannot collide), on ``backend`` (the caller's
    choice, see the module docstring), each on ``device`` with ``threads``
    intra-op threads (0 keeps the default) and ``COLLECTIVE_TIMEOUT_S`` on
    every collective.  ``fn`` and ``args`` are pickled (a module-level
    function; CUDA tensors go by CUDA IPC, and the caller keeps them alive
    until this returns).  The whole run is bounded by ``timeout`` seconds:
    a rank that has not answered by then, or fails, fails the call, and
    every child is joined or terminated before it returns or raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results, collected = ctx.Queue(), ctx.Event()
    init_method = f"file://{init_file}"
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, backend, init_method, str(device),
                               threads, COLLECTIVE_TIMEOUT_S, args, results,
                               collected),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Tuple[bool, object]] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                if not any(p.is_alive() for p in procs) and results.empty():
                    break
                continue
            got[rank] = (ok, out)
            if not ok:
                break
    finally:
        collected.set()
        for p in procs:
            p.join(timeout=5.0 if len(got) == world else 0.5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
    failed = {r: out for r, (ok, out) in got.items() if not ok}
    if failed or len(got) < world:
        missing = sorted(set(range(world)) - set(got))
        detail = "\n".join(f"rank {r}:\n{tb}" for r, tb in sorted(failed.items()))
        raise RuntimeError(
            f"mesh run failed: ranks {sorted(failed)} raised, ranks "
            f"{missing} gave no result within {timeout:.0f} s (exit codes "
            f"{[p.exitcode for p in procs]})\n{detail}")
    return [got[r][1] for r in range(world)]
