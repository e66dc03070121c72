"""Fault tolerance: port of ``StepWatchdog``, ``write_heartbeat``,
``run_training`` and ``run_serving`` of ``repro.runtime.fault``.

``run_training`` is the crash-safe training loop: periodic asynchronous
checkpoints, and restore-and-continue after a failed step.  On the card a
failure must not hide a kernel, so the port narrows what is retried:

* a refused kernel launch (:class:`~repro_torch.kernels.cuda_build.
  KernelLaunchError`) ends the run at once;
* after any other failure the loop synchronises the device, and a sticky
  CUDA error, which poisons every later launch, ends the run;
* each restart is logged, and every history entry carries the number of
  restarts so far, so a caller can insist on none.

``run_serving`` is the same discipline around the serving engine:
heartbeats with the scheduler's stats, a snapshot every N steps
(``serving.snapshot``), watchdog overruns survived as degraded service,
and an engine rebuilt and restored from the latest snapshot after a kill
(``serving.chaos.EngineKilled``).  It recovers from those two faults
only: any other error, a failed kernel launch above all, propagates, and
a sticky CUDA error surfaces before a recovery.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import store
from ..data.pipeline import Dataset
from ..kernels.cuda_build import KernelLaunchError

__all__ = ["StepWatchdog", "write_heartbeat", "run_training",
           "run_serving"]

STEP_DEADLINE_S = 3600.0
MAX_RESTARTS = 3


class StepWatchdog:
    """Detects straggling steps: ``check()`` raises if the step started by
    ``start()`` ran past its deadline."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self._t0: Optional[float] = None
        self.tripped = False

    def start(self):
        self._t0 = time.monotonic()

    def check(self):
        if (self._t0 is not None
                and time.monotonic() - self._t0 > self.deadline_s):
            self.tripped = True
            raise TimeoutError(
                f"step exceeded {self.deadline_s}s deadline (straggler)")
        self._t0 = None

    def inject_overrun(self) -> bool:
        """Chaos hook: move the running step's start back past the
        deadline, so that the next ``check()`` trips.  Returns True iff a
        step was running (``start()`` called, ``check()`` not yet)."""
        if self._t0 is None:
            return False
        self._t0 -= self.deadline_s + 1.0
        return True


def write_heartbeat(path, step: int, extra: dict | None = None):
    """Atomically (re)write the heartbeat file: write + fsync a temp file,
    then ``os.replace`` it over the target."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps({"step": step, "t": time.time(), **(extra or {})}))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _raise_if_device_broken(err: BaseException) -> None:
    """Re-raise when the CUDA context is poisoned: a sticky error makes
    every later launch fail, so a restart could only hide it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        try:
            torch.cuda.synchronize()
        except RuntimeError as sticky:
            raise sticky from err


def run_training(*, train_step: Callable, init_state: Callable,
                 dataset: Dataset, max_steps: int, ckpt_dir,
                 ckpt_every: int = 50, to_device: Callable = lambda b: b,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 log: Callable = print):
    """Crash-safe training loop.  Returns (state, history): one entry per
    logged step (every ``ckpt_every`` steps and the last), with the
    step's metrics as floats and ``restarts``, the restarts so far."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    heartbeat = ckpt_dir / "heartbeat.json"
    watchdog = StepWatchdog(STEP_DEADLINE_S)
    history = []
    restarts = 0

    def _restore():
        state, step, dstate = store.restore(ckpt_dir, init_state())
        return state, (Dataset.resume_step(dstate) if dstate else step)

    if store.latest_step(ckpt_dir) is not None:
        state, step = _restore()
        log(f"[fault] resumed from checkpoint at step {step}")
    else:
        state, step = init_state(), 0

    pending = None
    while step < max_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)  # test hook: may raise to simulate a crash
            watchdog.start()
            batch = to_device(dataset.batch(step))
            state, metrics = train_step(state, batch)
            watchdog.check()
            step += 1
            if step % ckpt_every == 0 or step == max_steps:
                metrics = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, **metrics,
                                "restarts": restarts})
                log(f"[train] step {step}: {metrics}")
                if pending is not None:
                    pending.result()  # don't stack async writes
                pending = store.save(ckpt_dir, state, step=step,
                                     data_state=dataset.state(step))
                write_heartbeat(heartbeat, step)
        except KernelLaunchError:
            raise
        except (TimeoutError, RuntimeError, ValueError) as e:
            _raise_if_device_broken(e)
            restarts += 1
            if restarts > MAX_RESTARTS:
                raise
            log(f"[fault] step {step} failed ({e}); restoring last "
                f"checkpoint (restart {restarts}/{MAX_RESTARTS})")
            if pending is not None:
                pending.result()
            if store.latest_step(ckpt_dir) is None:
                state, step = init_state(), 0
            else:
                state, step = _restore()
    if pending is not None:
        pending.result()
    return state, history


def run_serving(make_engine: Callable, queue, *, gen: int,
                temperature: float = 0.0, seed: int = 0, arrivals=None,
                chunk: int = 4, on_token: Optional[Callable] = None,
                deadline_steps: Optional[int] = None,
                deadline_s: Optional[float] = None,
                max_tokens: Optional[int] = None,
                max_queue: Optional[int] = None,
                watermark_high: float = 1.0, watermark_low: float = 0.75,
                control=None, chaos=None, ckpt_dir=None,
                snapshot_every: int = 0, resume: bool = False,
                heartbeat_path=None, heartbeat_every: int = 1,
                step_deadline_s: Optional[float] = None,
                max_restarts: int = MAX_RESTARTS, log: Callable = print):
    """Crash-safe serving loop: ``run_training``'s discipline around the
    continuous scheduler.  Returns (outputs, stats).

    ``make_engine`` builds a fresh ``launch.serve.Engine`` (called again
    after every kill: a crashed engine's device state is garbage by
    definition); ``queue`` is the prompt list.  Per-request deadlines,
    caps and backpressure knobs pass straight to the scheduler; ``chaos``
    is an optional :class:`~repro_torch.serving.chaos.FaultPlan`.

    Faults survived, per step:

    * ``TimeoutError`` from the :class:`StepWatchdog` (a straggling or
      chaos-overrun step): counted; the step's work is already committed,
      so service degrades instead of dying.
    * ``EngineKilled`` (a chaos kill, standing in for a real crash): the
      killed engine is dropped, a new one built, and the latest snapshot
      under ``ckpt_dir`` restored into it; survivors resume mid-stream
      with the tokens of an uninterrupted run (position-addressed KV
      rounding).  With no snapshot on disk the whole request stream is
      replayed cold (tokens already streamed through ``on_token``
      repeat).

    Any other exception propagates, and before either recovery the device
    is synchronised so that a sticky CUDA error ends the run instead.
    ``snapshot_every > 0`` (with ``ckpt_dir``) snapshots the serving state
    every N scheduler steps; ``resume=True`` restores the latest snapshot
    at startup instead of seeding ``queue`` (a process restart).
    Heartbeats carry per-step scheduler stats for an orchestrator.
    ``stats["restored_from"]`` is the step of the last snapshot restored,
    at startup or after a kill (None when none was).

    Tensor-parallel: every rank of a mesh runs this with the same
    arguments and a ``make_engine`` that builds its mesh engine (or, after
    a kill, any engine: a TP=1 successor restores the same snapshot).  The
    plan's draws are deterministic, so a kill or an overrun happens on
    every rank at the same step; snapshots gather the shards and rank 0
    writes them and the heartbeats.
    """
    from ..launch.serve import sample as _sample
    from ..serving import (ChaosHarness, ContinuousScheduler, EngineKilled,
                           Request, load_snapshot, save_snapshot)

    if ckpt_dir is not None:
        ckpt_dir = pathlib.Path(ckpt_dir)
        if heartbeat_path is None:
            heartbeat_path = ckpt_dir / "heartbeat.json"
    rng = np.random.default_rng(seed)

    def sample_row(row: np.ndarray) -> int:
        return int(_sample(row[None], temperature, rng)[0])

    def build():
        eng = make_engine()
        sched = ContinuousScheduler(
            eng, chunk=chunk, sample=sample_row, on_token=on_token,
            control=control, max_tokens=max_tokens, max_queue=max_queue,
            watermark_high=watermark_high, watermark_low=watermark_low)
        return eng, sched

    def seed_requests(sched):
        for i, prompt in enumerate(queue):
            sched.add(Request(
                rid=i, prompt=np.asarray(prompt), gen=gen,
                arrival=0 if arrivals is None else int(arrivals[i]),
                deadline_steps=deadline_steps, deadline_s=deadline_s))

    eng, sched = build()
    restored_from = None
    if (resume and ckpt_dir is not None
            and store.latest_step(ckpt_dir) is not None):
        restored_from = load_snapshot(ckpt_dir, eng, sched, sampler_rng=rng)
        log(f"[serve:fault] resumed from snapshot at step {restored_from}")
    else:
        seed_requests(sched)

    watchdog = StepWatchdog(step_deadline_s) if step_deadline_s else None
    harness = (ChaosHarness(sched, chaos, watchdog) if chaos is not None
               else None)
    restarts = overruns = snapshots = 0
    t0 = sched.tel.clock()
    while sched.pending():
        killed = None
        try:
            if watchdog is not None:
                watchdog.start()
            (harness if harness is not None else sched).step()
            if watchdog is not None:
                watchdog.check()
        except TimeoutError as e:
            # the overrun step's work is committed: degrade, don't die
            _raise_if_device_broken(e)
            overruns += 1
            sched.tel.counter("fault_watchdog_overruns_total").inc()
            log(f"[serve:fault] step {sched.steps} overran: {e}")
        except EngineKilled as e:
            # recovered below, once the traceback (whose frames hold the
            # killed engine) is gone
            killed = e.with_traceback(None)
        if killed is not None:
            restarts += 1
            if restarts > max_restarts:
                raise killed
            _raise_if_device_broken(killed)
            log(f"[serve:fault] {killed}; rebuilding engine "
                f"(restart {restarts}/{max_restarts})")
            if chaos is not None:
                # the kill fired: the rebuilt engine must not die again at
                # the same step
                chaos = dataclasses.replace(chaos, kill_at_step=None)
            counts = harness.counts if harness is not None else None
            # drop the killed engine before its successor draws its own
            # weights and cache
            eng = sched = harness = None
            eng, sched = build()
            if (ckpt_dir is not None
                    and store.latest_step(ckpt_dir) is not None):
                t_restore = sched.tel.clock()
                with sched.tel.span("snapshot_restore"):
                    step = load_snapshot(ckpt_dir, eng, sched,
                                         sampler_rng=rng)
                sched.tel.histogram("snapshot_restore_seconds").observe(
                    sched.tel.clock() - t_restore)
                sched.tel.counter("snapshot_restores_total").inc()
                restored_from = step
                log(f"[serve:fault] restored snapshot at step {step}")
            else:
                rng = np.random.default_rng(seed)  # cold restart: replay
                seed_requests(sched)
            # counted after the restore, whose registry replaced the fresh
            # one: the restart just survived goes on top
            sched.tel.counter("fault_restarts_total").inc()
            if counts is not None:
                harness = ChaosHarness(sched, chaos, watchdog)
                harness.counts = counts
                # faults injected between the snapshot and the kill (the
                # kill included) are newer than the restored registry
                for kind, v in counts.items():
                    if v:
                        sched.tel.counter(
                            "chaos_faults_total", kind=kind).value = float(v)
            continue
        if (heartbeat_path is not None
                and (eng.mesh is None or eng.mesh.rank == 0)
                and sched.steps % max(heartbeat_every, 1) == 0):
            write_heartbeat(pathlib.Path(heartbeat_path), sched.steps, extra={
                "active": len(sched.active),
                "queued": len(sched.queued),
                "preempted": len(sched.preempted),
                "finished": len(sched.finished),
                "decoded_tokens": sched.decoded_tokens,
                "preemptions": sched.preemptions,
                "free_pages": sched.pool.free_pages,
            })
        if (ckpt_dir is not None and snapshot_every > 0
                and sched.steps % snapshot_every == 0 and sched.pending()):
            t_save = sched.tel.clock()
            with sched.tel.span("snapshot_save"):
                save_snapshot(ckpt_dir, eng, sched,
                              sampler_rng=rng if temperature > 0 else None)
            sched.tel.histogram("snapshot_save_seconds").observe(
                sched.tel.clock() - t_save)
            sched.tel.counter("snapshot_saves_total").inc()
            snapshots += 1
    if harness is not None:
        harness.release_all_seizures()
    dt = sched.tel.clock() - t0
    stats = dict(
        steps=sched.steps, wall_s=dt,
        tok_s=sched.decoded_tokens / dt if dt > 0 else 0.0,
        decode_tok_s=(sched.decode_step_tokens / sched.decode_wall_s
                      if sched.decode_wall_s > 0 else 0.0),
        preemptions=sched.preemptions,
        shed=sched.shed,
        terminal=dict(sched.terminal_counts),
        statuses=sched.statuses(),
        requests=sched.request_traces(),
        restarts=restarts,
        watchdog_overruns=overruns,
        snapshots=snapshots,
        restored_from=restored_from,
        chaos=dict(harness.counts) if harness is not None else None,
        phases=sched.tel.phase_seconds(),
        telemetry=sched.tel,
    )
    return sched.outputs, stats
