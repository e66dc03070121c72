"""Fault tolerance of the training loop: port of ``StepWatchdog``,
``write_heartbeat`` and ``run_training`` of ``repro.runtime.fault``.

``run_training`` is the crash-safe loop: periodic asynchronous
checkpoints, and restore-and-continue after a failed step.  On the card a
failure must not hide a kernel, so the port narrows what is retried:

* a refused kernel launch (:class:`~repro_torch.kernels.cuda_build.
  KernelLaunchError`) ends the run at once;
* after any other failure the loop synchronises the device, and a sticky
  CUDA error, which poisons every later launch, ends the run;
* each restart is logged, and every history entry carries the number of
  restarts so far, so a caller can insist on none.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Callable, Optional

import torch

from ..checkpoint import store
from ..data.pipeline import Dataset
from ..kernels.cuda_build import KernelLaunchError

__all__ = ["StepWatchdog", "write_heartbeat", "run_training"]

STEP_DEADLINE_S = 3600.0
MAX_RESTARTS = 3


class StepWatchdog:
    """Detects straggling steps: ``check()`` raises if the step started by
    ``start()`` ran past its deadline."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def check(self):
        if (self._t0 is not None
                and time.monotonic() - self._t0 > self.deadline_s):
            raise TimeoutError(
                f"step exceeded {self.deadline_s}s deadline (straggler)")
        self._t0 = None


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
