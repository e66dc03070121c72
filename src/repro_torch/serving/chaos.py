"""Chaos harness: deterministic fault injection for the serving engine.
Port of ``repro.serving.chaos`` (numpy and Python only).

The robustness contract of the paged FP8 engine is twofold: (1) no
individual request failure — oversized, deadline-blown, cancelled — ever
takes down the run or leaks pages, and (2) the bit-identity invariants
(KV page codes are a pure function of page *content* thanks to the
position-addressed stochastic-rounding streams) survive preemption,
exhaustion, and crash/restore.  This module injects exactly those faults,
reproducibly, so the contract is testable instead of aspirational.

A :class:`FaultPlan` is a seed-driven schedule of fault *kinds*; the
:class:`ChaosHarness` wraps a :class:`~.scheduler.ContinuousScheduler` and
draws from one ``numpy`` Generator in a fixed per-step order, so the same
plan against the same request stream injects the same faults at the same
steps — a chaos failure reproduces from its seed alone.

Fault kinds:

* **Pool exhaustion** — :meth:`PagePool.seize` pulls pages off the free
  list for a few steps (an external memory squeeze).  The scheduler must
  degrade (park/preempt, pause admission at the watermark) and recover
  when the pages return.
* **Preemption storm** — every active slot but the oldest is spilled at
  once.  Restores must be bit-identical (codes copied verbatim).
* **Slot-state corruption** — a held page's refcount is bumped behind the
  allocator's back.  ``assert_invariants`` must catch it (the drill
  *fails* if the corruption goes undetected), then the harness repairs it
  and re-verifies.
* **Step-deadline overrun** — the serving :class:`StepWatchdog`'s clock is
  rewound so the next ``check()`` trips, exercising the straggler path.
* **Engine kill** — :class:`EngineKilled` is raised *before* step N
  executes.  ``runtime.fault.run_serving`` catches it, rebuilds the engine
  and restores the latest snapshot; survivors' remaining tokens must be
  bit-identical to an uninterrupted run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .telemetry import Telemetry

__all__ = ["FaultPlan", "ChaosHarness", "EngineKilled"]


class EngineKilled(RuntimeError):
    """Simulated hard crash of the serving engine at a given step."""

    def __init__(self, step: int):
        super().__init__(f"engine killed at step {step} (injected)")
        self.step = step


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seed-driven schedule of injected serving faults.

    Per-fault fields are *per-step probabilities* (drawn from one seeded
    Generator in a fixed order, so runs are reproducible); ``kill_at_step``
    is a deterministic one-shot.  ``horizon`` stops all injection after
    that many scheduler steps so a finite request stream can always drain.
    """

    seed: int = 0
    horizon: int = 10_000  # no injections at/after this step
    pool_exhaustion: float = 0.0  # P(seize pages this step)
    exhaustion_pages: int = 2  # pages taken per seizure
    exhaustion_hold: int = 3  # steps until a seizure is released
    preemption_storm: float = 0.0  # P(spill all but the oldest slot)
    corruption: float = 0.0  # P(refcount-corruption detection drill)
    overrun: float = 0.0  # P(forced step-deadline overrun)
    kill_at_step: Optional[int] = None  # raise EngineKilled before this step


class ChaosHarness:
    """Wraps a scheduler's ``step()`` with fault injection.

    ``harness.step()`` (1) raises :class:`EngineKilled` when the plan's
    kill step is reached — *before* the step runs, like a real crash
    between steps; (2) releases seizures whose hold expired; (3) draws the
    step's fault coin-flips in a fixed order (exhaustion, storm,
    corruption, overrun) and injects; then (4) runs the wrapped scheduler
    step.  Stats are in :attr:`counts`.

    The corruption injection is a *detection drill*: it corrupts a
    refcount, requires ``assert_invariants`` to raise, repairs the
    corruption, and re-verifies the pool is clean — if the corruption goes
    undetected the harness raises, because an invariant checker that
    misses a bumped refcount would also miss a real double-share bug.
    """

    def __init__(self, sched, plan: FaultPlan, watchdog=None):
        self.sched = sched
        self.plan = plan
        self.watchdog = watchdog  # serving StepWatchdog (overrun target)
        self.rng = np.random.default_rng(plan.seed)
        self.counts = {"exhaustion": 0, "storm": 0, "corruption": 0,
                       "overrun": 0, "killed": 0}
        self._seizures: list = []  # (release_at_step, [page ids])
        # injected faults land in the scheduler's registry so the chaos
        # timeline interleaves with the phase spans in one trace
        self.tel: Telemetry = getattr(sched, "tel", None) or Telemetry()

    def _record(self, kind: str, **args) -> None:
        self.counts[kind] += 1
        self.tel.counter("chaos_faults_total", kind=kind).inc()
        self.tel.event(f"chaos/{kind}", step=self.sched.steps, **args)

    # ------------------------------------------------------------------ #
    def _release_due(self) -> None:
        pool = self.sched.pool
        keep = []
        for release_at, ids in self._seizures:
            if self.sched.steps >= release_at:
                pool.release_seized(ids)
            else:
                keep.append((release_at, ids))
        self._seizures = keep

    def release_all_seizures(self) -> None:
        """Return every outstanding seized page (end-of-run cleanup)."""
        for _, ids in self._seizures:
            self.sched.pool.release_seized(ids)
        self._seizures = []

    # ------------------------------------------------------------------ #
    def _inject_exhaustion(self) -> None:
        pool = self.sched.pool
        ids = pool.seize(self.plan.exhaustion_pages)
        if ids:
            self._record("exhaustion", pages=len(ids),
                         hold=self.plan.exhaustion_hold)
            self._seizures.append(
                (self.sched.steps + self.plan.exhaustion_hold, ids)
            )

    def _inject_storm(self) -> None:
        if len(self.sched.active) > 1:
            self._record("storm", victims=len(self.sched.active) - 1)
        while len(self.sched.active) > 1:
            self.sched._preempt_victim()

    def _inject_corruption(self) -> None:
        pool = self.sched.pool
        held = [pid for pid in range(1, pool.num_pages)
                if pool.ref[pid] > 0]
        if not held:
            return
        pid = held[int(self.rng.integers(len(held)))]
        pool.ref[pid] += 1  # corrupt: a reference no block table holds
        try:
            pool.assert_invariants()
        except AssertionError:
            pool.ref[pid] -= 1  # detected: repair and re-verify
            pool.assert_invariants()
            self._record("corruption", page=pid)
            return
        pool.ref[pid] -= 1
        raise RuntimeError(
            f"invariant checker MISSED an injected refcount corruption "
            f"on page {pid}"
        )

    def _inject_overrun(self) -> None:
        if self.watchdog is not None and self.watchdog.inject_overrun():
            self._record("overrun")

    # ------------------------------------------------------------------ #
    def step(self) -> None:
        plan, sched = self.plan, self.sched
        if plan.kill_at_step is not None and sched.steps >= plan.kill_at_step:
            self._record("killed")
            raise EngineKilled(sched.steps)
        self._release_due()
        # one draw per fault kind, every step, whether or not it fires:
        # the Generator stream position stays aligned with the step count,
        # so a plan reproduces exactly even if a fault is inapplicable
        # (e.g. a storm with one active slot) on some step.
        coins = self.rng.random(4)
        if sched.steps < plan.horizon:
            if coins[0] < plan.pool_exhaustion:
                self._inject_exhaustion()
            if coins[1] < plan.preemption_storm:
                self._inject_storm()
            if coins[2] < plan.corruption:
                self._inject_corruption()
            if coins[3] < plan.overrun:
                self._inject_overrun()
        sched.step()

    def pending(self) -> bool:
        return self.sched.pending()
