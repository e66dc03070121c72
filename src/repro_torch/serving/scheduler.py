"""Continuous-batching scheduler: the host-side admission/preemption state
machine that drives the paged serving engine one step at a time.

Where the bucketed scheduler (``launch.serve.run_bucketed``) admits requests
in prompt-length buckets — one blocking batched prefill per bucket, with a
worst-case page reservation per request — this scheduler keeps every slot
busy every step:

  * **Chunked prefill.**  A prompt is fed ``chunk`` tokens per step through
    the same mixed step that decodes the other slots
    (``Model.step_paged``), so a long prompt never blocks decode steps and
    there is exactly one model trace however many prompt lengths are in
    flight (the bucketed path compiles one prefill per (batch, length)
    combination).
  * **Per-step admission.**  A queued request joins a free slot the step it
    arrives, needing only its *first chunk* of pages up front — no
    worst-case reservation, so the pool can overcommit.
  * **Preemption with spill/restore.**  When the pool runs dry mid-flight,
    the lowest-priority (youngest) slot is spilled: its page *codes* are
    copied out verbatim (``Engine.preempt_slot``), its pages freed, and the
    request parked.  Restore re-allocates pages and scatters the saved
    codes back — bit-identical, never re-quantized, so a preempted request
    resumes exactly where it left off.  The oldest active request is never
    preempted while others can be, which guarantees forward progress.
  * **Streaming.**  Each sampled token is surfaced through ``on_token`` the
    step it is produced.

Request lifecycle (**fault isolation**: every request reaches exactly one
terminal state; a request that cannot be served is terminated individually
— pages released, pool invariants intact — and never takes the run down)::

    QUEUED --admit--> PREFILL --last chunk--> DECODE --gen--> FINISHED
       |                ^  \\                  ^  \\
       |                |   +--pool dry-------+   |
       |                +------- PREEMPTED <------+
       |                         (spilled; resumes with restored pages)
       |
       +--> REJECTED   (oversized for the pool, or load-shed off a full
       |                bounded queue)
       +--> TIMED_OUT  (per-request step budget / wall-clock deadline)
       +--> CANCELLED  (``cancel(rid)`` or a ``ServeControl`` handle)
       +--> FAILED     (grew past the pool mid-flight, resume impossible,
                        or the engine stalled with no forward progress)

  * **Backpressure.**  ``max_queue`` bounds the arrived-but-unadmitted
    queue: overflow is load-shed (REJECTED) newest-first.  Page-pool
    **watermarks** pause new admissions when occupancy crosses
    ``watermark_high`` and resume below ``watermark_low`` — hysteresis
    that sheds load *before* ``_fit`` must thrash preemptions.
  * **Prefix-cache admission.**  When the engine's prefix cache is on,
    admission matches each queued prompt's longest cached page-prefix
    (``Engine.prefix_plan`` / ``admit_prefix``): matched pages are mapped
    read-only into the slot, only the *uncached tail* is charged to the
    page budget, and chunked prefill starts at the first uncached token
    (``req.n_prefilled`` starts at the matched length).  As prefill
    completes pages, ``Engine.note_prefilled`` publishes them for later
    requests.

The scheduler is pure host-side Python/numpy; the engine collaborator only
needs ``slots``, ``pool``, ``step_chunk``, ``preempt_slot``,
``restore_slot``, ``release`` and the prefix-cache trio ``prefix_plan`` /
``admit_prefix`` / ``note_prefilled`` (see ``launch.serve.Engine``).

This is the PyTorch port's verbatim copy of ``repro.serving.scheduler``.
In this slice of the port the engine's prefix cache is always off and its
``preempt_slot`` raises ``NotImplementedError`` (spill/restore arrives
with the next slice), so a pool must be sized to never run dry.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np

from .page_pool import invariant_checks_enabled
from .telemetry import Telemetry

__all__ = ["Request", "ContinuousScheduler", "ServeControl",
           "QUEUED", "PREFILL", "DECODE", "PREEMPTED",
           "FINISHED", "REJECTED", "TIMED_OUT", "CANCELLED", "FAILED",
           "TERMINAL_STATES", "DONE"]

# live states
QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
PREEMPTED = "preempted"
# terminal states (per-request fault isolation)
FINISHED = "finished"
REJECTED = "rejected"
TIMED_OUT = "timed_out"
CANCELLED = "cancelled"
FAILED = "failed"
DONE = FINISHED  # pre-fault-tolerance alias
TERMINAL_STATES = frozenset({FINISHED, REJECTED, TIMED_OUT, CANCELLED, FAILED})


class ServeControl:
    """Cancellation handle shared by caller and serving loop.

    ``cancel(rid)`` may be called from an ``on_token`` callback or any
    other thread; both schedulers poll it every step and terminate the
    request (state CANCELLED), releasing its pages.  Cancelling an unknown
    or already-terminal rid is a no-op."""

    def __init__(self):
        self._cancelled = set()

    def cancel(self, rid: int) -> None:
        self._cancelled.add(rid)

    def cancelled(self, rid: int) -> bool:
        return rid in self._cancelled


@dataclasses.dataclass
class Request:
    """One generation request and its scheduling state."""

    rid: int
    prompt: np.ndarray
    gen: int
    arrival: int = 0  # step index at which the request becomes admissible
    state: str = QUEUED
    # prompt tokens already in the KV cache: prefilled by this request OR
    # served read-only from the prefix cache at admission
    n_prefilled: int = 0
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    spill: Optional[dict] = None  # engine spill record while PREEMPTED
    # prompt chunk hashes, computed once at first admission attempt (the
    # chain is content-pure; re-planning a budget-blocked request every
    # step must not re-hash a long prompt)
    prefix_hashes: Optional[List[str]] = None
    preemptions: int = 0
    finished_step: int = -1  # -> per-request latency in the run stats
    # --- per-request fault-tolerance budget/bookkeeping ------------------ #
    deadline_steps: Optional[int] = None  # scheduler-step budget from arrival
    deadline_s: Optional[float] = None  # wall-clock budget from add()
    finish_reason: str = ""  # why the terminal state was reached
    t_added: float = -1.0  # scheduler clock at add() (deadline_s anchor)
    # --- lifecycle trace (telemetry; -1.0/-1 = never happened) ----------- #
    admitted_step: int = -1  # step of first slot admission
    first_token_step: int = -1  # step the first token was sampled
    t_first_token: float = -1.0  # clock at first sampled token (TTFT anchor)
    t_last_token: float = -1.0  # clock at latest token (inter-token anchor)
    prefix_cached_tokens: int = 0  # prompt tokens mapped from the prefix cache

    @property
    def plen(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def length(self) -> int:
        """Tokens currently written into the KV cache: the prefilled prompt
        plus every generated token except the last (sampled but not yet fed
        back)."""
        return self.n_prefilled + max(0, len(self.out) - 1)

    @property
    def last_token(self) -> int:
        return self.out[-1]

    def finished(self) -> bool:
        return len(self.out) >= self.gen


class _StepLogits:
    """Logits of an async-dispatched engine step, materialized to host on
    first row access — the token-emission boundary.  Until then the device
    computes while the scheduler's host-side bookkeeping runs; a step
    whose rows are never read (every lane mid-prefill) never blocks."""

    def __init__(self, eng, dev, clock):
        self._eng = eng
        self._dev = dev
        self._clock = clock
        self._host = None
        self.t_sync = None  # emission-boundary timestamp, None if unread

    def __getitem__(self, slot):
        if self._host is None:
            self._host = self._eng.sync_logits(self._dev)
            self.t_sync = self._clock()
        return self._host[slot]


class ContinuousScheduler:
    """Per-step admission / chunked-prefill / preemption loop.

    ``sample`` maps one logits row (np.ndarray [vocab]) to a token id;
    ``on_token(rid, token, step)`` streams tokens out as they are produced.

    Fault-tolerance knobs:

    * ``control``: a :class:`ServeControl`; cancelled rids are terminated
      (CANCELLED) at the next step.
    * ``max_tokens``: hard cap on any request's generation budget
      (``req.gen`` is clamped at :meth:`add`).
    * ``max_queue``: bound on *arrived* queued requests; overflow is
      load-shed newest-first (REJECTED, counted in ``self.shed``).
    * ``watermark_high`` / ``watermark_low``: page-pool occupancy
      fractions.  Crossing high pauses *new* admissions (resumes are
      unaffected) until occupancy falls below low — hysteresis so
      admission stops before ``_fit`` must thrash preemptions.
    * ``stall_limit``: steps with zero slots active and zero forward
      progress after which the blocking request is FAILED (livelock
      breaker: e.g. a spilled request whose pages can never be
      re-allocated because of external seizures/pins).
    * ``clock``: injectable wall-clock (``deadline_s``; chaos tests fake
      it).
    """

    def __init__(self, eng, *, chunk: int = 4,
                 sample: Optional[Callable[[np.ndarray], int]] = None,
                 on_token: Optional[Callable[[int, int, int], None]] = None,
                 control: Optional[ServeControl] = None,
                 max_tokens: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 watermark_high: float = 1.0,
                 watermark_low: float = 0.75,
                 stall_limit: int = 256,
                 clock: Callable[[], float] = time.monotonic,
                 telemetry: Optional[Telemetry] = None):
        self.eng = eng
        self.pool = eng.pool
        # One registry per engine: the engine's spans (prefill/decode/
        # kv_write) and the scheduler's lifecycle metrics must land in the
        # same exposition/trace.  An explicit ``telemetry`` overrides both.
        if telemetry is not None:
            self.tel = telemetry
            eng.tel = telemetry
        else:
            self.tel = getattr(eng, "tel", None) or Telemetry(clock=clock)
        self.chunk = max(1, int(chunk))
        self.sample = sample if sample is not None else (
            lambda row: int(np.argmax(row))
        )
        self.on_token = on_token
        self.control = control
        self.max_tokens = max_tokens
        self.max_queue = max_queue
        self.watermark_high = float(watermark_high)
        self.watermark_low = float(watermark_low)
        self.stall_limit = int(stall_limit)
        self.clock = clock
        self.queued: List[Request] = []
        self.preempted: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.finished: List[Request] = []  # every TERMINAL request, any state
        self.outputs: Dict[int, List[int]] = {}  # FINISHED requests only
        self.by_rid: Dict[int, Request] = {}
        # stats
        self.steps = 0
        self.decoded_tokens = 0
        self.prefill_tokens = 0
        self.prefix_hit_tokens = 0  # prompt tokens served from the cache
        self.occupied_slot_steps = 0
        self.preemptions = 0
        self.restores = 0  # preempted requests resumed into a slot
        self.shed = 0  # load-shed adds (bounded-queue overflow)
        self.admission_pauses = 0  # watermark-high crossings
        self.terminal_counts: Counter = Counter()
        # decode-only vs end-to-end throughput decomposition: wall time and
        # tokens of pure-decode engine steps, vs steps with a prefill chunk
        # in flight (telemetry clock; see stats["decode_tok_s"])
        self.decode_wall_s = 0.0
        self.decode_step_tokens = 0
        self.prefill_wall_s = 0.0
        self._paused = False  # watermark admission pause (hysteresis)
        self._last_progress = 0  # last step a token was committed / admitted

    # ------------------------------------------------------------------ #
    def add(self, req: Request) -> None:
        req.t_added = self.clock()
        if self.max_tokens is not None and req.gen > self.max_tokens:
            req.gen = self.max_tokens
        self.by_rid[req.rid] = req
        self.queued.append(req)

    def pending(self) -> bool:
        return bool(self.queued or self.preempted or self.active)

    def statuses(self) -> Dict[int, tuple]:
        """rid -> (state, finish_reason) for every request ever added.

        Thin compatibility view over :meth:`request_traces`."""
        return {rid: (r.state, r.finish_reason)
                for rid, r in self.by_rid.items()}

    def request_traces(self) -> List[dict]:
        """Structured per-request lifecycle records (rid order): the
        source of truth behind ``stats`` and the statuses() view."""
        out = []
        for rid in sorted(self.by_rid):
            r = self.by_rid[rid]
            out.append({
                "rid": rid,
                "state": r.state,
                "reason": r.finish_reason,
                "arrival_step": r.arrival,
                "admitted_step": r.admitted_step,
                "first_token_step": r.first_token_step,
                "finished_step": (r.finished_step
                                  if r.state in TERMINAL_STATES else -1),
                "queue_wait_steps": (r.admitted_step - r.arrival
                                     if r.admitted_step >= 0 else -1),
                "ttft_steps": (r.first_token_step - r.arrival
                               if r.first_token_step >= 0 else -1),
                "ttft_s": (r.t_first_token - r.t_added
                           if r.t_first_token >= 0 and r.t_added >= 0
                           else -1.0),
                "tokens_out": len(r.out),
                "prompt_tokens": r.plen,
                "prefill_charged_tokens": max(
                    0, r.n_prefilled - r.prefix_cached_tokens),
                "prefix_cached_tokens": r.prefix_cached_tokens,
                "preemptions": r.preemptions,
            })
        return out

    # ------------------------------------------------------------------ #
    # Terminal transitions: every path out of the live set goes through
    # _terminate, which releases whatever the request holds (slot pages,
    # spill pins) so pool invariants survive any individual failure.
    # ------------------------------------------------------------------ #
    def _finalize(self, req: Request, state: str, reason: str) -> None:
        req.state = state
        req.finish_reason = reason
        req.finished_step = self.steps
        self.finished.append(req)
        self.terminal_counts[state] += 1
        self.tel.counter("serve_requests_total", state=state).inc()
        if state == FINISHED:
            self.outputs[req.rid] = req.out

    def _drop_spill(self, req: Request) -> None:
        if req.spill is not None:
            self.pool.unpin(req.spill.get("pinned", ()))
            req.spill = None

    def _terminate(self, req: Request, state: str, reason: str = "") -> None:
        if req.state in TERMINAL_STATES:
            return
        if req.slot >= 0 and self.active.get(req.slot) is req:
            self.eng.release(req.slot)
            del self.active[req.slot]
            req.slot = -1
        elif req in self.preempted:
            self.preempted.remove(req)
            self._drop_spill(req)
        elif req in self.queued:
            self.queued.remove(req)
        self._finalize(req, state, reason)

    def cancel(self, rid: int) -> bool:
        """Cancel a live request: its slot/pages (or spill pins) are
        released and it terminates CANCELLED.  Returns False for unknown
        or already-terminal rids."""
        req = self.by_rid.get(rid)
        if req is None or req.state in TERMINAL_STATES:
            return False
        self._terminate(req, CANCELLED, "cancelled by client")
        return True

    # ------------------------------------------------------------------ #
    def _expire(self) -> None:
        """Per-request deadline/cancellation sweep (start of every step)."""
        now = self.clock()
        for req in [*self.active.values(), *self.preempted, *self.queued]:
            if self.control is not None and self.control.cancelled(req.rid):
                self._terminate(req, CANCELLED, "cancelled by client")
                continue
            if (req.deadline_steps is not None
                    and self.steps - req.arrival >= req.deadline_steps):
                self._terminate(
                    req, TIMED_OUT,
                    f"step budget {req.deadline_steps} exhausted "
                    f"(arrived step {req.arrival})",
                )
                continue
            if (req.deadline_s is not None and req.t_added >= 0
                    and now - req.t_added > req.deadline_s):
                self._terminate(
                    req, TIMED_OUT,
                    f"wall-clock budget {req.deadline_s}s exhausted",
                )
        if self.max_queue is not None:
            arrived = [r for r in self.queued if r.arrival <= self.steps]
            for req in arrived[self.max_queue:]:  # shed newest arrivals
                self.shed += 1
                self.tel.counter("serve_shed_total").inc()
                self._terminate(req, REJECTED,
                                f"queue full (load shed at {self.max_queue})")

    # ------------------------------------------------------------------ #
    def _admit(self) -> None:
        free = [s for s in range(self.eng.slots) if s not in self.active]

        # Preempted requests resume first (oldest arrival first) — strictly
        # in order, so a large old request is not starved by smaller young
        # ones slipping past it.
        while free and self.preempted:
            req = min(self.preempted, key=lambda r: (r.arrival, r.rid))
            n = req.spill["n_pages"]
            if (n > self.pool.num_pages - 1
                    or n + len(req.spill.get("pinned", ()))
                    > self.pool.max_pages_per_slot):
                # resume is impossible in ANY pool state: isolate the
                # failure to this request instead of wedging the engine
                self._terminate(
                    req, FAILED,
                    f"needs {n} pages to resume but the pool has only "
                    f"{self.pool.num_pages - 1}",
                )
                continue
            if not self.pool.can_alloc(n):
                break  # transient: wait for in-flight work to free pages
            slot = free.pop(0)
            self.eng.restore_slot(slot, req.spill)
            req.spill = None
            req.slot = slot
            req.state = DECODE if req.n_prefilled >= req.plen else PREFILL
            self.preempted.remove(req)
            self.active[slot] = req
            self.restores += 1
            self.tel.counter("serve_restores_total").inc()

        # Watermark backpressure with hysteresis: pause NEW admissions when
        # pool occupancy crosses the high mark, resume below the low mark.
        # Resumes above are exempt (spilled work must drain), and the pause
        # auto-lifts when nothing in flight could ever lower occupancy.
        usable = max(self.pool.num_pages - 1, 1)
        frac = self.pool.used_pages / usable
        if self._paused:
            if frac <= self.watermark_low or not (self.active
                                                  or self.preempted):
                self._paused = False
        elif frac >= self.watermark_high:
            self._paused = True
            self.admission_pauses += 1
            self.tel.counter("serve_admission_pauses_total").inc()
        if self._paused:
            return

        # New admissions: FIFO over arrived requests.  Held back while
        # anything is preempted (spilled work resumes first — admitting
        # fresh requests over it would thrash the pool).  A request only
        # needs its first UNCACHED prefill chunk's pages to join: its
        # longest cached prompt prefix is mapped read-only from the prefix
        # index, and only the tail (plus the copy-on-write clone when the
        # cache covers the whole prompt) is charged to the page budget.
        charged = 0  # first-chunk pages of this step's admissions, not
        while free and self.queued and not self.preempted:  # yet allocated
            req = self.queued[0]
            if req.arrival > self.steps:
                break
            # Admission control: a request whose worst case cannot fit an
            # EMPTY pool (or one slot's block table) can never complete —
            # reject it individually instead of crashing the run later.
            worst = self.pool.pages_needed(req.plen + max(req.gen, 1) - 1)
            if worst > min(self.pool.num_pages - 1,
                           self.pool.max_pages_per_slot):
                self.queued.pop(0)
                self._finalize(
                    req, REJECTED,
                    f"needs {worst} pages (prompt {req.plen} + gen "
                    f"{req.gen}) but the pool serves at most "
                    f"{min(self.pool.num_pages - 1, self.pool.max_pages_per_slot)} "
                    f"per request; raise --pages or lower --gen",
                )
                continue
            if req.prefix_hashes is None:
                req.prefix_hashes = self.eng.prompt_hashes(req.prompt)
            n_cached, n_mapped, extra, revived = self.eng.prefix_plan(
                req.prompt, hashes=req.prefix_hashes
            )
            tail = req.plen - n_cached
            # the admission bill: the tail's first chunk + the COW clone +
            # the matched pages this request will revive out of the LRU
            # (parked pages count as free_pages until share() re-refs
            # them, so they must be charged or the later allocation could
            # exhaust the pool mid-admission)
            first = extra + revived + max(
                0,
                self.pool.pages_needed(n_cached + min(self.chunk, tail))
                - n_mapped,
            )
            # free_pages is read live: mapping a cached prefix revives LRU
            # pages and draws the COW clone, both visible immediately
            if charged + first > self.pool.free_pages:
                break  # transient: wait for in-flight work to free pages
            slot = free.pop(0)
            req.slot = slot
            got = self.eng.admit_prefix(slot, req.prompt,
                                        hashes=req.prefix_hashes)
            req.n_prefilled = got
            self.prefix_hit_tokens += got
            req.prefix_cached_tokens = got
            self.tel.counter("serve_prefix_hit_tokens_total").inc(got)
            if req.admitted_step < 0:  # first admission only (not resumes)
                req.admitted_step = self.steps
                self.tel.histogram("serve_queue_wait_steps").observe(
                    self.steps - req.arrival)
            # the COW draw and the revivals are already reflected in the
            # live free_pages; keep charging only the unallocated tail
            charged += first - extra - revived
            req.state = PREFILL
            self.active[slot] = req
            self.queued.pop(0)
            self._last_progress = self.steps

    # ------------------------------------------------------------------ #
    def _plan(self) -> Dict[int, tuple]:
        """slot -> (tokens_to_feed, n_new) for every active slot."""
        plan: Dict[int, tuple] = {}
        for slot, req in self.active.items():
            if req.state == PREFILL:
                n = min(self.chunk, req.plen - req.n_prefilled)
                toks = req.prompt[req.n_prefilled:req.n_prefilled + n]
            else:
                n = 1
                toks = [req.last_token]
            plan[slot] = (list(map(int, toks)), n)
        return plan

    def _preempt_victim(self) -> int:
        """Spill the lowest-priority (youngest-arrival, rid tiebreak)
        active slot; returns the freed slot id."""
        victim = max(self.active.values(), key=lambda r: (r.arrival, r.rid))
        slot = victim.slot
        victim.spill = self.eng.preempt_slot(slot)
        victim.state = PREEMPTED
        victim.slot = -1
        victim.preemptions += 1
        self.preemptions += 1
        self.tel.counter("serve_preemptions_total").inc()
        del self.active[slot]
        self.preempted.append(victim)
        return slot

    def _fit(self, plan: Dict[int, tuple]) -> None:
        """Make the step's page demand fit the pool, preempting youngest
        slots when it runs dry, then allocate.

        Exhaustion with a single active slot no longer crashes the run:
        if that request structurally cannot take another step (it grew
        past the whole pool) it is FAILED individually; otherwise it is
        parked (spilled) and resumed once pages return — the pool may be
        transiently short because of external seizures (chaos) or spill
        pins."""
        while True:
            need = 0
            for slot, (_, n) in plan.items():
                req = self.active[slot]
                need += max(
                    0,
                    self.pool.pages_needed(req.length + n)
                    - len(self.pool.pages_of[slot]),
                )
            if need <= self.pool.free_pages:
                break
            if not self.active:
                return
            if len(self.active) == 1:
                slot, req = next(iter(self.active.items()))
                n = plan[slot][1]
                if (self.pool.pages_needed(req.length + n)
                        > self.pool.num_pages - 1):
                    plan.pop(slot, None)
                    self._terminate(
                        req, FAILED,
                        f"grew past the page pool "
                        f"({self.pool.pages_needed(req.length + n)} pages "
                        f"needed, {self.pool.num_pages - 1} total)",
                    )
                else:
                    plan.pop(self._preempt_victim(), None)
                return
            plan.pop(self._preempt_victim(), None)
        # one batched allocation pass for the whole step (single pool
        # version bump -> at most one block-table upload in the engine)
        tokens_needed = np.zeros((self.eng.slots,), np.int64)
        for slot, (_, n) in plan.items():
            tokens_needed[slot] = self.active[slot].length + n
        self.pool.ensure_capacity_batch(tokens_needed)

    # ------------------------------------------------------------------ #
    def _commit(self, plan: Dict[int, tuple], logits: np.ndarray) -> None:
        finished = []
        now = self.tel.clock()
        for slot, (_, n) in plan.items():
            req = self.active[slot]
            if req.state == PREFILL:
                req.n_prefilled += n
                self.prefill_tokens += n
                self.tel.counter("serve_prefill_tokens_total").inc(n)
                # publish newly completed prompt pages for later requests
                self.eng.note_prefilled(slot, req.n_prefilled)
                if req.n_prefilled < req.plen:
                    continue
                req.state = DECODE  # last prompt token's logits sample next
            else:
                self.decoded_tokens += 1
                self.tel.counter("serve_decoded_tokens_total").inc()
            tok = self.sample(logits[slot])
            if req.first_token_step < 0:
                req.first_token_step = self.steps
                req.t_first_token = now
                if req.t_added >= 0:
                    self.tel.histogram("serve_ttft_seconds").observe(
                        now - req.t_added)
            elif req.t_last_token >= 0:
                self.tel.histogram("serve_intertoken_seconds").observe(
                    now - req.t_last_token)
            req.t_last_token = now
            req.out.append(tok)
            if self.on_token is not None:
                self.on_token(req.rid, tok, self.steps)
            if req.finished():
                finished.append(slot)
        self._last_progress = self.steps
        for slot in finished:
            req = self.active.pop(slot)
            req.slot = -1
            self._finalize(req, FINISHED, "")
            self.eng.release(slot)

    # ------------------------------------------------------------------ #
    def _break_stall(self) -> None:
        """Livelock breaker: nothing active, something waiting, and no
        forward progress for ``stall_limit`` steps — FAIL the blocking
        request so the run terminates instead of spinning forever."""
        head_arrived = bool(self.queued
                            and self.queued[0].arrival <= self.steps)
        if (self.active or not (self.preempted or head_arrived)
                or self.steps - self._last_progress <= self.stall_limit):
            return
        if self.preempted:
            victim = min(self.preempted, key=lambda r: (r.arrival, r.rid))
        else:
            victim = self.queued[0]
        self._terminate(
            victim, FAILED,
            f"no scheduler progress for {self.stall_limit} steps "
            f"(pool free={self.pool.free_pages})",
        )
        self._last_progress = self.steps

    def step(self) -> None:
        """One scheduler step: expire/cancel, admit, fit (maybe preempt),
        dispatch the mixed model step asynchronously, overlap host
        bookkeeping with the device compute, sample/stream at the
        emission boundary, evict finished slots."""
        with self.tel.span("admit"):
            self._expire()
            self._admit()
        with self.tel.span("host"):
            plan = self._plan()
            self._fit(plan)
        if plan:
            # T is 1 on pure-decode steps and ``chunk`` whenever a prefill
            # is in flight — exactly two model traces for the whole run.
            pure_decode = all(n == 1 for _, n in plan.values())
            T = 1 if pure_decode else self.chunk
            B = self.eng.slots
            toks = np.zeros((B, T), np.int32)
            lengths = np.zeros((B,), np.int32)
            n_new = np.zeros((B,), np.int32)
            for slot, (tk, n) in plan.items():
                toks[slot, :n] = tk
                lengths[slot] = self.active[slot].length
                n_new[slot] = n
            t0 = self.tel.clock()
            # async dispatch: the jitted step returns a device future; the
            # commit below runs its host-side bookkeeping (prefill
            # accounting, prefix-page registration) while the device
            # computes, and blocks only when the first sampled row is
            # actually read.  A step that samples no token (every lane
            # mid-prefill) never blocks at all — the next step's
            # plan/fit/dispatch overlaps this one's compute.
            logits = _StepLogits(
                self.eng, self.eng.step_chunk(toks, lengths, n_new,
                                              sync=False),
                self.tel.clock,
            )
            with self.tel.span("host"):
                self._commit(plan, logits)
            # critical-path wall time: dispatch -> emission sync (or
            # dispatch only, for steps that never emitted)
            dt = (logits.t_sync if logits.t_sync is not None
                  else self.tel.clock()) - t0
            if pure_decode:
                self.decode_wall_s += dt
                self.decode_step_tokens += len(plan)
            else:
                self.prefill_wall_s += dt
            self.occupied_slot_steps += len(plan)
        with self.tel.span("host"):
            self.pool.observe_step()
            self.pool.publish_telemetry(self.tel)
            self.steps += 1
            self.tel.counter("serve_steps_total").inc()
            self._break_stall()
        if invariant_checks_enabled():
            self.pool.assert_invariants()

    def mean_latency_steps(self) -> float:
        """Mean arrival-to-completion latency of FINISHED requests, in
        scheduler steps (queueing + prefill + decode + preemption time)."""
        done = [r for r in self.finished if r.state == FINISHED]
        if not done:
            return 0.0
        return float(np.mean([r.finished_step - r.arrival + 1
                              for r in done]))

    def run(self) -> Dict[int, List[int]]:
        while self.pending():
            self.step()
        return self.outputs
