"""Zero-dependency serving telemetry: counters, gauges, histograms, spans.

Everything the serving stack measures flows through one ``Telemetry``
registry per engine:

- **Counters** are monotone event tallies (steps, decoded tokens,
  preemptions, faults).  They snapshot/restore through
  ``serving/snapshot.py`` so a crash-recovered run reports cumulative
  truth from its restore point.
- **Gauges** are point-in-time levels (pool free pages, utilization,
  autotune block timings), overwritten each observation.
- **Histograms** are fixed-bucket cumulative distributions (queue wait,
  TTFT, inter-token latency, per-phase step durations, snapshot
  save/restore times).  Bucket edges are declared once in
  ``METRIC_CATALOG`` so exposition and docs agree.
- **Spans** (``with tel.span("decode"):``) time a phase against the
  injectable monotonic clock, feed the ``serve_phase_seconds`` histogram
  (label ``phase=...``), and append a Chrome-trace ``"X"`` event so the
  whole run can be opened in Perfetto / ``chrome://tracing``.  With
  ``profile=True`` each span additionally opens a
  ``torch.profiler.record_function`` range so host phases line up with
  device traces captured by ``torch.profiler``.

The registry is always on: recording is a handful of dict/float ops per
event, and keeping it unconditional is what makes the bit-neutrality
gate trivial (telemetry never touches the numerics, only observes the
host side).  The ``--metrics-out`` / ``--trace-out`` CLI flags control
only *export*.

Two exporters:

- ``to_prometheus()`` — Prometheus text exposition (``# HELP``/``# TYPE``
  lines, ``_bucket{le=...}``/``_sum``/``_count`` histogram series).
- ``to_chrome_trace()`` — Chrome trace event JSON (``{"traceEvents":
  [...]}``, durations in microseconds) of every span and instant event.

Determinism: the clock is injected (``clock=time.monotonic`` by
default), so tests drive a fake clock and pin exact durations, bucket
placement, and exporter bytes.

This is the PyTorch port's copy of ``repro.serving.telemetry``; the only
change is the profiler range (``torch.profiler.record_function`` in place
of ``jax.profiler.TraceAnnotation``) and one more counter,
``serve_substeps_total``.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Telemetry",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricSpec",
    "METRIC_CATALOG",
    "PHASES",
    "default_registry",
    "record_autotune",
]

# The canonical engine-step phase decomposition.  Every serving step is
# covered by spans carrying exactly these names (plus auxiliary spans
# like "preempt"/"restore"/"snapshot_save" outside the hot loop):
#
#   admit    — request expiry/cancellation sweep + admission (prefix
#              match, page reservation, slot assignment)
#   prefill  — device steps that process >=1 prompt chunk (the mixed
#              prefill+decode step counts here: prefill dominates it)
#   decode   — pure decode device steps (every active slot advances one
#              token)
#   kv_write — host-side KV-cache writes outside the fused step: prefill
#              splice into pages/dense cache, and copy-on-write clones
#   host     — host bookkeeping: planning, capacity fitting, block-table
#              updates, commit/stream accounting
PHASES: Tuple[str, ...] = ("admit", "prefill", "decode", "kv_write", "host")

# Bucket edges (seconds) for host-phase durations: 50us .. 10s.
_PHASE_BUCKETS = (
    0.00005, 0.0002, 0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0,
)
_LATENCY_BUCKETS = (
    0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
_STEP_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """Declarative metric metadata: drives registration, exposition
    HELP/TYPE lines, and the generated table in docs/observability.md."""

    name: str
    kind: str  # "counter" | "gauge" | "histogram"
    help: str
    labels: Tuple[str, ...] = ()
    buckets: Tuple[float, ...] = ()


# One row per metric the serving stack emits.  scripts/gen_docs.py
# renders this into docs/observability.md (--check gates staleness), so
# adding a metric here without regenerating the docs fails CI.
METRIC_CATALOG: Tuple[MetricSpec, ...] = (
    # -- scheduler / request lifecycle -------------------------------
    MetricSpec("serve_steps_total", "counter",
               "Engine steps executed by the scheduler."),
    MetricSpec("serve_decoded_tokens_total", "counter",
               "Tokens sampled across all requests."),
    MetricSpec("serve_prefill_tokens_total", "counter",
               "Prompt tokens actually prefilled (charged; excludes "
               "prefix-cache hits)."),
    MetricSpec("serve_prefix_hit_tokens_total", "counter",
               "Prompt tokens served read-only from the prefix cache."),
    MetricSpec("serve_requests_total", "counter",
               "Requests reaching a terminal state, by state.",
               labels=("state",)),
    MetricSpec("serve_preemptions_total", "counter",
               "Slot preemptions (spill to host)."),
    MetricSpec("serve_restores_total", "counter",
               "Preempted requests restored into a slot."),
    MetricSpec("serve_shed_total", "counter",
               "Requests shed by the bounded admission queue."),
    MetricSpec("serve_admission_pauses_total", "counter",
               "Steps with admission paused by the pool watermark."),
    MetricSpec("serve_queue_wait_steps", "histogram",
               "Steps between arrival and slot admission.",
               buckets=_STEP_BUCKETS),
    MetricSpec("serve_ttft_seconds", "histogram",
               "Time from arrival to first sampled token.",
               buckets=_LATENCY_BUCKETS),
    MetricSpec("serve_intertoken_seconds", "histogram",
               "Gap between consecutive sampled tokens of one request.",
               buckets=_LATENCY_BUCKETS),
    MetricSpec("serve_phase_seconds", "histogram",
               "Engine step time decomposed by phase "
               "(admit/prefill/decode/kv_write/host/sync + auxiliary "
               "spans; mesh engines time the per-step cross-shard "
               "wait as 'collectives' instead of 'sync').",
               labels=("phase",), buckets=_PHASE_BUCKETS),
    MetricSpec("serve_mesh_info", "gauge",
               "Info gauge (constant 1) carrying the serving engine's "
               "device-mesh layout: mesh_shape like '1x2' ('1' single-"
               "device) and tp_size (model-axis size).",
               labels=("mesh_shape", "tp_size")),
    MetricSpec("serve_substeps_total", "counter",
               "Single-token model sub-steps executed (a mixed step of T "
               "tokens per slot runs T; each runs every layer once)."),
    MetricSpec("host_transfers_total", "counter",
               "Block-table host->device uploads (at most one per step: "
               "the engine caches the device copy and re-uploads only "
               "when the pool's version counter moves)."),
    # -- page pool ---------------------------------------------------
    MetricSpec("pool_pages", "gauge",
               "Total data pages in the pool (capacity, excludes the "
               "null page)."),
    MetricSpec("pool_free_pages", "gauge",
               "Free-list depth (allocatable pages)."),
    MetricSpec("pool_used_pages", "gauge",
               "Referenced pages (any refcount > 0, incl. pinned)."),
    MetricSpec("pool_cached_pages", "gauge",
               "LRU-parked prefix pages (evictable, refcount 0)."),
    MetricSpec("pool_seized_pages", "gauge",
               "Pages seized by fault injection (unavailable)."),
    MetricSpec("pool_utilization", "gauge",
               "used_pages / pages at last observation."),
    MetricSpec("pool_prefix_lookups_total", "counter",
               "Prefix-index lookups at admission."),
    MetricSpec("pool_prefix_hits_total", "counter",
               "Prefix-index lookups that matched >=1 chunk."),
    MetricSpec("pool_evictions_total", "counter",
               "LRU-parked pages evicted to satisfy allocation."),
    MetricSpec("pool_cow_copies_total", "counter",
               "Copy-on-write page clones."),
    MetricSpec("pool_spills_total", "counter",
               "Pages spilled to host by preemption."),
    MetricSpec("pool_restores_total", "counter",
               "Pages restored from host spill."),
    # -- chaos / fault runtime --------------------------------------
    MetricSpec("chaos_faults_total", "counter",
               "Faults injected by the chaos harness, by kind.",
               labels=("kind",)),
    MetricSpec("fault_restarts_total", "counter",
               "Engine rebuilds after a kill (crash recovery)."),
    MetricSpec("fault_watchdog_overruns_total", "counter",
               "Watchdog step-deadline overruns survived."),
    MetricSpec("snapshot_save_seconds", "histogram",
               "Serving snapshot save duration.",
               buckets=_LATENCY_BUCKETS),
    MetricSpec("snapshot_restore_seconds", "histogram",
               "Serving snapshot restore duration.",
               buckets=_LATENCY_BUCKETS),
    MetricSpec("snapshot_saves_total", "counter",
               "Serving snapshots written."),
    MetricSpec("snapshot_restores_total", "counter",
               "Serving snapshots restored."),
    # -- kernels -----------------------------------------------------
    MetricSpec("autotune_block_us", "gauge",
               "Measured (or assumed) best-candidate time per autotuned "
               "kernel site, microseconds.",
               labels=("kernel", "site", "config", "source")),
    # -- telemetry self-accounting ----------------------------------
    MetricSpec("trace_events_dropped_total", "counter",
               "Trace events dropped after the in-memory cap."),
)

_CATALOG_BY_NAME: Dict[str, MetricSpec] = {s.name: s for s in METRIC_CATALOG}

# Safety cap on the in-memory Chrome-trace buffer; beyond it spans still
# time (histograms keep counting) but events are dropped and tallied.
_MAX_EVENTS = 200_000


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Counter:
    """Monotone tally.  ``inc`` only; ``value`` is the running total."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    """Point-in-time level; ``set`` overwrites."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus ``le`` semantics:
    a sample lands in every bucket whose upper edge is >= the value)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]) -> None:
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"bucket edges must be sorted/unique: {buckets}")
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1


class Telemetry:
    """Metric registry + span tracer for one serving engine.

    ``clock`` must be monotonic (it is used exclusively for durations);
    tests inject a fake.  ``profile=True`` additionally wraps every span
    in ``torch.profiler.record_function`` so host phases show up in device
    traces.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 profile: bool = False) -> None:
        self.clock = clock
        self.profile = profile
        self._counters: Dict[Tuple[str, Tuple], Counter] = {}
        self._gauges: Dict[Tuple[str, Tuple], Gauge] = {}
        self._histograms: Dict[Tuple[str, Tuple], Histogram] = {}
        self._events: List[dict] = []
        self._t0 = self.clock()
        self._span_depth = 0

    # -- registry ----------------------------------------------------

    def counter(self, name: str, **labels: str) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None,
                  **labels: str) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            if buckets is None:
                spec = _CATALOG_BY_NAME.get(name)
                if spec is None or not spec.buckets:
                    raise ValueError(
                        f"histogram {name!r} is not in METRIC_CATALOG; "
                        "pass explicit buckets")
                buckets = spec.buckets
            h = self._histograms[key] = Histogram(buckets)
        return h

    # -- spans / trace events ----------------------------------------

    def _emit(self, ev: dict) -> None:
        if len(self._events) >= _MAX_EVENTS:
            self.counter("trace_events_dropped_total").inc()
            return
        self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[None]:
        """Time a phase: histogram observation + Chrome-trace "X" event.

        Spans nest (context-manager discipline gives proper containment,
        which is all the Chrome trace format needs for same-thread
        nesting).  ``**args`` become trace-event args (stringified).
        """
        prof = _profiler_annotation(name) if self.profile else None
        if prof is not None:
            prof.__enter__()
        t0 = self.clock()
        self._span_depth += 1
        try:
            yield
        finally:
            self._span_depth -= 1
            dur = self.clock() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
            self.histogram("serve_phase_seconds", phase=name).observe(dur)
            ev = {
                "name": name, "ph": "X", "pid": 1, "tid": 1,
                "ts": round((t0 - self._t0) * 1e6, 3),
                "dur": round(dur * 1e6, 3),
            }
            if args:
                ev["args"] = {k: str(v) for k, v in args.items()}
            self._emit(ev)

    def event(self, name: str, **args) -> None:
        """Instant (zero-duration) trace event, e.g. a fault injection."""
        ev = {
            "name": name, "ph": "i", "s": "g", "pid": 1, "tid": 1,
            "ts": round((self.clock() - self._t0) * 1e6, 3),
        }
        if args:
            ev["args"] = {k: str(v) for k, v in args.items()}
        self._emit(ev)

    # -- phase rollup ------------------------------------------------

    def phase_seconds(self) -> Dict[str, Dict[str, float]]:
        """Per-phase {sum_s, count, mean_s} rollup of every span name.

        Canonical phases (``PHASES``) are always present (zeroed when a
        run never entered them) so downstream consumers — BENCH_6, the
        stats dict — see a fixed schema.
        """
        out: Dict[str, Dict[str, float]] = {
            p: {"sum_s": 0.0, "count": 0, "mean_s": 0.0} for p in PHASES}
        for (name, labels), h in self._histograms.items():
            if name != "serve_phase_seconds":
                continue
            phase = dict(labels).get("phase", "")
            row = out.setdefault(
                phase, {"sum_s": 0.0, "count": 0, "mean_s": 0.0})
            row["sum_s"] += h.sum
            row["count"] += h.count
        for row in out.values():
            if row["count"]:
                row["mean_s"] = row["sum_s"] / row["count"]
        return out

    # -- exporters ---------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every metric."""
        lines: List[str] = []
        names = sorted(
            {n for (n, _) in self._counters}
            | {n for (n, _) in self._gauges}
            | {n for (n, _) in self._histograms})
        for name in names:
            spec = _CATALOG_BY_NAME.get(name)
            if spec is not None:
                lines.append(f"# HELP {name} {spec.help}")
                kind = spec.kind
            else:
                kind = ("histogram" if any(n == name for (n, _)
                                           in self._histograms)
                        else "counter" if any(n == name for (n, _)
                                              in self._counters)
                        else "gauge")
            lines.append(f"# TYPE {name} {kind}")
            for store in (self._counters, self._gauges):
                for (n, lk), m in sorted(store.items()):
                    if n != name:
                        continue
                    lines.append(f"{name}{_render_labels(lk)}"
                                 f" {_fmt_value(m.value)}")
            for (n, lk), h in sorted(self._histograms.items()):
                if n != name:
                    continue
                cum = 0
                for edge, c in zip(h.buckets, h.counts):
                    cum += c
                    lines.append(
                        f"{name}_bucket{_render_labels(lk, le=_fmt_value(edge))}"
                        f" {cum}")
                lines.append(
                    f"{name}_bucket{_render_labels(lk, le='+Inf')} {h.count}")
                lines.append(f"{name}_sum{_render_labels(lk)}"
                             f" {_fmt_value(h.sum)}")
                lines.append(f"{name}_count{_render_labels(lk)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_chrome_trace(self) -> dict:
        """Chrome trace event format: load in Perfetto / chrome://tracing."""
        return {
            "traceEvents": list(self._events),
            "displayTimeUnit": "ms",
            "otherData": {"clock": "monotonic", "ts_unit": "us"},
        }

    def write_prometheus(self, path: str) -> None:
        _atomic_write(path, self.to_prometheus())

    def write_chrome_trace(self, path: str) -> None:
        _atomic_write(path, json.dumps(self.to_chrome_trace(), indent=1))

    # -- snapshot / restore ------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable cumulative state (counters + histograms).

        Gauges (point-in-time) and trace events (host-process-local) are
        deliberately not carried: after a crash-restore the gauges are
        republished on the next step and the trace restarts.
        """
        return {
            "counters": [
                {"name": n, "labels": dict(lk), "value": c.value}
                for (n, lk), c in sorted(self._counters.items())],
            "histograms": [
                {"name": n, "labels": dict(lk),
                 "buckets": list(h.buckets), "counts": list(h.counts),
                 "sum": h.sum, "count": h.count}
                for (n, lk), h in sorted(self._histograms.items())],
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore cumulative counters/histograms (replacing any current
        values for the same series; unrelated series are left alone)."""
        for row in state.get("counters", ()):
            self.counter(row["name"], **row["labels"]).value = float(
                row["value"])
        for row in state.get("histograms", ()):
            h = self.histogram(row["name"], buckets=row["buckets"],
                               **row["labels"])
            if list(h.buckets) != [float(b) for b in row["buckets"]]:
                # Bucket layout changed across versions: refuse to merge
                # mismatched edges, keep cumulative sum/count truthful.
                h = self._histograms[
                    (row["name"], _label_key(row["labels"]))
                ] = Histogram(row["buckets"])
            h.counts = [int(c) for c in row["counts"]]
            h.sum = float(row["sum"])
            h.count = int(row["count"])

    # -- introspection (tests, stats compatibility view) -------------

    def counter_value(self, name: str, **labels: str) -> float:
        c = self._counters.get((name, _label_key(labels)))
        return c.value if c is not None else 0.0

    def gauge_value(self, name: str, **labels: str) -> float:
        g = self._gauges.get((name, _label_key(labels)))
        return g.value if g is not None else 0.0

    def counters_by_label(self, name: str, label: str) -> Dict[str, float]:
        """{label value: counter value} across one family, e.g.
        counters_by_label("serve_requests_total", "state")."""
        out: Dict[str, float] = {}
        for (n, lk), c in self._counters.items():
            if n == name:
                out[dict(lk).get(label, "")] = c.value
        return out

    @property
    def events(self) -> List[dict]:
        return self._events


def _render_labels(label_key: Tuple[Tuple[str, str], ...],
                   le: Optional[str] = None) -> str:
    items = [(k, v) for k, v in label_key]
    if le is not None:
        items.append(("le", le))
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items)
    return "{" + body + "}"


def _atomic_write(path: str, text: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _profiler_annotation(name: str):
    """A ``torch.profiler.record_function`` range for a span."""
    from torch.profiler import record_function

    return record_function(name)


# -- process-global registry ----------------------------------------
#
# Engine-independent instrumentation (the kernel autotuner, once ported)
# records into one shared process registry.  The serve CLI appends its
# exposition to the per-engine dump so those land in the same file.

_DEFAULT: Optional[Telemetry] = None


def default_registry() -> Telemetry:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Telemetry()
    return _DEFAULT


def record_autotune(kernel: str, site: str, config: str, best_us: float,
                    source: str) -> None:
    """Publish one autotune decision (the reference's kernels/autotune.py
    calls this via a lazy import; the port's autotuner is still to come)."""
    default_registry().gauge(
        "autotune_block_us", kernel=kernel, site=site,
        config=config, source=source).set(best_us)
