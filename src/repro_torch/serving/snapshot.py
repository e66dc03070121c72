"""Crash-recoverable serving state: snapshot and restore of the paged
Engine under the continuous scheduler.  Port of ``repro.serving.snapshot``
with the port's own on-disk layout (the reference cannot read it).

A snapshot holds everything the engine needs to resume mid-stream after a
hard kill:

  * the device cache, the dict ``{kp, vp, ks, vs}`` stacked over layers
    (``Model.make_paged_cache``: uint8 codes and float32 scales on FP8
    pages, ``cfg.pdtype`` rows on float pages), and each PREEMPTED
    request's spill tensors (``Engine.preempt_slot``'s host copies), as
    leaves of :mod:`repro_torch.checkpoint.store` under the keys
    ``cache/<name>`` and ``spills/<rid>/<name>``, bf16 bit for bit, with
    the store's atomic ``tmp-N`` -> ``step-N`` rename;
  * the host allocator (:meth:`PagePool.state_dict`: free list,
    refcounts, block tables, prefix index, LRU order, pins);
  * the engine's host state: its step counter (the bucketed splice's
    stream fold) and each slot's prompt hashes and registration cursor;
  * the scheduler's counters and request sets (active, preempted, queued,
    terminal) with every request's prompt, tokens, prefill progress and
    deadlines; wall-clock anchors are saved as time elapsed and
    re-anchored on load, so a restart does not reset a budget;
  * the sampler's numpy Generator state (``temperature > 0``);
  * the telemetry registry's counters and histograms.

Page codes are a pure function of page content (every KV write is keyed
by its position, never by the step or the batch), so an engine whose
codes, scales, pool and hashes are restored exactly draws, from then on,
the rounding bits an uninterrupted run would have drawn: survivors'
tokens are bitwise equal across a kill.
"""
from __future__ import annotations

import pathlib
from collections import Counter
from typing import Optional

import numpy as np

from ..checkpoint import store
from .scheduler import FINISHED, TERMINAL_STATES, ContinuousScheduler, Request

__all__ = ["save_snapshot", "load_snapshot"]

# Request fields carried verbatim; the clock anchors are saved as the time
# elapsed since them (None: never set) and re-anchored on load
_REQ_FIELDS = ("rid", "gen", "arrival", "state", "n_prefilled", "slot",
               "prefix_hashes", "preemptions", "finished_step",
               "deadline_steps", "deadline_s", "finish_reason",
               "admitted_step", "first_token_step", "prefix_cached_tokens")
_REQ_CLOCKS = ("t_added", "t_first_token", "t_last_token")
# the scheduler's cumulative counters and admission state
_SCHED_FIELDS = ("steps", "decoded_tokens", "prefill_tokens",
                 "prefix_hit_tokens", "occupied_slot_steps", "preemptions",
                 "restores", "shed", "admission_pauses", "decode_wall_s",
                 "decode_step_tokens", "prefill_wall_s", "_paused",
                 "_last_progress")
_SETS = ("finished", "active", "preempted", "queued")


def _req_record(req: Request, now: float) -> dict:
    rec = {f: getattr(req, f) for f in _REQ_FIELDS}
    rec["prompt"] = np.asarray(req.prompt).tolist()
    rec["out"] = [int(t) for t in req.out]
    rec["elapsed"] = {f: (now - getattr(req, f)) if getattr(req, f) >= 0
                      else None for f in _REQ_CLOCKS}
    if req.spill is not None:
        rec["spill"] = {
            "n_pages": int(req.spill["n_pages"]),
            "pinned": [[int(i), int(p)] for i, p in req.spill["pinned"]],
            "hashes": req.spill["hashes"],
            "registered": int(req.spill["registered"]),
        }
    return rec


def _rebuild_request(rec: dict, now: float, spill_state) -> Request:
    req = Request(prompt=np.asarray(rec["prompt"], np.int64),
                  out=list(rec["out"]), **{f: rec[f] for f in _REQ_FIELDS})
    for f, elapsed in rec["elapsed"].items():
        setattr(req, f, -1.0 if elapsed is None else now - elapsed)
    if "spill" in rec:
        meta = rec["spill"]
        req.spill = {"n_pages": meta["n_pages"],
                     "pinned": [tuple(p) for p in meta["pinned"]],
                     "state": spill_state[str(req.rid)],
                     "hashes": meta["hashes"],
                     "registered": meta["registered"]}
    return req


def save_snapshot(ckpt_dir, eng, sched: ContinuousScheduler,
                  sampler_rng: Optional[np.random.Generator] = None) -> None:
    """Write one atomic serving snapshot at ``sched.steps`` and wait until
    it is on disk (a kill right after must find it)."""
    if eng.pool is None:
        raise ValueError("serving snapshots cover the paged cache only")
    now = sched.clock()
    arrays = {"cache": eng.cache}
    spills = {str(r.rid): r.spill["state"] for r in sched.preempted}
    if spills:
        arrays["spills"] = spills
    sets = {"finished": sched.finished,
            "active": list(sched.active.values()),
            "preempted": sched.preempted, "queued": sched.queued}
    data_state = {
        "kind": "serving",
        "engine": {
            "step": eng._step,
            "slot_hash": {str(s): h for s, h in eng._slot_hash.items()},
            "slot_registered": {str(s): int(n) for s, n
                                in eng._slot_registered.items()},
        },
        "pool": eng.pool.state_dict(),
        "scheduler": {
            **{f: getattr(sched, f) for f in _SCHED_FIELDS},
            "terminal_counts": dict(sched.terminal_counts),
            **{name: [_req_record(r, now) for r in reqs]
               for name, reqs in sets.items()},
        },
        "sampler_rng": (None if sampler_rng is None
                        else sampler_rng.bit_generator.state),
        "telemetry": sched.tel.state_dict(),
    }
    store.save(ckpt_dir, arrays, step=sched.steps,
               data_state=data_state).result()


def _check_leaf(key: str, t, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(
            f"{key}: snapshot {tuple(t.shape)} {t.dtype} != engine "
            f"{tuple(shape)} {dtype} (the engine must be built with the "
            "snapshot's geometry and policy)")


def load_snapshot(ckpt_dir, eng, sched: ContinuousScheduler,
                  sampler_rng: Optional[np.random.Generator] = None,
                  step: Optional[int] = None) -> int:
    """Restore a snapshot (the latest, or ``step``) into a freshly built
    engine and scheduler of the killed ones' geometry.  Every cache leaf
    is copied into the engine's own tensors on ``eng.device`` (shape and
    dtype checked); spill tensors stay on the host, as
    ``Engine.preempt_slot`` keeps them.  Returns the restored step."""
    flat, manifest = store.restore_raw(pathlib.Path(ckpt_dir), step=step)
    data = manifest["data_state"]
    if data.get("kind") != "serving":
        raise ValueError(f"{ckpt_dir} holds a non-serving checkpoint")
    now = sched.clock()

    for name, like in eng.cache.items():
        key = store.path_key(("cache", name))
        _check_leaf(key, flat[key], like.shape, like.dtype)
        like.copy_(flat[key])
    spill_state: dict = {}
    for key, t in flat.items():
        part, *rest = key.split("/")
        if part == "spills":
            rid, name = rest
            like = eng.cache[name]
            _check_leaf(key, t, (like.shape[0], t.shape[1], *like.shape[2:]),
                        like.dtype)
            spill_state.setdefault(rid, {})[name] = t

    eng.pool.load_state_dict(data["pool"])
    eng._step = data["engine"]["step"]
    eng._slot_hash = {int(s): h
                      for s, h in data["engine"]["slot_hash"].items()}
    eng._slot_registered = {int(s): n for s, n
                            in data["engine"]["slot_registered"].items()}

    st = data["scheduler"]
    for f in _SCHED_FIELDS:
        setattr(sched, f, st[f])
    sched.terminal_counts = Counter(st["terminal_counts"])
    sched.active, sched.outputs, sched.by_rid = {}, {}, {}
    for name in _SETS:
        reqs = [_rebuild_request(rec, now, spill_state) for rec in st[name]]
        sched.by_rid.update((r.rid, r) for r in reqs)
        if name == "active":
            sched.active = {r.slot: r for r in reqs}
        else:
            setattr(sched, name, reqs)
    for req in sched.finished:
        if req.state not in TERMINAL_STATES:
            raise ValueError(f"request {req.rid}: {req.state} among the "
                             "terminal requests")
        if req.state == FINISHED:
            sched.outputs[req.rid] = req.out

    if sampler_rng is not None and data["sampler_rng"] is not None:
        sampler_rng.bit_generator.state = data["sampler_rng"]
    sched.tel.load_state_dict(data["telemetry"])
    return manifest["step"]
