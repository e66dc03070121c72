"""Paged KV-cache pool: host allocator plus the device-side write helpers.

Port of ``repro.serving.page_pool``.  Layout per attention layer (the
model stacks all layers on a leading axis):

  k_pages / v_pages : [num_pages, page_size, KV, hd]   uint8 FP8 codes
  k_scale / v_scale : [num_pages]                      float32 page scales

``PagePool`` is the host-side allocator: free list, per-page reference
counts, per-slot block tables (page ids in logical order), the prefix-cache
index (chained token-chunk hash -> page id, with an LRU of the registered
pages no slot references) and a version counter that moves on every
block-table change, so the engine uploads the tables at most once per
mutating step.  Page 0 is the reserved null page: unowned block-table
entries point at it and masked write lanes are redirected into it, where
they rewrite the row they hit with its own codes
(:func:`scatter_token_rows`): the null page keeps its initial zero codes
and unit scale, so what a masked lane reads there is the same in the fused
and unfused decode and on every run.

Every non-null page is in exactly one of five states: on the free list,
referenced by one or more slots (``ref[pid]`` block-table references),
parked in the prefix-cache LRU (registered content, ``ref == 0``, evicted
oldest first when the free list runs dry), pinned by a preemption spill
record, or seized by the chaos harness (:meth:`PagePool.seize`, a
simulated external memory squeeze).  A slot writes only into a page it
owns exclusively (``ref == 1``, unregistered, unpinned); full prompt pages
are registered and then mapped read-only into other slots
(:meth:`PagePool.share`), and a write into a shared page goes through
:meth:`PagePool.cow_page`.  Preemption spills a
slot's unregistered pages (the engine copies their contents to the host
first) and pins its registered ones in place; a restore takes fresh ids
for the former and re-references the latter.  :meth:`PagePool.state_dict`
and :meth:`PagePool.load_state_dict` carry the allocator through a
serving snapshot (``serving/snapshot.py``).

Per-page scales are powers of two chosen from the page's first write
(:func:`pow2_page_scale`, integer bit arithmetic) or, for a page the
bucketed scheduler's batched prefill splices in whole
(:func:`write_prefill_pages`), from the whole page's absmax; every float -> code
KV write rounds stochastically with noise addressed by (layer, write
position) — drawn by the caller with the threefry twin, so the codes equal
the reference's bit for bit, and a cached page holds exactly the codes a
request would have written itself.  Device helpers update the page and
scale tensors in place (``index_put_``) where the reference returns new
arrays.
"""
from __future__ import annotations

import os
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.carry_ins import supports_stochastic
from ..core.formats import FORMATS
from ..core.lns import lns_op
from ..core.prng import randint
from ..core.quant import encode, f32_bits, f32_from_bits

__all__ = [
    "PagePool",
    "invariant_checks_enabled",
    "pow2_page_scale",
    "kv_noise",
    "encode_kv",
    "token_row_codes",
    "scatter_token_rows",
    "write_token_page",
]


def invariant_checks_enabled() -> bool:
    """True when ``REPRO_CHECK_INVARIANTS=1``: the scheduler then runs
    :meth:`PagePool.assert_invariants` after every step."""
    return os.environ.get("REPRO_CHECK_INVARIANTS") == "1"


# --------------------------------------------------------------------------- #
# Host-side allocator
# --------------------------------------------------------------------------- #
class PagePool:
    """Free-list page allocator + refcounts + block tables + prefix index.

    The pool size is independent of the slot count.  Admission control is
    the caller's job via :meth:`can_alloc`; ``free_pages`` counts the pages
    allocatable right now, the free list plus the evictable LRU.
    """

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 max_pages_per_slot: int):
        if num_pages < 2:
            raise ValueError("need at least the null page + one real page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.slots = slots
        self.max_pages_per_slot = max_pages_per_slot
        # page 0 is the reserved null page; high ids are handed out first
        self._free: List[int] = list(range(1, num_pages))
        self.ref = np.zeros((num_pages,), np.int32)
        self.block_tables = np.zeros((slots, max_pages_per_slot), np.int32)
        self.pages_of: List[List[int]] = [[] for _ in range(slots)]
        # bumped on every block-table mutation (device-copy invalidation)
        self.version = 0
        # prefix cache: chunk hash -> page id, LRU over unreferenced entries
        self._index: Dict[str, int] = {}
        self._page_key: Dict[int, str] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._pinned: Dict[int, int] = {}  # page id -> spill-record pins
        self._seized: set = set()  # chaos-harness transient seizures
        self.peak_used_pages = 0
        self.used_page_steps = 0
        self.observed_steps = 0
        self.spills = 0
        self.restores = 0
        self.prefix_lookups = 0  # full-page chunks probed at admission
        self.prefix_hits = 0     # ... of which were index hits
        self.evictions = 0
        self.cow_copies = 0

    # ------------------------------------------------------------------ #
    @property
    def free_pages(self) -> int:
        """Pages allocatable right now (free list + evictable LRU)."""
        return len(self._free) + len(self._lru)

    @property
    def used_pages(self) -> int:
        """Pages referenced by a slot or pinned by a spill record."""
        return (self.num_pages - 1) - self.free_pages

    @property
    def cached_pages(self) -> int:
        """Pages registered in the prefix index (referenced or parked)."""
        return len(self._index)

    def observe_step(self) -> None:
        """Record one scheduler step for the occupancy watermark stats."""
        self.used_page_steps += self.used_pages
        self.observed_steps += 1

    def mean_utilization(self) -> float:
        if not self.observed_steps or self.num_pages <= 1:
            return 0.0
        return self.used_page_steps / (self.observed_steps * (self.num_pages - 1))

    def prefix_stats(self) -> Dict[str, float]:
        return dict(
            lookups=self.prefix_lookups, hits=self.prefix_hits,
            hit_rate=self.prefix_hits / max(self.prefix_lookups, 1),
            cached_pages=self.cached_pages, evictions=self.evictions,
            cow_copies=self.cow_copies,
        )

    def publish_telemetry(self, tel) -> None:
        """Publish the pool occupancy gauges and mirror the pool's
        cumulative event counters into a Telemetry registry."""
        usable = max(self.num_pages - 1, 1)
        tel.gauge("pool_pages").set(self.num_pages - 1)
        tel.gauge("pool_free_pages").set(len(self._free))
        tel.gauge("pool_used_pages").set(self.used_pages)
        tel.gauge("pool_cached_pages").set(len(self._lru))
        tel.gauge("pool_seized_pages").set(len(self._seized))
        tel.gauge("pool_utilization").set(self.used_pages / usable)
        for name, v in (("pool_prefix_lookups_total", self.prefix_lookups),
                        ("pool_prefix_hits_total", self.prefix_hits),
                        ("pool_evictions_total", self.evictions),
                        ("pool_cow_copies_total", self.cow_copies),
                        ("pool_spills_total", self.spills),
                        ("pool_restores_total", self.restores)):
            tel.counter(name).value = float(v)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_alloc(self, n: int) -> bool:
        return n <= self.free_pages

    # ------------------------------------------------------------------ #
    def _unregister(self, pid: int) -> None:
        key = self._page_key.pop(pid)
        del self._index[key]

    def _take_free(self, n: int) -> List[int]:
        """Pop ``n`` page ids, evicting the LRU's oldest registered pages
        when the free list runs dry.  Referenced and pinned pages are never
        in the LRU, so they cannot be evicted from under their readers."""
        if n > self.free_pages:
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {self.free_pages}"
            )
        while len(self._free) < n:
            pid, _ = self._lru.popitem(last=False)  # least recently parked
            self._unregister(pid)
            self.evictions += 1
            self._free.append(pid)
        return [self._free.pop() for _ in range(n)]

    def _check_room(self, slot: int, n: int) -> None:
        if n > self.max_pages_per_slot:
            raise RuntimeError(
                f"slot {slot} exceeds max_pages_per_slot="
                f"{self.max_pages_per_slot}"
            )

    def alloc(self, slot: int, n: int = 1) -> List[int]:
        """Allocate ``n`` exclusive pages to ``slot``, in logical order."""
        owned = self.pages_of[slot]
        self._check_room(slot, len(owned) + n)
        ids = self._take_free(n)
        for pid in ids:
            self.ref[pid] = 1
        start = len(owned)
        owned.extend(ids)
        self.block_tables[slot, start:start + len(ids)] = ids
        self.version += 1
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        return ids

    def share(self, slot: int, ids: Sequence[int]) -> None:
        """Map registered pages read-only into ``slot`` (appended in
        logical order): their refcounts rise, and a page parked in the LRU
        is revived out of it.  A write into a shared page goes through
        :meth:`cow_page`."""
        owned = self.pages_of[slot]
        self._check_room(slot, len(owned) + len(ids))
        for pid in ids:
            if self.ref[pid] == 0 and self._pinned.get(pid, 0) == 0:
                del self._lru[pid]  # revive from the evictable set
            self.ref[pid] += 1
        start = len(owned)
        owned.extend(ids)
        self.block_tables[slot, start:start + len(ids)] = ids
        self.version += 1
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)

    def _release_page(self, pid: int) -> None:
        self.ref[pid] -= 1
        if self.ref[pid] < 0:
            raise RuntimeError(f"refcount underflow on page {pid}")
        if self.ref[pid] == 0 and self._pinned.get(pid, 0) == 0:
            if pid in self._page_key:  # registered: park, newest at the back
                self._lru[pid] = None
            else:
                self._free.append(pid)

    def free_slot(self, slot: int) -> None:
        """Drop ``slot``'s reference on every page it maps: unregistered
        pages whose last reference this was return to the free list,
        registered ones park in the LRU (still servable as prefix hits,
        evictable)."""
        for pid in self.pages_of[slot]:
            self._release_page(pid)
        self.pages_of[slot] = []
        self.block_tables[slot] = 0
        self.version += 1

    def cow_page(self, slot: int, logical: int) -> Tuple[int, int]:
        """Copy-on-write: replace the shared page at logical index
        ``logical`` of ``slot`` with a fresh exclusive page.  Returns
        ``(old_id, new_id)``; the caller copies the page contents old ->
        new on the device before writing into it
        (``Engine._copy_page``)."""
        old = self.pages_of[slot][logical]
        new = self._take_free(1)[0]
        self.ref[new] = 1
        self.pages_of[slot][logical] = new
        self.block_tables[slot, logical] = new
        self.version += 1
        self._release_page(old)
        self.cow_copies += 1
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        return old, new

    def ensure_capacity(self, slot: int, n_tokens: int) -> None:
        """Allocate pages so ``slot`` can hold ``n_tokens`` tokens."""
        need = self.pages_needed(n_tokens) - len(self.pages_of[slot])
        if need > 0:
            self.alloc(slot, need)

    def ensure_capacity_batch(self, n_tokens) -> None:
        """Grow every slot to hold ``n_tokens[slot]`` tokens in one pass
        (entry 0 or negative leaves a slot alone): one exhaustion check,
        one eviction sweep and one version bump, so at most one block-table
        upload per step.  Makes exactly the per-slot
        :meth:`ensure_capacity` loop's choices."""
        n_tokens = np.asarray(n_tokens, np.int64)
        if n_tokens.shape != (self.slots,):
            raise ValueError(
                f"expected one token count per slot, got {n_tokens.shape}")
        owned = np.fromiter((len(p) for p in self.pages_of), np.int64,
                            count=self.slots)
        need = -(-n_tokens // self.page_size) - owned
        need = np.where(n_tokens > 0, np.maximum(need, 0), 0)
        total = int(need.sum())
        if total == 0:
            return
        over = np.nonzero(owned + need > self.max_pages_per_slot)[0]
        if over.size:
            self._check_room(int(over[0]), self.max_pages_per_slot + 1)
        ids = self._take_free(total)
        self.ref[ids] = 1
        off = 0
        for slot in np.nonzero(need)[0]:
            n = int(need[slot])
            chunk = ids[off:off + n]
            start = int(owned[slot])
            self.pages_of[slot].extend(chunk)
            self.block_tables[slot, start:start + n] = chunk
            off += n
        self.version += 1
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)

    # ------------------------------------------------------------------ #
    # Prefix index
    # ------------------------------------------------------------------ #
    def match_prefix(self, keys: Sequence[str], *,
                     peek: bool = False) -> List[int]:
        """Longest cached prefix of ``keys`` (chained full-page hashes):
        page ids in logical order, up to the first index miss.  ``peek``
        skips the accounting (planning passes); otherwise
        ``prefix_lookups`` counts the probes made (the hits and the one
        miss that ended the walk) and ``prefix_hits`` the hits."""
        ids: List[int] = []
        for k in keys:
            pid = self._index.get(k)
            if pid is None:
                break
            ids.append(pid)
        if not peek:
            self.prefix_lookups += len(ids) + (1 if len(ids) < len(keys) else 0)
            self.prefix_hits += len(ids)
        return ids

    def register_prefix(self, key: str, pid: int) -> bool:
        """Publish ``pid`` (a fully written prompt page) under ``key``.
        The first writer wins: a key already registered, or a page already
        registered under another key, is left alone (returns False)."""
        if key in self._index or pid in self._page_key:
            return False
        self._index[key] = pid
        self._page_key[pid] = key
        return True

    # ------------------------------------------------------------------ #
    # Preemption
    # ------------------------------------------------------------------ #
    def spill_plan(self, slot: int) -> Tuple[List[int], List[Tuple[int, int]]]:
        """What :meth:`spill_slot` will do: ``(spilled, pinned)``, the
        slot's unregistered page ids in logical order (the caller copies
        their contents out) and the ``(logical_idx, page_id)`` pairs of its
        registered prefix pages, which stay resident under a pin (never
        copied, never freed)."""
        spilled, pinned = [], []
        for i, pid in enumerate(self.pages_of[slot]):
            if pid in self._page_key:
                pinned.append((i, pid))
            else:
                spilled.append(pid)
        return spilled, pinned

    def spill_slot(self, slot: int) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Preemption: release ``slot``'s pages after the caller copied the
        spilled ones out; returns :meth:`spill_plan`'s pair.  The slot's
        reference on each registered page becomes a pin that keeps it
        resident and unevictable until :meth:`restore_slot` or
        :meth:`unpin`, so a shared prompt survives its readers' preemption.

        The freed ids are prepended to the free list (:meth:`_take_free`
        pops from the end), so an immediate re-allocation prefers other
        pages: a restore through the same physical pages would hide
        block-table faults in tests."""
        spilled, pinned = self.spill_plan(slot)
        for _, pid in pinned:
            self._pinned[pid] = self._pinned.get(pid, 0) + 1
            self.ref[pid] -= 1  # the slot's reference becomes the pin
        for pid in spilled:
            self.ref[pid] -= 1
            if self.ref[pid] != 0:
                raise RuntimeError(f"spilled page {pid} still referenced")
        self.pages_of[slot] = []
        self.block_tables[slot] = 0
        self.version += 1
        spilled_set = set(spilled)
        self._free = spilled + [i for i in self._free if i not in spilled_set]
        self.spills += 1
        return spilled, pinned

    def _check_pins(self, pinned: Sequence[Tuple[int, int]]) -> None:
        held = Counter(pid for _, pid in pinned)
        for pid, n in held.items():
            if self._pinned.get(pid, 0) < n:
                raise RuntimeError(
                    f"page {pid} holds {self._pinned.get(pid, 0)} spill "
                    f"pins, the record releases {n}")

    def restore_slot(self, slot: int, n: int,
                     pinned: Sequence[Tuple[int, int]] = ()) -> List[int]:
        """Re-admit a preempted request into ``slot``: allocate ``n`` fresh
        pages for its spilled contents (ids may differ from the spilled
        ones; the caller scatters the saved bytes back) and re-reference
        the pinned prefix pages at their recorded logical indices.  Returns
        the fresh ids in the logical order of the spilled positions."""
        if self.pages_of[slot]:
            raise RuntimeError(f"restore target slot {slot} is not empty")
        total = n + len(pinned)
        self._check_room(slot, total)
        self._check_pins(pinned)
        fresh = self._take_free(n)
        for pid in fresh:
            self.ref[pid] = 1
        table: List[Optional[int]] = [None] * total
        for i, pid in pinned:
            table[i] = pid
            self.ref[pid] += 1  # the pin's ownership returns to the slot
            self._pinned[pid] -= 1
            if self._pinned[pid] == 0:
                del self._pinned[pid]
        it = iter(fresh)
        for i in range(total):
            if table[i] is None:
                table[i] = next(it)
        self.pages_of[slot] = list(table)
        self.block_tables[slot, :total] = table
        self.version += 1
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        self.restores += 1
        return fresh

    def unpin(self, pinned: Sequence[Tuple[int, int]]) -> None:
        """Drop a discarded spill record's pins (the preempted request
        ended and will never restore).  A page whose last pin drops with no
        reference parks in the LRU: registered content, still servable as a
        hit and evictable."""
        self._check_pins(pinned)
        for _, pid in pinned:
            pins = self._pinned[pid]
            if pins > 1:
                self._pinned[pid] = pins - 1
                continue
            del self._pinned[pid]
            if self.ref[pid] == 0:
                self._lru[pid] = None

    # ------------------------------------------------------------------ #
    # Chaos seizures and snapshot state
    # ------------------------------------------------------------------ #
    # the cumulative counters a snapshot carries
    _COUNTERS = ("peak_used_pages", "used_page_steps", "observed_steps",
                 "spills", "restores", "prefix_lookups", "prefix_hits",
                 "evictions", "cow_copies")

    def seize(self, n: int) -> List[int]:
        """Chaos hook: take up to ``n`` pages off the free list (never out
        of the prefix-cache LRU: a simulated memory squeeze must not evict
        cached content), unallocatable until :meth:`release_seized`.
        Returns the seized ids."""
        ids = [self._free.pop() for _ in range(min(n, len(self._free)))]
        self._seized.update(ids)
        return ids

    def release_seized(self, ids: Sequence[int]) -> None:
        """Return chaos-seized pages to the free list."""
        for pid in ids:
            if pid not in self._seized:
                raise RuntimeError(f"page {pid} was not seized")
            self._seized.discard(pid)
            self._free.append(pid)

    def state_dict(self) -> dict:
        """JSON-serialisable allocator state for a serving snapshot.
        Seizures are transient faults, not engine state: seized pages are
        recorded as free, so a restored pool starts with them released."""
        return {
            "geometry": [self.num_pages, self.page_size, self.slots,
                         self.max_pages_per_slot],
            "free": [int(p) for p in self._free] + sorted(
                int(p) for p in self._seized),
            "ref": [int(r) for r in self.ref],
            "pages_of": [[int(p) for p in lst] for lst in self.pages_of],
            "index": {k: int(pid) for k, pid in self._index.items()},
            "lru": [int(p) for p in self._lru],
            "pinned": {str(pid): int(pins)
                       for pid, pins in self._pinned.items()},
            "counters": {name: int(getattr(self, name))
                         for name in self._COUNTERS},
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` into a pool of the same geometry:
        block tables rebuilt from the owner lists, the prefix index and its
        inverse, the LRU order and the pins; ``version`` moves, so an
        engine's device copy of the block tables is uploaded again.
        Checks every invariant after."""
        geo = [self.num_pages, self.page_size, self.slots,
               self.max_pages_per_slot]
        if list(state["geometry"]) != geo:
            raise ValueError(f"pool geometry mismatch: snapshot "
                             f"{state['geometry']} vs engine {geo}")
        self._free = [int(p) for p in state["free"]]
        self.ref = np.asarray(state["ref"], np.int32)
        self.pages_of = [[int(p) for p in lst] for lst in state["pages_of"]]
        self.block_tables = np.zeros(
            (self.slots, self.max_pages_per_slot), np.int32)
        for slot, owned in enumerate(self.pages_of):
            self.block_tables[slot, :len(owned)] = owned
        self._index = {k: int(pid) for k, pid in state["index"].items()}
        self._page_key = {pid: k for k, pid in self._index.items()}
        self._lru = OrderedDict((int(p), None) for p in state["lru"])
        self._pinned = {int(pid): int(pins)
                        for pid, pins in state["pinned"].items()}
        self._seized = set()
        for name in self._COUNTERS:
            setattr(self, name, int(state["counters"][name]))
        self.version += 1
        self.assert_invariants()

    # ------------------------------------------------------------------ #
    def writable(self, pid: int) -> bool:
        """May a slot write into ``pid``: exclusively owned (one
        reference, no pins) and not registered in the prefix index."""
        return (pid != 0 and self.ref[pid] == 1
                and self._pinned.get(pid, 0) == 0
                and pid not in self._page_key)

    def writable_mask(self) -> np.ndarray:
        """:meth:`writable` of every page, boolean ``[num_pages]``."""
        mask = self.ref == 1
        mask[0] = False
        if self._pinned:
            mask[np.fromiter(self._pinned, np.int64,
                             count=len(self._pinned))] = False
        if self._page_key:
            mask[np.fromiter(self._page_key, np.int64,
                             count=len(self._page_key))] = False
        return mask

    def assert_invariants(self) -> None:
        """Every non-null page is in exactly one of: the free list,
        referenced by a slot or pinned by a spill record, the prefix-cache
        LRU, seized by the chaos harness; refcounts and block tables agree
        with the owner lists, and the index with its inverse."""
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise AssertionError("duplicate ids in free list")
        owners = Counter()
        for lst in self.pages_of:
            owners.update(lst)
        if 0 in free_set or 0 in owners or 0 in self._lru:
            raise AssertionError("the null page was handed out")
        for pid in range(1, self.num_pages):
            pins = self._pinned.get(pid, 0)
            states = (pid in free_set, self.ref[pid] > 0 or pins > 0,
                      pid in self._lru, pid in self._seized)
            if sum(states) != 1:
                raise AssertionError(
                    f"page {pid}: free={states[0]} held={states[1]} "
                    f"lru={states[2]} seized={states[3]} "
                    f"(ref={self.ref[pid]}, pins={pins})")
            if self.ref[pid] != owners[pid]:
                raise AssertionError(
                    f"page {pid}: ref={self.ref[pid]} but {owners[pid]} "
                    "block-table references")
            if pid in self._lru and pid not in self._page_key:
                raise AssertionError(f"page {pid}: unregistered in the LRU")
        for key, pid in self._index.items():
            if self._page_key.get(pid) != key:
                raise AssertionError(f"prefix index desync on page {pid}")
        if len(self._index) != len(self._page_key):
            raise AssertionError("prefix index desync")
        for slot, owned in enumerate(self.pages_of):
            n = len(owned)
            if (self.block_tables[slot, :n].tolist() != owned
                    or self.block_tables[slot, n:].any()):
                raise AssertionError(f"slot {slot}: block table desync")


# --------------------------------------------------------------------------- #
# Device-side helpers (plain torch, any device)
# --------------------------------------------------------------------------- #
def pow2_page_scale(amax: torch.Tensor, fmt) -> torch.Tensor:
    """Power-of-two scale ``2^(ceil(log2(amax)) - e_max)`` mapping ``amax``
    inside the format's range, by integer bit arithmetic on the float32
    pattern (no log2/exp2), clamped so the scale and its reciprocal are
    normal FP8 values."""
    if isinstance(fmt, str):
        fmt = FORMATS[fmt]
    a = torch.maximum(amax.to(torch.float32),
                      torch.tensor(1e-12, dtype=torch.float32,
                                   device=amax.device))
    bits = f32_bits(a)
    e_amax = ((bits >> 23) & 0xFF) - 127
    e_amax = e_amax + ((bits & 0x7FFFFF) != 0).to(torch.int64)  # ceil
    e = torch.clamp(e_amax - fmt.e_max, -(fmt.bias - 1), fmt.bias - 1)
    return f32_from_bits((e + 127) << 23)


def kv_noise(keys: torch.Tensor, shape, fmt) -> torch.Tensor:
    """Stochastic-rounding noise of KV writes: ``jax.random.randint(key,
    shape, 0, 1 << (23 - man_bits), uint32)`` for every key of the batch
    ``keys [..., 2]`` -> int64 ``[..., *shape]``."""
    if isinstance(fmt, str):
        fmt = FORMATS[fmt]
    return randint(keys, shape, 0, 1 << (23 - fmt.man_bits), torch.uint32)


def encode_kv(x, scale, fmt: str, mode: str = "stochastic", noise=None):
    """float K/V -> FP8 codes at ``scale`` (value ~= decode(code) * scale).
    ``mode="stochastic"`` needs ``noise`` (see :func:`kv_noise`); any other
    mode falls through to the deterministic encoder."""
    xs = x.to(torch.float32) / scale
    if mode == "stochastic":
        if noise is None:
            raise ValueError("stochastic KV encode needs its noise")
        return encode(xs, fmt, "stochastic", noise=noise)
    return encode(xs, fmt, mode)


def token_row_codes(scales, new, page_ids, rows, *, fmt: Optional[str],
                    mode: str = "stochastic", noise=None, write_mask=None,
                    store_dtype=None):
    """The per-row half of :func:`write_token_page`: everything but the
    scatter.  Returns ``(page_ids [B] int64 with masked lanes redirected to
    the null page, row codes [B, KV, hd] uint8, page scale [B])``.  A row-0
    write claims the page's scale from the token's absmax only when its
    lane is unmasked; later rows reuse the page's scale.  Float pages
    (``fmt=None``): the row is ``new`` cast to ``store_dtype`` (the pages'
    dtype, when given), no noise is read, and the scales are the pages'
    own, untouched."""
    page_ids = page_ids.to(torch.int64)
    if write_mask is not None:
        write_mask = write_mask.to(torch.bool)
        page_ids = torch.where(write_mask, page_ids, 0)
    if fmt is None:
        row = new if store_dtype is None else new.to(store_dtype)
        return page_ids, row, scales[page_ids]
    amax = new.to(torch.float32).abs().amax(dim=(1, 2))
    fresh = rows == 0
    if write_mask is not None:
        fresh = fresh & write_mask
    s = torch.where(fresh, pow2_page_scale(amax, fmt), scales[page_ids])
    codes = encode_kv(new, s[:, None, None], fmt, mode, noise)
    return page_ids, codes, s


def scatter_token_rows(pages, page_ids, rows, codes, write_mask=None):
    """``pages[page_ids, rows] = codes`` in place, for the ids and codes of
    :func:`token_row_codes`.  A masked lane, redirected to the null page,
    writes back the codes already there.

    The reference lets masked lanes scatter their rows into the null page,
    whose contents no contract covers; but an idle slot's attention reads
    that page, and a per-tensor quantizer downstream (the FP8 gate product)
    lets an idle row's value move every other row's codes.  Keeping the
    null page constant makes those reads equal in the fused decode (which
    reads before its scatter) and the unfused one (which reads after), and
    leaves no duplicate writes whose order the card does not fix.
    """
    rows = rows.to(torch.int64)
    if write_mask is not None:
        keep = ~write_mask.to(torch.bool)[:, None, None]
        codes = torch.where(keep, pages[page_ids, rows], codes)
    pages.index_put_((page_ids, rows), codes)
    return pages


def write_token_page(pages, scales, new, page_ids, rows, *,
                     fmt: Optional[str], mode: str = "stochastic",
                     noise=None, write_mask=None):
    """Scatter one decode token's K or V into its page, per slot, in place.

    pages: [P, page, KV, hd] uint8 codes (float when ``fmt`` is None);
    scales: [P] float32 (left unchanged for float pages); new: [B, KV, hd]
    float; page_ids/rows: [B] (physical page and row of each write);
    ``noise``: [B, KV, hd] for stochastic rounding; ``write_mask``: [B]
    bool — masked lanes land in the null page, never claim a scale and
    leave it unchanged (see :func:`scatter_token_rows`).
    Returns (pages, scales), the updated inputs.
    """
    page_ids, codes, s = token_row_codes(
        scales, new, page_ids, rows, fmt=fmt, mode=mode, noise=noise,
        write_mask=write_mask, store_dtype=pages.dtype)
    scatter_token_rows(pages, page_ids, rows, codes, write_mask)
    if fmt is not None:
        scales.index_put_((page_ids,), s)
    return pages, scales


def _rbits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, 2, int32)``: one uniform bit an
    element, for keys ``[..., 2]`` -> ``[..., *shape]``."""
    return randint(key, shape, 0, 2, torch.int32)


def rescale_codes(codes, inv_scale, fmt: str, mode: str = "stochastic",
                  key=None):
    """Rescale FP8 codes by ``inv_scale`` in the code domain: ``code' =
    lns_mul(code, encode(inv_scale))``, the paper's integer-add multiply
    (``core.lns.lns_op``).  For a power-of-two ratio (the page-scale
    contract) every carry-in is 0 and the rescale is exact; otherwise
    ``mode="stochastic"`` picks the RD or RU carry-in per element by one
    bit drawn from ``key`` (a key ``[2]``, or a batch ``[..., 2]`` for the
    leading dims of ``codes``), bit for bit the reference's draw.  E4M3
    has no directed mul expressions: stochastic falls back to RNE."""
    ratio = encode(torch.as_tensor(inv_scale, dtype=torch.float32), fmt,
                   "rne")
    ratio = torch.broadcast_to(ratio, codes.shape)
    if mode == "stochastic" and supports_stochastic(fmt, "mul"):
        if key is None:
            raise ValueError("stochastic rescale needs a PRNG key")
        lead = key.ndim - 1
        return lns_op(fmt, "mul", "stochastic", codes, ratio,
                      rbits=_rbits(key, codes.shape[lead:]))
    if mode == "stochastic":
        mode = "rne"
    return lns_op(fmt, "mul", mode, codes, ratio)


def write_prefill_pages(pages, scales, src, page_ids, *,
                        fmt: Optional[str], mode: str = "stochastic",
                        key=None):
    """Splice a prefill cache row into freshly allocated pages, in place.

    pages: [..., P, page, KV, hd]; scales: [..., P]; src: [..., S, KV, hd],
    scale-1 FP8 codes (the dense prefill cache's representation) or float;
    page_ids: [n_pages] with n_pages * page >= S; the leading dims (none,
    or the stacked layers) match, and so does ``key``'s ([2] or [..., 2]).
    Each page's scale comes from its whole content's absmax
    (:func:`pow2_page_scale`) and the codes are rescaled to it by
    :func:`rescale_codes`.  Float pages take ``src`` cast to their dtype.
    Returns (pages, scales), the updated inputs."""
    page_ids = torch.as_tensor(page_ids, dtype=torch.int64,
                               device=pages.device)
    n_pages = int(page_ids.shape[0])
    page = pages.shape[-3]
    S = src.shape[-3]
    pad = n_pages * page - S
    if pad:
        src = torch.cat([src, src.new_zeros(*src.shape[:-3], pad,
                                             *src.shape[-2:])], dim=-3)
    srcp = src.reshape(*src.shape[:-3], n_pages, page, *src.shape[-2:])
    lead = (slice(None),) * (pages.ndim - 4)
    if fmt is None:
        pages[lead + (page_ids,)] = srcp.to(pages.dtype)
        return pages, scales
    from ..kernels.common import code_to_f32

    vals = code_to_f32(srcp, fmt)  # scale-1 decode of the dense codes
    s = pow2_page_scale(vals.abs().amax(dim=(-3, -2, -1)), fmt)
    codes = rescale_codes(srcp, (1.0 / s)[..., None, None, None], fmt,
                          mode=mode, key=key)
    pages[lead + (page_ids,)] = codes
    scales[lead + (page_ids,)] = s
    return pages, scales
