"""Paged KV-cache pool: host allocator plus the device-side write helpers.

Port of ``repro.serving.page_pool`` for the first slice of the port.
Layout per attention layer (the model stacks all layers on a leading axis):

  k_pages / v_pages : [num_pages, page_size, KV, hd]   uint8 FP8 codes
  k_scale / v_scale : [num_pages]                      float32 page scales

``PagePool`` is the host-side allocator: free list, per-page reference
counts, per-slot block tables (page ids in logical order) and a version
counter that moves on every block-table change, so the engine uploads the
tables at most once per mutating step.  Page 0 is the reserved null page:
unowned block-table entries point at it and masked write lanes are
redirected into it, where they rewrite the row they hit with its own
codes (:func:`scatter_token_rows`): the null page keeps its initial zero
codes and unit scale, so what a masked lane reads there is the same in the
fused and unfused decode and on every run.  Preemption spills a slot's
pages (:meth:`PagePool.spill_slot`; the engine copies their contents to
the host first) and restores them into fresh ids.  The prefix-cache
index, copy-on-write, the spill pins of shared prefix pages and chaos
seizures of the reference pool arrive with later slices; in this one
every non-null page is either free or owned by exactly one slot.

Per-page scales are powers of two chosen from the page's first write
(:func:`pow2_page_scale`, integer bit arithmetic), and every float -> code
KV write rounds stochastically with noise addressed by (layer, write
position) — drawn by the caller with the threefry twin, so the codes equal
the reference's bit for bit.  Device helpers update the page and scale
tensors in place (``index_put_``) where the reference returns new arrays.
"""
from __future__ import annotations

import os
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.formats import FORMATS
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
    """Free-list page allocator + refcounts + block tables.

    The pool size is independent of the slot count.  Admission control is
    the caller's job via :meth:`can_alloc`.
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
        self.peak_used_pages = 0
        self.used_page_steps = 0
        self.observed_steps = 0
        self.spills = 0
        self.restores = 0

    # ------------------------------------------------------------------ #
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - self.free_pages

    def observe_step(self) -> None:
        """Record one scheduler step for the occupancy watermark stats."""
        self.used_page_steps += self.used_pages
        self.observed_steps += 1

    def mean_utilization(self) -> float:
        if not self.observed_steps or self.num_pages <= 1:
            return 0.0
        return self.used_page_steps / (self.observed_steps * (self.num_pages - 1))

    def publish_telemetry(self, tel) -> None:
        """Publish the pool occupancy gauges into a Telemetry registry."""
        usable = max(self.num_pages - 1, 1)
        tel.gauge("pool_pages").set(self.num_pages - 1)
        tel.gauge("pool_free_pages").set(len(self._free))
        tel.gauge("pool_used_pages").set(self.used_pages)
        tel.gauge("pool_utilization").set(self.used_pages / usable)
        for name, v in (("pool_spills_total", self.spills),
                        ("pool_restores_total", self.restores)):
            tel.counter(name).value = float(v)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_alloc(self, n: int) -> bool:
        return n <= self.free_pages

    # ------------------------------------------------------------------ #
    def _take_free(self, n: int) -> List[int]:
        if n > self.free_pages:
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {self.free_pages}"
            )
        return [self._free.pop() for _ in range(n)]

    def alloc(self, slot: int, n: int = 1) -> List[int]:
        """Allocate ``n`` exclusive pages to ``slot``, in logical order."""
        owned = self.pages_of[slot]
        if len(owned) + n > self.max_pages_per_slot:
            raise RuntimeError(
                f"slot {slot} exceeds max_pages_per_slot="
                f"{self.max_pages_per_slot}"
            )
        ids = self._take_free(n)
        for pid in ids:
            self.ref[pid] = 1
        start = len(owned)
        owned.extend(ids)
        self.block_tables[slot, start:start + len(ids)] = ids
        self.version += 1
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        return ids

    def free_slot(self, slot: int) -> None:
        """Return every page of ``slot`` to the free list."""
        for pid in self.pages_of[slot]:
            self.ref[pid] -= 1
            if self.ref[pid] < 0:
                raise RuntimeError(f"refcount underflow on page {pid}")
            if self.ref[pid] == 0:
                self._free.append(pid)
        self.pages_of[slot] = []
        self.block_tables[slot] = 0
        self.version += 1

    def ensure_capacity(self, slot: int, n_tokens: int) -> None:
        """Allocate pages so ``slot`` can hold ``n_tokens`` tokens."""
        need = self.pages_needed(n_tokens) - len(self.pages_of[slot])
        if need > 0:
            self.alloc(slot, need)

    def ensure_capacity_batch(self, n_tokens) -> None:
        """Grow every slot to hold ``n_tokens[slot]`` tokens in one pass
        (entry 0 or negative leaves a slot alone): one exhaustion check,
        and one version bump, so at most one block-table upload per step.
        Makes exactly the per-slot :meth:`ensure_capacity` loop's choices."""
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
            raise RuntimeError(
                f"slot {int(over[0])} exceeds max_pages_per_slot="
                f"{self.max_pages_per_slot}"
            )
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

    def writable_mask(self) -> np.ndarray:
        """Boolean ``[num_pages]``: may a slot write into the page (a
        non-null page owned by exactly one slot)?"""
        mask = self.ref == 1
        mask[0] = False
        return mask

    # ------------------------------------------------------------------ #
    # Preemption
    # ------------------------------------------------------------------ #
    def spill_plan(self, slot: int) -> Tuple[List[int], List[Tuple[int, int]]]:
        """What :meth:`spill_slot` will do: ``(spilled, pinned)``, the
        slot's page ids in logical order (the caller copies their contents
        out) and the ``(logical_idx, page_id)`` pairs of shared prefix
        pages that would stay resident under a pin.  This pool has no
        prefix index, so every page is spilled and ``pinned`` is empty."""
        return list(self.pages_of[slot]), []

    def spill_slot(self, slot: int) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Preemption: release ``slot``'s pages after the caller copied
        their contents out; returns :meth:`spill_plan`'s pair.

        The freed ids are prepended to the free list (:meth:`_take_free`
        pops from the end), so an immediate re-allocation prefers other
        pages: a restore through the same physical pages would hide
        block-table faults in tests."""
        spilled, pinned = self.spill_plan(slot)
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

    def restore_slot(self, slot: int, n: int,
                     pinned: Sequence[Tuple[int, int]] = ()) -> List[int]:
        """Re-admit a preempted request into ``slot``: allocate ``n`` fresh
        pages for its spilled contents (ids may differ from the spilled
        ones; the caller scatters the saved bytes back).  Returns the fresh
        ids in logical order.  ``pinned`` takes a spill record's pinned
        prefix pages, of which this pool makes none."""
        if self.pages_of[slot]:
            raise RuntimeError(f"restore target slot {slot} is not empty")
        _no_pins(pinned)
        if n > self.max_pages_per_slot:
            raise RuntimeError(
                f"slot {slot} exceeds max_pages_per_slot="
                f"{self.max_pages_per_slot}"
            )
        fresh = self._take_free(n)
        for pid in fresh:
            self.ref[pid] = 1
        self.pages_of[slot] = list(fresh)
        self.block_tables[slot, :n] = fresh
        self.version += 1
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        self.restores += 1
        return fresh

    def unpin(self, pinned: Sequence[Tuple[int, int]]) -> None:
        """Drop a discarded spill record's pins (the preempted request
        ended and will never restore).  This pool pins nothing, so the
        record holds none."""
        _no_pins(pinned)

    # ------------------------------------------------------------------ #
    def assert_invariants(self) -> None:
        """Every non-null page is either free or referenced (never both),
        and refcounts and block tables agree with the owner lists."""
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise AssertionError("duplicate ids in free list")
        owners = Counter()
        for lst in self.pages_of:
            owners.update(lst)
        if 0 in free_set or 0 in owners:
            raise AssertionError("the null page was handed out")
        for pid in range(1, self.num_pages):
            if (pid in free_set) == (self.ref[pid] > 0):
                raise AssertionError(
                    f"page {pid}: free={pid in free_set} ref={self.ref[pid]}")
            if self.ref[pid] != owners[pid]:
                raise AssertionError(
                    f"page {pid}: ref={self.ref[pid]} but {owners[pid]} "
                    "block-table references")
        for slot, owned in enumerate(self.pages_of):
            n = len(owned)
            if (self.block_tables[slot, :n].tolist() != owned
                    or self.block_tables[slot, n:].any()):
                raise AssertionError(f"slot {slot}: block table desync")


def _no_pins(pinned) -> None:
    if len(pinned):
        raise RuntimeError(
            f"pinned prefix pages {list(pinned)}: this pool has no prefix "
            "index, so no spill record can hold a pin")


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
