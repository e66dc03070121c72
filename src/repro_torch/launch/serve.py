"""Serving entry point of the port: the Engine under the continuous or the
bucketed scheduler, on the paged or the dense cache.

Port of ``repro.launch.serve`` for its single-device paths:

* ``Engine`` with the paged cache (float pages of the model's dtype by
  default, FP8 pages under a policy that quantizes the KV cache, e.g.
  ``serve_fp8_paged``), fused or unfused decode, block tables uploaded at
  most once per mutating step, preemption (a slot's pages copied verbatim
  to the host and restored into fresh pages, bit for bit), ref-counted
  prefix caching (requests that share a prompt prefix map its registered
  pages read-only and prefill only their tails, token streams bitwise
  equal to the cache off); or with the dense per-slot cache
  (``cache_impl="dense"``: scale-1 FP8 codes or floats, a ring buffer of
  the window's length for local layers);
* ``static_weights=True``: the eligible weights held as FP8 codes
  (``models.quantize``), decoded before each float product or, under a
  policy that quantizes matmuls, multiplied as codes by K2
  (``fused_dequant``) or K3 (``lns``);
* ``run`` with its two schedulers: ``run_continuous`` (chunked prefill,
  mid-flight joins, preemption; paged cache only) and ``run_bucketed``
  (batched prefills of equal-length prompts spliced into the cache, one
  decode step for all slots, worst-case page reservations; with the
  prefix cache on, every admission prefills through ``tail_prefill``);
  ``sample``; and the CLI.

Every paged token, prefill or decode, is a single-token sub-step of
``Model.step_paged`` or ``Model.decode_step_paged``, whose attention
layers launch the hand-written CUDA kernel K1
(``kernels/paged_attention.py``: its float instance on float pages, its
LNS instance on FP8 pages).

The engine runs on the card unless the caller passes ``device="cpu"``
(the tests), and raises when no GPU is present — there is no silent CPU
fallback.  ``runtime.fault.run_serving`` drives it under faults (the
chaos harness, crash snapshots, a kill and restore); tensor parallelism
arrives with a later slice.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 6 \\
        --slots 2 --gen 16 --prompt-len 4,12,8
    python -m repro_torch.launch.serve --arch gemma3-12b --prefix-cache on \\
        --shared-prefix 64
    python -m repro_torch.launch.serve --arch gemma3-12b --scheduler bucketed \\
        --cache-impl dense
"""
from __future__ import annotations

import argparse
import hashlib
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import numerics
from ..configs import get_config
from ..core import prng
from ..models import Model
from ..models.quantize import quantize_params
from ..runtime.steps import build_decode_step, build_prefill_step
from ..serving import (CANCELLED, FINISHED, REJECTED, TIMED_OUT,
                       ContinuousScheduler, PagePool, Request,
                       invariant_checks_enabled)
from ..serving.telemetry import Telemetry, _atomic_write

__all__ = ["Engine", "cache_bytes", "sample", "run", "run_bucketed",
           "run_continuous", "main"]


def _later(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with a later slice of the "
        f"port (ROADMAP.md Queue 1 item {item})")


def cache_bytes(tree) -> int:
    """Bytes of every tensor in a cache (a dict, a list of dicts, or a
    tensor)."""
    if isinstance(tree, dict):
        return sum(cache_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(cache_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _resolve_device(device) -> torch.device:
    """The engine's device; CUDA unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "to run the plain (non-kernel) versions on the CPU")
    return device


class Engine:
    # Disjoint PRNG streams of the two KV-write paths.  Stream 0 (token
    # writes) is not folded with the engine step: the attention layers
    # fold each slot's write position into it, so page codes are a pure
    # function of (tokens, position, layer), as in the reference.  Stream
    # 1 (the bucketed scheduler's prefill splice) folds the engine step.
    _STREAM_TOKEN_WRITE = 0
    _STREAM_PREFILL_SPLICE = 1

    def __init__(self, cfg, *, slots: int, max_seq: int,
                 cache_impl: str = "paged", page_size: int = 16,
                 num_pages: Optional[int] = None, rng_seed: int = 0,
                 stochastic_kv: Optional[bool] = None,
                 prefix_cache: bool = False, fused_decode: bool = True,
                 telemetry: Optional[Telemetry] = None, mesh=None,
                 static_weights: bool = False, device="cuda"):
        if mesh is not None:
            raise _later("tensor-parallel serving (mesh=...)", 9)
        if cache_impl not in ("paged", "dense"):
            raise ValueError(f"unknown cache_impl {cache_impl!r}")
        if prefix_cache:
            if cache_impl != "paged":
                raise ValueError("prefix caching needs cache_impl='paged'")
            if not self.prefix_cache_supported(cfg):
                raise ValueError(
                    f"prefix caching needs a pure-GQA paged KV cache; "
                    f"{cfg.name!r} (family={cfg.family!r}, "
                    f"attn_impl={cfg.attn_impl!r}) keeps dense per-slot "
                    "cache entries that cannot be shared between requests")
        self.device = _resolve_device(device)
        self.cfg = cfg
        # fused_decode=True runs each sub-step's KV write and attention as
        # one K1 launch; False writes then attends.  Token streams are
        # bit-identical either way.
        self.fused_decode = bool(fused_decode)
        self.tel = telemetry if telemetry is not None else Telemetry()
        self.model = Model(cfg, max_seq=max_seq)
        # the bucketed scheduler's model calls (the reference's jitted
        # ``model.prefill`` / ``model.decode_step``)
        self._prefill = build_prefill_step(self.model)
        self._decode = build_decode_step(self.model)
        self.max_seq = max_seq
        self.slots = slots
        self.cache_impl = cache_impl
        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.params = self.model.init(gen)
        # static_weights: the eligible weights as FP8 codes (opt-in: it
        # changes the matmul path against the plain-weight engine)
        if static_weights:
            self.params = quantize_params(
                self.params, cfg.policy, period=cfg.layer_pattern_period)
        # stochastic-rounding KV writes only matter for FP8 pages; the
        # policy's kv_write mode carries the default.  Host-side keys: the
        # reference's PRNGKey(seed + 17) and its stream folds.
        if stochastic_kv is None:
            stochastic_kv = numerics.kv_stochastic(cfg.policy)
        self._kv_key = prng.prng_key(rng_seed + 17) if stochastic_kv else None
        self._token_key = (
            None if self._kv_key is None
            else prng.fold_in(self._kv_key, self._STREAM_TOKEN_WRITE))
        self._step = 0
        self.prefix_cache = bool(prefix_cache)
        self._slot_hash = {}        # slot -> its prompt's page hashes
        self._slot_registered = {}  # slot -> pages published so far
        # chain root of the token-chunk hashes: pages are valid across
        # requests that share the parameters' seed, numerics and page size
        desc = f"{cfg.name}|{rng_seed}|{page_size}|" + cfg.policy.to_json()
        self._prefix_root = hashlib.sha256(desc.encode()).digest()
        if cache_impl == "dense":
            self.pool = None
            self.cache = self.model.make_cache(slots, max_seq, self.device)
            return
        self.page_size = page_size
        self.max_pages_per_slot = -(-max_seq // page_size)
        if num_pages is None:
            num_pages = slots * self.max_pages_per_slot + 1
        self.pool = PagePool(num_pages, page_size, slots,
                             self.max_pages_per_slot)
        self.cache = self.model.make_paged_cache(num_pages, page_size,
                                                 self.device)
        # device mirror of pool.block_tables, re-uploaded only when the
        # pool's version moves (at most one transfer per mutating step)
        self._bt_device = None
        self._bt_version = -1

    # ------------------------------------------------------------------ #
    # Prefix cache: chunk hashing, admission matching, COW, registration
    # ------------------------------------------------------------------ #
    @staticmethod
    def prefix_cache_supported(cfg) -> bool:
        """Prefix caching shares pages, so every layer's KV state must live
        in the page pool: pure-GQA decoder-only stacks (every config the
        port runs; the reference refuses MLA latents, SSM states and
        cross/encoder caches, which are dense per-slot entries)."""
        if cfg.family in ("vlm", "encdec") or cfg.attn_impl != "gqa":
            return False
        return not cfg.first_dense and all(
            cfg.is_attn_layer(i) for i in range(cfg.n_layers))

    def _splice_key(self):
        """This step's key of the bucketed prefill splice's rescale stream
        (the reference's ``fold_in(fold_in(key, 1), step)``), or None."""
        if self._kv_key is None:
            return None
        return prng.fold_in(
            prng.fold_in(self._kv_key, self._STREAM_PREFILL_SPLICE),
            self._step)

    def _prompt_hashes(self, prompt: np.ndarray) -> List[str]:
        """Chained hash per FULL page of ``prompt``: hash i commits to the
        engine root (parameters' seed, numerics policy, page size) and to
        every token up to the end of page i — a page's KV is a function of
        the whole prefix under causal attention, so the chain, not the
        chunk alone, is the cache key."""
        toks = np.ascontiguousarray(np.asarray(prompt, np.int64))
        ps = self.page_size
        h = self._prefix_root
        out = []
        for i in range(len(toks) // ps):
            h = hashlib.sha256(h + toks[i * ps:(i + 1) * ps].tobytes()).digest()
            out.append(h.hex())
        return out

    def prompt_hashes(self, prompt: np.ndarray) -> List[str]:
        """:meth:`_prompt_hashes` ([] when the cache is off), so that the
        scheduler hashes each prompt once."""
        return self._prompt_hashes(prompt) if self.prefix_cache else []

    def prefix_plan(self, prompt: np.ndarray,
                    hashes: Optional[List[str]] = None
                    ) -> Tuple[int, int, int, int]:
        """Read-only admission planning: ``(n_cached, n_mapped, extra,
        revived)``.  ``n_cached`` prompt tokens are skipped, ``n_mapped``
        cached pages mapped into the slot, ``extra`` pages drawn beyond the
        tail's own (the COW copy when the cache covers the whole prompt),
        and ``revived`` of the matched pages sit in the LRU, where they
        count as free until the request's own ``share`` revives them, so
        the admission budget charges them too."""
        if not self.prefix_cache:
            return 0, 0, 0, 0
        plen = int(np.asarray(prompt).shape[0])
        if hashes is None:
            hashes = self._prompt_hashes(prompt)
        ids = self.pool.match_prefix(hashes, peek=True)
        revived = sum(1 for pid in ids if self.pool.ref[pid] == 0)
        matched = len(ids) * self.page_size
        if matched and matched == plen:
            # whole prompt cached: the final token is still recomputed (its
            # logits seed generation) into a COW copy of the last page
            return plen - 1, len(ids), 1, revived
        return matched, len(ids), 0, revived

    def admit_prefix(self, slot: int, prompt: np.ndarray,
                     hashes: Optional[List[str]] = None) -> int:
        """Map ``prompt``'s longest cached page prefix into ``slot``
        read-only; returns the number of prompt tokens admission skips
        (chunked prefill starts at the first uncached token).

        When the cache covers the whole prompt, the last matched page is
        replaced by a copy-on-write clone (``PagePool.cow_page`` and a
        device copy of its contents) and the final prompt token is
        recomputed into it: bit-identical to the cached row, because KV
        rounding is addressed by position."""
        if not self.prefix_cache:
            return 0
        plen = int(np.asarray(prompt).shape[0])
        if hashes is None:
            hashes = self._prompt_hashes(prompt)
        ids = self.pool.match_prefix(hashes)
        self._slot_hash[slot] = hashes
        self._slot_registered[slot] = len(ids)
        if not ids:
            return 0
        self.pool.share(slot, ids)
        matched = len(ids) * self.page_size
        if matched == plen:
            old, new = self.pool.cow_page(slot, len(ids) - 1)
            self._copy_page(old, new)
            matched = plen - 1
        return matched

    def note_prefilled(self, slot: int, n_prefilled: int) -> None:
        """Publish every prompt page ``slot`` has now fully written into
        the prefix index (the scheduler calls this as prefill advances)."""
        hashes = self._slot_hash.get(slot)
        if not self.prefix_cache or hashes is None:
            return
        upto = min(n_prefilled // self.page_size, len(hashes))
        start = self._slot_registered.get(slot, 0)
        for i in range(start, upto):
            self.pool.register_prefix(hashes[i], self.pool.pages_of[slot][i])
        if upto > start:
            self._slot_registered[slot] = upto

    def tail_prefill(self, admissions, *, chunk: int = 4):
        """Prefill every admission's uncached tail together, through shared
        masked mixed steps against the mapped cached prefixes (the bucketed
        scheduler's path with the prefix cache on).

        ``admissions``: a list of ``(slot, prompt, start)``.  All tails ride
        the same :meth:`step_chunk` calls; each slot's numerics do not
        depend on the batch's other rows, so this equals prefilling them
        one by one.  Returns ``{slot: the final prompt token's logits
        row}``."""
        state = {slot: [np.asarray(prompt), int(start)]
                 for slot, prompt, start in admissions}
        out = {}
        while state:
            toks = np.zeros((self.slots, chunk), np.int32)
            lengths = np.zeros((self.slots,), np.int32)
            n_new = np.zeros((self.slots,), np.int32)
            with self.tel.span("host"):
                for slot, (prompt, done) in state.items():
                    n = min(chunk, prompt.shape[0] - done)
                    toks[slot, :n] = prompt[done:done + n]
                    lengths[slot] = done
                    n_new[slot] = n
                self.pool.ensure_capacity_batch(lengths + n_new)
            logits = self.step_chunk(toks, lengths, n_new)
            for slot in list(state):
                prompt, done = state[slot]
                done += int(n_new[slot])
                state[slot][1] = done
                self.note_prefilled(slot, done)
                if done >= prompt.shape[0]:
                    out[slot] = logits[slot]
                    del state[slot]
        return out

    def _copy_page(self, old: int, new: int) -> None:
        """The device side of a COW: page ``old``'s codes and scales (or
        float rows) copied into page ``new`` in every layer, in place."""
        with self.tel.span("kv_write", kind="cow", src=old, dst=new):
            src = torch.tensor([old], dtype=torch.int64, device=self.device)
            dst = torch.tensor([new], dtype=torch.int64, device=self.device)
            for t in self.cache.values():
                t.index_copy_(1, dst, t.index_select(1, src))

    # ------------------------------------------------------------------ #
    # Preemption
    # ------------------------------------------------------------------ #
    def preempt_slot(self, slot: int) -> dict:
        """Spill ``slot`` to the host: copy its unregistered pages'
        contents (codes and scales, or float rows) out of every layer
        verbatim, never re-quantized, then free them, so a later
        :meth:`restore_slot` is bit-identical.  Registered prefix pages are
        neither copied nor freed: they stay resident under a pin
        (``PagePool.spill_slot``).  Returns the spill record, which also
        carries the prompt's page hashes."""
        with self.tel.span("preempt", slot=slot):
            return self._preempt_slot(slot)

    def _preempt_slot(self, slot: int) -> dict:
        spilled, pinned = self.pool.spill_plan(slot)
        ids = torch.as_tensor(spilled, dtype=torch.int64, device=self.device)
        # the index gather copies, so the host tensors never alias the cache
        state = {name: t[:, ids].cpu() for name, t in self.cache.items()}
        self.pool.spill_slot(slot)
        # the prompt's page hashes travel with the request, whichever slot
        # it is restored into
        return {"n_pages": len(spilled), "pinned": pinned, "state": state,
                "hashes": self._slot_hash.pop(slot, None),
                "registered": self._slot_registered.pop(slot, 0)}

    def restore_slot(self, slot: int, record: dict) -> None:
        """Re-admit a preempted request into ``slot``: fresh pages (ids may
        differ from the spilled ones), the saved contents scattered back
        into every layer, the pinned prefix pages re-referenced at their
        logical indices, and the prompt's hashes bound to ``slot``."""
        with self.tel.span("restore", slot=slot):
            self._restore_slot(slot, record)

    def _restore_slot(self, slot: int, record: dict) -> None:
        new_ids = self.pool.restore_slot(slot, record["n_pages"],
                                         record.get("pinned", ()))
        if record.get("hashes") is not None:
            self._slot_hash[slot] = record["hashes"]
            self._slot_registered[slot] = record.get("registered", 0)
        ids = torch.as_tensor(new_ids, dtype=torch.int64, device=self.device)
        for name, saved in record["state"].items():
            self.cache[name][:, ids] = saved.to(self.device)

    # ------------------------------------------------------------------ #
    def _assert_writable(self, lengths: np.ndarray, n_new: np.ndarray) -> None:
        """Host-side guard behind the device-side write mask: every page an
        active slot writes this step must be exclusively owned."""
        lengths = np.asarray(lengths, np.int64)
        n_new = np.asarray(n_new, np.int64)
        act = n_new > 0
        if not act.any():
            return
        l0 = lengths // self.page_size
        l1 = (lengths + np.maximum(n_new, 1) - 1) // self.page_size
        logical = np.arange(self.pool.max_pages_per_slot)[None, :]
        written = (act[:, None] & (logical >= l0[:, None])
                   & (logical <= l1[:, None]))
        pids = self.pool.block_tables[written]
        bad = ~self.pool.writable_mask()[pids]
        if bad.any():
            slot_of = np.broadcast_to(
                np.arange(self.slots)[:, None], written.shape)[written]
            i = int(np.argmax(bad))
            raise AssertionError(
                f"slot {int(slot_of[i])} would write into non-exclusive "
                f"page {int(pids[i])}")

    def _device_block_tables(self) -> torch.Tensor:
        """Device copy of the pool's block tables, re-uploaded only when
        the pool's version moved (``host_transfers_total`` counts it)."""
        if self._bt_version != self.pool.version or self._bt_device is None:
            self._bt_device = torch.from_numpy(
                self.pool.block_tables.copy()).to(self.device)
            self._bt_version = self.pool.version
            self.tel.counter("host_transfers_total").inc()
        return self._bt_device

    # ------------------------------------------------------------------ #
    # Bucketed scheduler: batched prefill, the splice, one-token decode
    # ------------------------------------------------------------------ #
    def _prefill_batch_inputs(self, prompts: List[np.ndarray]):
        toks = np.stack([np.asarray(p, np.int64) for p in prompts])
        return {"tokens": torch.as_tensor(toks, device=self.device)}

    def _layer_keys(self, key: torch.Tensor) -> torch.Tensor:
        """Per-layer keys [n_layers, 2] of one splice row's K or V key: the
        reference splits it over its stacked blocks, so every layer
        ``b * period + j`` of block ``b`` takes the block's key."""
        cfg = self.cfg
        period = cfg.layer_pattern_period
        blocks = prng.split(key, cfg.n_layers // period)
        return blocks.repeat_interleave(period, dim=0).to(self.device)

    def _splice(self, small, slots: List[int], page_ids: np.ndarray,
                keys) -> None:
        """Write each prefill row's dense cache entries into its slot, in
        place: rows of the dense cache, or freshly allocated pages (each
        page's scale from its whole content, the codes rescaled to it with
        stochastic carry-ins when ``keys`` is given).  Prefill row ``i``'s
        K and V take ``fold_in(keys, 2 i)`` and ``fold_in(keys, 2 i + 1)``,
        split per block."""
        cfg = self.cfg
        if self.cache_impl == "dense":
            for entry, new in zip(self.cache, small):
                for name in ("k", "v"):
                    src = new[name]
                    if src.shape[1] > entry[name].shape[1]:
                        raise ValueError(
                            f"a {src.shape[1]}-token prompt does not fit a "
                            f"{entry[name].shape[1]}-row dense cache entry "
                            "(a local layer's ring buffer holds its "
                            "window); the reference refuses it too")
                    for i, slot in enumerate(slots):
                        entry[name][slot, :src.shape[1]] = src[i].to(
                            entry[name].dtype)
            return
        for i in range(len(slots)):
            ids = torch.as_tensor(page_ids[i], dtype=torch.int64,
                                  device=self.device)
            for name, pages, scales, fold in (("k", "kp", "ks", 2 * i),
                                              ("v", "vp", "vs", 2 * i + 1)):
                key = (None if keys is None
                       else self._layer_keys(prng.fold_in(keys, fold)))
                src = torch.stack([c[name][i] for c in small])
                numerics.kv_write_prefill(cfg.policy, self.cache[pages],
                                          self.cache[scales], src, ids,
                                          key=key)

    def prefill_batch(self, prompts: List[np.ndarray], slots: List[int]):
        """Batched prefill admission: one model call for all the prompts
        (of one length), then each row's cache spliced into its slot
        (pages or dense rows).  Splice codes are addressed by the engine
        step and the batch, not by content, so they are never registered
        in the prefix index (with the prefix cache on, ``run_bucketed``
        prefills through :meth:`tail_prefill` instead).  Returns
        (first tokens [n], prompt length)."""
        n = len(prompts)
        plen = int(np.asarray(prompts[0]).shape[0])
        assert all(np.asarray(p).shape[0] == plen for p in prompts), \
            "bucket by length"
        with self.tel.span("prefill", n=n, plen=plen):
            logits, small = self._prefill(
                self.params, self._prefill_batch_inputs(prompts))
        with self.tel.span("host"):
            if self.cache_impl == "paged":
                npages = self.pool.pages_needed(plen)
                page_ids = np.zeros((n, npages), np.int64)
                for i, slot in enumerate(slots):
                    page_ids[i] = self.pool.alloc(slot, npages)
            else:
                page_ids = np.zeros((n, 1), np.int64)
        with self.tel.span("kv_write", kind="splice", n=n, plen=plen):
            self._splice(small, list(slots), page_ids, self._splice_key())
        host = self.sync_logits(logits[:, : self.cfg.vocab])
        return np.argmax(host, axis=-1), plen

    def decode(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """Dense decode step; ``pos`` is the per-slot position vector.
        Returns the host logits [slots, vocab]."""
        dev = self.device
        with self.tel.span("decode"):
            logits, self.cache = self._decode(
                self.params, self.cache,
                torch.as_tensor(np.asarray(tokens, np.int64), device=dev),
                torch.as_tensor(np.asarray(pos, np.int64), device=dev))
            self._step += 1
            self.tel.counter("serve_substeps_total").inc()
            out = logits[:, : self.cfg.vocab]
        return self.sync_logits(out)

    def decode_paged(self, tokens: np.ndarray, lengths: np.ndarray, *,
                     sync: bool = True):
        """Paged decode step: fresh pages for slots crossing a page
        boundary, then one single-token sub-step.  Slots with ``lengths
        == 0`` are idle: their writes are masked into the null page, so a
        slot whose block table still maps shared prefix pages cannot
        corrupt them.  ``sync=False`` returns the device logits (resolve
        with :meth:`sync_logits`)."""
        lengths = np.asarray(lengths)
        active = lengths > 0
        dev = self.device
        with self.tel.span("host"):
            self.pool.ensure_capacity_batch(np.where(active, lengths + 1, 0))
            self._assert_writable(lengths, active.astype(np.int32))
            tables = self._device_block_tables()
        with self.tel.span("decode"):
            logits, self.cache = self.model.decode_step_paged(
                self.params, self.cache,
                torch.as_tensor(np.asarray(tokens, np.int64), device=dev),
                torch.as_tensor(np.asarray(lengths, np.int32), device=dev),
                tables, page_size=self.page_size, key=self._token_key,
                active=torch.as_tensor(active, device=dev),
                fused=self.fused_decode)
            self._step += 1
            self.tel.counter("serve_substeps_total").inc()
            out = logits[:, : self.cfg.vocab]
        if not sync:
            return out
        return self.sync_logits(out)

    def sync_logits(self, logits) -> np.ndarray:
        """Wait for a step's logits and copy them to the host (the
        token-emission boundary); passthrough for a host array."""
        if isinstance(logits, np.ndarray):
            return logits
        with self.tel.span("sync"):
            return logits.cpu().numpy()

    def step_chunk(self, tokens: np.ndarray, lengths: np.ndarray,
                   n_new: np.ndarray, *, sync: bool = True):
        """Mixed prefill+decode step: tokens [slots, T]; lengths/n_new
        [slots].  The caller has allocated pages for ``lengths + n_new``
        tokens per slot.  Returns each slot's last-valid-token logits
        [slots, vocab] — the device tensor when ``sync=False`` (resolve
        with :meth:`sync_logits`)."""
        with self.tel.span("host"):
            self._assert_writable(np.asarray(lengths), np.asarray(n_new))
            tables = self._device_block_tables()
        dev = self.device
        phase = "decode" if all(int(n) <= 1 for n in n_new) else "prefill"
        with self.tel.span(phase):
            toks = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
            logits, self.cache = self.model.step_paged(
                self.params, self.cache, toks,
                torch.as_tensor(np.asarray(lengths, np.int32), device=dev),
                torch.as_tensor(np.asarray(n_new, np.int32), device=dev),
                tables, page_size=self.page_size, key=self._token_key,
                fused=self.fused_decode)
            self._step += 1
            self.tel.counter("serve_substeps_total").inc(toks.shape[1])
            out = logits[:, : self.cfg.vocab]
        if not sync:
            return out
        return self.sync_logits(out)

    def release(self, slot: int) -> None:
        if self.pool is not None:
            self.pool.free_slot(slot)
        self._slot_hash.pop(slot, None)
        self._slot_registered.pop(slot, None)

    def kv_cache_bytes(self) -> int:
        return cache_bytes(self.cache)

    def kv_capacity_tokens(self) -> int:
        """Tokens the cache memory holds (pool pages or dense rows)."""
        if self.pool is not None:
            return (self.pool.num_pages - 1) * self.page_size
        return self.slots * self.max_seq


def sample(logits: np.ndarray, temperature: float, rng: np.random.Generator):
    if temperature <= 0:
        return logits.argmax(-1)
    z = logits / temperature
    z = z - z.max(-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(-1, keepdims=True)
    return np.array([rng.choice(len(row), p=row) for row in p])


def run(eng: Engine, queue: List[np.ndarray], *, gen: int,
        temperature: float = 0.0, seed: int = 0, quiet: bool = False,
        scheduler: str = "bucketed", arrivals=None, chunk: int = 4,
        on_token=None, deadline_steps: Optional[int] = None,
        deadline_s: Optional[float] = None,
        max_tokens: Optional[int] = None, max_queue: Optional[int] = None,
        watermark_high: float = 1.0, watermark_low: float = 0.75,
        control=None):
    """Serve ``queue`` to completion; returns (outputs, stats).

    ``scheduler``: "bucketed" (batched prefills of equal-length prompts,
    worst-case page reservations; paged or dense cache) or "continuous"
    (chunked prefill and preemption; paged cache only).  ``arrivals``
    gives each request's arrival step; ``on_token(rid, token, step)``
    streams tokens as they are sampled.  Under either scheduler a request
    that cannot be served ends on its own (its slot and pages released)
    and ``stats["statuses"]`` records every request's terminal state;
    ``outputs`` holds the finished ones.  ``deadline_steps`` /
    ``deadline_s`` bound each request's steps or seconds, ``max_tokens``
    caps generation, ``control`` (a :class:`~repro_torch.serving.
    ServeControl`) cancels requests mid-flight; ``max_queue`` and the
    watermarks add admission backpressure (continuous only)."""
    if scheduler == "continuous":
        return run_continuous(eng, queue, gen=gen, temperature=temperature,
                              seed=seed, quiet=quiet, arrivals=arrivals,
                              chunk=chunk, on_token=on_token,
                              deadline_steps=deadline_steps,
                              deadline_s=deadline_s, max_tokens=max_tokens,
                              max_queue=max_queue,
                              watermark_high=watermark_high,
                              watermark_low=watermark_low, control=control)
    if scheduler != "bucketed":
        raise ValueError(f"unknown scheduler {scheduler!r}")
    return run_bucketed(eng, queue, gen=gen, temperature=temperature,
                        seed=seed, quiet=quiet, arrivals=arrivals,
                        chunk=chunk, on_token=on_token,
                        deadline_steps=deadline_steps,
                        deadline_s=deadline_s, max_tokens=max_tokens,
                        control=control)


def run_bucketed(eng: Engine, queue: List[np.ndarray], *, gen: int,
                 temperature: float = 0.0, seed: int = 0, quiet: bool = False,
                 arrivals=None, chunk: int = 4, on_token=None,
                 deadline_steps: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 max_tokens: Optional[int] = None, control=None):
    """Bucketed admission over ``queue``; returns (outputs, stats).

    Every free slot takes the next arrived request; the admissions of one
    step are grouped by prompt length and each group is one batched
    prefill (:meth:`Engine.prefill_batch`), or, with the prefix cache on,
    all of them prefill their uncached tails together
    (:meth:`Engine.tail_prefill`).  Then one decode step runs for every
    occupied slot.  Admission reserves each request's worst-case pages
    (prompt and whole generation), so decode never runs the pool dry; a
    request whose worst case exceeds the whole pool or one slot's block
    table is REJECTED at its admission, and deadline-blown or cancelled
    requests release their slots on their own."""
    rng = np.random.default_rng(seed)
    if max_tokens is not None:
        gen = min(gen, max_tokens)
    requests = len(queue)
    active: Dict[int, dict] = {}
    reserved: Dict[int, int] = {}   # slot -> worst-case page reservation
    outputs: Dict[int, list] = {}
    statuses: Dict[int, tuple] = {}  # rid -> (terminal state, reason)
    terminal = Counter()
    next_req = 0
    tel = eng.tel
    clock = tel.clock
    t0 = clock()
    steps = 0
    decoded_tokens = 0
    decode_wall_s = 0.0
    occupied_slot_steps = 0
    prefix_hit_tokens = 0

    def finish(rid: int, state: str, reason: str = "") -> None:
        statuses[rid] = (state, reason)
        terminal[state] += 1
        tel.counter("serve_requests_total", state=state).inc()

    def arrival_of(rid: int) -> int:
        return 0 if arrivals is None else int(arrivals[rid])

    def expired(rid: int) -> Optional[str]:
        if control is not None and control.cancelled(rid):
            return CANCELLED
        if (deadline_steps is not None
                and steps - arrival_of(rid) >= deadline_steps):
            return TIMED_OUT
        if deadline_s is not None and clock() - t0 > deadline_s:
            return TIMED_OUT
        return None

    while len(statuses) < requests:
        with tel.span("admit"):
            # deadline and cancellation sweep over the active slots
            for slot, st in list(active.items()):
                state = expired(st["rid"])
                if state is not None:
                    finish(st["rid"], state,
                           "cancelled by client" if state == CANCELLED
                           else "deadline exhausted")
                    del active[slot]
                    reserved.pop(slot, None)
                    eng.release(slot)
            # batched admission into every free slot; with the prefix
            # cache on every admission prefills through the position-
            # addressed chunked pipeline (registered pages must hold
            # content-addressed codes, which the step-keyed splice lacks)
            admit_slots, admit_prompts, admit_rids = [], [], []
            chunked_admissions = []  # (slot, rid, prompt, n_cached)
            for slot in range(eng.slots):
                if slot in active:
                    continue
                # end terminal queue heads first (cancelled, expired, or
                # too big for an empty pool), each on its own
                while next_req < requests:
                    if arrivals is not None and arrivals[next_req] > steps:
                        break
                    state = expired(next_req)
                    if state is not None:
                        finish(next_req, state,
                               "cancelled by client" if state == CANCELLED
                               else "deadline exhausted before admission")
                        next_req += 1
                        continue
                    if eng.pool is not None:
                        worst = eng.pool.pages_needed(
                            queue[next_req].shape[0] + gen)
                        usable = min(eng.pool.num_pages - 1,
                                     eng.pool.max_pages_per_slot)
                        if worst > usable:
                            finish(next_req, REJECTED,
                                   f"needs {worst} pages but the pool "
                                   f"serves at most {usable} per request; "
                                   f"raise --pages or lower "
                                   f"--gen/--prompt-len")
                            next_req += 1
                            if invariant_checks_enabled():
                                eng.pool.assert_invariants()
                            continue
                    break
                if next_req >= requests:
                    break
                if arrivals is not None and arrivals[next_req] > steps:
                    break  # FIFO: the next request has not arrived yet
                prompt = queue[next_req]
                if eng.pool is not None:
                    worst = eng.pool.pages_needed(prompt.shape[0] + gen)
                    if sum(reserved.values()) + worst > eng.pool.num_pages - 1:
                        break  # wait for in-flight requests to free pages
                    reserved[slot] = worst
                n_cached = eng.admit_prefix(slot, prompt)
                if eng.prefix_cache:
                    chunked_admissions.append(
                        (slot, next_req, prompt, n_cached))
                else:
                    admit_slots.append(slot)
                    admit_prompts.append(prompt)
                    admit_rids.append(next_req)
                next_req += 1
        if admit_prompts:
            # one batched prefill per prompt length
            by_len: Dict[int, List[int]] = {}
            for i, p in enumerate(admit_prompts):
                by_len.setdefault(p.shape[0], []).append(i)
            for idxs in by_len.values():
                first, plen = eng.prefill_batch(
                    [admit_prompts[i] for i in idxs],
                    [admit_slots[i] for i in idxs])
                for j, i in enumerate(idxs):
                    active[admit_slots[i]] = dict(
                        rid=admit_rids[i], pos=plen,
                        out=[int(first[j])], last=int(first[j]))
                    if on_token is not None:
                        on_token(admit_rids[i], int(first[j]), steps)
        if chunked_admissions:
            rows = eng.tail_prefill(
                [(slot, prompt, n_cached)
                 for slot, _, prompt, n_cached in chunked_admissions],
                chunk=chunk)
            for slot, rid, prompt, n_cached in chunked_admissions:
                first = int(np.argmax(rows[slot][: eng.cfg.vocab]))
                prefix_hit_tokens += n_cached
                tel.counter("serve_prefix_hit_tokens_total").inc(n_cached)
                active[slot] = dict(rid=rid, pos=prompt.shape[0],
                                    out=[first], last=first)
                if on_token is not None:
                    on_token(rid, first, steps)

        if not active:
            # nothing in flight (requests still arriving): let time pass
            steps += 1
            if eng.pool is not None:
                eng.pool.observe_step()
            continue

        # one decode step for the whole pool
        toks = np.zeros((eng.slots,), np.int32)
        pos = np.zeros((eng.slots,), np.int32)
        for slot, st in active.items():
            toks[slot] = st["last"]
            pos[slot] = st["pos"]
        t_dec = clock()
        if eng.cache_impl == "paged":
            # the host's per-step bookkeeping overlaps the card's step;
            # sync_logits waits at the sampling boundary below
            logits = eng.decode_paged(toks, pos, sync=False)
        else:
            logits = eng.decode(toks, pos)
        steps += 1
        tel.counter("serve_steps_total").inc()
        decoded_tokens += len(active)
        tel.counter("serve_decoded_tokens_total").inc(len(active))
        occupied_slot_steps += len(active)
        if eng.pool is not None:
            eng.pool.observe_step()
            eng.pool.publish_telemetry(tel)
        logits = eng.sync_logits(logits)
        decode_wall_s += clock() - t_dec
        nxt = sample(logits, temperature, rng)
        done = []
        for slot, st in list(active.items()):
            st["last"] = int(nxt[slot])
            st["out"].append(st["last"])
            st["pos"] += 1
            if on_token is not None:
                on_token(st["rid"], st["last"], steps)
            if len(st["out"]) >= gen:
                outputs[st["rid"]] = st["out"]
                finish(st["rid"], FINISHED)
                done.append(slot)
        for slot in done:
            del active[slot]
            reserved.pop(slot, None)
            eng.release(slot)
        if invariant_checks_enabled() and eng.pool is not None:
            eng.pool.assert_invariants()

    dt = clock() - t0
    stats = dict(
        steps=steps, wall_s=dt,
        tok_s=decoded_tokens / dt if dt > 0 else 0.0,
        decode_tok_s=(decoded_tokens / decode_wall_s
                      if decode_wall_s > 0 else 0.0),
        decode_wall_s=decode_wall_s,
        slot_occupancy=occupied_slot_steps / max(steps * eng.slots, 1),
        preemptions=0,
        shed=0,
        terminal=dict(terminal),
        statuses=statuses,
        prefix_hit_tokens=prefix_hit_tokens,
        cache_bytes=eng.kv_cache_bytes(),
        cache_bytes_per_token=eng.kv_cache_bytes() / max(eng.kv_capacity_tokens(), 1),
        phases=tel.phase_seconds(),
        telemetry=tel,
    )
    if eng.pool is not None:
        stats["page_utilization"] = eng.pool.mean_utilization()
        stats["prefix"] = eng.pool.prefix_stats()
    if not quiet:
        print(f"[serve:bucketed:{eng.cache_impl}:{eng.device}] {requests} "
              f"requests, {steps} decode steps, {stats['tok_s']:.1f} tok/s "
              f"e2e ({stats['decode_tok_s']:.1f} decode-only), occupancy "
              f"{stats['slot_occupancy']:.2f}, {prefix_hit_tokens} prefix "
              f"hit tokens, cache {stats['cache_bytes'] / 1e6:.2f} MB "
              f"({stats['cache_bytes_per_token']:.0f} B/token capacity)")
    return outputs, stats


def run_continuous(eng: Engine, queue: List[np.ndarray], *, gen: int,
                   temperature: float = 0.0, seed: int = 0,
                   quiet: bool = False, arrivals=None, chunk: int = 4,
                   on_token=None, deadline_steps: Optional[int] = None,
                   deadline_s: Optional[float] = None,
                   max_tokens: Optional[int] = None,
                   max_queue: Optional[int] = None,
                   watermark_high: float = 1.0, watermark_low: float = 0.75,
                   control=None):
    """Continuous-batching loop: chunked prefill, mid-flight joins,
    preemption, per-step streaming.  Returns (outputs, stats); the
    keyword arguments are documented on :func:`run`."""
    if eng.cache_impl != "paged":
        raise ValueError(
            "the continuous scheduler drives the paged engine; rerun with "
            "cache_impl='paged' (dense caches use scheduler='bucketed')")
    rng = np.random.default_rng(seed)

    def sample_row(row: np.ndarray) -> int:
        return int(sample(row[None], temperature, rng)[0])

    sched = ContinuousScheduler(eng, chunk=chunk, sample=sample_row,
                                on_token=on_token, control=control,
                                max_tokens=max_tokens, max_queue=max_queue,
                                watermark_high=watermark_high,
                                watermark_low=watermark_low)
    for i, prompt in enumerate(queue):
        sched.add(Request(
            rid=i, prompt=np.asarray(prompt), gen=gen,
            arrival=0 if arrivals is None else int(arrivals[i]),
            deadline_steps=deadline_steps, deadline_s=deadline_s,
        ))
    tel = sched.tel
    t0 = tel.clock()
    outputs = sched.run()
    dt = tel.clock() - t0
    stats = dict(
        steps=sched.steps, wall_s=dt,
        tok_s=sched.decoded_tokens / dt if dt > 0 else 0.0,
        decode_tok_s=(sched.decode_step_tokens / sched.decode_wall_s
                      if sched.decode_wall_s > 0 else 0.0),
        decode_wall_s=sched.decode_wall_s,
        prefill_wall_s=sched.prefill_wall_s,
        prefill_tokens=sched.prefill_tokens,
        prefix_hit_tokens=sched.prefix_hit_tokens,
        prefix=eng.pool.prefix_stats(),
        slot_occupancy=sched.occupied_slot_steps / max(sched.steps * eng.slots, 1),
        mean_latency_steps=sched.mean_latency_steps(),
        preemptions=sched.preemptions,
        restores=sched.restores,
        shed=sched.shed,
        admission_pauses=sched.admission_pauses,
        terminal=dict(sched.terminal_counts),
        statuses=sched.statuses(),
        requests=sched.request_traces(),
        page_utilization=eng.pool.mean_utilization(),
        cache_bytes=eng.kv_cache_bytes(),
        cache_bytes_per_token=eng.kv_cache_bytes() / max(eng.kv_capacity_tokens(), 1),
        phases=tel.phase_seconds(),
        telemetry=tel,
    )
    if not quiet:
        print(f"[serve:continuous:{eng.device}] {len(queue)} requests, "
              f"{sched.steps} steps, {stats['tok_s']:.1f} tok/s e2e "
              f"({stats['decode_tok_s']:.1f} decode-only), occupancy "
              f"{stats['slot_occupancy']:.2f}, {sched.preemptions} "
              f"preemptions, {sched.restores} restores, "
              f"{sched.prefix_hit_tokens} prefix hit tokens, cache "
              f"{stats['cache_bytes'] / 1e6:.2f} MB "
              f"({stats['cache_bytes_per_token']:.0f} B/token capacity)")
    return outputs, stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve random prompts through the paged LNS engine "
                    "(PyTorch/CUDA port).",
        epilog="Schedulers: 'continuous' (chunked prefill, mid-flight "
               "joins, preemption with page spill/restore when --pages is "
               "below the worst case; paged cache only) or 'bucketed' "
               "(batched length-bucket prefills, worst-case page "
               "reservation; paged or dense cache).  With --prefix-cache "
               "on, requests that share a prompt prefix map its cached "
               "pages and prefill only their tails.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default=None,
                    help="named numerics policy preset (e.g. "
                         "serve_fp8_paged for the FP8 KV cache; default: "
                         "none, float KV pages of the model's dtype)")
    ap.add_argument("--quant", default=None,
                    help="DEPRECATED alias for --policy; legacy flat "
                         "quant flag, mapped through the legacy "
                         "QuantConfig fields")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "bucketed"],
                    help="admission policy (default: continuous)")
    ap.add_argument("--cache-impl", default="paged",
                    choices=["paged", "dense"])
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="page-pool size (0 = worst-case slots*max_seq)")
    ap.add_argument("--prefix-cache", default="off", choices=["on", "off"],
                    help="ref-counted prefix caching: requests sharing a "
                         "prompt prefix reuse its KV pages and prefill "
                         "only the uncached tail; token streams are "
                         "bit-identical to the cache off")
    ap.add_argument("--fused-decode", default="on", choices=["on", "off"],
                    help="fuse the token KV write into the paged decode "
                         "attention; token streams are bit-identical "
                         "either way")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", default="8",
                    help="prompt length, or a comma list cycled over the "
                         "requests (e.g. 4,12,8)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared tokens to every prompt "
                         "(a common system prompt; the prefix-cache "
                         "workload)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=4,
                    help="prefill tokens per step per slot (continuous; "
                         "bucketed with the prefix cache on)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="mean request arrivals per step (0 = all at "
                         "step 0)")
    ap.add_argument("--stream", action="store_true",
                    help="print each token the step it is sampled")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="per-request scheduler-step budget from arrival "
                         "(0 = unbounded); blown deadlines time the "
                         "request out individually")
    ap.add_argument("--max-tokens", type=int, default=0,
                    help="hard cap on any request's generation budget "
                         "(0 = uncapped)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound on arrived-but-unadmitted requests; "
                         "overflow is load-shed (0 = unbounded)")
    ap.add_argument("--watermark-high", type=float, default=1.0,
                    help="page-pool occupancy fraction that pauses new "
                         "admissions")
    ap.add_argument("--watermark-low", type=float, default=0.75,
                    help="occupancy fraction that resumes admissions")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition to PATH")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the phase spans")
    ap.add_argument("--profile-spans", action="store_true",
                    help="wrap each phase span in a "
                         "torch.profiler.record_function range so host "
                         "phases line up with device traces")
    args = ap.parse_args(argv)

    if args.policy is not None:
        if args.quant not in (None, "none"):
            ap.error("--policy and the deprecated --quant are exclusive")
        cfg = get_config(args.arch, smoke=args.smoke, policy=args.policy)
    else:
        quant = args.quant or "none"
        if quant != "none":
            print(f"# --quant {quant} is deprecated; use --policy (mapped "
                  "through the legacy QuantConfig fields)")
        cfg = get_config(args.arch, smoke=args.smoke, quant=quant)
    if args.scheduler == "continuous" and args.cache_impl == "dense":
        print("# continuous scheduling needs a paged cache; falling back "
              "to the bucketed scheduler")
        args.scheduler = "bucketed"
    prefix_on = args.prefix_cache == "on"
    if prefix_on and (args.cache_impl != "paged"
                      or not Engine.prefix_cache_supported(cfg)):
        print("# prefix caching needs a paged pure-GQA cache; ignoring "
              "--prefix-cache on")
        prefix_on = False
    plens = [int(s) for s in str(args.prompt_len).split(",") if s]
    max_seq = max(plens) + args.shared_prefix + args.gen
    eng = Engine(cfg, slots=args.slots, max_seq=max_seq,
                 cache_impl=args.cache_impl, page_size=args.page_size,
                 num_pages=args.pages or None,
                 rng_seed=args.seed, prefix_cache=prefix_on,
                 fused_decode=args.fused_decode == "on",
                 telemetry=Telemetry(profile=args.profile_spans),
                 device=args.device)
    rng = np.random.default_rng(args.seed)
    shared = (rng.integers(0, cfg.vocab, size=args.shared_prefix)
              if args.shared_prefix > 0 else None)
    queue = []
    for i in range(args.requests):
        tail = rng.integers(0, cfg.vocab, size=plens[i % len(plens)])
        queue.append(tail if shared is None
                     else np.concatenate([shared, tail]))
    arrivals = None
    if args.arrival_rate > 0:
        inter = rng.exponential(1.0 / args.arrival_rate, size=args.requests)
        arrivals = np.floor(np.cumsum(inter)).astype(int)
    on_token = None
    if args.stream:
        def on_token(rid, tok, step):
            print(f"  step{step:4d} req{rid}: {tok}")
    outputs, stats = run(
        eng, queue, gen=args.gen, temperature=args.temperature,
        seed=args.seed, scheduler=args.scheduler, arrivals=arrivals,
        chunk=args.chunk,
        on_token=on_token, deadline_steps=args.deadline_steps or None,
        max_tokens=args.max_tokens or None,
        max_queue=args.max_queue or None,
        watermark_high=args.watermark_high,
        watermark_low=args.watermark_low)
    for rid in sorted(outputs):
        print(f"  req{rid}: {outputs[rid][:10]}...")
    for rid, (state, reason) in sorted(stats["statuses"].items()):
        if state != "finished":
            print(f"  req{rid}: {state} ({reason})")
    if args.metrics_out:
        _atomic_write(args.metrics_out, eng.tel.to_prometheus())
        print(f"# metrics -> {args.metrics_out}")
    if args.trace_out:
        eng.tel.write_chrome_trace(args.trace_out)
        print(f"# trace -> {args.trace_out}")
    return outputs


if __name__ == "__main__":
    main()
