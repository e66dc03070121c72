"""Serving entry point of the port: the paged Engine under the continuous
scheduler.

Port of ``repro.launch.serve`` for its main path: ``Engine`` with the paged
cache (float pages of the model's dtype by default, FP8 pages under a
policy that quantizes the KV cache, e.g. ``serve_fp8_paged``), fused or
unfused decode, block tables uploaded at most once per mutating step,
preemption (a slot's pages copied verbatim to the host and restored into
fresh pages, bit for bit), ref-counted prefix caching (requests that share
a prompt prefix map its registered pages read-only and prefill only their
tails, token streams bitwise equal to the cache off); ``sample``;
``run_continuous``; and the CLI.
Every token, prefill or decode, is a single-token sub-step of
``Model.step_paged``, whose attention layers launch the hand-written CUDA
kernel K1 (``kernels/paged_attention.py``: its float instance on float
pages, its LNS instance on FP8 pages).

The engine runs on the card unless the caller passes ``device="cpu"``
(the tests), and raises when no GPU is present — there is no silent CPU
fallback.  The bucketed scheduler, the dense cache, chaos, snapshots,
tensor parallelism and static FP8 weights arrive with later slices and
raise ``NotImplementedError`` here.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 6 \\
        --slots 2 --gen 16 --prompt-len 4,12,8
    python -m repro_torch.launch.serve --arch gemma3-12b --prefix-cache on \\
        --shared-prefix 64
"""
from __future__ import annotations

import argparse
import hashlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import numerics
from ..configs import get_config
from ..core import prng
from ..models import Model
from ..serving import ContinuousScheduler, PagePool, Request
from ..serving.telemetry import Telemetry, _atomic_write

__all__ = ["Engine", "sample", "run_continuous", "main"]


def _later(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with a later slice of the "
        "port (ROADMAP.md Queue 1 item 7)")


def _resolve_device(device) -> torch.device:
    """The engine's device; CUDA unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "to run the plain (non-kernel) versions on the CPU")
    return device


class Engine:
    # The token-write PRNG stream; the attention layers fold each slot's
    # write position into it, so page codes are a pure function of
    # (tokens, position, layer), as in the reference.
    _STREAM_TOKEN_WRITE = 0

    def __init__(self, cfg, *, slots: int, max_seq: int,
                 cache_impl: str = "paged", page_size: int = 16,
                 num_pages: Optional[int] = None, rng_seed: int = 0,
                 stochastic_kv: Optional[bool] = None,
                 prefix_cache: bool = False, fused_decode: bool = True,
                 telemetry: Optional[Telemetry] = None,
                 device="cuda"):
        if cache_impl != "paged":
            raise _later(f"cache_impl={cache_impl!r}")
        if prefix_cache and not self.prefix_cache_supported(cfg):
            raise ValueError(
                f"prefix caching needs a pure-GQA paged KV cache; "
                f"{cfg.name!r} (family={cfg.family!r}, "
                f"attn_impl={cfg.attn_impl!r}) keeps dense per-slot cache "
                "entries that cannot be shared between requests")
        self.device = _resolve_device(device)
        self.cfg = cfg
        # fused_decode=True runs each sub-step's KV write and attention as
        # one K1 launch; False writes then attends.  Token streams are
        # bit-identical either way.
        self.fused_decode = bool(fused_decode)
        self.tel = telemetry if telemetry is not None else Telemetry()
        self.model = Model(cfg, max_seq=max_seq)
        self.max_seq = max_seq
        self.slots = slots
        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.params = self.model.init(gen)
        # stochastic-rounding KV writes only matter for FP8 pages; the
        # policy's kv_write mode carries the default.  Host-side stream key
        # (the reference's fold_in(PRNGKey(seed + 17), 0)).
        if stochastic_kv is None:
            stochastic_kv = numerics.kv_stochastic(cfg.policy)
        self._token_key = (
            prng.fold_in(prng.prng_key(rng_seed + 17),
                         self._STREAM_TOKEN_WRITE)
            if stochastic_kv else None)
        self.prefix_cache = bool(prefix_cache)
        self._slot_hash = {}        # slot -> its prompt's page hashes
        self._slot_registered = {}  # slot -> pages published so far
        # chain root of the token-chunk hashes: pages are valid across
        # requests that share the parameters' seed, numerics and page size
        desc = f"{cfg.name}|{rng_seed}|{page_size}|" + cfg.policy.to_json()
        self._prefix_root = hashlib.sha256(desc.encode()).digest()
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
            self.tel.counter("serve_substeps_total").inc(toks.shape[1])
            out = logits[:, : self.cfg.vocab]
        if not sync:
            return out
        return self.sync_logits(out)

    def release(self, slot: int) -> None:
        self.pool.free_slot(slot)
        self._slot_hash.pop(slot, None)
        self._slot_registered.pop(slot, None)

    def kv_cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    def kv_capacity_tokens(self) -> int:
        return (self.pool.num_pages - 1) * self.page_size


def sample(logits: np.ndarray, temperature: float, rng: np.random.Generator):
    if temperature <= 0:
        return logits.argmax(-1)
    z = logits / temperature
    z = z - z.max(-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(-1, keepdims=True)
    return np.array([rng.choice(len(row), p=row) for row in p])


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
    per-step streaming.  Returns (outputs, stats)."""
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
                    "(PyTorch/CUDA port; continuous scheduler).",
        epilog="The continuous scheduler admits with chunked prefill, "
               "joins requests mid-flight and preempts (page spill/restore) "
               "when --pages is below the worst case; with --prefix-cache "
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
                    help="prefill tokens per step per slot")
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
    prefix_on = args.prefix_cache == "on"
    if prefix_on and not Engine.prefix_cache_supported(cfg):
        print("# prefix caching needs a paged pure-GQA cache; ignoring "
              "--prefix-cache on")
        prefix_on = False
    plens = [int(s) for s in str(args.prompt_len).split(",") if s]
    max_seq = max(plens) + args.shared_prefix + args.gen
    eng = Engine(cfg, slots=args.slots, max_seq=max_seq,
                 page_size=args.page_size, num_pages=args.pages or None,
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
    outputs, stats = run_continuous(
        eng, queue, gen=args.gen, temperature=args.temperature,
        seed=args.seed, arrivals=arrivals, chunk=args.chunk,
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
