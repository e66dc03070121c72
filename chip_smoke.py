#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root (it imports ``src/repro_torch``; it imports
nothing of JAX or of the JAX package) and needs one CUDA device and
``nvcc``.  Every comparison on the card runs with TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False).  In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together): K1 from
   ``paged_attention.cu``, K2, K3 and K4 from ``lns_matmul.cu``, K5 from
   ``fp8_elementwise.cu``, K6 from ``flash_attention.cu``; and checks with
   ``cuobjdump`` that every instantiation of K2, of K3 and of K6's bf16
   body holds HMMA (tensor-core) instructions;
3. holds kernel K1 (LNS paged decode attention, one launch per call that
   reads only the admissible pages and combines on the chip) against its
   plain PyTorch version (the per-page partials and their combine) at the
   attention geometries of qwen2-0.5b (KV 2, G 7, hd 64), gemma3-12b (KV
   8, G 2, hd 256), gemma2-27b (KV 16, G 2, hd 128) and qwen3-14b (KV 8,
   G 5, hd 128), each with B=8, page 16, up to 64 pages per slot, ragged
   lengths, masked lanes, fresh-page rows, e5m2 pages, stochastic writes
   (and, past qwen2's, window 32 with softcap 50): new pages and scales
   bitwise, output within
   rtol = atol = 1e-4 (float32 sums over hd, page rows and pages in
   another order, and the card's ``expf``), fused == unfused bitwise;
   slots of length 0 and a window that skips leading pages against the
   plain version, pages outside every slot's admissible range poisoned
   (output finite and bitwise unchanged), two calls bitwise equal; then
   times the kernel and the plain version beside the function's bound
   (its bytes in, and the attention written once);
4. holds K1's float instance against its plain version on the same
   geometries with float pages (bf16, float32, and bf16 with window 32 and
   softcap 50; a float32 query; the new rows in the pages' dtype): new
   pages bitwise, scales unchanged, output within rtol = atol = 1e-4,
   fused == unfused bitwise, and the cases of 3 on bf16 and float32
   pages; then times it on bf16 pages beside its byte bound (2-byte page
   elements) and the plain version;
5. serves requests of mixed prompt lengths through the full-width
   qwen2-0.5b Engine (policy serve_fp8_paged, continuous scheduler, random
   weights from a seed, a pool that never preempts) with fused decode on
   and off: every request must finish with finite logits, the K1 launch
   count must equal n_layers x sub-steps, and the token streams of the two
   runs must be bitwise equal; a float32 copy of the model must give the
   same first-step logits (rtol = atol = 1e-3) through K1 and through the
   plain attention;
6. traces a short window of that path with ``torch.profiler`` (card
   busy share, launches per sub-step, the kernels that take the time);
7. the same under the default policy (the serve CLI's default: float KV
   pages of the model's dtype, bf16): the same 8 requests fused on and
   off, bitwise equal streams, K1's float instance launched n_layers x
   sub-steps times and its LNS instance never, the float32 copy's
   logits through K1 and through the plain attention;
8. traces that path as in 6;
9. preemption at full width, under serve_fp8_paged and under the default
   policy: the same 8 requests on weights redrawn at std 0.5 from a seed
   (so that greedy streams follow the context), once with a worst-case
   pool and once with 15 pages, where the scheduler spills slots to the
   host and restores them into fresh pages (at least one preemption and
   one restore): the token streams must be bitwise equal;
10. this slice's main path: full-width, full-depth gemma3-12b (48 layers,
    5 local layers of window 1,024 to each global one, qk-norm, hd 256,
    about 23.6 GB of bf16 weights drawn on the card and redrawn as in 9,
    the embedding at 0.5 / sqrt(d_model), the sandwich norms' output
    gains 16 times larger so that the layers, not the last token's own
    row, lead the tied LM head) served by a 4-slot Engine, page 16,
    worst-case pool: 8 requests of one shared 64-token prefix and their
    own tails, 16 generated tokens, under serve_fp8_paged and the default
    policy, three times each (prefix cache off with fused decode, on with
    fused decode, on unfused): the three token streams bitwise equal,
    every stream varied (at least two distinct tokens), at least 256
    prefix hit tokens with the cache on, K1 launched n_layers x sub-steps
    times and its other instance never;
11. preemption while shared: the same requests at depth 6 (the main
    path's first 6 layers), prefix on, both policies, with a worst-case
    pool and with 18 pages, where spilled slots keep their registered
    prefix pages under pins (at least one spill pins a page); the pool's
    invariants after every step, the token streams bitwise equal and
    varied;
12. fault-tolerant serving (``runtime.fault.run_serving``, this slice's
    path): the same 8 requests at full width and depth on FP8 pages
    (serve_fp8_paged, stochastic KV writes), prefix on, a pool of 18
    pages, under a seeded fault plan (page exhaustion, preemption storms,
    refcount-corruption drills, watchdog overruns) with a snapshot every
    8 steps, deadlines and a bounded queue, and one kill at step 28,
    restored into a freshly built engine from the snapshot of step 24,
    which holds a PREEMPTED request: every fault kind injected, one
    restart, every FINISHED stream bitwise equal to 10's and varied, the
    shed and expired requests terminal, the pool clean after the
    seizures' release, K1 launched n_layers x the sub-steps of both
    engines, the successor's first K1 calls (on restored pages) within
    rtol = atol = 1e-4 of the plain version; then at depth 6 on bf16
    pages a snapshot round trip while a request is PREEMPTED (every cache
    and spill tensor bitwise equal after a load into a fresh engine) and
    the same chaos run, its survivors bitwise equal to 11's; printed: the
    snapshot's bytes on disk, save and restore seconds, the chaos run's
    wall against the fault-free run's, the fault and terminal counts and
    the peak memory;
13. the bucketed scheduler at full width: gemma3-12b on the main path's
    weights, the same 8 requests on 4 slots, under serve_fp8_paged and
    the default policy; at full depth (8 generated tokens) on the dense
    cache (its bytes from its layout) and on the paged cache (each
    batched prefill's rows spliced into pages: a page's pow2 scale from
    its whole content, the codes rescaled by the paper's integer-add
    multiply) fused, unfused and fused again with every K1 call held to
    its plain version on the same inputs (rtol = atol = 1e-4); at depth 6
    (16 generated) with the prefix cache on (every admission prefills its
    tail through ``tail_prefill``) and off, and on FP8 pages a continuous
    and a bucketed run with deterministic KV writes.  Bitwise, on varied
    streams: fused == unfused == the second run, and prefix on == 11's
    continuous streams; printed: the share of equal tokens and the first
    divergence of dense vs paged, prefix on vs off, and continuous vs
    bucketed; K1 launched n_layers x sub-steps, never on the dense cache;
14. the logits behind 13's printed agreements, at depth 6 in float32:
    the first decode step after a bucketed prefill on the dense cache,
    after one on the paged cache and after a continuous (sub-step)
    prefill, within rtol = atol = 1e-3 on float32 pages, printed on FP8
    pages;
15. static FP8 weights at full width and depth: ``Engine(static_weights=
    True)`` under serve_fp8_paged, continuous, on the main path's weights
    as E4M3 codes (each matmul decodes its weight to bf16 first), against
    an Engine on the decoded bf16 weights: token streams bitwise equal
    and varied; the weight bytes on the card, the peak memory, both walls
    and the card time of decoding one layer's weights;
16. static weights through K2 and K3 (depth 6, policies with every
    matmul quantized to E4M3 under ``fused_dequant`` and ``lns``), under
    the bucketed scheduler and, for K2, the continuous one, on varied
    streams: every K2/K3 call within 2 sqrt(K) 2^-24 sum|products| of its
    plain version on the model's own codes (the rounding of two float32
    sums of the same products), 7 x n_layers launches per model call of
    the kernel under test and none of the other; each kernel's card time on one
    layer's weights at M = 4 (decode) and M = 32 (the bucketed prefill)
    beside the bound, the plain version and, for K2, ``torch.matmul`` on
    decoded bf16;
17. windows on the model path: gemma3-12b at full width, depth 6,
    float32, on FP8 and on float32 pages: a 1,040-token prompt prefilled
    through K1 (from the 1,024th token on every K1 call held to its plain
    version on the model's own inputs at rtol = atol = 1e-4), then from
    that cache the last prompt token (the local window of 1,024 skips
    page 0) and one decode step through K1 and through the plain
    attention: logits within rtol = atol = 1e-3 on float32 pages, printed
    on FP8 pages (``_gate_logits``: there a code at a rounding boundary
    flips on a ~1e-6 difference and moves the logits by ~1e-3);
18. gemma2-27b (one local and one global layer: softcaps 50 and 30) and
    qwen3-14b at full width, depth 2: float32 logits through K1 (each K1
    call held to its plain version as in 17) and the plain attention, as
    in 17 on both page kinds, and 4 requests on bf16 pages with fused
    decode on and off, bitwise equal;
19. K5 (the paper's six FP8 operations): every one of the 69 supported
    (format, op, mode) cells over all 256 codes or 65,536 code pairs
    bitwise against the plain version, and the paper's claim on the card:
    on the exact rounding oracle's valid domain K5's codes are correctly
    rounded (faithful for ``faithful``) in 69/69 cells; random codes at
    the serving (8 x 4864) and training (8 x 128 x 4864) gate shapes and
    a misaligned ragged view, bitwise; card time of e5m2 mul at both
    shapes beside the bytes bound, the plain version and the compiled
    instruction count (SASS);
20. serves full-width qwen2-0.5b again with the SwiGLU gate product
    through K5 (serve_fp8_paged with elementwise e5m2; 4 requests, fused
    on and off): K5 launches = K1 launches = n_layers x sub-steps, fused
    == unfused token streams; a float32 copy's first-step logits through
    K5 and through the plain version bitwise equal; a profile of that
    path (launches per sub-step);
21. K3 (the paper's LNS matmul): all 65,536 products of every (format,
    mode) pair bitwise equal to the plain version (NaN as NaN); then K3
    (e4m3 RNE, and e5m2 ``ru``, whose planes carry x's sign) and K2 (e5m2
    x e4m3, bf16 and float32 compute) against their plain versions at the
    training path's shapes (M = 1024 tokens, every (K, N) of a qwen2-0.5b
    layer), each element within the float32 summation bound 2 K 2^-24
    sum|products|; then their card times per layer (the seven quantized
    matmuls of one layer's forward) beside the bound, the plain version
    and, for K2, ``torch.matmul`` on pre-decoded bf16 operands; K2's and
    K3's time and TFLOP/s at each shape (K3's both of the function, 2 M K
    N, and of its R planes), and beside K3 the same-shape bf16
    ``torch.matmul`` [M, R K] x [R K, N] as a yardstick of the GEMM's
    shape (no PyTorch call computes LNS products, so K3 has no library
    time).  K3's bound is the function's, whatever implements it: the
    larger of its bytes over the memory rate and its 2 M K N operations
    over the dense 8-bit tensor rate; the integer route's floor and the
    plane GEMM's dense bf16 time are printed beside it;
22. trains full-width qwen2-0.5b through the port's CLI
    (``launch.train.main``, ``--quant fp8_lns_pallas``, batch 8 x seq 128,
    6 steps, checkpoints every 3): finite losses, 0 restarts, and K3
    launches = 2 (forward and checkpointed recompute) x 7 matmuls x 24
    layers x 6 steps; then 3 steps under policy ``train_fp8`` with the K2
    count derived the same way; then the first step's loss and gradient
    norm of a float32 2-layer model through the kernels and through their
    plain versions (loss rtol 1e-4, gradient norm rtol 1e-3), for K3 and
    K2; then one profiled train step under each of the two policies
    (wall, card-busy share, K3's and K2's card time);
23. trains 2 full-width steps under train_fp8_lns with the gate through
    K5 in e4m3 (``run_training``): finite losses, 0 restarts, 672 K3 and
    96 K5 launches (forward and recompute); then the first step of a
    float32 2-layer model through K5 and through the plain version (loss
    rtol 1e-4, gradient norm rtol 1e-3); then one profiled train step
    under that policy;
24. K6 (flash attention) against its plain version: the CPU tests' cases
    (float32 at rtol = atol = 1e-4, bfloat16 within one bf16 ulp), the
    rows without an admissible key (sum(v) / padded key length), every
    candidate tiling of ``flash_blocks``, and the attention geometries of
    qwen2-0.5b (B 8 x S 128, also against ``chunked_attention``;
    B 1 x S 8192), gemma2-27b (S 8192, window 4096, cap 50), gemma3-12b
    (S 4096, hd 256, window 1024) and deepseek-v2-lite (S 4096, hd 192,
    dv 128) at full width, each in float32 and in bfloat16 (bfloat16:
    one ulp, or 1e-5 near 0); then K6's times at qwen2-0.5b
    B 1 x S 8192 bf16 beside its bound, the plain version and
    ``scaled_dot_product_attention`` (a yardstick the port never calls),
    the same geometry in float32 and gemma2-27b's windowed geometry in
    bf16, each with its TFLOP/s and the FLOP of the tiles it visits;
25. K6's path: ``flash_attention`` with no tiling through the autotuner
    on a fresh cache file (qwen2-0.5b geometry, S 2048, bf16): measured
    in bf16, cached under the card's name and ``bf16``, a ``measured``
    gauge; a second call answers
    ``cached``, launches once and is bitwise equal to the pinned tiling
    and within tolerance of the plain version;
26. K4 (the seed LNS matmul) bitwise against its plain version at 512^3
    and at the seven matmul shapes of one qwen2-0.5b layer at M = 1024
    (the narrow ones split over k tiles), two calls bitwise equal; its
    time per layer (its kernel and, where it splits, the launch that adds
    the tiles' sums) beside K3's, the plain version and the bound (K3's:
    both compute one function), its own SASS instructions per product
    (per FFMA), its shared loads per product and the floor they set, and
    K4 / K3 at 512^3;
27. K4's path: 2 full-width train steps under train_fp8_lns with every
    matmul through K4 (``run_training``): finite losses, 0 restarts, 672
    K4 launches and no K3 or K2; then the first step of a float32 2-layer
    model through K4 and through its plain version (loss rtol 1e-4,
    gradient norm rtol 1e-3);
28. prints one JSON line of per-kernel numbers, then the card line again,
    and last ``{"ok": true, "device": {...}}``.

K1's numbers in the ``kernels`` line are those of gemma3-12b's geometry
(KV 8, G 2, hd 256), its launches those of the main path's prefix-on
fused run under serve_fp8_paged (K1's float instance: under the default
policy); qwen2-0.5b's are printed beside them as before.  The
``dequant_matmul_static_weights`` and ``lns_matmul_static_weights``
entries are K2 and K3 on static weights: card time per gemma3-12b layer
(its seven matmuls) at M = 4, launches those of phase 16, the largest
difference from the plain version on the model's codes.
K1's ``ms`` and ``plain_ms`` are card time per call from the profiler
(the kernel alone; all kernels of the plain version, partials and
combine), or from CUDA-graph
replays timed with events where the profiler records no device time; the
comment lines also give the per-call time between CUDA events with the
host's launch overhead included.  The same holds for K1's float instance
(``float_paged_partials``, on bf16 pages).  K2's and K3's numbers are card time per
layer: the sum over one layer's seven matmul shapes at M = 1024.  K5's
are those of e5m2 mul at the training gate shape (4,980,736 codes), its
launches those of the K5 serving run; its ``max_abs_err`` is in code
units (0: bitwise).  K4's numbers are per layer like K3's, its launches
those of its training run, its ``max_abs_err`` 0 (bitwise, checked).
K6 has no model path (no model calls it, as in the reference): its
launches are those of its path through the autotuner (phase 25,
measurement included), its times those of qwen2-0.5b B 1 x S 8192 bf16,
and its ``max_abs_err`` the largest float32 difference from the plain
version in phase 23.

Any failed check raises, so the script exits non-zero and prints no result
line; it also exits non-zero without a GPU, or when run outside the repo.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
KERNEL_SOURCES = ("paged_attention", "lns_matmul", "fp8_elementwise",
                  "flash_attention")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Wall time per call between CUDA events: includes the host's
    launch overhead when the host, not the card, is the limit."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    return getattr(evt, "device_time_total", None) or getattr(
        evt, "cuda_time_total", 0.0)


def graph_ms(fn, launches: int = 50, replays: int = 10) -> float:
    """Time per call between CUDA events over replays of a CUDA graph of
    ``launches`` calls: no host launch overhead between the kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def device_ms(fn, iters: int, only: str = "", warmup: int = 3):
    """Card time per call: the summed device time of the CUDA kernels
    (whose names contain ``only``, if given) that ``iters`` calls ran,
    from ``torch.profiler``; where the profiler records no device time,
    or, when ``only`` picks kernels, a count of them that is no multiple
    of ``iters`` (late in a long process it has reported a tenth of a
    kernel's time, as if it had dropped launches), the CUDA-graph event
    timing of :func:`graph_ms`.  Returns (ms, how)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages()
            if only in e.key and _device_us(e) > 0]
    us = sum(_device_us(e) for e in seen)
    if us > 0 and not (only and sum(e.count for e in seen) % iters):
        return us / iters / 1e3, "profiler"
    return graph_ms(fn), "cuda-graph events"


# K1's attention geometries: (model, KV heads, query heads a KV head, hd).
# qwen2-0.5b's is the one of PRs 11-21; gemma3-12b's is this slice's main
# path's, at which K1 is timed for the kernels line.
K1_GEOMETRIES = (("qwen2-0.5b", 2, 7, 64), ("gemma3-12b", 8, 2, 256),
                 ("gemma2-27b", 16, 2, 128), ("qwen3-14b", 8, 5, 128))
K1_TIMED = ("qwen2-0.5b", "gemma3-12b")
K1_MAIN = "gemma3-12b"


def k1_inputs(dev, seed: int = 0, KV: int = 2, G: int = 7, hd: int = 64):
    """One decode sub-step of attention: 8 slots, page 16, up to 64 pages
    a slot, at the geometry (KV, G, hd) (qwen2-0.5b's by default)."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.quant import encode
    from repro_torch.serving.page_pool import kv_noise

    g = torch.Generator(device="cpu").manual_seed(seed)
    B, page, maxp = 8, 16, 64
    P = B * maxp + 1
    bt = (torch.randperm(P - 1, generator=g) + 1).reshape(B, maxp)
    # ragged pre-write lengths: short, long, page-aligned (fresh-page
    # writes into row 0), the last row of the last page
    lengths = torch.tensor([0, 5, 16, 100, 255, 512, 777, maxp * page - 1])
    mask = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.bool)
    kf = torch.randn((P, page, KV, hd), generator=g)
    vf = torch.randn((P, page, KV, hd), generator=g)
    keys = prng.fold_in(prng.split(prng.prng_key(seed), 2)[:, None, :],
                        lengths[None, :])                   # [2, B, 2]
    noise = kv_noise(keys, (KV, hd), "e5m2")
    return dict(
        q=torch.randn((B, 1, KV * G, hd), generator=g).to(dev),
        k_new=(torch.randn((B, KV, hd), generator=g) * 3).to(dev),
        v_new=(torch.randn((B, KV, hd), generator=g) * 3).to(dev),
        kp=encode(kf, "e5m2").to(dev), vp=encode(vf, "e5m2").to(dev),
        ks=(2.0 ** torch.randint(-2, 3, (P,), generator=g)).float().to(dev),
        vs=(2.0 ** torch.randint(-2, 3, (P,), generator=g)).float().to(dev),
        bt=bt.to(torch.int32).to(dev), lengths=lengths.to(torch.int32).to(dev),
        mask=mask.to(dev), k_noise=noise[0].to(dev), v_noise=noise[1].to(dev),
        KV=KV, G=G, hd=hd, page=page, maxp=maxp, B=B, fmt="e5m2")


def k1_float_inputs(dev, pdt, seed: int = 0, **geo):
    """``k1_inputs``' geometry, lengths and mask with float pages of
    ``pdt`` and the new K/V rows in that dtype (as the model writes them);
    the query stays float32, and float pages draw no noise."""
    import torch

    c = k1_inputs(dev, seed, **geo)
    g = torch.Generator(device="cpu").manual_seed(seed + 7)
    for name in ("kp", "vp"):
        c[name] = torch.randn(c[name].shape, generator=g).to(dev, pdt)
    for name in ("k_new", "v_new"):
        c[name] = c[name].to(pdt)
    c.update(fmt=None, k_noise=None, v_noise=None)
    return c


def fused(c, impl, window=0, cap=0.0):
    from repro_torch.kernels.paged_attention import fused_decode_write_attend

    kp, vp, ks, vs = (c[n].clone() for n in ("kp", "vp", "ks", "vs"))
    return fused_decode_write_attend(
        c["q"], c["k_new"], c["v_new"], kp, vp, ks, vs, c["bt"],
        c["lengths"], fmt=c["fmt"], n_kv_heads=c["KV"], kv_mode="stochastic",
        k_noise=c["k_noise"], v_noise=c["v_noise"], write_mask=c["mask"],
        window=window, cap=cap, impl=impl)


def unfused(c, window=0, cap=0.0):
    import torch
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.serving.page_pool import write_token_page

    kp, vp, ks, vs = (c[n].clone() for n in ("kp", "vp", "ks", "vs"))
    logical = torch.div(c["lengths"], c["page"], rounding_mode="floor")
    rows = c["lengths"] - logical * c["page"]
    pids = c["bt"].gather(1, logical[:, None].long())[:, 0]
    write_token_page(kp, ks, c["k_new"], pids, rows, fmt=c["fmt"],
                     noise=c["k_noise"], write_mask=c["mask"])
    write_token_page(vp, vs, c["v_new"], pids, rows, fmt=c["fmt"],
                     noise=c["v_noise"], write_mask=c["mask"])
    out = paged_decode_attention(c["q"], kp, vp, ks, vs, c["bt"],
                                 c["lengths"] + 1, fmt=c["fmt"],
                                 n_kv_heads=c["KV"], window=window, cap=cap)
    return out, kp, ks, vp, vs


def _partials_note(bytes_in, B, maxp, KV, G, dv) -> str:
    """The bound a design that writes per-page partials would have had
    (the parent's): information only, never the bound."""
    partials = 4 * B * maxp * KV * G * (2 + dv)      # m, l, o per page
    return (f"with per-page partials written ({partials} B) it would read "
            f"{(bytes_in + partials) / HBM_BYTES_PER_S * 1e3:.6f} ms "
            "(information, not the bound)")


def check_k1_edges(c, label: str) -> float:
    """The cases that reading only the admissible pages must get right,
    through ``paged_decode_attention`` on ``c``'s pool (FP8 or float
    pages), each call one launch: slots of length 0 (the reference reads
    every page with every position masked: the mean of all V rows) and a
    window of 32 that skips leading pages, against the plain version at
    rtol = atol = 1e-4; pages outside every slot's admissible range
    poisoned (NaN on float pages, random codes on FP8 pages, NaN/inf codes
    among them), with and without the window: a finite output bitwise
    equal to the clean pool's, so those pages are not read; and two calls
    on the same inputs bitwise equal.  Returns the largest |kernel -
    plain|."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    fmt, KV, page, maxp = c["fmt"], c["KV"], c["page"], c["maxp"]
    ln = c["lengths"] + 1                     # the attended lengths
    zero = ln.clone()
    zero[0] = zero[3] = 0
    count = "launches" if fmt else "float_launches"

    def attend(kp, vp, lengths, window, impl="auto"):
        return pa.paged_decode_attention(
            c["q"], kp, vp, c["ks"], c["vs"], c["bt"], lengths, fmt=fmt,
            n_kv_heads=KV, window=window, impl=impl)

    err = 0.0
    for lengths, window, what in ((zero, 0, "two slots of length 0"),
                                  (ln, 32, "window 32")):
        before = getattr(pa.paged_attend, count)
        got = attend(c["kp"], c["vp"], lengths, window)
        again = attend(c["kp"], c["vp"], lengths, window)
        want = attend(c["kp"], c["vp"], lengths, window, impl="ref")
        torch.cuda.synchronize()
        if getattr(pa.paged_attend, count) != before + 2:
            raise AssertionError(f"{label}: {what}: not one launch a call")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: {what}: non-finite output")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: {what}: two calls differ")
        err = max(err, float((got - want).abs().max()))
    g = torch.Generator(device="cpu").manual_seed(11)
    bt, lens = c["bt"].cpu(), ln.cpu()
    for window in (0, 32):
        kp, vp = c["kp"].clone(), c["vp"].clone()
        pids = []
        for b in range(bt.shape[0]):
            first, last = pa.admissible_pages(int(lens[b]), window, page,
                                              maxp)
            pids += [int(bt[b, j]) for j in range(maxp)
                     if not first <= j <= last]
        for t in (kp, vp):
            if fmt is None:
                t[pids] = float("nan")
            else:
                t[pids] = torch.randint(0, 256, t[pids].shape, generator=g,
                                        dtype=torch.uint8).to(t.device)
        clean = attend(c["kp"], c["vp"], ln, window)
        dirty = attend(kp, vp, ln, window)
        if not (torch.isfinite(dirty).all() and torch.equal(clean, dirty)):
            raise AssertionError(f"{label}: window {window}: poisoned pages "
                                 "outside the admissible range changed "
                                 "the output")
        print(f"# {label}: {len(pids)} pages outside the admissible ranges "
              f"poisoned (window {window}): output finite and unchanged",
              flush=True)
    print(f"# {label}: two slots of length 0 and window 32 within rtol = "
          f"atol = 1e-4 of the plain version (max |err| {err:.3e}), two "
          "calls bitwise equal", flush=True)
    return err


def _k1_fused_gates(c, label: str, window: int = 0, cap: float = 0.0):
    """K1's fused form against the plain version on ``c`` (FP8 pages):
    new pages and scales bitwise, output within rtol = atol = 1e-4, fused
    == unfused bitwise.  Returns the largest |kernel - plain|."""
    import torch

    act = c["mask"]
    kern, plain = fused(c, "auto", window, cap), fused(c, "ref", window, cap)
    torch.cuda.synchronize()
    for i, name in ((1, "k_pages"), (2, "k_scale"), (3, "v_pages"),
                    (4, "v_scale")):
        if not torch.equal(kern[i][1:], plain[i][1:]):
            raise AssertionError(f"{label}: new {name} differ from the "
                                 "plain version")
    out_k, out_p = kern[0][act], plain[0][act]
    if not torch.isfinite(out_k).all():
        raise AssertionError(f"{label}: non-finite attention output")
    err = float((out_k - out_p).abs().max())
    torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-4)
    unf = unfused(c, window, cap)
    if not torch.equal(kern[0][act], unf[0][act]):
        raise AssertionError(f"{label}: fused != unfused attention output")
    for i in (1, 2, 3, 4):
        if not torch.equal(kern[i][1:], unf[i][1:]):
            raise AssertionError(f"{label}: fused != unfused cache update")
    print(f"# {label} vs plain (window {window}, cap {cap}): pages/scales "
          f"bitwise, max |out err| {err:.3e}, fused == unfused bitwise",
          flush=True)
    return err


def _k1_bound(c, el: int, lns: bool):
    """K1's bound on ``c``'s inputs, the function's whatever computes it:
    the bytes it must move (each input read once: the query, the pages the
    lengths reach, their scales on FP8 pages, the block tables, lengths
    and inserted rows; its output, the attention [B, KV*G, dv] float32,
    written once) against its operations (per head and valid token: hd
    products and their sum, and dv p*v multiply-adds) at the float32
    rate.  ``el``: bytes of a page element.  Returns (ms, what bounds
    it, bytes in and out, operations, bytes in)."""
    B, KV, G, hd, page, maxp = (c[n] for n in
                                ("B", "KV", "G", "hd", "page", "maxp"))
    ln = c["lengths"] + 1
    pages_needed = int(((ln + page - 1) // page).sum())
    tokens = int(ln.sum())
    dv = c["vp"].shape[-1]
    if lns:
        q_bytes = B * KV * G * hd + 4 * B          # q codes, q scales
        extra = pages_needed * 4 * 2 + 2 * 256 * 2 * 4  # scales, tables
    else:
        q_bytes, extra = 4 * B * KV * G * hd, 0    # the float32 query
    bytes_in = (q_bytes + pages_needed * page * KV * (hd + dv) * el + extra
                + 4 * B * maxp + 4 * B             # block tables, lengths
                + B * KV * (hd + dv) * el + 3 * 4 * B)  # inserted rows
    nbytes = bytes_in + 4 * B * KV * G * dv        # + the attention
    ops = 2 * KV * G * tokens * (hd + dv)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_FLOP_PER_S * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations", nbytes,
            ops, bytes_in)


def _time_k1(c, label: str, lns: bool) -> dict:
    """Card time of K1 proper on the fused form's inputs as the serving
    path builds them (old pages, new scales, the new rows), of its plain
    version, and the bound."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.page_pool import token_row_codes

    ln = c["lengths"] + 1
    logical = torch.div(c["lengths"], c["page"], rounding_mode="floor")
    rows = c["lengths"] - logical * c["page"]
    if lns:
        codes, qs = pa.quantize_q(c["q"][:, 0], "e5m2")
        pids = c["bt"].gather(1, logical[:, None].long())[:, 0]
        scales, new_rows = [], []
        for name, new, noise in (("ks", "k_new", "k_noise"),
                                 ("vs", "v_new", "v_noise")):
            s = c[name].clone()
            pid, row, s_new = token_row_codes(s, c[new], pids, rows,
                                              fmt="e5m2", noise=c[noise],
                                              write_mask=c["mask"])
            s.index_put_((pid,), s_new)
            scales.append(s)
            new_rows.append(row)
        args = (codes, qs, c["kp"], c["vp"], *scales, c["bt"], ln)
        kw = dict(fmt="e5m2", mode="rne")
        only = "lns_paged_partials"
    else:
        q, _ = pa.query_operand(c["q"][:, 0], None)
        new_rows = [c["k_new"], c["v_new"]]
        args = (q, None, c["kp"], c["vp"], c["ks"], c["vs"], c["bt"], ln)
        kw = dict(fmt=None, mode="rne")
        only = "float_paged_partials"
    ins = (*new_rows, logical, rows, c["mask"].to(torch.int32))
    kw.update(KV=c["KV"], G=c["G"], inserts=ins)
    k1 = lambda: pa.paged_attend(*args, **kw)  # noqa: E731
    plain = lambda: pa._combine_partials(  # noqa: E731
        *pa.page_partials_plain(*args, **kw))
    torch.testing.assert_close(k1(), plain(), rtol=1e-4, atol=1e-4)
    ms, how = device_ms(k1, iters=200, only=only)
    plain_ms, plain_how = device_ms(plain, iters=10)
    call_ms, plain_call_ms = cuda_ms(k1, iters=200), cuda_ms(plain, iters=10)
    bound, by, nbytes, ops, bytes_in = _k1_bound(
        c, c["kp"].element_size(), lns)
    dv = c["vp"].shape[-1]
    print(f"# {label} card time ({how}): kernel {ms:.5f} ms; plain "
          f"{plain_ms:.4f} ms ({plain_how}, all its kernels); bound "
          f"{bound:.6f} ms = max({nbytes} B / 3.35 TB/s, {ops} ops / 67 "
          f"TFLOP/s), {ms / bound:.0f}x; per call incl. host: kernel "
          f"{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; "
          f"{_partials_note(bytes_in, c['B'], c['maxp'], c['KV'], c['G'], dv)}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def check_k1(dev) -> dict:
    """Phase 3: K1 against its plain version at every geometry of
    ``K1_GEOMETRIES`` (and, past qwen2-0.5b's, with window 32 and softcap
    50), the edge cases of :func:`check_k1_edges`, then its timings at the
    ``K1_TIMED`` geometries.  Returns the main path's (gemma3-12b's)
    timings and the largest error over all geometries."""
    err, timed = 0.0, {}
    for name, KV, G, hd in K1_GEOMETRIES:
        c = k1_inputs(dev, KV=KV, G=G, hd=hd)
        label = f"K1 {name} (KV {KV}, G {G}, hd {hd})"
        err = max(err, _k1_fused_gates(c, label))
        if name != "qwen2-0.5b":
            err = max(err, _k1_fused_gates(c, label, window=32, cap=50.0))
        err = max(err, check_k1_edges(c, label))
        if name in K1_TIMED:
            timed[name] = _time_k1(c, label, lns=True)
    return dict(max_abs_err=err, **timed[K1_MAIN])


FLOAT_K1_CASES = (("bfloat16", 0, 0.0), ("float32", 0, 0.0),
                  ("bfloat16", 32, 50.0))     # page dtype, window, softcap


def check_k1_float(dev) -> dict:
    """Phase: K1's float instance against its plain version at every
    geometry of ``K1_GEOMETRIES`` with float pages (bf16 and float32, and
    bf16 with window 32 and softcap 50): new pages bitwise, scales
    unchanged, output within rtol = atol = 1e-4, fused == unfused bitwise;
    then its times on bf16 pages (the serving path's) at the ``K1_TIMED``
    geometries beside the byte bound."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    err, timed = 0.0, {}
    for name, KV, G, hd in K1_GEOMETRIES:
        geo = dict(KV=KV, G=G, hd=hd)
        for pdt, window, cap in FLOAT_K1_CASES:
            c = k1_float_inputs(dev, getattr(torch, pdt), **geo)
            label = f"K1 float {name} ({pdt} pages)"
            act = c["mask"]
            before = pa.paged_attend.float_launches
            kern, plain = fused(c, "auto", window, cap), fused(c, "ref",
                                                                window, cap)
            torch.cuda.synchronize()
            if pa.paged_attend.float_launches != before + 1:
                raise AssertionError(f"{label}: the fused call did not "
                                     "launch the float instance once")
            for i, page_name in ((1, "k_pages"), (3, "v_pages")):
                if not torch.equal(kern[i][1:], plain[i][1:]):
                    raise AssertionError(f"{label}: new {page_name} differ "
                                         "from the plain version")
            for i, scale in ((2, "ks"), (4, "vs")):
                if not torch.equal(kern[i], c[scale]):
                    raise AssertionError(f"{label}: {scale} changed")
            out_k, out_p = kern[0][act], plain[0][act]
            if not torch.isfinite(out_k).all():
                raise AssertionError(f"{label}: non-finite attention output")
            case_err = float((out_k - out_p).abs().max())
            err = max(err, case_err)
            torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-4)
            unf = unfused(c, window, cap)
            if not torch.equal(kern[0][act], unf[0][act]):
                raise AssertionError(f"{label}: fused != unfused output")
            for i in (1, 2, 3, 4):
                if not torch.equal(kern[i][1:], unf[i][1:]):
                    raise AssertionError(f"{label}: fused != unfused cache "
                                         "update")
            print(f"# {label} vs plain (window {window}, cap {cap}): pages "
                  f"bitwise, scales unchanged, max |out err| {case_err:.3e}, "
                  "fused == unfused bitwise", flush=True)
            if not window:
                err = max(err, check_k1_edges(c, label))
        if name in K1_TIMED:
            c = k1_float_inputs(dev, torch.bfloat16, **geo)
            timed[name] = _time_k1(c, f"K1 float {name} (bf16 pages)",
                                   lns=False)
    return dict(max_abs_err=err, **timed[K1_MAIN])


SERVE_PLENS = (5, 17, 33, 64, 9, 48, 2, 26)   # the serving phases' prompts


def _policy_label(cfg, policy) -> str:
    return cfg.policy.name if policy is not None else "default policy " \
        f"({str(cfg.pdtype).split('.')[-1]} KV pages)"


def serve_main_path(dev, policy="serve_fp8_paged", plens=SERVE_PLENS,
                    gen=24) -> dict:
    """Phases 5, 7 and 15: the full-width Engine under the continuous
    scheduler, fused decode on and off.  K1 runs once per layer and
    sub-step, its LNS instance on FP8 pages, its float instance on float
    pages (``policy=None``, the CLI's default), the other instance never;
    K5 runs as often as K1 when the policy quantizes the SwiGLU gate
    product (else never)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import fp8_elementwise as fe
    from repro_torch.launch.serve import Engine

    cfg = get_config("qwen2-0.5b", policy=policy)
    k5_on = cfg.policy.elementwise.quantized
    label = _policy_label(cfg, policy)
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, size=n) for n in plens]
    runs = {}
    for fused_on in (True, False):
        eng = Engine(cfg, slots=8, max_seq=max(plens) + gen, page_size=16,
                     rng_seed=0, fused_decode=fused_on, device=dev)
        fe.fp8_elementwise.launches = 0
        run = _counted_run(eng, queue, gen)
        k5 = fe.fp8_elementwise.launches
        if k5 != (run["launches"] if k5_on else 0):
            raise AssertionError(f"K5 launches {k5}, want "
                                 f"{run['launches'] if k5_on else 0}")
        stats = run["stats"]
        print(f"# serve {label}"
              f"{' + K5 gate' if k5_on else ''} fused={fused_on}: "
              f"{len(queue)} requests finished, {stats['steps']} steps, "
              f"{run['substeps']} sub-steps, {run['lns']} K1 LNS, "
              f"{run['flt']} K1 float and {k5} K5 launches, "
              f"{run['wall']:.3f} s wall, "
              f"{stats['decode_tok_s']:.2f} decode tok/s, cache "
              f"{stats['cache_bytes_per_token']:.0f} B/token", flush=True)
        runs[fused_on] = (run["outputs"], run["launches"], k5)
        del eng
    if runs[True][0] != runs[False][0]:
        raise AssertionError("token streams differ with fused decode on/off")
    print("# token streams bitwise equal with fused decode on and off",
          flush=True)
    return dict(launches=runs[True][1], k5_launches=runs[True][2])


PREEMPT_PAGES = 16   # 15 usable pages against a worst case of 48


LIVELY_POST_GAIN = 16.0   # the sandwich norms' output gains, see _lively


def _lively(eng, seed: int = 0):
    """Redraw every parameter at std 0.5 from a seed, on the card, so that
    greedy tokens follow the context (the seed init's zero gains and 0.02
    weights repeat each prompt's last token), which makes equal token
    streams a sharp test.  Under an embedding scale (gemma) the embedding
    is redrawn at 0.5 / sqrt(d_model), so that it is 0.5 once scaled: at
    0.5 the scaled rows would drown every layer and greedy decoding would
    repeat each prompt's last token again.  Under sandwich norms (gemma)
    the norms' output gains 1 + s are then multiplied by
    ``LIVELY_POST_GAIN``: with gains near 1 the last token's own row (its
    scaled embedding in the residual) still leads the tied LM head at
    gemma3-12b's width, at depth 6 and at depth 48 alike, and most greedy
    streams hold a single token.  With each layer's output 16 times larger
    the embedding's share of the residual falls 16-fold and the layers
    lead; the final norm keeps the logits' scale, so the float32 logit
    gates keep their meaning."""
    import torch

    g = torch.Generator(device=eng.device).manual_seed(seed)

    def redraw(t):
        if isinstance(t, dict):
            return {k: redraw(v) for k, v in t.items()}
        if isinstance(t, list):
            return [redraw(v) for v in t]
        return (torch.randn(t.shape, generator=g, device=t.device)
                * 0.5).to(t.dtype)

    eng.params = redraw(eng.params)
    if eng.cfg.emb_scale:
        eng.params["embed"] = eng.params["embed"] / eng.cfg.d_model**0.5
    if eng.cfg.sandwich_norm:
        for layer in eng.params["blocks"]:
            for name in ("ln1_post", "ln2_post"):
                gain = (1.0 + layer[name].float()) * LIVELY_POST_GAIN
                layer[name] = (gain - 1.0).to(layer[name].dtype)
    return eng


def _shallow(params, depth: int):
    """The first ``depth`` layers of the main path's weights."""
    return dict(params, blocks=params["blocks"][:depth])


def _require_varied(outputs: dict, what: str,
                    constant_share: float = 0.0) -> list:
    """Equal token streams are a sharp test only when the streams follow
    their context.  Every stream must change token at least once (at most
    a share ``constant_share`` of them may hold a single token), and the
    streams must hold at least two distinct tokens each on average.  The
    main path's 16-token full-depth streams take the strict rule; shorter
    or shallower runs allow a quarter, since a stream may hold one token
    for its first 8 and turn later (gemma3-12b's bucketed FP8 streams:
    [8, 8, 5, 1, 8, 7, 6, 8] distinct tokens at 8 generated, [15, 14, 13,
    8, 11, 14, 12, 16] at 16).  Returns the distinct tokens per stream."""
    distinct = [len(set(o)) for o in outputs.values()]
    constant = sum(d == 1 for d in distinct)
    if (constant > constant_share * len(distinct)
            or sum(distinct) < 2 * len(distinct)):
        raise AssertionError(f"{what}: degenerate token streams, distinct "
                             f"tokens per stream {distinct}: the check "
                             "would be weak")
    return distinct


def preemption_path(dev, policy) -> dict:
    """Phase: preemption at full width.  The serving phases' 8 requests on
    lively weights, fused decode, once with a worst-case pool and once
    with ``PREEMPT_PAGES`` pages: the small pool makes the scheduler spill
    slots to the host and restore them into fresh pages; every request
    finishes and the token streams equal the worst-case run's bit for
    bit."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, run_continuous

    cfg = get_config("qwen2-0.5b", policy=policy)
    label = _policy_label(cfg, policy)
    gen = 24
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, size=n) for n in SERVE_PLENS]
    runs = []
    for pages in (None, PREEMPT_PAGES):
        eng = _lively(Engine(cfg, slots=8, max_seq=max(SERVE_PLENS) + gen,
                             page_size=16, num_pages=pages, rng_seed=0,
                             device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outputs, stats = run_continuous(eng, queue, gen=gen, chunk=4,
                                        quiet=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if stats["terminal"] != {"finished": len(queue)}:
            raise AssertionError(f"preemption run ({label}, {pages} pages): "
                                 f"{stats['statuses']}")
        eng.pool.assert_invariants()
        print(f"# preemption run {label}, pool "
              f"{eng.pool.num_pages - 1} pages: {stats['steps']} steps, "
              f"{stats['preemptions']} preemptions, {stats['restores']} "
              f"restores, {wall:.3f} s wall", flush=True)
        runs.append((outputs, stats))
        del eng
    (full, s_full), (small, s_small) = runs
    if s_full["preemptions"] or s_small["preemptions"] < 1 \
            or s_small["restores"] < 1:
        raise AssertionError(f"preemptions {s_full['preemptions']} / "
                             f"{s_small['preemptions']}, restores "
                             f"{s_small['restores']}: want 0, then >= 1")
    if not any(len(set(o)) > 1 for o in full.values()):
        raise AssertionError("degenerate token streams: the check would "
                             "be weak")
    if small != full:
        raise AssertionError(f"{label}: token streams differ with "
                             "preemption")
    print(f"# preempt/restore == uninterrupted ({label}): token streams "
          "bitwise equal", flush=True)
    return dict(preemptions=s_small["preemptions"],
                restores=s_small["restores"])


def _first_step_logits(dev, cfg):
    """A prefill chunk and one decode step of a 2-slot Engine: logits."""
    import numpy as np
    from repro_torch.launch.serve import Engine

    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 4)).astype(np.int32)
    eng = Engine(cfg, slots=2, max_seq=16, page_size=16, rng_seed=3,
                 device=dev)
    eng.pool.ensure_capacity_batch(np.asarray([4, 3]))
    first = eng.step_chunk(toks, np.zeros(2, np.int32),
                           np.asarray([4, 3], np.int32))
    second = eng.step_chunk(toks[:, :1], np.asarray([4, 3], np.int32),
                            np.asarray([1, 1], np.int32))
    return np.stack([first, second])


def check_against_plain_engine(dev, policy="serve_fp8_paged") -> None:
    """Float32 copy of the model: first-step logits through K1 and through
    the plain attention (policy attention_qk impl="ref") agree; FP8 pages
    under serve_fp8_paged, float32 pages under the default policy."""
    import numpy as np
    from repro_torch.configs import get_config

    base = get_config("qwen2-0.5b", policy=policy)
    cfg = dataclasses.replace(base, param_dtype="float32")
    ref_pol = base.policy.replace(attention_qk=dataclasses.replace(
        base.policy.attention_qk, impl="ref"))
    logits = [_first_step_logits(dev, c) for c in
              (cfg, dataclasses.replace(cfg, numerics=ref_pol))]
    np.testing.assert_allclose(logits[0], logits[1], rtol=1e-3, atol=1e-3)
    print(f"# float32 engine ({_policy_label(base, policy)}): K1 vs "
          f"plain-attention logits max diff "
          f"{np.abs(logits[0] - logits[1]).max():.3e}", flush=True)


def profile_main_path(dev, policy="serve_fp8_paged",
                      arch="qwen2-0.5b") -> None:
    """A short traced window of a serving path (8 requests, 4-token
    prompts, 4 generated tokens, after a warm-up run; ``arch`` at full
    width): the card's busy share of the window's wall time, the launches
    per sub-step and the kernels that take the time.  CUDA activity only,
    so the host pays little for the tracing."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, run_continuous

    cfg = get_config(arch, policy=policy)
    eng = Engine(cfg, slots=8, max_seq=16, page_size=16, rng_seed=0,
                 device=dev)
    rng = np.random.default_rng(2)
    run_continuous(eng, [rng.integers(0, cfg.vocab, size=4)
                         for _ in range(8)], gen=2, quiet=True)
    queue = [rng.integers(0, cfg.vocab, size=4) for _ in range(8)]
    sub0 = eng.tel.counter_value("serve_substeps_total")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_continuous(eng, queue, gen=4, quiet=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    substeps = int(eng.tel.counter_value("serve_substeps_total") - sub0)
    rows = [(e.key, getattr(e, "self_device_time_total", None)
             or e.self_cuda_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(us for _, us, _ in rows) / 1e6
    if busy <= 0:
        print(f"# profile of {arch}'s serving path: {substeps} sub-steps in "
              f"{wall:.4f} s wall; the profiler recorded no device time "
              "(busy share and launches not measured)", flush=True)
        return
    k1 = sum(us for k, us, _ in rows if "paged_partials" in k) / 1e6
    k5 = sum(us for k, us, _ in rows if "fp8_elementwise_kernel" in k) / 1e6
    n_kernels = sum(n for _, _, n in rows)
    top = sorted(rows, key=lambda r: -r[1])[:6]
    ew = cfg.policy.elementwise
    label = _policy_label(cfg, policy) + (f", elementwise {ew.fmt}"
                                          if ew.quantized else "")
    print(f"# profile of {arch}'s serving path ({label}): {substeps} "
          f"sub-steps in "
          f"{wall:.4f} s wall; card busy {busy:.4f} s "
          f"({100 * busy / wall:.2f}% of the wall), {n_kernels} kernel "
          f"launches ({n_kernels / max(substeps, 1):.0f} per sub-step); "
          f"K1 {k1:.5f} s ({100 * k1 / busy:.2f}% of busy), K5 {k5:.5f} s "
          f"({100 * k5 / busy:.2f}%)", flush=True)
    for key, us, n in top:
        print(f"#   {us / 1e3:10.3f} ms  x{n:<6d} {key[:90]}", flush=True)

# --------------------------------------------------------------------------- #
# The dense GQA family and prefix caching: gemma3-12b's main path, and
# gemma2-27b and qwen3-14b
# --------------------------------------------------------------------------- #
PREFIX_SHARED = 64                            # 4 full pages of 16
PREFIX_TAILS = (5, 17, 9, 2, 26, 12, 31, 7)   # each request's own tail
PREFIX_GEN = 16
PREFIX_SLOTS = 4
PREFIX_PREEMPT_DEPTH = 6                      # one whole 5:1 period
PREFIX_PREEMPT_PAGES = 19                     # 18 usable pages of 28


def _prefix_queue(cfg):
    """The 8 requests: one shared 64-token prefix, then each one's tail."""
    import numpy as np

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, size=PREFIX_SHARED)
    return [np.concatenate([shared, rng.integers(0, cfg.vocab, size=t)])
            for t in PREFIX_TAILS]


def _prefix_engine(dev, cfg, params, **kw):
    """A 4-slot Engine of the prefix phases on ``params`` (its own seed-0
    draw is dropped), or on its own draw when ``params`` is None."""
    from repro_torch.launch.serve import Engine

    eng = Engine(cfg, slots=PREFIX_SLOTS,
                 max_seq=PREFIX_SHARED + max(PREFIX_TAILS) + PREFIX_GEN,
                 page_size=16, rng_seed=0, device=dev, **kw)
    if params is not None:
        eng.params = params
    return eng


@contextlib.contextmanager
def _invariant_checks():
    """``REPRO_CHECK_INVARIANTS=1`` within the block: the scheduler checks
    the pool's invariants after every step."""
    saved = os.environ.get("REPRO_CHECK_INVARIANTS")
    os.environ["REPRO_CHECK_INVARIANTS"] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("REPRO_CHECK_INVARIANTS", None)
        else:
            os.environ["REPRO_CHECK_INVARIANTS"] = saved


def _counted_run(eng, queue, gen: int, scheduler: str = "continuous") -> dict:
    """``run`` under ``scheduler`` with every K1 count set to 0 just before
    and read just after; every step's logits checked finite and of the
    vocabulary's width.  Returns the run's outputs, stats, wall, sub-steps
    and K1 launches of each instance (none on a dense cache)."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import run

    sync, vocab = eng.sync_logits, eng.cfg.vocab

    def checked(logits):
        host = sync(logits)
        if host.shape[-1] != vocab or not np.isfinite(host).all():
            raise AssertionError("non-finite or misshapen logits")
        return host

    eng.sync_logits = checked
    torch.cuda.synchronize()
    pa.paged_attend.launches = 0
    pa.paged_attend.float_launches = 0
    t0 = time.perf_counter()
    outputs, stats = run(eng, queue, gen=gen, chunk=4, quiet=True,
                         scheduler=scheduler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = dict(outputs=outputs, stats=stats, wall=wall,
               substeps=int(eng.tel.counter_value("serve_substeps_total")),
               lns=pa.paged_attend.launches,
               flt=pa.paged_attend.float_launches)
    if stats["terminal"] != {"finished": len(queue)}:
        raise AssertionError(f"requests not all finished: "
                             f"{stats['statuses']}")
    if sorted(outputs) != list(range(len(queue))) or any(
            len(o) != gen for o in outputs.values()):
        raise AssertionError("missing or short token streams")
    fp8 = eng.cfg.policy.kv_quantized
    launches, other = ((run["lns"], run["flt"]) if fp8
                       else (run["flt"], run["lns"]))
    if eng.cache_impl == "dense":
        if launches or other:
            raise AssertionError(f"K1 launched {launches} + {other} times "
                                 "on the dense cache")
        run["launches"] = 0
        return run
    if launches != eng.cfg.n_layers * run["substeps"] or other:
        raise AssertionError(
            f"K1 {'LNS' if fp8 else 'float'} launches {launches} != "
            f"n_layers {eng.cfg.n_layers} x sub-steps {run['substeps']}, or "
            f"{other} launches of the other instance")
    run["launches"] = launches
    return run


def prefix_main_path(dev, policy, params=None) -> dict:
    """This slice's main path: full-width, full-depth gemma3-12b (48
    layers, 5 local layers of window 1,024 to each global one, hd 256)
    served through the Engine with the prefix cache, 4 slots, page 16, a
    worst-case pool; 8 requests of a shared 64-token prefix and their own
    tails, 16 generated tokens each, chunk 4.  Three runs: prefix off
    with fused decode, prefix on with fused decode, prefix on unfused.
    Gates: the three token streams bitwise equal and each stream varied
    (:func:`_require_varied`), at least 256 prefix hit tokens with the
    cache on (the second wave maps the 4 prefix pages), K1 launched
    n_layers x sub-steps times in every run and its other instance never.
    Weights: drawn on the card from seed 0, redrawn by :func:`_lively`
    (shared by both policies' runs; returned)."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("gemma3-12b", policy=policy)
    label = _policy_label(cfg, policy)
    queue = _prefix_queue(cfg)
    runs = {}
    for prefix_on, fused_on in ((False, True), (True, True), (True, False)):
        eng = _prefix_engine(dev, cfg, params, prefix_cache=prefix_on,
                             fused_decode=fused_on)
        if params is None:
            params = _lively(eng).params
        run = _counted_run(eng, queue, PREFIX_GEN)
        hits = run["stats"]["prefix_hit_tokens"]
        print(f"# gemma3-12b serve {label}, prefix "
              f"{'on' if prefix_on else 'off'}, fused={fused_on}: "
              f"{len(queue)} requests, {run['stats']['steps']} steps, "
              f"{run['substeps']} sub-steps, {run['lns']} K1 LNS and "
              f"{run['flt']} K1 float launches, {hits} prefix hit tokens "
              f"(prefix stats {run['stats']['prefix']}), {run['wall']:.3f} s "
              f"wall, {run['stats']['decode_tok_s']:.2f} decode tok/s",
              flush=True)
        if (hits >= 4 * PREFIX_SHARED) != prefix_on:
            raise AssertionError(f"prefix {'on' if prefix_on else 'off'}: "
                                 f"{hits} prefix hit tokens")
        runs[prefix_on, fused_on] = run
        del eng
        torch.cuda.empty_cache()
    streams = [r["outputs"] for r in runs.values()]
    distinct = _require_varied(streams[0], f"gemma3-12b {label}")
    if streams[1] != streams[0] or streams[2] != streams[0]:
        raise AssertionError(f"gemma3-12b {label}: token streams differ with "
                             "the prefix cache on/off or fused decode on/off")
    print(f"# gemma3-12b {label}: token streams bitwise equal with the "
          "prefix cache off, on, and on with unfused decode; distinct "
          f"tokens per stream {distinct}", flush=True)
    return dict(launches=runs[True, True]["launches"], params=params,
                outputs=streams[0], wall=runs[True, True]["wall"])


def preempt_shared_path(dev, policy, params) -> dict:
    """Preemption while shared: the prefix phase's requests at full width
    and depth 6 (one whole 5:1 period; the main path's weights, their
    first 6 layers), prefix on, once with a worst-case pool and once with
    ``PREFIX_PREEMPT_PAGES`` pages, under which the scheduler spills slots
    that map registered prefix pages: those stay resident under a pin
    (at least one spill must pin a page).  ``assert_invariants`` runs after
    every step (``REPRO_CHECK_INVARIANTS=1``); the token streams equal the
    worst-case pool's bit for bit, and vary (:func:`_require_varied`, at
    most a quarter of them on one token).  Returns the worst-case pool's
    streams too: :func:`bucketed_path` holds its depth-6 runs to them."""
    import torch
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("gemma3-12b", policy=policy),
                              n_layers=PREFIX_PREEMPT_DEPTH)
    label = _policy_label(cfg, policy)
    shallow = _shallow(params, PREFIX_PREEMPT_DEPTH)
    queue = _prefix_queue(cfg)
    runs = []
    with _invariant_checks():
        for pages in (None, PREFIX_PREEMPT_PAGES):
            eng = _prefix_engine(dev, cfg, shallow, prefix_cache=True,
                                 num_pages=pages)
            pinned = []
            spill = eng.pool.spill_slot

            def counted_spill(slot, spill=spill, pinned=pinned):
                out = spill(slot)
                pinned.append(len(out[1]))
                return out

            eng.pool.spill_slot = counted_spill
            run = _counted_run(eng, queue, PREFIX_GEN)
            eng.pool.assert_invariants()
            st = run["stats"]
            print(f"# gemma3-12b depth {cfg.n_layers} prefix on {label}, pool "
                  f"{eng.pool.num_pages - 1} pages: {st['steps']} steps, "
                  f"{st['preemptions']} preemptions, {st['restores']} "
                  f"restores, {sum(1 for n in pinned if n)} spills pinning "
                  f"{sum(pinned)} prefix pages, {st['prefix_hit_tokens']} "
                  f"prefix hit tokens, {run['wall']:.3f} s wall", flush=True)
            runs.append((run, pinned))
            del eng
            torch.cuda.empty_cache()
    (full, _), (small, pinned) = runs
    if full["stats"]["preemptions"] or small["stats"]["preemptions"] < 1 \
            or small["stats"]["restores"] < 1 or not any(pinned):
        raise AssertionError(
            f"preemptions {full['stats']['preemptions']} / "
            f"{small['stats']['preemptions']}, restores "
            f"{small['stats']['restores']}, pinned pages per spill {pinned}: "
            "want 0, then >= 1 with a pinned spill")
    distinct = _require_varied(full["outputs"], f"preempt-while-shared "
                               f"{label}", constant_share=0.25)
    if small["outputs"] != full["outputs"]:
        raise AssertionError(f"{label}: token streams differ with "
                             "preemption while shared")
    print(f"# preempt-while-shared == worst-case pool (gemma3-12b, {label}): "
          f"token streams bitwise equal; distinct tokens per stream "
          f"{distinct}", flush=True)
    return dict(preemptions=small["stats"]["preemptions"],
                restores=small["stats"]["restores"], pinned=sum(pinned),
                outputs=full["outputs"], wall=full["wall"])


# --------------------------------------------------------------------------- #
# Fault-tolerant serving: the chaos harness, crash snapshots, a kill and a
# restore through ``runtime.fault.run_serving``
# --------------------------------------------------------------------------- #
CHAOS_PAGES = PREFIX_PREEMPT_PAGES   # 18 usable pages of the worst case's 28
# BENCH_5's fault rates (benchmarks/run.py::serve_chaos); a CPU rehearsal
# at smoke size (the scheduler's choices do not depend on width) puts the
# kill after the snapshot of step 24, which holds a PREEMPTED request
CHAOS_PLAN = dict(seed=1, pool_exhaustion=0.25, exhaustion_pages=2,
                  exhaustion_hold=3, preemption_storm=0.15, corruption=0.15,
                  overrun=0.2, kill_at_step=28)
CHAOS_SNAPSHOT_EVERY = 8
# the 8 requests arrive together on 4 slots: a queue of 7 sheds the newest;
# 80 steps lie past the fault-free run's 57 and short of the last admitted
# request's finish under chaos, which expires
CHAOS_MAX_QUEUE = 7
CHAOS_DEADLINE_STEPS = 80
CHAOS_BF16_DEPTH = 6


def _latest_snapshot(ckpt) -> dict:
    """The latest snapshot under ``ckpt``: its step, bytes on disk and
    PREEMPTED requests, and the snapshots on disk."""
    import pathlib
    from repro_torch.checkpoint import store

    step = store.latest_step(ckpt)
    d = pathlib.Path(ckpt) / f"step-{step}"
    sched = json.loads((d / "manifest.json").read_text())[
        "data_state"]["scheduler"]
    return dict(step=step, bytes=sum(f.stat().st_size for f in d.iterdir()),
                preempted=len(sched["preempted"]),
                on_disk=len(list(pathlib.Path(ckpt).glob("step-*"))))


def _chaos_run(dev, cfg, policy, params, base: dict) -> None:
    """The prefix phase's 8 requests through ``run_serving`` under
    ``CHAOS_PLAN`` (page exhaustion, preemption storms, refcount-corruption
    drills, watchdog overruns and one kill), prefix cache on, a pool of
    ``CHAOS_PAGES``, a snapshot every ``CHAOS_SNAPSHOT_EVERY`` steps, the
    deadlines and queue bound above, pool invariants after every step.
    Gates: every fault kind injected; one restart, from a snapshot with at
    least two on disk and a PREEMPTED request in it; every FINISHED stream
    bitwise equal to ``base["outputs"]`` (the same requests fault-free,
    in ``base["wall"]`` seconds) and varied;
    every other request in a terminal state, at least one shed or
    expired; the pool clean after the seizures' release; K1 launched
    n_layers x the sub-steps of the killed engine and its successor, its
    other instance never; the successor's first K1 calls (its first step,
    on the restored pages) within rtol = atol = 1e-4 of the plain version
    (:class:`_ShadowK1`); every step's logits finite."""
    import gc
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.runtime.fault import run_serving
    from repro_torch.serving import FINISHED, TERMINAL_STATES, FaultPlan

    label = f"gemma3-12b depth {cfg.n_layers} {_policy_label(cfg, policy)}"
    queue = _prefix_queue(cfg)
    engines, restored, shadows, substeps, logs = [], {}, [], [0], []

    def make_engine():
        # drop the killed engine (its wrapped methods form cycles) before
        # its successor draws its own weights
        successor = bool(engines)
        engines.clear()
        gc.collect()
        if successor:
            restored.update(_latest_snapshot(ckpt))
        eng = _prefix_engine(dev, cfg, params, prefix_cache=True,
                             num_pages=CHAOS_PAGES)
        step_chunk, sync = eng.step_chunk, eng.sync_logits

        def counted(tokens, *args, **kw):
            substeps[0] += np.asarray(tokens).shape[1]
            if successor and not shadows:
                with _ShadowK1() as shadow:
                    out = step_chunk(tokens, *args, **kw)
                shadows.append(shadow)
                return out
            return step_chunk(tokens, *args, **kw)

        def checked(logits):
            host = sync(logits)
            if host.shape[-1] != cfg.vocab or not np.isfinite(host).all():
                raise AssertionError("non-finite or misshapen logits")
            return host

        eng.step_chunk, eng.sync_logits = counted, checked
        engines.append(eng)
        return eng

    with _invariant_checks(), tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pa.paged_attend.launches = 0
        pa.paged_attend.float_launches = 0
        t0 = time.perf_counter()
        out, stats = run_serving(
            make_engine, queue, gen=PREFIX_GEN, chunk=4,
            deadline_steps=CHAOS_DEADLINE_STEPS, max_queue=CHAOS_MAX_QUEUE,
            chaos=FaultPlan(**CHAOS_PLAN), ckpt_dir=ckpt,
            snapshot_every=CHAOS_SNAPSHOT_EVERY, step_deadline_s=3600.0,
            log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lns, flt = pa.paged_attend.launches, pa.paged_attend.float_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng = engines[0]
    for line in logs:
        if "overran" not in line:
            print(f"# {line}", flush=True)
    tel, counts = stats["telemetry"], stats["chaos"]
    save_h = tel.histogram("snapshot_save_seconds")
    restore_h = tel.histogram("snapshot_restore_seconds")
    print(f"# {label} chaos: {stats['steps']} steps, {substeps[0]} sub-steps "
          f"over both engines, {lns} K1 LNS and {flt} K1 float launches, "
          f"{stats['preemptions']} preemptions, faults {counts}, "
          f"{stats['watchdog_overruns']} watchdog overruns survived, "
          f"{stats['restarts']} restart from the snapshot of step "
          f"{stats['restored_from']} ({restored.get('bytes')} B on disk, "
          f"{restored.get('preempted')} PREEMPTED requests in it, "
          f"{restored.get('on_disk')} snapshots on disk), "
          f"{stats['snapshots']} snapshots taken; save "
          f"{save_h.sum / max(save_h.count, 1):.4f} s mean over "
          f"{save_h.count}, restore {restore_h.sum:.4f} s; terminal "
          f"{stats['terminal']}; {wall:.3f} s wall against the fault-free "
          f"run's {base['wall']:.3f} s; peak {peak:.2f} GiB", flush=True)
    for rid, (state, reason) in sorted(stats["statuses"].items()):
        if state != FINISHED:
            print(f"#   request {rid}: {state} ({reason})", flush=True)
    kinds = ("exhaustion", "storm", "corruption", "overrun", "killed")
    if (any(counts[k] < 1 for k in kinds) or stats["restarts"] != 1
            or stats["restored_from"] is None
            or restored.get("step", 0) < 2 * CHAOS_SNAPSHOT_EVERY
            or restored.get("preempted", 0) < 1):
        raise AssertionError(f"{label}: faults {counts}, restarts "
                             f"{stats['restarts']}, restored {restored}")
    terminal = stats["terminal"]
    if (not set(terminal) <= {"finished", "timed_out", "rejected"}
            or terminal.get("finished", 0) < 1
            or terminal.get("finished", 0) == len(queue)
            or any(s not in TERMINAL_STATES
                   for s, _ in stats["statuses"].values())):
        raise AssertionError(f"{label}: terminal {terminal}, "
                             f"statuses {stats['statuses']}")
    if any(out[rid] != base["outputs"][rid] for rid in out):
        raise AssertionError(f"{label}: a survivor's tokens differ from the "
                             "fault-free run's")
    # full-depth 16-token streams take the strict rule, shallower a quarter
    distinct = _require_varied(out, f"{label} chaos survivors",
                               constant_share=0.25 * (cfg.n_layers < 48))
    if eng.pool.free_pages != eng.pool.num_pages - 1:
        raise AssertionError(f"{label}: {eng.pool.free_pages} free pages of "
                             f"{eng.pool.num_pages - 1} after the run")
    eng.pool.assert_invariants()
    launches, other = (lns, flt) if cfg.policy.kv_quantized else (flt, lns)
    if launches != cfg.n_layers * substeps[0] or other:
        raise AssertionError(f"{label}: K1 launches {launches} != n_layers "
                             f"{cfg.n_layers} x sub-steps {substeps[0]}, or "
                             f"{other} of the other instance")
    shadow = shadows[0]
    print(f"# {label} chaos: {len(out)} survivors bitwise equal to the "
          f"fault-free streams (distinct tokens per stream {distinct}); the "
          f"successor's first {shadow.calls} K1 calls within "
          f"{shadow.err:.3e} of the plain version", flush=True)
    engines.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _snapshot_roundtrip(dev, cfg, params) -> None:
    """Save while a request sits PREEMPTED (the chaos pool makes the
    scheduler spill), load into a freshly built engine: every cache tensor
    and every spill tensor bitwise equal (``torch.equal``), the pool's
    state equal."""
    import tempfile
    import torch
    from repro_torch.serving import (ContinuousScheduler, Request,
                                     load_snapshot, save_snapshot)

    def build():
        eng = _prefix_engine(dev, cfg, params, prefix_cache=True,
                             num_pages=CHAOS_PAGES)
        return eng, ContinuousScheduler(eng, chunk=4)

    eng, sched = build()
    for i, prompt in enumerate(_prefix_queue(cfg)):
        sched.add(Request(rid=i, prompt=prompt, gen=PREFIX_GEN))
    while not sched.preempted:
        if not sched.pending():
            raise AssertionError("the pool never forced a preemption")
        sched.step()
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        save_snapshot(ckpt, eng, sched)
        t1 = time.perf_counter()
        eng2, sched2 = build()
        t2 = time.perf_counter()
        step = load_snapshot(ckpt, eng2, sched2)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        size = _latest_snapshot(ckpt)["bytes"]
    spills = [(r.spill["state"], r2.spill["state"])
              for r, r2 in zip(sched.preempted, sched2.preempted)]
    if (step != sched.steps or len(spills) != len(sched.preempted)
            or eng2.pool.state_dict() != eng.pool.state_dict()
            or any(not torch.equal(eng2.cache[k], t)
                   for k, t in eng.cache.items())
            or any(a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])
                   for a, b in spills for k in a)):
        raise AssertionError("snapshot round trip: restored state differs")
    print(f"# gemma3-12b depth {cfg.n_layers} {eng.cache['kp'].dtype} pages: "
          f"snapshot at step {step} with {len(spills)} PREEMPTED requests "
          f"({sum(r.spill['n_pages'] for r in sched.preempted)} spilled "
          f"pages), {size} B on disk, saved in {t1 - t0:.4f} s, loaded into "
          f"a fresh engine in {t3 - t2:.4f} s: every cache and spill tensor "
          "bitwise equal", flush=True)
    del eng, eng2, sched, sched2, spills
    torch.cuda.empty_cache()


def chaos_path(dev, params, fp8_base: dict, bf16_base: dict) -> None:
    """Phase: fault-tolerant serving (:func:`_chaos_run`) at gemma3-12b's
    full width and depth on FP8 pages (serve_fp8_paged, stochastic KV
    writes), its survivors held to :func:`prefix_main_path`'s streams
    (``fp8_base``); then on the CLI's default bf16 pages at depth
    ``CHAOS_BF16_DEPTH`` (the main path's first layers, cut for time as
    :func:`preempt_shared_path`): a snapshot round trip
    (:func:`_snapshot_roundtrip`) and the same chaos run, its survivors
    held to :func:`preempt_shared_path`'s default-policy streams
    (``bf16_base``)."""
    from repro_torch.configs import get_config

    _chaos_run(dev, get_config("gemma3-12b", policy="serve_fp8_paged"),
               "serve_fp8_paged", params, fp8_base)
    cfg = dataclasses.replace(get_config("gemma3-12b"),
                              n_layers=CHAOS_BF16_DEPTH)
    shallow = _shallow(params, CHAOS_BF16_DEPTH)
    _snapshot_roundtrip(dev, cfg, shallow)
    _chaos_run(dev, cfg, None, shallow, bf16_base)


def _plain_attention_policy(pol):
    return pol.replace(attention_qk=dataclasses.replace(pol.attention_qk,
                                                        impl="ref"))


class _ShadowK1:
    """Within the block, every K1 call is also computed by its plain
    version (``page_partials_plain`` and the combine) on the very same
    inputs, the model's own, and held to K1's gate, rtol = atol = 1e-4;
    the kernel's output is what the model goes on with.  Counts the calls
    and keeps the largest difference.  The launch counters stay
    ``paged_attend``'s."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import paged_attention as pa

        self.pa, self.real = pa, pa.paged_attend
        self.calls, self.err = 0, 0.0

        def shadowed(*args, **kw):
            out = self.real(*args, **kw)
            want = pa._combine_partials(*pa.page_partials_plain(*args, **kw))
            torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
            self.err = max(self.err, float((out - want).abs().max()))
            self.calls += 1
            return out

        self.counts = (self.real.launches, self.real.float_launches)
        shadowed.launches, shadowed.float_launches = self.counts
        pa.paged_attend = shadowed
        return self

    def __exit__(self, *exc):
        # the kernel's wrapper counts its launches on the module's
        # ``paged_attend``, which is ``shadowed`` within the block
        shadowed = self.pa.paged_attend
        self.real.launches += shadowed.launches - self.counts[0]
        self.real.float_launches += shadowed.float_launches - self.counts[1]
        self.pa.paged_attend = self.real
        return False


def _launch_counts():
    from repro_torch.kernels import paged_attention as pa

    return pa.paged_attend.launches, pa.paged_attend.float_launches


def _gate_logits(kern, plain, label: str, fp8: bool,
                 what: str = "K1 vs plain-attention logits") -> float:
    """K1's and the plain attention's logits: within rtol = atol = 1e-3 on
    float pages; printed on FP8 pages, where they are no gate.  There the
    query codes (RNE) and the KV writes (stochastic rounding) of every
    layer past the first quantize activations that already differ by the
    float32 sums' order (~1e-6): a code that sits at a rounding boundary
    flips, and one flipped code moves the logits by ~1e-3 (full width:
    qwen3-14b 21 logits past 1e-3 after two steps; gemma3-12b 7 % past it
    after 1,040 sub-steps).  Every K1 call on the way is held to its
    plain version on identical inputs instead (:class:`_ShadowK1`)."""
    import numpy as np

    diff = float(np.abs(kern - plain).max())
    if not fp8:
        np.testing.assert_allclose(kern, plain, rtol=1e-3, atol=1e-3)
    print(f"# {label}: {what} max diff {diff:.3e} "
          f"({'printed, not gated: FP8 codes' if fp8 else 'within 1e-3'})",
          flush=True)
    return diff


WINDOW_PROMPT = 1040    # the local layers' window of 1,024 skips page 0
WINDOW_DEPTH = 6


def window_path(dev) -> None:
    """Windows on the model path: gemma3-12b at full width, depth 6 (5
    local layers and the global one), float32 parameters, on FP8 pages
    (serve_fp8_paged) and on float32 pages (the default policy).  One
    slot prefills the first 1,039 tokens of a 1,040-token prompt through
    K1, every K1 call from the 1,024th token on (where the window starts
    to mask) held to its plain version on the same inputs
    (:class:`_ShadowK1`); then, from that cache, the last prompt token and
    one decode step (the local layers' window of 1,024 skips page 0) run
    once through K1 and once through the plain attention: their logits
    within rtol = atol = 1e-3 on float32 pages (:func:`_gate_logits`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    rng = np.random.default_rng(4)
    for policy in ("serve_fp8_paged", None):
        base = get_config("gemma3-12b", policy=policy)
        cfg = dataclasses.replace(base, n_layers=WINDOW_DEPTH,
                                  param_dtype="float32")
        plain_cfg = dataclasses.replace(
            cfg, numerics=_plain_attention_policy(base.policy))
        fp8 = cfg.policy.kv_quantized
        prompt = rng.integers(0, cfg.vocab, size=(1, WINDOW_PROMPT))
        n = WINDOW_PROMPT - 1
        early = cfg.window - 1  # sub-steps whose reads the window leaves whole
        eng = Engine(cfg, slots=1, max_seq=WINDOW_PROMPT + 1, page_size=16,
                     rng_seed=3, device=dev)
        eng.pool.ensure_capacity_batch(np.asarray([WINDOW_PROMPT + 1]))

        def tail():
            last = prompt[:, -1:]
            first = eng.step_chunk(last, np.asarray([n]), np.ones(1, np.int32))
            second = eng.step_chunk(last, np.asarray([n + 1]),
                                    np.ones(1, np.int32))
            return np.stack([first, second])

        t0 = time.perf_counter()
        before = _launch_counts()
        eng.step_chunk(prompt[:, :early], np.zeros(1, np.int32),
                       np.asarray([early], np.int32))
        with _ShadowK1() as shadow:
            eng.step_chunk(prompt[:, early:n], np.asarray([early], np.int32),
                           np.asarray([n - early], np.int32))
            saved = {k: v.clone() for k, v in eng.cache.items()}
            kern = tail()
        launched = [a - b for a, b in zip(_launch_counts(), before)]
        t1 = time.perf_counter()
        for k, v in saved.items():
            eng.cache[k].copy_(v)
        eng.model.cfg = eng.cfg = plain_cfg
        before = _launch_counts()
        plain = tail()
        none = [a - b for a, b in zip(_launch_counts(), before)]
        del eng, saved
        torch.cuda.empty_cache()
        want = WINDOW_DEPTH * (WINDOW_PROMPT + 1)
        shadowed = WINDOW_DEPTH * (WINDOW_PROMPT + 1 - early)
        got = launched[0] if fp8 else launched[1]
        if (got != want or sum(launched) != want or any(none)
                or shadow.calls != shadowed):
            raise AssertionError(f"K1 launches {launched} (plain run {none}, "
                                 f"shadowed calls {shadow.calls}), want "
                                 f"{want} of one instance")
        label = (f"gemma3-12b depth {WINDOW_DEPTH}, float32, "
                 f"{_policy_label(cfg, policy)}, {WINDOW_PROMPT}-token "
                 f"prompt (window {cfg.window} skips page 0 on the local "
                 "layers)")
        print(f"# {label}: {got} K1 launches, the {shadow.calls} past "
              f"{early} tokens each within {shadow.err:.3e} of "
              f"its plain version on the same inputs; K1 path "
              f"{t1 - t0:.1f} s wall", flush=True)
        _gate_logits(kern, plain, label + ", last prompt position and one "
                     "decode step", fp8)


DENSE_DEPTH = 2     # gemma2-27b: one local and one global layer


def dense_family_path(dev, arch: str) -> None:
    """gemma2-27b or qwen3-14b at full width, depth 2: float32 logits of a
    prefill chunk and a decode step through K1 (every K1 call held to its
    plain version on the same inputs) and through the plain attention, on
    both page kinds (:func:`_gate_logits`: within rtol = atol = 1e-3 on
    float32 pages; for gemma2 the attention softcap of 50 and the final
    softcap of 30), then 4 requests served on bf16 pages (the CLI's
    default) with fused decode on and off: token streams bitwise equal,
    K1's float instance launched n_layers x sub-steps times."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    for policy in ("serve_fp8_paged", None):
        base = dataclasses.replace(get_config(arch, policy=policy),
                                   n_layers=DENSE_DEPTH)
        cfg = dataclasses.replace(base, param_dtype="float32")
        with _ShadowK1() as shadow:
            kern = _first_step_logits(dev, cfg)
        plain = _first_step_logits(dev, dataclasses.replace(
            cfg, numerics=_plain_attention_policy(base.policy)))
        torch.cuda.empty_cache()
        if shadow.calls != DENSE_DEPTH * 5:     # 4 prompt + 1 decode
            raise AssertionError(f"{shadow.calls} K1 calls, want "
                                 f"{DENSE_DEPTH * 5}")
        _gate_logits(kern, plain, f"{arch} depth {DENSE_DEPTH}, float32, "
                     f"{_policy_label(cfg, policy)} ({shadow.calls} K1 "
                     f"calls each within {shadow.err:.3e} of the plain "
                     "version)", cfg.policy.kv_quantized)
    cfg = dataclasses.replace(get_config(arch), n_layers=DENSE_DEPTH)
    plens, gen = SERVE_PLENS[:4], 8
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, size=n) for n in plens]
    runs, params = [], None
    for fused_on in (True, False):
        eng = Engine(cfg, slots=4, max_seq=max(plens) + gen, page_size=16,
                     rng_seed=0, fused_decode=fused_on, device=dev)
        if params is None:
            params = _lively(eng).params
        else:
            eng.params = params
        run = _counted_run(eng, queue, gen)
        print(f"# {arch} depth {DENSE_DEPTH} serve "
              f"{_policy_label(cfg, None)} fused={fused_on}: "
              f"{run['substeps']} sub-steps, {run['flt']} K1 float "
              f"launches, {run['wall']:.3f} s wall, distinct tokens per "
              f"stream {[len(set(o)) for o in run['outputs'].values()]}",
              flush=True)
        runs.append(run["outputs"])
        del eng
    del params
    torch.cuda.empty_cache()
    if runs[0] != runs[1]:
        raise AssertionError(f"{arch}: token streams differ with fused "
                             "decode on/off")
    print(f"# {arch}: token streams bitwise equal with fused decode on and "
          "off", flush=True)


# --------------------------------------------------------------------------- #
# The bucketed scheduler, the dense cache and the prefill splice; static FP8
# weights, decoded before each product or multiplied as codes by K2 and K3
# --------------------------------------------------------------------------- #
BUCKET_LOGIT_DEPTH = 6     # one whole 5:1 period, float32 parameters
STATIC_PLENS = (5, 17, 9, 2)        # the static-weight phase's 4 requests
STATIC_GEN = 8
KERNEL_DEPTH = 6           # one whole 5:1 period
# K3's runs: its plain version, which every call is held to, takes ~0.15 s
# a layer at M = 4, so K3 runs under the bucketed scheduler alone (its
# decode steps at M = 4, its prefill at M = 32); K2 under both
KERNEL_SCHEDULERS = {"fused_dequant": ("continuous", "bucketed"),
                     "lns": ("bucketed",)}
KERNEL_PLEN = 8            # 4 prompts of one length: one prefill, M = 32
KERNEL_GEN = 4
BUCKET_GEN = 8             # the full-depth bucketed runs' generated tokens
BUCKET_SHALLOW_DEPTH = 6   # the bucketed runs set against continuous ones
# one gemma3-12b layer's seven static-weight matmuls: (K, N) -> count
# (wq; wk and wv; wo; w_gate and w_up; w_down)
G3_LAYER_MATMULS = {(3840, 4096): 1, (3840, 2048): 2, (4096, 3840): 1,
                    (3840, 15360): 2, (15360, 3840): 1}


def _agreement(a: dict, b: dict) -> tuple:
    """Share of equal tokens of two runs' streams, and the first
    divergence as (request, token index), or None."""
    same = total = 0
    first = None
    for rid in sorted(a):
        x, y = a[rid], b.get(rid, [])
        for i, t in enumerate(x):
            total += 1
            if i < len(y) and y[i] == t:
                same += 1
            elif first is None:
                first = (rid, i)
    return same / max(total, 1), first


def _dense_cache_bytes(cfg, slots: int, max_seq: int) -> int:
    """The dense cache's bytes from its layout: K and V rows of every
    layer, ``min(max_seq, window)`` of them for a local layer."""
    item = 1 if cfg.policy.kv_quantized else 2
    rows = sum(min(max_seq, cfg.window)
               if cfg.window and not cfg.is_global_attn_layer(i) else max_seq
               for i in range(cfg.n_layers))
    return 2 * rows * slots * cfg.n_kv_heads * cfg.hd * item


def _bucketed_first_decode_logits(dev, cfg, params, impl: str):
    """Two prompts (lengths 9 and 5) prefilled then one decode step of the
    same tokens, under the bucketed scheduler's calls on the ``impl``
    cache (``prefill_batch`` then ``decode`` / ``decode_paged``) or under
    the continuous scheduler's (``step_chunk`` sub-steps; ``impl``
    "continuous"): the decode step's float32 logits."""
    import numpy as np
    from repro_torch.launch.serve import Engine

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (9, 5)]
    nxt = rng.integers(0, cfg.vocab, size=2)
    eng = Engine(cfg, slots=2, max_seq=16, page_size=16, rng_seed=3,
                 cache_impl="dense" if impl == "dense" else "paged",
                 stochastic_kv=False, device=dev)
    eng.params = params
    pos = np.asarray([9, 5])
    if impl == "continuous":
        toks = np.zeros((2, 9), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        eng.pool.ensure_capacity_batch(pos)
        eng.step_chunk(toks, np.zeros(2, np.int32), pos.astype(np.int32))
        eng.pool.ensure_capacity_batch(pos + 1)
        return eng.step_chunk(nxt[:, None], pos.astype(np.int32),
                              np.ones(2, np.int32))
    for i, p in enumerate(prompts):
        eng.prefill_batch([p], [i])
    if impl == "dense":
        return eng.decode(nxt, pos)
    return eng.decode_paged(nxt, pos)


def bucketed_logits_path(dev, policy, params) -> None:
    """The gate behind the bucketed phase's printed token agreement: at
    depth 6 (the main path's first 6 layers, float32), the first decode
    step's logits after a bucketed prefill on the dense cache, after one
    on the paged cache (the splice), and after a continuous (sub-step)
    prefill: dense vs paged and continuous vs bucketed within rtol = atol
    = 1e-3 on float32 pages (:func:`_gate_logits`; printed on FP8 pages,
    where a ~1e-6 difference flips a code at a rounding boundary)."""
    import torch
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("gemma3-12b", policy=policy),
                              n_layers=BUCKET_LOGIT_DEPTH,
                              param_dtype="float32")
    shallow = {k: v.float() for k, v in params.items() if k != "blocks"}
    shallow["blocks"] = [{k: (v.float() if isinstance(v, torch.Tensor)
                              else {n: t.float() for n, t in v.items()})
                          for k, v in layer.items()}
                         for layer in params["blocks"][:BUCKET_LOGIT_DEPTH]]
    got = {impl: _bucketed_first_decode_logits(dev, cfg, shallow, impl)
           for impl in ("dense", "paged", "continuous")}
    del shallow
    torch.cuda.empty_cache()
    fp8 = cfg.policy.kv_quantized
    label = (f"gemma3-12b depth {BUCKET_LOGIT_DEPTH}, float32, "
             f"{_policy_label(cfg, policy)}, first decode step")
    _gate_logits(got["dense"], got["paged"], label, fp8,
                 what="bucketed dense vs paged cache logits")
    _gate_logits(got["continuous"], got["paged"], label, fp8,
                 what="continuous vs bucketed (paged) logits")


def bucketed_path(dev, policy, params, continuous) -> dict:
    """The bucketed scheduler at full width: gemma3-12b on the main path's
    weights and its 8 prefix-phase requests on 4 slots, page 16.  At full
    depth, ``BUCKET_GEN`` generated tokens: on the dense cache; on the
    paged cache (the batched prefill's rows spliced into pages) fused,
    unfused, and fused again with every K1 call held to its plain version
    on the same inputs (:class:`_ShadowK1`).  At depth 6 (the first 6
    layers, one 5:1 period), 16 generated tokens as the prefix phases:
    with the prefix cache on (every admission prefills its uncached tail
    through ``tail_prefill``) and off; on FP8 pages also a continuous and
    a bucketed run with deterministic KV writes.  The depth-6 runs stand
    beside ``continuous``: :func:`preempt_shared_path`'s worst-case-pool
    streams of the same policy (depth 6, prefix on, continuous).

    Bitwise gates, on streams that vary (:func:`_require_varied`): paged
    fused == unfused == the shadowed run; the prefix cache on ==
    ``continuous``: both prefill through single-token sub-steps whose KV
    rounding is addressed by position, and a slot's numerics do not
    depend on the batch's other rows.  Also: K1 launched n_layers x
    sub-steps and never on the dense cache; the dense cache's bytes from
    its layout.  Printed, as the reference promises no more at this width
    (the splice sets a page's scale from the whole page, chunked prefill
    from its first token, and a full-sequence prefill sums in another
    order, so a greedy token can flip): the token agreement of dense vs
    paged, of the prefix cache on vs off (splice), and of continuous vs
    bucketed (deterministic KV writes on FP8 pages; on float pages the
    writes are casts), whose logits :func:`bucketed_logits_path`
    gates."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cache_bytes

    cfg = get_config("gemma3-12b", policy=policy)
    label = _policy_label(cfg, policy)
    fp8 = cfg.policy.kv_quantized
    queue = _prefix_queue(cfg)
    shallow_cfg = dataclasses.replace(cfg, n_layers=BUCKET_SHALLOW_DEPTH)
    shallow = _shallow(params, BUCKET_SHALLOW_DEPTH)
    # (name, Engine keywords, depth-6, scheduler, shadowed)
    plans = [("dense", dict(cache_impl="dense"), False, "bucketed", False),
             ("fused", dict(), False, "bucketed", False),
             ("unfused", dict(fused_decode=False), False, "bucketed", False),
             ("shadowed", dict(), False, "bucketed", True),
             ("prefix", dict(prefix_cache=True), True, "bucketed", False),
             ("off", dict(), True, "bucketed", False)]
    if fp8:
        plans += [("bucketed_rne", dict(stochastic_kv=False), True,
                   "bucketed", False),
                  ("continuous_rne", dict(stochastic_kv=False), True,
                   "continuous", False)]
    runs, shadow = {}, None
    for name, kw, shallow_run, scheduler, shadowed in plans:
        if shallow_run:
            eng = _prefix_engine(dev, shallow_cfg, shallow, **kw)
            gen = PREFIX_GEN
        else:
            eng = _prefix_engine(dev, cfg, params, **kw)
            gen = BUCKET_GEN
        if shadowed:
            with _ShadowK1() as shadow:
                run = _counted_run(eng, queue, gen, scheduler)
        else:
            run = _counted_run(eng, queue, gen, scheduler)
        st = run["stats"]
        extra = ""
        if name == "dense":
            want = _dense_cache_bytes(cfg, PREFIX_SLOTS, eng.max_seq)
            got = eng.kv_cache_bytes()
            if got != want or cache_bytes(eng.cache) != want:
                raise AssertionError(f"dense cache {got} B, want {want}")
            extra = f", dense cache {got} B (= its layout's)"
        print(f"# gemma3-12b depth {eng.cfg.n_layers} {scheduler} {label}, "
              f"{name}: {len(queue)} requests, {gen} generated, "
              f"{st['steps']} steps, {run['substeps']} sub-steps, "
              f"{run['lns']} K1 LNS and {run['flt']} K1 float launches, "
              f"{st['prefix_hit_tokens']} prefix hit tokens, "
              f"{run['wall']:.3f} s wall, {st['decode_tok_s']:.2f} decode "
              f"tok/s{extra}", flush=True)
        if (st["prefix_hit_tokens"] >= 4 * PREFIX_SHARED) != (name ==
                                                              "prefix"):
            raise AssertionError(f"{name}: {st['prefix_hit_tokens']} prefix "
                                 "hit tokens")
        runs[name] = run
        del eng
        torch.cuda.empty_cache()
    out = {k: r["outputs"] for k, r in runs.items()}
    distinct = _require_varied(out["fused"], f"gemma3-12b bucketed {label}",
                               constant_share=0.25)
    if out["unfused"] != out["fused"] or out["shadowed"] != out["fused"]:
        raise AssertionError(f"gemma3-12b bucketed {label}: token streams "
                             "differ fused/unfused or between two runs")
    print(f"# gemma3-12b bucketed {label}: paged fused == unfused == a "
          f"second run bitwise (distinct tokens per stream {distinct}); its "
          f"{shadow.calls} K1 calls each within {shadow.err:.3e} of the "
          "plain version", flush=True)
    _require_varied(out["prefix"], f"gemma3-12b bucketed prefix on {label}",
                    constant_share=0.25)
    if out["prefix"] != continuous:
        raise AssertionError(f"gemma3-12b {label}: bucketed token streams "
                             "with the prefix cache on differ from the "
                             "continuous scheduler's")
    hits = runs["prefix"]["stats"]["prefix_hit_tokens"]
    print(f"# gemma3-12b depth {BUCKET_SHALLOW_DEPTH} {label}: bucketed with "
          f"the prefix cache on ({hits} hit tokens, tail_prefill) == "
          "continuous, token streams bitwise", flush=True)
    pairs = [("dense vs paged (bucketed)", out["dense"], out["fused"]),
             (f"depth {BUCKET_SHALLOW_DEPTH}, bucketed prefix cache on vs off",
              out["prefix"], out["off"])]
    if fp8:
        pairs.append((f"depth {BUCKET_SHALLOW_DEPTH}, continuous vs "
                      "bucketed, deterministic KV writes",
                      out["continuous_rne"], out["bucketed_rne"]))
    else:
        pairs.append((f"depth {BUCKET_SHALLOW_DEPTH}, continuous vs "
                      "bucketed", continuous, out["off"]))
    for what, a, b in pairs:
        share, first = _agreement(a, b)
        print(f"# gemma3-12b {label}, {what}: {100 * share:.1f} % of tokens "
              f"equal, first divergence (request, token) {first}; distinct "
              f"tokens per stream {[len(set(o)) for o in b.values()]}",
              flush=True)
    return dict(launches=runs["fused"]["launches"],
                substeps=runs["fused"]["substeps"], k1_calls=shadow.calls,
                k1_err=shadow.err)


def _weight_bytes(params) -> int:
    from repro_torch.core.quant import QTensor

    def walk(t):
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        if isinstance(t, list):
            return sum(walk(v) for v in t)
        if isinstance(t, QTensor):
            return walk(t.codes) + walk(t.scale)
        return t.numel() * t.element_size()

    return walk(params)


def static_weights_path(dev, params) -> dict:
    """Static FP8 weights at full width and depth: gemma3-12b under
    serve_fp8_paged, continuous scheduler, prefix off, 4 requests of 5-17
    tokens, 8 generated.  ``Engine(static_weights=True)`` serves the main
    path's weights quantized (``quantize_params``: E4M3 codes, one scale a
    tensor), each matmul decoding its weight to bf16 first (the
    reference's route when matmuls are unquantized); an Engine with plain
    bf16 weights set to ``resolve_weight`` of the same codes serves the
    same requests.  Gate: token streams bitwise equal (the same bf16
    product in the same order) and varied (:func:`_require_varied`).
    Printed: the weight bytes on the card, the peak memory, both walls,
    and the card time of decoding one layer's weights.  Consumes
    ``params`` (its bf16 weights are dropped once quantized); returns the
    codes for :func:`static_kernel_path`."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QTensor
    from repro_torch.launch.serve import Engine
    from repro_torch.models.quantize import quantize_params, resolve_weight

    cfg = get_config("gemma3-12b", policy="serve_fp8_paged")
    rng = np.random.default_rng(6)
    queue = [rng.integers(0, cfg.vocab, size=n) for n in STATIC_PLENS]
    bf16_bytes = _weight_bytes(params)
    codes = quantize_params(params, cfg.policy,
                            period=cfg.layer_pattern_period)
    params.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    kw = dict(slots=PREFIX_SLOTS, max_seq=max(STATIC_PLENS) + STATIC_GEN,
              page_size=16, rng_seed=0, device=dev)
    eng = Engine(cfg, static_weights=True, **kw)
    own = eng.params["blocks"][0]["attn"]["wq"]
    if not isinstance(own, QTensor) or own.codes.dtype != torch.uint8:
        raise AssertionError("Engine(static_weights=True) holds no codes")
    eng.params = codes
    torch.cuda.empty_cache()
    static = _counted_run(eng, queue, STATIC_GEN)
    peak = torch.cuda.max_memory_allocated(dev)
    del eng
    torch.cuda.empty_cache()
    plain_params = {k: resolve_weight(v) if isinstance(v, QTensor) else v
                    for k, v in codes.items() if k != "blocks"}
    plain_params["blocks"] = [
        {k: ({n: resolve_weight(t) for n, t in v.items()}
             if isinstance(v, dict) else v) for k, v in layer.items()}
        for layer in codes["blocks"]]
    eng = Engine(cfg, **kw)
    eng.params = plain_params
    plain = _counted_run(eng, queue, STATIC_GEN)
    del eng, plain_params
    torch.cuda.empty_cache()
    distinct = _require_varied(static["outputs"], "static weights",
                               constant_share=0.25)
    if static["outputs"] != plain["outputs"]:
        raise AssertionError("static weights: token streams differ from the "
                             "plain bf16 engine on the decoded codes")
    layer = codes["blocks"][0]
    mats = [layer["attn"][n] for n in ("wq", "wk", "wv", "wo")] + \
        [layer["ffn"][n] for n in ("w_gate", "w_up", "w_down")]
    decode_ms, how = device_ms(lambda: [resolve_weight(q) for q in mats],
                               iters=10)
    qbytes = _weight_bytes(codes)
    print(f"# gemma3-12b static weights (serve_fp8_paged, continuous, "
          f"{len(queue)} requests, {static['substeps']} sub-steps): weights "
          f"on the card {qbytes / 1e9:.3f} GB as codes against "
          f"{bf16_bytes / 1e9:.3f} GB of bf16; peak memory "
          f"{peak / 2**30:.1f} GiB; wall {static['wall']:.3f} s static "
          f"against {plain['wall']:.3f} s on the decoded bf16 weights; "
          f"token streams bitwise equal (distinct tokens per stream "
          f"{distinct}); decoding one layer's 7 weights "
          f"{decode_ms:.4f} ms of card time ({how}), "
          f"{cfg.n_layers * decode_ms:.2f} ms a sub-step", flush=True)
    return dict(codes=codes, decode_ms=decode_ms, wall=static["wall"],
                plain_wall=plain["wall"], weight_bytes=qbytes,
                bf16_bytes=bf16_bytes, peak=peak)


def k_static_policy(impl: str):
    """serve_fp8_paged with every matmul quantized: E4M3 activations times
    the stored E4M3 weight codes through ``impl`` (``fused_dequant``: K2;
    ``lns``: K3), float32 sums."""
    from repro_torch.numerics import OpPolicy, get_policy

    return get_policy("serve_fp8_paged").replace(matmul=OpPolicy(
        fmt="e4m3", mode="rne", impl=impl, accum="f32"))


SHADOW_SUM_LIMIT = 2.0   # x sqrt(K) 2^-24 sum|products|, see _ShadowMatmul


class _ShadowMatmul:
    """Within the block, every call of K2 (``dequant_matmul``) or K3
    (``lns_product_matmul``) is also computed by its plain version on the
    very same codes and held to its gate, element by element:
    |kernel - plain| <= ``SHADOW_SUM_LIMIT`` sqrt(K) 2^-24 sum|products|.
    Both sum the same exact products (K3's products themselves are held
    bitwise by :func:`check_k3_products`) in float32 in another order; the
    rounding of each sum grows like sqrt(K) u sum|products| (u = 2^-24;
    the worst case 2 K u sum|products| of :func:`_sum_bound` is sqrt(K),
    62 to 124 times, looser at these K), while one product left out or
    counted twice is an error of the order of sum|products| / K, which
    this limit catches at every K the model has.  The kernel's output is
    what the model goes on with.  Counts the calls, their shapes, the
    largest difference, its largest share of the limit and of the call's
    largest |plain|; the launch counters stay the wrapper's."""

    def __init__(self, which: str):
        self.which = which

    def __enter__(self):
        import torch
        from repro_torch.kernels import lns_matmul as lm

        self.lm, self.real = lm, getattr(lm, self.which)
        plain = (lm.dequant_matmul_plain if self.which == "dequant_matmul"
                 else lm.lns_matmul_plain)
        self.calls, self.err, self.shapes = 0, 0.0, {}
        self.of_limit, self.rel = 0.0, 0.0

        def shadowed(x, w, **kw):
            out = self.real(x, w, **kw)
            want = plain(x, w, **kw)
            absum = plain(x & 0x7F, w & 0x7F, **kw)
            diff = (out - want).abs()
            limit = SHADOW_SUM_LIMIT * x.shape[1] ** 0.5 * 2.0**-24 * absum
            if not torch.isfinite(out).all() or bool((diff > limit).any()):
                raise AssertionError(f"{self.which} differs from its plain "
                                     f"version at {tuple(x.shape)} x "
                                     f"{tuple(w.shape)} beyond "
                                     f"{SHADOW_SUM_LIMIT} sqrt(K) 2^-24 "
                                     "sum|products|")
            self.err = max(self.err, float(diff.max()))
            self.of_limit = max(self.of_limit, float(
                (diff / limit.clamp_min(torch.finfo(torch.float32).tiny))
                .max()))
            self.rel = max(self.rel, float(diff.max())
                           / max(float(want.abs().max()), 1e-30))
            self.calls += 1
            key = (x.shape[0],) + tuple(w.shape)
            self.shapes[key] = self.shapes.get(key, 0) + 1
            return out

        self.start = self.real.launches
        shadowed.launches = self.start
        setattr(lm, self.which, shadowed)
        return self

    def __exit__(self, *exc):
        shadowed = getattr(self.lm, self.which)
        self.real.launches += shadowed.launches - self.start
        setattr(self.lm, self.which, self.real)
        return False


def _static_layer_ms(dev, layer, impl: str, M: int) -> dict:
    """Card time of one gemma3-12b layer's seven static-weight matmuls at
    M rows (E4M3 codes of random activations times the layer's stored
    codes): the kernel, its plain version and, for K2, ``torch.matmul`` on
    the decoded bf16 operands; the function's bound (its bytes: the weight
    codes, x's codes and the float32 out, once each, over the memory rate;
    against its 2 M K N operations at the card's dense rate, bf16 for K2's
    float products, 8-bit for K3's) and, for K3, its R-fold plane work
    beside it."""
    import torch
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import lns_matmul as lm
    from repro_torch.kernels.common import code_to_f32, lns_plane_tables

    g = torch.Generator(device=dev).manual_seed(M)
    mats = [layer["attn"][n] for n in ("wq", "wk", "wv", "wo")] + \
        [layer["ffn"][n] for n in ("w_gate", "w_up", "w_down")]
    xs = [quantize(torch.randn((M, q.codes.shape[0]), generator=g,
                               device=dev), "e4m3").codes for q in mats]
    if impl == "fused_dequant":
        def kern(i):
            return lm.dequant_matmul(xs[i], mats[i].codes, fmt="e4m3",
                                     w_fmt="e4m3",
                                     compute_dtype=torch.float32)

        def plain(i):
            return lm.dequant_matmul_plain(xs[i], mats[i].codes, fmt="e4m3",
                                           w_fmt="e4m3",
                                           compute_dtype=torch.float32)
        only = "dequant_matmul_kernel"
    else:
        def kern(i):
            return lm.lns_product_matmul(xs[i], mats[i].codes, fmt="e4m3",
                                         mode="rne")

        def plain(i):
            return lm.lns_matmul_plain(xs[i], mats[i].codes, fmt="e4m3",
                                       mode="rne")
        only = "lns_matmul_kernel"
    n = len(mats)
    ms, how = device_ms(lambda: [kern(i) for i in range(n)], iters=20,
                        only=only)
    plain_ms, _ = device_ms(lambda: [plain(i) for i in range(n)],
                            iters=2 if impl == "lns" else 10, warmup=1)
    res = dict(ms=ms, plain_ms=plain_ms, how=how, library_ms=None)
    if impl == "fused_dequant":
        dec = [(code_to_f32(x, "e4m3").to(torch.bfloat16),
                code_to_f32(q.codes, "e4m3").to(torch.bfloat16))
               for x, q in zip(xs, mats)]
        res["library_ms"], _ = device_ms(
            lambda: [torch.matmul(a, b) for a, b in dec], iters=20)
    prods = sum(M * q.codes.shape[0] * q.codes.shape[1] for q in mats)
    nbytes = sum(q.codes.numel() + M * q.codes.shape[0]
                 + 4 * M * q.codes.shape[1] for q in mats)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = BF16_FLOP_PER_S if impl == "fused_dequant" else INT8_OPS_PER_S
    b_ops = 2 * prods / rate * 1e3
    res.update(bound_ms=max(b_bytes, b_ops),
               bound_by="bytes" if b_bytes >= b_ops else "operations",
               nbytes=nbytes, prods=prods)
    note = ""
    if impl == "lns":
        R = lns_plane_tables("e4m3", "rne").R
        note = (f"; the design's own work beside it (never the bound): "
                f"{R} x {2 * prods} plane FLOP = "
                f"{R * 2 * prods / BF16_FLOP_PER_S * 1e3:.5f} ms at 989 "
                "TFLOP/s")
    lib = ("" if res["library_ms"] is None else
           f", torch.matmul on decoded bf16 {res['library_ms']:.5f} ms")
    print(f"# {'K2' if impl == 'fused_dequant' else 'K3'} static weights, "
          f"one gemma3-12b layer (7 matmuls) at M = {M}: kernel {ms:.5f} ms "
          f"({how}), plain {plain_ms:.4f} ms{lib}; bound "
          f"{res['bound_ms']:.5f} ms = max({nbytes} B / 3.35 TB/s = "
          f"{b_bytes:.5f} ms, {2 * prods} operations = {b_ops:.5f} ms) -> "
          f"{res['bound_by']} (kernel / bound "
          f"{ms / res['bound_ms']:.1f}){note}", flush=True)
    return res


def static_kernel_path(dev, codes) -> dict:
    """Static weights through K2 and K3: gemma3-12b at full width, depth 6
    (the static phase's codes, first 6 layers), under
    :func:`k_static_policy` for ``fused_dequant`` (K2) and ``lns`` (K3): 4
    requests of 8 tokens, 4 generated, under the continuous scheduler
    (every matmul at M = 4 slots; K2 only, ``KERNEL_SCHEDULERS``) and the
    bucketed one (one batched prefill at M = 4 x 8 = 32, then decode at
    M = 4), every K2/K3 call held to its plain version on the model's own
    codes (:class:`_ShadowMatmul`).  Launches: 7 x n_layers per model
    call (a sub-step or a batched prefill) of the kernel under test, none
    of the other; the tied LM head stays a bf16 product on the embedding.
    The streams must vary (:func:`_require_varied`, at most a quarter of
    them on one token), so that the kernels see the model's own
    activations.  Then each kernel alone on one layer's weights at M = 4
    and M = 32 beside its bound (:func:`_static_layer_ms`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    rng = np.random.default_rng(7)
    res = {}
    shallow = _shallow(codes, KERNEL_DEPTH)
    for impl, which in (("fused_dequant", "dequant_matmul"),
                        ("lns", "lns_product_matmul")):
        cfg = dataclasses.replace(
            get_config("gemma3-12b"), numerics=k_static_policy(impl),
            n_layers=KERNEL_DEPTH)
        queue = [rng.integers(0, cfg.vocab, size=KERNEL_PLEN)
                 for _ in range(PREFIX_SLOTS)]
        streams, launches = {}, 0
        for scheduler in KERNEL_SCHEDULERS[impl]:
            eng = Engine(cfg, slots=PREFIX_SLOTS,
                         max_seq=KERNEL_PLEN + KERNEL_GEN, page_size=16,
                         rng_seed=0, device=dev)
            eng.params = shallow
            prefills = []
            real_prefill = eng.prefill_batch

            def counted(prompts, slots, real=real_prefill, seen=prefills):
                seen.append(len(prompts) * len(prompts[0]))
                return real(prompts, slots)

            eng.prefill_batch = counted
            _reset_matmul_counts()
            with _ShadowMatmul(which) as shadow:
                run = _counted_run(eng, queue, KERNEL_GEN, scheduler)
            k3, k2 = _matmul_counts()
            got, other = (k2, k3) if impl == "fused_dequant" else (k3, k2)
            calls = run["substeps"] + len(prefills)
            want = 7 * KERNEL_DEPTH * calls
            print(f"# gemma3-12b depth {KERNEL_DEPTH} static weights, "
                  f"matmul {impl}, {scheduler}: {run['substeps']} sub-steps "
                  f"and {len(prefills)} batched prefills (M {prefills}), "
                  f"{got} launches of the kernel under test ({other} of the "
                  f"other), {shadow.calls} calls each within "
                  f"{shadow.err:.3e} of the plain version ({shadow.rel:.2e} "
                  f"of the call's max |plain|; at most {shadow.of_limit:.4f} "
                  f"of the limit {SHADOW_SUM_LIMIT} sqrt(K) 2^-24 "
                  f"sum|products|), at (M, K, N) "
                  f"{sorted(shadow.shapes)}; {run['wall']:.3f} s wall",
                  flush=True)
            if got != want or other or shadow.calls != want:
                raise AssertionError(f"{impl}: {got} launches ({other} of "
                                     f"the other kernel, {shadow.calls} "
                                     f"calls), want {want}")
            if scheduler == "bucketed" and prefills != [
                    PREFIX_SLOTS * KERNEL_PLEN]:
                raise AssertionError(f"bucketed prefills {prefills}")
            _require_varied(run["outputs"], f"static weights through {impl}, "
                            f"{scheduler}", constant_share=0.25)
            streams[scheduler] = run["outputs"]
            launches += got
            mine = res.setdefault(impl, dict(err=0.0, rel=0.0, of_limit=0.0))
            for k in mine:
                mine[k] = max(mine[k], getattr(shadow, k))
            del eng
            torch.cuda.empty_cache()
        if "continuous" in streams:
            share, first = _agreement(streams["continuous"],
                                      streams["bucketed"])
            print(f"# static weights through {impl}: continuous vs bucketed "
                  f"{100 * share:.1f} % of tokens equal, first divergence "
                  f"{first}; distinct tokens per stream "
                  f"{[len(set(o)) for o in streams['bucketed'].values()]}",
                  flush=True)
        res[impl]["launches"] = launches
        for M in (PREFIX_SLOTS, PREFIX_SLOTS * KERNEL_PLEN):
            res[impl][M] = _static_layer_ms(dev, codes["blocks"][0], impl, M)
    return res


# --------------------------------------------------------------------------- #
# K5: the paper's six FP8 operations, through the SwiGLU gate
# --------------------------------------------------------------------------- #
K5_SERVE_SHAPE = (8, 4864)         # one decode sub-step's gate product
K5_TRAIN_SHAPE = (8, 128, 4864)    # batch 8 x seq 128 tokens
# A lower count of K5's work than its compiled instruction stream: three
# 32-bit integer operations per element (the paper's add with its
# constant, the carry-in, the saturation); the instruction stream as
# compiled is printed beside it (SASS), for PERF.md.
K5_MIN_OPS_PER_ELEMENT = 3


def k5_serve_policy():
    """serve_fp8_paged with the gate product through K5 in e5m2 (the
    reference's legacy mapping of QuantConfig(elementwise=True): act_fmt)."""
    from repro_torch.numerics import OpPolicy, get_policy

    return get_policy("serve_fp8_paged").replace(elementwise=OpPolicy(
        fmt="e5m2", mode="rne", impl="auto", accum="f32"))


def k5_train_policy():
    """train_fp8_lns with the gate product through K5 in e4m3 (the legacy
    mapping coerces act_fmt to the weight format under lns)."""
    from repro_torch.numerics import OpPolicy, get_policy

    return get_policy("train_fp8_lns").replace(elementwise=OpPolicy(
        fmt="e4m3", mode="rne", impl="auto", accum="f32"))


def _k5_operands(op, dev):
    import torch

    codes = torch.arange(256, dtype=torch.uint8, device=dev)
    if op in ("mul", "div"):
        X, Y = torch.meshgrid(codes, codes, indexing="ij")
        return X.reshape(-1).contiguous(), Y.reshape(-1).contiguous()
    return codes, None


def check_k5_cells(dev) -> dict:
    """Phase: every supported (format, op, mode) cell of Tables 2/3
    through K5, over all 256 codes or 65,536 code pairs, bitwise against
    the plain version; then the paper's claim on the card: on the exact
    rounding oracle's valid domain, K5's codes are correctly rounded
    (faithful for ``faithful``) in all 69 cells."""
    import torch
    from repro_torch.core.carry_ins import CARRY_INS
    from repro_torch.core.formats import FORMATS
    from repro_torch.core.rounding import Oracle
    from repro_torch.kernels import fp8_elementwise as fe

    cells = passed = checked = 0
    for (fmt, op), modes in sorted(CARRY_INS.items()):
        x, y = _k5_operands(op, dev)
        expected, valid = Oracle(FORMATS[fmt]).quantize_all(
            op, x.cpu().numpy(), None if y is None else y.cpu().numpy())
        for mode, spec in modes.items():
            if spec is None:
                continue
            got = fe.fp8_elementwise(op, x, y, fmt=fmt, mode=mode)
            want = fe.fp8_elementwise_plain(op, x, y, fmt=fmt, mode=mode)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K5 differs from its plain version "
                                     f"in cell {fmt}/{op}/{mode}")
            checked += got.numel()
            got = got.cpu().numpy()
            if mode == "faithful":
                ok = (got == expected["rd"]) | (got == expected["ru"])
            else:
                ok = got == expected[mode]
            cells += 1
            passed += int((~ok & valid).sum()) == 0
    print(f"# K5 cells: {cells} (format, op, mode) cells, {checked} codes, "
          "bitwise equal to the plain version", flush=True)
    print(f"# Tables 2/3 through K5 on the card: {passed}/{cells} cells "
          "correctly rounded (faithful for faithful) on the oracle's valid "
          "domain", flush=True)
    if (passed, cells) != (69, 69):
        raise AssertionError(f"Tables 2/3 through K5: {passed}/{cells}")
    return dict(cells=cells, passed=passed)


def check_k5_shapes(dev) -> dict:
    """Phase: K5 against its plain version on random codes at the main
    paths' shapes (e5m2 and e4m3 mul) and on a ragged, misaligned view;
    then the card time of e5m2 mul at both shapes beside its bound."""
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import fp8_elementwise as fe

    g = torch.Generator(device=dev).manual_seed(13)

    def codes(shape):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)

    ops, err = {}, 0
    for label, shape in (("serve", K5_SERVE_SHAPE), ("train", K5_TRAIN_SHAPE)):
        x, y = codes(shape), codes(shape)
        for fmt in ("e5m2", "e4m3"):
            got = fe.fp8_elementwise("mul", x, y, fmt=fmt, mode="rne")
            want = fe.fp8_elementwise_plain("mul", x, y, fmt=fmt,
                                            mode="rne")
            torch.cuda.synchronize()
            err = max(err, int((got.int() - want.int()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"K5 {fmt} mul differs from its plain "
                                     f"version at {shape}")
        ops[label] = (x, y)
    buf = codes((3 * 4099 + 8,))
    x, y = buf[1:4100], buf[4105:4105 + 4099]   # misaligned, ragged
    for op in ("mul", "div", "rsqrt"):
        got = fe.fp8_elementwise(op, x, None if op == "rsqrt" else y,
                                 fmt="e5m2", mode="rne")
        want = fe.fp8_elementwise_plain(op, x, None if op == "rsqrt" else y,
                                        fmt="e5m2", mode="rne")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {op} differs on a misaligned view")
    print("# K5 mul at the serving and training shapes (e5m2, e4m3) and "
          "mul/div/rsqrt on a misaligned 4,099-code view: bitwise equal to "
          "the plain version", flush=True)

    mix = sass_loop_mix(cuda_build.build(["fp8_elementwise"])[0],
                        "fp8_elementwise_kernelILi0E", per="STG.E.128")
    res = dict(max_abs_err=float(err))  # in code units; 0 = bitwise
    for label, (x, y) in ops.items():
        n, shape = x.numel(), tuple(x.shape)
        k5 = lambda: fe.fp8_elementwise("mul", x, y, fmt="e5m2")  # noqa: E731
        plain = lambda: fe.fp8_elementwise_plain(  # noqa: E731
            "mul", x, y, fmt="e5m2", mode="rne")
        ms, how = device_ms(k5, iters=200, only="fp8_elementwise_kernel")
        plain_ms, _ = device_ms(plain, iters=20)
        call_ms = cuda_ms(k5, iters=200)
        b_bytes = 3 * n / HBM_BYTES_PER_S * 1e3
        b_ops = K5_MIN_OPS_PER_ELEMENT * n / INT32_PER_S * 1e3
        sass_int = mix["int32_per_product"] * n / 16 / INT32_PER_S * 1e3
        res[label] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(b_bytes, b_ops),
                          bound_by="bytes" if b_bytes >= b_ops
                          else "operations")
        print(f"# K5 e5m2 mul at {shape} ({n} codes; card time, {how}): "
              f"kernel {ms:.5f} ms; plain {plain_ms:.4f} ms; bound "
              f"{res[label]['bound_ms']:.5f} ms = max({3 * n} B / 3.35 "
              f"TB/s, {K5_MIN_OPS_PER_ELEMENT} x {n} int32 ops at "
              f"{INT32_PER_S:.4g}/s); the compiled integer stream alone "
              f"{sass_int:.5f} ms; per call incl. host {call_ms:.4f} ms",
              flush=True)
    print("# K5 vector loop (SASS), instructions per 16 codes: "
          + ", ".join(f"{op} {c:.2f}" for op, c in mix["mix"].items())
          + f"; {mix['per_product']:.2f} in all, "
          f"{mix['int32_per_product']:.2f} on the 32-bit integer pipe "
          f"({mix['int32_per_product'] / 16:.2f} per code; "
          f"{(mix['int32_per_product'] + mix['mix'].get('PRMT', 0)) / 16:.2f}"
          " with the byte permutes)", flush=True)
    return res


def check_k5_engine_against_plain(dev) -> None:
    """Phase: a float32 copy of the model under the K5 serving policy:
    the first steps' logits with the gate product through K5 (impl
    "auto") and through the plain version (impl "ref") are bitwise equal,
    since K5's codes are."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import fp8_elementwise as fe

    pol = k5_serve_policy()
    cfg = dataclasses.replace(get_config("qwen2-0.5b", policy=pol),
                              param_dtype="float32")
    ref_pol = pol.replace(elementwise=pol.elementwise.replace(impl="ref"))
    logits, used = [], []
    for c in (cfg, dataclasses.replace(cfg, numerics=ref_pol)):
        before = fe.fp8_elementwise.launches
        logits.append(_first_step_logits(dev, c))
        used.append(fe.fp8_elementwise.launches - before)
    want = 5 * cfg.n_layers  # 4 + 1 sub-steps
    if used != [want, 0]:
        raise AssertionError(f"K5 launches {used}, want [{want}, 0]")
    if not np.array_equal(logits[0], logits[1]):
        raise AssertionError("float32 engine logits through K5 differ from "
                             "those through the plain version: max diff "
                             f"{np.abs(logits[0] - logits[1]).max():.3e}")
    print(f"# float32 engine (K5 serving policy): first-step logits through "
          f"K5 ({used[0]} launches) and through the plain version bitwise "
          "equal", flush=True)


# --------------------------------------------------------------------------- #
# K2 and K3: the quantized matmuls of the training path
# --------------------------------------------------------------------------- #
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12   # H100 SXM fp8 and int8 tensor cores, dense
# One transformer layer's seven quantized matmuls at qwen2-0.5b widths:
# (K, N) -> how many of the layer's matmuls have that shape (wq/wo, wk/wv,
# w_gate/w_up, w_down).
LAYER_MATMULS = {(896, 896): 2, (896, 128): 2, (896, 4864): 2,
                 (4864, 896): 1}
MATMULS_PER_LAYER = 7      # STE matmuls per layer (the tied unembed is not)
SMOKE_M = 1024             # batch 8 x seq 128 tokens
# Instruction rates of the data sheet's card (132 SMs at 1.98 GHz): the
# 67 TFLOP/s float32 rate is 128 FMA lanes per SM, an FMA counted as two
# operations, so an SM issues at most 128 thread-instructions per clock;
# 32-bit integer add, multiply-add, shift, compare and logic run on 64
# lanes per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0).
ISSUE_PER_S = F32_FLOP_PER_S / 2
INT32_PER_S = F32_FLOP_PER_S / 4
SM_CLOCK_HZ = 1.98e9       # the data sheet's boost clock
SHARED_LANES_PER_CLOCK = 32  # one 32-bank wavefront per SM a clock
INT32_OPCODES = {"IADD3", "IADD", "VIADD", "IMAD", "LOP3", "SHF", "ISETP",
                 "LEA", "IMNMX", "VIMNMX", "IABS"}


def _sass_functions(lib) -> dict:
    """Each function's SASS in the built library ``lib`` (``cuobjdump``),
    by mangled name."""
    import re
    import shutil
    from repro_torch.kernels import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return {f.split(None, 1)[0]: f
            for f in re.split(r"\n\s*Function : ", sass)[1:]}


def sass_loop_mix(lib, kernel: str, per: str) -> dict:
    """Instructions per product in ``kernel``'s innermost loop that holds
    the instruction ``per`` (one per product: K3's float add of each
    product; an opcode such as ``FADD``, or a full mnemonic such as
    ``STG.E.128``): all of them, and those of the 32-bit integer pipe.
    Read from the SASS of the built library (``cuobjdump``);
    uniform-datapath (U*) instructions run on another pipe and are not
    counted."""
    import collections
    import re

    (body,) = [f for name, f in _sass_functions(lib).items()
               if kernel in name]
    ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", b.strip()).split()[0])
           for a, b in re.findall(r"/\*([0-9a-f]+)\*/\s+([^;]*);", body)]
    targets = re.findall(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?BRA\s+"
                         r"0x([0-9a-f]+)", body)
    loops = sorted(((int(t, 16), int(a, 16)) for a, t in targets
                    if int(t, 16) <= int(a, 16)), key=lambda lh: lh[1] - lh[0])
    for lo, hi in loops:
        body_ins = [m for a, m in ins if lo <= a <= hi]
        ops = collections.Counter(m.split(".")[0] for m in body_ins)
        n = sum(m == per or m.split(".")[0] == per for m in body_ins)
        if n:
            total = sum(c for op, c in ops.items() if not op.startswith("U"))
            return dict(per_product=total / n,
                        int32_per_product=sum(ops[o] for o in INT32_OPCODES)
                        / n, mix={op: c / n for op, c in ops.most_common()})
    raise AssertionError(f"no loop with {per} in the SASS of {kernel}")


def sass_opcode_counts(lib, kernel: str, opcode: str) -> dict:
    """How many ``opcode`` instructions (``HMMA``: the tensor cores'
    warp-level product) the SASS of each function of the built library
    ``lib`` whose name contains ``kernel`` holds (``cuobjdump``)."""
    import re

    return {name: sum(
        re.sub(r"^@!?U?P\w+\s+", "", b.strip()).split()[0].split(".")[0]
        == opcode for b in re.findall(r"/\*[0-9a-f]+\*/\s+([^;]*);", f))
        for name, f in _sass_functions(lib).items() if kernel in name}


def check_tensor_cores() -> None:
    """Phase: K2 (every instantiation of ``dequant_matmul_kernel``), K3
    (of ``lns_matmul_kernel``) and K6's bf16 body (of
    ``flash_attention_bf16_kernel``) run their products on the tensor
    cores: cuobjdump finds HMMA in each."""
    from repro_torch.kernels import cuda_build

    for source, kernel in (("lns_matmul", "dequant_matmul_kernel"),
                           ("lns_matmul", "lns_matmul_kernel"),
                           ("flash_attention", "flash_attention_bf16_kernel")):
        counts = sass_opcode_counts(cuda_build.build([source])[0], kernel,
                                    "HMMA")
        if not counts or not all(counts.values()):
            raise AssertionError(f"no HMMA in the SASS of {kernel}: {counts}")
        print(f"# SASS: HMMA in all {len(counts)} instantiations of {kernel} "
              f"({source}.cu): " + ", ".join(str(c) for c in counts.values()),
              flush=True)


def _nan_aware_bitwise(a, b) -> bool:
    """Equal bit patterns, except that any NaN equals any NaN (the card's
    float add returns its canonical NaN, the CPU keeps the operand's)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    keep = ~na
    return torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))


def check_k3_products(dev) -> int:
    """Phase: every product of the paper's LNS multiply through K3, per
    format and mode: codes [256, 1] x [1, 256] against the plain version,
    bit for bit.  Returns the number of products checked."""
    import torch
    from repro_torch.core.carry_ins import FACTORED_MUL
    from repro_torch.kernels import lns_matmul as lm

    codes = torch.arange(256, dtype=torch.uint8, device=dev)
    x, w = codes[:, None].contiguous(), codes[None, :].contiguous()
    n = 0
    for fmt, mode in sorted(FACTORED_MUL):
        got = lm.lns_product_matmul(x, w, fmt=fmt, mode=mode)
        want = lm.lns_matmul_plain(x, w, fmt=fmt, mode=mode)
        torch.cuda.synchronize()
        if not _nan_aware_bitwise(got, want):
            raise AssertionError(f"K3 products differ from the plain "
                                 f"version for {fmt}/{mode}")
        n += got.numel()
    print(f"# K3 products: {n} = {len(FACTORED_MUL)} (format, mode) pairs "
          "x 65536, bitwise equal to the plain version (NaN as NaN)",
          flush=True)
    return n


def _n_sm(dev) -> int:
    import torch

    return torch.cuda.get_device_properties(dev).multi_processor_count


def _layer_codes(dev, seed: int, act_fmt: str, w_fmt: str):
    """FP8 codes of the slice's matmul operands: activations [M, K] and
    weights [K, N] for each shape of LAYER_MATMULS, quantized as the STE
    matmul quantizes them (per-tensor / per-output-channel scales)."""
    import torch
    from repro_torch.core.quant import quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for K, N in LAYER_MATMULS:
        x = torch.randn((SMOKE_M, K), generator=g, device=dev)
        w = torch.randn((K, N), generator=g, device=dev) * 0.02
        out[K, N] = (quantize(x, act_fmt).codes,
                     quantize(w, w_fmt, axis=-1).codes)
    return out


def _sum_bound(K, absum):
    """Float32 summation error bound of a K-term sum: 2 K 2^-24 sum|p|."""
    return 2 * K * 2.0 ** -24 * absum


def lns_function_bound() -> dict:
    """The least time of one layer's seven LNS matmuls at M = SMOKE_M
    (K3's function, which K4 computes too), whatever implements them: the
    larger of the bytes they must move (codes in, float32 out) over the
    memory rate and their operations (a multiply and an add of two 8-bit
    operands per product) over the card's fastest dense 8-bit rate."""
    prods = sum(c * SMOKE_M * K * N for (K, N), c in LAYER_MATMULS.items())
    nbytes = sum(c * (SMOKE_M * K + K * N + 4 * SMOKE_M * N)
                 for (K, N), c in LAYER_MATMULS.items())
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = 2 * prods / INT8_OPS_PER_S * 1e3
    return dict(ms=max(b_bytes, b_ops), prods=prods, nbytes=nbytes,
                bytes_ms=b_bytes, ops_ms=b_ops,
                bound_by="bytes" if b_bytes >= b_ops else "operations")


def _per_layer_ms(fn_of_shape, only, iters, warmup=2):
    """Card time of one layer's seven matmuls: per-shape card time of
    ``fn_of_shape(shape)`` times each shape's count in LAYER_MATMULS."""
    total, hows = 0.0, []
    for shape, count in LAYER_MATMULS.items():
        ms, how = device_ms(lambda: fn_of_shape(shape), iters=iters,
                            only=only, warmup=warmup)
        total += count * ms
        hows.append(how)
    return total, " / ".join(sorted(set(hows)))


def check_matmul_kernels(dev) -> dict:
    """Phase: K3 (e4m3 RNE, and e5m2 RU) and K2 against their plain
    versions at the training path's shapes (M = 1024, every (K, N) of a
    qwen2-0.5b layer), then their timings per layer (the seven matmuls of
    one layer's forward) beside the bounds."""
    import torch
    from repro_torch.kernels import lns_matmul as lm
    from repro_torch.kernels.common import code_to_f32, lns_plane_tables

    res = {}
    # K3: e4m3 x e4m3, RNE carry-in (--quant fp8_lns_pallas); then e5m2
    # RU, whose carry-in reads the signs (8 planes: mantissa and sign)
    k3_codes = _layer_codes(dev, 10, "e4m3", "e4m3")
    err = {}
    for fmt, mode, cases in (
            ("e4m3", "rne", k3_codes),
            ("e5m2", "ru", _layer_codes(dev, 12, "e5m2", "e5m2"))):
        for (K, N), (x, w) in cases.items():
            got = lm.lns_product_matmul(x, w, fmt=fmt, mode=mode)
            want = lm.lns_matmul_plain(x, w, fmt=fmt, mode=mode)
            absum = lm.lns_matmul_plain(x & 0x7F, w & 0x7F, fmt=fmt,
                                        mode=mode)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            if not torch.isfinite(got).all() or bool(
                    (diff > _sum_bound(K, absum)).any()):
                raise AssertionError(f"K3 differs from its plain version at "
                                     f"{SMOKE_M}x{K}x{N} ({fmt} {mode})")
            err[fmt, mode] = max(err.get((fmt, mode), 0.0),
                                 float(diff.max()))
            print(f"# K3 {fmt} {mode} {SMOKE_M}x{K}x{N} (tile "
                  f"{lm.lns_tile(SMOKE_M, N, _n_sm(dev))}) vs plain: max "
                  f"|err| {float(diff.max()):.3e} within 2 K 2^-24 "
                  f"sum|products| (max bound "
                  f"{float(_sum_bound(K, absum).max()):.3e})", flush=True)
    res["k3_err"] = err["e4m3", "rne"]     # the training path's cell
    # K2: e5m2 activations x e4m3 weights (train_fp8), bf16 and f32 compute
    k2_codes = _layer_codes(dev, 11, "e5m2", "e4m3")
    err = 0.0
    for cd in (torch.bfloat16, torch.float32):
        for (K, N), (x, w) in k2_codes.items():
            kw = dict(fmt="e5m2", w_fmt="e4m3", compute_dtype=cd)
            got = lm.dequant_matmul(x, w, **kw)
            want = lm.dequant_matmul_plain(x, w, **kw)
            absum = lm.dequant_matmul_plain(x & 0x7F, w & 0x7F, **kw)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            if not torch.isfinite(got).all() or bool(
                    (diff > _sum_bound(K, absum)).any()):
                raise AssertionError(f"K2 differs from its plain version at "
                                     f"{SMOKE_M}x{K}x{N} ({cd})")
            err = max(err, float(diff.max()))
        print(f"# K2 {cd} vs plain, all four shapes: max |err| {err:.3e} "
              "within 2 K 2^-24 sum|products|", flush=True)
    res["k2_err"] = err

    # timings: one layer's seven matmuls at M = 1024
    def k3(shape):
        return lm.lns_product_matmul(*k3_codes[shape], fmt="e4m3", mode="rne")

    def k3_plain(shape):
        return lm.lns_matmul_plain(*k3_codes[shape], fmt="e4m3", mode="rne")

    def k2(shape):
        return lm.dequant_matmul(*k2_codes[shape], fmt="e5m2", w_fmt="e4m3",
                                 compute_dtype=torch.bfloat16)

    def k2_plain(shape):
        return lm.dequant_matmul_plain(*k2_codes[shape], fmt="e5m2",
                                       w_fmt="e4m3",
                                       compute_dtype=torch.bfloat16)

    decoded = {s: (code_to_f32(x, "e5m2").to(torch.bfloat16),
                   code_to_f32(w, "e4m3").to(torch.bfloat16))
               for s, (x, w) in k2_codes.items()}

    def k2_library(shape):
        return torch.matmul(*decoded[shape])

    # K3's GEMM shape as one bf16 product, [M, R K] x [R K, N]: its planes
    # expanded beforehand (a yardstick of the shape, not of the function)
    pt = lns_plane_tables("e4m3", "rne")
    B = pt.B.to(dev)
    A = pt.A.to(dev).to(torch.bfloat16)
    cls = pt.cls.to(dev)

    def planes(shape):
        x, w = k3_codes[shape]
        xi, wi = x.long(), w.long()
        xp = torch.zeros((SMOKE_M, shape[0], pt.R), dtype=torch.bfloat16,
                         device=dev)
        xp.scatter_(2, cls[xi][..., None], A[xi][..., None])
        return (xp.reshape(SMOKE_M, -1),
                B[:, wi].permute(1, 0, 2).reshape(-1, shape[1]))

    expanded = {s: planes(s) for s in LAYER_MATMULS}

    def k3_yardstick(shape):
        return torch.matmul(*expanded[shape])

    res["k3_ms"], how = _per_layer_ms(k3, "lns_matmul_kernel", iters=20)
    res["k3_plain_ms"], _ = _per_layer_ms(k3_plain, "", iters=1, warmup=1)
    yard_ms, _ = _per_layer_ms(k3_yardstick, "", iters=20)
    k3_shape = {(K, N): device_ms(lambda: k3((K, N)), iters=20,
                                  only="lns_matmul_kernel")[0]
                for K, N in LAYER_MATMULS}
    print(f"# K3 per shape (e4m3 RNE, R = {pt.R} planes, card time): "
          + ", ".join(
              f"{SMOKE_M}x{K}x{N} tile {lm.lns_tile(SMOKE_M, N, _n_sm(dev))}"
              f" {ms:.4f} ms = {2 * SMOKE_M * K * N / ms / 1e9:.1f} TFLOP/s "
              f"of the function, {pt.R * 2 * SMOKE_M * K * N / ms / 1e9:.1f}"
              " of planes" for (K, N), ms in k3_shape.items()), flush=True)
    res["k2_ms"], _ = _per_layer_ms(k2, "dequant_matmul_kernel", iters=20)
    res["k2_plain_ms"], _ = _per_layer_ms(k2_plain, "", iters=10)
    res["k2_library_ms"], _ = _per_layer_ms(k2_library, "", iters=50)
    per_shape = {(K, N): device_ms(lambda: k2((K, N)), iters=20,
                                   only="dequant_matmul_kernel")[0]
                 for K, N in LAYER_MATMULS}
    print("# K2 per shape (bf16 compute, card time): " + ", ".join(
        f"{SMOKE_M}x{K}x{N} {ms:.4f} ms = "
        f"{2 * SMOKE_M * K * N / ms / 1e9:.1f} TFLOP/s"
        for (K, N), ms in per_shape.items()), flush=True)

    # least time of one layer's seven matmuls
    fb = lns_function_bound()
    prods, nbytes, b_bytes = fb["prods"], fb["nbytes"], fb["bytes_ms"]
    # beside K3's bound, never as it: the integer route's floor (two issue
    # slots per product) and the plane GEMM's dense bf16 time
    b_int = 2 * prods / ISSUE_PER_S * 1e3
    b_planes = pt.R * 2 * prods / BF16_FLOP_PER_S * 1e3
    # K2: a multiply-add per product at the bf16 tensor-core rate
    b_k2 = 2 * prods / BF16_FLOP_PER_S * 1e3
    res["k3_bound"] = fb["ms"]
    res["k3_bound_by"] = fb["bound_by"]
    res["k2_bound"] = max(b_bytes, b_k2)
    res["k2_bound_by"] = "bytes" if b_bytes >= b_k2 else "operations"
    print(f"# K3 per layer (7 matmuls, M={SMOKE_M}; card time, {how}): "
          f"kernel {res['k3_ms']:.4f} ms = "
          f"{2 * prods / res['k3_ms'] / 1e9:.1f} TFLOP/s of the function, "
          f"{pt.R * 2 * prods / res['k3_ms'] / 1e9:.1f} of planes; plain "
          f"{res['k3_plain_ms']:.3f} ms; bound {res['k3_bound']:.5f} ms = "
          f"max({nbytes} B / 3.35 TB/s = {b_bytes:.5f} ms, {2 * prods} "
          f"operations / 1979 TOP/s = {fb['ops_ms']:.5f} ms) -> "
          f"{res['k3_bound_by']} (kernel / bound "
          f"{res['k3_ms'] / res['k3_bound']:.2f}); beside it: the integer "
          f"route's floor {b_int:.4f} ms (2 issue slots per product at "
          f"{ISSUE_PER_S:.4g}/s), the plane GEMM's dense bf16 time "
          f"{b_planes:.4f} ms ({pt.R} x {2 * prods} FLOP / 989 TFLOP/s); "
          f"yardstick (not K3's library time): bf16 torch.matmul "
          f"[M, {pt.R} K] x [{pt.R} K, N] {yard_ms:.4f} ms", flush=True)
    print(f"# K2 per layer (7 matmuls, M={SMOKE_M}, bf16 compute): kernel "
          f"{res['k2_ms']:.4f} ms = {2 * prods / res['k2_ms'] / 1e9:.1f} "
          f"TFLOP/s; plain {res['k2_plain_ms']:.4f} ms; "
          f"torch.matmul on pre-decoded bf16 {res['k2_library_ms']:.4f} ms; "
          f"bound {res['k2_bound']:.4f} ms = max({nbytes} B / 3.35 TB/s, "
          f"{2 * prods} FLOP / 989 TFLOP/s)", flush=True)
    return res


def _reset_matmul_counts():
    from repro_torch.kernels import lns_matmul as lm

    lm.lns_product_matmul.launches = 0
    lm.dequant_matmul.launches = 0


def _matmul_counts():
    from repro_torch.kernels import lns_matmul as lm

    return lm.lns_product_matmul.launches, lm.dequant_matmul.launches


def train_main_path(dev) -> dict:
    """Phase: the training main path, full-width qwen2-0.5b under
    ``--quant fp8_lns_pallas`` through the port's CLI: 6 steps of batch
    8 x seq 128, checkpoints every 3 steps.  Every STE matmul runs K3 once
    forward and once in the checkpointed recompute of its layer."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config("qwen2-0.5b", quant="fp8_lns_pallas")
    n_steps = 6
    want = 2 * MATMULS_PER_LAYER * cfg.n_layers * n_steps
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.synchronize()
        _reset_matmul_counts()
        t0 = time.perf_counter()
        history = train.main([
            "--arch", "qwen2-0.5b", "--quant", "fp8_lns_pallas",
            "--batch", "8", "--seq", "128", "--steps", str(n_steps),
            "--data", "arith", "--ckpt-every", "3", "--ckpt-dir", tmp,
            "--seed", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3, k2 = _matmul_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [h["loss"] for h in history]
    if [h["step"] for h in history] != [3, 6]:
        raise AssertionError(f"unexpected log points {history}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if history[-1]["restarts"] != 0:
        raise AssertionError(f"{history[-1]['restarts']} restarts")
    if k3 != want or k2 != 0:
        raise AssertionError(f"K3 launches {k3} (want 2 x 7 x "
                             f"{cfg.n_layers} layers x {n_steps} steps = "
                             f"{want}), K2 launches {k2} (want 0)")
    print(f"# train fp8_lns_pallas: {n_steps} full-width steps, losses "
          f"{losses} at steps 3 and 6, 0 restarts, {k3} K3 launches = 2 x 7 "
          f"x {cfg.n_layers} x {n_steps}, 0 K2; {wall:.2f} s wall "
          f"({wall / n_steps:.3f} s per step, init and checkpoints "
          "included)", flush=True)
    return dict(launches=k3)


def _train_setup(dev, cfg, seed: int = 0, batch: int = 8, seq: int = 128):
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, Dataset
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    model = Model(cfg, max_seq=seq)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = steps.make_train_state(model, gen)
    step = steps.build_train_step(model, adamw.OptConfig(
        lr=1e-3, warmup_steps=10, total_steps=100))
    data = Dataset(DataConfig(vocab=cfg.vocab, seq_len=seq,
                              global_batch=batch, seed=seed, kind="arith"))

    def batch_of(i):
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in data.batch(i).items()}

    return state, step, batch_of


def train_k2_path(dev) -> dict:
    """Phase: 3 full-width train steps under policy train_fp8 (e5m2
    activations x e4m3 weights, impl auto -> fused_dequant on the card):
    K2 once forward and once in the recompute of every STE matmul."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-0.5b", policy="train_fp8")
    state, step, batch_of = _train_setup(dev, cfg)
    n_steps = 3
    want = 2 * MATMULS_PER_LAYER * cfg.n_layers * n_steps
    torch.cuda.synchronize()
    _reset_matmul_counts()
    losses = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, metrics = step(state, batch_of(i))
        losses.append(float(metrics["loss"]))
    wall = time.perf_counter() - t0
    k3, k2 = _matmul_counts()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train_fp8 loss {losses}")
    if k2 != want or k3 != 0:
        raise AssertionError(f"K2 launches {k2} (want {want}), K3 {k3}")
    print(f"# train train_fp8: {n_steps} full-width steps, losses {losses}, "
          f"{k2} K2 launches = 2 x 7 x {cfg.n_layers} x {n_steps}, 0 K3; "
          f"{wall / n_steps:.3f} s per step", flush=True)
    return dict(launches=k2)


def train_k5_path(dev) -> dict:
    """Phase: 2 full-width train steps (batch 8 x seq 128, ``arith``)
    under train_fp8_lns with the gate product through K5 in e4m3, through
    ``run_training``: K3 once forward and once in the recompute of every
    STE matmul, K5 once forward and once in the recompute of every
    layer's gate (K5 has no backward kernel: the codes carry no gradient)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Dataset
    from repro_torch.kernels import fp8_elementwise as fe
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault, steps

    cfg = get_config("qwen2-0.5b", policy=k5_train_policy())
    n_steps = 2
    want_k3 = 2 * MATMULS_PER_LAYER * cfg.n_layers * n_steps
    want_k5 = 2 * cfg.n_layers * n_steps
    model = Model(cfg, max_seq=128)
    data = Dataset(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8,
                              seed=0, kind="arith"))

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        return steps.make_train_state(model, gen)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_k5_")
    try:
        torch.cuda.synchronize()
        _reset_matmul_counts()
        fe.fp8_elementwise.launches = 0
        t0 = time.perf_counter()
        _, history = fault.run_training(
            train_step=steps.build_train_step(model, adamw.OptConfig(
                lr=1e-3, warmup_steps=10, total_steps=100)),
            init_state=init_state, dataset=data, max_steps=n_steps,
            ckpt_dir=tmp, ckpt_every=n_steps,
            to_device=lambda b: {k: torch.from_numpy(v).to(dev)
                                 for k, v in b.items()},
            log=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (k3, k2), k5 = _matmul_counts(), fe.fp8_elementwise.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if history[-1]["restarts"] != 0:
        raise AssertionError(f"{history[-1]['restarts']} restarts")
    if (k3, k2, k5) != (want_k3, 0, want_k5):
        raise AssertionError(f"launches K3 {k3} (want {want_k3}), K2 {k2} "
                             f"(want 0), K5 {k5} (want {want_k5})")
    print(f"# train train_fp8_lns + K5 gate (e4m3): {n_steps} full-width "
          f"steps, loss {losses} at step {n_steps}, 0 restarts, {k3} K3 "
          f"launches = 2 x 7 x {cfg.n_layers} x {n_steps}, {k5} K5 launches "
          f"= 2 x {cfg.n_layers} x {n_steps}; {wall:.2f} s wall (init and a "
          "checkpoint included)", flush=True)
    return dict(launches=k5)


def check_train_k5_against_plain(dev) -> None:
    """Phase: the first step's loss and gradient global norm of a float32,
    2-layer, full-width qwen2-0.5b under the K5 training policy, with the
    gate product through K5 (impl "auto") and through the plain version
    (impl "ref"); K3 runs in both.  Tolerance: loss rtol 1e-4, gradient
    norm rtol 1e-3, as for K2/K3 (the codes are equal; the float32 sums
    around them run on the card in the same order, so the two agree far
    inside it)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import fp8_elementwise as fe

    pol = k5_train_policy()
    out = []
    for impl in ("auto", "ref"):
        p = pol.replace(elementwise=pol.elementwise.replace(impl=impl))
        cfg = dataclasses.replace(get_config("qwen2-0.5b", policy=p),
                                  n_layers=2, param_dtype="float32")
        state, step, batch_of = _train_setup(dev, cfg, seed=5)
        before = fe.fp8_elementwise.launches
        _, metrics = step(state, batch_of(0))
        torch.cuda.synchronize()
        used = fe.fp8_elementwise.launches - before
        if used != (2 * cfg.n_layers if impl == "auto" else 0):
            raise AssertionError(f"K5 launches {used} with impl={impl}")
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    (lk, gk), (lp, gp) = out
    if not (math.isclose(lk, lp, rel_tol=1e-4)
            and math.isclose(gk, gp, rel_tol=1e-3)):
        raise AssertionError(f"K5: kernel {out[0]} vs plain {out[1]}")
    print(f"# K5 train_fp8_lns, 2 layers float32, first step: loss "
          f"{lk:.7f} (K5) vs {lp:.7f} (plain), grad norm {gk:.6f} vs "
          f"{gp:.6f}", flush=True)


def profile_train_step(dev, policy=None) -> None:
    """One profiled full-width train step (after a warm-up step) under
    ``--quant fp8_lns_pallas``, or under ``policy``: wall time, card-busy
    share, launches, the kernels that take the time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config

    if policy is None:
        cfg, label = get_config("qwen2-0.5b", quant="fp8_lns_pallas"), \
            "fp8_lns_pallas"
    else:
        cfg = get_config("qwen2-0.5b", policy=policy)
        label = policy.name + (" + K5 gate" if policy.elementwise.quantized
                               else "")
    state, step, batch_of = _train_setup(dev, cfg)
    state, _ = step(state, batch_of(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch_of(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, getattr(e, "self_device_time_total", None)
             or e.self_cuda_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(us for _, us, _ in rows) / 1e6
    if busy <= 0:
        print(f"# profiled train step: {wall:.4f} s wall; the profiler "
              "recorded no device time (busy share not measured)", flush=True)
        return
    k3 = sum(us for k, us, _ in rows if "lns_matmul_kernel" in k) / 1e6
    k2 = sum(us for k, us, _ in rows if "dequant_matmul_kernel" in k) / 1e6
    k5 = sum(us for k, us, _ in rows if "fp8_elementwise_kernel" in k) / 1e6
    print(f"# profiled train step ({label}, full width, batch 8 x "
          f"seq 128): {wall:.4f} s wall; card busy {busy:.4f} s "
          f"({100 * busy / wall:.2f}% of the wall); K3 {k3:.4f} s "
          f"({100 * k3 / busy:.2f}% of busy); K2 {k2:.4f} s "
          f"({100 * k2 / busy:.2f}%); K5 {k5:.5f} s; "
          f"{sum(n for _, _, n in rows)} kernel launches", flush=True)
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"#   {us / 1e3:10.3f} ms  x{n:<6d} {key[:90]}", flush=True)


class _plain_matmuls:
    """Within the block, the K2/K3 wrappers run their plain versions on
    the card (for the end-to-end comparison only; the package itself
    never does this)."""

    def __enter__(self):
        from repro_torch.kernels import lns_matmul as lm

        self.saved = (lm.lns_product_matmul, lm.dequant_matmul,
                      lm.lns_loop_matmul)
        lm.lns_product_matmul = lambda x, w, *, fmt, mode="rne": \
            lm.lns_matmul_plain(x, w, fmt=fmt, mode=mode)
        lm.dequant_matmul = lambda x, w, **kw: lm.dequant_matmul_plain(x, w,
                                                                       **kw)
        lm.lns_loop_matmul = lambda x, w, *, fmt, mode="rne": \
            lm.lns_loop_matmul_plain(x, w, fmt=fmt, mode=mode)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import lns_matmul as lm

        (lm.lns_product_matmul, lm.dequant_matmul,
         lm.lns_loop_matmul) = self.saved
        return False


def check_train_against_plain(dev) -> None:
    """Phase: the first step's loss and gradient global norm of a
    float32, 2-layer, full-width qwen2-0.5b, through the kernels and
    through their plain versions, for K3 (fp8_lns_pallas) and K2
    (train_fp8).  Tolerance: loss rtol 1e-4, gradient norm rtol 1e-3 --
    the float32 sums run in other orders, and a last-bit difference can
    move an activation code across a rounding boundary."""
    import torch
    from repro_torch.configs import get_config

    for label, kw in (("K3 fp8_lns_pallas", dict(quant="fp8_lns_pallas")),
                      ("K2 train_fp8", dict(policy="train_fp8"))):
        cfg = dataclasses.replace(get_config("qwen2-0.5b", **kw),
                                  n_layers=2, param_dtype="float32")
        out = []
        for plain in (False, True):
            state, step, batch_of = _train_setup(dev, cfg, seed=5)
            before = _matmul_counts()
            if plain:
                with _plain_matmuls():
                    _, metrics = step(state, batch_of(0))
            else:
                _, metrics = step(state, batch_of(0))
            torch.cuda.synchronize()
            used = [a - b for a, b in zip(_matmul_counts(), before)]
            if (sum(used) == 0) != plain:
                raise AssertionError(f"{label}: kernel launches {used} with "
                                     f"plain={plain}")
            out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        (lk, gk), (lp, gp) = out
        if not (math.isclose(lk, lp, rel_tol=1e-4)
                and math.isclose(gk, gp, rel_tol=1e-3)):
            raise AssertionError(f"{label}: kernels {out[0]} vs plain "
                                 f"{out[1]}")
        print(f"# {label}, 2 layers float32, first step: loss {lk:.7f} "
              f"(kernels) vs {lp:.7f} (plain), grad norm {gk:.6f} vs "
              f"{gp:.6f}", flush=True)


# --------------------------------------------------------------------------- #
# K6: flash attention, through its entry point and the autotuner
# --------------------------------------------------------------------------- #
# Attention geometries of the repo's models at full width (only these are
# used; the configurations themselves are not ported):
# (label, B, S, H, KV, hd, dv, causal, window, cap), each run in float32
# and in bfloat16
K6_GEOMETRIES = (
    ("qwen2-0.5b", 8, 128, 14, 2, 64, 64, True, 0, 0.0),
    ("qwen2-0.5b", 1, 8192, 14, 2, 64, 64, True, 0, 0.0),
    ("gemma2-27b", 1, 8192, 32, 16, 128, 128, True, 4096, 50.0),
    ("gemma3-12b", 1, 4096, 16, 8, 256, 256, True, 1024, 0.0),
    ("deepseek-v2-lite", 1, 4096, 16, 16, 192, 128, True, 0, 0.0),
)
# bfloat16 outputs: at most one bf16 ulp apart, or at most this far where
# an output lies so close to 0 that a bf16 ulp is finer than the float32
# gap of two summation orders (a float32 max |err| of 4.8e-7 at full
# width on the H100)
K6_BF16_NEAR_ZERO = 1e-5
K6_TIMED = (1, 8192, 14, 2, 64, 64)   # qwen2-0.5b: B, S, H, KV, hd, dv
# The CPU tests' cases at bq = bk = 32:
# (B, Sq, Sk, H, KV, hd, dv, causal, window, cap)
K6_SMALL = (
    (1, 128, 128, 4, 4, 32, 32, True, 0, 0.0),
    (2, 64, 64, 4, 2, 16, 16, True, 0, 0.0),
    (1, 128, 128, 2, 1, 64, 64, True, 32, 0.0),
    (1, 64, 64, 2, 2, 32, 32, True, 0, 30.0),
    (2, 96, 96, 4, 2, 32, 32, True, 0, 0.0),
    (1, 64, 128, 2, 2, 32, 32, False, 0, 0.0),
    (2, 64, 64, 4, 2, 48, 32, True, 0, 0.0),
    (2, 37, 37, 4, 2, 32, 32, True, 0, 0.0),
    (1, 96, 30, 2, 1, 16, 16, False, 16, 0.0),   # rows without a key
)


def _k6_qkv(dev, B, Sq, Sk, H, KV, hd, dv, dtype, seed=0):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, dv))]


def _bf16_ulps(a, b):
    """Distance in bf16 ulps of two bfloat16 tensors (+0 == -0)."""
    import torch

    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i & 0x7FFF))
    return (ordered(a) - ordered(b)).abs()


def _k6_compare(got, want, what) -> float:
    """K6 against its plain version: float32 at rtol = atol = 1e-4;
    bfloat16 at most one bf16 ulp apart, or at most ``K6_BF16_NEAR_ZERO``
    apart (printed when any output needs it).  Returns the max
    |difference|."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"K6 {what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K6 {what}: non-finite output")
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        over = _bf16_ulps(got, want) > 1
        if bool(over.any()):
            d, val = diff[over], want.float().abs()[over]
            print(f"# K6 {what}: {int(over.sum())} of {got.numel()} bf16 "
                  f"outputs more than one ulp apart, max |diff| "
                  f"{float(d.max()):.3g} at |value| up to "
                  f"{float(val.max()):.3g}", flush=True)
            if float(d.max()) > K6_BF16_NEAR_ZERO:
                raise AssertionError(f"K6 {what}: bf16 outputs more than "
                                     "one ulp and more than "
                                     f"{K6_BF16_NEAR_ZERO} apart")
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=f"K6 {what}")
    return float(diff.max())


def check_k6(dev) -> dict:
    """Phase: K6 against its plain version on the card: the CPU tests'
    cases (float32 and bfloat16), the rows without an admissible key,
    every candidate tiling of ``flash_blocks``, and the attention
    geometries of the repo's models at full width (qwen2-0.5b also
    against the port's ``chunked_attention``), each in float32 and in
    bfloat16.  All at pinned tilings: these launches are comparisons,
    not K6's path.  Returns the max |kernel - plain| over all of them;
    the float32 comparisons' own maximum is printed."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    err = err32 = 0.0     # max |kernel - plain|: all; float32 only
    for i, (B, Sq, Sk, H, KV, hd, dv, causal, window, cap) in \
            enumerate(K6_SMALL):
        kw = dict(causal=causal, window=window, cap=cap)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _k6_qkv(dev, B, Sq, Sk, H, KV, hd, dv, dtype, seed=i)
            got = fa.flash_attention(q, k, v, bq=32, bk=32, **kw)
            bq, bk = fa.clamp_blocks(Sq, Sk, 32, 32)
            want = fa.flash_attention_plain(q, k, v, bq=bq, bk=bk, **kw)
            e = _k6_compare(got, want, f"case {i} {dtype}")
            err = max(err, e)
            if dtype == torch.float32:
                err32 = max(err32, e)
                if Sk == 30:   # the corner: sum(v) / 32 from row 47 on
                    corner = (v[0, :, 0].sum(0) / 32).expand(Sq - 47, dv)
                    torch.testing.assert_close(got[0, 47:, 0], corner,
                                               rtol=1e-5, atol=1e-6)
    print(f"# K6 vs plain, the {len(K6_SMALL)} CPU-test cases at bq = bk = 32 "
          "(float32 and bfloat16): within tolerance; rows without an "
          "admissible key = sum(v) / padded key length", flush=True)

    q, k, v = _k6_qkv(dev, 1, 600, 600, 14, 2, 64, 64, torch.float32)
    for bq in (64, 128, 256):
        for bk in (64, 128, 256):
            got = fa.flash_attention(q, k, v, bq=bq, bk=bk)
            want = fa.flash_attention_plain(q, k, v, causal=True, bq=bq,
                                            bk=bk)
            e = _k6_compare(got, want, f"tiling {bq}x{bk}")
            err, err32 = max(err, e), max(err32, e)
    print("# K6 vs plain, every flash_blocks candidate tiling (bq, bk in "
          "64/128/256) at 1 x 600 x 14 heads: within tolerance", flush=True)

    for i, (label, B, S, H, KV, hd, dv, causal, window, cap) in \
            enumerate(K6_GEOMETRIES):
        kw = dict(causal=causal, window=window, cap=cap, bq=128, bk=128)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _k6_qkv(dev, B, S, S, H, KV, hd, dv, dtype, seed=S)
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            what = f"{label} B{B} S{S} {str(dtype)[6:]}"
            e = _k6_compare(got, want, what)
            err = max(err, e)
            if dtype == torch.float32:
                err32 = max(err32, e)
            if dtype == torch.float32 and i == 0:
                chunked = layers.chunked_attention(q, k, v, causal=causal,
                                                   window=window, cap=cap)
                _k6_compare(got, chunked, f"{label} vs chunked_attention")
            print(f"# K6 {label} (H {H}, KV {KV}, hd {hd}, dv {dv}, window "
                  f"{window}, cap {cap:g}) B {B} x S {S} {str(dtype)[6:]}, "
                  f"tiling 128 x 128: max |diff| {e:.3g}, within tolerance "
                  "of the plain version"
                  + (" and of chunked_attention"
                     if dtype == torch.float32 and i == 0 else ""),
                  flush=True)
            del q, k, v, got, want
    print(f"# K6 max |kernel - plain|: {err32:.3g} over the float32 "
          f"comparisons, {err:.3g} over all", flush=True)
    return dict(max_abs_err=err)


def _k6_pairs(B, S, H, causal, window, bq, bk):
    """(admissible (query, key) pairs, pairs in the key tiles K6 visits) of
    self-attention over S tokens: the kernel takes the query rows 64 at a
    time and visits ``key_tile_range``'s tiles for each group."""
    from repro_torch.kernels import flash_attention as fa

    if not causal:
        admissible = S * (min(S, window) if window else S)
    elif window:
        w = min(window, S)
        admissible = w * (w + 1) // 2 + (S - w) * w
    else:
        admissible = S * (S + 1) // 2
    nk = -(-S // bk)
    visited = 0
    for q0 in range(0, -(-S // bq) * bq, bq):
        for g0 in range(q0, q0 + bq, 64):
            rows = min(64, q0 + bq - g0)
            first, last = fa.key_tile_range(g0, rows, S, S, bk, nk, causal,
                                            window)
            visited += (last - first) * bk * 64
    return B * H * admissible, B * H * visited


def time_k6(dev) -> dict:
    """Phase: K6 times at qwen2-0.5b B 1 x S 8192 in bfloat16 (tiling
    128 x 128): the kernel alone (CUDA-graph replays), the wrapper call
    between CUDA events, the plain
    version, the bound, and as a yardstick ``scaled_dot_product_attention``
    on the same tensors in its own layout (transposes outside the timing;
    the port never calls it).  Then the same geometry in float32 (the
    CUDA-core body) and gemma2-27b's windowed, soft-capped geometry in
    bfloat16, each with its rate on the admissible FLOP and the FLOP of
    the tiles the kernel visits."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    B, S, H, KV, hd, dv = K6_TIMED
    q, k, v = _k6_qkv(dev, B, S, S, H, KV, hd, dv, torch.bfloat16, seed=1)
    kw = dict(causal=True, bq=128, bk=128)
    k6 = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(q, k, v, **kw)  # noqa: E731
    # one kernel per call: CUDA-graph replays time it without the host
    # (the profiler has under-reported late in this process)
    ms = graph_ms(k6, launches=20, replays=5)
    call_ms = cuda_ms(k6, iters=10)
    plain_ms, _ = device_ms(plain, iters=3, warmup=1)
    pairs, visited = _k6_pairs(B, S, H, True, 0, 128, 128)
    flops = 2 * (hd + dv) * pairs
    computed = 2 * (hd + dv) * visited
    nbytes = 2 * (B * S * H * hd + B * S * KV * (hd + dv) + B * S * H * dv)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / BF16_FLOP_PER_S * 1e3
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    try:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_ms, _ = device_ms(sdpa, iters=20)
        lib_note = "scaled_dot_product_attention(is_causal, enable_gqa)"
    except TypeError as exc:    # a torch without enable_gqa
        lib_ms, lib_note = None, f"not measured: {exc}"
    print(f"# K6 qwen2-0.5b B {B} x S {S} bf16 causal (card time, "
          f"CUDA-graph events): kernel {ms:.4f} ms = "
          f"{flops / ms / 1e9:.1f} TFLOP/s on the admissible FLOP; wrapper "
          f"call {call_ms:.4f} ms between CUDA events, host included "
          f"({call_ms / ms:.3f}x the kernel); plain {plain_ms:.3f} ms; bound "
          f"{max(b_bytes, b_ops):.5f} ms = max({nbytes} B / 3.35 TB/s, "
          f"{flops:.4g} FLOP ({pairs} admissible pairs x 2 (hd + dv)) / 989 "
          f"TFLOP/s) -> {'bytes' if b_bytes >= b_ops else 'operations'}; "
          f"the tiles it visits hold {computed:.4g} FLOP "
          f"({computed / flops:.3f}x the admissible; the P split adds "
          f"{2 * dv * visited:.4g} more on the tensor cores); library "
          f"{lib_note}: "
          + (f"{lib_ms:.4f} ms" if lib_ms is not None else "null"),
          flush=True)
    del q, k, v, qt, kt, vt

    q, k, v = _k6_qkv(dev, B, S, S, H, KV, hd, dv, torch.float32, seed=1)
    f32_ms = graph_ms(lambda: fa.flash_attention(q, k, v, **kw),
                      launches=5, replays=2)
    print(f"# K6 qwen2-0.5b B {B} x S {S} float32 causal (CUDA-core body, "
          f"card time, CUDA-graph events): {f32_ms:.4f} ms = "
          f"{flops / f32_ms / 1e9:.2f} TFLOP/s on the admissible FLOP, "
          f"{computed / f32_ms / 1e9:.2f} on the visited tiles' (67 TFLOP/s "
          f"float32 peak)", flush=True)
    del q, k, v

    label, gB, gS, gH, gKV, ghd, gdv, causal, window, cap = K6_GEOMETRIES[2]
    q, k, v = _k6_qkv(dev, gB, gS, gS, gH, gKV, ghd, gdv, torch.bfloat16,
                      seed=1)
    gkw = dict(causal=causal, window=window, cap=cap, bq=128, bk=128)
    g_ms = graph_ms(lambda: fa.flash_attention(q, k, v, **gkw),
                    launches=10, replays=3)
    gpairs, gvisited = _k6_pairs(gB, gS, gH, causal, window, 128, 128)
    gflops = 2 * (ghd + gdv) * gpairs
    full = 2 * (ghd + gdv) * gB * gH * gS * gS
    print(f"# K6 {label} B {gB} x S {gS} bf16 (H {gH}, KV {gKV}, hd {ghd}, "
          f"window {window}, cap {cap:g}), tiling 128 x 128 (card time, "
          f"CUDA-graph events): {g_ms:.4f} ms = {gflops / g_ms / 1e9:.1f} "
          f"TFLOP/s on the "
          f"admissible {gflops:.4g} FLOP; the visited tiles hold "
          f"{2 * (ghd + gdv) * gvisited:.4g} FLOP, "
          f"{gvisited / (gB * gH * gS * gS):.3f} of every tile's "
          f"{full:.4g}; bound {gflops / BF16_FLOP_PER_S * 1e3:.5f} ms",
          flush=True)
    del q, k, v
    return dict(ms=ms, plain_ms=plain_ms,
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                library_ms=lib_ms, call_ms=call_ms, f32_ms=f32_ms,
                gemma2_ms=g_ms)


def k6_autotune_path(dev) -> dict:
    """Phase: K6's path, the entry point with the autotuner behind it.
    A fresh cache file; ``flash_attention`` with no tiling at qwen2-0.5b
    geometry, S 2048, bf16: the tuner measures the candidates with K6 on
    bf16 operands (the tensor-core body the call runs), caches the
    fastest under the card's name and ``bf16`` and publishes a ``measured``
    gauge; a second call answers ``cached``, launches K6 once and equals
    a call with that tiling pinned, bit for bit.  K6's launch count is
    read over the two calls (measurement included)."""
    import tempfile

    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.telemetry import default_registry

    S, H, KV, hd = 2048, 14, 2, 64
    q, k, v = _k6_qkv(dev, 1, S, S, H, KV, hd, hd, torch.bfloat16, seed=2)
    saved = {n: os.environ.get(n) for n in ("REPRO_AUTOTUNE",
                                            "REPRO_AUTOTUNE_CACHE")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    path = os.path.join(tmp, "autotune.json")
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    os.environ.pop("REPRO_AUTOTUNE", None)
    autotune.clear_memory_cache()
    try:
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        first = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        tuned_s = time.perf_counter() - t0
        measured = fa.flash_attention.launches
        second = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        with open(path) as f:
            cache = json.load(f)
        tail = f"{S}x{S}x{hd}x{hd}"
        key = (f"flash|torch-{dev.type}|{autotune._device_kind(dev)}|bf16|"
               f"{tail}")
        cands = [[a, b] for a in (64, 128, 256) for b in (64, 128, 256)]
        if list(cache) != [key] or cache[key] not in cands:
            raise AssertionError(f"autotune cache {cache}, want one {key} "
                                 "entry holding a candidate")
        bq, bk = cache[key]
        config = f"{bq}x{bk}"
        reg = default_registry()
        best_us = reg.gauge_value("autotune_block_us", kernel="flash",
                                  site=tail, config=config, source="measured")
        cached = reg.gauge_value("autotune_block_us", kernel="flash",
                                 site=tail, config=config, source="cached")
        if not best_us > 0 or cached != -1.0:
            raise AssertionError(f"autotune gauges: measured {best_us}, "
                                 f"cached {cached}")
        if launches != measured + 1:
            raise AssertionError(f"the cached call launched K6 "
                                 f"{launches - measured} times, want 1")
        pinned = fa.flash_attention(q, k, v, bq=bq, bk=bk)
        torch.cuda.synchronize()
        if not (torch.equal(second, pinned) and torch.equal(first, second)):
            raise AssertionError("autotuned K6 output differs from the "
                                 "pinned tiling's")
        cbq, cbk = fa.clamp_blocks(S, S, bq, bk)
        err = _k6_compare(second, fa.flash_attention_plain(
            q, k, v, causal=True, bq=cbq, bk=cbk), f"autotuned path S {S}")
    finally:
        for n, val in saved.items():
            if val is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = val
        autotune.clear_memory_cache()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"# K6 through the autotuner (qwen2-0.5b S {S} bf16, fresh cache): "
          f"measured 9 candidates in {tuned_s:.3f} s ({measured} launches), "
          f"cached {key} = {config} (best {best_us:.1f} us per call); second "
          f"call answered 'cached' with 1 launch, bitwise equal to the pinned "
          f"tiling and within tolerance of the plain version (max |diff| "
          f"{err:.3g}); {launches} K6 launches on this path", flush=True)
    return dict(launches=launches, max_abs_err=err)


# --------------------------------------------------------------------------- #
# K4: the seed LNS matmul
# --------------------------------------------------------------------------- #
def k4_train_policy():
    """train_fp8_lns with every STE matmul through K4 (impl lns_loop), as
    the reference builds such a policy: no preset, flag or --quant."""
    from repro_torch.numerics import OpPolicy, get_policy

    return get_policy("train_fp8_lns").replace(matmul=OpPolicy(
        fmt="e4m3", mode="rne", impl="lns_loop", accum="bf16"))


def check_k4(dev, k3_layer_ms: float, k3_bound: float) -> dict:
    """Phase: K4 bitwise against its plain version (NaN as NaN) at BENCH_1's
    512 x 512 x 512 (e4m3, RNE) and at the seven matmul shapes of one
    qwen2-0.5b layer at M = 1024 (the codes K3 was timed on); then its
    card time per layer beside K3's, the plain version's and the bound,
    and K4 / K3 at 512^3.  K4 computes K3's function (the same products
    and sums), so its bound is ``k3_bound``, the function's
    (:func:`lns_function_bound`) per layer.  K4's own compiled
    instructions per product (per FFMA), their time at the issue and
    integer rates, and the time of its shared loads at one a lane a clock
    are printed beside it; two calls must agree bit for bit."""
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import lns_matmul as lm

    g = torch.Generator(device=dev).manual_seed(14)
    x512 = torch.randint(0, 256, (512, 512), generator=g, device=dev,
                         dtype=torch.uint8)
    w512 = torch.randint(0, 256, (512, 512), generator=g, device=dev,
                         dtype=torch.uint8)
    cases = {(512, 512, 512): (x512, w512)}
    for (K, N), xw in _layer_codes(dev, 10, "e4m3", "e4m3").items():
        cases[SMOKE_M, K, N] = xw
    for shape, (x, w) in cases.items():
        got = lm.lns_loop_matmul(x, w, fmt="e4m3", mode="rne")
        again = lm.lns_loop_matmul(x, w, fmt="e4m3", mode="rne")
        want = lm.lns_loop_matmul_plain(x, w, fmt="e4m3", mode="rne")
        torch.cuda.synchronize()
        if not _nan_aware_bitwise(got, want):
            raise AssertionError(f"K4 differs from its plain version at "
                                 f"{shape}")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"two K4 calls differ at {shape}")
    splits = {s: lm.loop_split(s[0], s[2], s[1], _n_sm(dev)) for s in cases}
    print(f"# K4 vs plain at {', '.join('x'.join(map(str, s)) for s in cases)}"
          " (e4m3, RNE; 512^3 with every code, NaN included): bitwise "
          "(NaN as NaN), two calls bitwise equal; (splits, tiles a split) "
          + ", ".join(f"{'x'.join(map(str, s))} {v}"
                      for s, v in splits.items()), flush=True)

    layer = {s[1:]: xw for s, xw in cases.items() if s[0] == SMOKE_M}

    def k4(shape):
        return lm.lns_loop_matmul(*layer[shape], fmt="e4m3", mode="rne")

    def k4_plain(shape):
        return lm.lns_loop_matmul_plain(*layer[shape], fmt="e4m3",
                                        mode="rne")

    # "lns_loop_matmul": the kernel and the launch that adds split sums
    ms, how = _per_layer_ms(k4, "lns_loop_matmul", iters=10)
    plain_ms, _ = _per_layer_ms(k4_plain, "", iters=1, warmup=1)
    k4_512, _ = device_ms(lambda: lm.lns_loop_matmul(x512, w512, fmt="e4m3"),
                          iters=10, only="lns_loop_matmul")
    k3_512, _ = device_ms(lambda: lm.lns_product_matmul(x512, w512,
                                                        fmt="e4m3"),
                          iters=10, only="lns_matmul_kernel")
    fb = lns_function_bound()
    prods, nbytes = fb["prods"], fb["nbytes"]
    mix = sass_loop_mix(cuda_build.build(["lns_matmul"])[0],
                        "lns_loop_matmul_kernel", per="FFMA")
    b_issue = mix["per_product"] * prods / ISSUE_PER_S * 1e3
    b_int = mix["int32_per_product"] * prods / INT32_PER_S * 1e3
    b_own = max(b_issue, b_int)           # K4's own instruction stream
    lds = mix["mix"].get("LDS", 0.0)
    b_shared = (lds * prods / (_n_sm(dev) * SHARED_LANES_PER_CLOCK
                               * SM_CLOCK_HZ) * 1e3)
    bound = k3_bound
    print("# K4 k loop (SASS), instructions per product (per FFMA): "
          + ", ".join(f"{op} {c:.3f}" for op, c in mix["mix"].items())
          + f"; {mix['per_product']:.3f} in all ({b_issue:.4f} ms per layer "
          f"at {ISSUE_PER_S:.4g}/s), {mix['int32_per_product']:.3f} on the "
          f"32-bit integer pipe ({b_int:.4f} ms at {INT32_PER_S:.4g}/s); "
          f"{lds:.3f} shared loads per product: {b_shared:.4f} ms per layer "
          f"at one 32-lane load per SM a clock ({_n_sm(dev)} SMs, "
          f"{SM_CLOCK_HZ / 1e9:.2f} GHz)", flush=True)
    print(f"# K4 per layer (7 matmuls, M={SMOKE_M}; card time, {how}): "
          f"kernel {ms:.4f} ms (K3 {k3_layer_ms:.4f} ms, K4/K3 "
          f"{ms / k3_layer_ms:.3f}); plain {plain_ms:.3f} ms; bound "
          f"{bound:.5f} ms, K3's (the function's: max({nbytes} B / 3.35 "
          f"TB/s, {2 * prods} operations / 1979 TOP/s; an in-order sum "
          f"cannot use the 8-bit tensor rate)) (kernel / bound "
          f"{ms / bound:.1f}); K4's own instructions {b_own:.4f} ms and "
          f"shared loads {b_shared:.4f} ms (kernel / the larger "
          f"{ms / max(b_own, b_shared):.3f}); at 512^3: "
          f"K4 {k4_512:.4f} ms, K3 {k3_512:.4f} ms, K4/K3 "
          f"{k4_512 / k3_512:.3f}", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=fb["bound_by"], ratio_512=k4_512 / k3_512)


def train_k4_path(dev) -> dict:
    """Phase: K4's path, 2 full-width qwen2-0.5b train steps (batch 8 x seq
    128, ``arith``) under the lns_loop policy through ``run_training``:
    K4 once forward and once in the recompute of every STE matmul, K3 and
    K2 never."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Dataset
    from repro_torch.kernels import lns_matmul as lm
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault, steps

    cfg = get_config("qwen2-0.5b", policy=k4_train_policy())
    n_steps = 2
    want = 2 * MATMULS_PER_LAYER * cfg.n_layers * n_steps
    model = Model(cfg, max_seq=128)
    data = Dataset(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=8,
                              seed=0, kind="arith"))

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        return steps.make_train_state(model, gen)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_k4_")
    try:
        torch.cuda.synchronize()
        _reset_matmul_counts()
        lm.lns_loop_matmul.launches = 0
        t0 = time.perf_counter()
        _, history = fault.run_training(
            train_step=steps.build_train_step(model, adamw.OptConfig(
                lr=1e-3, warmup_steps=10, total_steps=100)),
            init_state=init_state, dataset=data, max_steps=n_steps,
            ckpt_dir=tmp, ckpt_every=n_steps,
            to_device=lambda b: {k: torch.from_numpy(v).to(dev)
                                 for k, v in b.items()},
            log=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (k3, k2), k4 = _matmul_counts(), lm.lns_loop_matmul.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    if history[-1]["restarts"] != 0:
        raise AssertionError(f"{history[-1]['restarts']} restarts")
    if (k4, k3, k2) != (want, 0, 0):
        raise AssertionError(f"launches K4 {k4} (want {want}), K3 {k3}, K2 "
                             f"{k2} (want 0)")
    print(f"# train train_fp8_lns + matmul lns_loop (K4): {n_steps} "
          f"full-width steps, loss {losses} at step {n_steps}, 0 restarts, "
          f"{k4} K4 launches = 2 x 7 x {cfg.n_layers} x {n_steps}, 0 K3, 0 "
          f"K2; {wall:.2f} s wall (init and a checkpoint included)",
          flush=True)
    return dict(launches=k4)


def check_train_k4_against_plain(dev) -> None:
    """Phase: the first step's loss and gradient global norm of a float32,
    2-layer, full-width qwen2-0.5b under the lns_loop policy, through K4
    and through its plain version.  Tolerance as for K2/K3: loss rtol
    1e-4, gradient norm rtol 1e-3 (K4 is bitwise equal to its plain
    version; the sums around it may run in other orders)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import lns_matmul as lm

    cfg = dataclasses.replace(get_config("qwen2-0.5b",
                                         policy=k4_train_policy()),
                              n_layers=2, param_dtype="float32")
    out = []
    for plain in (False, True):
        state, step, batch_of = _train_setup(dev, cfg, seed=5)
        before = lm.lns_loop_matmul.launches
        if plain:
            with _plain_matmuls():
                _, metrics = step(state, batch_of(0))
        else:
            _, metrics = step(state, batch_of(0))
        torch.cuda.synchronize()
        used = lm.lns_loop_matmul.launches - before
        if used != (0 if plain else 2 * MATMULS_PER_LAYER * cfg.n_layers):
            raise AssertionError(f"K4 launches {used} with plain={plain}")
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    (lk, gk), (lp, gp) = out
    if not (math.isclose(lk, lp, rel_tol=1e-4)
            and math.isclose(gk, gp, rel_tol=1e-3)):
        raise AssertionError(f"K4: kernel {out[0]} vs plain {out[1]}")
    print(f"# K4 lns_loop policy, 2 layers float32, first step: loss "
          f"{lk:.7f} (K4) vs {lp:.7f} (plain), grad norm {gk:.6f} vs "
          f"{gp:.6f}", flush=True)


def _phase(fn, *args, **kw):
    """Run one phase of :func:`main` and print its wall time."""
    t = time.perf_counter()
    out = fn(*args, **kw)
    print(f"# phase {fn.__name__}: {time.perf_counter() - t:.1f} s",
          flush=True)
    return out


def main() -> int:
    import torch

    from repro_torch.numerics import get_policy
    from repro_torch.kernels import cuda_build  # fails outside the repo

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # full float32 products in every comparison on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    cuda_build.build(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        log = cuda_build.ptxas_log(name).strip()
        if log:
            print(f"# nvcc {name}.cu:\n" + "\n".join(
                "#   " + line for line in log.splitlines()), flush=True)
    print(f"# built {len(KERNEL_SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    _phase(check_tensor_cores)
    k1 = _phase(check_k1, dev)
    k1f = _phase(check_k1_float, dev)
    _phase(serve_main_path, dev)
    _phase(check_against_plain_engine, dev)
    _phase(profile_main_path, dev)
    _phase(serve_main_path, dev, policy=None)
    _phase(check_against_plain_engine, dev, policy=None)
    _phase(profile_main_path, dev, policy=None)
    _phase(preemption_path, dev, "serve_fp8_paged")
    _phase(preemption_path, dev, None)
    served_prefix = _phase(prefix_main_path, dev, "serve_fp8_paged")
    params = served_prefix.pop("params")
    served_prefix_float = _phase(prefix_main_path, dev, None, params)
    served_prefix_float.pop("params")
    shared = _phase(preempt_shared_path, dev, "serve_fp8_paged", params)
    shared_float = _phase(preempt_shared_path, dev, None, params)
    _phase(chaos_path, dev, params, served_prefix, shared_float)
    _phase(bucketed_path, dev, "serve_fp8_paged", params, shared["outputs"])
    _phase(bucketed_path, dev, None, params, shared_float["outputs"])
    _phase(bucketed_logits_path, dev, "serve_fp8_paged", params)
    _phase(bucketed_logits_path, dev, None, params)
    static = _phase(static_weights_path, dev, params)  # drops the bf16
    del params
    static_k = _phase(static_kernel_path, dev, static.pop("codes"))
    torch.cuda.empty_cache()
    _phase(profile_main_path, dev, arch="gemma3-12b")
    _phase(profile_main_path, dev, policy=None, arch="gemma3-12b")
    _phase(window_path, dev)
    _phase(dense_family_path, dev, "gemma2-27b")
    _phase(dense_family_path, dev, "qwen3-14b")
    _phase(check_k5_cells, dev)
    k5 = _phase(check_k5_shapes, dev)
    served_k5 = _phase(serve_main_path, dev, policy=k5_serve_policy(),
                       plens=(5, 17, 9, 2), gen=8)
    _phase(check_k5_engine_against_plain, dev)
    _phase(profile_main_path, dev, policy=k5_serve_policy())
    _phase(check_k3_products, dev)
    mm = _phase(check_matmul_kernels, dev)
    trained = _phase(train_main_path, dev)
    trained_k2 = _phase(train_k2_path, dev)
    _phase(check_train_against_plain, dev)
    _phase(profile_train_step, dev)
    _phase(profile_train_step, dev, policy=get_policy("train_fp8"))
    _phase(train_k5_path, dev)
    _phase(check_train_k5_against_plain, dev)
    _phase(profile_train_step, dev, policy=k5_train_policy())
    k6 = _phase(check_k6, dev)
    k6.update(_phase(time_k6, dev))
    tuned = _phase(k6_autotune_path, dev)
    k4 = _phase(check_k4, dev, mm["k3_ms"], mm["k3_bound"])
    trained_k4 = _phase(train_k4_path, dev)
    _phase(check_train_k4_against_plain, dev)

    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(name="lns_paged_partials", route="cuda",
             source=src + "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:400",
             launches=served_prefix["launches"],
             max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="lns_matmul", route="cuda", source=src + "lns_matmul.cu",
             replaces="src/repro/kernels/lns_matmul.py:62",
             launches=trained["launches"], max_abs_err=mm["k3_err"],
             ms=mm["k3_ms"], plain_ms=mm["k3_plain_ms"],
             bound_ms=mm["k3_bound"], bound_by=mm["k3_bound_by"],
             library_ms=None),
        dict(name="dequant_matmul", route="cuda",
             source=src + "lns_matmul.cu",
             replaces="src/repro/kernels/lns_matmul.py:110",
             launches=trained_k2["launches"], max_abs_err=mm["k2_err"],
             ms=mm["k2_ms"], plain_ms=mm["k2_plain_ms"],
             bound_ms=mm["k2_bound"], bound_by=mm["k2_bound_by"],
             library_ms=mm["k2_library_ms"]),
        dict(name="fp8_elementwise", route="cuda",
             source=src + "fp8_elementwise.cu",
             replaces="src/repro/kernels/fp8_elementwise.py:29",
             launches=served_k5["k5_launches"],
             max_abs_err=k5["max_abs_err"],
             ms=k5["train"]["ms"], plain_ms=k5["train"]["plain_ms"],
             bound_ms=k5["train"]["bound_ms"],
             bound_by=k5["train"]["bound_by"], library_ms=None),
        dict(name="lns_loop_matmul", route="cuda",
             source=src + "lns_matmul.cu",
             replaces="src/repro/kernels/lns_matmul.py:91",
             launches=trained_k4["launches"], max_abs_err=0.0,
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None),
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:31",
             launches=tuned["launches"],
             max_abs_err=max(k6["max_abs_err"], tuned["max_abs_err"]),
             ms=k6["ms"], plain_ms=k6["plain_ms"], bound_ms=k6["bound_ms"],
             bound_by=k6["bound_by"], library_ms=k6["library_ms"]),
        dict(name="float_paged_partials", route="cuda",
             source=src + "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:400",
             launches=served_prefix_float["launches"],
             max_abs_err=k1f["max_abs_err"], ms=k1f["ms"],
             plain_ms=k1f["plain_ms"], bound_ms=k1f["bound_ms"],
             bound_by=k1f["bound_by"], library_ms=None),
    ]
    for impl, name, line in (("fused_dequant", "dequant_matmul", 110),
                             ("lns", "lns_matmul", 62)):
        k = static_k[impl]
        m4 = k[PREFIX_SLOTS]
        kernels.append(dict(
            name=f"{name}_static_weights", route="cuda",
            source=src + "lns_matmul.cu",
            replaces=f"src/repro/kernels/lns_matmul.py:{line}",
            launches=k["launches"], max_abs_err=k["err"], ms=m4["ms"],
            plain_ms=m4["plain_ms"], bound_ms=m4["bound_ms"],
            bound_by=m4["bound_by"], library_ms=m4["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
