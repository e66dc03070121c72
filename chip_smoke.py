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
   plain PyTorch version (the per-page partials and their combine) at
   qwen2-0.5b attention shapes (B=8, KV=2, G=7, hd=64, page 16, up to 64
   pages per slot, ragged lengths, masked lanes, fresh-page rows, e5m2
   pages, stochastic writes): new pages and scales bitwise, output within
   rtol = atol = 1e-4 (float32 sums over hd, page rows and pages in
   another order, and the card's ``expf``), fused == unfused bitwise;
   slots of length 0 and a window that skips leading pages against the
   plain version, pages outside every slot's admissible range poisoned
   (output finite and bitwise unchanged), two calls bitwise equal; then
   times the kernel and the plain version beside the function's bound
   (its bytes in, and the attention written once);
4. holds K1's float instance against its plain version on the same
   geometry with float pages (bf16, float32, and bf16 with window 32 and
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
10. K5 (the paper's six FP8 operations): every one of the 69 supported
    (format, op, mode) cells over all 256 codes or 65,536 code pairs
    bitwise against the plain version, and the paper's claim on the card:
    on the exact rounding oracle's valid domain K5's codes are correctly
    rounded (faithful for ``faithful``) in 69/69 cells; random codes at
    the serving (8 x 4864) and training (8 x 128 x 4864) gate shapes and
    a misaligned ragged view, bitwise; card time of e5m2 mul at both
    shapes beside the bytes bound, the plain version and the compiled
    instruction count (SASS);
11. serves full-width qwen2-0.5b again with the SwiGLU gate product
    through K5 (serve_fp8_paged with elementwise e5m2; 4 requests, fused
    on and off): K5 launches = K1 launches = n_layers x sub-steps, fused
    == unfused token streams; a float32 copy's first-step logits through
    K5 and through the plain version bitwise equal; a profile of that
    path (launches per sub-step);
12. K3 (the paper's LNS matmul): all 65,536 products of every (format,
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
13. trains full-width qwen2-0.5b through the port's CLI
    (``launch.train.main``, ``--quant fp8_lns_pallas``, batch 8 x seq 128,
    6 steps, checkpoints every 3): finite losses, 0 restarts, and K3
    launches = 2 (forward and checkpointed recompute) x 7 matmuls x 24
    layers x 6 steps; then 3 steps under policy ``train_fp8`` with the K2
    count derived the same way; then the first step's loss and gradient
    norm of a float32 2-layer model through the kernels and through their
    plain versions (loss rtol 1e-4, gradient norm rtol 1e-3), for K3 and
    K2; then one profiled train step under each of the two policies
    (wall, card-busy share, K3's and K2's card time);
14. trains 2 full-width steps under train_fp8_lns with the gate through
    K5 in e4m3 (``run_training``): finite losses, 0 restarts, 672 K3 and
    96 K5 launches (forward and recompute); then the first step of a
    float32 2-layer model through K5 and through the plain version (loss
    rtol 1e-4, gradient norm rtol 1e-3); then one profiled train step
    under that policy;
15. K6 (flash attention) against its plain version: the CPU tests' cases
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
16. K6's path: ``flash_attention`` with no tiling through the autotuner
    on a fresh cache file (qwen2-0.5b geometry, S 2048, bf16): measured
    in bf16, cached under the card's name and ``bf16``, a ``measured``
    gauge; a second call answers
    ``cached``, launches once and is bitwise equal to the pinned tiling
    and within tolerance of the plain version;
17. K4 (the seed LNS matmul) bitwise against its plain version at 512^3
    and at the seven matmul shapes of one qwen2-0.5b layer at M = 1024
    (the narrow ones split over k tiles), two calls bitwise equal; its
    time per layer (its kernel and, where it splits, the launch that adds
    the tiles' sums) beside K3's, the plain version and the bound (K3's:
    both compute one function), its own SASS instructions per product
    (per FFMA), its shared loads per product and the floor they set, and
    K4 / K3 at 512^3;
18. K4's path: 2 full-width train steps under train_fp8_lns with every
    matmul through K4 (``run_training``): finite losses, 0 restarts, 672
    K4 launches and no K3 or K2; then the first step of a float32 2-layer
    model through K4 and through its plain version (loss rtol 1e-4,
    gradient norm rtol 1e-3);
19. prints one JSON line of per-kernel numbers, then the card line again,
    and last ``{"ok": true, "device": {...}}``.

K1's ``ms`` and ``plain_ms`` are card time per call from the profiler
(the kernel alone; all kernels of the plain version, partials and
combine), or from CUDA-graph
replays timed with events where the profiler records no device time; the
comment lines also give the per-call time between CUDA events with the
host's launch overhead included.  The same holds for K1's float instance
(``float_paged_partials``, on bf16 pages), whose launches are those of
the default-policy serving run with fused decode.  K2's and K3's numbers are card time per
layer: the sum over one layer's seven matmul shapes at M = 1024.  K5's
are those of e5m2 mul at the training gate shape (4,980,736 codes), its
launches those of the K5 serving run; its ``max_abs_err`` is in code
units (0: bitwise).  K4's numbers are per layer like K3's, its launches
those of its training run, its ``max_abs_err`` 0 (bitwise, checked).
K6 has no model path (no model calls it, as in the reference): its
launches are those of its path through the autotuner (phase 16,
measurement included), its times those of qwen2-0.5b B 1 x S 8192 bf16,
and its ``max_abs_err`` the largest float32 difference from the plain
version in phase 15.

Any failed check raises, so the script exits non-zero and prints no result
line; it also exits non-zero without a GPU, or when run outside the repo.
"""
from __future__ import annotations

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


def k1_inputs(dev, seed: int = 0):
    """One decode sub-step of attention at qwen2-0.5b shapes."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.quant import encode
    from repro_torch.serving.page_pool import kv_noise

    g = torch.Generator(device="cpu").manual_seed(seed)
    B, KV, G, hd, page, maxp = 8, 2, 7, 64, 16, 64
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


def k1_float_inputs(dev, pdt, seed: int = 0):
    """``k1_inputs``' geometry, lengths and mask with float pages of
    ``pdt`` and the new K/V rows in that dtype (as the model writes them);
    the query stays float32, and float pages draw no noise."""
    import torch

    c = k1_inputs(dev, seed)
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


def check_k1(dev) -> dict:
    """Phase 3: K1 against its plain version, then its timings."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.page_pool import token_row_codes

    c = k1_inputs(dev)
    act = c["mask"]
    kern, plain = fused(c, "auto"), fused(c, "ref")
    torch.cuda.synchronize()
    for i, name in ((1, "k_pages"), (2, "k_scale"), (3, "v_pages"),
                    (4, "v_scale")):
        if not torch.equal(kern[i][1:], plain[i][1:]):
            raise AssertionError(f"K1: new {name} differ from the plain "
                                 "version")
    out_k, out_p = kern[0][act], plain[0][act]
    if not torch.isfinite(out_k).all():
        raise AssertionError("K1: non-finite attention output")
    err = float((out_k - out_p).abs().max())
    torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-4)
    unf = unfused(c)
    if not torch.equal(kern[0][act], unf[0][act]):
        raise AssertionError("K1: fused != unfused attention output")
    for i in (1, 2, 3, 4):
        if not torch.equal(kern[i][1:], unf[i][1:]):
            raise AssertionError("K1: fused != unfused cache update")
    print(f"# K1 vs plain: pages/scales bitwise, max |out err| {err:.3e}, "
          "fused == unfused bitwise", flush=True)
    err = max(err, check_k1_edges(c, "K1"))

    # timings of the kernel proper, on the fused form's inputs as the
    # main path builds them (old pages, new scales, the new rows)
    codes, qs = pa.quantize_q(c["q"][:, 0], "e5m2")
    ln = c["lengths"] + 1
    logical = torch.div(c["lengths"], c["page"], rounding_mode="floor")
    rows = c["lengths"] - logical * c["page"]
    pids = c["bt"].gather(1, logical[:, None].long())[:, 0]
    scales, new_rows = [], []
    for name, new, noise in (("ks", "k_new", "k_noise"),
                             ("vs", "v_new", "v_noise")):
        s = c[name].clone()
        pid, row, s_new = token_row_codes(s, c[new], pids, rows, fmt="e5m2",
                                          noise=c[noise],
                                          write_mask=c["mask"])
        s.index_put_((pid,), s_new)
        scales.append(s)
        new_rows.append(row)
    ins = (*new_rows, logical, rows, c["mask"].to(torch.int32))
    args = (codes, qs, c["kp"], c["vp"], *scales, c["bt"], ln)
    kw = dict(fmt="e5m2", mode="rne", KV=c["KV"], G=c["G"], inserts=ins)
    k1 = lambda: pa.paged_attend(*args, **kw)  # noqa: E731
    plain = lambda: pa._combine_partials(  # noqa: E731
        *pa.page_partials_plain(*args, **kw))
    torch.testing.assert_close(k1(), plain(), rtol=1e-4, atol=1e-4)
    ms, how = device_ms(k1, iters=200, only="lns_paged_partials")
    plain_ms, plain_how = device_ms(plain, iters=10)
    call_ms, plain_call_ms = cuda_ms(k1, iters=200), cuda_ms(plain, iters=10)

    # least time for the same work, the function's whatever computes it:
    # bytes it must move (each input read once: the query, the pages the
    # lengths reach, their scales, the block tables, lengths and inserted
    # rows; its output, the attention [B, KV*G, dv] float32, written once)
    B, KV, G, hd, page, maxp = (c[n] for n in
                                ("B", "KV", "G", "hd", "page", "maxp"))
    pages_needed = int(((ln + page - 1) // page).sum())
    tokens = int(ln.sum())
    dv = c["vp"].shape[-1]
    bytes_in = (B * KV * G * hd + 4 * B            # q codes, q scales
                + pages_needed * page * KV * (hd + dv)  # K, V codes
                + pages_needed * 4 * 2             # page scales
                + 4 * B * maxp + 4 * B             # block tables, lengths
                + B * KV * (hd + dv) + 3 * 4 * B   # inserted rows
                + 2 * 256 * 2 * 4)                 # operand tables
    bytes_out = 4 * B * KV * G * dv                # the attention
    # per (head, valid token): hd LNS products + their sum, and dv p*v
    # multiply-adds; ``tokens`` already sums over the slots
    ops = 2 * KV * G * tokens * (hd + dv)
    bound_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_FLOP_PER_S * 1e3
    print(f"# K1 card time ({how}): kernel {ms:.5f} ms; plain "
          f"{plain_ms:.4f} ms ({plain_how}, all its kernels); bound "
          f"{max(bound_bytes, bound_ops):.6f} ms = max({bytes_in + bytes_out}"
          f" B / 3.35 TB/s, {ops} ops / 67 TFLOP/s); per call incl. host: "
          f"kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; "
          f"{_partials_note(bytes_in, B, maxp, KV, G, dv)}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations")


FLOAT_K1_CASES = (("bfloat16", 0, 0.0), ("float32", 0, 0.0),
                  ("bfloat16", 32, 50.0))     # page dtype, window, softcap


def check_k1_float(dev) -> dict:
    """Phase: K1's float instance against its plain version on
    ``k1_inputs``' geometry with float pages (bf16 and float32, and bf16
    with window 32 and softcap 50): new pages bitwise, scales unchanged,
    output within rtol = atol = 1e-4, fused == unfused bitwise; then its
    times on bf16 pages (the serving path's) beside the byte bound."""
    import torch
    from repro_torch.kernels import paged_attention as pa

    err = 0.0
    for pdt, window, cap in FLOAT_K1_CASES:
        c = k1_float_inputs(dev, getattr(torch, pdt))
        act = c["mask"]
        before = pa.paged_attend.float_launches
        kern, plain = fused(c, "auto", window, cap), fused(c, "ref",
                                                            window, cap)
        torch.cuda.synchronize()
        if pa.paged_attend.float_launches != before + 1:
            raise AssertionError("K1 float: the fused call did not launch "
                                 "the float instance once")
        for i, name in ((1, "k_pages"), (3, "v_pages")):
            if not torch.equal(kern[i][1:], plain[i][1:]):
                raise AssertionError(f"K1 float {pdt}: new {name} differ "
                                     "from the plain version")
        for i, name in ((2, "ks"), (4, "vs")):
            if not torch.equal(kern[i], c[name]):
                raise AssertionError(f"K1 float {pdt}: {name} changed")
        out_k, out_p = kern[0][act], plain[0][act]
        if not torch.isfinite(out_k).all():
            raise AssertionError("K1 float: non-finite attention output")
        case_err = float((out_k - out_p).abs().max())
        err = max(err, case_err)
        torch.testing.assert_close(out_k, out_p, rtol=1e-4, atol=1e-4)
        unf = unfused(c, window, cap)
        if not torch.equal(kern[0][act], unf[0][act]):
            raise AssertionError(f"K1 float {pdt}: fused != unfused output")
        for i in (1, 2, 3, 4):
            if not torch.equal(kern[i][1:], unf[i][1:]):
                raise AssertionError(f"K1 float {pdt}: fused != unfused "
                                     "cache update")
        print(f"# K1 float vs plain ({pdt} pages, window {window}, cap "
              f"{cap}): pages bitwise, scales unchanged, max |out err| "
              f"{case_err:.3e}, fused == unfused bitwise", flush=True)
        if not window:
            err = max(err, check_k1_edges(c, f"K1 float ({pdt} pages)"))

    # timings on the fused form's inputs as the serving path builds them:
    # bf16 pages, the new rows in bf16, a float32 query
    c = k1_float_inputs(dev, torch.bfloat16)
    q, _ = pa.query_operand(c["q"][:, 0], None)
    ln = c["lengths"] + 1
    logical = torch.div(c["lengths"], c["page"], rounding_mode="floor")
    rows = c["lengths"] - logical * c["page"]
    ins = (c["k_new"], c["v_new"], logical, rows, c["mask"].to(torch.int32))
    args = (q, None, c["kp"], c["vp"], c["ks"], c["vs"], c["bt"], ln)
    kw = dict(fmt=None, mode="rne", KV=c["KV"], G=c["G"], inserts=ins)
    k1 = lambda: pa.paged_attend(*args, **kw)  # noqa: E731
    plain = lambda: pa._combine_partials(  # noqa: E731
        *pa.page_partials_plain(*args, **kw))
    torch.testing.assert_close(k1(), plain(), rtol=1e-4, atol=1e-4)
    ms, how = device_ms(k1, iters=200, only="float_paged_partials")
    plain_ms, plain_how = device_ms(plain, iters=10)
    call_ms, plain_call_ms = cuda_ms(k1, iters=200), cuda_ms(plain, iters=10)

    # bytes it must move: the float32 query, the bf16 pages the lengths
    # reach (no scales), block tables, lengths, the inserted rows and their
    # indices; the attention [B, KV*G, dv] float32 written once
    B, KV, G, hd, page, maxp = (c[n] for n in
                                ("B", "KV", "G", "hd", "page", "maxp"))
    pages_needed = int(((ln + page - 1) // page).sum())
    tokens = int(ln.sum())
    dv = c["vp"].shape[-1]
    el = c["kp"].element_size()
    bytes_in = (4 * B * KV * G * hd                    # float32 q
                + pages_needed * page * KV * (hd + dv) * el  # K, V pages
                + 4 * B * maxp + 4 * B                 # block tables, lengths
                + B * KV * (hd + dv) * el + 3 * 4 * B)  # inserted rows
    bytes_out = 4 * B * KV * G * dv                    # the attention
    ops = 2 * KV * G * tokens * (hd + dv)              # q.k and p.v FMAs
    bound_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_FLOP_PER_S * 1e3
    print(f"# K1 float card time ({how}, bf16 pages): kernel {ms:.5f} ms; "
          f"plain {plain_ms:.4f} ms ({plain_how}, all its kernels); bound "
          f"{max(bound_bytes, bound_ops):.6f} ms = max({bytes_in + bytes_out}"
          f" B / 3.35 TB/s, {ops} ops / 67 TFLOP/s); per call incl. host: "
          f"kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; "
          f"{_partials_note(bytes_in, B, maxp, KV, G, dv)}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations")


SERVE_PLENS = (5, 17, 33, 64, 9, 48, 2, 26)   # the serving phases' prompts


def _policy_label(cfg, policy) -> str:
    return cfg.policy.name if policy is not None else "default policy " \
        f"({str(cfg.pdtype).split('.')[-1]} KV pages)"


def serve_main_path(dev, policy="serve_fp8_paged", plens=SERVE_PLENS,
                    gen=24) -> dict:
    """Phases 5, 7 and 11: the full-width Engine under the continuous
    scheduler, fused decode on and off.  K1 runs once per layer and
    sub-step, its LNS instance on FP8 pages, its float instance on float
    pages (``policy=None``, the CLI's default), the other instance never;
    K5 runs as often as K1 when the policy quantizes the SwiGLU gate
    product (else never)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import fp8_elementwise as fe
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import Engine, run_continuous

    cfg = get_config("qwen2-0.5b", policy=policy)
    k5_on = cfg.policy.elementwise.quantized
    fp8 = cfg.policy.kv_quantized
    label = _policy_label(cfg, policy)
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, size=n) for n in plens]
    runs = {}
    for fused_on in (True, False):
        eng = Engine(cfg, slots=8, max_seq=max(plens) + gen, page_size=16,
                     rng_seed=0, fused_decode=fused_on, device=dev)
        sync = eng.sync_logits

        def checked(logits, sync=sync):
            host = sync(logits)
            if host.shape[-1] != cfg.vocab or not np.isfinite(host).all():
                raise AssertionError("non-finite or misshapen logits")
            return host

        eng.sync_logits = checked
        torch.cuda.synchronize()
        pa.paged_attend.launches = 0
        pa.paged_attend.float_launches = 0
        fe.fp8_elementwise.launches = 0
        t0 = time.perf_counter()
        outputs, stats = run_continuous(eng, queue, gen=gen, chunk=4,
                                        quiet=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lns, flt = (pa.paged_attend.launches,
                    pa.paged_attend.float_launches)
        launches, other = (lns, flt) if fp8 else (flt, lns)
        k5 = fe.fp8_elementwise.launches
        substeps = int(eng.tel.counter_value("serve_substeps_total"))
        if stats["terminal"] != {"finished": len(queue)}:
            raise AssertionError(f"requests not all finished: "
                                 f"{stats['statuses']}")
        if sorted(outputs) != list(range(len(queue))) or any(
                len(o) != gen for o in outputs.values()):
            raise AssertionError("missing or short token streams")
        if launches != cfg.n_layers * substeps or other:
            raise AssertionError(
                f"K1 {'LNS' if fp8 else 'float'} launches {launches} != "
                f"n_layers {cfg.n_layers} x sub-steps {substeps}, or "
                f"{other} launches of the other instance")
        if k5 != (launches if k5_on else 0):
            raise AssertionError(f"K5 launches {k5}, want "
                                 f"{launches if k5_on else 0}")
        print(f"# serve {label}"
              f"{' + K5 gate' if k5_on else ''} fused={fused_on}: "
              f"{len(queue)} requests finished, {stats['steps']} steps, "
              f"{substeps} sub-steps, {lns} K1 LNS, {flt} K1 float and {k5} "
              f"K5 launches, {wall:.3f} s wall, "
              f"{stats['decode_tok_s']:.2f} decode tok/s, cache "
              f"{stats['cache_bytes_per_token']:.0f} B/token", flush=True)
        runs[fused_on] = (outputs, launches, k5)
        del eng
    if runs[True][0] != runs[False][0]:
        raise AssertionError("token streams differ with fused decode on/off")
    print("# token streams bitwise equal with fused decode on and off",
          flush=True)
    return dict(launches=runs[True][1], k5_launches=runs[True][2])


PREEMPT_PAGES = 16   # 15 usable pages against a worst case of 48


def _lively(eng, seed: int = 0):
    """Redraw every parameter at std 0.5 from a seed, on the card, so that
    greedy tokens follow the context (the seed init's zero gains and 0.02
    weights repeat each prompt's last token), which makes equal token
    streams a sharp test."""
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
    return eng


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


def profile_main_path(dev, policy="serve_fp8_paged") -> None:
    """A short traced window of the main path (8 requests, 4-token
    prompts, 4 generated tokens, after a warm-up run): the card's busy
    share of the window's wall time, the launches per sub-step and the
    kernels that take the time.  CUDA activity only, so the host pays
    little for the tracing."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, run_continuous

    cfg = get_config("qwen2-0.5b", policy=policy)
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
        print(f"# profile of the main path: {substeps} sub-steps in "
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
    print(f"# profile of the main path ({label}): {substeps} sub-steps in "
          f"{wall:.4f} s wall; card busy {busy:.4f} s "
          f"({100 * busy / wall:.2f}% of the wall), {n_kernels} kernel "
          f"launches ({n_kernels / max(substeps, 1):.0f} per sub-step); "
          f"K1 {k1:.5f} s ({100 * k1 / busy:.2f}% of busy), K5 {k5:.5f} s "
          f"({100 * k5 / busy:.2f}%)", flush=True)
    for key, us, n in top:
        print(f"#   {us / 1e3:10.3f} ms  x{n:<6d} {key[:90]}", flush=True)

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

    check_tensor_cores()
    k1 = check_k1(dev)
    k1f = check_k1_float(dev)
    served = serve_main_path(dev)
    check_against_plain_engine(dev)
    profile_main_path(dev)
    served_float = serve_main_path(dev, policy=None)
    check_against_plain_engine(dev, policy=None)
    profile_main_path(dev, policy=None)
    preemption_path(dev, "serve_fp8_paged")
    preemption_path(dev, None)
    check_k5_cells(dev)
    k5 = check_k5_shapes(dev)
    served_k5 = serve_main_path(dev, policy=k5_serve_policy(),
                                plens=(5, 17, 9, 2), gen=8)
    check_k5_engine_against_plain(dev)
    profile_main_path(dev, policy=k5_serve_policy())
    check_k3_products(dev)
    mm = check_matmul_kernels(dev)
    trained = train_main_path(dev)
    trained_k2 = train_k2_path(dev)
    check_train_against_plain(dev)
    profile_train_step(dev)
    profile_train_step(dev, policy=get_policy("train_fp8"))
    train_k5_path(dev)
    check_train_k5_against_plain(dev)
    profile_train_step(dev, policy=k5_train_policy())
    k6 = check_k6(dev)
    k6.update(time_k6(dev))
    tuned = k6_autotune_path(dev)
    k4 = check_k4(dev, mm["k3_ms"], mm["k3_bound"])
    trained_k4 = train_k4_path(dev)
    check_train_k4_against_plain(dev)

    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(name="lns_paged_partials", route="cuda",
             source=src + "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:400",
             launches=served["launches"], max_abs_err=k1["max_abs_err"],
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
             launches=served_float["launches"],
             max_abs_err=k1f["max_abs_err"], ms=k1f["ms"],
             plain_ms=k1f["plain_ms"], bound_ms=k1f["bound_ms"],
             bound_by=k1f["bound_by"], library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
