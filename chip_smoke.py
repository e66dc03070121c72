#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root (it imports ``src/repro_torch``; it imports
nothing of JAX or of the JAX package) and needs one CUDA device and
``nvcc``.  In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. holds kernel K1 (LNS paged decode attention) against its plain PyTorch
   version at qwen2-0.5b attention shapes (B=8, KV=2, G=7, hd=64, page 16,
   up to 64 pages per slot, ragged lengths, masked lanes, fresh-page rows,
   e5m2 pages, stochastic writes): new pages and scales bitwise, output
   within rtol = atol = 1e-4 (float32 sums over hd, page rows and pages in
   another order, and the card's ``expf``), fused == unfused bitwise; then
   times the kernel and the plain version;
4. serves requests of mixed prompt lengths through the full-width
   qwen2-0.5b Engine (policy serve_fp8_paged, continuous scheduler, random
   weights from a seed, a pool that never preempts) with fused decode on
   and off: every request must finish with finite logits, the K1 launch
   count must equal n_layers x sub-steps, and the token streams of the two
   runs must be bitwise equal; a float32 copy of the model must give the
   same first-step logits (rtol = atol = 1e-3) through K1 and through the
   plain attention;
5. traces a short window of the main path with ``torch.profiler`` (card
   busy share, launches per sub-step, the kernels that take the time);
6. prints one JSON line of per-kernel numbers, then the card line again,
   and last ``{"ok": true, "device": {...}}``.

K1's ``ms`` and ``plain_ms`` are card time per call from the profiler
(the kernel alone; all kernels of the plain version), or from CUDA-graph
replays timed with events where the profiler records no device time; the
comment lines also give the per-call time between CUDA events with the
host's launch overhead included.

Any failed check raises, so the script exits non-zero and prints no result
line; it also exits non-zero without a GPU, or when run outside the repo.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
KERNEL_SOURCES = ("paged_attention",)


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
    the CUDA-graph event timing of :func:`graph_ms`.  Returns (ms, how)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if only in e.key and _device_us(e) > 0)
    if us > 0:
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
        KV=KV, G=G, hd=hd, page=page, maxp=maxp, B=B)


def fused(c, impl):
    from repro_torch.kernels.paged_attention import fused_decode_write_attend

    kp, vp, ks, vs = (c[n].clone() for n in ("kp", "vp", "ks", "vs"))
    return fused_decode_write_attend(
        c["q"], c["k_new"], c["v_new"], kp, vp, ks, vs, c["bt"],
        c["lengths"], fmt="e5m2", n_kv_heads=c["KV"], kv_mode="stochastic",
        k_noise=c["k_noise"], v_noise=c["v_noise"], write_mask=c["mask"],
        impl=impl)


def unfused(c):
    import torch
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.serving.page_pool import write_token_page

    kp, vp, ks, vs = (c[n].clone() for n in ("kp", "vp", "ks", "vs"))
    logical = torch.div(c["lengths"], c["page"], rounding_mode="floor")
    rows = c["lengths"] - logical * c["page"]
    pids = c["bt"].gather(1, logical[:, None].long())[:, 0]
    write_token_page(kp, ks, c["k_new"], pids, rows, fmt="e5m2",
                     noise=c["k_noise"], write_mask=c["mask"])
    write_token_page(vp, vs, c["v_new"], pids, rows, fmt="e5m2",
                     noise=c["v_noise"], write_mask=c["mask"])
    out = paged_decode_attention(c["q"], kp, vp, ks, vs, c["bt"],
                                 c["lengths"] + 1, fmt="e5m2",
                                 n_kv_heads=c["KV"])
    return out, kp, ks, vp, vs


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
    m_k, l_k, o_k = pa.paged_partials(*args, **kw)
    m_p, l_p, o_p = pa.page_partials_plain(*args, **kw)
    torch.testing.assert_close(pa._combine_partials(m_k, l_k, o_k),
                               pa._combine_partials(m_p, l_p, o_p),
                               rtol=1e-4, atol=1e-4)
    k1 = lambda: pa.paged_partials(*args, **kw)  # noqa: E731
    plain = lambda: pa.page_partials_plain(*args, **kw)  # noqa: E731
    ms, how = device_ms(k1, iters=200, only="lns_paged_partials")
    plain_ms, plain_how = device_ms(plain, iters=10)
    call_ms, plain_call_ms = cuda_ms(k1, iters=200), cuda_ms(plain, iters=10)

    # least time for the same work: bytes it must move (each input read
    # once: the query, the pages the lengths reach, their scales, the
    # block tables, lengths and inserted rows; each output written once)
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
    bytes_out = 4 * B * maxp * KV * G * (2 + dv)   # m, l, o
    # per (head, valid token): hd LNS products + their sum, and dv p*v
    # multiply-adds; ``tokens`` already sums over the slots
    ops = 2 * KV * G * tokens * (hd + dv)
    bound_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_FLOP_PER_S * 1e3
    print(f"# K1 card time ({how}): kernel {ms:.5f} ms; plain "
          f"{plain_ms:.4f} ms ({plain_how}, all its kernels); bound "
          f"{max(bound_bytes, bound_ops):.5f} ms = max({bytes_in + bytes_out} B / 3.35 TB/s, {ops} ops / 67 "
          f"TFLOP/s); per call incl. host: kernel {call_ms:.4f} ms, plain "
          f"{plain_call_ms:.4f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations")


def serve_main_path(dev) -> dict:
    """Phase 4: the full-width Engine under the continuous scheduler."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import Engine, run_continuous

    cfg = get_config("qwen2-0.5b", policy="serve_fp8_paged")
    rng = np.random.default_rng(0)
    plens = [5, 17, 33, 64, 9, 48, 2, 26]
    queue = [rng.integers(0, cfg.vocab, size=n) for n in plens]
    gen = 24
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
        pa.paged_partials.launches = 0
        t0 = time.perf_counter()
        outputs, stats = run_continuous(eng, queue, gen=gen, chunk=4,
                                        quiet=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pa.paged_partials.launches
        substeps = int(eng.tel.counter_value("serve_substeps_total"))
        if stats["terminal"] != {"finished": len(queue)}:
            raise AssertionError(f"requests not all finished: "
                                 f"{stats['statuses']}")
        if sorted(outputs) != list(range(len(queue))) or any(
                len(o) != gen for o in outputs.values()):
            raise AssertionError("missing or short token streams")
        if launches != cfg.n_layers * substeps:
            raise AssertionError(f"K1 launches {launches} != n_layers "
                                 f"{cfg.n_layers} x sub-steps {substeps}")
        print(f"# serve fused={fused_on}: {len(queue)} requests finished, "
              f"{stats['steps']} steps, {substeps} sub-steps, {launches} K1 "
              f"launches, {wall:.3f} s wall, "
              f"{stats['decode_tok_s']:.2f} decode tok/s", flush=True)
        runs[fused_on] = (outputs, launches)
        del eng
    if runs[True][0] != runs[False][0]:
        raise AssertionError("token streams differ with fused decode on/off")
    print("# token streams bitwise equal with fused decode on and off",
          flush=True)
    return dict(launches=runs[True][1])


def check_against_plain_engine(dev) -> None:
    """Float32 copy of the model: first-step logits through K1 and through
    the plain attention (policy attention_qk impl="ref") agree."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine

    base = get_config("qwen2-0.5b", policy="serve_fp8_paged")
    cfg = dataclasses.replace(base, param_dtype="float32")
    ref_pol = base.policy.replace(attention_qk=dataclasses.replace(
        base.policy.attention_qk, impl="ref"))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 4)).astype(np.int32)
    logits = []
    for c in (cfg, dataclasses.replace(cfg, numerics=ref_pol)):
        eng = Engine(c, slots=2, max_seq=16, page_size=16, rng_seed=3,
                     device=dev)
        eng.pool.ensure_capacity_batch(np.asarray([4, 3]))
        first = eng.step_chunk(toks, np.zeros(2, np.int32),
                               np.asarray([4, 3], np.int32))
        second = eng.step_chunk(toks[:, :1], np.asarray([4, 3], np.int32),
                                np.asarray([1, 1], np.int32))
        logits.append(np.stack([first, second]))
        del eng
    np.testing.assert_allclose(logits[0], logits[1], rtol=1e-3, atol=1e-3)
    print(f"# float32 engine: K1 vs plain-attention logits max diff "
          f"{np.abs(logits[0] - logits[1]).max():.3e}", flush=True)


def profile_main_path(dev) -> None:
    """A short traced window of the main path (8 requests, 4-token
    prompts, 4 generated tokens, after a warm-up run): the card's busy
    share of the window's wall time and the kernels that take it.  CUDA
    activity only, so the host pays little for the tracing."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Engine, run_continuous

    cfg = get_config("qwen2-0.5b", policy="serve_fp8_paged")
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
              "(busy share not measured)", flush=True)
        return
    k1 = sum(us for k, us, _ in rows if "lns_paged_partials" in k) / 1e6
    n_kernels = sum(n for _, _, n in rows)
    top = sorted(rows, key=lambda r: -r[1])[:6]
    print(f"# profile of the main path: {substeps} sub-steps in "
          f"{wall:.4f} s wall; card busy {busy:.4f} s "
          f"({100 * busy / wall:.2f}% of the wall), {n_kernels} kernel "
          f"launches ({n_kernels / max(substeps, 1):.0f} per sub-step); "
          f"K1 {k1:.5f} s ({100 * k1 / busy:.2f}% of busy)", flush=True)
    for key, us, n in top:
        print(f"#   {us / 1e3:10.3f} ms  x{n:<6d} {key[:90]}", flush=True)


def main() -> int:
    import torch

    from repro_torch.kernels import cuda_build  # fails outside the repo

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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

    k1 = check_k1(dev)
    served = serve_main_path(dev)
    check_against_plain_engine(dev)
    profile_main_path(dev)

    kernels = [dict(
        name="lns_paged_partials", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:400",
        launches=served["launches"], max_abs_err=k1["max_abs_err"],
        ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
        bound_by=k1["bound_by"], library_ms=None)]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
