#!/usr/bin/env python3
"""Card times of kernels K2, K4, K5 and K6 of the PyTorch port, and one
profiled ``train_fp8`` step, in one or more checkouts of this repository,
each in its own process on one CUDA device.

    python3 scripts/torch_kernel_ab.py [ROOT ...]

Each ROOT is the root of a checkout (default: this one); they run in the
order given, so ``parent change change parent`` compares two commits on
one card in turns.  A child process imports that checkout's
``src/repro_torch`` and ``chip_smoke.py`` (nothing of JAX), builds its
kernels, keeps the card busy for 3 s (so that its clocks are up) and
prints one JSON line:

* ``k2_ms``: card time of K2 over one qwen2-0.5b layer's seven quantized
  matmuls at M = 1024 (bf16 compute), as ``chip_smoke.py`` times it;
* ``k4_ms``: card time of K4 (e4m3, RNE) over the same seven matmuls, as
  ``chip_smoke.py`` times it (every kernel whose name holds
  ``lns_loop_matmul``: the matmul and, where it splits the k tiles, the
  launch that adds their sums);
* ``k5_train_ms``, ``k5_serve_ms``: card time of K5's e5m2 ``mul`` at the
  training gate shape (8 x 128 x 4864 codes) and the serving one (8 x
  4864);
* ``k6_ms``, ``k6_call_ms``: K6 at qwen2-0.5b B 1 x S 8192 bf16 causal,
  tiling 128 x 128: the card time of the kernels whose name holds
  ``flash_attention``, and the wrapper call between CUDA events;
* ``step_s``, ``busy_s``, ``k2_s``, ``launches``: one full-width
  ``train_fp8`` step (batch 8 x seq 128, after a warm-up step): wall, card
  busy time, K2's card time and the kernels launched, from
  ``torch.profiler``.

The card's name and power limit are printed first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def child(root: str) -> dict:
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fp8_elementwise as fe
    from repro_torch.kernels import lns_matmul as lm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cuda_build.build(["lns_matmul", "flash_attention", "fp8_elementwise"])
    res = dict(root=root)
    x = torch.randn((8192, 8192), device=dev)   # 3 s of warm-up: clocks
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3:
        x @ x
    torch.cuda.synchronize()
    del x

    codes = cs._layer_codes(dev, 11, "e5m2", "e4m3")

    def k2(shape):
        return lm.dequant_matmul(*codes[shape], fmt="e5m2", w_fmt="e4m3",
                                 compute_dtype=torch.bfloat16)

    res["k2_ms"], _ = cs._per_layer_ms(k2, "dequant_matmul_kernel", iters=20)

    k4_codes = cs._layer_codes(dev, 10, "e4m3", "e4m3")

    def k4(shape):
        return lm.lns_loop_matmul(*k4_codes[shape], fmt="e4m3", mode="rne")

    res["k4_ms"], _ = cs._per_layer_ms(k4, "lns_loop_matmul", iters=10)
    del k4_codes

    g = torch.Generator(device=dev).manual_seed(13)
    for label, shape in (("train", cs.K5_TRAIN_SHAPE),
                         ("serve", cs.K5_SERVE_SHAPE)):
        xy = [torch.randint(0, 256, shape, generator=g, device=dev,
                            dtype=torch.uint8) for _ in range(2)]
        res[f"k5_{label}_ms"], _ = cs.device_ms(
            lambda: fe.fp8_elementwise("mul", *xy, fmt="e5m2"), iters=200,
            only="fp8_elementwise_kernel")

    B, S, H, KV, hd, dv = cs.K6_TIMED
    q, k, v = cs._k6_qkv(dev, B, S, S, H, KV, hd, dv, torch.bfloat16, seed=1)

    def k6():
        return fa.flash_attention(q, k, v, causal=True, bq=128, bk=128)

    res["k6_ms"], res["k6_how"] = cs.device_ms(k6, iters=10,
                                               only="flash_attention")
    res["k6_call_ms"] = cs.cuda_ms(k6, iters=10)
    del q, k, v

    cfg = get_config("qwen2-0.5b", policy="train_fp8")
    state, step, batch_of = cs._train_setup(dev, cfg)
    state, _ = step(state, batch_of(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch_of(1))
        torch.cuda.synchronize()
        res["step_s"] = time.perf_counter() - t0
    rows = [(e.key, getattr(e, "self_device_time_total", None)
             or e.self_cuda_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    res["busy_s"] = sum(us for _, us, _ in rows) / 1e6
    res["k2_s"] = sum(us for key, us, _ in rows
                      if "dequant_matmul_kernel" in key) / 1e6
    res["launches"] = sum(n for _, _, n in rows)
    return res


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(os.path.abspath(argv[1]))), flush=True)
        return 0
    roots = argv or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rc = 0
    for root in roots:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], timeout=1800).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
