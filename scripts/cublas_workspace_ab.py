#!/usr/bin/env python3
"""What ``CUBLAS_WORKSPACE_CONFIG=:0:0`` costs the PyTorch port's TP=1
serving on one CUDA device, each setting in its own process, and when a
process can still set it.

    python3 scripts/cublas_workspace_ab.py [off|on ...]
    python3 scripts/cublas_workspace_ab.py --probe

The settings run in the order given (default ``off on off on off on``),
since cuBLAS reads the variable once a process.  ``on`` sets it to
``:0:0`` (no split-K workspaces: a column block of a product is computed
as inside the whole product, which every card engine requires,
``launch.mesh.require_column_stable_cublas``), ``off`` leaves it unset
and lets the engine run without that requirement.  Each child serves
``chip_smoke.py``'s
main path once: gemma3-12b at full width and depth under
``serve_fp8_paged``, the prefix cache on, fused decode, the 8 requests
of a 64-token shared prefix, 16 generated tokens each, on the seed-0
``_lively`` weights, and prints one JSON line:

* ``wall_s``, ``decode_tok_s``, ``substeps``: the run's wall clock,
  decode tokens a second and sub-steps;
* ``digest``, ``streams``: SHA-256 of the final paged cache and of the
  token streams (equal digests: the setting moved no bit);
* ``gemv_ms``: card time (CUDA events, 200 calls) of one bf16
  ``torch.matmul`` at M = 4 for each projection of a gemma3-12b layer,
  whole and halved as a TP=2 rank holds it, and ``layer_ms``, the seven
  whole projections of one layer.

``--probe`` runs three children, each setting the variable at another
moment: before anything, after CUDA is initialised (a tensor on the
card) but before any product, and after one bf16 product.  Each then
prints whether gemma3-12b's ``wq`` product at M = 4, [4, 3840] x
[3840, 4096], equals its two column halves bit for bit (``halves_equal``)
and whether ``torch.cuda.is_initialized()`` was true when it set the
variable.

The card's name and power limit are printed first.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, K, N) of a gemma3-12b layer's decode products x [4, K] @ w [K, N]
SHAPES = (("wq", 3840, 4096), ("wk", 3840, 2048), ("wo", 4096, 3840),
          ("w_gate", 3840, 15360), ("w_down", 15360, 3840),
          ("wq/2", 3840, 2048), ("wk/2", 3840, 1024),
          ("w_gate/2", 3840, 7680))
LAYER = ("wq", "wk", "wk", "wo", "w_gate", "w_gate", "w_down")


def _gemv_ms(dev) -> dict:
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, k, n in SHAPES:
        x = torch.randn(4, k, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn(k, n, generator=g, device=dev).to(torch.bfloat16)
        for _ in range(20):
            torch.matmul(x, w)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(200):
            torch.matmul(x, w)
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 200
    return out


PROBES = ("first", "after_init", "after_product")


def probe(when: str) -> int:
    """Set the variable at moment ``when`` of :data:`PROBES`, then test
    whether a product's column halves equal the whole product's."""
    import torch

    os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(4, 3840, generator=g).to(torch.bfloat16)
    w = torch.randn(3840, 4096, generator=g).to(torch.bfloat16)
    if when != "first":
        x, w = x.to(dev), w.to(dev)
    if when == "after_product":
        torch.matmul(x[:, :64], w[:64, :64])
    initialised = torch.cuda.is_initialized()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":0:0"
    x, w = x.to(dev), w.to(dev)
    whole = torch.matmul(x, w)
    halves = torch.cat([torch.matmul(x, w[:, :2048]),
                        torch.matmul(x, w[:, 2048:])], dim=1)
    print(json.dumps(dict(probe=when, initialised_when_set=initialised,
                          halves_equal=bool(torch.equal(whole, halves)))),
          flush=True)
    return 0


def child(setting: str) -> int:
    if setting == "on":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":0:0"
    else:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    if setting == "off":   # the arm that measures what the requirement costs
        serve.require_column_stable_cublas = lambda device: None

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config("gemma3-12b", policy="serve_fp8_paged")
    eng = cs._prefix_engine(dev, cfg, None, prefix_cache=True,
                            fused_decode=True)
    cs._lively(eng)
    run = cs._counted_run(eng, cs._prefix_queue(cfg), cs.PREFIX_GEN)
    streams = json.dumps({str(k): [int(t) for t in v]
                          for k, v in sorted(run["outputs"].items())})
    gemv = _gemv_ms(dev)
    print(json.dumps(dict(
        setting=setting, wall_s=run["wall"],
        decode_tok_s=run["stats"]["decode_tok_s"],
        substeps=run["substeps"], digest=cs._cache_digest(eng.cache),
        streams=hashlib.sha256(streams.encode()).hexdigest(),
        gemv_ms=gemv, layer_ms=sum(gemv[n] for n in LAYER))), flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(argv[1])
    if argv[:1] == ["--probe-child"]:
        return probe(argv[1])
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    if argv == ["--probe"]:
        runs = [("--probe-child", when) for when in PROBES]
    else:
        order = argv or ["off", "on", "off", "on", "off", "on"]
        if any(s not in ("off", "on") for s in order):
            raise SystemExit(f"settings are off or on, got {order}")
        from repro_torch.kernels import cuda_build

        cuda_build.build(["paged_attention"])
        runs = [("--child", setting) for setting in order]
    rc = 0
    for flag, setting in runs:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               flag, setting], timeout=600)
        print(f"# {setting}: child {time.perf_counter() - t0:.1f} s, "
              f"exit {proc.returncode}", flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
