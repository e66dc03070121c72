"""Tiling and implementation choices of the port's kernels, with a
persistent cache: port of ``repro.kernels.autotune``.

``flash_blocks`` answers K6's ``(bq, bk)`` tiling (``flash_attention``
asks for it when the caller pins none), from, in order:

  1. the on-disk cache: one JSON file, keyed by kernel kind, the port's
     backend tag (``torch-cuda`` or ``torch-cpu``), the device's name
     (``torch.cuda.get_device_name``: a tiling measured on one card is
     never replayed on another sharing the file), the operands' dtype
     (K6 runs another body for bf16 than for float32, so a tiling tuned
     for one is never replayed for the other) and the problem shape.
     The backend tag keeps the port's entries apart from the JAX
     package's, so a file shared between the two never replays one's
     tiling in the other;
  2. live measurement over a candidate grid, in the caller's dtype, on
     CUDA devices or when forced;
  3. the reference's heuristic default.

Knobs (environment):

  REPRO_AUTOTUNE        "0"/"off"/"never": never measure; "1"/"force"/
                        "always": measure on any device, the CPU included;
                        unset: measure on CUDA devices only.
  REPRO_AUTOTUNE_CACHE  cache file path (default
                        ``~/.cache/repro_torch/autotune.json``).

The cache write is atomic (tmp file + rename), so concurrent processes at
worst re-measure; measurement runs the kernel with explicit blocks, so
the tuner never recurses into itself.  A candidate that raises is never
skipped: the error, a refused launch (``cuda_build.KernelLaunchError``)
among them, propagates and nothing is cached.  Every
answer publishes an ``autotune_block_us`` gauge (labels kernel, site,
config, source = measured | cached | heuristic) into the telemetry
registry (``serving/telemetry.py::record_autotune``).

``choose_matmul_impl`` keeps only the reference's heuristic branch, which
reads nothing but the device: ``xla`` (plain decode + float product) on
the CPU, ``fused_dequant`` on CUDA (for mixed formats because the LNS
product is single-format, and otherwise as the reference's default).
The reference's ``matmul_blocks``, ``elementwise_block_rows``,
``paged_blocks`` and the measured branch of ``choose_matmul_impl`` wait
for kernels that take a tiling (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["cache_path", "clear_memory_cache", "flash_blocks",
           "choose_matmul_impl"]

_LOCK = threading.Lock()
_CACHE: Optional[Dict[str, list]] = None


def cache_path() -> pathlib.Path:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return pathlib.Path(env).expanduser()
    return pathlib.Path("~/.cache/repro_torch/autotune.json").expanduser()


def _load() -> Dict[str, list]:
    global _CACHE
    with _LOCK:
        if _CACHE is None:
            try:
                _CACHE = json.loads(cache_path().read_text())
            except (OSError, ValueError):
                _CACHE = {}
        return _CACHE


def _store(key: str, value) -> None:
    cache = _load()
    with _LOCK:
        cache[key] = list(value) if isinstance(value, (tuple, list)) else value
        path = cache_path()
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(cache, f, indent=0, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass  # the cache is an optimization; never fail the op over it


def clear_memory_cache() -> None:
    """Drop the in-process view (tests; external edits to the cache file)."""
    global _CACHE
    with _LOCK:
        _CACHE = None


def _device_kind(device) -> str:
    """Sanitized device name for cache keys (``NVIDIA_H100_80GB_HBM3``),
    or ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    kind = torch.cuda.get_device_name(device)
    return kind.strip().replace("|", "/").replace(" ", "_") or "unknown"


def _fmt_config(config) -> str:
    if isinstance(config, (tuple, list)):
        return "x".join(str(c) for c in config)
    return str(config)


def _publish(kernel: str, site: str, config, best_s: Optional[float],
             source: str) -> None:
    """Mirror one tuning decision into the telemetry registry as
    ``autotune_block_us{kernel, site, config, source}``; answers that
    timed nothing in this process (cached, heuristic) publish -1.0."""
    from ..serving.telemetry import record_autotune

    record_autotune(kernel, site, _fmt_config(config),
                    -1.0 if best_s is None else best_s * 1e6, source)


def _should_measure(device) -> bool:
    env = os.environ.get("REPRO_AUTOTUNE", "").lower()
    if env in ("0", "off", "never"):
        return False
    if env in ("1", "force", "always"):
        return True
    return torch.device(device).type == "cuda"


def _time_call(fn: Callable[[], object], device, n: int = 5,
               warmup: int = 2) -> float:
    """Seconds per call of ``fn``, the device synchronised around the
    timed calls (PyTorch returns before a CUDA kernel ends)."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n


def _measure_best(key: str, candidates: Sequence[tuple], make_fn, device,
                  *, kernel: str, site: str):
    """Time each candidate, cache and return the fastest (first on tie).

    Every error propagates, unlike the reference, which skips a candidate
    that raises: a refused launch or a sticky CUDA error is never taken
    for a slow tiling."""
    best, best_t = None, float("inf")
    for cand in candidates:
        t = _time_call(make_fn(cand), device)
        if t < best_t:
            best, best_t = cand, t
    _publish(kernel, site, best, best_t, "measured")
    _store(key, best)
    return best


# --------------------------------------------------------------------------- #
# Flash attention (K6)
# --------------------------------------------------------------------------- #
def _flash_default(Sq: int, Sk: int) -> Tuple[int, int]:
    """The reference's heuristic: shrink to the sequence length only when
    it is itself a multiple of 8, otherwise keep 128 and pad."""
    return (min(128, Sq) if Sq % 8 == 0 else 128,
            min(128, Sk) if Sk % 8 == 0 else 128)


_DTYPE_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}  # K6's dtypes


def flash_blocks(Sq: int, Sk: int, hd: int, dv: int, *, device,
                 dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(bq, bk) tiling for ``flash_attention`` at this shape on
    ``device`` for operands of ``dtype``: measured, when it measures, on
    operands of that dtype, and cached under a key that names it."""
    backend = f"torch-{torch.device(device).type}"
    tail = f"{Sq}x{Sk}x{hd}x{dv}"
    key = (f"flash|{backend}|{_device_kind(device)}|{_DTYPE_TAGS[dtype]}|"
           f"{tail}")
    cached = _load().get(key)
    if cached is not None:
        _publish("flash", tail, tuple(cached), None, "cached")
        return tuple(cached)
    default = _flash_default(Sq, Sk)
    if not _should_measure(device):
        _publish("flash", tail, default, None, "heuristic")
        return default

    from .flash_attention import flash_attention

    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn((1, S, 4, d), generator=gen).to(device, dtype)
               for S, d in ((Sq, hd), (Sk, hd), (Sk, dv)))
    candidates = [(bq, bk) for bq in (64, 128, 256) for bk in (64, 128, 256)
                  if bq <= Sq and bk <= Sk] or [default]

    def make_fn(cand):
        bq, bk = cand
        return lambda: flash_attention(q, k, v, bq=bq, bk=bk)

    return tuple(_measure_best(key, candidates, make_fn, device,
                               kernel="flash", site=tail))


# --------------------------------------------------------------------------- #
# Matmul implementation (heuristic branch only)
# --------------------------------------------------------------------------- #
def choose_matmul_impl(device) -> str:
    """Resolve ``impl="auto"`` for a product of codes on ``device``."""
    return "xla" if torch.device(device).type == "cpu" else "fused_dequant"
