"""Matmul implementation choice: the heuristic branch of
``repro.kernels.autotune.choose_matmul_impl``.

The reference measures ``lns`` against ``fused_dequant`` on an accelerator
and caches the winner by shape and format; the port keeps only the
heuristic it falls back on, which reads nothing but the device (the
measured autotuner is ROADMAP.md Queue 1 item 8):

* on the CPU, ``xla`` (plain decode + float product);
* on CUDA, ``fused_dequant`` (for mixed formats because the LNS product
  is single-format, and otherwise as the reference's default).
"""
from __future__ import annotations

import torch

__all__ = ["choose_matmul_impl"]


def choose_matmul_impl(device) -> str:
    """Resolve ``impl="auto"`` for a product of codes on ``device``."""
    return "xla" if torch.device(device).type == "cpu" else "fused_dequant"
