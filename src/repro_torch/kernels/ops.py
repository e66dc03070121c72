"""Entry point of the quantized matmul: port of ``repro.kernels.ops``.

``matmul_q`` dispatches between

* ``lns``           -- the paper's integer-add products (kernel K3),
* ``fused_dequant`` -- decode into a float product (kernel K2),
* ``xla``           -- plain decode + ``torch.matmul`` (the reference
                       leaves this one to XLA, outside any kernel),
* ``auto``          -- :func:`~repro_torch.kernels.autotune.choose_matmul_impl`
                       of the codes' device.
"""
from __future__ import annotations

import torch

from ..core.quant import QTensor
from .autotune import choose_matmul_impl
from .lns_matmul import dequant_matmul_plain, lns_matmul

__all__ = ["matmul_q"]


def matmul_q(x: QTensor, w: QTensor, *, impl: str = "xla", mode: str = "rne",
             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Quantized matmul: [M, K] @ [K, N] -> f32 [M, N], scales applied.

    Per-tensor scales, or per-channel scales on the non-contracted axes:
    ``x.scale`` broadcasts over rows, ``w.scale`` over columns."""
    if impl == "auto":
        impl = choose_matmul_impl(x.codes.device)
    if impl == "xla":
        acc = dequant_matmul_plain(x.codes, w.codes, fmt=x.fmt, w_fmt=w.fmt,
                                   compute_dtype=compute_dtype)
    elif impl in ("lns", "lns_loop", "fused_dequant"):
        acc = lns_matmul(x.codes, w.codes, fmt=x.fmt, w_fmt=w.fmt,
                         mode=mode, impl=impl, compute_dtype=compute_dtype)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    w_scale = w.scale.to(torch.float32)
    if w_scale.ndim:
        w_scale = w_scale.squeeze()[None, ...]
    return acc * x.scale * w_scale
