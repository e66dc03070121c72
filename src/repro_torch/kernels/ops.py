"""Entry points of the quantized ops: port of ``repro.kernels.ops``.

``elementwise_q`` applies one of the paper's six operations to quantized
tensors in the code domain: ``impl="pallas"`` (the reference's name,
kept) runs kernel K5 through ``fp8_elementwise``, ``"ref"`` its plain
version ``ref.fp8_elementwise_ref``.  ``matmul_q`` dispatches between

* ``lns``           -- the paper's integer-add products (kernel K3),
* ``lns_loop``      -- the same products through the reference's seed
                       design, a sequential rank-1 k loop (kernel K4),
* ``fused_dequant`` -- decode into a float product (kernel K2),
* ``xla``           -- plain decode + ``torch.matmul`` (the reference
                       leaves this one to XLA, outside any kernel),
* ``auto``          -- :func:`~repro_torch.kernels.autotune.choose_matmul_impl`
                       of the codes' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.quant import QTensor
from . import fp8_elementwise as fe
from . import ref
from .autotune import choose_matmul_impl
from .lns_matmul import dequant_matmul_plain, lns_matmul

__all__ = ["elementwise_q", "matmul_q"]


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


def elementwise_q(op: str, x: QTensor, y: Optional[QTensor] = None, *,
                  mode: str = "rne", impl: str = "pallas") -> QTensor:
    """Apply a paper op to quantized tensors, staying in the code domain.

    Scale algebra rides along in the LNS view (float32 scalars or vectors,
    exact ops, no approximation):
      mul: s = sx*sy | div: sx/sy | square: sx^2 | recip: 1/sx
      sqrt: sqrt(sx) | rsqrt: 1/sqrt(sx)
    """
    yc = None if y is None else y.codes
    if impl == "pallas":
        codes = fe.fp8_elementwise(op, x.codes, yc, fmt=x.fmt, mode=mode)
    elif impl == "ref":
        codes = ref.fp8_elementwise_ref(op, x.fmt, mode, x.codes, yc)
    else:
        raise ValueError(f"unknown elementwise impl {impl!r}")
    sx = x.scale
    if op == "mul":
        scale = sx * y.scale
    elif op == "div":
        scale = sx / y.scale
    elif op == "square":
        scale = sx * sx
    elif op == "recip":
        scale = 1.0 / sx
    elif op == "sqrt":
        scale = torch.sqrt(sx)
    elif op == "rsqrt":
        scale = torch.rsqrt(sx)
    else:
        raise ValueError(op)
    return QTensor(codes=codes, scale=scale.to(torch.float32), fmt=x.fmt)
