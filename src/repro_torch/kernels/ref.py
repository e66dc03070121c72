"""Plain-torch oracles of the kernels: port of ``repro.kernels.ref``.

``fp8_elementwise_ref`` is the saturating core op ``lns_op`` itself (the
function kernel K5 computes).  ``lns_matmul_ref`` materialises every
pairwise LNS product as an ``[M, K, N]`` tensor, so it is for test shapes
only (``lns_matmul.lns_matmul_plain`` is the chunked plain version of K3
that also runs at full width, and ``lns_matmul.dequant_matmul_plain`` that
of K2).
"""
from __future__ import annotations

import torch

from ..core.lns import lns_op
from .common import lns_mul_to_f32

__all__ = ["fp8_elementwise_ref", "lns_matmul_ref"]


def fp8_elementwise_ref(op: str, fmt, mode: str, x_codes, y_codes=None):
    return lns_op(fmt, op, mode, x_codes, y_codes)


def lns_matmul_ref(x_codes, w_codes, fmt="e4m3", mode="rne", *,
                   x_scale=1.0, w_scale=1.0):
    """f32[M, N] = sum_k wide_decode(lns_mul(x[m, k], w[k, n])) * scales."""
    prod = lns_mul_to_f32(x_codes[:, :, None], w_codes[None, :, :], fmt, mode)
    acc = prod.sum(dim=1, dtype=torch.float32)
    return acc * torch.as_tensor(x_scale, dtype=torch.float32) * \
        torch.as_tensor(w_scale, dtype=torch.float32)
