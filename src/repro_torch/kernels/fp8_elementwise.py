"""The paper's six FP8 operations elementwise over code tensors (kernel K5).

Port of ``repro.kernels.fp8_elementwise``: ``mul``, ``div``, ``square``,
``recip``, ``sqrt`` and ``rsqrt`` of Table 1, each an integer add,
subtract, shift or negate of the uint8 codes plus the Table 2/3 carry-in
bit, with the saturating semantics of ``core.lns.lns_op`` (overflow
saturates, underflow and subnormals flush, NaN propagates).  Used by the
quantized model fabric for the SwiGLU gate product.

:func:`fp8_elementwise` launches the hand-written CUDA kernel
(``csrc/fp8_elementwise.cu``) for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it runs the plain version
:func:`fp8_elementwise_plain` (``lns_op`` over the codes); any other
device raises.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.formats import FORMATS
from ..core.lns import folded_constant, lns_op
from .common import elementwise_carry_table
from .cuda_build import check_launch

__all__ = ["OPS", "BINARY_OPS", "fp8_elementwise", "fp8_elementwise_plain"]

OPS = ("mul", "div", "square", "recip", "sqrt", "rsqrt")  # csrc enum order
BINARY_OPS = ("mul", "div")


def fp8_elementwise_plain(op: str, x_codes, y_codes=None, *,
                          fmt: str = "e4m3", mode: str = "rne"):
    """Plain version of K5: ``lns_op`` over the codes (int32 passes)."""
    return lns_op(fmt, op, mode, x_codes, y_codes)


def _lib():
    from .cuda_build import load

    lib = load("fp8_elementwise")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fp8_elementwise.argtypes = ([ci] + [vp] * 3 + [ctypes.c_longlong]
                                        + [ci] * 5 + [vp] * 2)
        lib.fp8_elementwise.restype = ci
        lib._typed = True
    return lib


def _check(op, x_codes, y_codes, fmt, mode):
    """The reference's checks (uint8 codes; binary operands of one shape,
    no broadcasting), and a refusal of every cell K5 cannot compute."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}")
    if (y_codes is not None) != (op in BINARY_OPS):
        raise ValueError(f"{op} takes {2 if op in BINARY_OPS else 1} "
                         "operand(s)")
    for t, name in ((x_codes, "x_codes"), (y_codes, "y_codes")):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8:
            raise ValueError(f"K5: {name} must be a uint8 tensor, got "
                             f"{getattr(t, 'dtype', type(t))}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"K5 runs on CUDA or CPU tensors, not "
                             f"{t.device}")
    if y_codes is not None:
        if y_codes.shape != x_codes.shape:
            raise ValueError(f"K5: operand shapes differ: "
                             f"{tuple(x_codes.shape)} vs "
                             f"{tuple(y_codes.shape)} (no broadcasting)")
        if y_codes.device != x_codes.device:
            raise ValueError("K5: both operands must be on one device")
    if mode == "stochastic":
        raise ValueError("mode='stochastic' needs rbits ({0,1} array), "
                         "which the elementwise kernel does not take")


def fp8_elementwise(op: str, x_codes, y_codes=None, *, fmt: str = "e4m3",
                    mode: str = "rne", block_rows: Optional[int] = None):
    """Apply a paper op to uint8 code tensors of one shape: K5.

    CUDA tensors launch the kernel (``fp8_elementwise.launches`` counts
    it); CPU tensors run :func:`fp8_elementwise_plain`.  A dash cell of
    Tables 2/3 raises ``Unsupported`` and ``mode="stochastic"`` raises
    ``ValueError``, both before any launch.  ``block_rows`` is accepted
    for signature parity with the reference and unused: K5 sizes its grid
    from the element count.
    """
    del block_rows
    _check(op, x_codes, y_codes, fmt, mode)
    if x_codes.device.type == "cpu":
        return fp8_elementwise_plain(op, x_codes, y_codes, fmt=fmt,
                                     mode=mode)
    table = elementwise_carry_table(fmt, op, mode)  # raises Unsupported
    f = FORMATS[fmt]
    x = x_codes.contiguous()
    y = None if y_codes is None else y_codes.contiguous()
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return out
    err = _lib().fp8_elementwise(
        OPS.index(op), x.data_ptr(), None if y is None else y.data_ptr(),
        out.data_ptr(), x.numel(), folded_constant(fmt, op),
        f.min_normal_code, f.max_normal_code, f.nan_code,
        (f.exp_mask << f.man_bits) if f.has_inf else 0x7F,
        table.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "K5")
    fp8_elementwise.launches += 1
    return out


fp8_elementwise.launches = 0
