"""LNS helpers shared by the paged-attention kernel and its plain version.

Port of ``repro.kernels.common``: ``code_to_f32`` decodes FP8 codes by bit
placement, and ``lns_prepare``/``lns_combine`` split the paper's
integer-add multiply into per-operand preparation and a cheap per-product
combine.  ``lns_tables`` packs the prepared fields of all 256 codes into
the lookup table the CUDA kernel reads, so the kernel serves every
(format, mode) pair of Tables 2/3 without hard-coding a carry expression.
All functions are plain torch integer ops and run on any device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.carry_ins import mul_carry_constant, mul_carry_term_mask
from ..core.formats import FORMATS, FP8Format
from ..core.lns import LNS_CONSTS
from ..core.quant import f32_from_bits

__all__ = ["LNSOperand", "code_to_f32", "lns_prepare", "lns_combine",
           "lns_tables"]


def _fmt(fmt: FP8Format | str) -> FP8Format:
    return FORMATS[fmt] if isinstance(fmt, str) else fmt


def code_to_f32(codes: torch.Tensor, fmt: FP8Format | str) -> torch.Tensor:
    """uint8 FP8 codes -> float32 by bit placement.

    Normals and zero only: subnormal, NaN and inf codes map to 0, as in
    the reference (the saturating LNS ops never emit them, and the encoder
    flushes subnormals).
    """
    fmt = _fmt(fmt)
    c = codes.to(torch.int64)
    sign = (c >> 7) & 0x1
    mag = c & 0x7F
    exp = mag >> fmt.man_bits
    man = mag & fmt.man_mask
    f32_exp = exp - fmt.bias + 127
    bits = (sign << 31) | (f32_exp << 23) | (man << (23 - fmt.man_bits))
    val = f32_from_bits(bits)
    is_normal = (mag >= fmt.min_normal_code) & (mag <= fmt.max_normal_code)
    return torch.where(is_normal, val, 0.0)


class LNSOperand(NamedTuple):
    """Per-operand fields of the LNS product (see ``lns_prepare``)."""

    s31: torch.Tensor              # int64: sign bit already at bit 31
    mag: torch.Tensor              # int64: magnitude code; the x side
    #                                carries the folded LNS constant, f32
    #                                re-bias and any constant carry-in
    cmask: Optional[torch.Tensor]  # int64 packed factored carry terms, or
    #                                None when the carry-in is a constant
    zero: torch.Tensor             # bool: zero/subnormal operand (FTZ)
    bad: torch.Tensor              # bool: NaN (or inf for e5m2) operand


def lns_prepare(codes: torch.Tensor, fmt: FP8Format | str,
                mode: str = "rne", side: str = "x") -> LNSOperand:
    """Everything per-operand about the paper's mul: bit fields, the
    factored carry-in half for ``side`` ("x" = left, "y" = right) and the
    special-value masks.  The x side also absorbs every additive constant
    of the wide decode (``K - 256``, the f32 exponent re-bias and a
    constant carry-in), so combine is ``mag_x + mag_y (+ c_in)``."""
    fmt = _fmt(fmt)
    Vi = codes.to(torch.int64)
    s31 = (Vi & 0x80) << 24
    mag = Vi & 0x7F
    if side == "x":
        folded = (LNS_CONSTS[(fmt.name, "mul")] - 256) + (
            (127 - fmt.bias) << fmt.man_bits)
        const_cin = mul_carry_constant(fmt.name, mode)
        if const_cin is not None:
            folded += const_cin
        mag = mag + folded
    cmask = mul_carry_term_mask(fmt.name, mode, Vi, side)
    zero = (Vi & 0x7F) < fmt.min_normal_code
    if fmt.has_inf:
        bad = (Vi & 0x7F) >= (fmt.exp_mask << fmt.man_bits)
    else:
        bad = (Vi & 0x7F) == 0x7F
    return LNSOperand(s31=s31, mag=mag, cmask=cmask, zero=zero, bad=bad)


def lns_combine(px: LNSOperand, py: LNSOperand,
                fmt: FP8Format | str) -> torch.Tensor:
    """Finish the integer-add product, decoded wide to float32: one or two
    integer adds, then the pre-biased magnitude shifted into the exponent
    and mantissa fields.  FTZ operands give 0, NaN/inf operands NaN."""
    fmt = _fmt(fmt)
    mag = px.mag + py.mag
    if px.cmask is not None:
        mag = mag + ((px.cmask & py.cmask) != 0).to(torch.int64)
    val = f32_from_bits((px.s31 ^ py.s31) | (mag << (23 - fmt.man_bits)))
    val = torch.where(px.zero | py.zero, 0.0, val)
    return torch.where(px.bad | py.bad, float("nan"), val)


# Bit layout of the packed flag word of ``lns_tables`` (mirrored in
# csrc/paged_attention.cu): factored carry mask in bits 0..15.
ZERO_BIT = 1 << 16
BAD_BIT = 1 << 17


def lns_tables(fmt: FP8Format | str, mode: str,
               device=None) -> torch.Tensor:
    """int32 ``[2, 256, 2]`` table of the prepared fields of every code:
    ``[side, code] = (mag, flags)`` for side x (0) and y (1), where
    ``flags`` packs the carry mask, the zero and bad bits and the sign.
    A constant carry-in is folded into the x magnitudes and leaves the
    masks 0, so ``(flags_x & flags_y & 0xFFFF) != 0`` is the carry bit
    in every mode."""
    codes = torch.arange(256, dtype=torch.int64)
    out = torch.zeros((2, 256, 2), dtype=torch.int64)
    for i, side in enumerate(("x", "y")):
        p = lns_prepare(codes, fmt, mode, side)
        cm = torch.zeros_like(codes) if p.cmask is None else p.cmask
        assert int(cm.max()) < ZERO_BIT, "carry terms exceed 16 bits"
        flags = (cm | p.zero.to(torch.int64) * ZERO_BIT
                 | p.bad.to(torch.int64) * BAD_BIT | p.s31)
        out[i, :, 0] = p.mag
        out[i, :, 1] = flags
    # two's-complement narrowing keeps the sign bit of the flags word
    out = torch.where(out >= 2**31, out - 2**32, out)
    return out.to(torch.int32).to(device)
