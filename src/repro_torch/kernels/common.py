"""LNS helpers shared by the port's kernels and their plain versions.

Port of ``repro.kernels.common``: ``code_to_f32`` decodes FP8 codes by bit
placement, and ``lns_prepare``/``lns_combine`` split the paper's
integer-add multiply into per-operand preparation and a cheap per-product
combine.  ``lns_tables`` packs the prepared fields of all 256 codes into
the lookup table K1 reads, so it serves every (format, mode) pair
of Tables 2/3 without hard-coding a carry expression;
``lns_plane_tables`` factors the same product into a power of two of x
and a bf16 table of (class of x, y), the exact one-hot planes K3
multiplies on the tensor cores and the exact factors K4 multiplies and
adds in one FFMA a product; likewise
``elementwise_carry_table`` gives K5 the carry bit of one (format, op,
mode) cell for every operand pair.  All functions are plain torch integer
ops and run on any device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.carry_ins import (carry_in, mul_carry_constant,
                              mul_carry_term_mask)
from ..core.formats import FORMATS, FP8Format
from ..core.lns import LNS_CONSTS
from ..core.quant import f32_from_bits

__all__ = ["LNSOperand", "code_to_f32", "lns_prepare", "lns_combine",
           "lns_mul_to_f32", "lns_tables", "device_lns_tables",
           "PlaneTables", "lns_plane_tables", "device_plane_table",
           "carry_index", "elementwise_carry_table"]


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


def lns_mul_to_f32(X: torch.Tensor, Y: torch.Tensor, fmt: FP8Format | str,
                   mode: str = "rne") -> torch.Tensor:
    """The paper's integer-add FP8 product of codes X and Y (broadcast
    against each other), decoded wide to float32: no saturation, FTZ
    operands give 0, NaN/inf operands NaN."""
    return lns_combine(lns_prepare(X, fmt, mode, side="x"),
                       lns_prepare(Y, fmt, mode, side="y"), fmt)


# Bit layout of the packed flag word of ``lns_tables`` (mirrored in
# csrc/lns_common.cuh): factored carry mask in bits 0..15.
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


_DEVICE_TABLES = {}


def device_lns_tables(fmt: str, mode: str, device) -> torch.Tensor:
    """:func:`lns_tables` on ``device``, built once per (fmt, mode,
    device) and kept: the kernels read it on every launch."""
    key = (fmt, mode, torch.device(device))
    lut = _DEVICE_TABLES.get(key)
    if lut is None:
        lut = _DEVICE_TABLES[key] = lns_tables(fmt, mode, device=device)
    return lut


# --------------------------------------------------------------------------- #
# The product factored over one-hot planes (kernel K3)
# --------------------------------------------------------------------------- #
class PlaneTables(NamedTuple):
    """The paper's product of codes x and y as ``A(x) * B[cls(x), y]``
    (see :func:`lns_plane_tables`)."""

    R: int                 # number of classes (planes)
    cls: torch.Tensor      # int64 [256]: the class of every code as x
    A: torch.Tensor        # float32 [256]: A(x), NaN for a NaN/inf code
    B: torch.Tensor        # bfloat16 [R, 256]: B[r, y]
    sign_classes: bool     # the class holds x's sign (its carry reads it)
    bad_min: int           # smallest NaN/inf magnitude code (7 bits)


_PLANE_TABLES = {}


def lns_plane_tables(fmt: FP8Format | str, mode: str) -> PlaneTables:
    """The paper's product ``P(x, y)`` (:func:`lns_mul_to_f32`) factored
    exactly as ``A(x) * B[cls(x), y]``.

    ``A(x)`` is x with its mantissa bits cleared, decoded: ``sign *
    2**(e - bias)``, 0 for a zero or subnormal code and NaN for a NaN/inf
    code (marked: decoding its bits would give a number, 256 for e4m3's
    0x7F).  ``cls(x)`` is x's mantissa field, with x's sign above it where
    the mode's carry-in reads x's sign (e5m2 ``ru``/``rd``), so
    ``R = 2**man_bits`` classes, twice that with the sign.  ``B[r, y] =
    P(rep_r, y) / A(rep_r)`` for the class's code ``rep_r`` of exponent
    ``bias`` (``A = +-1``): the carry-in, the folded LNS constant and the
    mantissa overflow all live in B, which is NaN in every class for a
    NaN/inf y and 0 for a zero or subnormal y.  Every B entry holds
    ``man_bits + 1`` significant bits, so it is exact in bf16 and every
    product ``A * B`` is exact in float32.  Both facts, and ``A * B == P``
    in value on all 65,536 pairs (NaN exactly where P is NaN), are
    asserted.  Built once per (fmt, mode) and kept."""
    fmt = _fmt(fmt)
    key = (fmt.name, mode)
    tables = _PLANE_TABLES.get(key)
    if tables is not None:
        return tables
    codes = torch.arange(256, dtype=torch.int64)
    px = lns_prepare(codes, fmt, mode, side="x")
    sign_classes = px.cmask is not None and bool(
        (px.cmask != px.cmask[codes ^ 0x80]).any())
    cls = codes & fmt.man_mask
    if sign_classes:
        cls = cls | ((codes >> 7) << fmt.man_bits)
    R = (fmt.man_mask + 1) << int(sign_classes)
    exp = (codes & 0x7F) >> fmt.man_bits
    sign = 1.0 - 2.0 * ((codes >> 7) & 1).to(torch.float32)
    A = sign * torch.exp2((exp - fmt.bias).to(torch.float32))
    A = torch.where(px.zero, 0.0, A)
    A = torch.where(px.bad, float("nan"), A)
    r = torch.arange(R, dtype=torch.int64)
    rep = ((r & fmt.man_mask) | (fmt.bias << fmt.man_bits)
           | ((r >> fmt.man_bits) << 7))
    Bf = lns_mul_to_f32(rep[:, None], codes[None, :], fmt, mode)
    Bf = Bf * A[rep, None]                      # A(rep_r) = +-1
    B = Bf.to(torch.bfloat16)
    nan = torch.isnan(Bf)
    assert torch.equal(torch.isnan(B), nan) and torch.equal(
        B.float()[~nan], Bf[~nan]), "a plane entry is not exact in bf16"
    P = lns_mul_to_f32(codes[:, None], codes[None, :], fmt, mode)
    AB = A[:, None] * B.float()[cls]
    pnan = torch.isnan(P)
    assert torch.equal(torch.isnan(AB), pnan) and torch.equal(
        AB[~pnan], P[~pnan]), "the product does not factor over the planes"
    bad_min = int(codes[px.bad & (codes < 0x80)].min())
    tables = _PLANE_TABLES[key] = PlaneTables(
        R=R, cls=cls, A=A, B=B, sign_classes=sign_classes, bad_min=bad_min)
    return tables


_DEVICE_PLANES = {}


def device_plane_table(fmt: str, mode: str, device) -> torch.Tensor:
    """The B table of :func:`lns_plane_tables` (bf16 ``[R, 256]``) on
    ``device``, built once per (fmt, mode, device) and kept: K3 reads it
    on every launch."""
    key = (fmt, mode, torch.device(device))
    B = _DEVICE_PLANES.get(key)
    if B is None:
        B = _DEVICE_PLANES[key] = lns_plane_tables(fmt, mode).B.to(device)
    return B


# --------------------------------------------------------------------------- #
# Carry bits of the elementwise ops (kernel K5)
# --------------------------------------------------------------------------- #
def carry_index(V):
    """The 5 bits of a code that any Table 2/3 carry-in reads -- bits 0-3
    and the sign bit 7 -- packed as ``(V & 0xF) | ((V >> 7) << 4)``."""
    return (V & 0xF) | (((V >> 7) & 1) << 4)


def _code_of_index(i):
    return (i & 0xF) | (((i >> 4) & 1) << 7)


_CARRY_TABLES = {}


def elementwise_carry_table(fmt: str, op: str, mode: str) -> torch.Tensor:
    """The carry bit of cell (fmt, op, mode) for every operand pair, as
    int32 ``[32]``: bit ``carry_index(y)`` of word ``carry_index(x)``.

    Built once per cell, by evaluating the tested :func:`carry_in` on the
    1,024 (x, y) combinations of the bits it reads (bits 0-3 and 7 of each
    operand; a unary op's carry ignores y, so every bit of a word is
    equal).  A constant carry gives an all-0 or all-1 table; a dash cell
    of Tables 2/3 raises ``Unsupported``.  The table stays on the host:
    K5 takes its 128 bytes as a kernel parameter, not from device memory.
    """
    key = (fmt, op, mode)
    table = _CARRY_TABLES.get(key)
    if table is None:
        idx = torch.arange(32, dtype=torch.int64)
        X = _code_of_index(idx)[:, None]
        Y = _code_of_index(idx)[None, :]
        bits = carry_in(fmt, op, mode, X, Y if op in ("mul", "div") else None)
        bits = torch.broadcast_to(torch.as_tensor(bits, dtype=torch.int64),
                                  (32, 32))
        words = (bits << idx[None, :]).sum(dim=1)
        # two's-complement narrowing keeps bit 31
        words = torch.where(words >= 2**31, words - 2**32, words)
        table = _CARRY_TABLES[key] = words.to(torch.int32)
    return table
