"""The paper's approximate FP8 operations via integer arithmetic (LNS domain).

The port's copy of ``repro.core.lns``.  An FP8 code read as an 8-bit
integer is (via Mitchell) the scaled log2 of its value plus the bias
constant ``B``; hence multiplication becomes integer addition, division
subtraction, square a left shift, square root a right shift (Table 1 of
the paper).  A per-(op, format, rounding-mode) carry-in bit
(``carry_ins.py``) turns the raw approximation into a correctly-rounded or
faithfully-rounded result wherever Tables 2/3 claim it is possible.

Two entry points:

  * :func:`lns_op_raw` -- the paper-faithful mod-256 integer expression,
    valid exactly on the paper's domain (normal operands, in-range result).
  * :func:`lns_op` -- the saturating wrapper: saturates on overflow,
    flushes subnormals/underflow to zero, propagates NaN, handles zero
    operands.  This is what kernel K5 (``kernels/fp8_elementwise.py``)
    computes and what the quantized layers use.

Both take Python ints, numpy arrays or integer torch tensors (on any
device) and compute in int32, as the reference does: uint8 arithmetic
would wrap.  A torch tensor gives a uint8 torch tensor; anything else a
uint8 numpy array.  ``tests/test_torch_lns.py`` pins both against the
reference bit for bit over every code (pair) of every supported cell.
"""
from __future__ import annotations

import numpy as np
import torch

from .carry_ins import Unsupported, carry_in, stochastic_carry_in
from .formats import FORMATS, FP8Format

__all__ = [
    "LNS_CONSTS",
    "RSQRT_NEG_FIRST",
    "lns_op_raw",
    "lns_op",
    "Unsupported",
]

# (format, op): additive constant K such that result = f(X, Y) + K + c_in,
# already including the -1 decrements the paper applies so the carry-in
# can compensate in one direction.  e5m2 recip is 0x77, not the paper's
# printed 0x87 (a typo the reference's exhaustive tests expose).
LNS_CONSTS = {
    ("e5m2", "mul"): 0xC4,     # X + Y - B          (B = 0x3c)
    ("e5m2", "square"): 0xC4,  # (X << 1) - B
    ("e5m2", "div"): 0x3B,     # X - Y + B - 1
    ("e5m2", "recip"): 0x77,   # -X + 2B - 1
    ("e5m2", "sqrt"): 0x1E,    # (X >> 1) + B/2
    ("e5m2", "rsqrt"): 0x5A,   # (-X) >> 1 + 3B/2
    ("e4m3", "mul"): 0xC8,     # X + Y - B          (B = 0x38)
    ("e4m3", "square"): 0xC8,  # (X << 1) - B
    ("e4m3", "div"): 0x37,     # X - Y + B - 1
    ("e4m3", "recip"): 0x6F,   # -X + 2B - 1
    ("e4m3", "sqrt"): 0x1B,    # (X >> 1) + B/2 - 1
    ("e4m3", "rsqrt"): 0x53,   # (-X) >> 1 + 3B/2 - 1
}

# The paper prints eq. (28)/(49) with "<<" but Table 1 and the derivation
# give ">>".  Of the two shift/negate orders for rsqrt the reference's
# exhaustive validation selects negate first:
#   True:   ((-X) >> 1) + K   (arithmetic shift, i.e. floor(-X/2) = -ceil(X/2))
#   False:  (-(X >> 1)) + K   (= -floor(X/2))
RSQRT_NEG_FIRST = True


def _fmt(fmt: FP8Format | str) -> FP8Format:
    return FORMATS[fmt] if isinstance(fmt, str) else fmt


def _i32(V) -> torch.Tensor:
    if isinstance(V, torch.Tensor):
        return V.to(torch.int32)
    return torch.from_numpy(np.asarray(V).astype(np.int32))


def _out(codes: torch.Tensor, like):
    """uint8 result in the caller's kind: torch in, torch out."""
    codes = codes.to(torch.uint8)
    return codes if isinstance(like, torch.Tensor) else codes.numpy()


def _lns_core(fmt: FP8Format, op: str, Xi, Yi=None):
    """The shift/add part of the LNS expression, in int32, before + K + cin."""
    if op == "mul":
        return Xi + Yi
    if op == "square":
        return Xi << 1
    if op == "div":
        return Xi - Yi
    if op == "recip":
        return -Xi
    if op == "sqrt":
        return Xi >> 1
    if op == "rsqrt":
        if RSQRT_NEG_FIRST:
            return (-Xi) >> 1  # arithmetic: floor(-X/2)
        return -(Xi >> 1)
    raise ValueError(f"unknown op {op!r}")


def _carry(fmt: FP8Format, op: str, mode: str, X, Y=None, rbits=None):
    """Mode-dispatching carry-in: Table 2/3 expression, or the stochastic
    RD/RU selection when mode == "stochastic" (needs ``rbits``)."""
    if mode == "stochastic":
        if rbits is None:
            raise ValueError("mode='stochastic' needs rbits ({0,1} array)")
        if not isinstance(rbits, (int, torch.Tensor)):
            rbits = _i32(rbits)
        return stochastic_carry_in(fmt.name, op, X, Y, rbits=rbits)
    return carry_in(fmt.name, op, mode, X, Y)


def lns_op_raw(fmt: FP8Format | str, op: str, mode: str, X, Y=None, *,
               rbits=None):
    """Paper-faithful mod-256 integer expression.  Returns uint8 codes.

    Only meaningful on the paper's domain (normal operands, normal result);
    outside it the mod-256 wraparound produces garbage by design, like the
    minimal hardware circuit the paper synthesizes.  ``mode="stochastic"``
    selects per element between the RD and RU carry-in expressions with
    ``rbits`` (a {0,1} array).

    FP8 multiplication really is one integer add (plus the constant and the
    carry-in): with the e5m2 codes 0x40 = 2.0 and 0x44 = 4.0,

    >>> hex(int(lns_op_raw("e5m2", "mul", "rne", 0x40, 0x44)))  # 2.0 * 4.0
    '0x48'
    >>> from repro_torch.core.formats import E5M2
    >>> float(E5M2.decode([0x48])[0])
    8.0
    """
    fmt = _fmt(fmt)
    Xi = _i32(X)
    Yi = None if Y is None else _i32(Y)
    cin = _carry(fmt, op, mode, Xi, Yi, rbits)
    core = _lns_core(fmt, op, Xi, Yi)
    K = LNS_CONSTS[(fmt.name, op)]
    return _out((core + K + cin) & 0xFF, X)


# --------------------------------------------------------------------------- #
# Production (saturating) variant
# --------------------------------------------------------------------------- #
def folded_constant(fmt: FP8Format | str, op: str) -> int:
    """The constant :func:`lns_op` adds to the sign-free magnitudes: K,
    or K - 256 for mul and square when K >= 128 (K encodes -B there)."""
    K = LNS_CONSTS[(_fmt(fmt).name, op)]
    return K - 256 if op in ("mul", "square") and K >= 128 else K


def _signed_lns_parts(fmt: FP8Format, op: str, Xi, Yi=None):
    """(sign bit, unwrapped magnitude code) in int32 without mod-256: the
    LNS result restricted to bits [0, 6] but kept full-range, so overflow
    (> max_normal_code) and underflow (< min_normal_code) are detectable
    before wrapping."""
    mx = Xi & 0x7F
    sx = (Xi >> 7) & 1
    if Yi is not None:
        my = Yi & 0x7F
        sy = (Yi >> 7) & 1
    K = folded_constant(fmt, op)
    if op == "mul":
        return sx ^ sy, mx + my + K
    if op == "square":
        return torch.zeros_like(sx), (mx << 1) + K
    if op == "div":
        return sx ^ sy, mx - my + K
    if op == "recip":
        return sx, -mx + K
    if op == "sqrt":
        return torch.zeros_like(sx), (mx >> 1) + K
    if op == "rsqrt":
        core = (-mx) >> 1 if RSQRT_NEG_FIRST else -(mx >> 1)
        return torch.zeros_like(sx), core + K
    raise ValueError(op)


def lns_op(fmt: FP8Format | str, op: str, mode: str, X, Y=None, *,
           rbits=None):
    """Saturating/guarded LNS op on full uint8 code tensors.

    Semantics outside the paper's domain, in the reference's order (later
    cases override earlier ones, NaN last):
      * zero or subnormal operand (FTZ)      -> exact special-case result
        (mul/square -> +-0; div 0/y -> +-0; x/0 -> +-max, 0/0 -> +-NaN
        code; recip(0) -> +-max; sqrt(0) -> 0; rsqrt(0) -> max)
      * overflow   -> +-max_normal
      * underflow  -> +-0 (flush; the sign is kept)
      * sqrt/rsqrt of any code with the sign bit set, -0 included -> NaN
      * NaN operand (or inf for E5M2)        -> canonical NaN code

    ``mode="stochastic"`` (with ``rbits``, a {0,1} array) picks per element
    between the RD and RU carry-in expressions.
    """
    fmt = _fmt(fmt)
    Xi = _i32(X)
    Yi = None if Y is None else _i32(Y)

    cin = _carry(fmt, op, mode, Xi, Yi, rbits)
    sign, mag = _signed_lns_parts(fmt, op, Xi, Yi)
    mag = mag + cin

    lo, hi = fmt.min_normal_code, fmt.max_normal_code
    underflow = mag < lo
    mag = torch.where(underflow, 0, mag.clamp(lo, hi))
    out = (sign << 7) | mag

    # --- special operands ------------------------------------------------ #
    def zeroish(V):  # zero or subnormal (FTZ)
        return (V & 0x7F) < fmt.min_normal_code

    def is_bad(V):  # NaN (and inf for e5m2)
        if fmt.has_inf:
            return (V & 0x7F) >= (fmt.exp_mask << fmt.man_bits)
        return (V & 0x7F) == 0x7F

    nan_code, max_code = fmt.nan_code, fmt.max_normal_code
    xz = zeroish(Xi)
    bad = is_bad(Xi)
    if Yi is not None:
        yz = zeroish(Yi)
        bad = bad | is_bad(Yi)

    if op == "mul":
        out = torch.where(xz | yz, sign << 7, out)
    elif op == "square":
        out = torch.where(xz, 0, out)
    elif op == "div":
        out = torch.where(xz & ~yz, sign << 7, out)
        xy0 = torch.where(xz, nan_code, max_code).to(torch.int32)
        out = torch.where(yz, (sign << 7) | xy0, out)
    elif op == "recip":
        out = torch.where(xz, (sign << 7) | max_code, out)  # saturate 1/0
    elif op == "sqrt":
        out = torch.where(xz, 0, out)
        out = torch.where(((Xi >> 7) & 1) == 1, nan_code, out)
    elif op == "rsqrt":
        out = torch.where(xz, max_code, out)
        out = torch.where(((Xi >> 7) & 1) == 1, nan_code, out)

    out = torch.where(bad, nan_code, out)
    return _out(out, X)
