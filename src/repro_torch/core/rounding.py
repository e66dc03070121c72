"""Exact rounding oracle for FP8 operations.

The port's own copy of ``repro.core.rounding`` (numpy only); the chip
smoke's Tables 2/3 phase and ``tests/test_torch_lns.py`` use it.

Implements the seven rounding modes of the paper (RN_e, RN_a, RN_z, RU, RD,
RZ, faithful) as an *exact* reference: all comparisons between the
mathematically exact result and representable FP8 values / tie midpoints are
decided by exact integer-valued float64 predicates (products of dyadic
rationals with few significand bits are exact in float64), never by a rounded
intermediate.  This makes the oracle bit-trustworthy, which matters because
the paper's claims are validated exhaustively over all 256x256 operand pairs.

Conventions:
  * ``op`` is one of ``mul, square, div, recip, sqrt, rsqrt``.
  * Operand/result arrays are uint8 FP8 codes.
  * The validity domain follows the paper: operands are normal (and positive
    for sqrt/rsqrt), and the exact result magnitude lies in
    [min_normal, max_normal] of the format.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from .formats import FP8Format

__all__ = [
    "MODES",
    "UNARY_OPS",
    "BINARY_OPS",
    "Oracle",
]

MODES = ("rne", "rna", "rnz", "ru", "rd", "rz")
UNARY_OPS = ("square", "recip", "sqrt", "rsqrt")
BINARY_OPS = ("mul", "div")


def _cmp_factory(op: str, ax: np.ndarray, ay: Optional[np.ndarray]) -> Callable:
    """Return cmp(t) in {-1,0,1} comparing the exact |result| against t.

    ``ax``/``ay`` are the positive operand magnitudes as float64 (exact).
    ``t`` must be exactly representable in float64 with few significand bits
    (an FP8 normal value or a midpoint of two adjacent ones).
    All products below involve <= ~14 significand bits => exact in float64.
    """
    if op == "mul":
        r = ax * ay  # exact
        return lambda t: np.sign(r - t)
    if op == "square":
        r = ax * ax  # exact
        return lambda t: np.sign(r - t)
    if op == "div":
        # ax/ay vs t  <=>  ax vs t*ay (ay > 0)
        return lambda t: np.sign(ax - t * ay)
    if op == "recip":
        # 1/ax vs t  <=>  1 vs t*ax
        return lambda t: np.sign(1.0 - t * ax)
    if op == "sqrt":
        # sqrt(ax) vs t  <=>  ax vs t^2
        return lambda t: np.sign(ax - t * t)
    if op == "rsqrt":
        # 1/sqrt(ax) vs t  <=>  1 vs t^2 * ax
        return lambda t: np.sign(1.0 - (t * t) * ax)
    raise ValueError(f"unknown op {op!r}")


def _result_hint(op: str, ax: np.ndarray, ay: Optional[np.ndarray]) -> np.ndarray:
    """float64 approximation of |result| used only to locate the bracket."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if op == "mul":
            return ax * ay
        if op == "square":
            return ax * ax
        if op == "div":
            return ax / ay
        if op == "recip":
            return 1.0 / ax
        if op == "sqrt":
            return np.sqrt(ax)
        if op == "rsqrt":
            return 1.0 / np.sqrt(ax)
    raise ValueError(f"unknown op {op!r}")


class Oracle:
    """Exact FP8 rounding oracle for one format."""

    def __init__(self, fmt: FP8Format):
        self.fmt = fmt
        self.vals = fmt.normal_values()  # positive normals, ascending
        self.codes = fmt.all_normal_codes()  # magnitude codes, ascending

    # ------------------------------------------------------------------ #
    def operand_mask(self, op: str, X: np.ndarray, Y: Optional[np.ndarray]) -> np.ndarray:
        """Operands inside the paper's claimed domain."""
        fmt = self.fmt
        ok = fmt.is_normal(X.astype(np.int64))
        if op in ("sqrt", "rsqrt"):
            ok = ok & (fmt.sign(X.astype(np.int64)) == 0)
        if Y is not None:
            ok = ok & fmt.is_normal(Y.astype(np.int64))
        return ok

    def result_sign(self, op: str, X: np.ndarray, Y: Optional[np.ndarray]) -> np.ndarray:
        fmt = self.fmt
        sx = fmt.sign(X.astype(np.int64))
        if op in ("mul",):
            return sx ^ fmt.sign(Y.astype(np.int64))
        if op == "div":
            return sx ^ fmt.sign(Y.astype(np.int64))
        if op == "recip":
            return sx
        return np.zeros_like(sx)  # square, sqrt, rsqrt

    # ------------------------------------------------------------------ #
    def quantize_all(
        self, op: str, X: np.ndarray, Y: Optional[np.ndarray] = None
    ) -> Tuple[dict, np.ndarray]:
        """Quantize the exact result of ``op`` under every rounding mode.

        Returns ``(results, valid)`` where ``results[mode]`` is a uint8 code
        array and ``valid`` marks cells inside the paper's domain (normal
        operands, exact result magnitude within normal range).
        """
        fmt = self.fmt
        X = np.asarray(X, dtype=np.uint8)
        Xi = X.astype(np.int64)
        ax = np.abs(fmt.decode((Xi & 0x7F).astype(np.uint8)))
        ay = None
        if Y is not None:
            Y = np.asarray(Y, dtype=np.uint8)
            Yi = Y.astype(np.int64)
            ay = np.abs(fmt.decode((Yi & 0x7F).astype(np.uint8)))

        valid = self.operand_mask(op, X, Y)
        # Avoid nan/inf noise outside the domain.
        ax = np.where(valid, ax, 1.0)
        if ay is not None:
            ay = np.where(valid, ay, 1.0)

        cmp = _cmp_factory(op, ax, ay)
        hint = _result_hint(op, ax, ay)

        vals, codes = self.vals, self.codes
        n = len(vals)

        # Exact range check: vals[0] <= r <= vals[-1].
        valid = valid & (cmp(vals[0]) >= 0) & (cmp(vals[-1]) <= 0)
        hint = np.where(valid, hint, 1.0)

        # Bracket via hint, then fix up with exact predicates.
        idx = np.searchsorted(vals, hint, side="right") - 1
        idx = np.clip(idx, 0, n - 1)
        # lo = largest i with vals[i] <= r: nudge with exact compares.
        up = np.clip(idx + 1, 0, n - 1)
        idx = np.where((up > idx) & (cmp(vals[up]) >= 0), up, idx)
        dn = np.clip(idx - 1, 0, n - 1)
        idx = np.where(cmp(vals[idx]) < 0, dn, idx)
        lo = idx
        cmp_lo = cmp(vals[lo])
        exact = cmp_lo == 0
        hi = np.clip(lo + 1, 0, n - 1)

        # Magnitude-domain roundings (positive r).
        rd_i = lo
        ru_i = np.where(exact, lo, hi)

        mid = 0.5 * (vals[lo] + vals[np.clip(lo + 1, 0, n - 1)])  # exact in f64
        cmp_mid = cmp(mid)
        rn_hi = cmp_mid > 0
        tie = (cmp_mid == 0) & ~exact

        lo_code_even = (self.codes[lo] & 1) == 0
        rne_i = np.where(exact, lo, np.where(rn_hi, hi, np.where(tie, np.where(lo_code_even, lo, hi), lo)))
        rna_i = np.where(exact, lo, np.where(rn_hi | tie, hi, lo))
        rnz_i = np.where(exact, lo, np.where(rn_hi, hi, lo))

        sign = self.result_sign(op, X, Y)
        sbit = (sign.astype(np.int64) << 7).astype(np.int64)

        def mk(i):
            return (codes[i] | sbit).astype(np.uint8)

        results = {
            "rne": mk(rne_i),
            "rna": mk(rna_i),
            "rnz": mk(rnz_i),
            "rz": mk(rd_i),  # toward zero == magnitude RD
            # Directed modes depend on the sign of the result.
            "ru": np.where(sign == 0, mk(ru_i), mk(rd_i)).astype(np.uint8),
            "rd": np.where(sign == 0, mk(rd_i), mk(ru_i)).astype(np.uint8),
        }
        return results, valid

    # ------------------------------------------------------------------ #
    def faithful_set(
        self, op: str, X: np.ndarray, Y: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (rd_codes, ru_codes, valid): the two faithful answers."""
        results, valid = self.quantize_all(op, X, Y)
        return results["rd"], results["ru"], valid
