"""Factored mul carry-ins of the paper's Tables 2/3 (throughput form).

The port's copy of the part of ``repro.core.carry_ins`` that the paged
decode path needs: the ``FACTORED_MUL`` table, :func:`mul_carry_constant`
and :func:`mul_carry_term_mask`.  The direct per-equation expressions,
the rounding oracle and the stochastic carry-in wait for the slices that
port the LNS elementwise and matmul kernels.

Every Table 2/3 *mul* expression is a sum of product terms whose literals
each touch only one operand, so it factors exactly as

    c_in(X, Y) = OR_i  fx_i(X) & fy_i(Y).

A kernel evaluates all fx_i once per x operand and all fy_i once per y
operand, packed into one integer bitmask per element, and the per-product
carry collapses to ``(mask_x & mask_y) != 0``.  The callables use only
``>>``, ``&``, ``|`` and ``^``, so they accept Python ints, numpy arrays
and integer torch tensors alike.  ``tests/test_torch_core.py`` pins every
entry against the reference table over all 256 codes and both sides.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

__all__ = [
    "FACTORED_MUL",
    "Unsupported",
    "mul_carry_constant",
    "mul_carry_term_mask",
]


class Unsupported(ValueError):
    """Requested (op, format, rounding-mode) has no integer-expression form."""


def _b(v, i: int):
    return (v >> i) & 0x1


def _n(bit):
    return bit ^ 0x1


def _fx_lo(X):  # (x0|x1) x2'   — low mantissa set, top bit clear
    return (_b(X, 0) | _b(X, 1)) & _n(_b(X, 2))


def _fx_hi(X):  # x2 (x0'|x1')  — top bit set, low mantissa not both set
    return _b(X, 2) & (_n(_b(X, 0)) | _n(_b(X, 1)))


FACTORED_MUL: Dict[Tuple[str, str], Union[int, Tuple]] = {
    # ----- E5M2 ----------------------------------------------------------- #
    # eq. (7): two symmetric terms
    ("e5m2", "rne"): (
        (lambda X: _b(X, 0) & _n(_b(X, 1)), lambda Y: _b(Y, 1) & _n(_b(Y, 0))),
        (lambda X: _b(X, 1) & _n(_b(X, 0)), lambda Y: _b(Y, 0) & _n(_b(Y, 1))),
    ),
    # eq. (8): rne + the x1 y1 x0' y0' tie term
    ("e5m2", "rna"): (
        (lambda X: _b(X, 0) & _n(_b(X, 1)), lambda Y: _b(Y, 1) & _n(_b(Y, 0))),
        (lambda X: _b(X, 1) & _n(_b(X, 0)), lambda Y: _b(Y, 0) & _n(_b(Y, 1))),
        (lambda X: _b(X, 1) & _n(_b(X, 0)), lambda Y: _b(Y, 1) & _n(_b(Y, 0))),
    ),
    ("e5m2", "rnz"): 0,
    ("e5m2", "rz"): 0,
    ("e5m2", "faithful"): 0,
    # eq. (9): S_r' (x0|x1)(y0|y1); S_r' = sx'sy' | sx sy splits in two terms
    ("e5m2", "ru"): (
        (lambda X: _n(_b(X, 7)) & (_b(X, 0) | _b(X, 1)),
         lambda Y: _n(_b(Y, 7)) & (_b(Y, 0) | _b(Y, 1))),
        (lambda X: _b(X, 7) & (_b(X, 0) | _b(X, 1)),
         lambda Y: _b(Y, 7) & (_b(Y, 0) | _b(Y, 1))),
    ),
    # eq. (10): S_r (x0|x1)(y0|y1)
    ("e5m2", "rd"): (
        (lambda X: _b(X, 7) & (_b(X, 0) | _b(X, 1)),
         lambda Y: _n(_b(Y, 7)) & (_b(Y, 0) | _b(Y, 1))),
        (lambda X: _n(_b(X, 7)) & (_b(X, 0) | _b(X, 1)),
         lambda Y: _b(Y, 7) & (_b(Y, 0) | _b(Y, 1))),
    ),
    # ----- E4M3 ----------------------------------------------------------- #
    # eq. (30): terms 1-4 and 5-8 collapse to one cross-product each
    ("e4m3", "rne"): (
        (_fx_lo, lambda Y: _b(Y, 2) & (_n(_b(Y, 0)) | _n(_b(Y, 1)))),
        (_fx_hi, lambda Y: (_b(Y, 0) | _b(Y, 1)) & _n(_b(Y, 2))),
        (lambda X: _b(X, 2) & _n(_b(X, 1)), lambda Y: _b(Y, 2) & _n(_b(Y, 1))),
        (lambda X: _b(X, 0) & _b(X, 1) & _n(_b(X, 2)),
         lambda Y: _b(Y, 1) & _n(_b(Y, 2))),
        (lambda X: _b(X, 1) & _n(_b(X, 2)),
         lambda Y: _b(Y, 0) & _b(Y, 1) & _n(_b(Y, 2))),
    ),
    # eq. (31): term-by-term split
    ("e4m3", "rna"): (
        (lambda X: _b(X, 0) & _n(_b(X, 1)), lambda Y: _b(Y, 2) & _n(_b(Y, 1))),
        (lambda X: _b(X, 0) & _n(_b(X, 2)), lambda Y: _b(Y, 2) & _n(_b(Y, 0))),
        (lambda X: _b(X, 1) & _n(_b(X, 0)), lambda Y: _b(Y, 1) & _n(_b(Y, 2))),
        (lambda X: _b(X, 1) & _n(_b(X, 2)), lambda Y: _b(Y, 1) & _n(_b(Y, 0))),
        (lambda X: _b(X, 1) & _n(_b(X, 2)), lambda Y: _b(Y, 1) & _n(_b(Y, 2))),
        (lambda X: _b(X, 1) & _n(_b(X, 2)), lambda Y: _b(Y, 2) & _n(_b(Y, 1))),
        (lambda X: _b(X, 2) & _n(_b(X, 0)), lambda Y: _b(Y, 0) & _n(_b(Y, 2))),
        (lambda X: _b(X, 2) & _n(_b(X, 1)), lambda Y: _b(Y, 0) & _n(_b(Y, 1))),
        (lambda X: _b(X, 2) & _n(_b(X, 1)), lambda Y: _b(Y, 1) & _n(_b(Y, 2))),
        (lambda X: _b(X, 2) & _n(_b(X, 0)) & _n(_b(X, 1)),
         lambda Y: _b(Y, 2) & _n(_b(Y, 0))),
        (lambda X: _b(X, 2) & _n(_b(X, 0)),
         lambda Y: _b(Y, 2) & _n(_b(Y, 0)) & _n(_b(Y, 1))),
    ),
    # eq. (32): terms 1-2 and 3-4 collapse
    ("e4m3", "rnz"): (
        (lambda X: _b(X, 1) & _n(_b(X, 2)),
         lambda Y: _b(Y, 2) & (_n(_b(Y, 0)) | _n(_b(Y, 1)))),
        (_fx_hi, lambda Y: _b(Y, 1) & _n(_b(Y, 2))),
        (lambda X: _b(X, 2) & _n(_b(X, 1)), lambda Y: _b(Y, 2) & _n(_b(Y, 1))),
        (lambda X: _b(X, 0) & _b(X, 1) & _n(_b(X, 2)),
         lambda Y: _b(Y, 1) & _n(_b(Y, 2))),
        (lambda X: _b(X, 0) & _b(X, 2) & _n(_b(X, 1)),
         lambda Y: _b(Y, 0) & _n(_b(Y, 2))),
        (lambda X: _b(X, 0) & _n(_b(X, 2)),
         lambda Y: _b(Y, 0) & _b(Y, 2) & _n(_b(Y, 1))),
        (lambda X: _b(X, 0) & _n(_b(X, 2)),
         lambda Y: _b(Y, 1) & _b(Y, 2) & _n(_b(Y, 0))),
        (lambda X: _b(X, 1) & _b(X, 2) & _n(_b(X, 0)),
         lambda Y: _b(Y, 0) & _n(_b(Y, 2))),
        (lambda X: _b(X, 1) & _n(_b(X, 2)),
         lambda Y: _b(Y, 0) & _b(Y, 1) & _n(_b(Y, 2))),
    ),
    # eq. (33): term-by-term split
    ("e4m3", "rz"): (
        (lambda X: _b(X, 1) & _n(_b(X, 0)) & _n(_b(X, 2)),
         lambda Y: _b(Y, 2) & _n(_b(Y, 1))),
        (lambda X: _b(X, 1) & _n(_b(X, 2)),
         lambda Y: _b(Y, 2) & _n(_b(Y, 0)) & _n(_b(Y, 1))),
        (lambda X: _b(X, 2) & _n(_b(X, 0)) & _n(_b(X, 1)),
         lambda Y: _b(Y, 1) & _n(_b(Y, 2))),
        (lambda X: _b(X, 2) & _n(_b(X, 1)),
         lambda Y: _b(Y, 1) & _n(_b(Y, 0)) & _n(_b(Y, 2))),
        (lambda X: _b(X, 0) & _b(X, 1) & _n(_b(X, 2)),
         lambda Y: _b(Y, 0) & _b(Y, 1) & _n(_b(Y, 2))),
        (lambda X: _b(X, 2) & _n(_b(X, 0)) & _n(_b(X, 1)),
         lambda Y: _b(Y, 2) & _n(_b(Y, 0)) & _n(_b(Y, 1))),
    ),
    # eq. (34): (x has mantissa bits) AND (y has mantissa bits)
    ("e4m3", "faithful"): (
        (lambda X: _b(X, 0) | _b(X, 1) | _b(X, 2),
         lambda Y: _b(Y, 0) | _b(Y, 1) | _b(Y, 2)),
    ),
}


def mul_carry_constant(fmt_name: str, mode: str):
    """The constant carry for (fmt, mul, mode), or None if input-dependent."""
    spec = FACTORED_MUL.get((fmt_name, mode))
    if spec is None:
        raise Unsupported(f"{fmt_name} mul has no integer expression for {mode}")
    return spec if isinstance(spec, int) else None


def mul_carry_term_mask(fmt_name: str, mode: str, V, side: str):
    """Pack one operand's halves of the factored mul carry into a bitmask.

    ``side`` is "x" (left operand) or "y" (right).  For operands px, py the
    carry-in bit is ``(mask_x & mask_y) != 0``.  Returns None when the carry
    is constant for this (format, mode) — fold it via mul_carry_constant.
    """
    spec = FACTORED_MUL.get((fmt_name, mode))
    if spec is None:
        raise Unsupported(f"{fmt_name} mul has no integer expression for {mode}")
    if isinstance(spec, int):
        return None
    idx = {"x": 0, "y": 1}[side]
    mask = None
    for i, pair in enumerate(spec):
        bit = pair[idx](V) << i
        mask = bit if mask is None else mask | bit
    return mask
