"""Carry-in bits of the paper's Tables 2/3, eqs. (7)-(52).

The port's copy of ``repro.core.carry_ins``.  Each expression maps the
operand bit patterns to the single carry-in bit added into the LSB of the
integer LNS expression to reach a rounding mode.  ``x_i``/``y_i`` is bit
*i* of the raw 8-bit code (x7 = sign bit, x3 = LSB of the E4M3 exponent
field).  The callables use only ``>>``, ``&``, ``|`` and ``^``, so they
accept Python ints, numpy arrays and integer torch tensors alike.

* ``CARRY_INS[(format, op)][mode]`` -- the direct expressions, with the
  reference's corrections of the printed paper (e5m2 recip RU/RD swapped,
  e4m3 sqrt eqs. (47)/(48) re-derived, the unconditional faithful
  carries): a callable ``f(X, Y) -> {0,1}``, the constant 0 or 1, or
  ``None`` for a dash in the tables.  :func:`carry_in` evaluates one
  cell; :func:`stochastic_carry_in` picks the RD or RU expression per
  element with a random bit.
* ``FACTORED_MUL`` -- the throughput form of every *mul* expression that
  K1 and K3 use.  Each is a sum of product terms whose literals each
  touch only one operand, so it factors exactly as

      c_in(X, Y) = OR_i  fx_i(X) & fy_i(Y);

  a kernel evaluates all fx_i once per x operand and all fy_i once per y
  operand, packed into one integer bitmask per element, and the
  per-product carry collapses to ``(mask_x & mask_y) != 0``.

``tests/test_torch_core.py`` and ``tests/test_torch_lns.py`` pin every
entry against the reference over all codes and code pairs.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

__all__ = [
    "CARRY_INS",
    "FACTORED_MUL",
    "Unsupported",
    "carry_in",
    "directed_pair",
    "mul_carry_constant",
    "mul_carry_term_mask",
    "stochastic_carry_in",
    "supports_stochastic",
]


CarrySpec = Union[int, None, Callable]


class Unsupported(ValueError):
    """Requested (op, format, rounding-mode) has no integer-expression form."""


def _b(v, i: int):
    return (v >> i) & 0x1


def _n(bit):
    return bit ^ 0x1


# --------------------------------------------------------------------------- #
# E5M2 expressions (Sec. 3.1).  Mantissa bits: x1 (0.5), x0 (0.25).
# --------------------------------------------------------------------------- #
def e5m2_mul_rne(X, Y):  # eq. (7)
    x0, x1 = _b(X, 0), _b(X, 1)
    y0, y1 = _b(Y, 0), _b(Y, 1)
    return (x0 & y1 & _n(x1) & _n(y0)) | (x1 & y0 & _n(x0) & _n(y1))


def e5m2_mul_rna(X, Y):  # eq. (8)
    x0, x1 = _b(X, 0), _b(X, 1)
    y0, y1 = _b(Y, 0), _b(Y, 1)
    return e5m2_mul_rne(X, Y) | (x1 & y1 & _n(x0) & _n(y0))


def _e5m2_sr(X, Y):
    return _b(X, 7) ^ _b(Y, 7)


def e5m2_mul_ru(X, Y):  # eq. (9)
    x0, x1 = _b(X, 0), _b(X, 1)
    y0, y1 = _b(Y, 0), _b(Y, 1)
    return _n(_e5m2_sr(X, Y)) & (x0 | x1) & (y0 | y1)


def e5m2_mul_rd(X, Y):  # eq. (10)
    x0, x1 = _b(X, 0), _b(X, 1)
    y0, y1 = _b(Y, 0), _b(Y, 1)
    return _e5m2_sr(X, Y) & (x0 | x1) & (y0 | y1)


def e5m2_square_rna(X, Y=None):  # eq. (12)
    return _b(X, 1) & _n(_b(X, 0))


def e5m2_square_ru(X, Y=None):  # eq. (13)
    return _b(X, 0) | _b(X, 1)


def e5m2_div_rn(X, Y):  # eq. (16) -- shared by RN_e, RN_a, RN_z
    x0, x1 = _b(X, 0), _b(X, 1)
    y0, y1 = _b(Y, 0), _b(Y, 1)
    return x0 | x1 | (y0 & y1) | (_n(y0) & _n(y1))


def _e5m2_div_directed_core(X, Y):  # eq. (17) terms
    x0, x1 = _b(X, 0), _b(X, 1)
    y0, y1 = _b(Y, 0), _b(Y, 1)
    return (
        (_n(y0) & _n(y1))
        | (x0 & _n(x1) & _n(y1))
        | (x1 & _n(x0) & _n(y0))
        | (x0 & x1 & y0 & y1)
    )


def e5m2_div_rz(X, Y):  # eq. (17)
    return _e5m2_div_directed_core(X, Y)


def e5m2_div_ru(X, Y):  # eq. (18)
    return _n(_e5m2_sr(X, Y)) | _e5m2_div_directed_core(X, Y)


def e5m2_div_rd(X, Y):  # eq. (19)
    return _e5m2_sr(X, Y) | _e5m2_div_directed_core(X, Y)


def e5m2_recip_rn(X, Y=None):  # eq. (22)
    x0, x1 = _b(X, 0), _b(X, 1)
    return (x0 & x1) | (_n(x0) & _n(x1))


def e5m2_recip_rz(X, Y=None):  # eq. (23)
    return _n(_b(X, 0)) & _n(_b(X, 1))


def e5m2_recip_ru(X, Y=None):
    """Eqs. (24)/(25) with RU/RD swapped relative to the paper.

    The paper prints RU = x7 + x0'x1' and RD = x7' + x0'x1', but rounding
    toward +inf must *increase* the LNS magnitude code for positive results
    (x7 = 0), exactly as in the paper's own mul (eq. 9, fires on S_r') and
    div (eq. 18, fires on S_r') expressions.  The exhaustive oracle confirms
    the swap: RU needs the carry when x7 = 0.
    """
    return _n(_b(X, 7)) | e5m2_recip_rz(X)


def e5m2_recip_rd(X, Y=None):  # see e5m2_recip_ru docstring
    return _b(X, 7) | e5m2_recip_rz(X)


def e5m2_sqrt_ru(X, Y=None):  # eq. (27); shared by rsqrt
    return _b(X, 0)


# --------------------------------------------------------------------------- #
# E4M3 expressions (Sec. 3.2).  Mantissa bits: x2 (0.5), x1 (0.25), x0 (0.125);
# x3 is the exponent LSB.
# --------------------------------------------------------------------------- #
def _bits3(V):
    return _b(V, 0), _b(V, 1), _b(V, 2)


def e4m3_mul_rne(X, Y):  # eq. (30)
    x0, x1, x2 = _bits3(X)
    y0, y1, y2 = _bits3(Y)
    return (
        (x0 & y2 & _n(x2) & _n(y0))
        | (x0 & y2 & _n(x2) & _n(y1))
        | (x1 & y2 & _n(x2) & _n(y0))
        | (x1 & y2 & _n(x2) & _n(y1))
        | (x2 & y0 & _n(x0) & _n(y2))
        | (x2 & y0 & _n(x1) & _n(y2))
        | (x2 & y1 & _n(x0) & _n(y2))
        | (x2 & y1 & _n(x1) & _n(y2))
        | (x2 & y2 & _n(x1) & _n(y1))
        | (x0 & x1 & y1 & _n(x2) & _n(y2))
        | (x1 & y0 & y1 & _n(x2) & _n(y2))
    )


def e4m3_mul_rna(X, Y):  # eq. (31)
    x0, x1, x2 = _bits3(X)
    y0, y1, y2 = _bits3(Y)
    return (
        (x0 & y2 & _n(x1) & _n(y1))
        | (x0 & y2 & _n(x2) & _n(y0))
        | (x1 & y1 & _n(x0) & _n(y2))
        | (x1 & y1 & _n(x2) & _n(y0))
        | (x1 & y1 & _n(x2) & _n(y2))
        | (x1 & y2 & _n(x2) & _n(y1))
        | (x2 & y0 & _n(x0) & _n(y2))
        | (x2 & y0 & _n(x1) & _n(y1))
        | (x2 & y1 & _n(x1) & _n(y2))
        | (x2 & y2 & _n(x0) & _n(x1) & _n(y0))
        | (x2 & y2 & _n(x0) & _n(y0) & _n(y1))
    )


def e4m3_mul_rnz(X, Y):  # eq. (32)
    x0, x1, x2 = _bits3(X)
    y0, y1, y2 = _bits3(Y)
    return (
        (x1 & y2 & _n(x2) & _n(y0))
        | (x1 & y2 & _n(x2) & _n(y1))
        | (x2 & y1 & _n(x0) & _n(y2))
        | (x2 & y1 & _n(x1) & _n(y2))
        | (x2 & y2 & _n(x1) & _n(y1))
        | (x0 & x1 & y1 & _n(x2) & _n(y2))
        | (x0 & x2 & y0 & _n(x1) & _n(y2))
        | (x0 & y0 & y2 & _n(x2) & _n(y1))
        | (x0 & y1 & y2 & _n(x2) & _n(y0))
        | (x1 & x2 & y0 & _n(x0) & _n(y2))
        | (x1 & y0 & y1 & _n(x2) & _n(y2))
    )


def e4m3_mul_rz(X, Y):  # eq. (33)
    x0, x1, x2 = _bits3(X)
    y0, y1, y2 = _bits3(Y)
    return (
        (x1 & y2 & _n(x0) & _n(x2) & _n(y1))
        | (x1 & y2 & _n(x2) & _n(y0) & _n(y1))
        | (x2 & y1 & _n(x0) & _n(x1) & _n(y2))
        | (x2 & y1 & _n(x1) & _n(y0) & _n(y2))
        | (x0 & x1 & y0 & y1 & _n(x2) & _n(y2))
        | (x2 & y2 & _n(x0) & _n(x1) & _n(y0) & _n(y1))
    )


def e4m3_mul_faithful(X, Y):  # eq. (34)
    x0, x1, x2 = _bits3(X)
    y0, y1, y2 = _bits3(Y)
    return (x2 | x1 | x0) & (y2 | y1 | y0)


def e4m3_square_rne(X, Y=None):  # eq. (36) -- RN_e and RN_z
    x0, x1, x2 = _bits3(X)
    return (x2 & _n(x1)) | (x0 & x1 & _n(x2))


def e4m3_square_rna(X, Y=None):  # eq. (37)
    x0, x1, x2 = _bits3(X)
    return (x1 & _n(x2)) | (x2 & _n(x1))


def e4m3_square_rd(X, Y=None):  # eq. (38) -- RD and RZ
    x0, x1, x2 = _bits3(X)
    return (x0 & x1 & _n(x2)) | (x2 & _n(x0) & _n(x1))


def e4m3_square_faithful(X, Y=None):  # eq. (39)
    x0, x1, x2 = _bits3(X)
    return (x2 & _n(x1) & _n(x0)) | (_n(x2) & x1 & x0)


def e4m3_div_rn(X, Y):  # eq. (41) -- RN_e, RN_a, RN_z
    x0, x1, x2 = _bits3(X)
    y0, y1, y2 = _bits3(Y)
    return (
        (x0 & x1 & _n(x2))
        | (x1 & _n(x2) & _n(y2))
        | (x2 & y1 & y2)
        | (x2 & _n(x0) & _n(x1))
        | (x2 & _n(x1) & _n(y1))
        | (y0 & y1 & y2)
        | (_n(y0) & _n(y1) & _n(y2))
        | (x0 & _n(x1) & _n(y1) & _n(y2))
        | (x2 & y0 & y2 & _n(x0))
    )


def e4m3_div_faithful(X, Y):  # eq. (42)
    x0, x1, x2 = _bits3(X)
    y0, y1, y2 = _bits3(Y)
    eq_m = _n(x2 ^ y2) & _n(x1 ^ y1) & _n(x0 ^ y0)
    return (_n(y2) & _n(y1) & _n(y0)) | eq_m


def e4m3_recip_rn(X, Y=None):  # eq. (44)
    x0, x1, x2 = _bits3(X)
    return (x0 & x1 & x2) | (_n(x0) & _n(x1) & _n(x2))


def e4m3_recip_faithful(X, Y=None):  # eq. (45)
    x0, x1, x2 = _bits3(X)
    return _n(x2) & _n(x1) & _n(x0)


def e4m3_sqrt_rn(X, Y=None):
    """Corrected eq. (47).

    The paper prints ``c_in = x3' + x0 + x1 + x2``; the exhaustive oracle
    (scripts/derive_cin.py) shows the carry is needed for every input except
    (m == 0 and x3 == 0), i.e. ``c_in = x0 + x1 + x2 + x3`` -- the printed
    ``x3'`` is a typesetting artifact of ``x3``.  This matches the paper's
    own narrative ("under-approximates when the exponent LSB is 1").
    Shared by RN_e/RN_a/RN_z (identical derived tables).
    """
    x0, x1, x2 = _bits3(X)
    x3 = _b(X, 3)
    return x0 | x1 | x2 | x3


def e4m3_sqrt_rd(X, Y=None):
    """Corrected eq. (48) -- RD and RZ.

    The printed ``x3 x0 + x3'(x0 x1' + x0 x2' + x1' x2')`` mismatches the
    oracle in 29/119 cases.  Exhaustively derived replacement:
    ``x0 x1' + x0 x2' + x0' x1' x2' x3 + x0 x1 x2 x3'``.
    """
    x0, x1, x2 = _bits3(X)
    x3 = _b(X, 3)
    return (
        (x0 & _n(x1))
        | (x0 & _n(x2))
        | (_n(x0) & _n(x1) & _n(x2) & x3)
        | (x0 & x1 & x2 & _n(x3))
    )


def e4m3_rsqrt_rn(X, Y=None):  # eq. (51)
    x0, x1, x2 = _bits3(X)
    x3 = _b(X, 3)
    return (x3 & _n(x1) & _n(x2)) | (_n(x3) & x1 & x2) | x0


def e4m3_rsqrt_rd(X, Y=None):  # eq. (52) -- RD and RZ
    x0, x1, x2 = _bits3(X)
    x3 = _b(X, 3)
    return (x3 & _n(x1) & _n(x2)) | (_n(x3) & x0 & x1 & x2)


# --------------------------------------------------------------------------- #
# Registry: (format, op) -> {mode: spec}.  Mirrors Tables 2 and 3.
# --------------------------------------------------------------------------- #
CARRY_INS: Dict[Tuple[str, str], Dict[str, CarrySpec]] = {
    # ----- E5M2 (Table 2) ------------------------------------------------- #
    ("e5m2", "mul"): {
        "rne": e5m2_mul_rne, "rna": e5m2_mul_rna, "rnz": 0,
        "ru": e5m2_mul_ru, "rd": e5m2_mul_rd, "rz": 0, "faithful": 0,
    },
    ("e5m2", "square"): {
        "rne": 0, "rna": e5m2_square_rna, "rnz": 0,
        "ru": e5m2_square_ru, "rd": 0, "rz": 0, "faithful": 0,
    },
    ("e5m2", "div"): {
        "rne": e5m2_div_rn, "rna": e5m2_div_rn, "rnz": e5m2_div_rn,
        "ru": e5m2_div_ru, "rd": e5m2_div_rd, "rz": e5m2_div_rz,
        # Table 2 prints 0, but with the decremented 0x3b constant the raw
        # result under-approximates past RD; exhaustive check shows an
        # unconditional carry (== using the original 0x3c constant, the
        # table's footnote-b convention) is faithful everywhere.
        "faithful": 1,
    },
    ("e5m2", "recip"): {
        "rne": e5m2_recip_rn, "rna": e5m2_recip_rn, "rnz": e5m2_recip_rn,
        "ru": e5m2_recip_ru, "rd": e5m2_recip_rd, "rz": e5m2_recip_rz,
        "faithful": 1,
    },
    ("e5m2", "sqrt"): {
        "rne": 0, "rna": 0, "rnz": 0,
        "ru": e5m2_sqrt_ru, "rd": None, "rz": None, "faithful": 0,
    },
    ("e5m2", "rsqrt"): {
        "rne": 0, "rna": 0, "rnz": 0,
        "ru": e5m2_sqrt_ru, "rd": None, "rz": None, "faithful": 0,
    },
    # ----- E4M3 (Table 3) ------------------------------------------------- #
    ("e4m3", "mul"): {
        "rne": e4m3_mul_rne, "rna": e4m3_mul_rna, "rnz": e4m3_mul_rnz,
        "ru": None, "rd": None, "rz": e4m3_mul_rz,
        "faithful": e4m3_mul_faithful,
    },
    ("e4m3", "square"): {
        "rne": e4m3_square_rne, "rna": e4m3_square_rna, "rnz": e4m3_square_rne,
        "ru": None, "rd": e4m3_square_rd, "rz": e4m3_square_rd,
        "faithful": e4m3_square_faithful,
    },
    ("e4m3", "div"): {
        "rne": e4m3_div_rn, "rna": e4m3_div_rn, "rnz": e4m3_div_rn,
        "ru": None, "rd": None, "rz": None,
        "faithful": e4m3_div_faithful,
    },
    ("e4m3", "recip"): {
        "rne": e4m3_recip_rn, "rna": e4m3_recip_rn, "rnz": e4m3_recip_rn,
        "ru": None, "rd": None, "rz": None,
        "faithful": e4m3_recip_faithful,
    },
    ("e4m3", "sqrt"): {
        "rne": e4m3_sqrt_rn, "rna": e4m3_sqrt_rn, "rnz": e4m3_sqrt_rn,
        # Table 3 prints faithful = 0, but with the decremented 0x1b constant
        # an unconditional carry is required (footnote-b convention).
        "ru": None, "rd": e4m3_sqrt_rd, "rz": e4m3_sqrt_rd, "faithful": 1,
    },
    ("e4m3", "rsqrt"): {
        "rne": e4m3_rsqrt_rn, "rna": e4m3_rsqrt_rn, "rnz": e4m3_rsqrt_rn,
        "ru": None, "rd": e4m3_rsqrt_rd, "rz": e4m3_rsqrt_rd, "faithful": 1,
    },
}


def carry_in(fmt_name: str, op: str, mode: str, X, Y=None):
    """Evaluate the carry-in bit for (format, op, mode) on code arrays.

    Works on plain ints, numpy arrays and integer torch tensors alike (the
    expressions use only bitwise ops):

    >>> carry_in("e5m2", "mul", "rne", 0b01, 0b10)  # eq. (7) fires
    1
    >>> carry_in("e5m2", "mul", "rz", 0b01, 0b10)   # RZ is a constant cell
    0
    """
    spec = CARRY_INS[(fmt_name, op)][mode]
    if spec is None:
        raise Unsupported(f"{fmt_name} {op} has no integer expression for {mode}")
    if isinstance(spec, int):
        return spec
    return spec(X, Y)


# --------------------------------------------------------------------------- #
# Stochastic rounding as a carry-in.
#
# The directed modes RD and RU of Tables 2/3 bracket the exact result, and
# both are realized by a single carry-in bit into the same integer LNS
# expression.  Selecting between the two expressions with a uniform random
# bit therefore yields stochastic rounding *in the carry-in domain*: the
# result is always one of the two faithful answers, and the hardware cost is
# the same one-bit carry (a 2:1 mux on the two boolean expressions).
# --------------------------------------------------------------------------- #
def directed_pair(fmt_name: str, op: str) -> Tuple[CarrySpec, CarrySpec]:
    """The (RD, RU) carry-in specs for (format, op); Unsupported if either
    direction has no integer expression (a dash in Tables 2/3)."""
    table = CARRY_INS[(fmt_name, op)]
    rd, ru = table["rd"], table["ru"]
    if rd is None or ru is None:
        raise Unsupported(
            f"{fmt_name} {op}: stochastic rounding needs both RD and RU "
            "carry-in expressions"
        )
    return rd, ru


def supports_stochastic(fmt_name: str, op: str) -> bool:
    try:
        directed_pair(fmt_name, op)
        return True
    except Unsupported:
        return False


def stochastic_carry_in(fmt_name: str, op: str, X, Y=None, *, rbits):
    """Carry-in bit for stochastic rounding: the RD expression when the
    random bit is 0, the RU expression when it is 1.

    ``rbits`` is a {0,1} integer array broadcastable against the operands
    (one independent uniform bit per element).  Works on ints, numpy
    arrays and integer torch tensors alike.

    >>> int(stochastic_carry_in("e5m2", "mul", 0b01, 0b01, rbits=0))  # RD
    0
    >>> int(stochastic_carry_in("e5m2", "mul", 0b01, 0b01, rbits=1))  # RU
    1
    """
    rd, ru = directed_pair(fmt_name, op)
    c_rd = rd if isinstance(rd, int) else rd(X, Y)
    c_ru = ru if isinstance(ru, int) else ru(X, Y)
    r = rbits & 0x1
    return (c_rd & (r ^ 0x1)) | (c_ru & r)


# --------------------------------------------------------------------------- #
# Factored mul carry-ins (throughput form; see the module docstring).
# --------------------------------------------------------------------------- #
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
