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

The kernel computes four codes of a 32-bit word at once, two in the
16-bit lanes of each of two registers (:func:`packed_constants` gives it
the lane constants of one (format, op) pair).  :func:`packed_rule_model`
repeats its steps on int64 tensors holding the 32-bit words; the tests
hold it against the reference bit for bit, and nothing else calls it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..core.formats import FORMATS
from ..core.lns import folded_constant, lns_op
from .common import elementwise_carry_table
from .cuda_build import check_launch

__all__ = ["OPS", "BINARY_OPS", "fp8_elementwise", "fp8_elementwise_plain",
           "PackedConstants", "packed_constants", "packed_rule_model"]

OPS = ("mul", "div", "square", "recip", "sqrt", "rsqrt")  # csrc enum order
BINARY_OPS = ("mul", "div")


def fp8_elementwise_plain(op: str, x_codes, y_codes=None, *,
                          fmt: str = "e4m3", mode: str = "rne"):
    """Plain version of K5: ``lns_op`` over the codes (int32 passes)."""
    return lns_op(fmt, op, mode, x_codes, y_codes)


# --------------------------------------------------------------------------- #
# The kernel's packed rule: four codes a word, two in each register
# --------------------------------------------------------------------------- #
# What each op adds to the code bytes before K: the byte value v of the
# op's integer expression, kept in [0, 255] by an offset (``mag = v + K -
# OFF + carry``): mul mx + my, div mx + (127 - my), square 2 mx, recip
# 127 - mx, sqrt mx >> 1, rsqrt 64 - ceil(mx / 2).
_OFFSET = {"mul": 0, "div": 127, "square": 0, "recip": 127, "sqrt": 0,
           "rsqrt": 64}
_REP2, _REP4 = 0x00010001, 0x01010101
_LANE_BIAS = 0x8000      # bit 15 of a lane: mag >= lo


class PackedConstants(NamedTuple):
    """The constants of one (format, op) pair the kernel's packed rule
    reads, each replicated into every lane (16-bit) or byte (8-bit)."""

    kb2: int   # lanes: K - OFF + 0x8000 - lo, so a lane is mag + 0x8000 - lo
    hb2: int   # lanes: hi + 0x8000 - lo, the saturation
    lo4: int   # bytes: lo, the smallest normal magnitude
    cl4: int   # bytes: 0x80 - lo; mx + it sets bit 7 iff mx >= lo
    cb4: int   # bytes: 0x80 - bad_from; mx + it sets bit 7 iff x is NaN/inf
    hi4: int   # bytes: hi, the largest normal magnitude


def packed_constants(fmt: str, op: str) -> PackedConstants:
    """The lane constants of ``csrc/fp8_elementwise.cu``'s packed rule for
    one (format, op) pair (every mode shares them; the carry differs)."""
    f = FORMATS[fmt]
    lo, hi = f.min_normal_code, f.max_normal_code
    bad_from = (f.exp_mask << f.man_bits) if f.has_inf else 0x7F
    assert f.nan_code == 0x7F, "the packed rule writes NaN as 0x7F"
    kb = folded_constant(fmt, op) - _OFFSET[op] + _LANE_BIAS - lo
    assert 0 < kb and kb + 255 < 0x10000, "a lane would wrap"
    return PackedConstants(
        kb2=kb * _REP2, hb2=(hi + _LANE_BIAS - lo) * _REP2, lo4=lo * _REP4,
        cl4=(0x80 - lo) * _REP4, cb4=(0x80 - bad_from) * _REP4,
        hi4=hi * _REP4)


_M32 = 0xFFFFFFFF


def _prmt(a, b, sel: int):
    """PTX ``prmt.b32`` (default mode) on int64 tensors of 32-bit words:
    result byte j is byte ``n & 7`` of ``{b, a}`` for the selector's
    nibble ``n`` j, or that byte's bit 7 replicated when ``n & 8``."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    out = torch.zeros_like(a)
    for j in range(4):
        n = (sel >> (4 * j)) & 0xF
        src = a if (n & 7) < 4 else b
        byte = (src >> (8 * (n & 3))) & 0xFF
        if n & 8:
            byte = torch.where((byte & 0x80) != 0, 0xFF, 0)
        out = out | (byte << (8 * j))
    return out


def _vminu2(a, b):
    """Unsigned minimum of each 16-bit lane (``__vminu2``)."""
    b = torch.as_tensor(b)
    lo = torch.minimum(a & 0xFFFF, b & 0xFFFF)
    hi = torch.minimum(a >> 16, b >> 16)
    return (hi << 16) | lo


def _funnel_r(w, s):
    """``__funnelshift_r(w, w, s)``: w rotated right by ``s & 31``."""
    s = s & 31
    return ((w >> s) | (w << (32 - s))) & _M32


def _sel(m, a, b):
    """Bytes of a where the byte mask m is 0xFF, of b where it is 0."""
    return (a & m) | (b & ~m & _M32)


def _carry_index_table(fmt: str, op: str, mode: str) -> torch.Tensor:
    """int64 [256] table the packed rule's carry reads: the cell's carry
    word (:func:`common.elementwise_carry_table`) of x index ``i`` at
    ``(x & 0xF) | (0xF0 if x has its sign bit)`` (words 0-15 and 240-255,
    in 32 different banks), 0 elsewhere."""
    words = elementwise_carry_table(fmt, op, mode).to(torch.int64) & _M32
    tab = torch.zeros(256, dtype=torch.int64)
    tab[:16] = words[:16]
    tab[240:] = words[16:]
    return tab


def packed_rule_model(op: str, x_codes, y_codes=None, *, fmt: str = "e4m3",
                      mode: str = "rne"):
    """Test model of K5's packed rule, step for step: the uint8 codes
    (padded by 0 to whole words) as little-endian 32-bit words, each step
    an int64 operation on the words as the kernel's 32-bit one.  Used
    only by the tests, which hold it against the reference."""
    c = packed_constants(fmt, op)
    tab = _carry_index_table(fmt, op, mode)
    binary = op in BINARY_OPS
    n = x_codes.numel()

    def words(t):
        b = torch.zeros(-(-n // 4) * 4, dtype=torch.int64)
        b[:n] = t.reshape(-1).to(torch.int64)
        b = b.reshape(-1, 4)
        return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)

    X = words(x_codes)
    Y = words(y_codes) if binary else torch.zeros_like(X)
    # flags in bit 7 of each byte, then byte masks
    AX, AY = X & 0x7F7F7F7F, Y & 0x7F7F7F7F
    XN, XB = AX + c.cl4, AX + c.cb4         # x normal-or-more / NaN-inf
    YN, YB = AY + c.cl4, AY + c.cb4
    XNM, YNM = _prmt(XN, 0, 0xBA98), _prmt(YN, 0, 0xBA98)
    BM = _prmt(XB | YB if binary else XB, 0, 0xBA98)
    # carry: x's index selects a word, y's index a bit of it
    IX = X & 0x0F0F0F0F | _prmt(X, 0, 0xBA98) & 0xF0F0F0F0
    IY = Y & 0x0F0F0F0F | (Y >> 3) & 0xF0F0F0F0 if binary else Y * 0
    cw = [_funnel_r(tab[_prmt(IX, 0, 0x4440 | i)], IY >> (8 * i))
          for i in range(4)]
    C4 = _prmt(_prmt(cw[0], cw[1], 0x0040), _prmt(cw[2], cw[3], 0x4000),
               0x7610) & 0x01010101
    # the op's bytes, with the carry: no byte exceeds 255
    NX = ~X & 0x7F7F7F7F
    if op == "mul":
        SUM = AX + AY + C4
    elif op == "div":
        SUM = AX + (~Y & 0x7F7F7F7F) + C4
    elif op == "square":
        SUM = AX + AX + C4
    elif op == "recip":
        SUM = NX + C4
    elif op == "sqrt":
        SUM = ((X >> 1) & 0x3F3F3F3F) + C4
    else:
        SUM = (((NX + 0x01010101) >> 1) & 0x7F7F7F7F) + C4
    # two codes a register: add K, saturate, read the underflow bit
    TE = _vminu2((_prmt(SUM, 0, 0x4240) + c.kb2) & _M32, c.hb2)
    TO = _vminu2((_prmt(SUM, 0, 0x4341) + c.kb2) & _M32, c.hb2)
    NUF = _prmt(TE, TO, 0xFBD9)             # 0xFF: mag >= lo
    MAG = (_prmt(TE, TO, 0x6240) & NUF) + c.lo4
    # the special cases in the reference's order, NaN last
    if op == "mul":
        out = (MAG & NUF & XNM & YNM) | ((X ^ Y) & 0x80808080)
    elif op == "div":
        S = (X ^ Y) & 0x80808080
        out = _sel(YNM, (MAG & NUF & XNM) | S,
                   S | _sel(XNM, c.hi4, 0x7F7F7F7F))
    elif op in ("square", "sqrt"):
        out = MAG & NUF & XNM
    else:                                   # recip, rsqrt
        out = _sel(XNM, MAG & NUF, c.hi4)
        if op == "recip":
            out = out | (X & 0x80808080)
    if op in ("sqrt", "rsqrt"):
        BM = BM | _prmt(X, 0, 0xBA98)       # a sign bit: NaN
    out = _sel(BM, 0x7F7F7F7F, out)
    b = torch.stack([(out >> (8 * i)) & 0xFF for i in range(4)], dim=1)
    return b.reshape(-1)[:n].to(torch.uint8).reshape(x_codes.shape)


_HOST_CONSTANTS = {}


def _host_constants(fmt: str, op: str) -> torch.Tensor:
    """:func:`packed_constants` as a host int32 tensor (the kernel's
    parameters), built once per (fmt, op)."""
    t = _HOST_CONSTANTS.get((fmt, op))
    if t is None:
        v = torch.tensor(packed_constants(fmt, op), dtype=torch.int64)
        t = _HOST_CONSTANTS[fmt, op] = torch.where(
            v >= 2**31, v - 2**32, v).to(torch.int32)
    return t


def _lib():
    from .cuda_build import load

    lib = load("fp8_elementwise")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fp8_elementwise.argtypes = ([ci] + [vp] * 3 + [ctypes.c_longlong]
                                        + [vp] * 3)
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
    x = x_codes.contiguous()
    y = None if y_codes is None else y_codes.contiguous()
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return out
    err = _lib().fp8_elementwise(
        OPS.index(op), x.data_ptr(), None if y is None else y.data_ptr(),
        out.data_ptr(), x.numel(), _host_constants(fmt, op).data_ptr(),
        table.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(err, "K5")
    fp8_elementwise.launches += 1
    return out


fp8_elementwise.launches = 0
