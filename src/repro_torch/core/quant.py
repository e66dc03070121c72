"""FP8 encode/decode on torch tensors, bit-exact with ``repro.core.quant``.

Encoding works on the float32 bit pattern with integer ops (no LUT, no
search), so it runs unchanged on the CPU and on the card.  Bit arithmetic
is done in int64 holding 32-bit patterns, because ``torch.uint32`` lacks
most integer ops; every intermediate stays below 2**33.

Stochastic rounding takes its uniform noise as an argument instead of a
PRNG key: ``noise`` holds integers in ``[0, 1 << (23 - man_bits))``,
added to the float32 bits before truncation.  The serving path draws it
with the threefry twin (:mod:`repro_torch.core.prng`) so it equals the
reference's ``jax.random.randint`` bits, and tests can hand it JAX's bits
directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .formats import FORMATS, FP8Format

__all__ = ["QTensor", "quantize", "encode", "decode", "decode_lut",
           "f32_bits", "f32_from_bits"]


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 tensor -> its bit patterns as int64 in ``[0, 2**32)``."""
    x = x.to(torch.float32).contiguous()
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def f32_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`f32_bits`: the low 32 bits of an integer tensor
    reinterpreted as float32 (explicit two's-complement narrowing)."""
    bits = bits & 0xFFFFFFFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def encode(x, fmt: FP8Format | str, mode: str = "rne", *,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """float tensor -> uint8 FP8 codes with saturation and FTZ.

    Modes: ``rne`` (default), ``rz``, ``stochastic`` (needs ``noise``,
    broadcastable to ``x``).  NaN -> canonical NaN code; +-inf saturates
    to +-max_normal.
    """
    if isinstance(fmt, str):
        fmt = FORMATS[fmt]
    x = torch.as_tensor(x, dtype=torch.float32)
    sign = f32_bits(x) >> 31
    isnan = torch.isnan(x)
    absx = torch.where(isnan, 1.0, x.abs())
    absx = torch.clamp_max(absx, fmt.max_normal)

    shift = 23 - fmt.man_bits
    b = f32_bits(absx)
    if mode == "rne":
        lsb = (b >> shift) & 1
        b = b + ((1 << (shift - 1)) - 1) + lsb
    elif mode == "rz":
        pass
    elif mode == "stochastic":
        if noise is None:
            raise ValueError("stochastic rounding needs its uniform noise")
        b = b + noise.to(torch.int64)
    else:
        raise ValueError(f"unknown encode mode {mode!r}")

    exp = (b >> 23) - 127 + fmt.bias
    man = (b >> shift) & fmt.man_mask
    code = (exp.clamp_min(0) << fmt.man_bits) | man

    # Flush-to-zero, exactly as the reference: values that would need an
    # exponent field < 1 become 0 or min_normal (RNE tie -> 0, "even").
    # Stochastic mode keeps the reference's coarse ``absx > half_min``.
    underflow = exp < 1
    if mode == "rz":
        to_min = torch.zeros_like(underflow)
    else:
        to_min = absx > 0.5 * fmt.min_normal
    code = torch.where(underflow,
                       torch.where(to_min, fmt.min_normal_code, 0), code)
    code = code.clamp(0, fmt.max_normal_code)
    code = torch.where(isnan, fmt.nan_code, code)
    return ((sign << 7) | code).to(torch.uint8)


_DECODE_LUTS = {}


def decode_lut(fmt: FP8Format | str, device=None) -> torch.Tensor:
    """256-entry float32 decode table (subnormals, NaN and inf kept),
    built once per (format, device) and kept: a host-to-device copy on
    every decode would stall the host on the card's queue."""
    if isinstance(fmt, str):
        fmt = FORMATS[fmt]
    key = (fmt.name, torch.device(device or "cpu"))
    lut = _DECODE_LUTS.get(key)
    if lut is None:
        lut = _DECODE_LUTS[key] = torch.from_numpy(
            fmt.code_to_float32_bits()).to(device)
    return lut


def decode(codes: torch.Tensor, fmt: FP8Format | str) -> torch.Tensor:
    """uint8 codes -> float32 by a 256-entry table gather."""
    return decode_lut(fmt, codes.device)[codes.to(torch.int64)]


# --------------------------------------------------------------------------- #
# Scaled tensors
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class QTensor:
    """FP8-quantized tensor: ``value ~= decode(codes) * scale``.

    ``scale`` broadcasts against the decoded codes (per-tensor scalar or a
    per-channel vector kept with a size-1 axis); ``fmt`` names the format.
    """

    codes: torch.Tensor  # uint8
    scale: torch.Tensor  # float32, broadcastable
    fmt: str  # "e5m2" | "e4m3"

    def dequantize(self) -> torch.Tensor:
        return decode(self.codes, self.fmt) * self.scale


ENCODE_SLAB = 2**26     # elements a slab of :func:`quantize`'s encode


def quantize(x, fmt: FP8Format | str = "e4m3", *,
             axis: Optional[int | tuple] = None, mode: str = "rne",
             reduce=None) -> QTensor:
    """Quantize a float tensor; ``axis`` keeps a per-channel scale along it
    (a tuple keeps one scale per index of all its axes: ``(0, 2)`` of an
    expert weight [E, D, F] gives scales [E, 1, F], as the reference's
    per-channel ``quantize`` under a ``vmap`` over experts does).

    The scale maps the absmax onto the format's max_normal, so the full
    exponent range is used; the codes are ``encode(x / scale)`` (a true
    division, as the reference computes it: a multiply by the reciprocal
    would move codes).  ``reduce`` maps the absmax before the scale is
    taken (the maximum over a tensor-parallel mesh's shards of ``x``).

    The encode runs ``ENCODE_SLAB`` elements at a time along the first
    axis (elementwise, so the codes are those of one pass): its int64
    temporaries for a whole expert stack of ~1e9 elements would take
    ~40 GB at once.
    """
    if isinstance(fmt, str):
        fmt_obj = FORMATS[fmt]
    else:
        fmt_obj, fmt = fmt, fmt.name
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    # the absmax in x's own float type: abs and max are exact there, and
    # its float32 value is the absmax of x in float32
    if axis is None:
        amax = x.abs().amax()
    else:
        keep = {a % x.ndim for a in (axis if isinstance(axis, tuple)
                                     else (axis,))}
        dims = tuple(i for i in range(x.ndim) if i not in keep)
        amax = x.abs().amax(dim=dims, keepdim=True)
    amax = amax.to(torch.float32)
    if reduce is not None:
        amax = reduce(amax)
    amax = torch.clamp_min(amax, 1e-12)
    scale = amax / fmt_obj.max_normal
    if x.ndim == 0 or x.numel() <= ENCODE_SLAB:
        codes = encode(x.to(torch.float32) / scale, fmt_obj, mode)
        return QTensor(codes=codes, scale=scale, fmt=fmt)
    rows = max(1, ENCODE_SLAB // x[0].numel())
    per_row = scale.ndim == x.ndim and scale.shape[0] > 1
    codes = torch.cat([
        encode(xs.to(torch.float32)
               / (scale[i:i + rows] if per_row else scale), fmt_obj, mode)
        for i, xs in zip(range(0, x.shape[0], rows), x.split(rows))])
    return QTensor(codes=codes, scale=scale, fmt=fmt)

