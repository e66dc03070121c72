"""FP8 format descriptors and bit-exact codecs.

The paper (Lindberg & Gustafsson, 2024) considers the two OCP FP8 interchange
formats [Micikevicius et al., arXiv:2209.05433]:

  * E5M2 -- IEEE-754 style: 5 exponent bits (bias 15), 2 mantissa bits,
    exponent field 0b11111 encodes inf/NaN.
  * E4M3 -- OCP "FN" style: 4 exponent bits (bias 7), 3 mantissa bits,
    NO infinities; S.1111.111 is the only NaN pattern, S.1111.110 = +-448
    is the largest normal.

Everything in this module is backend agnostic: functions accept numpy
arrays or torch tensors of integer codes and only use operators common to
both.  Decoding targets float32 (all FP8 values are exactly representable).

This is the PyTorch port's own copy of ``repro.core.formats`` (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` pins it
equal to the original field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "FP8Format",
    "E5M2",
    "E4M3",
    "FORMATS",
]


@dataclasses.dataclass(frozen=True)
class FP8Format:
    """Static description of an 8-bit floating-point format.

    >>> from repro_torch.core.formats import E4M3, E5M2
    >>> (E4M3.max_normal, E5M2.max_normal)
    (448.0, 57344.0)
    >>> (E4M3.bias, E4M3.B)  # the paper's b, and B = b << (p - 1)
    (7, 56)
    >>> float(E4M3.decode([0x08])[0])  # smallest positive normal, 2**-6
    0.015625
    >>> hex(E5M2.max_normal_code)
    '0x7b'
    """

    name: str
    exp_bits: int
    man_bits: int  # p - 1 trailing significand bits
    has_inf: bool  # IEEE style (E5M2) vs OCP FN style (E4M3)

    # ------------------------------------------------------------------ #
    # Derived constants
    # ------------------------------------------------------------------ #
    @property
    def p(self) -> int:
        """Precision (significand bits including the hidden one)."""
        return self.man_bits + 1

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def B(self) -> int:
        """The paper's LNS bias constant ``b << (p - 1)``."""
        return self.bias << self.man_bits

    @property
    def man_mask(self) -> int:
        return (1 << self.man_bits) - 1

    @property
    def exp_mask(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def sign_bit(self) -> int:
        return 0x80

    @property
    def mag_mask(self) -> int:
        return 0x7F

    @property
    def e_min(self) -> int:
        return 1 - self.bias

    @property
    def e_max(self) -> int:
        """Largest exponent usable by a normal number."""
        if self.has_inf:
            return self.exp_mask - 1 - self.bias  # top exponent reserved
        return self.exp_mask - self.bias  # OCP FN: top exponent is normal

    @property
    def min_normal(self) -> float:
        return float(2.0 ** self.e_min)

    @property
    def max_normal(self) -> float:
        if self.has_inf:
            m = self.man_mask
        else:
            m = self.man_mask - 1  # S.1111.111 is NaN for E4M3
        return float((1.0 + m / (1 << self.man_bits)) * 2.0 ** self.e_max)

    @property
    def min_normal_code(self) -> int:
        """Magnitude code of the smallest positive normal."""
        return 1 << self.man_bits

    @property
    def max_normal_code(self) -> int:
        """Magnitude code of the largest positive normal."""
        if self.has_inf:
            return ((self.exp_mask - 1) << self.man_bits) | self.man_mask
        return (self.exp_mask << self.man_bits) | (self.man_mask - 1)

    @property
    def nan_code(self) -> int:
        """A canonical quiet-NaN magnitude code."""
        if self.has_inf:
            # E5M2: exponent all ones, mantissa != 0.
            return (self.exp_mask << self.man_bits) | self.man_mask
        return (self.exp_mask << self.man_bits) | self.man_mask  # 0x7F

    @property
    def inf_code(self) -> int:
        if not self.has_inf:
            raise ValueError(f"{self.name} has no infinity")
        return self.exp_mask << self.man_bits

    # ------------------------------------------------------------------ #
    # Bit-field helpers (work on numpy arrays or torch tensors of any int dtype)
    # ------------------------------------------------------------------ #
    def sign(self, code):
        return (code >> 7) & 0x1

    def exp_field(self, code):
        return (code >> self.man_bits) & self.exp_mask

    def man_field(self, code):
        return code & self.man_mask

    def magnitude(self, code):
        return code & 0x7F

    def bit(self, code, i: int):
        """The paper's ``x_i``: bit *i* of the raw code (x7 = sign)."""
        return (code >> i) & 0x1

    # ------------------------------------------------------------------ #
    # Classification (array in, boolean array out)
    # ------------------------------------------------------------------ #
    def is_zero(self, code):
        return (code & 0x7F) == 0

    def is_subnormal(self, code):
        return (self.exp_field(code) == 0) & (self.man_field(code) != 0)

    def is_normal(self, code):
        mag = code & 0x7F
        return (mag >= self.min_normal_code) & (mag <= self.max_normal_code)

    def is_nan(self, code):
        if self.has_inf:
            return (self.exp_field(code) == self.exp_mask) & (
                self.man_field(code) != 0
            )
        return (code & 0x7F) == 0x7F

    def is_inf(self, code):
        if not self.has_inf:
            # E4M3 (OCP FN) has no infinities.
            return (code & 0x7F) < 0  # always-false array of right shape
        return (self.exp_field(code) == self.exp_mask) & (self.man_field(code) == 0)

    # ------------------------------------------------------------------ #
    # Codec (numpy implementation; exact)
    # ------------------------------------------------------------------ #
    def decode(self, code: np.ndarray) -> np.ndarray:
        """uint8 codes -> float64 values (exact). NaN maps to np.nan."""
        code = np.asarray(code, dtype=np.uint8).astype(np.int64)
        s = np.where(self.sign(code) == 1, -1.0, 1.0)
        e = self.exp_field(code)
        m = self.man_field(code)
        scale = 1 << self.man_bits
        normal = (1.0 + m / scale) * np.exp2(e.astype(np.float64) - self.bias)
        subnorm = (m / scale) * np.exp2(float(1 - self.bias))
        val = np.where(e == 0, subnorm, normal)
        out = s * val
        out = np.where(self.is_nan(code), np.nan, out)
        if self.has_inf:
            out = np.where(self.is_inf(code), s * np.inf, out)
        return out

    def all_normal_codes(self) -> np.ndarray:
        """All positive normal magnitude codes, ascending in value."""
        return np.arange(self.min_normal_code, self.max_normal_code + 1, dtype=np.int64)

    def normal_values(self) -> np.ndarray:
        """Values of all positive normals, ascending (code order = value order)."""
        return self.decode(self.all_normal_codes().astype(np.uint8))

    def code_to_float32_bits(self) -> np.ndarray:
        """Lookup table: 256 uint8 codes -> float32 values (for fast LUT decode)."""
        return self.decode(np.arange(256, dtype=np.uint8)).astype(np.float32)


E5M2 = FP8Format(name="e5m2", exp_bits=5, man_bits=2, has_inf=True)
E4M3 = FP8Format(name="e4m3", exp_bits=4, man_bits=3, has_inf=False)

FORMATS = {"e5m2": E5M2, "e4m3": E4M3}
