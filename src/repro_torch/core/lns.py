"""Integer constants of the paper's LNS-domain FP8 operations.

The port's copy of ``repro.core.lns.LNS_CONSTS``: an FP8 code read as an
8-bit integer is (via Mitchell) the scaled log2 of its value plus the bias
constant ``B``, so multiplication is an integer add of the two codes plus
the constant ``K`` below and a carry-in bit (Tables 2/3).  The paged
decode attention uses the ``mul`` entries; the elementwise ``lns_op`` and
its kernel arrive with a later slice of the port.
"""
from __future__ import annotations

__all__ = ["LNS_CONSTS"]

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
