"""Threefry-2x32 twin of ``jax.random``, bit-exact under jax 0.9 defaults.

The reference's stochastic KV writes draw their rounding noise from
``jax.random`` keyed by (engine stream, layer, write position).  Page
codes can equal the reference's only if the port draws the same bits, so
this module reimplements the pieces that chain uses:

  * :func:`prng_key` = ``jax.random.PRNGKey`` (raw ``uint32[2]`` keys),
  * :func:`split` and :func:`fold_in`,
  * :func:`random_bits` (32-bit) and :func:`randint`,

for ``jax_threefry_partitionable=True`` (the default since jax 0.5) with
64-bit mode off.  In that variant a key's ``i``-th split, its fold with
``i`` and the ``i``-th 32-bit draw all run the threefry-2x32 block cipher
on the counter pair ``(0, i)``; the draw xors the two output words.

Keys are int64 tensors of shape ``[..., 2]`` holding uint32 words, and
every function is vectorised over the leading batch dimensions, so a whole
decode sub-step's noise (all layers, K and V, all slots) is one call.
Arithmetic runs in int64 masked to 32 bits, because ``torch.uint32``
lacks most integer ops.  ``tests/test_torch_prng.py`` pins each function
against ``jax.random``.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["prng_key", "split", "fold_in", "random_bits", "randint",
           "threefry2x32"]

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_DTYPE_RANGE = {torch.uint32: (0, 2**32 - 1),
                torch.int32: (-2**31, 2**31 - 1)}


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 block cipher (20 rounds), elementwise.

    All four operands are int64 tensors of uint32 words, broadcastable
    against each other.  Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _M
    x1 = (x1 + k1) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``[0, seed mod 2**32]``."""
    if not -2**31 <= seed < 2**31:
        raise OverflowError("seeds are int32 with 64-bit mode off")
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def _counters(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys ``[..., 2]`` -> ``[..., num, 2]``."""
    k0, k1 = key[..., 0:1], key[..., 1:2]
    y0, y1 = threefry2x32(k0, k1, 0, _counters(num, key.device))
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``, vectorised: ``data`` (an int or an integer
    tensor) broadcasts against the key batch ``key[..., 0]``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit ``jax.random.bits``: keys ``[..., 2]`` -> ``[..., *shape]``
    int64 in ``[0, 2**32)``."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(*lead, 1)
    k1 = key[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, 0, _counters(n, key.device))
    return (y0 ^ y1).reshape(*lead, *shape)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``jax.random.randint`` for 32-bit integer dtypes, ``[minval,
    maxval)`` with both bounds inside the dtype.  Returns int64 values
    (the caller casts); keys ``[..., 2]`` -> ``[..., *shape]``."""
    lo, hi = _DTYPE_RANGE[dtype]
    if not (lo <= minval <= hi and lo <= maxval <= hi):
        raise ValueError(f"bounds [{minval}, {maxval}) outside {dtype}")
    span = (maxval - minval) & _M if maxval > minval else 1
    # The reference combines two 32-bit draws to cut the bias of
    # non-power-of-two spans; its multiplier is (2**16 mod span)**2 mod
    # span in uint32 arithmetic.  When that is 0 (every power-of-two span)
    # the high draw cannot change the result, so it is not drawn.
    mult = (((2**16 % span) * (2**16 % span)) & _M) % span
    keys = split(key, 2)
    offset = random_bits(keys[..., 1, :], shape) % span
    if mult:
        high = random_bits(keys[..., 0, :], shape) % span
        offset = (((high * mult) & _M) + offset) & _M
        offset = offset % span
    return minval + offset
