"""PyTorch port: the one-hot plane form of the paper's LNS product (kernel
K3's design) against the JAX package.

``common.lns_plane_tables`` factors the product of codes x and y as
``A(x) * B[r(x), y]``.  Single products are held to JAX's
``lns_mul_to_f32`` exactly in value (NaN exactly where JAX gives NaN; a
zero may differ in sign, which a +0 accumulator absorbs).  The planes
expanded in K3's layout (plane column ``k R + r``) and multiplied in
float32 are held to JAX's Pallas K3 (``impl="lns"``, interpret mode)
within the float32 summation bound ``2 K 2^-24 sum_k |product|``: both
add the same exact products, in other orders.

K4 adds the same factored products in the reference's seed order, each
as one float multiply-add: its table (``lns_matmul.loop_tables``) decoded
as the kernel decodes it, the tile sums computed apart (as blocks that
split the k tiles compute them) and added in tile order, is held bit for
bit (int32 views, NaN as NaN) to K4's plain version and to JAX's Pallas
K4 (``impl="lns_loop"``, interpret mode).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import common as jcommon
from repro.kernels import lns_matmul as jlm
from repro_torch.core.carry_ins import FACTORED_MUL
from repro_torch.core.formats import FORMATS
from repro_torch.kernels import common, ref
from repro_torch.kernels import lns_matmul as lm

CELLS = sorted(FACTORED_MUL)


def _jax_products(fmt, mode, X, Y):
    return np.asarray(jcommon.lns_mul_to_f32(
        jnp.asarray(X, jnp.uint8), jnp.asarray(Y, jnp.uint8), fmt, mode))


@pytest.mark.parametrize("key", CELLS, ids="-".join)
def test_planes_factor_every_product(key):
    fmt, mode = key
    pt = common.lns_plane_tables(fmt, mode)
    X, Y = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    want = _jax_products(fmt, mode, X, Y)
    A = pt.A.numpy()
    B = pt.B.float().numpy()
    got = A[X] * B[pt.cls.numpy()[X], Y]           # float32: exact products
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])


@pytest.mark.parametrize("key", CELLS, ids="-".join)
def test_every_plane_entry_is_exact_in_bf16(key):
    """B[r, y] equals the exact quotient P(rep_r, y) / A(rep_r) (float64)
    for the class's code of exponent ``bias``, NaN for a NaN/inf y."""
    fmt, mode = key
    f = FORMATS[fmt]
    pt = common.lns_plane_tables(fmt, mode)
    r = np.arange(pt.R)
    rep = (r & f.man_mask) | (f.bias << f.man_bits) | ((r >> f.man_bits) << 7)
    P = _jax_products(fmt, mode, rep[:, None], np.arange(256)[None, :])
    quot = P.astype(np.float64) / pt.A.numpy()[rep, None].astype(np.float64)
    B = pt.B.float().numpy().astype(np.float64)
    assert pt.B.dtype == torch.bfloat16 and pt.B.shape == (pt.R, 256)
    nan = np.isnan(quot)
    np.testing.assert_array_equal(np.isnan(B), nan)
    np.testing.assert_array_equal(B[~nan], quot[~nan])
    bad = (np.arange(256) & 0x7F) >= pt.bad_min
    assert np.isnan(B[:, bad]).all() and not np.isnan(B[:, ~bad]).any()
    zero = (np.arange(256) & 0x7F) < f.min_normal_code
    assert (B[:, zero] == 0).all()


@pytest.mark.parametrize("key", CELLS, ids="-".join)
def test_plane_count(key):
    fmt, mode = key
    pt = common.lns_plane_tables(fmt, mode)
    signed = fmt == "e5m2" and mode in ("ru", "rd")
    assert pt.sign_classes == signed
    assert pt.R == (4 if fmt == "e5m2" and not signed else 8)
    assert sorted(set(pt.cls.tolist())) == list(range(pt.R))


@pytest.mark.parametrize("key", CELLS, ids="-".join)
def test_x_side_bit_rule_and_nan_mark(key):
    """The rule K3 applies to x, with the parameters its wrapper passes:
    A(x) as bf16 bits by bit placement, 0 below the smallest normal, NaN
    from ``bad_min`` up; the class is the mantissa field (and the sign)."""
    fmt, mode = key
    f = FORMATS[fmt]
    pt = common.lns_plane_tables(fmt, mode)
    c = np.arange(256, dtype=np.uint32)
    mag, sgn = c & 0x7F, c >> 7
    bits = (sgn << 15) | (((mag >> f.man_bits) + 127 - f.bias) << 7)
    bits = np.where(mag < f.min_normal_code, 0, bits)
    bits = np.where(mag >= pt.bad_min, 0x7FC0, bits)
    A = (bits.astype(np.uint32) << 16).view(np.float32)
    want = pt.A.numpy()
    np.testing.assert_array_equal(np.isnan(A), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(A[ok], want[ok])
    cls = (mag & f.man_mask) | ((sgn << f.man_bits) if pt.sign_classes
                                else 0)
    np.testing.assert_array_equal(cls, pt.cls.numpy())
    # decoding the bits of a NaN/inf code would give a number: it is marked
    nan_codes = [0x7F, 0xFF] if fmt == "e4m3" else [0x7C, 0x7D, 0xFE, 0xFF]
    assert np.isnan(want[nan_codes]).all()
    assert pt.bad_min == (0x7F if fmt == "e4m3" else 0x7C)
    np.testing.assert_array_equal(want[[0, 0x80, 1, 0x81]], 0.0)


def _expand(x, w, pt):
    """K3's operands in its layout: plane column ``k R + r`` of x's one-hot
    rows [M, K R] and of w's plane values [K R, N], float32."""
    M, K = x.shape
    xi, wi = x.long(), w.long()
    xp = torch.zeros((M, K, pt.R), dtype=torch.float32)
    xp.scatter_(2, pt.cls[xi][..., None], pt.A[xi][..., None])
    wp = pt.B.float()[:, wi].permute(1, 0, 2)          # [K, R, N]
    return xp.reshape(M, K * pt.R), wp.reshape(K * pt.R, -1)


def _codes(rng, shape, fmt):
    c = rng.integers(0, 256, shape).astype(np.uint8)
    bad = (c & 0x7F) >= (0x7C if fmt == "e5m2" else 0x7F)
    return np.where(bad, c & 0xF0, c).astype(np.uint8)


@pytest.mark.parametrize("key", CELLS, ids="-".join)
def test_plane_gemm_matches_reference_kernel(key):
    """The planes, expanded from the tables, multiplied in float32 without
    BLAS (products, then a sum over the plane columns), against JAX's K3
    at a ragged shape with zero, negative-zero and NaN codes on both
    sides."""
    fmt, mode = key
    rng = np.random.default_rng(len(fmt) * 31 + len(mode))
    M, K, N = 13, 37, 11
    x, w = _codes(rng, (M, K), fmt), _codes(rng, (K, N), fmt)
    nan = 0x7F if fmt == "e4m3" else 0x7E
    x[0, :3] = [nan, 0x80, 0]
    w[:3, 1] = [0, 0x80, nan]
    x[2, 4] = 0x01                                   # subnormal
    want = np.asarray(jlm.lns_matmul(jnp.asarray(x), jnp.asarray(w),
                                     fmt=fmt, mode=mode, impl="lns",
                                     interpret=True))
    pt = common.lns_plane_tables(fmt, mode)
    xp, wp = _expand(torch.from_numpy(x), torch.from_numpy(w), pt)
    got = (xp[:, :, None] * wp[None, :, :]).sum(dim=1).numpy()
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    absum = ref.lns_matmul_ref(tx & 0x7F, tw & 0x7F, fmt, mode).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[0]).all() and np.isnan(want[:, 1]).all()
    ok = ~np.isnan(want)
    bound = 2 * K * 2.0 ** -24 * absum[ok]
    assert (np.abs(got[ok] - want[ok]) <= bound).all()


@pytest.mark.parametrize("M,N,n_sm,tile", [
    (1024, 4864, 132, 128),   # 8 x 38 = 304 tiles of 128
    (1024, 896, 132, 64),     # 56 of 128 < 132 <= 224 of 64
    (1024, 128, 132, 32),     # 32 of 64: narrow, the smallest tile
    (256, 256, 132, 32),      # the products check
    (2048, 2048, 132, 128),
    (1024, 896, 40, 128),     # a smaller card takes the larger tile
    (1, 1, 1, 128),
])
def test_lns_tile_rule(M, N, n_sm, tile):
    assert lm.lns_tile(M, N, n_sm) == tile
    for t in lm.LNS_TILES:
        fills = -(-M // t) * -(-N // t) >= n_sm
        if t > tile:
            assert not fills
        if t == tile and t != lm.LNS_TILES[-1]:
            assert fills


def test_device_plane_table_is_kept():
    a = common.device_plane_table("e5m2", "ru", "cpu")
    assert common.device_plane_table("e5m2", "ru", "cpu") is a
    assert torch.equal(a.view(torch.int16),
                       common.lns_plane_tables("e5m2", "ru").B.view(
                           torch.int16))
    assert common.lns_plane_tables("e4m3", "rne") is \
        common.lns_plane_tables("e4m3", "rne")


# --------------------------------------------------------------------------- #
# K4: the factored products in the seed order
# --------------------------------------------------------------------------- #
def _k4_order(x, w, fmt, mode):
    """K4's arithmetic on the CPU: A and the B row from the x word as the
    kernel splits it, B from the table's float32 bits, ``tile + A * B``
    per k in order (A * B is exact, so this is the kernel's fmaf), each
    tile's sum started from +0 apart from the others, then the sums added
    to a +0 output in tile order."""
    tab = lm.loop_tables(fmt, mode)
    words = tab[:256].to(torch.int64) & 0xFFFFFFFF
    a_bits = words & ~lm.LOOP_OFF_MASK & 0xFFFFFFFF
    A = torch.where(a_bits >= 2**31, a_bits - 2**32, a_bits).to(
        torch.int32).view(torch.float32)
    row = (words & lm.LOOP_OFF_MASK) // (4 * lm.LOOP_PITCH)
    pt = common.lns_plane_tables(fmt, mode)
    assert torch.equal(row, pt.cls)
    assert torch.equal(torch.isnan(A), torch.isnan(pt.A))
    B = tab[256:].view(torch.float32).reshape(pt.R, 256)
    M, K = x.shape
    xi, wi = x.long(), w.long()
    bk = lm.loop_bk(K)
    sums = []
    for k0 in range(0, K, bk):
        tile = torch.zeros((M, w.shape[1]), dtype=torch.float32)
        for k in range(k0, min(k0 + bk, K)):
            tile = tile + A[xi[:, k]][:, None] * B[row[xi[:, k]]][:, wi[k]]
        sums.append(tile)
    out = torch.zeros_like(sums[0])
    for tile in sums:
        out = out + tile
    return out


def _bits_equal_nan_as_nan(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(b)
    return (np.array_equal(np.isnan(a), nan)
            and np.array_equal(a[~nan].view(np.int32),
                               b[~nan].view(np.int32)))


@pytest.mark.parametrize("K", [1, 127, 128, 257, 300])
@pytest.mark.parametrize("key", CELLS, ids="-".join)
def test_k4_order_bitwise_equal_to_plain_and_reference(key, K):
    fmt, mode = key
    rng = np.random.default_rng(K * 13 + len(mode))
    M, N = 5, 6
    x, w = _codes(rng, (M, K), fmt), _codes(rng, (K, N), fmt)
    nan = 0x7F if fmt == "e4m3" else 0xFE
    x[0, 0], x[1, -1] = 0, nan                  # a zero and a NaN code
    w[0, 2], w[-1, 3] = 0x80, nan               # -0 and NaN in w
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = _k4_order(tx, tw, fmt, mode).numpy()
    plain = lm.lns_loop_matmul_plain(tx, tw, fmt=fmt, mode=mode).numpy()
    want = np.asarray(jlm.lns_matmul(jnp.asarray(x), jnp.asarray(w), fmt=fmt,
                                     mode=mode, impl="lns_loop",
                                     interpret=True))
    assert np.isnan(want).any() and not np.isnan(want).all()
    assert _bits_equal_nan_as_nan(got, plain)
    assert _bits_equal_nan_as_nan(got, want)


@pytest.mark.parametrize("M,N,K,split", [
    (1024, 896, 896, (1, 7)),       # 112 blocks: half the card or more
    (1024, 4864, 896, (1, 7)),
    (1024, 896, 4864, (1, 38)),
    (1024, 128, 896, (7, 1)),       # 16 blocks: a block a tile
    (1024, 128, 4864, (8, 5)),      # 8 blocks a tile: 5 tiles each
    (3, 5, 1000, (8, 1)),
    (5, 7, 100, (1, 1)),            # one tile (bk = K)
])
def test_loop_split_rule(M, N, K, split):
    assert lm.loop_split(M, N, K, 132) == split
    splits, per = split
    tiles = -(-K // lm.loop_bk(K))
    assert (splits - 1) * per < tiles <= splits * per
