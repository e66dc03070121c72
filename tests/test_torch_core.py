"""PyTorch port, numeric core: formats, carry-ins, LNS product, codec.

Every check here is bit-exact against the JAX package on the same numpy
inputs: FP8 codes, carry bits, decoded products (NaN-aware) and page
scales are integer-domain results, so no tolerance applies.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import carry_ins as jcarry
from repro.core import formats as jformats
from repro.core import lns as jlns
from repro.core import quant as jquant
from repro.kernels import common as jcommon
from repro.serving import page_pool as jpool
from repro_torch.core import carry_ins, formats, lns, quant
from repro_torch.kernels import common
from repro_torch.serving import page_pool

FMTS = ("e5m2", "e4m3")
FACTORED = sorted(jcarry.FACTORED_MUL)


def _bits_equal(a, b):
    """Bitwise equality of two float32 arrays (NaN payloads included)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)
    b = np.ascontiguousarray(np.asarray(b, np.float32)).view(np.uint32)
    return np.array_equal(a, b)


@pytest.mark.parametrize("fmt", FMTS)
def test_formats_copy_equal_field_by_field(fmt):
    ref, port = jformats.FORMATS[fmt], formats.FORMATS[fmt]
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    props = [n for n, v in vars(jformats.FP8Format).items()
             if isinstance(v, property)]
    assert len(props) >= 15
    for name in props:
        if name == "inf_code" and not ref.has_inf:
            continue
        assert getattr(ref, name) == getattr(port, name), name
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(ref.decode(codes), port.decode(codes))
    np.testing.assert_array_equal(ref.code_to_float32_bits(),
                                  port.code_to_float32_bits())
    for pred in ("is_zero", "is_subnormal", "is_normal", "is_nan", "is_inf"):
        np.testing.assert_array_equal(
            getattr(ref, pred)(codes.astype(np.int64)),
            getattr(port, pred)(torch.from_numpy(codes.astype(np.int64))).numpy(),
            err_msg=pred)


def test_lns_consts_equal():
    assert lns.LNS_CONSTS == jlns.LNS_CONSTS


@pytest.mark.parametrize("key", FACTORED, ids=lambda k: "-".join(k))
def test_factored_mul_masks_bitwise(key):
    fmt, mode = key
    assert carry_ins.mul_carry_constant(fmt, mode) == \
        jcarry.mul_carry_constant(fmt, mode)
    codes = np.arange(256, dtype=np.int64)
    for side in ("x", "y"):
        ref = jcarry.mul_carry_term_mask(fmt, mode, codes, side)
        port = carry_ins.mul_carry_term_mask(fmt, mode,
                                             torch.from_numpy(codes), side)
        if ref is None:
            assert port is None
        else:
            np.testing.assert_array_equal(ref, port.numpy())


def test_unsupported_mode_raises():
    with pytest.raises(carry_ins.Unsupported):
        carry_ins.mul_carry_constant("e4m3", "ru")


@pytest.mark.parametrize("key", FACTORED, ids=lambda k: "-".join(k))
def test_lns_product_exhaustive_bitwise(key):
    """lns_prepare/lns_combine over all 256 x 256 code pairs."""
    fmt, mode = key
    X, Y = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    X, Y = X.astype(np.uint8), Y.astype(np.uint8)
    ref = jcommon.lns_combine(
        jcommon.lns_prepare(jnp.asarray(X), fmt, mode, side="x"),
        jcommon.lns_prepare(jnp.asarray(Y), fmt, mode, side="y"), fmt)
    port = common.lns_combine(
        common.lns_prepare(torch.from_numpy(X), fmt, mode, side="x"),
        common.lns_prepare(torch.from_numpy(Y), fmt, mode, side="y"), fmt)
    assert _bits_equal(ref, port.numpy())


@pytest.mark.parametrize("key", FACTORED, ids=lambda k: "-".join(k))
def test_lns_tables_hold_prepared_fields(key):
    """The kernel's lookup table packs exactly the prepared fields, and
    the table-driven product (the kernel's arithmetic, replayed in numpy)
    equals lns_combine on all 256 x 256 pairs."""
    fmt, mode = key
    fo = formats.FORMATS[fmt]
    lut = common.lns_tables(fmt, mode).numpy().astype(np.int64)
    X, Y = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    mx, fx = lut[0, X, 0], lut[0, X, 1] & 0xFFFFFFFF
    my, fy = lut[1, Y, 0], lut[1, Y, 1] & 0xFFFFFFFF
    mag = mx + my + (((fx & fy) & 0xFFFF) != 0)
    bits = ((fx ^ fy) & 0x80000000) | ((mag << (23 - fo.man_bits)) & 0xFFFFFFFF)
    val = bits.astype(np.uint32).view(np.float32).copy()
    val[((fx | fy) & common.ZERO_BIT) != 0] = 0.0
    val[((fx | fy) & common.BAD_BIT) != 0] = np.nan
    ref = common.lns_combine(
        common.lns_prepare(torch.from_numpy(X), fmt, mode, side="x"),
        common.lns_prepare(torch.from_numpy(Y), fmt, mode, side="y"), fmt)
    assert _bits_equal(val, ref.numpy())


@pytest.mark.parametrize("fmt", FMTS)
def test_code_to_f32_all_codes_bitwise(fmt):
    codes = np.arange(256, dtype=np.uint8)
    ref = jcommon.code_to_f32(jnp.asarray(codes), fmt)
    port = common.code_to_f32(torch.from_numpy(codes), fmt)
    assert _bits_equal(ref, port.numpy())


def _encode_grid():
    """Finite normals and subnormals of float32 and of both FP8 formats,
    exact FP8 values and the midpoints between them (ties), saturation,
    +-0, +-inf and NaN."""
    rng = np.random.default_rng(0)
    vals = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-40,
            1.1754944e-38, 3.4e38, -3.4e38, 448.0, 449.0, 464.0, 480.0,
            57344.0, 61440.0, 65536.0, 1e6]
    for fo in formats.FORMATS.values():
        v = fo.normal_values()
        vals += list(v) + list((v[:-1] + v[1:]) / 2)
        vals += [fo.min_normal / 2, fo.min_normal / 4, fo.min_normal * 0.75,
                 fo.min_normal / 2 * (1 + 2**-20)]
    vals += list(rng.standard_normal(2000) * 10.0 ** rng.integers(-8, 6, 2000))
    g = np.asarray(vals, np.float32)
    return np.concatenate([g, -g])


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("mode", ["rne", "rz"])
def test_encode_deterministic_grid_bitwise(fmt, mode):
    x = _encode_grid()
    ref = np.asarray(jquant.encode(jnp.asarray(x), fmt, mode))
    port = quant.encode(torch.from_numpy(x), fmt, mode).numpy()
    np.testing.assert_array_equal(ref, port)


@pytest.mark.parametrize("fmt", FMTS)
def test_encode_stochastic_given_jax_noise_bitwise(fmt):
    """The port takes the noise as an argument: hand it JAX's bits."""
    x = _encode_grid()
    shift = 23 - formats.FORMATS[fmt].man_bits
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jquant.encode(jnp.asarray(x), fmt, "stochastic", key=key))
    noise = np.asarray(jax.random.randint(key, x.shape, 0, 1 << shift,
                                          dtype=jnp.uint32))
    port = quant.encode(torch.from_numpy(x), fmt, "stochastic",
                        noise=torch.from_numpy(noise.astype(np.int64)))
    np.testing.assert_array_equal(ref, port.numpy())
    with pytest.raises(ValueError):
        quant.encode(torch.from_numpy(x), fmt, "stochastic")


@pytest.mark.parametrize("fmt", FMTS)
def test_decode_all_codes(fmt):
    codes = np.arange(256, dtype=np.uint8)
    ref = np.asarray(jquant.decode(jnp.asarray(codes), fmt))
    port = quant.decode(torch.from_numpy(codes), fmt).numpy()
    assert _bits_equal(ref, port)


@pytest.mark.parametrize("fmt", FMTS)
def test_pow2_page_scale_bitwise(fmt):
    rng = np.random.default_rng(1)
    amax = np.concatenate([
        np.asarray([0.0, 1e-30, 1e-12, 1e-6, 0.5, 1.0, 2.0, 3.0, 448.0,
                    57344.0, 1e10, 3.4e38, np.inf], np.float32),
        (2.0 ** rng.integers(-40, 40, 200)).astype(np.float32),
        np.abs(rng.standard_normal(500) * 10.0 ** rng.integers(-6, 8, 500)),
    ]).astype(np.float32)
    ref = np.asarray(jpool.pow2_page_scale(jnp.asarray(amax), fmt))
    port = page_pool.pow2_page_scale(torch.from_numpy(amax), fmt).numpy()
    assert _bits_equal(ref, port)
