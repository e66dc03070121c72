"""PyTorch port: quantize, the LNS product and the quantized matmuls (the
plain versions of kernels K2, K3 and K4) against the JAX package.

Integer-domain results are bitwise: codes, scales and every single LNS
product.  K2's and K3's sums are held to the float32 summation bound
``2 K 2^-24 sum_k |product|`` per element: the port and the reference
add the same exact products in other orders (the reference's Pallas
kernel in [bm, ck, bn] chunks, the port's plain version in K chunks).
K4's sums run in the reference's own order (k in order within tiles of
``min(128, K)``, tiles in order), so its plain version is held to the
reference bit for bit, NaN as NaN.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import quant as jquant
from repro.kernels import autotune as jautotune
from repro.kernels import common as jcommon
from repro.kernels import lns_matmul as jlm
from repro.kernels import ops as jops
from repro_torch.core import quant
from repro_torch.core.carry_ins import FACTORED_MUL
from repro_torch.kernels import autotune, common, cuda_build, ops, ref
from repro_torch.kernels import lns_matmul as lm

FMTS = ("e4m3", "e5m2")


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)
    b = np.ascontiguousarray(np.asarray(b, np.float32)).view(np.uint32)
    return np.array_equal(a, b)


def _within_sum_bound(got, want, absum, K):
    """Elementwise |got - want| <= 2 K 2^-24 sum|products| (NaN as NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    bound = 2 * K * 2.0 ** -24 * np.asarray(absum)[ok]
    assert (np.abs(got[ok] - want[ok]) <= bound).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("axis", [None, -1])
@pytest.mark.parametrize("mode", ["rne", "rz"])
def test_quantize_codes_and_scales_bitwise(dtype, fmt, axis, mode):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((37, 53))
         * rng.uniform(1e-3, 1e2, (1, 53))).astype(np.float32)
    x[3, 5] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jquant.quantize(jx, fmt, axis=axis, mode=mode)
    got = quant.quantize(tx, fmt, axis=axis, mode=mode)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert got.scale.shape == np.asarray(want.scale).shape
    assert _bits_equal(got.scale.numpy(), want.scale)
    assert got.fmt == want.fmt
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))


def test_quantize_divides_by_the_scale():
    """The codes come from x / scale, not x * (1 / scale): the two differ
    in the last bit for some inputs and then move codes."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    q = quant.quantize(x, "e4m3")
    np.testing.assert_array_equal(
        q.codes.numpy(), quant.encode(x / q.scale, "e4m3").numpy())
    assert not torch.equal(x / q.scale, x * (1.0 / q.scale))


@pytest.mark.parametrize("key", sorted(FACTORED_MUL), ids="-".join)
def test_lns_mul_to_f32_all_pairs_bitwise(key):
    fmt, mode = key
    X, Y = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    want = jcommon.lns_mul_to_f32(jnp.asarray(X, jnp.uint8),
                                  jnp.asarray(Y, jnp.uint8), fmt, mode)
    got = common.lns_mul_to_f32(torch.from_numpy(X).to(torch.uint8),
                                torch.from_numpy(Y).to(torch.uint8), fmt,
                                mode)
    assert _bits_equal(got.numpy(), want)


def _codes(rng, shape, fmt):
    """Random codes without NaN/inf patterns (special codes are covered
    by the all-pairs product test)."""
    c = rng.integers(0, 256, shape).astype(np.uint8)
    mag = c & 0x7F
    bad = mag >= (0x7C if fmt == "e5m2" else 0x7F)
    return np.where(bad, c & 0xF0, c).astype(np.uint8)


@pytest.mark.parametrize("fmt,mode,M,K,N", [
    ("e4m3", "rne", 37, 70, 45), ("e5m2", "rne", 5, 130, 3),
    ("e4m3", "faithful", 64, 33, 129), ("e5m2", "ru", 1, 7, 200),
])
def test_plain_k3_matches_reference_kernel(fmt, mode, M, K, N):
    rng = np.random.default_rng(M * N + K)
    x, w = _codes(rng, (M, K), fmt), _codes(rng, (K, N), fmt)
    x[0, :3] = [0x7F if fmt == "e4m3" else 0x7E, 0x80, 0]  # NaN, -0, 0
    want = jlm.lns_matmul(jnp.asarray(x), jnp.asarray(w), fmt=fmt, mode=mode,
                          impl="lns", interpret=True)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    before = lm.lns_product_matmul.launches
    got = lm.lns_matmul(tx, tw, fmt=fmt, mode=mode, impl="lns")
    assert lm.lns_product_matmul.launches == before  # CPU: plain version
    chunked = lm.lns_matmul_plain(tx, tw, fmt=fmt, mode=mode, chunk=97)
    whole = ref.lns_matmul_ref(tx, tw, fmt, mode)
    absum = ref.lns_matmul_ref(tx & 0x7F, tw & 0x7F, fmt, mode).numpy()
    for out in (got, chunked, whole):
        _within_sum_bound(out.numpy(), want, absum, K)


def _nan_aware_bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(b)
    return np.array_equal(np.isnan(a), nan) and _bits_equal(a[~nan], b[~nan])


@pytest.mark.parametrize("K", [128, 257, 300, 896])
@pytest.mark.parametrize("key", sorted(FACTORED_MUL), ids="-".join)
def test_plain_k4_bitwise_equal_to_reference_kernel(key, K):
    """Random codes with zero, negative-zero and NaN codes; odd M and N;
    K a whole tile, a tile and one, ragged, and qwen2-0.5b's width."""
    fmt, mode = key
    rng = np.random.default_rng(K + len(mode))
    M, N = 5, 7
    x = rng.integers(0, 256, (M, K)).astype(np.uint8)
    w = rng.integers(0, 256, (K, N)).astype(np.uint8)
    x[0, :3] = [0, 0x80, 0x7F]            # 0, -0, NaN (both formats)
    w[:4, 1] = [0, 0x80, 0xFF, 0x01]      # 0, -0, NaN, subnormal
    want = jlm.lns_matmul(jnp.asarray(x), jnp.asarray(w), fmt=fmt, mode=mode,
                          impl="lns_loop", interpret=True)
    before = lm.lns_loop_matmul.launches
    got = lm.lns_matmul(torch.from_numpy(x), torch.from_numpy(w), fmt=fmt,
                        mode=mode, impl="lns_loop")
    assert lm.lns_loop_matmul.launches == before  # CPU: plain version
    assert np.isnan(np.asarray(want)).any()
    assert _nan_aware_bits_equal(got.numpy(), want)
    chunked = lm.lns_loop_matmul_plain(torch.from_numpy(x),
                                       torch.from_numpy(w), fmt=fmt,
                                       mode=mode, chunk=3)
    assert _nan_aware_bits_equal(chunked.numpy(), want)


@pytest.mark.parametrize("fmt,mode", [("e4m3", "rne"), ("e5m2", "rz")])
def test_plain_k4_within_the_sum_bound_of_plain_k3(fmt, mode):
    """The same products as K3, summed in another order."""
    rng = np.random.default_rng(9)
    x, w = _codes(rng, (33, 300), fmt), _codes(rng, (300, 21), fmt)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    loop = lm.lns_loop_matmul_plain(tx, tw, fmt=fmt, mode=mode)
    k3 = lm.lns_matmul_plain(tx, tw, fmt=fmt, mode=mode)
    absum = lm.lns_matmul_plain(tx & 0x7F, tw & 0x7F, fmt=fmt, mode=mode)
    _within_sum_bound(loop.numpy(), k3.numpy(), 2 * absum.numpy(), 300)
    assert not torch.equal(loop, k3)  # another order, not the same sums


def test_matmul_q_lns_loop_matches_reference():
    """``matmul_q(impl="lns_loop")``: K4's sums and then the scales in the
    reference's order, bit for bit."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((19, 300)).astype(np.float32)
    w = (rng.standard_normal((300, 24)) * 0.05).astype(np.float32)
    jx = jquant.quantize(jnp.asarray(x), "e4m3")
    jw = jquant.quantize(jnp.asarray(w), "e4m3", axis=-1)
    want = jops.matmul_q(jx, jw, impl="lns_loop", mode="rz", interpret=True)
    qx = quant.quantize(torch.from_numpy(x), "e4m3")
    qw = quant.quantize(torch.from_numpy(w), "e4m3", axis=-1)
    got = ops.matmul_q(qx, qw, impl="lns_loop", mode="rz")
    assert _nan_aware_bits_equal(got.numpy(), want)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_plain_k2_matches_reference_kernel(cd):
    rng = np.random.default_rng(3)
    M, K, N = 33, 70, 50
    x, w = _codes(rng, (M, K), "e5m2"), _codes(rng, (K, N), "e4m3")
    want = jlm.lns_matmul(jnp.asarray(x), jnp.asarray(w), fmt="e5m2",
                          w_fmt="e4m3", impl="fused_dequant", interpret=True,
                          compute_dtype=getattr(jnp, cd))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    kw = dict(fmt="e5m2", w_fmt="e4m3", compute_dtype=getattr(torch, cd))
    got = lm.lns_matmul(tx, tw, impl="fused_dequant", **kw)
    absum = lm.dequant_matmul_plain(tx & 0x7F, tw & 0x7F, **kw).numpy()
    _within_sum_bound(got.numpy(), want, absum, K)
    # subnormal, NaN and inf codes decode to 0 (the reference's decode)
    specials = torch.tensor([[0x01, 0x7F, 0x7C, 0xFD]], dtype=torch.uint8)
    ones = torch.full((4, 1), 0x38, dtype=torch.uint8)  # 1.0 in e4m3
    assert float(lm.lns_matmul(specials, ones, impl="fused_dequant",
                               fmt="e5m2", w_fmt="e4m3")) == 0.0


@pytest.mark.parametrize("impl,act_fmt", [
    ("xla", "e5m2"), ("lns", "e4m3"), ("fused_dequant", "e5m2")])
def test_matmul_q_with_scales_matches_reference(impl, act_fmt):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((19, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) * 0.05).astype(np.float32)
    jx = jquant.quantize(jnp.asarray(x), act_fmt)
    jw = jquant.quantize(jnp.asarray(w), "e4m3", axis=-1)
    want = jops.matmul_q(jx, jw, impl=impl, compute_dtype=jnp.float32,
                         interpret=True)
    qx = quant.quantize(torch.from_numpy(x), act_fmt)
    qw = quant.quantize(torch.from_numpy(w), "e4m3", axis=-1)
    got = ops.matmul_q(qx, qw, impl=impl, compute_dtype=torch.float32)
    absx = quant.QTensor(qx.codes & 0x7F, qx.scale, qx.fmt)
    absw = quant.QTensor(qw.codes & 0x7F, qw.scale, qw.fmt)
    absum = ops.matmul_q(absx, absw, impl=impl,
                         compute_dtype=torch.float32).numpy()
    # the scale multiply adds one rounding on top of the sum's
    bound = 2 * 40 * 2.0 ** -24 * absum + 2.0 ** -23 * np.abs(np.asarray(want))
    assert (np.abs(got.numpy() - np.asarray(want)) <= bound).all()


def test_auto_impl_resolution():
    for w_fmt in ("e4m3", "e5m2"):
        assert autotune.choose_matmul_impl("cpu") == \
            jautotune.choose_matmul_impl(8, 16, 32, fmt="e5m2",
                                         w_fmt=w_fmt) == "xla"
    assert autotune.choose_matmul_impl("cuda") == "fused_dequant"
    assert autotune.choose_matmul_impl(torch.device("cuda", 0)) == \
        "fused_dequant"
    # on the CPU, auto is the plain decode path (no kernel counter moves)
    q = quant.quantize(torch.ones((4, 8)), "e4m3")
    w = quant.quantize(torch.ones((8, 2)), "e4m3", axis=-1)
    counts = (lm.lns_product_matmul.launches, lm.dequant_matmul.launches)
    torch.testing.assert_close(ops.matmul_q(q, w, impl="auto"),
                               torch.full((4, 2), 8.0))
    assert counts == (lm.lns_product_matmul.launches,
                      lm.dequant_matmul.launches)


def test_lns_matmul_refuses_what_it_does_not_take():
    x = torch.zeros((2, 3), dtype=torch.uint8)
    w = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="single-format"):
        lm.lns_matmul(x, w, fmt="e5m2", w_fmt="e4m3", impl="lns_loop")
    with pytest.raises(ValueError, match="single-format"):
        lm.lns_matmul(x, w, fmt="e5m2", w_fmt="e4m3", impl="lns")
    with pytest.raises(ValueError, match="unknown impl"):
        lm.lns_matmul(x, w, impl="mxu")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        lm.lns_matmul(x.to("meta"), w.to("meta"), impl="lns")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        lm.lns_matmul(x.to("meta"), w.to("meta"), impl="lns_loop")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lm.lns_matmul(x, w, impl="fused_dequant", compute_dtype=torch.half)


def test_build_name_follows_included_headers(tmp_path, monkeypatch):
    """A header edit must change the library's name: the build is keyed
    by every csrc header a source includes, directly or through another
    header, not by the .cu file alone."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cuh").write_text('#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("// b\n")
    (csrc / "unused.cuh").write_text("// not included\n")
    (csrc / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    names = {p.name for p in cuda_build._sources("k")}
    assert names == {"k.cu", "a.cuh", "b.cuh"}
    first = cuda_build._target("k")
    (csrc / "unused.cuh").write_text("// edited\n")
    assert cuda_build._target("k") == first
    (csrc / "b.cuh").write_text("// b, edited\n")
    assert cuda_build._target("k") != first


def test_kernel_sources_share_the_lns_header():
    assert "lns_common.cuh" not in {p.name for p in
                                    cuda_build._sources("flash_attention")}
    for name in ("paged_attention", "lns_matmul"):
        assert "lns_common.cuh" in {p.name for p in
                                    cuda_build._sources(name)}
    with pytest.raises(cuda_build.KernelLaunchError, match="error 9"):
        cuda_build.check_launch(9, "K3")
    cuda_build.check_launch(0, "K3")


def test_tensor_core_kernels_share_the_mma_header():
    """K2 and K6 both build from mma_bf16.cuh, so an edit of it rebuilds
    both libraries; the other sources do not include it."""
    for name in ("flash_attention", "lns_matmul"):
        assert "mma_bf16.cuh" in {p.name for p in cuda_build._sources(name)}
    for name in ("paged_attention", "fp8_elementwise"):
        assert "mma_bf16.cuh" not in {p.name for p in
                                      cuda_build._sources(name)}


@pytest.mark.parametrize("M,N,n_sm,tile", [
    (1024, 4864, 132, 128),   # 8 x 38 = 304 tiles of 128: fills the card
    (1024, 896, 132, 64),     # 56 tiles of 128 would leave SMs idle
    (1024, 128, 132, 64),
    (4096, 4096, 132, 128),
    (1, 1, 132, 64),
    (1024, 896, 56, 128),     # a card of 56 SMs is filled at 128
])
def test_dequant_tile_rule(M, N, n_sm, tile):
    assert lm.dequant_tile(M, N, n_sm) == tile
