"""PyTorch port: kernels K1 to K6 on the card (CUDA) against their plain
versions.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` on first use); they carry the ``cuda``
marker and skip on a host without CUDA.  They import no JAX, so they run
on the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernel_cuda.py

Tolerance of the attention output: rtol = atol = 1e-4 — the kernel and
the plain version sum the exact LNS products over hd, the page rows and
the pages in different float32 orders, and the card's ``expf`` is not
torch's ``exp``; the same for K1's float instance (bf16 and float32
pages), whose q.k products are float32 FMAs on the card.  Cache updates
and fused == unfused are bitwise.  K3's
single products are bitwise (NaN as NaN: the card's float add returns its
own canonical NaN); K2's and K3's sums are held to the float32 summation
bound 2 K 2^-24 sum|products|, since they add the same exact products in
another order (K3 in every block tile and (format, mode) cell, NaN/inf
against zero NaN as in the plain version).  TF32 is off for the plain versions' float32 products.
K5's codes are integer results and compare bitwise in every cell, at
every length to 64 and at every storage offset to 15.  K4 sums in the
reference's order and is bitwise equal to its plain version (NaN as NaN),
also where it splits the k tiles among blocks, and two calls agree bit
for bit.  K6 is held to rtol = atol = 1e-4 in float32 (the plain
version's float32 products and sums run in another order, and the card's
``expf`` is not torch's ``exp``), and to one bf16 ulp in bfloat16, or to
1e-5 where an output lies so close to 0 that a bf16 ulp is finer than
the float32 gap of the two summation orders (under 5e-7 in float32).
"""
import itertools

import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.carry_ins import CARRY_INS, FACTORED_MUL, Unsupported
from repro_torch.core.quant import encode
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fp8_elementwise as fe
from repro_torch.kernels import lns_matmul as lm
from repro_torch.kernels import paged_attention as pa
from repro_torch.serving.page_pool import kv_noise, write_token_page

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(seed, dev, *, G, hd, page, fmt, maxp=4):
    g = torch.Generator().manual_seed(seed)
    B, KV = 3, 2
    P = B * maxp + 1
    bt = (torch.randperm(P - 1, generator=g) + 1).reshape(B, maxp)
    lengths = torch.randint(0, maxp * page, (B,), generator=g)
    lengths[0] = page  # a fresh-page write
    mask = torch.tensor([True, False, True])
    keys = prng.fold_in(prng.split(prng.prng_key(seed), 2)[:, None, :],
                        lengths[None, :])
    noise = kv_noise(keys, (KV, hd), fmt)
    c = dict(q=torch.randn((B, 1, KV * G, hd), generator=g),
             k_new=torch.randn((B, KV, hd), generator=g) * 3,
             v_new=torch.randn((B, KV, hd), generator=g) * 3,
             kp=encode(torch.randn((P, page, KV, hd), generator=g), fmt),
             vp=encode(torch.randn((P, page, KV, hd), generator=g), fmt),
             ks=(2.0 ** torch.randint(-2, 3, (P,), generator=g)).float(),
             vs=(2.0 ** torch.randint(-2, 3, (P,), generator=g)).float(),
             bt=bt.to(torch.int32), lengths=lengths.to(torch.int32),
             mask=mask, k_noise=noise[0], v_noise=noise[1])
    c = {k: v.to(dev) for k, v in c.items()}
    c.update(KV=KV, page=page, fmt=fmt, maxp=maxp)
    return c


def _fused(c, impl, window=0, cap=0.0):
    kp, vp, ks, vs = (c[n].clone() for n in ("kp", "vp", "ks", "vs"))
    return pa.fused_decode_write_attend(
        c["q"], c["k_new"], c["v_new"], kp, vp, ks, vs, c["bt"],
        c["lengths"], fmt=c["fmt"], n_kv_heads=c["KV"],
        k_noise=c["k_noise"], v_noise=c["v_noise"], write_mask=c["mask"],
        window=window, cap=cap, impl=impl)


GEOS = [dict(G=7, hd=64, page=16, fmt="e5m2"),
        dict(G=2, hd=8, page=4, fmt="e4m3"),
        dict(G=1, hd=128, page=8, fmt="e5m2")]


@pytest.mark.parametrize("geo", GEOS, ids=lambda g: "-".join(map(str, g.values())))
@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 25.0)])
def test_k1_matches_plain(dev, geo, window, cap):
    c = _case(1, dev, **geo)
    before = pa.paged_attend.launches
    kern = _fused(c, "auto", window, cap)
    plain = _fused(c, "ref", window, cap)
    torch.cuda.synchronize()
    assert pa.paged_attend.launches == before + 1
    for i in (1, 2, 3, 4):
        assert torch.equal(kern[i][1:], plain[i][1:])
    act = c["mask"]
    assert torch.isfinite(kern[0][act]).all()
    torch.testing.assert_close(kern[0][act], plain[0][act], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("geo", GEOS, ids=lambda g: "-".join(map(str, g.values())))
def test_k1_fused_equals_unfused(dev, geo):
    c = _case(2, dev, **geo)
    fused = _fused(c, "auto")
    kp, vp, ks, vs = (c[n].clone() for n in ("kp", "vp", "ks", "vs"))
    logical = torch.div(c["lengths"], c["page"], rounding_mode="floor")
    rows = c["lengths"] - logical * c["page"]
    pids = c["bt"].gather(1, logical[:, None].long())[:, 0]
    write_token_page(kp, ks, c["k_new"], pids, rows, fmt=c["fmt"],
                     noise=c["k_noise"], write_mask=c["mask"])
    write_token_page(vp, vs, c["v_new"], pids, rows, fmt=c["fmt"],
                     noise=c["v_noise"], write_mask=c["mask"])
    out = pa.paged_decode_attention(c["q"], kp, vp, ks, vs, c["bt"],
                                    c["lengths"] + 1, fmt=c["fmt"],
                                    n_kv_heads=c["KV"])
    act = c["mask"]
    assert torch.equal(fused[0][act], out[act])
    for got, want in zip(fused[1:], (kp, ks, vp, vs)):
        assert torch.equal(got[1:], want[1:])


def test_k1_rejects_operands_it_does_not_take(dev):
    c = _case(3, dev, **GEOS[0])
    codes, qs = pa.quantize_q(c["q"][:, 0], "e5m2")
    with pytest.raises(ValueError, match="block_tables"):
        pa.paged_attend(codes, qs, c["kp"], c["vp"], c["ks"], c["vs"],
                        c["bt"].long(), c["lengths"], fmt="e5m2",
                        mode="rne", KV=2, G=7)


def _float_case(seed, dev, *, G, hd, page, pdt, maxp=4):
    """``_case`` with float pages of ``pdt`` and new rows in that dtype
    (as the model writes them); the query stays float32."""
    c = _case(seed, dev, G=G, hd=hd, page=page, fmt="e5m2", maxp=maxp)
    g = torch.Generator().manual_seed(seed + 7)
    for name in ("kp", "vp"):
        c[name] = torch.randn(c[name].shape, generator=g).to(dev, pdt)
    for name in ("k_new", "v_new"):
        c[name] = c[name].to(pdt)
    c.update(fmt=None, k_noise=None, v_noise=None)
    return c


PAGE_DTYPES = [torch.bfloat16, torch.float32]
FLOAT_GEOS = [{k: v for k, v in g.items() if k != "fmt"} for g in GEOS]


@pytest.mark.parametrize("pdt", PAGE_DTYPES, ids=str)
@pytest.mark.parametrize("geo", FLOAT_GEOS,
                         ids=lambda g: "-".join(map(str, g.values())))
@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 25.0)])
def test_k1_float_matches_plain(dev, geo, window, cap, pdt):
    c = _float_case(4, dev, **geo, pdt=pdt)
    before = (pa.paged_attend.launches, pa.paged_attend.float_launches)
    kern = _fused(c, "auto", window, cap)
    plain = _fused(c, "ref", window, cap)
    torch.cuda.synchronize()
    assert (pa.paged_attend.launches,
            pa.paged_attend.float_launches) == (before[0], before[1] + 1)
    for i in (1, 3):
        assert kern[i].dtype == pdt
        assert torch.equal(kern[i][1:], plain[i][1:])
    for i, name in ((2, "ks"), (4, "vs")):
        assert torch.equal(kern[i], c[name])   # float pages keep scales
    act = c["mask"]
    assert torch.isfinite(kern[0][act]).all()
    torch.testing.assert_close(kern[0][act], plain[0][act], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("pdt", PAGE_DTYPES, ids=str)
@pytest.mark.parametrize("geo", FLOAT_GEOS,
                         ids=lambda g: "-".join(map(str, g.values())))
def test_k1_float_fused_equals_unfused(dev, geo, pdt):
    c = _float_case(5, dev, **geo, pdt=pdt)
    fused = _fused(c, "auto", 5, 30.0)
    kp, vp, ks, vs = (c[n].clone() for n in ("kp", "vp", "ks", "vs"))
    logical = torch.div(c["lengths"], c["page"], rounding_mode="floor")
    rows = c["lengths"] - logical * c["page"]
    pids = c["bt"].gather(1, logical[:, None].long())[:, 0]
    write_token_page(kp, ks, c["k_new"], pids, rows, fmt=None,
                     write_mask=c["mask"])
    write_token_page(vp, vs, c["v_new"], pids, rows, fmt=None,
                     write_mask=c["mask"])
    out = pa.paged_decode_attention(c["q"], kp, vp, ks, vs, c["bt"],
                                    c["lengths"] + 1, fmt=None,
                                    n_kv_heads=c["KV"], window=5, cap=30.0)
    act = c["mask"]
    assert torch.equal(fused[0][act], out[act])
    for got, want in zip(fused[1:], (kp, ks, vp, vs)):
        assert torch.equal(got[1:], want[1:])


def test_k1_float_rejects_operands_it_does_not_take(dev):
    c = _float_case(6, dev, G=7, hd=64, page=16, pdt=torch.bfloat16)
    q, _ = pa.query_operand(c["q"][:, 0], None)
    kw = dict(fmt=None, mode="rne", KV=2, G=7)
    before = pa.paged_attend.float_launches
    with pytest.raises(ValueError, match="bf16 or float32"):
        pa.paged_attend(q, None, c["kp"].half(), c["vp"].half(), c["ks"],
                        c["vs"], c["bt"], c["lengths"], **kw)
    with pytest.raises(ValueError, match="v_pages"):
        pa.paged_attend(q, None, c["kp"], c["vp"].float(), c["ks"],
                        c["vs"], c["bt"], c["lengths"], **kw)
    strided = c["kp"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attend(q, None, strided, c["vp"], c["ks"], c["vs"],
                        c["bt"], c["lengths"], **kw)
    with pytest.raises(ValueError, match="q"):
        pa.paged_attend(q.to(torch.bfloat16), None, c["kp"], c["vp"],
                        c["ks"], c["vs"], c["bt"], c["lengths"], **kw)
    assert pa.paged_attend.float_launches == before


# The one-launch design: each (slot, KV head) is a cluster of min(8, maxp)
# blocks sharing the admissible pages; these cases cover every cluster
# size, shares of unequal length and ranks with no page.
K1_KINDS = ["e5m2", torch.bfloat16, torch.float32]


def _k1_kind_case(seed, dev, kind, maxp, page=8):
    geo = dict(G=7, hd=64, page=page, maxp=maxp)
    if isinstance(kind, str):
        return _case(seed, dev, fmt=kind, **geo)
    return _float_case(seed, dev, pdt=kind, **geo)


def _attend(c, kp, vp, lengths, window=0, impl="auto"):
    return pa.paged_decode_attention(
        c["q"], kp, vp, c["ks"], c["vs"], c["bt"], lengths, fmt=c["fmt"],
        n_kv_heads=c["KV"], window=window, impl=impl)


@pytest.mark.parametrize("kind", K1_KINDS, ids=str)
@pytest.mark.parametrize("maxp", [1, 2, 7, 8, 9, 64])
def test_k1_every_cluster_size_matches_plain(dev, kind, maxp):
    """Lengths 0 (the mean of all V rows), 1, a random one and the whole
    table, without and with a window that skips leading pages: one launch
    a call within tolerance of the plain version, two calls bitwise
    equal."""
    c = _k1_kind_case(7, dev, kind, maxp)
    full = maxp * c["page"]
    g = torch.Generator().manual_seed(maxp)
    lengths = torch.tensor([0, 1, int(torch.randint(1, full + 1, (1,),
                                                    generator=g)), full],
                           dtype=torch.int32, device=dev)
    c["bt"] = torch.cat([c["bt"], c["bt"][:1]])   # slot 3 shares slot 0's
    c["q"] = torch.cat([c["q"], c["q"][:1]])
    count = "launches" if c["fmt"] else "float_launches"
    for window in (0, 2 * c["page"] + 3):
        before = getattr(pa.paged_attend, count)
        got = _attend(c, c["kp"], c["vp"], lengths, window)
        again = _attend(c, c["kp"], c["vp"], lengths, window)
        want = _attend(c, c["kp"], c["vp"], lengths, window, impl="ref")
        torch.cuda.synchronize()
        assert getattr(pa.paged_attend, count) == before + 2
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert torch.equal(got, again)


@pytest.mark.parametrize("kind", K1_KINDS, ids=str)
@pytest.mark.parametrize("window", [0, 11])
def test_k1_reads_only_the_admissible_pages(dev, kind, window):
    """Every page outside each slot's admissible range poisoned (NaN on
    float pages; random codes, NaN/inf codes among them, on FP8 pages):
    the output stays finite and bitwise equal to the clean pool's."""
    c = _k1_kind_case(8, dev, kind, maxp=9, page=4)
    lengths = torch.tensor([3, 17, 36], dtype=torch.int32, device=dev)
    kp, vp = c["kp"].clone(), c["vp"].clone()
    pids = []
    for b in range(3):
        first, last = pa.admissible_pages(int(lengths[b]), window, 4, 9)
        pids += [int(c["bt"][b, j]) for j in range(9)
                 if not first <= j <= last]
    assert pids
    g = torch.Generator().manual_seed(window)
    for t in (kp, vp):
        if c["fmt"] is None:
            t[pids] = float("nan")
        else:
            t[pids] = torch.randint(0, 256, t[pids].shape, generator=g,
                                    dtype=torch.uint8).to(dev)
    clean = _attend(c, c["kp"], c["vp"], lengths, window)
    dirty = _attend(c, kp, vp, lengths, window)
    torch.cuda.synchronize()
    assert torch.isfinite(dirty).all()
    assert torch.equal(clean, dirty)


def _nan_aware_equal(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))


@pytest.mark.parametrize("key", sorted(FACTORED_MUL), ids="-".join)
def test_k3_every_product_bitwise(dev, key):
    fmt, mode = key
    codes = torch.arange(256, dtype=torch.uint8, device=dev)
    before = lm.lns_product_matmul.launches
    got = lm.lns_product_matmul(codes[:, None].contiguous(),
                                codes[None, :].contiguous(), fmt=fmt,
                                mode=mode)
    torch.cuda.synchronize()
    assert lm.lns_product_matmul.launches == before + 1
    want = lm.lns_matmul_plain(codes[:, None], codes[None, :], fmt=fmt,
                               mode=mode)
    assert _nan_aware_equal(got, want)


def _codes(g, shape, fmt, dev):
    c = torch.randint(0, 256, shape, generator=g).to(torch.uint8)
    mag = c & 0x7F
    bad = mag >= (0x7C if fmt == "e5m2" else 0x7F)
    return torch.where(bad, c & 0xF0, c).to(dev)


SHAPES = [(1, 1, 1), (5, 7, 3), (64, 32, 64), (65, 33, 129), (130, 96, 200),
          (1024, 896, 128)]


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("fmt,mode", [("e4m3", "rne"), ("e5m2", "rz")])
def test_k3_matches_plain(dev, M, K, N, fmt, mode):
    g = torch.Generator().manual_seed(M + K + N)
    x, w = _codes(g, (M, K), fmt, dev), _codes(g, (K, N), fmt, dev)
    got = lm.lns_matmul(x, w, fmt=fmt, mode=mode, impl="lns")
    want = lm.lns_matmul_plain(x, w, fmt=fmt, mode=mode)
    absum = lm.lns_matmul_plain(x & 0x7F, w & 0x7F, fmt=fmt, mode=mode)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and torch.isfinite(got).all()
    assert bool(((got - want).abs() <= 2 * K * 2.0**-24 * absum).all())


@pytest.mark.parametrize("tile", lm.LNS_TILES)
@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("key", sorted(FACTORED_MUL), ids="-".join)
def test_k3_every_tile_matches_plain(dev, key, M, K, N, tile):
    """K3's one-hot plane GEMM in each block tile the rule can pick, in
    every (format, mode) cell (4 or 8 planes, with or without the sign
    in the class), one launch per call."""
    fmt, mode = key
    g = torch.Generator().manual_seed(M + K + N + len(mode))
    x, w = _codes(g, (M, K), fmt, dev), _codes(g, (K, N), fmt, dev)
    before = lm.lns_product_matmul.launches
    got = lm.lns_product_matmul(x, w, fmt=fmt, mode=mode, tile=tile)
    assert lm.lns_product_matmul.launches == before + 1
    want = lm.lns_matmul_plain(x, w, fmt=fmt, mode=mode)
    absum = lm.lns_matmul_plain(x & 0x7F, w & 0x7F, fmt=fmt, mode=mode)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and torch.isfinite(got).all()
    assert bool(((got - want).abs() <= 2 * K * 2.0**-24 * absum).all())


@pytest.mark.parametrize("key", sorted(FACTORED_MUL), ids="-".join)
def test_k3_nan_and_inf_against_zero(dev, key):
    """A NaN/inf code times a zero or subnormal code is NaN, on either
    side, and NaN spreads over its row or column; every other output
    equals the plain version's."""
    fmt, mode = key
    bad = [0x7C, 0x7D, 0xFC, 0xFF] if fmt == "e5m2" else [0x7F, 0xFF]
    zero = [0x00, 0x80, 0x01, 0x83]
    g = torch.Generator().manual_seed(len(bad) + len(mode))
    M, K, N = 40, 70, 36
    x, w = _codes(g, (M, K), fmt, "cpu"), _codes(g, (K, N), fmt, "cpu")
    x[:, 5] = torch.tensor(zero * (M // 4), dtype=torch.uint8)
    w[5, :] = torch.tensor(zero * (N // 4), dtype=torch.uint8)
    for i, c in enumerate(bad):
        x[i, 5] = c                    # NaN/inf x times a zero y ...
        w[5, N - 1 - i] = c            # ... and a zero x times NaN/inf y
    x, w = x.to(dev), w.to(dev)
    got = lm.lns_product_matmul(x, w, fmt=fmt, mode=mode)
    want = lm.lns_matmul_plain(x, w, fmt=fmt, mode=mode)
    absum = lm.lns_matmul_plain(x & 0x7F, w & 0x7F, fmt=fmt, mode=mode)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert nan[:len(bad)].all() and nan[:, N - len(bad):].all()
    assert torch.equal(torch.isnan(got), nan)
    assert bool(((got - want).abs()[~nan]
                 <= (2 * K * 2.0**-24 * absum)[~nan]).all())


def test_k3_refuses_a_tile_it_has_not(dev):
    x = torch.zeros((4, 8), dtype=torch.uint8, device=dev)
    before = lm.lns_product_matmul.launches
    with pytest.raises(ValueError, match="tile"):
        lm.lns_product_matmul(x, x.t().contiguous(), fmt="e4m3", tile=16)
    assert lm.lns_product_matmul.launches == before


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_k2_matches_plain(dev, M, K, N, cd):
    g = torch.Generator().manual_seed(M * N + K)
    x, w = _codes(g, (M, K), "e5m2", dev), _codes(g, (K, N), "e4m3", dev)
    kw = dict(fmt="e5m2", w_fmt="e4m3", compute_dtype=cd)
    before = lm.dequant_matmul.launches
    got = lm.lns_matmul(x, w, impl="fused_dequant", **kw)
    assert lm.dequant_matmul.launches == before + 1
    want = lm.dequant_matmul_plain(x, w, **kw)
    absum = lm.dequant_matmul_plain(x & 0x7F, w & 0x7F, **kw)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 2 * K * 2.0**-24 * absum).all())


# ragged M, N and K in every combination the tiles meet (a partial tile,
# a partial 16-code chunk, K or N not a multiple of 16: element loads) and
# N = 128, the narrow outputs of the training path, at both block tiles
K2_RAGGED = [(1, 1000, 17), (17, 130, 1), (130, 17, 1000), (1000, 1000, 130),
             (17, 1, 128), (1, 17, 128), (1024, 896, 128), (1024, 4864, 128),
             (1000, 130, 4864), (1024, 896, 4864)]


@pytest.mark.parametrize("M,K,N", K2_RAGGED)
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_k2_ragged_and_narrow_match_plain(dev, M, K, N, cd):
    g = torch.Generator().manual_seed(M + 3 * K + 7 * N)
    x, w = _codes(g, (M, K), "e5m2", dev), _codes(g, (K, N), "e4m3", dev)
    kw = dict(fmt="e5m2", w_fmt="e4m3", compute_dtype=cd)
    got = lm.dequant_matmul(x, w, **kw)
    want = lm.dequant_matmul_plain(x, w, **kw)
    absum = lm.dequant_matmul_plain(x & 0x7F, w & 0x7F, **kw)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and torch.isfinite(got).all()
    assert bool(((got - want).abs() <= 2 * K * 2.0**-24 * absum).all())


def test_k2_decodes_special_codes_to_zero(dev):
    x = torch.tensor([[0x01, 0x7F, 0x7C, 0xFD, 0x3C]], dtype=torch.uint8,
                     device=dev)
    w = torch.full((5, 1), 0x38, dtype=torch.uint8, device=dev)  # 1.0
    got = lm.dequant_matmul(x, w, fmt="e5m2", w_fmt="e4m3")
    assert float(got) == 1.0  # only 0x3C (1.0 in e5m2) counts


def test_matmul_kernels_reject_operands_they_do_not_take(dev):
    x = torch.zeros((4, 8), dtype=torch.uint8, device=dev)
    w = torch.zeros((8, 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        lm.lns_product_matmul(x.t(), x.t(), fmt="e4m3")
    with pytest.raises(ValueError, match="uint8"):
        lm.dequant_matmul(x.float(), w, fmt="e5m2", w_fmt="e4m3")
    with pytest.raises(ValueError, match="contraction"):
        lm.lns_product_matmul(x, x, fmt="e4m3")


# --------------------------------------------------------------------------- #
# K5: the paper's six operations elementwise
# --------------------------------------------------------------------------- #
K5_CELLS = [(f, op, m) for (f, op), modes in sorted(CARRY_INS.items())
            for m, spec in modes.items() if spec is not None]


def _k5_operands(op, dev):
    codes = torch.arange(256, dtype=torch.uint8, device=dev)
    if op in fe.BINARY_OPS:
        X, Y = torch.meshgrid(codes, codes, indexing="ij")
        return X.reshape(-1).contiguous(), Y.reshape(-1).contiguous()
    return codes, None


@pytest.mark.parametrize("fmt,op,mode", K5_CELLS, ids="-".join)
def test_k5_every_cell_bitwise(dev, fmt, op, mode):
    x, y = _k5_operands(op, dev)
    before = fe.fp8_elementwise.launches
    got = fe.fp8_elementwise(op, x, y, fmt=fmt, mode=mode)
    want = fe.fp8_elementwise_plain(op, x, y, fmt=fmt, mode=mode)
    torch.cuda.synchronize()
    assert fe.fp8_elementwise.launches == before + 1
    assert got.dtype == torch.uint8 and torch.equal(got, want)


@pytest.mark.parametrize("n,off", list(itertools.product(
    [1, 15, 16, 17, 1000, 4099, 38912], [0, 1, 3])))
@pytest.mark.parametrize("op", ["mul", "rsqrt"])
def test_k5_ragged_and_misaligned(dev, n, off, op):
    g = torch.Generator(device="cpu").manual_seed(n + off)
    buf = torch.randint(0, 256, (2, n + 32), generator=g,
                        dtype=torch.uint8).to(dev)
    x = buf[0, off:off + n]                    # storage offset off
    y = buf[1, 5:5 + n] if op in fe.BINARY_OPS else None
    got = fe.fp8_elementwise(op, x, y, fmt="e5m2", mode="rne")
    want = fe.fp8_elementwise_plain(op, x, y, fmt="e5m2", mode="rne")
    assert torch.equal(got, want)
    # a non-contiguous operand of a 2-D shape
    t = buf[:, :2 * (n // 2 + 1)].reshape(2, -1, 2).transpose(0, 1)
    got = fe.fp8_elementwise("square", t, fmt="e4m3", mode="rd")
    assert got.shape == t.shape
    assert torch.equal(got, fe.fp8_elementwise_plain("square", t,
                                                     fmt="e4m3", mode="rd"))


K5_SERVE_N = 8 * 4864       # one decode sub-step's gate product


@pytest.mark.parametrize("off", range(16))
@pytest.mark.parametrize("op", ["mul", "div", "rsqrt"])
def test_k5_every_length_and_offset(dev, off, op):
    """n = 1..64, 4,099 and the serving shape, at storage offset ``off``
    of both operands (y at another offset than x when off > 0), bitwise
    equal to the plain version: the vector loop, the scalar tail and the
    all-scalar path of a misaligned view."""
    g = torch.Generator(device="cpu").manual_seed(100 + off)
    buf = torch.randint(0, 256, (2, K5_SERVE_N + 64), generator=g,
                        dtype=torch.uint8).to(dev)
    for n in [*range(1, 65), 4099, K5_SERVE_N]:
        x = buf[0, off:off + n]
        y = buf[1, (3 * off) % 16:(3 * off) % 16 + n] \
            if op in fe.BINARY_OPS else None
        got = fe.fp8_elementwise(op, x, y, fmt="e5m2", mode="rne")
        want = fe.fp8_elementwise_plain(op, x, y, fmt="e5m2", mode="rne")
        assert torch.equal(got, want), n


def test_k5_refusals_launch_nothing(dev):
    x = torch.zeros(64, dtype=torch.uint8, device=dev)
    before = fe.fp8_elementwise.launches
    with pytest.raises(Unsupported):
        fe.fp8_elementwise("div", x, x, fmt="e4m3", mode="ru")
    with pytest.raises(ValueError, match="rbits"):
        fe.fp8_elementwise("mul", x, x, fmt="e5m2", mode="stochastic")
    with pytest.raises(ValueError, match="uint8"):
        fe.fp8_elementwise("mul", x.float(), x)
    with pytest.raises(ValueError, match="shapes differ"):
        fe.fp8_elementwise("mul", x, x[:8])
    with pytest.raises(ValueError, match="one device"):
        fe.fp8_elementwise("mul", x, x.cpu())
    assert fe.fp8_elementwise.launches == before
    assert fe.fp8_elementwise("mul", x[:0], x[:0]).numel() == 0


# --------------------------------------------------------------------------- #
# K4: the seed LNS matmul, bitwise
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key", sorted(FACTORED_MUL), ids="-".join)
@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (5, 7, 3), (37, 300, 45),
                                   (65, 257, 129), (16, 896, 17)])
def test_k4_bitwise_equal_to_plain(dev, key, M, K, N):
    fmt, mode = key
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randint(0, 256, (M, K), generator=g, dtype=torch.uint8)
    w = torch.randint(0, 256, (K, N), generator=g, dtype=torch.uint8)
    x[0, 0] = 0                       # a zero operand
    x[-1, -1] = 0x7F                  # NaN in both formats
    x, w = x.to(dev), w.to(dev)
    before = lm.lns_loop_matmul.launches
    got = lm.lns_matmul(x, w, fmt=fmt, mode=mode, impl="lns_loop")
    want = lm.lns_loop_matmul_plain(x, w, fmt=fmt, mode=mode)
    torch.cuda.synchronize()
    assert lm.lns_loop_matmul.launches == before + 1
    assert _nan_aware_equal(got, want)


@pytest.mark.parametrize("M,K,N", [(1024, 4864, 128), (3, 1000, 5),
                                   (1024, 896, 128), (130, 512, 66)])
def test_k4_split_over_k_tiles_bitwise(dev, M, K, N):
    """Shapes whose k tiles the wrapper splits among blocks (a second
    launch adds their sums in tile order): bitwise equal to the plain
    version (NaN as NaN), and two calls bitwise equal."""
    splits, _ = lm.loop_split(M, N, K, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert splits > 1 or (M, K, N) == (130, 512, 66)
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randint(0, 256, (M, K), generator=g, dtype=torch.uint8)
    w = torch.randint(0, 256, (K, N), generator=g, dtype=torch.uint8)
    x[(x & 0x7F) == 0x7F] = 0x30      # NaN only where planted
    w[(w & 0x7F) == 0x7F] = 0x30
    x[0, 0], x[-1, -1] = 0, 0x7F
    x, w = x.to(dev), w.to(dev)
    got = lm.lns_loop_matmul(x, w, fmt="e4m3", mode="rne")
    again = lm.lns_loop_matmul(x, w, fmt="e4m3", mode="rne")
    want = lm.lns_loop_matmul_plain(x, w, fmt="e4m3", mode="rne")
    torch.cuda.synchronize()
    assert _nan_aware_equal(got, want)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_k4_refuses_what_it_does_not_take(dev):
    x = torch.zeros((4, 8), dtype=torch.uint8, device=dev)
    before = lm.lns_loop_matmul.launches
    with pytest.raises(ValueError, match="contiguous"):
        lm.lns_loop_matmul(x.t(), x.t(), fmt="e4m3")
    with pytest.raises(ValueError, match="single-format"):
        lm.lns_matmul(x, x.t().contiguous(), fmt="e5m2", w_fmt="e4m3",
                      impl="lns_loop")
    assert lm.lns_loop_matmul.launches == before


# --------------------------------------------------------------------------- #
# K6: flash attention
# --------------------------------------------------------------------------- #
def _bf16_ulps(a, b):
    """Distance in bf16 ulps between two bfloat16 tensors (+0 == -0)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i & 0x7FFF))
    return (ordered(a) - ordered(b)).abs()


K6_CASES = [
    # (B, Sq, Sk, H, KV, hd, dv, causal, window, cap)
    (1, 128, 128, 4, 4, 32, 32, True, 0, 0.0),
    (2, 64, 64, 4, 2, 16, 16, True, 0, 0.0),       # GQA
    (1, 128, 128, 2, 1, 64, 64, True, 32, 0.0),    # sliding window
    (1, 64, 64, 2, 2, 32, 32, True, 0, 30.0),      # softcap
    (2, 96, 96, 4, 2, 32, 32, True, 0, 0.0),       # ragged: pad path
    (1, 64, 128, 2, 2, 32, 32, False, 0, 0.0),     # cross attention
    (1, 64, 64, 4, 2, 48, 32, True, 0, 0.0),       # dv != hd
    (2, 37, 45, 4, 2, 32, 32, True, 0, 0.0),       # Sq, Sk not multiples of 8
    (1, 96, 30, 2, 1, 16, 16, False, 16, 0.0),     # rows without a key
    (1, 300, 300, 2, 1, 192, 128, True, 0, 0.0),   # MLA widths
    (1, 300, 300, 2, 2, 256, 256, True, 100, 0.0),  # hd = 256
]


def _k6_inputs(case, dtype, dev, seed=0):
    B, Sq, Sk, H, KV, hd, dv = case[:7]
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).to(dev)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, dv))]


def _k6_check(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    if got.dtype == torch.bfloat16:
        near = (got.float() - want.float()).abs() <= 1e-5
        assert bool(((_bf16_ulps(got, want) <= 1) | near).all())
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K6_CASES, ids=[str(i) for i in
                                                range(len(K6_CASES))])
@pytest.mark.parametrize("blocks", [(32, 32), (64, 256), (256, 64)])
def test_k6_matches_plain(dev, case, dtype, blocks):
    causal, window, cap = case[7:]
    q, k, v = _k6_inputs(case, dtype, dev)
    bq, bk = fa.clamp_blocks(q.shape[1], k.shape[1], *blocks)
    kw = dict(causal=causal, window=window, cap=cap)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, bq=blocks[0], bk=blocks[1], **kw)
    want = fa.flash_attention_plain(q, k, v, bq=bq, bk=bk, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _k6_check(got, want)


def test_k6_rows_without_a_key_follow_the_padding(dev):
    """Non-causal, window 16, Sk = 30 padded to bk = 32: rows from 47 on
    see no admissible key and are sum(v) / 32, as in the reference."""
    q, k, v = _k6_inputs((1, 96, 30, 2, 1, 16, 16), torch.float32, dev)
    got = fa.flash_attention(q, k, v, causal=False, window=16, bq=32, bk=32)
    torch.testing.assert_close(got[0, 47:, 0],
                               (v[0, :, 0].sum(0) / 32).expand(49, 16),
                               rtol=1e-5, atol=1e-6)


def test_k6_every_autotuner_candidate(dev, tmp_path, monkeypatch):
    """Every (bq, bk) the autotuner may pick, at a shape that admits all
    nine; then the tuner itself measures, caches under the card's name
    and replays."""
    case = (1, 300, 300, 4, 2, 64, 64)
    q, k, v = _k6_inputs(case, torch.float32, dev)
    for bq in (64, 128, 256):
        for bk in (64, 128, 256):
            got = fa.flash_attention(q, k, v, bq=bq, bk=bk)
            want = fa.flash_attention_plain(q, k, v, causal=True, bq=bq,
                                            bk=bk)
            _k6_check(got, want)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.clear_memory_cache()
    try:
        first = fa.flash_attention(q, k, v)
        key = (f"flash|torch-cuda|{autotune._device_kind(dev)}|f32|"
               "300x300x64x64")
        blocks = tuple(autotune._load()[key])
        assert blocks in [(a, b) for a in (64, 128, 256)
                          for b in (64, 128, 256)]
        before = fa.flash_attention.launches
        second = fa.flash_attention(q, k, v)
        assert fa.flash_attention.launches == before + 1
        pinned = fa.flash_attention(q, k, v, bq=blocks[0], bk=blocks[1])
        assert torch.equal(first, second) and torch.equal(second, pinned)
    finally:
        autotune.clear_memory_cache()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [K6_CASES[i] for i in (0, 2, 7, 8, 10)],
                         ids=["0", "2", "7", "8", "10"])
@pytest.mark.parametrize("blocks", [(32, 8), (24, 24), (64, 24)])
def test_k6_small_key_tiles_match_plain(dev, case, dtype, blocks):
    """bk = 8 and 24: tiles narrower than a 16-key fragment, or ending
    inside one."""
    causal, window, cap = case[7:]
    q, k, v = _k6_inputs(case, dtype, dev, seed=3)
    bq, bk = fa.clamp_blocks(q.shape[1], k.shape[1], *blocks)
    kw = dict(causal=causal, window=window, cap=cap)
    got = fa.flash_attention(q, k, v, bq=blocks[0], bk=blocks[1], **kw)
    want = fa.flash_attention_plain(q, k, v, bq=bq, bk=bk, **kw)
    torch.cuda.synchronize()
    _k6_check(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_views_equal_the_contiguous_call(dev, dtype):
    """K6 reads q, k and v through their strides: views whose last
    dimension is contiguous (head-major, a slice of wider rows, a row
    stride that is no multiple of 8, a base off 16 bytes) give the
    contiguous call's output bit for bit; a strided last dimension raises
    before any launch."""
    case = (2, 100, 100, 4, 2, 64, 64)
    q, k, v = _k6_inputs(case, dtype, dev, seed=4)
    kw = dict(causal=True, window=0, cap=0.0, bq=64, bk=32)
    want = fa.flash_attention(q, k, v, **kw)
    q_heads = q.transpose(1, 2).contiguous().transpose(1, 2)
    k_wide = torch.zeros((2, 100, 2, 72), dtype=dtype, device=dev)
    k_wide[..., :64] = k
    v_odd = torch.zeros((2, 100, 2, 67), dtype=dtype, device=dev)
    v_odd[..., :64] = v
    q_off = torch.zeros(q.numel() + 1, dtype=dtype, device=dev)[1:]
    q_off = q_off.view(q.shape)
    q_off.copy_(q)
    for qq, kk, vv in ((q_heads, k, v), (q, k_wide[..., :64], v),
                       (q, k, v_odd[..., :64]), (q_off, k, v)):
        got = fa.flash_attention(qq, kk, vv, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    before = fa.flash_attention.launches
    v_t = v.transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="last dimension contiguous"):
        fa.flash_attention(q, k, v_t, **kw)
    assert fa.flash_attention.launches == before


def test_k6_refusals_launch_nothing(dev):
    q, k, v = _k6_inputs((1, 64, 64, 4, 2, 32, 32), torch.float32, dev)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half(), bq=32, bk=32)
    with pytest.raises(ValueError, match="bq in 8-256"):
        fa.flash_attention(q, k, v, bq=512, bk=32)
    with pytest.raises(ValueError, match="multiple of KV"):
        fa.flash_attention(q[:, :, :3], k, v, bq=32, bk=32)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention(q, k.cpu(), v, bq=32, bk=32)
    assert fa.flash_attention.launches == before
