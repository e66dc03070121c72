"""PyTorch port: kernels K1, K2, K3 and K5 on the card (CUDA) against
their plain versions.

These tests need an NVIDIA GPU with ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` on first use); they carry the ``cuda``
marker and skip on a host without CUDA.  They import no JAX, so they run
on the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernel_cuda.py

Tolerance of the attention output: rtol = atol = 1e-4 — the kernel and
the plain version sum the exact LNS products over hd, the page rows and
the pages in different float32 orders, and the card's ``expf`` is not
torch's ``exp``.  Cache updates and fused == unfused are bitwise.  K3's
single products are bitwise (NaN as NaN: the card's float add returns its
own canonical NaN); K2's and K3's sums are held to the float32 summation
bound 2 K 2^-24 sum|products|, since they add the same exact products in
another order.  TF32 is off for the plain versions' float32 products.
K5's codes are integer results and compare bitwise in every cell.
"""
import itertools

import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.carry_ins import CARRY_INS, FACTORED_MUL, Unsupported
from repro_torch.core.quant import encode
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


def _case(seed, dev, *, G, hd, page, fmt):
    g = torch.Generator().manual_seed(seed)
    B, KV, maxp = 3, 2, 4
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
    c.update(KV=KV, page=page, fmt=fmt)
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
    before = pa.paged_partials.launches
    kern = _fused(c, "auto", window, cap)
    plain = _fused(c, "ref", window, cap)
    torch.cuda.synchronize()
    assert pa.paged_partials.launches == before + 1
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
        pa.paged_partials(codes, qs, c["kp"], c["vp"], c["ks"], c["vs"],
                          c["bt"].long(), c["lengths"], fmt="e5m2",
                          mode="rne", KV=2, G=7)


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
