"""PyTorch port: kernel K1 on the card (CUDA) against its plain version.

These tests need an NVIDIA GPU with ``nvcc`` (the kernel is built from
``src/repro_torch/kernels/csrc`` on first use); they carry the ``cuda``
marker and skip on a host without CUDA.  They import no JAX, so they run
on the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernel_cuda.py

Tolerance of the attention output: rtol = atol = 1e-4 — the kernel and
the plain version sum the exact LNS products over hd, the page rows and
the pages in different float32 orders, and the card's ``expf`` is not
torch's ``exp``.  Cache updates and fused == unfused are bitwise.
"""
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.quant import encode
from repro_torch.kernels import paged_attention as pa
from repro_torch.serving.page_pool import kv_noise, write_token_page

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
