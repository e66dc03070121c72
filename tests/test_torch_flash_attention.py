"""PyTorch port: flash attention (kernel K6's plain version and its
wrapper) against the JAX package's ``flash_attention(..., interpret=True)``.

Tolerance: rtol = atol = 2e-5 in float32, the reference's own against its
oracle (the same online softmax over the same key tiles; XLA and torch
sum the products in other orders).  bfloat16 outputs are held to one bf16
ulp, since both round a float32 result that differs in the last bits;
where an output is so close to 0 (a sum that cancels) that a bf16 ulp is
finer than the float32 tolerance, to that tolerance (2e-5) instead.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import autotune as jautotune
from repro.kernels import flash_attention as jfa
from repro_torch.kernels import autotune
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers

CASES = [
    # (B, Sq, Sk, H, KV, hd, causal, window, cap): tests/test_flash_attention.py
    (1, 128, 128, 4, 4, 32, True, 0, 0.0),
    (2, 64, 64, 4, 2, 16, True, 0, 0.0),       # GQA
    (1, 128, 128, 2, 1, 64, True, 32, 0.0),    # sliding window
    (1, 64, 64, 2, 2, 32, True, 0, 30.0),      # softcap (gemma)
    (2, 96, 96, 4, 2, 32, True, 0, 0.0),       # ragged: pad path
    (1, 64, 128, 2, 2, 32, False, 0, 0.0),     # cross attention (Sq != Sk)
]


def _inputs(B, Sq, Sk, H, KV, hd, dv=None, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, dv or hd)).astype(np.float32))


def _both(q, k, v, **kw):
    """(port, reference) outputs as numpy arrays."""
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True,
                               **kw)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_plain_matches_reference(case):
    B, Sq, Sk, H, KV, hd, causal, window, cap = case
    got, want = _both(*_inputs(B, Sq, Sk, H, KV, hd), causal=causal,
                      window=window, cap=cap, bq=32, bk=32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Sq,Sk,hd,dv,causal,window,cap", [
    (64, 64, 48, 32, True, 0, 0.0),      # dv != hd
    (40, 72, 24, 40, False, 0, 20.0),    # dv > hd, cross attention, softcap
    (37, 37, 32, 32, True, 0, 0.0),      # Sq not a multiple of 8
    (45, 29, 16, 16, True, 8, 0.0),      # neither length, window
])
def test_widths_and_ragged_lengths_match_reference(Sq, Sk, hd, dv, causal,
                                                   window, cap):
    got, want = _both(*_inputs(2, Sq, Sk, 4, 2, hd, dv, seed=Sq + Sk),
                      causal=causal, window=window, cap=cap, bq=32, bk=32)
    assert got.shape == (2, Sq, 4, dv)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bk", [32, 16])
def test_rows_without_an_admissible_key_follow_the_padding(bk):
    """Non-causal, window 16, Sk = 30: query rows from 47 on see no key.
    With the finite NEG_INF every entry of such a row weighs 1, so it is
    the sum of V over the 30 real keys divided by the padded key length
    (32 at either bk here), not 0 and not sum(V) / 30."""
    q, k, v = _inputs(1, 96, 30, 2, 1, 16, seed=3)
    got, want = _both(q, k, v, causal=False, window=16, bq=32, bk=bk)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    corner = v[0, :, 0].sum(0) / 32
    np.testing.assert_allclose(got[0, 47:, 0], np.broadcast_to(corner,
                                                               (49, 16)),
                               rtol=1e-5, atol=1e-6)
    assert np.abs(got[0, 90, 0] - v[0, :, 0].sum(0) / 30).max() > 1e-3


def _bf16_ulps(a, b):
    """Distance in bf16 ulps of two bf16 arrays given as int16 bit
    patterns (+0 == -0)."""
    def ordered(i):
        i = i.astype(np.int32)
        return np.where(i >= 0, i, -(i & 0x7FFF))
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("causal,cap", [(True, 0.0), (False, 30.0)])
def test_bf16_outputs_within_one_ulp(causal, cap):
    q, k, v = _inputs(1, 64, 64, 4, 2, 32, seed=2)
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, cap=cap, bq=32,
                               bk=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(t.astype(jnp.float32)))
                  .to(torch.bfloat16) for t in (jq, jk, jv))
    got = fa.flash_attention(tq, tk, tv, causal=causal, cap=cap, bq=32,
                             bk=32)
    assert got.dtype == torch.bfloat16
    ulps = _bf16_ulps(got.view(torch.int16).numpy(),
                      np.asarray(want).view(np.int16))
    diff = np.abs(got.float().numpy() - np.asarray(want).astype(np.float32))
    assert ((ulps <= 1) | (diff <= 2e-5)).all()
    assert (ulps <= 1).mean() > 0.99


def test_matches_the_ports_chunked_attention():
    """As tests/test_flash_attention.py holds the reference kernel against
    the models' chunked attention: rtol = atol = 2e-5."""
    q, k, v = _inputs(2, 128, 128, 4, 2, 32, seed=1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True, bq=32, bk=32)
    want = layers.chunked_attention(tq, tk, tv, causal=True, q_chunk=64,
                                    kv_chunk=64)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------- #
# The (bq, bk) defaults
# --------------------------------------------------------------------------- #
@pytest.fixture()
def no_measurement(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    autotune.clear_memory_cache()
    jautotune.clear_memory_cache()
    yield tmp_path / "at.json"
    autotune.clear_memory_cache()
    jautotune.clear_memory_cache()


SWEEP = [(Sq, Sk, hd, dv) for Sq in (1, 8, 30, 64, 96, 128, 200, 256, 1000)
         for Sk in (7, 16, 130, 512) for hd, dv in ((32, 32), (192, 128))]


def test_default_blocks_equal_the_reference(no_measurement):
    for Sq, Sk, hd, dv in SWEEP:
        assert autotune.flash_blocks(Sq, Sk, hd, dv, device="cpu") == \
            jautotune.flash_blocks(Sq, Sk, hd, dv, interpret=True)
    assert not no_measurement.exists()  # heuristics are not persisted


@pytest.mark.parametrize("Sq,Sk", [(30, 7), (64, 16), (96, 130), (37, 45),
                                   (8, 512)])
def test_wrapper_clamps_blocks_as_the_reference(no_measurement, monkeypatch,
                                                Sq, Sk):
    """The blocks the wrapper runs with, unpinned and pinned: the
    reference's default, then its clamp (flash_attention.py:114-115)."""
    seen, jseen = [], []
    real = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain", lambda *a, **k: (
        seen.append((k["bq"], k["bk"])) or real(*a, **k)))
    jreal = jfa._flash_attention
    monkeypatch.setattr(jfa, "_flash_attention", lambda *a, **k: (
        jseen.append((k["bq"], k["bk"])) or jreal(*a, **k)))
    q, k, v = _inputs(1, Sq, Sk, 2, 1, 16)
    for pinned in ({}, dict(bq=16, bk=256)):
        got, want = _both(q, k, v, causal=False, **pinned)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for (bq, bk), (jbq, jbk) in zip(seen, jseen):
        assert (bq, bk) == (min(jbq, Sq if Sq % 8 == 0 else jbq),
                            min(jbk, Sk if Sk % 8 == 0 else jbk))
    assert len(seen) == len(jseen) == 2


# --------------------------------------------------------------------------- #
# Dispatch
# --------------------------------------------------------------------------- #
def test_cpu_tensors_run_the_plain_version(monkeypatch):
    def no_kernel():
        raise AssertionError("the CPU path must not load the kernel")

    monkeypatch.setattr(fa, "_lib", no_kernel)
    q, k, v = map(torch.from_numpy, _inputs(1, 64, 64, 4, 2, 32))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, bq=32, bk=32)
    assert fa.flash_attention.launches == before
    torch.testing.assert_close(got, fa.flash_attention_plain(
        q, k, v, causal=True, bq=32, bk=32), rtol=0, atol=0)


def test_unsupported_inputs_raise_before_any_work(monkeypatch):
    def never(*a, **k):
        raise AssertionError("no fallback to the plain version")

    monkeypatch.setattr(fa, "flash_attention_plain", never)
    q, k, v = map(torch.from_numpy, _inputs(1, 64, 64, 4, 2, 32))
    cases = [
        ((q.half(), k.half(), v.half()), {}, "float32 or bfloat16"),
        ((q, k.to(torch.bfloat16), v), {}, "one dtype"),
        ((q.double(), k.double(), v.double()), {}, "float32 or bfloat16"),
        ((torch.zeros(1, 8, 2, 264), torch.zeros(1, 8, 2, 264),
          torch.zeros(1, 8, 2, 8)), {}, "up to 256"),
        ((q, k, torch.zeros(1, 64, 2, 300)), {}, "up to 256"),
        ((q, k, v), dict(bq=4, bk=32), "bq in 8-256"),
        ((q, k, v), dict(bq=32, bk=512), "bk in 8-256"),
        ((q[:, :, :3], k, v), dict(bq=32, bk=32), "multiple of KV"),
        ((q, k[:, :32], v), dict(bq=32, bk=32), "shapes differ"),
        ((q[0], k, v), dict(bq=32, bk=32), "4-D"),
        ((q[:, :0], k, v), {}, "at least one"),
        ((q, k[:, :0], v[:, :0]), dict(bq=32, bk=32), "at least one"),
        ((torch.zeros(4097, 8, 16, 8), torch.zeros(4097, 8, 1, 8),
          torch.zeros(4097, 8, 1, 8)), dict(bq=8, bk=8), "65535"),
        ((q.to("meta"), k.to("meta"), v.to("meta")), dict(bq=32, bk=32),
         "CUDA or CPU"),
        ((q.to("meta"), k.to("meta"), v.to("meta")), {}, "CUDA or CPU"),
    ]
    for args, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            fa.flash_attention(*args, **kw)


# --------------------------------------------------------------------------- #
# The tile skip
# --------------------------------------------------------------------------- #
def _admissible(Sq0, Sk0, nk, bk, causal, window):
    """[Sq0, nk * bk] mask of admissible (query, key) pairs, brute force."""
    qp = np.arange(Sq0)[:, None]
    kp = np.arange(nk * bk)[None, :]
    ok = kp < Sk0
    if causal:
        ok = ok & (qp >= kp)
    if window:
        ok = ok & (qp - kp < window)
    return np.broadcast_to(ok, (Sq0, nk * bk))


SKIP_LENGTHS = [(1, 1), (37, 45), (96, 30), (64, 128), (200, 64), (300, 300),
                (129, 257)]
SKIP_MASKS = [(True, 0), (True, 5), (True, 64), (False, 0), (False, 16),
              (False, 100)]


@pytest.mark.parametrize("bq", [8, 24, 32, 64, 128, 256])
@pytest.mark.parametrize("bk", [8, 24, 32, 64, 128, 256])
def test_key_tile_range_against_brute_force(bq, bk):
    """For every block of real query rows (the wrapper's bq blocks and the
    kernel's 64-row groups): the range is exactly the tiles holding an
    admissible pair, or every tile where a real row has none."""
    for Sq0, Sk0 in SKIP_LENGTHS:
        nk = -(-Sk0 // bk)
        for causal, window in SKIP_MASKS:
            ok = _admissible(Sq0, Sk0, nk, bk, causal, window)
            for rows in {bq, min(bq, 64)}:
                for q0 in range(0, -(-Sq0 // bq) * bq, rows):
                    got = fa.key_tile_range(q0, rows, Sq0, Sk0, bk, nk,
                                            causal, window)
                    block = ok[q0:q0 + rows]
                    if not len(block):
                        assert got == (0, 0)
                        continue
                    if not block.any(axis=1).all():
                        assert got == (0, nk), (Sq0, Sk0, causal, window, q0)
                        continue
                    tiles = np.flatnonzero(
                        block.reshape(len(block), nk, bk).any(axis=(0, 2)))
                    assert got == (tiles[0], tiles[-1] + 1), \
                        (Sq0, Sk0, causal, window, q0)


# (B, Sq, Sk, H, KV, hd, dv, causal, window, cap): the chip smoke's cases,
# then small-width copies of gemma2-27b's (window 4096 in 8192, cap 50)
# and gemma3-12b's (window 1024 in 4096) masks
K6_SMALL = [
    (1, 128, 128, 4, 4, 32, 32, True, 0, 0.0),
    (2, 64, 64, 4, 2, 16, 16, True, 0, 0.0),
    (1, 128, 128, 2, 1, 64, 64, True, 32, 0.0),
    (1, 64, 64, 2, 2, 32, 32, True, 0, 30.0),
    (2, 96, 96, 4, 2, 32, 32, True, 0, 0.0),
    (1, 64, 128, 2, 2, 32, 32, False, 0, 0.0),
    (2, 64, 64, 4, 2, 48, 32, True, 0, 0.0),
    (2, 37, 37, 4, 2, 32, 32, True, 0, 0.0),
    (1, 96, 30, 2, 1, 16, 16, False, 16, 0.0),
    (1, 256, 256, 4, 2, 16, 16, True, 128, 50.0),
    (1, 256, 256, 4, 2, 32, 32, True, 64, 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K6_SMALL,
                         ids=[str(i) for i in range(len(K6_SMALL))])
@pytest.mark.parametrize("blocks", [(32, 32), (64, 16)])
def test_plain_skip_is_bitwise_the_full_walk(case, dtype, blocks,
                                             monkeypatch):
    """The plain version with its skip equals, bit for bit, the same
    version with every key tile visited."""
    B, Sq, Sk, H, KV, hd, dv, causal, window, cap = case
    q, k, v = (torch.from_numpy(t).to(dtype) for t in
               _inputs(B, Sq, Sk, H, KV, hd, dv, seed=Sq + Sk + hd))
    bq, bk = fa.clamp_blocks(Sq, Sk, *blocks)
    kw = dict(causal=causal, window=window, cap=cap, bq=bq, bk=bk)
    got = fa.flash_attention_plain(q, k, v, **kw)
    nk = -(-Sk // bk)
    skipped = sum(nk - (last - first) for first, last in (
        fa.key_tile_range(i, bq, Sq, Sk, bk, nk, causal, window)
        for i in range(0, Sq, bq)))
    monkeypatch.setattr(fa, "key_tile_range", lambda *a: (0, a[5]))
    want = fa.flash_attention_plain(q, k, v, **kw)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))
    if causal and Sq == Sk and Sq > bq:
        assert skipped > 0    # the case really skips


def test_views_read_through_their_strides():
    """A view whose last dimension is contiguous is taken as it is (equal
    to the contiguous call); one whose last dimension is strided raises."""
    q, k, v = map(torch.from_numpy, _inputs(1, 64, 64, 4, 2, 32, seed=5))
    want = fa.flash_attention(q, k, v, bq=32, bk=32)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)   # [B, H, S, hd]
    kw = torch.zeros(1, 64, 2, 48)
    kw[..., :32] = k
    got = fa.flash_attention(qt, kw[..., :32], v, bq=32, bk=32)
    assert not qt.is_contiguous() and torch.equal(got, want)
    vt = v.transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="last dimension contiguous"):
        fa.flash_attention(q, k, vt, bq=32, bk=32)
