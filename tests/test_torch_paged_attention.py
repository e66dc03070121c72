"""PyTorch port: paged decode attention (K1's plain version and the fused
KV-write + attend) against the JAX package, on the CPU.

* Integer-domain results — the quantized query, the new token's row
  codes, the updated pages and page scales — are bitwise equal to JAX
  ``fused_decode_write_attend(impl="batch")``.
* The attention output is allclose: rtol = atol = 1e-5.  The port sums the
  hd products and the page rows in torch's order, XLA in its own; the
  products themselves are exact, so the outputs differ by a few float32
  ulps of values of order 1 (page scales are powers of two near the data).
* Fused == unfused is bitwise *within the port* over random geometries,
  including the qwen2-0.5b head grouping G=7 with hd=64.

The null page 0 is excluded from cache comparisons: masked lanes all
write into it, in an order the reference leaves unspecified.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import encode as jencode
from repro.kernels import paged_attention as jpa
from repro.serving import page_pool as jpool
from repro_torch.kernels import paged_attention as pa
from repro_torch.serving import page_pool

RTOL = ATOL = 1e-5


def _case(seed, *, fmt, G=None, hd=None, page=None):
    """Ownership-respecting random decode-step inputs (the reference's
    tests/test_paged_fuzz.py generator, extended with G and hd)."""
    rng = np.random.default_rng(seed)
    page = page or int(rng.choice([4, 8, 16]))
    maxp = int(rng.integers(2, 5))
    B = int(rng.integers(1, 5))
    KV = int(rng.choice([1, 2]))
    G = G or int(rng.choice([1, 2, 7]))
    hd = hd or int(rng.choice([4, 8, 64]))
    H = KV * G
    P = B * maxp + 1
    bt = rng.permutation(np.arange(1, P)).reshape(B, maxp).astype(np.int32)
    lengths = rng.integers(0, maxp * page, size=B).astype(np.int32)
    kf = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
    vf = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
    mask = rng.random(B) < 0.8
    if not mask.any():
        mask[0] = True
    return dict(
        q=rng.standard_normal((B, 1, H, hd)).astype(np.float32),
        k_new=(rng.standard_normal((B, KV, hd)) * 3).astype(np.float32),
        v_new=(rng.standard_normal((B, KV, hd)) * 3).astype(np.float32),
        kp=np.asarray(jencode(jnp.asarray(kf), fmt)),
        vp=np.asarray(jencode(jnp.asarray(vf), fmt)),
        ks=(2.0 ** rng.integers(-2, 3, size=P)).astype(np.float32),
        vs=(2.0 ** rng.integers(-2, 3, size=P)).astype(np.float32),
        bt=bt, lengths=lengths, mask=mask, KV=KV, page=page,
        window=int(rng.choice([0, 5])), cap=float(rng.choice([0.0, 25.0])),
    )


def _keys(case, seed):
    """Per-slot position-addressed keys (JAX) for K and V writes."""
    fold = jax.vmap(jax.random.fold_in, in_axes=(None, 0))
    stream = jax.random.PRNGKey(seed)
    ln = jnp.asarray(case["lengths"])
    return (fold(jax.random.fold_in(stream, 0), ln),
            fold(jax.random.fold_in(stream, 1), ln))


def _noise(key, case, fmt):
    """The port draws the same bits from the same keys with its twin."""
    if key is None:
        return None
    keys = torch.from_numpy(np.asarray(key).astype(np.int64))
    return page_pool.kv_noise(keys, case["k_new"].shape[1:], fmt)


def _t(case, **over):
    c = {k: (torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v)
         for k, v in case.items()}
    c.update(over)
    return c


def _port_fused(case, fmt, mode, kv_mode, kn, vn, impl="auto"):
    c = _t(case)
    return pa.fused_decode_write_attend(
        c["q"], c["k_new"], c["v_new"], c["kp"], c["vp"], c["ks"], c["vs"],
        c["bt"], c["lengths"], fmt=fmt, n_kv_heads=case["KV"], mode=mode,
        kv_mode=kv_mode, k_noise=kn, v_noise=vn, write_mask=c["mask"],
        window=case["window"], cap=case["cap"], impl=impl)


def _port_unfused(case, fmt, mode, kv_mode, kn, vn, impl="auto"):
    c = _t(case)
    logical = c["lengths"] // case["page"]
    rows = c["lengths"] - logical * case["page"]
    pids = c["bt"].gather(1, logical[:, None].long())[:, 0]
    page_pool.write_token_page(c["kp"], c["ks"], c["k_new"], pids, rows,
                               fmt=fmt, mode=kv_mode, noise=kn,
                               write_mask=c["mask"])
    page_pool.write_token_page(c["vp"], c["vs"], c["v_new"], pids, rows,
                               fmt=fmt, mode=kv_mode, noise=vn,
                               write_mask=c["mask"])
    out = pa.paged_decode_attention(
        c["q"], c["kp"], c["vp"], c["ks"], c["vs"], c["bt"],
        c["lengths"] + 1, fmt=fmt, n_kv_heads=case["KV"], mode=mode,
        window=case["window"], cap=case["cap"], impl=impl)
    return out, c["kp"], c["ks"], c["vp"], c["vs"]


def _jax_fused(case, fmt, mode, kv_mode, kk, vk):
    return jpa.fused_decode_write_attend(
        jnp.asarray(case["q"]), jnp.asarray(case["k_new"]),
        jnp.asarray(case["v_new"]), jnp.asarray(case["kp"]),
        jnp.asarray(case["vp"]), jnp.asarray(case["ks"]),
        jnp.asarray(case["vs"]), jnp.asarray(case["bt"]),
        jnp.asarray(case["lengths"]), fmt=fmt, n_kv_heads=case["KV"],
        mode=mode, kv_mode=kv_mode, k_key=kk, v_key=vk,
        write_mask=jnp.asarray(case["mask"]), window=case["window"],
        cap=case["cap"], impl="batch")


def _jax_unfused(case, fmt, mode, kv_mode, kk, vk):
    """write_token_page x2 -> paged_attention_ref (the reference's oracle
    composition, which does not share the batch impl's failing case)."""
    lengths = jnp.asarray(case["lengths"])
    logical = lengths // case["page"]
    rows = lengths - logical * case["page"]
    bt = jnp.asarray(case["bt"])
    pids = jnp.take_along_axis(bt, logical[:, None], axis=1)[:, 0]
    wm = jnp.asarray(case["mask"])
    kp, ks = jpool.write_token_page(
        jnp.asarray(case["kp"]), jnp.asarray(case["ks"]),
        jnp.asarray(case["k_new"]), pids, rows, fmt=fmt, mode=kv_mode,
        key=kk, write_mask=wm)
    vp, vs = jpool.write_token_page(
        jnp.asarray(case["vp"]), jnp.asarray(case["vs"]),
        jnp.asarray(case["v_new"]), pids, rows, fmt=fmt, mode=kv_mode,
        key=vk, write_mask=wm)
    out = jpa.paged_decode_attention(
        jnp.asarray(case["q"]), kp, vp, ks, vs, bt, lengths + 1, fmt=fmt,
        n_kv_heads=case["KV"], mode=mode, window=case["window"],
        cap=case["cap"], impl="ref")
    return out, kp, ks, vp, vs


def _assert_matches_jax(port, ref, mask):
    np.testing.assert_allclose(port[0].numpy()[mask],
                               np.asarray(ref[0])[mask], rtol=RTOL, atol=ATOL)
    for i, name in ((1, "kp"), (2, "ks"), (3, "vp"), (4, "vs")):
        np.testing.assert_array_equal(port[i].numpy()[1:],
                                      np.asarray(ref[i])[1:], err_msg=name)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_quantize_q_bitwise(fmt):
    q = np.random.default_rng(0).standard_normal((3, 14, 64)).astype(np.float32)
    q[1] *= 1e-3
    rc, rs = jpa.quantize_q(jnp.asarray(q), fmt)
    pc, ps = pa.quantize_q(torch.from_numpy(q), fmt)
    np.testing.assert_array_equal(np.asarray(rc), pc.numpy())
    np.testing.assert_array_equal(np.asarray(rs), ps.numpy())


@pytest.mark.parametrize("kv_mode", ["stochastic", "rne", "rz"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_token_row_codes_bitwise(fmt, kv_mode):
    case = _case(11, fmt=fmt, G=7, hd=64)
    kk, _ = _keys(case, 3) if kv_mode == "stochastic" else (None, None)
    pids = case["bt"][np.arange(len(case["lengths"])),
                      case["lengths"] // case["page"]]
    rows = case["lengths"] % case["page"]
    ref = jpool.token_row_codes(
        jnp.asarray(case["ks"]), jnp.asarray(case["k_new"]),
        jnp.asarray(pids), jnp.asarray(rows), fmt=fmt, mode=kv_mode, key=kk,
        write_mask=jnp.asarray(case["mask"]))
    port = page_pool.token_row_codes(
        torch.from_numpy(case["ks"]), torch.from_numpy(case["k_new"]),
        torch.from_numpy(pids), torch.from_numpy(rows), fmt=fmt,
        mode=kv_mode, noise=_noise(kk, case, fmt),
        write_mask=torch.from_numpy(case["mask"]))
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(r), p.numpy())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fused_matches_jax_batch(seed, fmt):
    """Pages and scales bitwise, output allclose, against the reference's
    fused launch (impl="batch") — stochastic, rne and rz writes."""
    kv_mode = ("stochastic", "rne", "rz")[seed % 3]
    mode = ("rne", "faithful")[seed % 2]
    case = _case(100 * seed + len(fmt), fmt=fmt)
    kk, vk = _keys(case, seed) if kv_mode == "stochastic" else (None, None)
    ref = _jax_fused(case, fmt, mode, kv_mode, kk, vk)
    port = _port_fused(case, fmt, mode, kv_mode, _noise(kk, case, fmt),
                       _noise(vk, case, fmt))
    _assert_matches_jax(port, ref, case["mask"])


@pytest.mark.parametrize("seed", range(8))
def test_fused_equals_unfused_within_port(seed):
    """The fused form (row spliced into the gathered old pages) equals
    write-then-attend bit for bit on active lanes, pages included; at
    qwen2-0.5b head geometry on even seeds."""
    fmt = ("e5m2", "e4m3")[seed % 2]
    geo = dict(G=7, hd=64, page=16) if seed % 2 == 0 else {}
    case = _case(1000 + seed, fmt=fmt, **geo)
    kk, vk = _keys(case, seed)
    kn, vn = _noise(kk, case, fmt), _noise(vk, case, fmt)
    mode = ("rne", "rz", "faithful")[seed % 3]
    for impl in ("auto", "ref"):
        fused = _port_fused(case, fmt, mode, "stochastic", kn, vn, impl=impl)
        unfused = _port_unfused(case, fmt, mode, "stochastic", kn, vn)
        act = case["mask"]
        np.testing.assert_array_equal(fused[0].numpy()[act],
                                      unfused[0].numpy()[act])
        for i in (1, 2, 3, 4):
            np.testing.assert_array_equal(fused[i].numpy()[1:],
                                          unfused[i].numpy()[1:])


def test_reference_failing_case_lengths_5_0():
    """The case the reference's own fused==unfused property test fails on
    (lengths=[5, 0], mask=[True, False] on its fixed geometry).  The
    port's fused form is held against the reference's *unfused*
    composition, and against the port's own unfused form bitwise."""
    case = _case(3, fmt="e4m3")
    B = case["lengths"].shape[0]
    maxlen = case["bt"].shape[1] * case["page"] - 1
    case["lengths"] = np.resize(np.asarray([5, 0]), B).astype(np.int32) % (maxlen + 1)
    case["mask"] = np.resize(np.asarray([True, False]), B)
    case["window"], case["cap"] = 0, 0.0
    ref = _jax_unfused(case, "e4m3", "rne", "rne", None, None)
    port = _port_fused(case, "e4m3", "rne", "rne", None, None)
    _assert_matches_jax(port, ref, case["mask"])
    unfused = _port_unfused(case, "e4m3", "rne", "rne", None, None)
    np.testing.assert_array_equal(port[0].numpy()[case["mask"]],
                                  unfused[0].numpy()[case["mask"]])


@pytest.mark.parametrize("seed", range(3))
def test_paged_decode_attention_matches_jax_ref(seed):
    case = _case(50 + seed, fmt="e5m2", G=7, hd=64, page=16)
    ln = case["lengths"] + 1
    ref = jpa.paged_decode_attention(
        jnp.asarray(case["q"]), jnp.asarray(case["kp"]),
        jnp.asarray(case["vp"]), jnp.asarray(case["ks"]),
        jnp.asarray(case["vs"]), jnp.asarray(case["bt"]), jnp.asarray(ln),
        fmt="e5m2", n_kv_heads=case["KV"], window=case["window"],
        cap=case["cap"], impl="ref")
    c = _t(case)
    for impl in ("auto", "ref"):
        port = pa.paged_decode_attention(
            c["q"], c["kp"], c["vp"], c["ks"], c["vs"], c["bt"],
            torch.from_numpy(ln), fmt="e5m2", n_kv_heads=case["KV"],
            window=case["window"], cap=case["cap"], impl=impl)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)


def test_fully_masked_page_partials_are_finite():
    """NEG_INF is finite: a page past the length yields m = -2e30 with
    finite l and o, and drops out of the combine with weight exactly 0."""
    case = _case(5, fmt="e5m2", G=7, hd=64, page=16)
    c = _t(case)
    codes, qs = pa.quantize_q(c["q"][:, 0], "e5m2")
    m, l, o = pa.page_partials_plain(
        codes, qs, c["kp"], c["vp"], c["ks"], c["vs"], c["bt"],
        torch.ones_like(c["lengths"]), fmt="e5m2", mode="rne",
        KV=case["KV"], G=7)
    assert torch.isfinite(l).all() and torch.isfinite(o).all()
    assert (m[:, 1:] == pa.NEG_INF).all()
    w = torch.exp(m - m.amax(1, keepdim=True))
    assert (w[:, 1:] == 0).all()


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    case = _case(6, fmt="e5m2", G=7, hd=64, page=16)
    c = _t(case)
    codes, qs = pa.quantize_q(c["q"][:, 0], "e5m2")
    args = (codes, qs, c["kp"], c["vp"], c["ks"], c["vs"], c["bt"],
            c["lengths"] + 1)
    before = pa.paged_partials.launches
    got = pa.paged_partials(*args, fmt="e5m2", mode="rne", KV=case["KV"], G=7)
    want = pa.page_partials_plain(*args, fmt="e5m2", mode="rne",
                                  KV=case["KV"], G=7)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert pa.paged_partials.launches == before


def test_float_pages_not_ported_yet():
    case = _case(7, fmt="e5m2")
    c = _t(case)
    with pytest.raises(NotImplementedError):
        pa.paged_decode_attention(
            c["q"], c["kp"], c["vp"], c["ks"], c["vs"], c["bt"],
            c["lengths"] + 1, fmt=None, n_kv_heads=case["KV"])
