"""PyTorch port, kernel K5 and the slice that runs it: the paper's six FP8
operations elementwise, through ``elementwise_q``, ``numerics.elementwise``
and qwen2's SwiGLU gate, when serving and when training, against the JAX
package.

Tolerances: codes are integer-domain results and compare bitwise.  Scales
compare bitwise too, except those of ``sqrt`` and ``rsqrt``: XLA-CPU's
vectorised ``sqrt``/``rsqrt`` and torch's differ in the last bit on part
of the float32 inputs, so those scales are held to 1 ulp.  The model-level
checks reuse the port's existing bars: ``step_paged`` logits to rtol =
atol = 2e-4 (float32 sums in other orders), equal greedy token streams,
losses to rtol 1e-5 and every gradient leaf to 1e-5 of its largest
magnitude.  The gate's codes are quantized per tensor from float32 values
that differ from the reference's by ulps; a code moves only when a value
sits within an ulp of a rounding boundary, and at these sizes none does
(``test_gated_mlp_under_the_serving_policy`` checks the codes bitwise).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as jnumerics
from repro.configs import get_config as jget_config
from repro.core import carry_ins as jcarry
from repro.core import quant as jquant
from repro.kernels import fp8_elementwise as jfe
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.numerics import policy as jpolicy
from repro_torch import numerics
from repro_torch.configs import get_config
from repro_torch.core import carry_ins, quant
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.kernels import common, ops
from repro_torch.kernels import fp8_elementwise as fe
from repro_torch.launch import serve
from repro_torch.models import Model, layers, params_from_jax
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import steps

FMTS = ("e5m2", "e4m3")
OPS = ("mul", "div", "square", "recip", "sqrt", "rsqrt")
MODES = ("rne", "rna", "rnz", "ru", "rd", "rz", "faithful")
CELLS = list(itertools.product(FMTS, OPS, MODES))
SHAPES = [(1,), (127,), (129,), (3, 5, 37)]


def _serve_policies():
    ew = dict(fmt="e5m2", mode="rne", impl="auto", accum="f32")
    return (jpolicy.get_policy("serve_fp8_paged").replace(
                elementwise=jpolicy.OpPolicy(**ew)),
            numerics.get_policy("serve_fp8_paged").replace(
                elementwise=numerics.OpPolicy(**ew)))


def _train_policies():
    ew = dict(fmt="e4m3", mode="rne", impl="auto", accum="f32")
    return (jpolicy.get_policy("train_fp8_lns").replace(
                elementwise=jpolicy.OpPolicy(**ew)),
            numerics.get_policy("train_fp8_lns").replace(
                elementwise=numerics.OpPolicy(**ew)))


def _codes(rng, shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


def _ulps(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)
    b = np.ascontiguousarray(np.asarray(b, np.float32)).view(np.int32)
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


# --------------------------------------------------------------------------- #
# The carry table: K5's only source of carry bits
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt,op,mode", CELLS)
def test_carry_table_reproduces_carry_in(fmt, op, mode):
    if jcarry.CARRY_INS[(fmt, op)][mode] is None:
        with pytest.raises(carry_ins.Unsupported):
            common.elementwise_carry_table(fmt, op, mode)
        return
    table = common.elementwise_carry_table(fmt, op, mode)
    assert table.dtype == torch.int32 and table.shape == (32,)
    c = torch.arange(256, dtype=torch.int64)
    X, Y = c[:, None], c[None, :]
    words = table.to(torch.int64)[common.carry_index(X)]
    got = (words >> common.carry_index(Y)) & 1
    want = carry_ins.carry_in(fmt, op, mode, X,
                              Y if op in ("mul", "div") else None)
    want = torch.broadcast_to(torch.as_tensor(want, dtype=torch.int64),
                              (256, 256))
    assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# The plain K5 against the reference's Pallas kernel in interpret mode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("op", OPS)
def test_plain_k5_equals_reference_kernel(op, shape):
    fmt = FMTS[SHAPES.index(shape) % 2]
    rng = np.random.default_rng(SHAPES.index(shape))
    x = _codes(rng, shape)
    y = _codes(rng, shape) if op in ("mul", "div") else None
    want = jfe.fp8_elementwise(op, jnp.asarray(x),
                               None if y is None else jnp.asarray(y),
                               fmt=fmt, mode="rne", block_rows=8,
                               interpret=True)
    got = fe.fp8_elementwise(op, torch.from_numpy(x),
                             None if y is None else torch.from_numpy(y),
                             fmt=fmt, mode="rne")
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, fe.fp8_elementwise_plain(
        op, torch.from_numpy(x), None if y is None else torch.from_numpy(y),
        fmt=fmt, mode="rne"))


# --------------------------------------------------------------------------- #
# K5's packed rule (four codes a word, two a register) against the reference
# --------------------------------------------------------------------------- #
def _all_operands(op):
    c = np.arange(256, dtype=np.uint8)
    if op in ("mul", "div"):
        X, Y = np.meshgrid(c, c, indexing="ij")
        return X.reshape(-1), Y.reshape(-1)
    return c, None


@pytest.mark.parametrize("fmt,op,mode", [
    c for c in CELLS if jcarry.CARRY_INS[c[:2]][c[2]] is not None])
def test_packed_rule_model_equals_reference_kernel(fmt, op, mode):
    """Every code (pair) of every supported cell: the int64 model of the
    kernel's packed steps against JAX's Pallas K5 in interpret mode, bit
    for bit; a ragged, odd-length slice pads the last word with code 0."""
    x, y = _all_operands(op)
    want = np.asarray(jfe.fp8_elementwise(
        op, jnp.asarray(x), None if y is None else jnp.asarray(y), fmt=fmt,
        mode=mode, block_rows=512, interpret=True))
    got = fe.packed_rule_model(op, torch.from_numpy(x),
                               None if y is None else torch.from_numpy(y),
                               fmt=fmt, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)
    tail = slice(1, 254)              # 253 codes: not a multiple of 4
    got = fe.packed_rule_model(
        op, torch.from_numpy(x[tail]),
        None if y is None else torch.from_numpy(y[tail]), fmt=fmt, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want[tail])


def test_cpu_calls_launch_nothing_and_views_are_legal():
    before = fe.fp8_elementwise.launches
    buf = torch.from_numpy(_codes(np.random.default_rng(3), (300,)))
    x, y = buf[3:103], buf[150:250]  # views with storage offsets
    got = fe.fp8_elementwise("div", x, y, fmt="e5m2", mode="ru")
    want = fe.fp8_elementwise_plain("div", x.clone(), y.clone(), fmt="e5m2",
                                    mode="ru")
    assert torch.equal(got, want)
    assert fe.fp8_elementwise.launches == before


def test_refusals():
    x = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        fe.fp8_elementwise("mul", x.to(torch.int32), x)
    with pytest.raises(ValueError, match="shapes differ"):
        fe.fp8_elementwise("mul", x, torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="operand"):
        fe.fp8_elementwise("mul", x)
    with pytest.raises(ValueError, match="operand"):
        fe.fp8_elementwise("sqrt", x, x)
    with pytest.raises(ValueError, match="unknown op"):
        fe.fp8_elementwise("exp", x)
    with pytest.raises(carry_ins.Unsupported):
        fe.fp8_elementwise("mul", x, x, fmt="e4m3", mode="ru")
    with pytest.raises(ValueError, match="rbits"):
        fe.fp8_elementwise("mul", x, x, fmt="e5m2", mode="stochastic")
    with pytest.raises(ValueError, match="rbits"):  # as the reference
        jfe.fp8_elementwise("mul", jnp.asarray(x.numpy()),
                            jnp.asarray(x.numpy()), fmt="e5m2",
                            mode="stochastic", block_rows=8, interpret=True)


# --------------------------------------------------------------------------- #
# elementwise_q and numerics.elementwise
# --------------------------------------------------------------------------- #
def _inputs(op, shape=(4, 33), seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    y = (rng.standard_normal(shape) * 2).astype(np.float32)
    if op in ("sqrt", "rsqrt"):
        x[0, :5] = -x[0, :5]  # both signs: negative operands give NaN
    return x, (y if op in ("mul", "div") else None)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("op", OPS)
def test_elementwise_q_codes_and_scales(op, fmt):
    x, y = _inputs(op)
    jx = jquant.quantize(jnp.asarray(x), fmt)
    jy = None if y is None else jquant.quantize(jnp.asarray(y), fmt)
    want = jops.elementwise_q(op, jx, jy, mode="rne", impl="ref")
    qx = quant.quantize(torch.from_numpy(x), fmt)
    qy = None if y is None else quant.quantize(torch.from_numpy(y), fmt)
    for impl in ("pallas", "ref"):
        got = ops.elementwise_q(op, qx, qy, mode="rne", impl=impl)
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(want.codes))
        assert got.fmt == want.fmt and got.scale.dtype == torch.float32
        ulps = _ulps(got.scale.numpy(), want.scale)
        assert ulps.max() <= (1 if op in ("sqrt", "rsqrt") else 0), ulps


@pytest.mark.parametrize("op", OPS)
def test_numerics_elementwise_both_branches(op):
    jpol, pol = _serve_policies()
    x, y = _inputs(op, seed=1)
    jargs = (jnp.asarray(x), None if y is None else jnp.asarray(y))
    args = (torch.from_numpy(x), None if y is None else torch.from_numpy(y))
    # full precision: the float op itself (sqrt/rsqrt within 1 ulp)
    want = np.asarray(jnumerics.elementwise(op, *jargs, None))
    got = numerics.elementwise(op, *args, None).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert _ulps(got[ok], want[ok]).max() <= (1 if op in ("sqrt", "rsqrt")
                                              else 0)
    # quantized: the same codes, so the values differ at most by the
    # scale's ulp (sqrt/rsqrt) and are otherwise bitwise equal
    want = np.asarray(jnumerics.elementwise(op, *jargs, jpol, site="f.g"))
    for impl in ("auto", "ref"):
        p = pol.replace(elementwise=pol.elementwise.replace(impl=impl))
        got = numerics.elementwise(op, *args, p, site="f.g").numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        assert _ulps(got[ok], want[ok]).max() <= (
            1 if op in ("sqrt", "rsqrt") else 0)


def test_gated_mlp_under_the_serving_policy():
    jpol, pol = _serve_policies()
    rng = np.random.default_rng(2)
    d, ff = 16, 40
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in (("w_gate", (d, ff)), ("w_up", (d, ff)),
                      ("w_down", (ff, d)))}
    want = jlayers.gated_mlp(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()}, jpol)
    got = layers.gated_mlp(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           pol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the gate product's codes, from the same float32 g and u, bitwise
    g = jax.nn.silu(jnp.asarray(x) @ p["w_gate"])
    u = jnp.asarray(x) @ p["w_up"]
    jh = jops.elementwise_q("mul", jquant.quantize(g, "e5m2"),
                            jquant.quantize(u, "e5m2"), impl="ref")
    h = ops.elementwise_q("mul", quant.quantize(torch.tensor(np.asarray(g)),
                                                "e5m2"),
                          quant.quantize(torch.tensor(np.asarray(u)), "e5m2"))
    np.testing.assert_array_equal(h.codes.numpy(), np.asarray(jh.codes))
    # and the policy really quantized: the float product differs
    plain = layers.gated_mlp(torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in p.items()},
                             None)
    assert not torch.allclose(plain, got, rtol=1e-3, atol=1e-4)


# --------------------------------------------------------------------------- #
# The serving path through K5
# --------------------------------------------------------------------------- #
def _serve_configs():
    jpol, pol = _serve_policies()
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b", smoke=True,
                                           policy=jpol),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True,
                                         policy=pol),
                              param_dtype="float32")
    return jcfg, cfg


def test_step_paged_logits_under_the_serving_policy(monkeypatch):
    """Teacher-forced mixed prefill+decode steps, as in
    ``test_torch_model``: logits to 2e-4, page scales bitwise; every
    layer of every sub-step calls K5's wrapper once."""
    jcfg, cfg = _serve_configs()
    jm = JModel(jcfg, max_seq=32)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = Model(cfg, max_seq=32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    calls = []
    real = fe.fp8_elementwise
    monkeypatch.setattr(fe, "fp8_elementwise",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    page, P = 4, 16
    jcache = jm.make_paged_cache(2, P, page)
    cache = model.make_paged_cache(P, page, "cpu")
    bt = np.zeros((2, 8), np.int32)
    bt[0, :4] = [15, 14, 13, 12]
    bt[1, :4] = [10, 9, 8, 7]
    jkey = jax.random.fold_in(jax.random.PRNGKey(17), 0)
    key = fold_in(prng_key(17), 0)
    rng = np.random.default_rng(0)
    sub = 0
    for n_new, lengths, T in (([4, 3], [0, 0], 4), ([1, 1], [4, 3], 1),
                              ([1, 1], [5, 4], 1)):
        toks = rng.integers(0, cfg.vocab, (2, T)).astype(np.int32)
        jl, jcache = jm.step_paged(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(lengths),
            jnp.asarray(n_new), jnp.asarray(bt), page_size=page, key=jkey)
        pl, cache = model.step_paged(
            params, cache, torch.from_numpy(toks),
            torch.tensor(lengths, dtype=torch.int32),
            torch.tensor(n_new, dtype=torch.int32), torch.from_numpy(bt),
            page_size=page, key=key)
        sub += T
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=2e-4,
                                   atol=2e-4)
        jself = jcache["blocks"][0]["self"]
        for name in ("ks", "vs"):
            np.testing.assert_array_equal(cache[name].numpy()[:, 1:],
                                          np.asarray(jself[name])[:, 1:])
    assert len(calls) == cfg.n_layers * sub


def test_engine_streams_under_the_serving_policy():
    """The port's token streams equal the reference engine's, fused
    decode on and off (greedy sampling)."""
    jcfg, cfg = _serve_configs()
    queue = [np.arange(3) + 5, np.arange(6) + 17, np.arange(1) + 99]
    jeng = jserve.Engine(jcfg, slots=2, max_seq=16, page_size=4)
    ref, _ = jserve.run_continuous(jeng, queue, gen=4, chunk=4, quiet=True)
    for fused in (True, False):
        eng = serve.Engine(cfg, slots=2, max_seq=16, page_size=4,
                           fused_decode=fused, device="cpu")
        eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                     cfg)
        port, _ = serve.run_continuous(eng, queue, gen=4, chunk=4,
                                       quiet=True)
        assert port == ref, fused


def test_masked_writes_leave_the_null_page_unchanged():
    """Masked lanes are redirected to the null page and write back what
    is there, so the page and its scale never change."""
    from repro_torch.serving.page_pool import write_token_page

    g = torch.Generator().manual_seed(0)
    pages = torch.randint(0, 256, (4, 4, 2, 8), generator=g,
                          dtype=torch.uint8)
    scales = torch.tensor([0.5, 1.0, 2.0, 4.0])
    before = pages[0].clone(), scales[0].clone()
    new = torch.randn((3, 2, 8), generator=g) * 3
    noise = torch.randint(0, 1 << 21, (3, 2, 8), generator=g)
    mask = torch.tensor([False, True, False])
    write_token_page(pages, scales, new, torch.tensor([2, 1, 3]),
                     torch.tensor([0, 2, 0]), fmt="e5m2", noise=noise,
                     write_mask=mask)
    assert torch.equal(pages[0], before[0]) and scales[0] == before[1]
    assert not torch.equal(pages[1, 2], torch.zeros_like(pages[1, 2]))


def test_gate_inputs_equal_fused_and_unfused_in_every_row(monkeypatch):
    """The gate product is quantized per tensor over every slot's row,
    idle slots included, so an idle row's value can move the active rows'
    codes.  Idle slots attend over the null page; the fused decode reads
    it before its scatter and the unfused one after, so the null page
    must not change for the two to agree (it did, and the token streams
    differed on the card).  Every row of every gate call is equal."""
    _, cfg = _serve_configs()
    seen = {}
    real = numerics.elementwise

    def spy(op, x, y=None, pol=None, *, site="", reduce=None):
        seen.setdefault(fused, []).append((x.detach().clone(),
                                           y.detach().clone()))
        return real(op, x, y, pol, site=site, reduce=reduce)

    monkeypatch.setattr(layers.numerics, "elementwise", spy)
    queue = [np.arange(5) + 3, np.arange(17) + 50, np.arange(2) + 9]
    streams = {}
    for fused in (True, False):
        eng = serve.Engine(cfg, slots=6, max_seq=24, page_size=4,
                           fused_decode=fused, device="cpu")
        streams[fused], _ = serve.run_continuous(eng, queue, gen=5, chunk=4,
                                                 quiet=True)
    assert streams[True] == streams[False]
    assert len(seen[True]) == len(seen[False]) > 0
    for (g1, u1), (g2, u2) in zip(seen[True], seen[False]):
        assert torch.equal(g1, g2) and torch.equal(u1, u2)


# --------------------------------------------------------------------------- #
# The training path through K5
# --------------------------------------------------------------------------- #
def _train_models():
    jpol, pol = _train_policies()
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b", smoke=True,
                                           policy=jpol),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True,
                                         policy=pol),
                              param_dtype="float32")
    jm = JModel(jcfg, max_seq=16)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jm, jparams, Model(cfg, max_seq=16), params


def _batch(cfg, B=2, S=16):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, 3] = -1
    return {"tokens": toks, "labels": labels}


def test_loss_and_gradients_under_the_training_policy():
    """float32 smoke model: loss rtol 1e-5, every gradient leaf within
    1e-5 of its largest magnitude.  The gate product's gradient flows
    through the two per-tensor scales only (the codes carry none), in
    both packages."""
    jm, jparams, model, params = _train_models()
    batch = _batch(model.cfg)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    (jloss, _), jgrads = grad_fn(jparams, jax.tree.map(jnp.asarray, batch))
    req = tree_map(lambda p: p.clone().requires_grad_(True), params)
    loss, _ = model.loss_fn(req, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(req))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg)
    for a, b in zip(grads, tree_leaves(want)):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max() + 1e-12)


def test_k5_calls_of_a_train_step(monkeypatch):
    """Each layer's gate product calls K5's wrapper once in the forward
    and once in the checkpointed recompute: 2 x n_layers per step (on
    the card each call is one launch; K5 has no backward kernel)."""
    from repro_torch.optim import adamw

    calls = []
    real = fe.fp8_elementwise
    monkeypatch.setattr(fe, "fp8_elementwise",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, _, model, params = _train_models()
    step = steps.build_train_step(model, adamw.OptConfig())
    state = steps.make_train_state(model, params=params)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in _batch(model.cfg).items()})
    assert np.isfinite(float(metrics["loss"]))
    assert len(calls) == 2 * model.cfg.n_layers
