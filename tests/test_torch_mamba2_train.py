"""PyTorch port: training mamba2-780m (Mamba2's SSD mixer through the
straight-through FP8 products) against the JAX package.

At mamba2's smoke widths (d_model 64, d_inner 128, 8 SSD heads of 16,
d_state 16, conv width 4, 2 layers, the tied embedding), float32
parameters, the same numpy inputs go through the reference's functions
and the port's:

* the within-chunk decays: the port masks the exponent
  (``mamba2.masked_decay``: ``exp(where(mask, diff, -inf))``) where the
  reference masks the exponential (``where(mask, exp(diff), 0)``,
  ``src/repro/models/mamba2.py:102``).  ``ssd_forward``'s outputs are
  bitwise those of the former form, and within ``F32_TOL`` of JAX's;
* at S 128 with the decays at Mamba2's init ranges (A in [1, 16], dt in
  [0.001, 0.1]) a chunk's dt |A| sums pass float32's ``exp`` range above
  the diagonal: JAX's gradients of ``A_log``, ``dt_bias`` and ``w_dt``
  are NaN there (0 x inf in the untaken branch), and so are the port's
  under the former form; the port's are finite and within ``GRAD_TOL``
  of JAX's at chunk 16, the same function summed in another order, where
  JAX's are finite;
* ``Model.loss_fn``'s loss and every gradient leaf (the tied embedding,
  which is no STE product, among them) under ``train_bf16``,
  ``fp8_lns_pallas``, ``train_fp8`` and ``train_fp8_weight_only``,
  within ``test_torch_moe_train.py``'s tolerances (losses rtol 1e-5,
  every leaf 1e-5 of its largest magnitude);
* the products of a train step: each SSD layer (``ffn="none"``, as in
  the full config) under ``torch.utils.checkpoint``, so each of its six
  STE products (``w_z``, ``w_x``, ``w_B``, ``w_C``, ``w_dt``,
  ``out_proj``) runs twice, forward and recompute: K3 2 x 6 x n_layers,
  K4 as many under ``lns_loop``, K2 under ``fused_dequant`` (the
  reference's recompute drops ``out_proj``, whose output feeds no
  gradient: 6 + 5 a layer there);
* three AdamW steps, kill and resume, and the training CLI.

Each JAX function is built once per module (``_jax_loss``), and torch
runs on one CPU thread (``torch_cpu_threads``).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import mamba2 as jmamba
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import Model, mamba2, params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import fault, steps
from test_torch_mla_train import (_assert_params_close, _k2_policies,
                                  _pallas_calls, _state_from_jax)
from test_torch_moe_train import (POLICIES, _assert_grads_close, _batch,
                                  _counted, _lns_loop_policies, _torch_batch)
from torch_cpu_threads import one_torch_thread  # noqa: F401

ARCH = "mamba2-780m"
F32_TOL = 1e-5    # x the largest |output|: float32 sums in another order
# x the largest |gradient| of a leaf, the port's chunk of 128 against JAX's
# chunk of 16: the decays of one chunk as exp(cum_i - cum_j) against the
# products of up to eight chunks' decays (measured: 1.4e-5 at most, A_log)
GRAD_TOL = 1e-4
MAMBA2_A = (1.0, 16.0)     # Mamba2's init range of A = exp(A_log)
MAMBA2_DT = (1e-3, 1e-1)   # ... and of dt, through dt_bias


def _configs(key="fp8_lns_pallas", policy=None, **changes):
    """mamba2's smoke config in both packages, float32 parameters."""
    if policy is not None:
        jkw, kw = dict(policy=policy[0]), dict(policy=policy[1])
    else:
        jkw = kw = POLICIES[key]
    change = dict(param_dtype="float32", **changes)
    return (dataclasses.replace(jget_config(ARCH, smoke=True, **jkw),
                                **change),
            dataclasses.replace(get_config(ARCH, smoke=True, **kw),
                                **change))


def _models(key="fp8_lns_pallas", policy=None, **changes):
    jcfg, cfg = _configs(key, policy, **changes)
    jm = JModel(jcfg, max_seq=32)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jm, jparams, Model(cfg, max_seq=32), params


@functools.lru_cache(maxsize=None)
def _jax_loss(key):
    """The reference model, its init and its jitted ``value_and_grad`` of
    ``loss_fn``, built once per policy."""
    jm, jparams, model, params = _models(key)
    return jm, jparams, model, params, jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))


def _former_decay(diff, mask):
    """The reference's form, which the port had before: the exponential
    masked, not its exponent."""
    return torch.where(mask, torch.exp(diff),
                       torch.zeros((), dtype=diff.dtype, device=diff.device))


def _mixer(jcfg, seed=0, ranges=False):
    """The reference's mixer leaves; with ``ranges``, A and dt spread
    over Mamba2's init ranges, ends included (head h takes the h-th of
    ``nh`` points, A linear, dt geometric), through ``A_log`` and
    ``dt_bias`` (softplus' inverse)."""
    jp = dict(jmamba.mamba2_init(jax.random.PRNGKey(seed), jcfg))
    if ranges:
        nh = jp["A_log"].shape[0]
        A = np.linspace(*MAMBA2_A, nh)
        dt = np.geomspace(*MAMBA2_DT, nh)
        jp["A_log"] = jnp.asarray(np.log(A), jnp.float32)
        jp["dt_bias"] = jnp.asarray(dt + np.log(-np.expm1(-dt)), jnp.float32)
    return jp


def _port_vjp(jp, x, g, cfg, chunk=128):
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, cache = mamba2.ssd_forward(p, tx, cfg, chunk=chunk)
    y.backward(torch.from_numpy(g))
    return y.detach(), cache, tx.grad, {k: t.grad for k, t in p.items()}


def _within(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * np.abs(want).max() + 1e-12)


# --------------------------------------------------------------------------- #
# The masked decays
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("S,chunk", [(8, 4), (32, 128), (128, 128)])
def test_masked_decay_forward_is_bitwise_the_former_form(monkeypatch, S,
                                                         chunk):
    """``ssd_forward``'s output, conv cache and end state with the
    exponent masked are bitwise those of the former form (the reference's,
    the exponential masked): exp(-inf) is exactly 0; and within
    ``F32_TOL`` of JAX's ``ssd_forward``."""
    jcfg, cfg = _configs("train_bf16")
    jp = _mixer(jcfg, seed=1, ranges=True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    y, c = mamba2.ssd_forward(p, torch.from_numpy(x), cfg, chunk=chunk)
    monkeypatch.setattr(mamba2, "masked_decay", _former_decay)
    y0, c0 = mamba2.ssd_forward(p, torch.from_numpy(x), cfg, chunk=chunk)
    assert torch.equal(y, y0)
    assert torch.equal(c["state"], c0["state"])
    assert torch.equal(c["conv"], c0["conv"])
    jy, jc = jax.jit(lambda p_, x_: jmamba.ssd_forward(
        p_, x_, jcfg, chunk=chunk))(jp, jnp.asarray(x))
    _within(y, jy, F32_TOL)
    _within(c["state"], jc["state"], F32_TOL)


def test_decay_gradient_is_finite_where_the_references_is_nan(monkeypatch):
    """S 128, one chunk, A and dt over Mamba2's init ranges: the largest
    dt |A| sum over a chunk's 127 rows passes 88.72, where float32's exp
    overflows.  JAX's gradients of ``A_log``, ``dt_bias`` and ``w_dt``
    are then non-finite (ROADMAP.md Queue 3, a known behaviour of the
    reference), and the port's under the former form alike; the port's
    are finite, every leaf's and x's within ``GRAD_TOL`` of JAX's at
    chunk 16 (finite there: no chunk's sum passes the range), and its
    output within ``F32_TOL``."""
    jcfg, cfg = _configs("train_bf16")
    jp = _mixer(jcfg, seed=3, ranges=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 128, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 128, cfg.d_model)).astype(np.float32)
    nh = jp["A_log"].shape[0]
    assert MAMBA2_A[1] * MAMBA2_DT[1] * 127 > math.log(np.finfo(
        np.float32).max)

    def reference(chunk):
        def f(p_, x_):
            return jmamba.ssd_forward(p_, x_, jcfg, chunk=chunk)[0]
        y, vjp = jax.vjp(jax.jit(f), jp, jnp.asarray(x))
        gp, gx = vjp(jnp.asarray(g))
        return y, gx, jax.tree.map(np.asarray, gp)

    _, _, nan = reference(128)
    want_y, want_gx, want = reference(16)
    for name in ("A_log", "dt_bias", "w_dt"):
        assert not np.isfinite(nan[name]).all(), name
        assert np.isfinite(want[name]).all(), name
    y, _, gx, grads = _port_vjp(jp, x, g, cfg)
    _within(y, want_y, F32_TOL)
    _within(gx, want_gx, GRAD_TOL)
    assert set(grads) == set(want)
    for name, t in grads.items():
        assert bool(torch.isfinite(t).all()), name
        _within(t, want[name], GRAD_TOL)
    monkeypatch.setattr(mamba2, "masked_decay", _former_decay)
    former = _port_vjp(jp, x, g, cfg)[3]
    for name in ("A_log", "dt_bias"):
        bad = ~torch.isfinite(former[name])
        assert bad.any() and bool((bad.numpy()
                                   == ~np.isfinite(nan[name])).all()), name
    assert not bool(torch.isfinite(former["w_dt"]).all())
    assert nh == former["A_log"].shape[0]


# --------------------------------------------------------------------------- #
# The loss and every gradient
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key", list(POLICIES))
def test_loss_and_gradients_match_reference(key):
    """``loss_fn`` at S 32 (one chunk): loss and ce within rtol 1e-5 and
    every gradient leaf within 1e-5 of its largest magnitude, the tied
    embedding's (no STE product: its rows are read by the lookup and its
    transpose is the LM head) and each SSD leaf's among them."""
    _, jparams, model, params, jvg = _jax_loss(key)
    batch = _batch(model.cfg, S=32)
    (jloss, jaux), jgrads = jvg(jparams, jax.tree.map(jnp.asarray, batch))
    req = tree_map(lambda p: p.clone().requires_grad_(True), params)
    loss, aux = model.loss_fn(req, _torch_batch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(req))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(jaux["ce"]),
                               rtol=1e-5)
    assert model.cfg.tie_embeddings and "unembed" not in params
    it = iter(grads)
    got = tree_map(lambda _: next(it), req)
    for leaf in (got["embed"], got["blocks"][0]["mamba"]["A_log"],
                 got["blocks"][1]["mamba"]["w_dt"],
                 got["blocks"][1]["mamba"]["out_proj"]):
        assert float(leaf.abs().max()) > 0.0
    _assert_grads_close(got, jgrads, model.cfg)


def test_three_train_steps_match_reference():
    """Three AdamW steps under fp8_lns_pallas against the reference's
    train step (its ``value_and_grad`` of the loss, then
    ``adamw.update``), each port step from the reference's state: losses
    rtol 1e-5, gradient norms rtol 1e-4, the new moments within 1e-5 of
    each leaf's largest magnitude, the new parameters within 5 % of a
    step's largest move.  The port also runs the steps on its own states:
    its first two losses within rtol 1e-5 and its parameters within 5 %
    of the steps' largest move.  Its third is not held there, as in
    ``test_torch_mla_train.py``: parameters that differ by under 1e-5
    move an FP8 code at a rounding boundary, which parts the losses by
    3.5e-5, while from the reference's state the loss is equal."""
    _, jparams, model, params, jvg = _jax_loss("fp8_lns_pallas")
    cfg = model.cfg
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jupdate = jax.jit(functools.partial(
        jadamw.update, cfg=jadamw.OptConfig(**opt)))
    jstate = {"params": jparams, "opt": jadamw.init(jparams)}
    step = steps.build_train_step(model, adamw.OptConfig(**opt))
    own = steps.make_train_state(model, params=params)
    for i in range(3):
        batch = _batch(cfg, seed=i, S=32)
        state = _state_from_jax(jstate, cfg)
        (jloss, jmetrics), jgrads = jvg(jstate["params"],
                                        jax.tree.map(jnp.asarray, batch))
        jp, jo, jstats = jupdate(jgrads, jstate["opt"], jstate["params"])
        jstate = {"params": jp, "opt": jo}
        jmetrics = dict(jmetrics, loss=jloss, **jstats)
        state, metrics = step(state, _torch_batch(batch))
        own, own_metrics = step(own, _torch_batch(batch))
        for name in ("loss", "ce"):
            np.testing.assert_allclose(float(metrics[name]),
                                       float(jmetrics[name]), rtol=1e-5)
            if i < 2:
                np.testing.assert_allclose(float(own_metrics[name]),
                                           float(jmetrics[name]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-4)
        want = _state_from_jax(jstate, cfg)
        _assert_grads_close(state["opt"]["m"], jstate["opt"]["m"], cfg)
        _assert_grads_close(state["opt"]["v"], jstate["opt"]["v"], cfg)
        _assert_params_close(state["params"], want["params"],
                             0.05 * opt["lr"])
        if i < 2:
            _assert_params_close(own["params"], want["params"],
                                 0.05 * (i + 1) * opt["lr"])


# --------------------------------------------------------------------------- #
# The products of a train step
# --------------------------------------------------------------------------- #
def test_ssd_layers_run_under_the_checkpoint(monkeypatch):
    """With ``d_ff = 0`` (the full config's: no FFN) each SSD layer runs
    under ``torch.utils.checkpoint``: its forward runs twice a step
    (``sublayer_forward`` by site) and each of its six products twice, 2 x
    6 x n_layers K3 calls.  The reference's ``value_and_grad`` interprets
    its Pallas kernel 6 x n_layers times outside its remat but 5 x
    n_layers inside: its recompute drops ``out_proj``, whose output only
    joins the residual and so feeds no gradient.  The port recomputes it
    (ROADMAP.md Queue 3, open: qwen2's ``w_down`` likewise); the loss and
    every gradient match (:func:`test_loss_and_gradients_match_reference`)."""
    from repro_torch.models import transformer

    jm, jparams, model, params = _models(d_ff=0)
    batch = _batch(model.cfg, S=32)
    closed = jax.make_jaxpr(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    n = model.cfg.n_layers
    assert _pallas_calls(closed.jaxpr) == {False: 6 * n, True: 5 * n}
    assert "ffn" not in params["blocks"][0]
    sites = []
    real = transformer.sublayer_forward
    monkeypatch.setattr(transformer, "sublayer_forward", lambda *a, **k: (
        sites.append(k["site"]) or real(*a, **k)))
    calls = _counted(monkeypatch, ("lns_product_matmul",))
    step = steps.build_train_step(model, adamw.OptConfig())
    step(steps.make_train_state(model, params=params),
         _torch_batch(batch))
    assert sorted(sites) == ["blocks.0"] * (2 * n)
    assert calls["lns_product_matmul"] == 2 * 6 * n


@pytest.mark.parametrize("route", ["lns", "lns_loop", "fused_dequant"])
def test_kernel_calls_of_a_train_step(monkeypatch, route):
    """K3 runs 2 x 6 x n_layers times a step (each SSD layer's six STE
    products, forward and checkpointed recompute) and K2 and K4 never;
    under ``train_fp8`` with impl ``fused_dequant`` K2 as many and the
    others never; under a matmul impl of ``lns_loop`` K4 as many (every
    product 2-D, one launch each) and the others never.  ``d_ff = 0``, as
    in the full config; the loss finite."""
    names = ("lns_product_matmul", "lns_loop_matmul", "dequant_matmul")
    calls = _counted(monkeypatch, names)
    policy = {"lns_loop": _lns_loop_policies,
              "fused_dequant": _k2_policies}.get(route, lambda: None)()
    _, _, model, params = _models(policy=policy, d_ff=0)
    step = steps.build_train_step(model, adamw.OptConfig())
    _, metrics = step(steps.make_train_state(model, params=params),
                      _torch_batch(_batch(model.cfg, S=32)))
    assert np.isfinite(float(metrics["loss"]))
    want = 2 * 6 * model.cfg.n_layers
    name = {"lns": "lns_product_matmul", "lns_loop": "lns_loop_matmul",
            "fused_dequant": "dequant_matmul"}[route]
    assert calls == {n: want if n == name else 0 for n in names}


# --------------------------------------------------------------------------- #
# Kill and resume, the CLI
# --------------------------------------------------------------------------- #
def _run(tmp_path, name, fault_hook=None):
    _, _, model, params = _models()
    data = pipeline.Dataset(pipeline.DataConfig(
        vocab=model.cfg.vocab, seq_len=32, global_batch=2, kind="arith"))
    logs = []
    state, history = fault.run_training(
        train_step=steps.build_train_step(model, adamw.OptConfig(lr=1e-2)),
        init_state=lambda: steps.make_train_state(model, params=params),
        dataset=data, max_steps=4, ckpt_dir=tmp_path / name, ckpt_every=2,
        fault_hook=fault_hook, to_device=_torch_batch, log=logs.append)
    return state, history, logs


def test_kill_and_resume_equals_an_uninterrupted_run(tmp_path):
    """A step that fails after the step-2 checkpoint restores it (the
    float32 SSD leaves with the rest) and replays the same batches: the
    final state is bitwise the uninterrupted run's."""
    fired = []

    def crash_once(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected crash")

    clean, clean_hist, _ = _run(tmp_path, "clean")
    resumed, hist, logs = _run(tmp_path, "crash", crash_once)
    assert fired == [3]
    assert [h["restarts"] for h in hist] == [0, 1]
    assert any("restoring last checkpoint" in line for line in logs)
    assert [h["loss"] for h in hist] == [h["loss"] for h in clean_hist]
    for a, b in zip(tree_leaves(resumed), tree_leaves(clean)):
        assert torch.equal(a, b)


def test_train_cli_trains_mamba2_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch mamba2-780m --smoke
    --device cpu --quant fp8_lns_pallas`` on learnable data: finite
    losses, no restart, a checkpoint, and the loss falls.  (Training
    mamba2 was refused before: ROADMAP.md Queue 1 item 11c-train.)"""
    history = train.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--quant",
        "fp8_lns_pallas", "--steps", "16", "--batch", "4", "--seq", "32",
        "--lr", "1e-2", "--ckpt-every", "8", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in history] == [8, 16]
    assert all(np.isfinite(h["loss"]) and h["restarts"] == 0
               for h in history)
    assert history[-1]["loss"] < history[0]["loss"]
    assert (tmp_path / "step-16" / "manifest.json").exists()
    assert "[train:cpu] done" in capsys.readouterr().out


def test_hybrid_training_is_refused(tmp_path):
    """Training jamba-v0.1-52b waits for FSDP (ROADMAP.md Queue 1 item
    12): ``build_train_step`` and the training CLI raise, naming it."""
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        steps.build_train_step(Model(cfg), adamw.OptConfig())
    with pytest.raises(NotImplementedError, match="item 12"):
        train.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device",
                    "cpu", "--steps", "1", "--ckpt-dir", str(tmp_path)])
