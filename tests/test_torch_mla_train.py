"""PyTorch port: training deepseek-v2-lite-16b (MLA, shared experts and a
leading dense layer through the straight-through FP8 products) against
the JAX package.

At deepseek's smoke widths (d_model 64, 4 heads, latent 32, qk 16 + 8,
v 16; 8 experts top-2 of d_ff 64, 2 shared; one leading dense layer of
d_ff 128, then one MoE layer), float32 parameters, the same numpy inputs
go through the reference's functions and the port's:

* ``mla_forward``'s STE output and the gradients of its six leaves and
  of x (``jax.vjp``) under the four training policies;
* the MoE layer with shared experts at top-6 of 64 experts (each token's
  six pair gradients added in ascending expert id by ``_GatherPairs``),
  the router's gradient beside the shared experts', both dispatch modes;
* ``Model.loss_fn``'s loss, ce, ``moe_lb`` and ``moe_z`` and every
  gradient leaf (the prefix layer's, the shared experts', the router's)
  under the four policies with ``grouped`` dispatch and under
  ``fp8_lns_pallas`` with ``sorted_global``;
* three AdamW steps under ``fp8_lns_pallas``;
* the products of a train step: the prefix layer runs once (outside the
  checkpoints, as the reference runs it outside its scan's remat), each
  MoE layer twice but the shared experts' down product, once (after the
  checkpoint: the reference's remat drops it from the recompute), so K3
  runs ``8 + 21 (n_layers - 1)`` times a step, the reference's count, K2
  as many under ``train_fp8``, and K4 ``8 + (5 + 3 + 3 E) + (5 + 2 +
  3 E)`` per MoE layer; the loss, aux terms and every gradient bitwise
  those of the layer's former structure, the whole layer under the
  checkpoint;
* kill and resume against an uninterrupted run, and the training CLI.

Tolerances are ``test_torch_moe_train.py``'s: losses rtol 1e-5, every
gradient leaf within 1e-5 of its largest magnitude.  Each JAX function is
built once per module (``_jax_loss``), and torch runs on one CPU thread
(``torch_cpu_threads``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import attention as jatt
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import Model, attention, moe, params_from_jax
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import fault, steps
from test_torch_moe_train import (POLICIES, _assert_grads_close, _batch,
                                  _close, _counted, _lns_loop_policies,
                                  _Reductions, _torch_batch)
from torch_cpu_threads import one_torch_thread  # noqa: F401

ARCH = "deepseek-v2-lite-16b"
CASES = [(p, "grouped") for p in POLICIES] + [("fp8_lns_pallas",
                                               "sorted_global")]
IDS = [f"{p}-{d}" for p, d in CASES]


def _configs(key="fp8_lns_pallas", dispatch="grouped", policy=None,
             **changes):
    """Deepseek's smoke config in both packages, float32 parameters."""
    if policy is not None:
        jkw, kw = dict(policy=policy[0]), dict(policy=policy[1])
    else:
        jkw = kw = POLICIES[key]
    change = dict(param_dtype="float32", moe_dispatch=dispatch, **changes)
    return (dataclasses.replace(jget_config(ARCH, smoke=True, **jkw),
                                **change),
            dataclasses.replace(get_config(ARCH, smoke=True, **kw),
                                **change))


def _models(key="fp8_lns_pallas", dispatch="grouped", policy=None):
    jcfg, cfg = _configs(key, dispatch, policy)
    jm = JModel(jcfg, max_seq=16)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jm, jparams, Model(cfg, max_seq=16), params


@functools.lru_cache(maxsize=None)
def _jax_loss(key, dispatch):
    """The reference model, its init and its jitted ``value_and_grad`` of
    ``loss_fn``, built once per (policy, dispatch)."""
    jm, jparams, model, params = _models(key, dispatch)
    return jm, jparams, model, params, jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))


def _vjp_close(got, want):
    _close(got.detach().numpy(), np.asarray(want))


# --------------------------------------------------------------------------- #
# MLA and the MoE layer under the STE
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key", list(POLICIES))
def test_mla_forward_ste_output_and_gradients(key):
    """``mla_forward``'s five products through the STE (``wq``, ``w_dkv``,
    ``w_uk``, ``w_uv``, ``wo``), RoPE, ``kv_norm``'s RMSNorm, the latent's
    split and ``chunked_attention`` at qk 24 / v 16: the output and, by
    ``jax.vjp``, the gradients of the six leaves and of x, each within 1e-5
    of its largest magnitude."""
    jcfg, cfg = _configs(key)
    jp = {k: v * 25 if k != "kv_norm" else v + 0.1
          for k, v in jatt.mla_init(jax.random.PRNGKey(1), jcfg).items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).copy()

    def ref(p_, x_):
        return jatt.mla_forward(p_, x_, jcfg, positions=jnp.asarray(pos),
                                site="blocks.0.attn")[0]

    want, vjp = jax.vjp(jax.jit(ref), jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = attention.mla_forward(p, tx, cfg, positions=torch.from_numpy(pos),
                                 site="blocks.0.attn")
    y.backward(torch.from_numpy(g))
    _vjp_close(y, want)
    _vjp_close(tx.grad, jgx)
    assert set(p) == {"wq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"}
    for name, leaf in p.items():
        assert float(leaf.grad.abs().max()) > 0, name
        _vjp_close(leaf.grad, jgp[name])


@pytest.mark.parametrize("dispatch", ["grouped", "sorted_global"])
def test_moe_layer_top6_of_64_with_shared_experts(dispatch):
    """The MoE layer at deepseek's routing, top-6 of 64 experts, with its
    two shared experts, under ``train_fp8``: the output, the aux losses
    and the gradients of x, the router, the routed and the shared experts'
    weights against ``jax.vjp`` of the reference's ``moe_ffn``; each
    token's six pair gradients are added by ``_GatherPairs`` in ascending
    expert id, with no reduction whose result depends on an atomic order
    (on inputs whose capacity drops pairs), and the backward repeats
    bitwise."""
    jcfg, cfg = _configs("train_fp8", dispatch, n_experts=64, top_k=6)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    x[:, 3:13] = x[0, 0]  # ten equal tokens a row: their experts overflow
    g = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    def ref(p_, x_):
        out, aux = jmoe.moe_ffn(p_, x_, jcfg, site="blocks.0.ffn")
        return out, aux["moe_lb"] + aux["moe_z"]

    (want, jaux), vjp = jax.vjp(jax.jit(ref), jp, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(g), jnp.ones((), jnp.float32)))
    jgp = jax.tree.map(np.asarray, jgp)

    def run():
        p = tree_map(lambda v: torch.from_numpy(np.array(v))
                     .requires_grad_(True), jax.tree.map(np.asarray, jp))
        tx = torch.from_numpy(x).requires_grad_(True)
        ops = _Reductions()
        with ops:
            out, aux = moe.moe_ffn(p, tx, cfg, site="blocks.0.ffn")
            torch.autograd.backward(
                (out, aux["moe_lb"] + aux["moe_z"]),
                (torch.from_numpy(g), torch.ones(())))
        assert ops.order_dependent == [] and len(ops.seen) >= 2
        return out, aux, tx.grad, p

    out, aux, gx, p = run()
    _vjp_close(out, want)
    np.testing.assert_allclose(float((aux["moe_lb"] + aux["moe_z"]).detach()),
                               float(jaux), rtol=1e-5)
    _vjp_close(gx, jgx)
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert float(p[name].grad.abs().max()) > 0, name
        _vjp_close(p[name].grad, jgp[name])
    for name in ("w_gate", "w_up", "w_down"):
        _vjp_close(p["shared"][name].grad, jgp["shared"][name])
    Tg = 16 if dispatch == "grouped" else 32
    C = moe.capacity(Tg, 6, 64, cfg.capacity_factor)
    ids = moe.route(p["router"].detach(),
                    torch.from_numpy(x).reshape(-1, Tg, cfg.d_model), 6)[3]
    assert not bool(moe.dispatch(ids, 64, C)["keep"].all())
    assert torch.equal(run()[2], gx)


# --------------------------------------------------------------------------- #
# The loss, its aux terms and every gradient
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key,dispatch", CASES, ids=IDS)
def test_loss_aux_terms_and_gradients_match_reference(key, dispatch):
    """``loss_fn`` of the leading dense layer and one MLA + MoE layer:
    loss, ce, ``moe_lb`` and ``moe_z`` (the MoE layer's alone; the dense
    layer adds nothing) within rtol 1e-5, and every gradient leaf within
    1e-5 of its largest magnitude: the prefix layer's (which reaches
    ``params["prefix"]``), the shared experts' and the router's
    included."""
    _, jparams, model, params, jvg = _jax_loss(key, dispatch)
    batch = _batch(model.cfg)
    (jloss, jaux), jgrads = jvg(jparams, jax.tree.map(jnp.asarray, batch))
    req = tree_map(lambda p: p.clone().requires_grad_(True), params)
    loss, aux = model.loss_fn(req, _torch_batch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(req))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for name in ("ce", "moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux[name].detach()),
                                   float(jaux[name]), rtol=1e-5)
    it = iter(grads)
    got = tree_map(lambda _: next(it), req)
    assert len(got["prefix"]) == 1 and len(got["blocks"]) == 1
    for leaf in (got["prefix"][0]["attn"]["w_dkv"],
                 got["prefix"][0]["ffn"]["w_down"],
                 got["blocks"][0]["ffn"]["router"],
                 got["blocks"][0]["ffn"]["shared"]["w_up"]):
        assert float(leaf.abs().max()) > 0.0
    _assert_grads_close(got, jgrads, model.cfg)


def _state_from_jax(jstate, cfg):
    """A reference train state in the port's layout (``params_from_jax``
    carries the ``prefix`` tuple of the parameters and both moments)."""
    conv = lambda t: params_from_jax(jax.tree.map(np.asarray, t), cfg)  # noqa: E731
    return {"params": conv(jstate["params"]),
            "opt": {"m": conv(jstate["opt"]["m"]),
                    "v": conv(jstate["opt"]["v"]),
                    "step": torch.tensor(int(jstate["opt"]["step"]),
                                         dtype=torch.int32)}}


def _assert_params_close(got, want, atol):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)


def test_three_train_steps_match_reference():
    """Three AdamW steps under fp8_lns_pallas against the reference's
    train step (its ``value_and_grad`` of the loss, then
    ``adamw.update``).  Each port step starts from the reference's state,
    carried across by ``params_from_jax`` (the ``prefix`` tuple
    included): losses and terms rtol 1e-5, gradient norms rtol 1e-4, the
    new moments within 1e-5 of each leaf's largest magnitude, the new
    parameters within 5 % of a step's largest possible move.  The port
    also runs the steps on its own states: its first two losses within
    rtol 1e-5 and its parameters within 5 % of the steps' largest move.
    Its third step is not held there: on the third batch a rounding or
    routing decision lies within float noise of its boundary, so
    parameters that differ by under 1e-5 part the losses by 1.5e-5 and a
    few parameters by 0.2 lr, while from the reference's state the loss
    is equal."""
    _, jparams, model, params, jvg = _jax_loss("fp8_lns_pallas", "grouped")
    cfg = model.cfg
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jupdate = jax.jit(functools.partial(
        jadamw.update, cfg=jadamw.OptConfig(**opt)))
    jstate = {"params": jparams, "opt": jadamw.init(jparams)}
    step = steps.build_train_step(model, adamw.OptConfig(**opt))
    own = steps.make_train_state(model, params=params)
    for i in range(3):
        batch = _batch(cfg, seed=i)
        state = _state_from_jax(jstate, cfg)
        assert len(state["params"]["prefix"]) == 1
        (jloss, jmetrics), jgrads = jvg(jstate["params"],
                                        jax.tree.map(jnp.asarray, batch))
        jp, jo, jstats = jupdate(jgrads, jstate["opt"], jstate["params"])
        jstate = {"params": jp, "opt": jo}
        jmetrics = dict(jmetrics, loss=jloss, **jstats)
        state, metrics = step(state, _torch_batch(batch))
        own, own_metrics = step(own, _torch_batch(batch))
        for name in ("loss", "ce", "moe_lb", "moe_z"):
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
def _pallas_calls(jaxpr, in_remat=False, counts=None):
    """Interpreted Pallas calls of a jaxpr, sub-jaxprs included (a scan's
    body times its length): {False: outside a remat, True: inside one,
    the backward's recompute}."""
    counts = {False: 0, True: 0} if counts is None else counts
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            counts[in_remat] += 1
            continue
        times = eqn.params.get("length", 1) if eqn.primitive.name == "scan" \
            else 1
        for sub in jax.core.jaxprs_in_params(eqn.params):
            for _ in range(times):
                _pallas_calls(sub, in_remat or eqn.primitive.name == "remat2",
                              counts)
    return counts


def test_prefix_layer_runs_once_per_step(monkeypatch):
    """In a train step the leading dense layer's sublayer runs once and the
    MoE layer's twice (forward and checkpointed recompute), as in the
    reference, whose remat wraps only its scanned blocks: the port's
    ``sublayer_forward`` calls by site, and its K3 calls, 8 + 11 + 10,
    equal to the interpreted Pallas calls of the reference's
    ``value_and_grad``: 8 + 11 outside its remat and 10 inside.  Both
    recomputes leave out the shared experts' down product, whose output
    no gradient reads: the port runs it after the checkpoint."""
    jm, jparams, model, params, _ = _jax_loss("fp8_lns_pallas", "grouped")
    batch = _batch(model.cfg)
    closed = jax.make_jaxpr(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    sites = []
    real = transformer.sublayer_forward
    monkeypatch.setattr(transformer, "sublayer_forward", lambda *a, **k: (
        sites.append(k["site"]) or real(*a, **k)))
    calls = _counted(monkeypatch, ("lns_product_matmul",))
    step = steps.build_train_step(model, adamw.OptConfig())
    step(steps.make_train_state(model, params=params), _torch_batch(batch))
    assert sorted(sites) == ["blocks.0", "blocks.0", "prefix.0"]
    reference = _pallas_calls(closed.jaxpr)
    assert reference == {False: 8 + 11, True: 11 - 1}
    assert calls["lns_product_matmul"] == 8 + 11 + 10 == sum(
        reference.values())


def _k2_policies():
    """``train_fp8`` with its matmuls through K2 (``fused_dequant``), the
    route ``auto`` takes on the card."""
    from repro.numerics import policy as jpolicy
    from repro_torch import numerics

    return tuple(
        pol.replace(matmul=dataclasses.replace(pol.matmul,
                                               impl="fused_dequant"))
        for pol in (jpolicy.get_policy("train_fp8"),
                    numerics.get_policy("train_fp8")))


@pytest.mark.parametrize("route", ["lns", "lns_loop", "fused_dequant"])
def test_kernel_calls_of_a_train_step(monkeypatch, route):
    """K3 runs 8 + 21 (n_layers - 1) times a step (the prefix layer's 5
    MLA and 3 FFN products once; each MoE layer's 5 MLA, 3 shared and 3
    routed products, one batched call each, twice, but the shared down
    product once) and K2 never; under ``train_fp8`` (impl
    ``fused_dequant``) K2 as many and K3 never; under a matmul impl of
    lns_loop, K4 runs each expert's products one launch each, 8 + (5 + 3
    + 3 E) + (5 + 2 + 3 E) (n_layers - 1), and K3 never."""
    names = ("lns_product_matmul", "lns_loop_matmul", "dequant_matmul")
    calls = _counted(monkeypatch, names)
    policy = {"lns_loop": _lns_loop_policies,
              "fused_dequant": _k2_policies}.get(route, lambda: None)()
    _, _, model, params = _models(policy=policy)
    cfg = model.cfg
    step = steps.build_train_step(model, adamw.OptConfig())
    _, metrics = step(steps.make_train_state(model, params=params),
                      _torch_batch(_batch(cfg)))
    assert all(np.isfinite(float(metrics[k]))
               for k in ("loss", "moe_lb", "moe_z"))
    moe_layers = cfg.n_layers - cfg.first_dense
    E = cfg.n_experts
    if route == "lns":
        want = {"lns_product_matmul": 8 + 21 * moe_layers}
    elif route == "fused_dequant":
        want = {"dequant_matmul": 8 + 21 * moe_layers}
    else:
        want = {"lns_loop_matmul": 8 + ((5 + 3 + 3 * E) + (5 + 2 + 3 * E))
                * moe_layers}
    assert calls == {name: want.get(name, 0) for name in names}


def _whole_layer_stack_forward(layers, x, cfg, *, positions, mode="train"):
    """``stack_forward``'s training loop as it was before the shared
    experts' down product left the checkpoint: every body layer whole
    under ``torch.utils.checkpoint``."""
    from torch.utils.checkpoint import checkpoint

    assert mode == "train"
    aux = {"moe_lb": 0.0, "moe_z": 0.0}
    for i, p in enumerate(layers):
        kw = transformer._layer_kw(cfg, i)
        if i < cfg.first_dense:
            out = transformer.sublayer_forward(p, x, cfg, positions=positions,
                                               want_aux=True, **kw)
        else:
            out = checkpoint(transformer.sublayer_forward, p, x, cfg,
                             use_reentrant=False, positions=positions,
                             want_aux=True, **kw)
        if kw["ffn"] == "moe":
            x, lb, z = out
            aux = {"moe_lb": aux["moe_lb"] + lb, "moe_z": aux["moe_z"] + z}
        else:
            x = out
    return x, aux


@pytest.mark.parametrize("key", ["fp8_lns_pallas", "train_bf16"])
def test_shared_down_product_leaves_the_recompute_bitwise(monkeypatch, key):
    """The loss, ce, aux terms and every gradient leaf of a step's loss
    are bitwise those of the former structure (the whole MoE layer under
    the checkpoint, kept above), which ran K3 8 + 22 times against the
    new 8 + 21."""
    from repro_torch.models import model as model_mod

    _, _, model, params = _models(key)
    batch = _torch_batch(_batch(model.cfg))

    def loss_and_grads():
        leaves = tree_leaves(params)
        live = [t.detach().requires_grad_(True) for t in leaves]
        it = iter(live)
        loss, metrics = model.loss_fn(tree_map(lambda _: next(it), params),
                                      batch)
        return loss, metrics, torch.autograd.grad(loss, live,
                                                  allow_unused=True)

    calls = _counted(monkeypatch, ("lns_product_matmul",))
    new = loss_and_grads()
    n_new = calls["lns_product_matmul"]
    monkeypatch.setattr(model_mod, "stack_forward",
                        _whole_layer_stack_forward)
    old = loss_and_grads()
    n_old = calls["lns_product_matmul"] - n_new
    if key == "fp8_lns_pallas":
        assert (n_new, n_old) == (8 + 21, 8 + 22)
    assert torch.equal(new[0], old[0])
    assert set(new[1]) == {"ce", "moe_lb", "moe_z"}
    for name in new[1]:
        assert torch.equal(new[1][name], old[1][name]), name
    assert len(new[2]) == len(old[2])
    for g_new, g_old in zip(new[2], old[2]):
        assert (g_new is None) == (g_old is None)
        if g_new is not None:
            assert torch.equal(g_new, g_old)


# --------------------------------------------------------------------------- #
# Kill and resume, the CLI
# --------------------------------------------------------------------------- #
def _run(tmp_path, name, fault_hook=None):
    _, _, model, params = _models()
    data = pipeline.Dataset(pipeline.DataConfig(
        vocab=model.cfg.vocab, seq_len=16, global_batch=2, kind="arith"))
    logs = []
    state, history = fault.run_training(
        train_step=steps.build_train_step(model, adamw.OptConfig(lr=1e-2)),
        init_state=lambda: steps.make_train_state(model, params=params),
        dataset=data, max_steps=4, ckpt_dir=tmp_path / name, ckpt_every=2,
        fault_hook=fault_hook, to_device=_torch_batch, log=logs.append)
    return state, history, logs


def test_kill_and_resume_equals_an_uninterrupted_run(tmp_path):
    """A step that fails after the step-2 checkpoint restores it (the
    prefix layer's leaves with the rest) and replays the same batches:
    the final state is bitwise the uninterrupted run's."""
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
    assert all(np.isfinite(h["moe_lb"]) and h["moe_z"] > 0 for h in hist)
    assert len(resumed["params"]["prefix"]) == 1
    for a, b in zip(tree_leaves(resumed), tree_leaves(clean)):
        assert torch.equal(a, b)


def test_train_cli_trains_deepseek_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch deepseek-v2-lite-16b
    --smoke --device cpu --quant fp8_lns_pallas`` on learnable data:
    finite losses and aux terms, no restart, a checkpoint, and the loss
    falls."""
    history = train.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--quant",
        "fp8_lns_pallas", "--steps", "8", "--batch", "4", "--seq", "32",
        "--lr", "1e-2", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in history] == [4, 8]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["moe_lb"])
               and h["moe_z"] > 0 and h["restarts"] == 0 for h in history)
    assert history[-1]["loss"] < history[0]["loss"]
    assert (tmp_path / "step-8" / "manifest.json").exists()
    assert "[train:cpu] done" in capsys.readouterr().out
