"""PyTorch port: MoE training (granite-moe-3b-a800m's smoke config: 8
experts, top-2, d_ff 64, 2 layers) against the JAX package.

The reference vmaps ``_dispatch_group`` over token groups and
``numerics.matmul`` over experts, so every (group, expert) pair quantizes
its own activations per tensor and every expert its own weight per output
channel; the port stacks the groups into ``[E, G * C, D]`` buffers and
runs one batched product (``layers.ste_expert_matmul``).  Held here:

* the codes and scales of every (group, expert) pair and every expert,
  bitwise (FP8 encoding is integer arithmetic on equal floats);
* the expert products' STE forward and gradients under ``train_bf16``,
  ``fp8_lns_pallas`` (K3's plain version against the reference's
  interpreted Pallas kernel), ``train_fp8`` (its impl ``auto`` is the
  plain decode product on the CPU in both packages) and
  ``train_fp8_weight_only``, with one group (``sorted_global``) and with
  several (``grouped``);
* ``Model.loss_fn``'s loss, ce, ``moe_lb`` and ``moe_z`` (each summed over
  layers through the checkpoints) and every parameter's gradient, router
  included, under the four policies and both dispatch modes;
* three AdamW steps, the K3 and K4 call counts of a train step, kill and
  resume, and the training CLI.

Tolerances are ``test_torch_train.py``'s: losses rtol 1e-5, every
gradient leaf 1e-5 of its largest magnitude (measured: below 7e-7 of it
in every case), float32 parameters.  The weight gradient of an expert
product sums every group's rows in one product where the reference adds
the groups' products: float32 sums in another order, inside the same
limit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.core import quant as jquant
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.data import pipeline
from repro_torch.kernels import lns_matmul as lm
from repro_torch.launch import train
from repro_torch.models import Model, moe, params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import fault, steps
from torch_cpu_threads import one_torch_thread  # noqa: F401

ARCH = "granite-moe-3b-a800m"
POLICIES = {"train_bf16": dict(policy="train_bf16"),
            "fp8_lns_pallas": dict(quant="fp8_lns_pallas"),
            "train_fp8": dict(policy="train_fp8"),
            "train_fp8_weight_only": dict(policy="train_fp8_weight_only")}
DISPATCH = ("grouped", "sorted_global")
CASES = [(p, d) for p in POLICIES for d in DISPATCH]
IDS = [f"{p}-{d}" for p, d in CASES]


def _configs(key="fp8_lns_pallas", dispatch="grouped", policy=None):
    """The smoke config in both packages, float32 parameters."""
    if policy is not None:
        jkw, kw = dict(policy=policy[0]), dict(policy=policy[1])
    else:
        jkw = kw = POLICIES[key]
    change = dict(param_dtype="float32", moe_dispatch=dispatch)
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


def _batch(cfg, seed=0, B=2, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, 3] = -1  # an ignored label
    return {"tokens": toks, "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, scale=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=scale * np.abs(want).max() + 1e-12)


def _assert_grads_close(got_tree, jgrads, cfg):
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    got, ref = tree_leaves(got_tree), tree_leaves(want)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _close(a.detach().numpy(), b.numpy())


# --------------------------------------------------------------------------- #
# The expert products
# --------------------------------------------------------------------------- #
def _expert_operands(G, seed=3, E=8, C=8, D=64, F=32):
    """Buffers of G token groups [G, E, C, D] (the reference's per-group
    layout; a few zero rows, as capacity padding leaves them), expert
    weights [E, D, F] and an output cotangent [G, E, C, F]."""
    rng = np.random.default_rng(seed)
    bufs = rng.standard_normal((G, E, C, D)).astype(np.float32)
    bufs[:, :, -2:] = 0.0
    bufs[0, 1] *= 40.0        # one pair's scale far from the others'
    w = (rng.standard_normal((E, D, F)) * 0.05).astype(np.float32)
    w[2] *= 8.0               # one expert's scales far from the others'
    g = rng.standard_normal((G, E, C, F)).astype(np.float32)
    return bufs, w, g


def _stacked(a):
    """[G, E, C, ...] (the reference's groups) -> the port's [E, G * C,
    ...] buffer."""
    a = np.array(np.swapaxes(a, 0, 1))
    return torch.from_numpy(a.reshape(a.shape[0], -1, *a.shape[3:]))


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_expert_codes_and_scales_bitwise(G, fmt):
    """Activations per (group, expert) pair and weights per expert and
    output channel: codes and scales bitwise the reference's ``quantize``
    under its vmaps."""
    bufs, w, _ = _expert_operands(G)
    jq = jax.vmap(jax.vmap(lambda a: jquant.quantize(a, fmt)))(
        jnp.asarray(bufs))
    jw = jax.vmap(lambda b: jquant.quantize(b, fmt, axis=-1))(jnp.asarray(w))
    E, C, D = bufs.shape[1:]
    qx = quant.quantize(_stacked(bufs).view(E, G, C, D), fmt, axis=(0, 1))
    qw = quant.quantize(torch.from_numpy(w), fmt, axis=(0, 2))
    assert qx.scale.shape == (E, G, 1, 1) and qw.scale.shape == (E, 1, 32)
    np.testing.assert_array_equal(
        qx.codes.view(E, G, C, D).numpy(),
        np.swapaxes(np.asarray(jq.codes), 0, 1))
    np.testing.assert_array_equal(
        qx.scale.numpy().view(np.uint32).reshape(E, G),
        np.asarray(jq.scale, np.float32).view(np.uint32).reshape(G, E).T)
    np.testing.assert_array_equal(qw.codes.numpy(), np.asarray(jw.codes))
    np.testing.assert_array_equal(
        qw.scale.numpy().view(np.uint32),
        np.asarray(jw.scale, np.float32).view(np.uint32))


@pytest.mark.parametrize("key,dispatch", CASES, ids=IDS)
def test_expert_ste_forward_and_gradients(key, dispatch):
    """``moe._expert_mm`` under a training policy against the reference's
    ``_expert_mm`` vmapped over the groups (one group under
    ``sorted_global``, three under ``grouped``): the output and, through
    ``jax.vjp``, the buffer's and the weight's gradients, each within 1e-5
    of its largest magnitude."""
    jcfg, cfg = _configs(key, dispatch)
    G = 3 if dispatch == "grouped" else 1
    bufs, w, g = _expert_operands(G)
    site = "blocks.0.ffn.w_up"

    def ref(b, ww):
        return jax.vmap(lambda bb: jmoe._expert_mm(bb, ww, jcfg.policy,
                                                   site))(b)

    want, vjp = jax.vjp(jax.jit(ref), jnp.asarray(bufs), jnp.asarray(w))
    jgb, jgw = vjp(jnp.asarray(g))
    buf = _stacked(bufs).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = moe._expert_mm(buf, tw, cfg.policy, site, groups=G)
    got.backward(_stacked(g))
    E, C, F = w.shape[0], bufs.shape[2], w.shape[2]
    _close(got.detach().numpy(), _stacked(np.asarray(want)).numpy())
    _close(buf.grad.numpy(), _stacked(np.asarray(jgb)).numpy())
    _close(tw.grad.numpy(), jgw)
    assert got.shape == (E, G * C, F)


def test_expert_products_call_the_kernel_once_per_product(monkeypatch):
    """Under fp8_lns_pallas the three expert products of a layer call the
    K3 wrapper once each with the [E, M, K] x [E, K, N] batch (one launch
    on the card), never expert by expert."""
    calls = []
    real = lm.lns_product_matmul
    monkeypatch.setattr(lm, "lns_product_matmul", lambda x, w, **k: (
        calls.append((tuple(x.shape), tuple(w.shape))) or real(x, w, **k)))
    _, cfg = _configs()
    p = Model(cfg).init(torch.Generator().manual_seed(0))["blocks"][0]
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).to(cfg.pdtype)
    moe.moe_ffn(p["ffn"], x, cfg)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    M = 2 * moe.capacity(16, cfg.top_k, E, cfg.capacity_factor)
    assert calls == [((E, M, D), (E, D, F))] * 2 + [((E, M, F), (E, F, D))]


@pytest.mark.parametrize("n_sm", [132, 114])
def test_tile_rules_count_every_product_of_a_batch(n_sm):
    """K3's and K2's block tiles are chosen over the whole grid of a
    batched launch: one granite expert's [256, 512] output (8 tiles of
    128 x 128, 32 of 64 x 64) leaves the card's SMs idle, so a 2-D launch
    takes the small tiles; 40 experts fill it with 128 x 128 tiles."""
    for M, N in ((256, 512), (256, 1536)):
        assert lm.lns_tile(M, N, n_sm) == 32
        assert lm.dequant_tile(M, N, n_sm) == 64
        assert lm.lns_tile(M, N, n_sm, 40) == 128
        assert lm.dequant_tile(M, N, n_sm, 40) == 128
    assert lm.lns_tile(256, 512, n_sm, 8) == 64   # 8 x 32 tiles of 64
    assert lm.lns_tile(256, 512, n_sm, 3) == 32   # 3 x 32 tiles of 64


# --------------------------------------------------------------------------- #
# The loss, its aux terms and every gradient
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key,dispatch", CASES, ids=IDS)
def test_loss_aux_terms_and_gradients_match_reference(key, dispatch):
    jm, jparams, model, params = _models(key, dispatch)
    batch = _batch(model.cfg)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jparams, jax.tree.map(jnp.asarray, batch))
    req = tree_map(lambda p: p.clone().requires_grad_(True), params)
    loss, aux = model.loss_fn(req, _torch_batch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(req))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for name in ("ce", "moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux[name].detach()),
                                   float(jaux[name]), rtol=1e-5)
    # two MoE layers, each lb >= 1 and z > 0: the sums of both layers
    assert float(aux["moe_lb"].detach()) > 1.5
    assert float(aux["moe_z"].detach()) > 0.0
    it = iter(grads)
    got = tree_map(lambda _: next(it), req)
    assert float(got["blocks"][0]["ffn"]["router"].abs().max()) > 0.0
    _assert_grads_close(got, jgrads, model.cfg)


class _Reductions(TorchDispatchMode):
    """Every reduction by index the autograd graph runs: a scatter-add or
    index-add must not add two values into one destination (so their
    order cannot matter); an accumulating index_put may, when all but one
    of the values are zeros (the dropped pairs' zero gates)."""

    def __init__(self):
        super().__init__()
        self.seen, self.order_dependent = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if "scatter_add" in name or "index_add" in name \
                or "scatter_reduce" in name:
            dim, index = args[1], args[2]
            rows = index.movedim(dim, -1).reshape(-1, index.shape[dim])
            s = rows.sort(-1).values
            if bool((s[:, 1:] == s[:, :-1]).any()):
                self.order_dependent.append(name)
            self.seen.append(name)
        elif "index_put" in name and len(args) > 3 and args[3]:
            (dest,), values = args[1], args[2]
            nonzero = values.reshape(values.shape[0], -1).ne(0).any(-1)
            _, counts = torch.unique(dest[nonzero], return_counts=True)
            if bool((counts > 1).any()):
                self.order_dependent.append(name)
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_layer_backward_sums_in_a_fixed_order(dispatch):
    """The MoE layer's forward and backward add nothing whose result
    depends on the order of an atomic reduction: each token's k pair
    gradients go through ``_GatherPairs`` (added one after another in
    ascending expert id, no scatter-add); the remaining reductions by
    index write distinct destinations or add zeros, on inputs whose
    capacity drops pairs (so the zero gates occur)."""
    _, cfg = _configs("train_fp8", dispatch)
    cfg = dataclasses.replace(cfg, capacity_factor=0.25)
    p = Model(cfg).init(torch.Generator().manual_seed(0))["blocks"][0]
    p = tree_map(lambda t: t.requires_grad_(True), p["ffn"])
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).requires_grad_(True)
    ids = moe.route(p["router"], x.reshape(-1, 32, cfg.d_model)
                    if dispatch == "grouped" else x.reshape(1, 64, -1),
                    cfg.top_k)[3]
    Tg = ids.shape[1]
    C = moe.capacity(Tg, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    assert not bool(moe.dispatch(ids, cfg.n_experts, C)["keep"].all())
    ops = _Reductions()
    with ops:
        out, aux = moe.moe_ffn(p, x, cfg)
        (out.square().sum() + aux["moe_lb"] + aux["moe_z"]).backward()
    assert ops.order_dependent == [] and len(ops.seen) >= 2
    assert float(x.grad.abs().max()) > 0
    assert float(p["router"].grad.abs().max()) > 0


# --------------------------------------------------------------------------- #
# Train steps, kernel calls, kill and resume, the CLI
# --------------------------------------------------------------------------- #
def test_three_train_steps_match_reference():
    """Three AdamW steps under fp8_lns_pallas: losses rtol 1e-5, gradient
    norms rtol 1e-4, the first step's moments within 1e-5 of each leaf's
    largest magnitude; the parameters within 5 % of the largest possible
    move (see ``test_torch_train.py``)."""
    jm, jparams, model, params = _models()
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jsteps.build_train_step(jm, jadamw.OptConfig(**opt)))
    jstate = {"params": jparams, "opt": jadamw.init(jparams)}
    step = steps.build_train_step(model, adamw.OptConfig(**opt))
    state = steps.make_train_state(model, params=params)
    for i in range(3):
        batch = _batch(model.cfg, seed=i)
        jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, metrics = step(state, _torch_batch(batch))
        for name in ("loss", "ce", "moe_lb", "moe_z"):
            np.testing.assert_allclose(float(metrics[name]),
                                       float(jmetrics[name]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-4)
        if i == 0:
            _assert_grads_close(state["opt"]["m"], jstate["opt"]["m"],
                                model.cfg)
            _assert_grads_close(state["opt"]["v"], jstate["opt"]["v"],
                                model.cfg)
    want = params_from_jax(jax.tree.map(np.asarray, jstate["params"]),
                           model.cfg)
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=0.05 * 3 * opt["lr"])


def _lns_loop_policies():
    from repro.numerics import policy as jpolicy
    from repro_torch import numerics

    mm = dict(fmt="e4m3", mode="rne", impl="lns_loop", accum="bf16")
    return (jpolicy.get_policy("train_fp8_lns").replace(
                matmul=jpolicy.OpPolicy(**mm)),
            numerics.get_policy("train_fp8_lns").replace(
                matmul=numerics.OpPolicy(**mm)))


def _counted(monkeypatch, wrappers):
    """Count the 2-D calls of each named K2/K3/K4 wrapper: one per launch
    on the card (K4 runs a batch of expert products one launch each)."""
    calls = {name: 0 for name in wrappers}
    for name in wrappers:
        real = getattr(lm, name)

        def counted(x, w, *a, name=name, real=real, **k):
            if x.ndim == 2 or name != "lns_loop_matmul":
                calls[name] += 1
            return real(x, w, *a, **k)

        monkeypatch.setattr(lm, name, counted)
    return calls


@pytest.mark.parametrize("route", ["lns", "lns_loop"])
def test_kernel_calls_of_a_train_step(monkeypatch, route):
    """A train step calls K3 2 x 7 x n_layers times (the 7 STE products of
    a layer, forward and checkpointed recompute; each expert product one
    batched call) and K2 never; under a matmul impl of lns_loop, K4 runs
    the four attention products and each expert's three products one
    launch each: 2 x (4 + 3 E) x n_layers, K3 never."""
    names = ("lns_product_matmul", "lns_loop_matmul", "dequant_matmul")
    calls = _counted(monkeypatch, names)
    policy = _lns_loop_policies() if route == "lns_loop" else None
    _, _, model, params = _models(policy=policy)
    cfg = model.cfg
    step = steps.build_train_step(model, adamw.OptConfig())
    state = steps.make_train_state(model, params=params)
    _, metrics = step(state, _torch_batch(_batch(cfg)))
    assert all(np.isfinite(float(metrics[k]))
               for k in ("loss", "moe_lb", "moe_z"))
    if route == "lns":
        want = {"lns_product_matmul": 2 * 7 * cfg.n_layers}
    else:
        want = {"lns_loop_matmul": 2 * (4 + 3 * cfg.n_experts)
                * cfg.n_layers}
    assert calls == {name: want.get(name, 0) for name in names}


def _run(tmp_path, name, fault_hook=None, steps_=6):
    _, _, model, params = _models()
    data = pipeline.Dataset(pipeline.DataConfig(
        vocab=model.cfg.vocab, seq_len=16, global_batch=2, kind="arith"))
    logs = []
    state, history = fault.run_training(
        train_step=steps.build_train_step(model, adamw.OptConfig(lr=1e-2)),
        init_state=lambda: steps.make_train_state(model, params=params),
        dataset=data, max_steps=steps_, ckpt_dir=tmp_path / name,
        ckpt_every=2, fault_hook=fault_hook,
        to_device=_torch_batch, log=logs.append)
    return state, history, logs


def test_kill_and_resume_equals_an_uninterrupted_run(tmp_path):
    """A step that fails after the step-2 checkpoint restores it and
    replays the same batches: the final state, routers included, is
    bitwise the uninterrupted run's (one CPU thread), and the aux terms
    are logged."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fired = []

        def crash_once(step):
            if step == 3 and not fired:
                fired.append(step)
                raise RuntimeError("injected crash")

        clean, clean_hist, _ = _run(tmp_path, "clean")
        resumed, hist, logs = _run(tmp_path, "crash", crash_once)
    finally:
        torch.set_num_threads(threads)
    assert fired == [3]
    assert [h["restarts"] for h in hist] == [0, 1, 1]
    assert any("restoring last checkpoint" in line for line in logs)
    assert [h["loss"] for h in hist] == [h["loss"] for h in clean_hist]
    assert all(np.isfinite(h["moe_lb"]) and h["moe_z"] > 0 for h in hist)
    for a, b in zip(tree_leaves(resumed), tree_leaves(clean)):
        assert torch.equal(a, b)


def test_train_cli_trains_granite_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch granite-moe-3b-a800m
    --smoke --device cpu --quant fp8_lns_pallas`` on learnable data: finite
    losses and aux terms, no restart, a checkpoint, and the loss falls."""
    history = train.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--quant",
        "fp8_lns_pallas", "--steps", "12", "--batch", "4", "--seq", "32",
        "--lr", "1e-2", "--ckpt-every", "4", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in history] == [4, 8, 12]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["moe_lb"])
               and h["restarts"] == 0 for h in history)
    assert history[-1]["loss"] < history[0]["loss"]
    assert (tmp_path / "step-12" / "manifest.json").exists()
    assert "[train:cpu] done" in capsys.readouterr().out


def test_shared_experts_and_leading_dense_layers_train():
    """deepseek-v2-lite's shared experts and first_dense layers, refused
    for training until ROADMAP Queue 1 item 11b-train, train on granite's
    smoke config: a step of each returns finite terms and moves the new
    leaves (the shared experts' ``w_down``, the prefix layer's)."""
    _, cfg = _configs()
    batch = _torch_batch(_batch(cfg, B=1, S=8))
    for change, leaf in ((dict(n_shared_experts=2),
                          lambda p: p["blocks"][0]["ffn"]["shared"]["w_down"]),
                         (dict(first_dense=1),
                          lambda p: p["prefix"][0]["ffn"]["w_down"])):
        model = Model(dataclasses.replace(cfg, **change))
        state = steps.make_train_state(
            model, torch.Generator().manual_seed(0))
        before = leaf(state["params"]).clone()
        state, metrics = steps.build_train_step(model, adamw.OptConfig())(
            state, batch)
        assert all(np.isfinite(float(metrics[k]))
                   for k in ("loss", "moe_lb", "moe_z", "grad_norm"))
        assert not torch.equal(leaf(state["params"]), before)
