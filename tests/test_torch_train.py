"""PyTorch port: the training path against the JAX package.

The STE matmul, AdamW, the data pipeline, the policies of the ``--quant``
strings, the smoke qwen2 loss and gradients, train steps and the CLI, at
``smoke()`` size with float32 parameters carried across by
``params_from_jax``.

Tolerances: the forward activations pass through FP8 codes, which agree
bitwise where the float inputs do (integer domain); float32 sums (matmuls,
norms, softmax, the global norm) run in other orders in XLA and torch,
about 1e-7 relative per op.  Losses are held to rtol 1e-5, and every
gradient leaf to 1e-5 of its largest magnitude (measured: below 1e-6 for
all three policies).  A last-bit difference in front of a quantizer can
move one activation code; at this size none does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import quant as jquant
from repro.data import pipeline as jpipeline
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro_torch.configs import LEGACY_QUANTS, get_config
from repro_torch.core import quant
from repro_torch.data import pipeline
from repro_torch.kernels import lns_matmul as lm
from repro_torch.launch import train
from repro_torch.models import Model, layers, params_from_jax, transformer
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import fault, steps

POLICIES = {"train_bf16": dict(policy="train_bf16"),
            "fp8_lns_pallas": dict(quant="fp8_lns_pallas"),
            "train_fp8": dict(policy="train_fp8")}


def _lns_loop_policies():
    """train_fp8_lns with every STE matmul through K4 (impl "lns_loop"),
    built as the reference builds a policy: no preset, no flag."""
    from repro.numerics import policy as jpolicy
    from repro_torch import numerics

    mm = dict(fmt="e4m3", mode="rne", impl="lns_loop", accum="bf16")
    return (jpolicy.get_policy("train_fp8_lns").replace(
                matmul=jpolicy.OpPolicy(**mm)),
            numerics.get_policy("train_fp8_lns").replace(
                matmul=numerics.OpPolicy(**mm)))


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", ["lns", "fused", "weight_only"])
def test_ste_qmatmul_forward_and_gradients(case):
    """Forward through FP8 codes; gradients straight through (plain float
    products of the unquantized operands), against ``jax.vjp``.
    Tolerance 1e-5 relative to the output's largest magnitude (float32
    sums in other orders)."""
    args = {"lns": ("e4m3", "e4m3", "lns", True, "rne", "f32"),
            "fused": ("e5m2", "e4m3", "fused_dequant", True, "rne", "bf16"),
            "weight_only": ("e5m2", "e4m3", "auto", False, "rne",
                            "bf16")}[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) * 0.05).astype(np.float32)
    g = rng.standard_normal((12, 24)).astype(np.float32)
    fn = functools.partial(jlayers._ste_qmatmul, act_fmt=args[0],
                           weight_fmt=args[1], impl=args[2],
                           act_quant=args[3], mode=args[4], accum=args[5])
    want, vjp = jax.vjp(lambda a, b: fn(a, b), jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = layers._ste_qmatmul(tx, tw, *args)
    got.backward(torch.from_numpy(g))
    for a, b in ((got.detach(), want), (tx.grad, jgx), (tw.grad, jgw)):
        b = _f32(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def _tree(rng):
    shapes = {"a": (5, 3), "b": [(7,), (2, 2)], "c": {"d": (4,)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return rng.standard_normal(s).astype(np.float32)

    return make(shapes)


def test_adamw_update_matches_reference():
    """Two updates from the same trees, one with clipping active.  The
    global norm sums in another order and ``b ** t`` is another pow:
    rtol 1e-6 on every result."""
    rng = np.random.default_rng(1)
    params, cfg = _tree(rng), adamw.OptConfig(lr=1e-2, warmup_steps=1,
                                              total_steps=5)
    jcfg = jadamw.OptConfig(**dataclasses.asdict(cfg))
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jopt, topt = jadamw.init(jp), adamw.init(tp)
    for scale in (3.0, 0.01):
        grads = jax.tree.map(lambda a: a * scale, _tree(rng))
        jp, jopt, jstats = jadamw.update(jax.tree.map(jnp.asarray, grads),
                                         jopt, jp, jcfg)
        tp, topt, tstats = adamw.update(tree_map(torch.from_numpy, grads),
                                        topt, tp, cfg)
        for a, b in zip(tree_leaves(tp) + tree_leaves(topt["m"])
                        + tree_leaves(topt["v"]),
                        jax.tree.leaves(jp) + jax.tree.leaves(jopt["m"])
                        + jax.tree.leaves(jopt["v"])):
            np.testing.assert_allclose(a.numpy(), _f32(b), rtol=1e-6,
                                       atol=1e-9)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-6)
        assert int(topt["step"]) == int(jopt["step"])


@pytest.mark.parametrize("kind", ["synthetic", "arith", "memmap"])
def test_dataset_batches_bitwise(kind, tmp_path):
    path = None
    if kind == "memmap":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(2).integers(0, 500, 5000).astype(
            np.uint16).tofile(path)
    kw = dict(vocab=500, seq_len=17, global_batch=6, seed=3, kind=kind,
              path=path, n_hosts=2, host_id=1)
    ours = pipeline.Dataset(pipeline.DataConfig(**kw))
    ref = jpipeline.Dataset(jpipeline.DataConfig(**kw))
    for step in (0, 1, 7):
        a, b = ours.batch(step), ref.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.state(5) == ref.state(5)


@pytest.mark.parametrize("quant_str", LEGACY_QUANTS)
def test_quant_strings_resolve_to_the_reference_policies(quant_str):
    ref = jget_config("qwen2-0.5b", quant=quant_str).policy
    port = get_config("qwen2-0.5b", quant=quant_str).policy
    assert port.to_dict() == ref.to_dict()


def test_policy_and_quant_together_raise():
    with pytest.raises(ValueError, match="not both"):
        get_config("qwen2-0.5b", quant="fp8_lns", policy="train_fp8")


def _models(key, n_layers=None):
    if key == "lns_loop":
        jpol, pol = _lns_loop_policies()
        jkw, kw = dict(policy=jpol), dict(policy=pol)
    else:
        jkw = kw = POLICIES[key]
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b", smoke=True, **jkw),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True, **kw),
                              param_dtype="float32")
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


def _assert_grads_close(got_tree, jgrads, cfg):
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    for a, b in zip(tree_leaves(got_tree), tree_leaves(want)):
        b = b.numpy()
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("key", list(POLICIES) + ["lns_loop"])
def test_smoke_loss_and_gradients_match_reference(key):
    jm, jparams, model, params = _models(key)
    batch = _batch(model.cfg)
    (jloss, jaux), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    req = tree_map(lambda p: p.clone().requires_grad_(True), params)
    loss, aux = model.loss_fn(req, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(req))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(jaux["ce"]),
                               rtol=1e-5)
    assert float(aux["moe_lb"]) == float(aux["moe_z"]) == 0.0
    it = iter(grads)
    _assert_grads_close(tree_map(lambda _: next(it), req), jgrads, model.cfg)


def test_first_layer_activation_codes_bitwise():
    """The first STE matmul quantizes rms_norm(embed(tokens)): the port's
    codes and scale equal the reference's bit for bit."""
    jm, jparams, model, params = _models("fp8_lns_pallas")
    toks = _batch(model.cfg)["tokens"]
    jx = jlayers.rms_norm(jm._embed(jparams, jnp.asarray(toks)),
                          jparams["blocks"][0]["ln1"][0])
    x = layers.rms_norm(model._embed(params, torch.from_numpy(toks)),
                        params["blocks"][0]["ln1"])
    want = jquant.quantize(jx.reshape(-1, jx.shape[-1]), "e4m3")
    got = quant.quantize(x.reshape(-1, x.shape[-1]), "e4m3")
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert np.asarray(got.scale).tobytes() == np.asarray(want.scale).tobytes()


def test_k3_launch_count_of_a_train_step(monkeypatch):
    """Each of a layer's 7 STE matmuls calls the K3 wrapper once in the
    forward and once in the checkpointed recompute of its layer: 2 x 7 x
    n_layers calls per step (counted here on the CPU, where the wrapper
    runs its plain version; on the card each call is one launch)."""
    calls = []
    real = lm.lns_product_matmul
    monkeypatch.setattr(lm, "lns_product_matmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, _, model, params = _models("fp8_lns_pallas")
    step = steps.build_train_step(model, adamw.OptConfig())
    state = steps.make_train_state(model, params=params)
    step(state, {k: torch.from_numpy(v)
                 for k, v in _batch(model.cfg).items()})
    assert len(calls) == 2 * 7 * model.cfg.n_layers


def test_k4_launch_count_of_a_train_step(monkeypatch):
    """Under the lns_loop policy every STE matmul calls K4's wrapper once
    in the forward and once in the recompute, and K3's never."""
    calls = {"K4": 0, "K3": 0}
    for name, wrapper in (("K4", "lns_loop_matmul"),
                          ("K3", "lns_product_matmul")):
        real = getattr(lm, wrapper)

        def counted(*a, name=name, real=real, **k):
            calls[name] += 1
            return real(*a, **k)

        monkeypatch.setattr(lm, wrapper, counted)
    _, _, model, params = _models("lns_loop")
    assert model.cfg.policy.matmul.impl == "lns_loop"
    step = steps.build_train_step(model, adamw.OptConfig())
    state = steps.make_train_state(model, params=params)
    _, metrics = step(state, {k: torch.from_numpy(v)
                              for k, v in _batch(model.cfg).items()})
    assert np.isfinite(float(metrics["loss"]))
    assert calls == {"K4": 2 * 7 * model.cfg.n_layers, "K3": 0}


def test_three_train_steps_match_reference():
    """Three AdamW steps from the same parameters under fp8_lns_pallas:
    losses rtol 1e-5, gradient norms rtol 1e-4, the first step's moments
    within 1e-5 of each leaf's largest magnitude.  The parameters after
    three steps are held to 5 % of the largest possible move (3 steps x
    lr): Adam's normalised step m / (sqrt(v) + eps), eps = 1e-8, turns
    last-bit differences of near-zero gradients into differences of order
    lr, which the next steps' gradients then carry."""
    jm, jparams, model, params = _models("fp8_lns_pallas")
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jsteps.build_train_step(jm, jadamw.OptConfig(**opt)))
    jstate = {"params": jparams, "opt": jadamw.init(jparams)}
    step = steps.build_train_step(model, adamw.OptConfig(**opt))
    state = steps.make_train_state(model, params=params)
    for i in range(3):
        batch = _batch(model.cfg, seed=i)
        jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jmetrics["grad_norm"]), rtol=1e-4)
        if i == 0:
            _assert_grads_close(state["opt"]["m"], jstate["opt"]["m"],
                                model.cfg)
    want = params_from_jax(jax.tree.map(np.asarray, jstate["params"]),
                           model.cfg)
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=0.05 * 3 * opt["lr"])


def test_train_cli_on_cpu(tmp_path, capsys):
    history = train.main([
        "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--quant",
        "fp8_lns_pallas", "--steps", "4", "--batch", "2", "--seq", "16",
        "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in history] == [2, 4]
    assert all(np.isfinite(h["loss"]) and h["restarts"] == 0
               for h in history)
    assert (tmp_path / "history.json").exists()
    assert (tmp_path / "step-4" / "manifest.json").exists()
    assert "[train:cpu] done" in capsys.readouterr().out


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="FSDP/TP"):
        train.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                    "--mesh", "2x1", "--ckpt-dir", str(tmp_path)])
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              remat_policy="dots")
    with pytest.raises(NotImplementedError, match="remat_policy 'dots'"):
        transformer.stack_forward([], torch.zeros((1, 2, cfg.d_model)), cfg,
                                  positions=torch.arange(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "qwen2-0.5b", "--smoke", "--ckpt-dir",
                        str(tmp_path)])


def _run(tmp_path, name, fault_hook=None, steps_=6):
    _, _, model, params = _models("fp8_lns_pallas")
    data = pipeline.Dataset(pipeline.DataConfig(
        vocab=model.cfg.vocab, seq_len=16, global_batch=2, kind="arith"))
    logs = []
    state, history = fault.run_training(
        train_step=steps.build_train_step(model, adamw.OptConfig(lr=1e-2)),
        init_state=lambda: steps.make_train_state(model, params=params),
        dataset=data, max_steps=steps_, ckpt_dir=tmp_path / name,
        ckpt_every=2, fault_hook=fault_hook,
        to_device=lambda b: {k: torch.from_numpy(v) for k, v in b.items()},
        log=logs.append)
    return state, history, logs


def test_kill_and_resume_equals_an_uninterrupted_run(tmp_path):
    """A step that fails after the step-2 checkpoint restores it and
    replays the same batches: the final state is bitwise the
    uninterrupted run's (one CPU thread, so the float sums keep their
    order), and the restart is counted and logged."""
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
    for a, b in zip(tree_leaves(resumed), tree_leaves(clean)):
        assert torch.equal(a, b)
    # a process restart resumes from the last checkpoint on disk
    again, hist2, logs2 = _run(tmp_path, "crash", steps_=8)
    assert [h["step"] for h in hist2] == [8]
    assert "resumed from checkpoint at step 6" in logs2[0]


def test_watchdog_and_launch_errors_are_not_hidden(tmp_path):
    wd = fault.StepWatchdog(0.0)
    wd.check()  # no step in flight
    wd.start()
    with pytest.raises(TimeoutError):
        wd.check()

    def refused(step):
        from repro_torch.kernels.cuda_build import check_launch

        check_launch(7, "K3")

    with pytest.raises(RuntimeError, match="K3 launch failed"):
        _run(tmp_path, "refused", refused)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 30.0)])
def test_chunked_attention_matches_reference(window, cap):
    """Several q and kv chunks, ragged padding, GQA: rtol = atol = 1e-5
    (float32 online softmax in the same chunk order)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 13, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 13, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 13, 2, 8)).astype(np.float32)
    kw = dict(causal=True, window=window, cap=cap, q_chunk=4, kv_chunk=6)
    want = jlayers.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = layers.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-5,
                               atol=1e-5)
