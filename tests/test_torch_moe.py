"""PyTorch port: the MoE family (granite-moe-3b-a800m) against JAX and
against the port's own bitwise contracts.

``models.moe`` is held against ``repro.models.moe`` on the same numpy
inputs at granite's routing (40 experts, top-8) and a narrow width
(d_model 128, moe_d_ff 64), bf16 activations and weights, float32
router:

* the routing and the dispatch are integers and are held bitwise: each
  token's expert ids (in the reference's ``jax.lax.top_k`` order), each
  sorted pair's token, expert, rank and keep flag, and the capacity C.
  Routing is discrete, so a seed counts only where every gap between
  adjacent ones of a token's k + 1 largest probabilities exceeds 1e-6
  (the two float32 router products differ by ~1e-7); each test asserts
  that about its own inputs;
* the output within two bf16 ulps of the largest magnitude (rtol = atol
  = 2^-7 of it): bf16 expert products summed in another order; the aux
  losses within rtol 1e-5.

The engine's float32 first-step logits are held against the JAX engine's
(rtol = atol = 2e-4, the dense family's), and the port's contracts are
held bitwise on granite's smoke config with 40 experts and top-8:
fused == unfused, prefix on == off, preempt/restore == a worst-case pool,
bucketed fused == unfused, static weights == the decoded bf16 weights,
TP=2 == TP=1 under both schedulers (two spawned gloo ranks), and a chaos
kill's survivors == the fault-free streams.  Then the split-K guard
(``launch.mesh.require_column_stable_cublas``) and the training entry
points, which refused experts before MoE training was ported and now
train granite (its training is held against JAX in
``test_torch_moe_train.py``).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_mesh_workers as mw
import torch_moe_workers as workers
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.models.quantize import quantize_params as jquantize_params
from repro.models.quantize import resolve_weight as jresolve_weight
from repro.parallel import sharding as jsharding
from repro_torch.core.quant import QTensor
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import Model, moe, params_from_jax
from repro_torch.models.quantize import quantize_params, resolve_weight
from repro_torch.parallel import sharding
from repro_torch.runtime import fault, steps
from repro_torch.serving import FaultPlan
from test_torch_mesh import _jax_specs, _port_specs, _stand_in
from torch_cpu_threads import one_torch_thread  # noqa: F401

ARCH = workers.ARCH
ROUTE_GAP = 1e-6       # adjacent top-(k+1) probabilities at least this far
AUX_RTOL = 1e-5
LOGIT_TOL = 2e-4
SPAWN_TIMEOUT = 150.0


def _narrow(dispatch="grouped", factor=1.25):
    """granite's routing at a narrow width, in both packages."""
    kw = dict(d_model=128, moe_d_ff=64, n_experts=40, top_k=8,
              capacity_factor=factor, moe_dispatch=dispatch)
    return (dataclasses.replace(jget_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def _to_torch(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return {k: conv(v) for k, v in tree.items()}


def _inputs(B, S, seed, skew=0.0):
    """bf16 activations x [B, S, 128] and the reference's MoE leaves.
    ``skew`` adds a shared direction to every token and aligns experts
    0-3's router columns with it, so that every token routes to them and
    capacity drops pairs."""
    jcfg, _ = _narrow()
    p = dict(jmoe.moe_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, 128)).astype(np.float32)
    if skew:
        u = np.zeros(128, np.float32)
        u[:8] = 1.0
        x = x + 3.0 * u
        router = np.array(p["router"])
        router[:, :4] += skew * u[:, None]
        p["router"] = jnp.asarray(router)
    return jnp.asarray(x, jnp.bfloat16), p


def _jax_routing(p, xg, k, E, C):
    """The reference's routing and dispatch of each group xg [G, Tg, D]
    (its ``_dispatch_group`` lines), as numpy."""
    out = dict(ids=[], tok=[], eid=[], rank=[], keep=[], probs=[])
    for xf in xg:
        logits = xf.astype(jnp.float32) @ p["router"]
        probs = jax.nn.softmax(logits, axis=-1)
        _, ids = jax.lax.top_k(probs, k)
        flat = ids.reshape(-1)
        order = jnp.argsort(flat, stable=True)
        eid = flat[order]
        starts = jnp.searchsorted(eid, jnp.arange(E))
        rank = jnp.arange(flat.shape[0]) - starts[eid]
        for name, v in (("ids", ids), ("tok", order // k), ("eid", eid),
                        ("rank", rank), ("keep", rank < C),
                        ("probs", probs)):
            out[name].append(np.asarray(v))
    return {n: np.stack(v) for n, v in out.items()}


def _assert_routing_is_decided(probs, k):
    """Every token's k + 1 largest probabilities are at least
    ``ROUTE_GAP`` apart (the seed counts)."""
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    assert np.diff(-top, axis=-1).min() > ROUTE_GAP


CASES = [(d, S, f) for d in ("grouped", "sorted_global") for S in (1, 16)
         for f in (1.25, 0.25)]


@pytest.mark.parametrize("dispatch,S,factor", CASES,
                         ids=[f"{d}-S{S}-cf{f}" for d, S, f in CASES])
def test_moe_ffn_matches_jax(dispatch, S, factor):
    """Routing, dispatch and C bitwise, the output and the aux losses
    within tolerance; with S = 16 the skewed inputs send every token to
    experts 0-3, so both capacity factors drop pairs (at factor 0.25 the
    global dispatch's C is 8 instead of 16); with S = 1 a grouped row
    routes alone and nothing drops."""
    jcfg, cfg = _narrow(dispatch, factor)
    B, E, k = 4, cfg.n_experts, cfg.top_k
    jx, jp = _inputs(B, S, seed=1, skew=0.1 if S > 1 else 0.0)
    xg = jx if dispatch == "grouped" else jx.reshape(1, B * S, 128)
    Tg = xg.shape[1]
    C = moe.capacity(Tg, k, E, factor)
    assert C == jmoe.capacity(Tg, k, E, factor)
    want = _jax_routing(jp, xg, k, E, C)
    _assert_routing_is_decided(want["probs"], k)

    p = _to_torch(jp)
    x = _to_torch({"x": jx})["x"]
    tg = x if dispatch == "grouped" else x.reshape(1, B * S, 128)
    _, _, _, ids = moe.route(p["router"], tg, k)
    np.testing.assert_array_equal(ids.numpy(), want["ids"])
    d = moe.dispatch(ids, E, C)
    for name in ("tok", "eid", "rank", "keep"):
        np.testing.assert_array_equal(d[name].numpy(), want[name])
    dropped = int((~d["keep"]).sum())
    assert (dropped > 0) == (S > 1)

    out, aux = moe.moe_ffn(p, x, cfg)
    jout, jaux = jmoe.moe_ffn(jp, jx, jcfg)
    jo = np.asarray(jout.astype(jnp.float32))
    tol = 2.0**-7 * np.abs(jo).max()
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, 128)
    np.testing.assert_allclose(out.float().numpy(), jo, rtol=2.0**-7,
                               atol=tol)
    for name in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=AUX_RTOL)


@pytest.mark.parametrize("T,k,E,factor", [(1, 8, 40, 1.25), (16, 8, 40, 1.25),
                                          (64, 8, 40, 0.25), (95, 8, 40, 1.25),
                                          (4096, 2, 8, 1.0)])
def test_capacity_equals_reference(T, k, E, factor):
    assert moe.capacity(T, k, E, factor) == jmoe.capacity(T, k, E, factor)


@pytest.mark.parametrize("tie", ["all", "pairs"])
def test_top_k_ties_pick_the_lower_index(tie):
    """Equal probabilities: the port's ids equal ``jax.lax.top_k``'s,
    which takes the lower expert id first."""
    k, E = 8, 40
    if tie == "all":
        logits = np.zeros((3, 5, E), np.float32)
    else:  # pairs of equal logits straddling the k-th place
        rng = np.random.default_rng(0)
        logits = np.repeat(rng.standard_normal((3, 5, E // 2)), 2,
                           axis=-1).astype(np.float32)
    router = np.eye(E, dtype=np.float32)
    _, _, _, ids = moe.route(torch.from_numpy(router),
                             torch.from_numpy(logits), k)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jax.lax.top_k(probs, k)[1]))
    if tie == "all":
        assert (ids.numpy() == np.arange(k)).all()


@pytest.mark.parametrize("S", [1, 16])
def test_a_slots_output_does_not_depend_on_the_other_slots(S):
    """Grouped dispatch: row 0's output is bitwise unchanged when the
    other rows' inputs change (the product shapes depend on the row count
    and C only)."""
    _, cfg = _narrow()
    jx, jp = _inputs(4, S, seed=2)
    p, x = _to_torch(jp), _to_torch({"x": jx})["x"]
    first, _ = moe.moe_ffn(p, x, cfg)
    other = x.clone()
    other[1:] = torch.randn(other[1:].shape,
                            generator=torch.Generator().manual_seed(5)) * 3
    second, _ = moe.moe_ffn(p, other.to(torch.bfloat16), cfg)
    assert torch.equal(first[0], second[0])
    assert not torch.equal(first[1:], second[1:])


class _NoCollectives:
    """A TP=2 mesh stand-in whose every collective fails the test."""
    tp, rank, shape = 2, 0, {"data": 1, "model": 2}

    def _refuse(self, *a, **kw):
        raise AssertionError("the MoE layer issued a collective")

    all_gather = all_max = all_sum = local = _refuse


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        accumulate = (func.__name__.startswith("index_put")
                      and (kwargs.get("accumulate")
                           or (len(args) > 3 and args[3])))
        self.seen.append((str(func), bool(accumulate)))
        return func(*args, **kwargs)


@pytest.mark.parametrize("dispatch", ["grouped", "sorted_global"])
def test_no_atomic_scatter_add_and_no_collective(dispatch):
    """The layer writes its buffers by assignment and sums the combine in
    order: no scatter-add, index-add or accumulating index_put; inside a
    mesh's hint context it issues no collective (the experts run whole
    on every rank)."""
    from repro_torch.parallel.hints import serve_hint_specs, use_hints

    _, cfg = _narrow(dispatch)
    jx, jp = _inputs(2, 16, seed=1, skew=0.1)
    p, x = _to_torch(jp), _to_torch({"x": jx})["x"]
    ops = _Ops()
    with use_hints(_NoCollectives(), serve_hint_specs(cfg, _stand_in(2)),
                   cfg), ops:
        moe.moe_ffn(p, x, cfg)
    names = [n for n, _ in ops.seen]
    assert not [n for n in names if "scatter_add" in n or "index_add" in n
                or "scatter_reduce" in n]
    assert not [n for n, acc in ops.seen if acc]
    assert any("index_put" in n for n in names)  # the dispatch writes


# --------------------------------------------------------------------------- #
# Parameters: the reference's tree, static weights, sharding roles
# --------------------------------------------------------------------------- #
def _granite(policy="serve_fp8_paged", **changes):
    kw = dict(policy=policy) if policy else dict(quant="none")
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True, **kw),
                               n_experts=40, top_k=8, **changes)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True, **kw),
                              n_experts=40, top_k=8, **changes)
    return jcfg, cfg


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _flat(sub, path + (i,)).items()}
    return {path: tree}


def test_params_from_jax_and_init_carry_the_expert_leaves():
    """The reference's stacked MoE leaves come across per layer, 3-D and
    float32 as they are; ``Model.init`` draws the same tree."""
    jcfg, cfg = _granite()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    for i, layer in enumerate(params["blocks"]):
        ffn = layer["ffn"]
        assert ffn["router"].dtype == torch.float32
        assert tuple(ffn["router"].shape) == (D, E)
        assert tuple(ffn["w_gate"].shape) == tuple(ffn["w_up"].shape) == \
            (E, D, F)
        assert tuple(ffn["w_down"].shape) == (E, F, D)
        for name in ffn:
            want = np.asarray(jparams["blocks"][0]["ffn"][name][i])
            np.testing.assert_array_equal(ffn[name].float().numpy(),
                                          want.astype(np.float32))
    own = Model(cfg).init(torch.Generator().manual_seed(0))
    shape = {p: (tuple(t.shape), t.dtype) for p, t in _flat(own).items()}
    assert shape == {p: (tuple(t.shape), t.dtype)
                     for p, t in _flat(params).items()}
    assert 0.018 < float(own["blocks"][0]["ffn"]["w_up"].float().std()) \
        < 0.022


def test_quantize_params_expert_leaves_bitwise():
    """Static weights: the 3-D experts' codes and per-layer scale equal
    the reference's per-block ones, the router stays float32, and
    ``resolve_weight`` decodes [E, D, F] as the reference does."""
    jcfg, cfg = _granite()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(3))
    jq = jquantize_params(jparams, jcfg.policy)
    want = params_from_jax(jax.tree.map(np.asarray, jq), cfg)
    got = quantize_params(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg), cfg.policy,
                          period=cfg.layer_pattern_period)
    n_q = 0
    for path, w in _flat(got).items():
        if path[-1] == "router":
            assert not isinstance(w, QTensor) and w.dtype == torch.float32
        v = _flat(want)[path]
        if isinstance(w, QTensor):
            n_q += 1
            assert torch.equal(w.codes, v.codes) and w.scale.shape == ()
            assert torch.equal(w.scale, v.scale) and w.fmt == v.fmt
        else:
            assert torch.equal(w, v)
    assert n_q == 7 * cfg.n_layers
    jw = jq["blocks"][0]["ffn"]["w_gate"]
    one = jax.tree.map(lambda a: a[1], jw)
    np.testing.assert_array_equal(
        resolve_weight(got["blocks"][1]["ffn"]["w_gate"]).float().numpy(),
        np.asarray(jresolve_weight(one).astype(jnp.float32)))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("static", [False, True])
def test_sharding_roles_equal_reference_serve_pspecs(tp, static):
    """granite's serve roles equal the reference's ``serve_param_pspecs``
    leaf for leaf: the 3-D experts and the router replicate, attention
    and vocab shard as in the dense family; ``_validate_mesh`` admits it
    in both packages."""
    jcfg, cfg = _granite()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    if static:
        jparams = jquantize_params(jparams, jcfg.policy)
        params = quantize_params(params, cfg.policy,
                                 period=cfg.layer_pattern_period)
    want = _jax_specs(jsharding.serve_param_pspecs(jcfg, jparams,
                                                   _stand_in(tp)))
    got = _port_specs(sharding.serve_param_pspecs(cfg, params,
                                                  _stand_in(tp)))
    for path, spec in got.items():
        jpath = ("blocks", 0) + path[2:] if path[0] == "blocks" else path
        if path[-1] == "scale":
            assert "model" not in spec and "model" not in want[jpath], path
        elif path[0] == "blocks":
            assert (None,) + spec == want[jpath], path
            assert path[2] != "ffn" or "model" not in spec, path
        else:
            assert spec == want[path], path
    full = get_config(ARCH)
    jserve.Engine._validate_mesh(jget_config(ARCH), _stand_in(tp), "paged")
    serve.Engine._validate_mesh(full, _stand_in(tp), "paged")


# --------------------------------------------------------------------------- #
# The engine against the JAX engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("pages", ["fp8", "float32"])
def test_engine_first_step_logits_match_jax_engine(pages):
    """A prefill chunk and one decode step of the smoke engine (float32
    parameters carried across from the JAX engine) on FP8 pages with
    stochastic writes, or float32 pages: logits within 2e-4."""
    policy = "serve_fp8_paged" if pages == "fp8" else None
    jcfg, cfg = _granite(policy, param_dtype="float32")
    jeng = jserve.Engine(jcfg, slots=2, max_seq=16, page_size=8,
                         rng_seed=3)
    eng = serve.Engine(cfg, slots=2, max_seq=16, page_size=8, rng_seed=3,
                       device="cpu")
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 4)).astype(np.int32)
    got, want = [], []
    for e, out in ((jeng, want), (eng, got)):
        e.pool.ensure_capacity_batch(np.asarray([4, 3]))
        out.append(e.step_chunk(toks, np.zeros(2, np.int32),
                                np.asarray([4, 3], np.int32)))
        out.append(e.step_chunk(toks[:, :1], np.asarray([4, 3], np.int32),
                                np.asarray([1, 1], np.int32)))
    np.testing.assert_allclose(np.stack(got), np.stack(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


# --------------------------------------------------------------------------- #
# The port's own bitwise contracts on granite
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """One spawn of two gloo ranks: each serves granite under both
    schedulers on its mesh engine and on the TP=1 engine."""
    store = tmp_path_factory.mktemp("moe_mesh") / "store"
    return run_ranks(workers.moe_suite, 2, init_file=store, backend="gloo",
                     timeout=SPAWN_TIMEOUT)


def _run(cfg, params, queue, scheduler="continuous", **kw):
    eng = mw.engine(cfg, None, params, **kw)
    outs, stats = serve.run(eng, [q.copy() for q in queue], gen=12,
                            quiet=True, scheduler=scheduler)
    return outs, stats


def _static_pair(cfg, params, queue):
    """Static FP8 weights against the bf16 weights decoded from the very
    same codes."""
    codes = quantize_params(params, cfg.policy,
                            period=cfg.layer_pattern_period)
    decoded = {p: resolve_weight(w, dtype=cfg.pdtype)
               if isinstance(w, QTensor) else w
               for p, w in _flat(codes).items()}

    def unflat(tree, path=()):
        if isinstance(tree, dict):
            return {k: unflat(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [unflat(v, path + (i,)) for i, v in enumerate(tree)]
        return decoded[path]

    a, _ = _run(cfg, codes, queue, static_weights=True)
    b, _ = _run(cfg, unflat(codes), queue)
    return a, b


def _chaos_pair(cfg, params, queue, ckpt):
    geo = dict(slots=2, max_seq=48, page_size=8)
    base, _ = fault.run_serving(lambda: mw.engine(cfg, None, params, **geo),
                                queue, gen=8, log=lambda *a: None)
    out, stats = fault.run_serving(
        lambda: mw.engine(cfg, None, params, **geo), queue, gen=8,
        log=lambda *a: None, chaos=FaultPlan(kill_at_step=9),
        ckpt_dir=ckpt, snapshot_every=3)
    assert stats["restarts"] == 1 and stats["chaos"]["killed"] == 1
    assert stats["terminal"]["finished"] == len(queue)
    return out, base


CONTRACTS = ["fused", "prefix", "preempt", "bucketed-fused", "static",
             "tp2-continuous", "tp2-bucketed", "chaos"]


@pytest.mark.parametrize("contract", CONTRACTS)
def test_bitwise_contracts_hold_on_granite(contract, tp_runs, tmp_path):
    """Each pair of token streams bitwise equal, on lively weights (every
    leaf at std 0.5) so that the streams follow the context; the TP
    cases' caches (gathered over the ranks) bitwise equal too."""
    if contract.startswith("tp2"):
        for rank in tp_runs:
            res = rank[contract.split("-")[1]]
            tp1, tp2 = res["tp1"], res["tp2"]
            assert tp2["kv_heads"] * 2 == tp1["kv_heads"]
            assert tp2["outputs"] == tp1["outputs"]
            assert any(len(set(o)) > 1 for o in tp1["outputs"].values())
            for name, t in tp1["cache"].items():
                assert torch.equal(tp2["cache"][name], t), name
        return
    cfg = workers.config()
    params = workers.lively_params(cfg)
    queue = mw.prompts(cfg)
    if contract == "fused":
        (a, _), (b, _) = (_run(cfg, params, queue, fused_decode=f)
                          for f in (True, False))
    elif contract == "prefix":
        (a, sa), (b, _) = (_run(cfg, params, queue, prefix_cache=on)
                           for on in (True, False))
        assert sa["prefix_hit_tokens"] > 0
    elif contract == "preempt":
        (a, sa), (b, _) = (_run(cfg, params, queue, num_pages=n)
                           for n in (8, None))
        assert sa["preemptions"] >= 1 and sa["restores"] >= 1
    elif contract == "bucketed-fused":
        (a, _), (b, _) = (_run(cfg, params, queue, "bucketed",
                               fused_decode=f) for f in (True, False))
    elif contract == "static":
        a, b = _static_pair(cfg, params, queue)
    else:
        a, b = _chaos_pair(cfg, params, mw.prompts(cfg, n=4, shared=4,
                                                   tail=4, seed=9),
                           tmp_path / "ck")
    assert a == b
    assert sum(len(set(o)) > 1 for o in b.values()) >= len(b) - 1


# --------------------------------------------------------------------------- #
# The split-K guard, and what is refused
# --------------------------------------------------------------------------- #
VAR = "CUBLAS_WORKSPACE_CONFIG"


@pytest.mark.parametrize("device,initialised,before,after", [
    ("cpu", True, None, None),            # nothing for the CPU
    ("cpu", False, ":4096:8", ":4096:8"),
    ("cuda", False, None, ":0:0"),        # set before the first CUDA call
    ("cuda", True, ":0:0", ":0:0"),       # already the setting
    ("cuda", False, ":4096:8", "raises"),  # another setting
    ("cuda", True, None, "raises"),       # cuBLAS may already run split-K
])
def test_column_stable_cublas_guard(monkeypatch, device, initialised, before,
                                    after):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialised)
    if before is None:
        monkeypatch.delenv(VAR, raising=False)
    else:
        monkeypatch.setenv(VAR, before)
    if after == "raises":
        with pytest.raises(RuntimeError, match=f"{VAR}=:0:0"):
            tmesh.require_column_stable_cublas(device)
        return
    tmesh.require_column_stable_cublas(device)
    assert os.environ.get(VAR) == after


def test_serve_cli_requires_column_stable_cublas_on_every_run(monkeypatch):
    """The serve CLI calls the guard for every run, not only under
    ``--mesh``, before anything touches the device, and so does every
    ``Engine`` (here with the CPU, where it does nothing)."""
    seen = []
    monkeypatch.setattr(serve, "require_column_stable_cublas", seen.append)
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "2", "--slots", "2", "--gen", "2", "--prompt-len", "3"])
    assert seen == ["cpu", torch.device("cpu")]


def test_training_with_experts_trains(tmp_path):
    """The three entry points that refused a config with experts until
    ROADMAP Queue 1 item 11a (training) was ported now train granite:
    ``Model.loss_fn`` and a step of ``steps.build_train_step`` return
    finite aux terms (the sums over both MoE layers), and the training
    CLI runs; with shared experts (item 11b-train) a step trains too."""
    _, cfg = _granite(None)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.arange(8, dtype=torch.int64).view(1, 8),
             "labels": torch.arange(1, 9, dtype=torch.int64).view(1, 8)}
    loss, aux = model.loss_fn(params, batch)
    assert set(aux) == {"ce", "moe_lb", "moe_z"}
    assert all(bool(torch.isfinite(v)) for v in (loss, *aux.values()))
    assert float(aux["moe_lb"]) > 0 and float(aux["moe_z"]) > 0
    from repro_torch.optim import adamw

    step = steps.build_train_step(model, adamw.OptConfig())
    _, metrics = step(steps.make_train_state(model, params=params), batch)
    assert all(bool(torch.isfinite(metrics[k]))
               for k in ("loss", "moe_lb", "moe_z", "grad_norm"))
    history = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--steps", "1", "--batch", "1", "--seq", "8",
                          "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in history] == [1]
    assert np.isfinite(history[0]["moe_lb"]) and history[0]["moe_z"] > 0
    shared = Model(dataclasses.replace(cfg, n_shared_experts=1))
    params = shared.init(torch.Generator().manual_seed(0))
    assert "shared" in params["blocks"][0]["ffn"]
    step = steps.build_train_step(shared, adamw.OptConfig())
    new, metrics = step(steps.make_train_state(shared, params=params), batch)
    assert all(bool(torch.isfinite(metrics[k]))
               for k in ("loss", "moe_lb", "moe_z", "grad_norm"))
    moved = new["params"]["blocks"][0]["ffn"]["shared"]["w_down"]
    assert not torch.equal(moved, params["blocks"][0]["ffn"]["shared"][
        "w_down"].to(moved.dtype))
