"""PyTorch port: tensor-parallel serving against itself and the JAX package.

The port runs one process per shard (``launch.mesh``); these tests spawn 2
ranks on gloo over a ``FileStore`` in ``tmp_path`` (no TCP port) with one
intra-op thread each, under a hard time limit (``run_ranks``), and do the
rest in this process:

* TP=2 (concatenation-only sharding, ``parallel``) streams tokens and
  leaves a gathered paged cache bitwise equal to TP=1, with the prefix
  cache on and off, on FP8 pages with stochastic writes and on bf16
  pages, and under static FP8 weights (the reference's
  ``tests/test_serving_distributed.py``); the mesh engine's own static
  draw is the cut of the TP=1 engine's; the TP=2 tokens equal the JAX
  single-device Engine's;
* ``serve_param_pspecs`` / ``serve_cache_pspecs`` / ``serve_hint_specs``
  equal JAX's leaf for leaf, and ``Engine._validate_mesh`` refuses what
  the reference refuses, with its messages;
* ``paged_attention_partials`` (K1's partials mode, its plain version
  here) equals JAX's on the same numpy inputs, and two ranks' halves
  merged by ``combine_partials_psum`` equal JAX's ``paged_attention_batch``
  within the reference's rtol 2e-5 / atol 2e-6;
* the serve CLI's ``--mesh 1x2`` under ``torch.distributed.run`` prints
  the tokens of a run without it.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from repro.configs import get_config as jget_config
from repro.kernels import paged_attention as jpa
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro.models.quantize import quantize_params as jquantize_params
from repro.parallel import hints as jhints
from repro.parallel import sharding as jsharding
from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_production_mesh, parse_mesh_arg
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import Model
from repro_torch.models.quantize import quantize_params
from repro_torch.parallel import hints, sharding

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
SPAWN_TIMEOUT = 150.0  # one spawned mesh run, spawn to join

# (policy, prefix cache) of the bitwise cases
BITWISE = [("serve_fp8_paged", False), ("serve_fp8_paged", True),
           (None, False), (None, True)]
# more bitwise cases: the bucketed scheduler (batched prefills spliced
# into pages: each page's scale from its whole content, the rescale's
# stochastic bits drawn for every KV head), with the prefix cache on
# (tail_prefill), with one rank's KV head 8 times larger than the other's
# and decode unfused (the pages' scales then come from that rank's rows:
# the cross-rank max of the splice and of the unfused writes), the gate
# through K5 (a per-tensor scale over the whole hidden dimension), and a
# vocabulary of 250 padded to 256 (the padded columns masked at their
# global index in the last shard)
MORE = {"bucketed": dict(policy="serve_fp8_paged", scheduler="bucketed"),
        "bucketed-prefix_on": dict(policy="serve_fp8_paged", prefix=True,
                                   scheduler="bucketed"),
        "bucketed-kv_skew": dict(policy="serve_fp8_paged", kv_skew=8.0,
                                 scheduler="bucketed", fused=False),
        "k5-gate": dict(policy="k5", prefix=True),
        "padded-vocab": dict(policy="serve_fp8_paged", vocab=250)}


def _jax_case():
    """The reference engine's streams on its own float32 init, and the
    case that carries those weights to the port's TP=2 engine."""
    jcfg = dataclasses.replace(
        jget_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged"),
        param_dtype="float32")
    jeng = jserve.Engine(jcfg, cache_impl="paged", slots=2, max_seq=64,
                         page_size=8, rng_seed=0, stochastic_kv=True,
                         prefix_cache=True)
    cfg = workers.config(param_dtype="float32")
    queue = workers.prompts(cfg)
    ref, _ = jserve.run(jeng, [q.copy() for q in queue], gen=12, quiet=True,
                        scheduler="continuous")
    np_params = jax.tree.map(np.asarray, jeng.params)
    return ref, dict(policy="serve_fp8_paged", prefix=True,
                     param_dtype="float32", np_params=np_params)


def _partial_inputs():
    """The reference test's page-sharded geometry (full pages)."""
    B, KV, G, hd, page, maxp = 2, 2, 2, 8, 4, 4
    rng = np.random.default_rng(0)
    P = B * maxp + 1
    return dict(
        q=rng.standard_normal((B, KV, G, hd)).astype(np.float32),
        kp=rng.standard_normal((P, page, KV, hd)).astype(np.float32),
        vp=rng.standard_normal((P, page, KV, hd)).astype(np.float32),
        tables=np.arange(1, B * maxp + 1, dtype=np.int32).reshape(B, maxp),
        page=page, KV=KV, G=G)


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """One spawned TP=2 run of every serving case (each rank also runs
    the TP=1 engine of each), the page-sharded combine and the static
    draw; the JAX engine's streams."""
    ref, jax_case = _jax_case()
    cases = ([dict(policy=p, prefix=prefix) for p, prefix in BITWISE]
             + [dict(policy="serve_fp8_paged", static=True), jax_case]
             + list(MORE.values()))
    store = tmp_path_factory.mktemp("mesh") / "store"
    ranks = run_ranks(workers.mesh_suite, 2, init_file=store, backend="gloo",
                      args=(cases, _partial_inputs()),
                      timeout=SPAWN_TIMEOUT)
    return dict(ranks=ranks, jax_ref=ref)


def _assert_bitwise(res):
    tp1, tp2 = res["tp1"], res["tp2"]
    assert tp1["tp"] == 1 and tp2["tp"] == 2
    assert tp2["kv_heads"] * 2 == tp1["kv_heads"]
    assert set(tp1["outputs"]) == set(tp2["outputs"])
    assert tp2["outputs"] == tp1["outputs"]
    for name, t in tp1["cache"].items():
        u = tp2["cache"][name]
        assert u.dtype == t.dtype and torch.equal(u, t), name


@pytest.mark.parametrize("case", range(len(BITWISE)),
                         ids=[f"{p or 'bf16'}-prefix_{'on' if on else 'off'}"
                              for p, on in BITWISE])
def test_tp2_tokens_and_cache_bitwise_equal_tp1(suite, case):
    """The tentpole gate: continuous scheduler, stochastic KV writes on
    FP8 pages, bf16 pages; token streams and the final paged cache
    (codes and scales, gathered over the ranks) bitwise equal to TP=1 on
    both ranks, with the prefix cache on and off."""
    policy, prefix = BITWISE[case]
    for rank in suite["ranks"]:
        res = rank["cases"][case]
        _assert_bitwise(res)
        assert any(len(set(o)) > 1 for o in res["tp1"]["outputs"].values())
        if prefix:
            assert res["tp2"]["hits"] == res["tp1"]["hits"] > 0
        # the mesh engine's gauge and its collectives span
        assert res["tp1"]["gauge"] == res["tp2"]["gauge"] == 1.0
        assert "collectives" in res["tp2"]["phases"]
        assert "sync" in res["tp1"]["phases"]


@pytest.mark.parametrize("name", sorted(MORE))
def test_tp2_bitwise_under_bucketed_scheduler_k5_gate_padded_vocab(suite,
                                                                   name):
    """The bucketed scheduler's spliced pages (prefix off, and on through
    ``tail_prefill``), a policy that quantizes the gate product, and a
    padded vocabulary: TP=2 streams and cache bitwise equal to TP=1's."""
    i = len(BITWISE) + 2 + list(MORE).index(name)
    for rank in suite["ranks"]:
        res = rank["cases"][i]
        _assert_bitwise(res)
        assert any(len(set(o)) > 1 for o in res["tp1"]["outputs"].values())
        if MORE[name].get("prefix"):
            assert res["tp2"]["hits"] == res["tp1"]["hits"] > 0


@pytest.mark.parametrize("head", ["tied", "untied"])
def test_vocab_sharded_logits_mask_the_padding_at_global_columns(suite,
                                                                 head):
    """The LM head's vocab-sharded logits (the tied embedding's rows, an
    untied unembed's columns) are masked at their global column, then
    gathered: bitwise the TP=1 logits, padded columns at NEG."""
    for rank in suite["ranks"]:
        got = rank["logits"][head]
        assert got["masked"] and got["shape"] == (3, 256)
        assert got["equal"], head


def test_tp2_static_weights_bitwise_equal_tp1(suite):
    """Static FP8 weights: codes cut like their weight, scales replicated;
    the streams and the cache equal the TP=1 static engine's, and the
    mesh engine's own draw (each whole weight quantized, then cut) equals
    the cut of the TP=1 engine's."""
    for rank in suite["ranks"]:
        _assert_bitwise(rank["cases"][len(BITWISE)])
        draw = rank["static_draw"]
        assert draw["bad"] == [] and draw["quantized"] > 0, draw


def test_tp2_tokens_equal_jax_engine(suite):
    """The reference Engine's float32 weights carried across: TP=2 (and
    TP=1) streams equal the JAX single-device Engine's."""
    for rank in suite["ranks"]:
        res = rank["cases"][len(BITWISE) + 1]
        _assert_bitwise(res)
        assert res["tp2"]["outputs"] == suite["jax_ref"]


def test_combine_partials_psum_matches_jax_full_batch(suite):
    """Each rank's half of the pages through ``paged_attention_partials``,
    merged by ``combine_partials_psum`` (one all-max, two all-reduce
    sums): allclose to the reference's full-batch attention, at the
    reference's tolerance (the route is allclose, not bitwise)."""
    inp = _partial_inputs()
    B, KV, G, page, maxp = (2, inp["KV"], inp["G"], inp["page"], 4)
    ones = np.ones((inp["kp"].shape[0],), np.float32)
    full = jpa.paged_attention_batch(
        inp["q"], inp["kp"], inp["vp"], ones, ones, inp["tables"],
        np.full((B,), maxp * page, np.int32), fmt=None, mode=None,
        page_size=page, KV=KV, G=G)
    for rank in suite["ranks"]:
        np.testing.assert_allclose(rank["partials"]["split"],
                                   np.asarray(full), rtol=2e-5, atol=2e-6)


# --------------------------------------------------------------------------- #
# A shard's product on the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,M,N", [(torch.bfloat16, 4, 32),
                                       (torch.float32, 1, 16)])
def test_cpu_shard_product_equals_the_whole_products_columns(dtype, M, N):
    """``hints.tp_columns`` on CPU tensors: a rank's block of a
    column-sharded product, bitwise the TP=1 product's columns, over many
    draws at shapes where the CPU's BLAS sums a narrower product in
    another order (float32 [1, 64] x [64, 8] never equals its columns of
    [64, 16]; bf16 [4, 64] x [64, 16] now and then not those of [64, 32])."""
    g = torch.Generator().manual_seed(0)
    for _ in range(300):
        x = (torch.randn(M, 64, generator=g) * 3).to(dtype)
        w = (torch.randn(64, N, generator=g) * 0.5).to(dtype)
        whole = x @ w
        for rank in range(2):
            mesh = types.SimpleNamespace(tp=2, rank=rank)
            part = w[:, rank * N // 2:(rank + 1) * N // 2].contiguous()
            with hints.use_hints(mesh, {}, None):
                got = hints.tp_columns(torch.matmul, x, part, N)
            want = whole[:, rank * N // 2:(rank + 1) * N // 2]
            assert got.shape == want.shape and torch.equal(got, want)


# --------------------------------------------------------------------------- #
# Partials per shard, in this process
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt", [None, "e5m2"])
def test_paged_attention_partials_matches_jax(fmt):
    """One shard's locally combined partials (m, l, o), o un-normalised:
    the port's (K1's partials mode; its plain version on the CPU) against
    the reference's on the same numpy inputs, each half of the pages;
    normalised, they are ``paged_attend``'s attention."""
    B, KV, G, hd, page, maxp = 2, 2, 2, 8, 4, 4
    rng = np.random.default_rng(1)
    P = B * maxp + 1
    tables = rng.permutation(np.arange(1, P)).astype(np.int32).reshape(B,
                                                                       maxp)
    lengths = np.array([maxp * page - 3, 6], np.int32)
    if fmt is None:
        q = rng.standard_normal((B, KV * G, hd)).astype(np.float32)
        kp, vp = (rng.standard_normal((P, page, KV, hd)).astype(np.float32)
                  for _ in range(2))
        ks = vs = np.ones((P,), np.float32)
        q_op, jq_op = (torch.from_numpy(q), None), q
    else:
        from repro_torch.core.quant import encode

        codes = lambda a: encode(torch.from_numpy(a), fmt).numpy()  # noqa
        q = codes(rng.standard_normal((B, KV * G, hd)).astype(np.float32))
        qs = (2.0 ** rng.integers(-2, 3, (B,))).astype(np.float32)
        kp, vp = (codes(rng.standard_normal((P, page, KV, hd))
                        .astype(np.float32)) for _ in range(2))
        ks, vs = ((2.0 ** rng.integers(-2, 3, (P,))).astype(np.float32)
                  for _ in range(2))
        q_op = (torch.from_numpy(q), torch.from_numpy(qs))
        jq_op = (q, qs)
    kw = dict(fmt=fmt, mode="rne", page_size=page, KV=KV, G=G)
    for half in (slice(0, maxp // 2), slice(maxp // 2, maxp)):
        bt = np.ascontiguousarray(tables[:, half])
        ln = np.clip(lengths - half.start * page, 0, (maxp // 2) * page)
        ln = ln.astype(np.int32)
        got = pa.paged_attention_partials(
            q_op, *(torch.from_numpy(a) for a in (kp, vp, ks, vs, bt, ln)),
            **kw)
        want = jpa.paged_attention_partials(jq_op, kp, vp, ks, vs, bt, ln,
                                            **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                       atol=2e-6)
        m, l, o = got
        att = pa.paged_attend(
            *q_op, *(torch.from_numpy(a) for a in (kp, vp, ks, vs, bt, ln)),
            fmt=fmt, mode="rne", KV=KV, G=G)
        torch.testing.assert_close(
            (o / l[..., None]).reshape(att.shape), att, rtol=2e-5, atol=2e-6)


# --------------------------------------------------------------------------- #
# Sharding rules against JAX's
# --------------------------------------------------------------------------- #
def _keys(path):
    out = []
    for e in path:
        for attr in ("key", "idx", "name"):
            if hasattr(e, attr):
                out.append(getattr(e, attr))
                break
    return tuple(out)


def _port_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, path + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_specs(v, path + (i,)))
        return out
    return {path: tree}


def _jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_keys(p): tuple(s) for p, s in flat}


def _stand_in(tp):
    return types.SimpleNamespace(shape={"data": 1, "model": tp},
                                 axis_names=("data", "model"))


SHARD_POLICIES = {
    "default": (),
    "pinned": (("blocks.*.ffn.w_up", "replicate"), ("embed", "replicate"),
               ("blocks.0.attn.wk", "replicate")),
}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("pinned", sorted(SHARD_POLICIES))
def test_param_pspecs_match_jax_leaf_for_leaf(tp, static, pinned):
    """Every leaf's spec equals JAX's ``serve_param_pspecs``: the port's
    per-layer leaves against the reference's stacked blocks (its leading
    ``None`` dropped), QTensor codes like their weight and scales
    replicated, with and without a policy's ``shard_specs``."""
    jcfg = jget_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    cfg = get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    specs = SHARD_POLICIES[pinned]
    jpol = dataclasses.replace(jcfg.policy, shard_specs=specs)
    pol = dataclasses.replace(cfg.policy, shard_specs=specs)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    if static:
        jparams = jquantize_params(jparams, jpol)
        params = quantize_params(params, pol,
                                 period=cfg.layer_pattern_period)
    want = _jax_specs(jsharding.serve_param_pspecs(jcfg, jparams,
                                                   _stand_in(tp), policy=jpol))
    got = _port_specs(sharding.serve_param_pspecs(cfg, params, _stand_in(tp),
                                                  policy=pol))
    period = cfg.layer_pattern_period
    seen = set()
    for path, spec in got.items():
        jpath = (("blocks", path[1] % period) + path[2:]
                 if path[0] == "blocks" else path)
        if path[-1] == "scale":  # a scalar here, [n_blocks, 1, 1] there
            assert "model" not in spec and "model" not in want[jpath], path
        elif path[0] == "blocks":
            assert (None,) + spec == want[jpath], path
        else:
            assert spec == want[path], path
        seen.add(jpath)
    assert seen == set(want)
    # 4 heads split 2 ways, not 4 (2 KV heads); the MLP and vocab both
    wq = [s for p, s in got.items() if "wq" in p and p[-1] != "scale"]
    assert all(("model" in s) == (tp == 2) for s in wq) and wq
    assert ("model" in got[("embed",)]) == (pinned == "default")


def test_concatenation_only_roles_refuse_a_partial_sum():
    """A pinned role whose product would need a cross-shard sum (``wo``
    split by columns, ``w_down`` by rows) is refused, with the site."""
    cfg = get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    for site, role in (("blocks.*.attn.wo", "columns"),
                       ("blocks.0.ffn.w_down", "rows")):
        pol = dataclasses.replace(cfg.policy, shard_specs=((site, role),))
        with pytest.raises(ValueError, match="cross-shard sum"):
            sharding.serve_param_pspecs(cfg, params, _stand_in(2), policy=pol)


def test_cache_and_hint_specs_match_jax():
    """Page codes split over the KV heads, scales replicated; the hint
    roles' specs as the reference's ``PartitionSpec`` tuples."""
    jcfg = jget_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    cfg = get_config("qwen2-0.5b", smoke=True, policy="serve_fp8_paged")
    jcache = JModel(jcfg, max_seq=16).make_paged_cache(2, 5, 4)
    want = _jax_specs(jsharding.serve_cache_pspecs(jcache, _stand_in(2)))
    cache = Model(cfg).make_paged_cache(5, 4, "cpu")
    got = sharding.serve_cache_pspecs(cache, _stand_in(2))
    for path, spec in want.items():
        assert path[0] == "blocks", path
        assert got[path[-1]] == spec, path
    assert set(got) == {p[-1] for p in want}
    jh = {k: tuple(v) for k, v in
          jhints.serve_hint_specs(jcfg, _stand_in(2)).items()}
    assert hints.serve_hint_specs(cfg, _stand_in(2)) == jh


def _refusals():
    fp8 = dict(policy="serve_fp8_paged")
    return [
        ("no model axis", fp8, {}, types.SimpleNamespace(
            shape={"data": 2}, axis_names=("data",)), "paged"),
        ("data axis", fp8, {}, types.SimpleNamespace(
            shape={"data": 2, "model": 2}, axis_names=("data", "model")),
         "paged"),
        ("dense cache", fp8, {}, _stand_in(2), "dense"),
        ("not pure GQA", fp8, dict(family="encdec"), _stand_in(2), "paged"),
        ("heads", fp8, {}, _stand_in(3), "paged"),
        ("d_ff", fp8, dict(n_heads=6, n_kv_heads=3), _stand_in(3), "paged"),
    ]


@pytest.mark.parametrize("case", _refusals(), ids=lambda c: c[0])
def test_validate_mesh_refuses_as_the_reference(case):
    """``Engine(mesh=...)`` refuses, before anything is built, what the
    reference's ``_validate_mesh`` refuses, with the same message."""
    _, kw, changes, mesh, cache_impl = case
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b", smoke=True, **kw),
                               **changes)
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True, **kw),
                              **changes)
    with pytest.raises(ValueError) as want:
        jserve.Engine._validate_mesh(jcfg, mesh, cache_impl)
    with pytest.raises(ValueError) as got:
        serve.Engine(cfg, slots=1, max_seq=16, cache_impl=cache_impl,
                     mesh=mesh, device="cpu")
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------- #
# The CLI and the mesh's own errors
# --------------------------------------------------------------------------- #
CLI = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--policy",
       "serve_fp8_paged", "--requests", "3", "--slots", "2", "--gen", "4",
       "--prompt-len", "2,6", "--prefix-cache", "on", "--shared-prefix", "8",
       "--page-size", "4"]


def _tokens(text):
    return re.findall(r"^  req(\d+): (\[.*\])\.\.\.$", text, re.M)


def test_cli_mesh_under_torchrun_prints_the_single_device_tokens():
    """``--mesh 1x2`` under ``torch.distributed.run --standalone
    --nproc-per-node 2`` (gloo on the CPU): rank 0 alone prints, and its
    tokens are those of the same command without ``--mesh``."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    single = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *CLI], env=env,
        capture_output=True, text=True, timeout=120)
    assert single.returncode == 0, single.stderr
    meshed = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *CLI,
         "--mesh", "1x2"], env=env, capture_output=True, text=True,
        timeout=120)
    assert meshed.returncode == 0, meshed.stderr[-3000:]
    want = _tokens(single.stdout)
    assert len(want) == 3
    assert _tokens(meshed.stdout) == want  # once: rank 0 alone prints
    assert meshed.stdout.count("[serve:continuous") == 1


def test_mesh_arguments_and_world_are_checked(monkeypatch):
    """A bad ``--mesh`` spec, a world without enough processes (the
    message names the torchrun command), and ``--mesh`` on the card with
    fewer cards than ranks are refused with the reason."""
    for spec in ("2", "1x2x2", "ax2", "0x2"):
        with pytest.raises(ValueError, match="DATAxMODEL"):
            parse_mesh_arg(spec)
    assert parse_mesh_arg("1X4") == (1, 4)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        make_production_mesh(shape=(1, 2))
    if torch.cuda.device_count() >= 1:
        pytest.skip("this host has a CUDA device")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cuda",
                    "--mesh", "1x2"])
