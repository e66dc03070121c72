"""PyTorch port: jamba-v0.1-52b (a hybrid stack: Mamba2's SSD mixer in
seven layers of each eight, GQA attention in the eighth, 16 experts top-2
on every odd layer and a dense MLP on every even one) served, against JAX
and against the port's own bitwise contracts.

At Jamba's smoke widths (16 layers, two periods of 8; d_model 64, 4/2
heads of 16, 8 experts top-2 of d_ff 64 and MLPs of 128, SSD d_state 16
and 8 heads of 16), the same numpy inputs go through the reference and
the port:

* the config, ``params_from_jax`` (the reference stacks each pattern
  index's leaves over its blocks: an SSD, an attention, an MoE and an
  MLP layout side by side) and ``Model.init``'s tree;
* each layer's mixer, FFN and policy site against ``layer_specs``;
* the attention layers' write keys and noise against the reference's
  key chain, bitwise: attention layer ``i`` folds block ``i // 8``'s key
  with its pattern index 4, and the SSD layers take none;
* the engine's first-step logits against the JAX engine's (float32
  parameters) under ``serve_fp8_paged`` (stochastic E5M2 pages, whose
  codes and scales are then bitwise the reference's outside the null
  page) and the default policy (bf16 pages);
* each scheduler's streams against the JAX engine's where no slot is
  reused, and a reused slot starting from the zero state;
* static weights (MoE and MLP FFNs, SSD projections, attention) through
  K2's and K3's plain versions against the reference's kernels.

Then the port's contracts on lively weights, each bitwise: a rerun,
preempt/restore == a worst-case pool, fused == unfused, bucketed on the
paged cache == on the dense cache; the preemption spill and a snapshot
round trip while PREEMPTED, pages, scales and SSD leaves together; the
refusals (the prefix cache and a mesh, as in the reference) and the
serve CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro.models.transformer import layer_specs
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.core.quant import QTensor
from repro_torch.launch import serve
from repro_torch.models import Model, params_from_jax, transformer
from repro_torch.models.model import attention_layers
from repro_torch.serving import (ContinuousScheduler, Request, load_snapshot,
                                 save_snapshot)
from test_torch_mamba2 import STREAM_CASES
from test_torch_mesh import _stand_in
from test_torch_mla import _flat, _jf, _lively, _np
from test_torch_static_weights import _matmul_policy
from torch_cpu_threads import one_torch_thread  # noqa: F401

ARCH = "jamba-v0.1-52b"
LOGIT_TOL = 2e-4
PAGE_LEAVES = ("kp", "vp", "ks", "vs")
SSD_LEAVES = ("conv", "state")


def _cfgs(policy="serve_fp8_paged", **changes):
    kw = dict(policy=policy) if policy else dict(quant="none")
    return (dataclasses.replace(jget_config(ARCH, smoke=True, **kw),
                                **changes),
            dataclasses.replace(get_config(ARCH, smoke=True, **kw),
                                **changes))


def _engines(policy, **geo):
    """The JAX engine and the port's on its float32 parameters."""
    jcfg, cfg = _cfgs(policy, param_dtype="float32")
    jeng = jserve.Engine(jcfg, **geo)
    eng = serve.Engine(cfg, device="cpu", **geo)
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    return jeng, eng


# --------------------------------------------------------------------------- #
# The config, the pattern, the parameters
# --------------------------------------------------------------------------- #
def test_config_pattern_and_sites_match_layer_specs():
    """The full config is the reference's; every layer's mixer, FFN and
    policy site follow the reference's ``layer_specs``: attention at i %
    8 == 4, experts on odd layers, an MLP on even ones, ``blocks.{i %
    8}``; so the paged cache holds pages for the attention layers and
    SSD leaves for the rest."""
    for smoke in (False, True):
        cfg = get_config(ARCH, smoke=smoke)
        ref = jget_config(ARCH, smoke=smoke)
        assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
                cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.n_experts, cfg.top_k,
                cfg.moe_d_ff, cfg.ssm_state, cfg.layer_pattern_period) == \
            (ref.family, ref.n_layers, ref.d_model, ref.n_heads,
             ref.n_kv_heads, ref.hd, ref.d_ff, ref.n_experts, ref.top_k,
             ref.moe_d_ff, ref.ssm_state, ref.layer_pattern_period)
        _, pattern, n_blocks = layer_specs(ref)
        assert n_blocks * len(pattern) == cfg.n_layers
        for i in range(cfg.n_layers):
            spec = pattern[i % len(pattern)]
            assert transformer.mixer_kind(cfg, i) == spec.mixer, i
            assert transformer.ffn_kind(cfg, i) == spec.ffn, i
            assert transformer.layer_site(cfg, i) == f"blocks.{i % 8}"
        assert attention_layers(cfg) == list(range(4, cfg.n_layers, 8))
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.hd, full.n_kv_heads,
            full.n_heads // full.n_kv_heads) == (32, 4096, 128, 8, 4)
    assert [transformer.ffn_kind(full, i) for i in range(4)] == \
        ["mlp", "moe", "mlp", "moe"]
    _, cfg = _cfgs()
    cache = Model(cfg).make_paged_cache(5, 4, "cpu", slots=2)
    assert cache["kp"].shape[0] == 2 and cache["conv"].shape[0] == 14


def test_params_from_jax_and_init():
    """The reference's tree, its block leaves stacked per pattern index,
    comes across as one dict per layer, leaf for leaf (float32 SSD
    ``A_log``, ``Dskip``, ``dt_bias``, the router float32, 3-D experts);
    ``Model.init`` draws the same tree of shapes and dtypes."""
    jcfg, cfg = _cfgs()
    jparams = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    layers = params["blocks"]
    assert len(layers) == cfg.n_layers
    kinds = {i: (transformer.mixer_kind(cfg, i), transformer.ffn_kind(cfg, i))
             for i in range(cfg.n_layers)}
    for i, layer in enumerate(layers):
        mixer, ffn = kinds[i]
        assert ("mamba" in layer) == (mixer == "mamba")
        assert ("attn" in layer) == (mixer == "attn")
        assert ("router" in layer["ffn"]) == (ffn == "moe")
        j, b = i % 8, i // 8
        for path, t in _flat(layer).items():
            want = _flat(jparams["blocks"][j])[path][b]
            np.testing.assert_array_equal(_np(t), _jf(want))
    for name in ("A_log", "Dskip", "dt_bias"):
        assert layers[0]["mamba"][name].dtype == torch.float32
    assert layers[1]["ffn"]["router"].dtype == torch.float32
    assert layers[1]["ffn"]["w_up"].ndim == 3
    own = Model(cfg).init(torch.Generator().manual_seed(0))
    assert {p: (tuple(t.shape), t.dtype) for p, t in _flat(own).items()} \
        == {p: (tuple(t.shape), t.dtype) for p, t in _flat(params).items()}


# --------------------------------------------------------------------------- #
# The attention layers' keys and noise
# --------------------------------------------------------------------------- #
def test_attention_write_keys_and_noise_follow_the_reference():
    """``Model.kv_noise`` draws one entry per attention layer, in order,
    each bitwise the reference's chain: the stream key folded with 0 (the
    block stack), split over the blocks, block ``b``'s key folded with
    the attention layer's pattern index 4, split into K and V, folded
    with each slot's write position, then ``randint`` over (KV, hd)."""
    _, cfg = _cfgs()
    model = Model(cfg)
    stream = jax.random.fold_in(jax.random.PRNGKey(0 + 17), 0)
    pos = np.asarray([[0, 5, 16, 31], [1, 6, 17, 2]], np.int32)  # [T, B]
    port = model.kv_noise(torch.from_numpy(np.array(stream)),
                          torch.from_numpy(pos))
    n_attn = len(attention_layers(cfg))
    assert port.shape == (2, n_attn, 2, 4, cfg.n_kv_heads, cfg.hd)
    blocks = jax.random.split(jax.random.fold_in(stream, 0),
                              cfg.n_layers // 8)
    for a, layer in enumerate(attention_layers(cfg)):
        kk, vk = jax.random.split(jax.random.fold_in(blocks[layer // 8],
                                                     layer % 8))
        for kv, key in enumerate((kk, vk)):
            for t in range(pos.shape[0]):
                keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
                    key, jnp.asarray(pos[t]))
                ref = jax.vmap(lambda kb: jax.random.randint(
                    kb, (cfg.n_kv_heads, cfg.hd), 0, 1 << 21,
                    dtype=jnp.uint32))(keys)
                np.testing.assert_array_equal(
                    np.asarray(ref), port[t, a, kv].numpy(),
                    err_msg=f"layer {layer} {'kv'[kv]} t {t}")
    # the splice's per-layer keys: each attention layer its block's
    eng = serve.Engine(cfg, slots=2, max_seq=8, page_size=4, device="cpu")
    key = prng.prng_key(5)
    want = prng.split(key, cfg.n_layers // 8)
    assert torch.equal(eng._layer_keys(key), want)


# --------------------------------------------------------------------------- #
# The engine against the JAX engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["serve_fp8_paged", None],
                         ids=["serve_fp8_paged", "default"])
def test_engine_first_step_logits_match_jax_engine(policy):
    """A prefill chunk (4 and 3 tokens) and one decode step on the JAX
    engine's float32 parameters: logits within 2e-4; the attention
    layers' pages and scales bitwise the reference's outside the null
    page (stochastic E5M2 writes under serve_fp8_paged: the same keys and
    noise), beside the SSD layers' dense per-slot leaves."""
    jeng, eng = _engines(policy, slots=2, max_seq=16, page_size=8,
                         rng_seed=3)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, eng.cfg.vocab, size=(2, 4)).astype(np.int32)
    got, want = [], []
    for e, out in ((jeng, want), (eng, got)):
        e.pool.ensure_capacity_batch(np.asarray([4, 3]))
        out.append(e.step_chunk(toks, np.zeros(2, np.int32),
                                np.asarray([4, 3], np.int32)))
        out.append(e.step_chunk(toks[:, :1], np.asarray([4, 3], np.int32),
                                np.asarray([1, 1], np.int32)))
    np.testing.assert_allclose(np.stack(got), np.stack(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert set(eng.cache) == set(PAGE_LEAVES + SSD_LEAVES)
    n_attn = len(attention_layers(eng.cfg))
    assert eng.cache["kp"].shape[0] == n_attn
    assert eng.cache["state"].shape[:2] == (eng.cfg.n_layers - n_attn, 2)
    ref = jeng.cache["blocks"][4]["self"]
    for name in PAGE_LEAVES:
        want_t = np.asarray(ref[name])
        got_t = eng.cache[name].float().numpy() if policy is None \
            else eng.cache[name].numpy()
        if name in ("kp", "vp"):
            want_t, got_t = want_t[:, 1:], got_t[:, 1:]
        np.testing.assert_allclose(got_t, np.asarray(want_t, got_t.dtype),
                                   rtol=0, atol=0 if policy else 1e-6,
                                   err_msg=name)


def _stream_setup(quant, slots):
    kw = (dict(quant=quant) if quant == "fp8_w8kv8"
          else dict(policy=quant))
    jcfg = jget_config(ARCH, smoke=True, **kw)
    cfg = get_config(ARCH, smoke=True, **kw)
    rng = np.random.default_rng(1)
    queue = [rng.integers(0, cfg.vocab, size=3 + 2 * (i % 2))
             for i in range(3)]
    geo = dict(slots=slots, max_seq=10, page_size=4, stochastic_kv=False)
    return jcfg, cfg, queue, geo


def _streams(jcfg, cfg, queue, geo, cases):
    """{(package, scheduler, cache kind): streams} on the JAX engine's
    parameters, chunk 2, 4 generated."""
    out, params = {}, None
    for sched, impl in cases:
        jeng = jserve.Engine(jcfg, cache_impl=impl, **geo)
        if params is None:
            params = params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                     cfg)
        out["jax", sched, impl], _ = jserve.run(
            jeng, [q.copy() for q in queue], gen=4, quiet=True,
            scheduler=sched, chunk=2)
        eng = serve.Engine(cfg, device="cpu", cache_impl=impl, **geo)
        eng.params = params
        out["port", sched, impl], _ = serve.run(
            eng, [q.copy() for q in queue], gen=4, quiet=True,
            scheduler=sched, chunk=2)
    return out


def test_each_scheduler_matches_the_jax_engine():
    """``fp8_w8kv8`` (the reference's scheduler tests' policy), max_seq
    10, page 4, deterministic KV rounding, chunk 2, 4 generated, 3
    prompts of 3 and 5 tokens, a slot for each request: each scheduler
    and cache kind of the port gives the JAX engine's streams of the
    same scheduler and cache kind on the same parameters."""
    out = _streams(*_stream_setup("fp8_w8kv8", slots=3), STREAM_CASES)
    for sched, impl in STREAM_CASES:
        assert out["port", sched, impl] == out["jax", sched, impl], \
            (sched, impl)


def test_a_reused_slot_starts_from_the_zero_state(monkeypatch):
    """With 2 slots the third request takes a slot the first one used.
    The port zeroes the slot's SSD leaves at every admission, so its
    continuous streams equal its bucketed ones and the JAX engine's
    bucketed ones; without that reset they are the JAX engine's
    continuous streams (whose scheduler never resets a state: ROADMAP.md
    Queue 3), bitwise."""
    jcfg, cfg, queue, geo = _stream_setup("fp8_w8kv8", slots=2)
    out = _streams(jcfg, cfg, queue, geo, STREAM_CASES[:2])
    assert out["port", "continuous", "paged"] == \
        out["port", "bucketed", "paged"] == out["jax", "bucketed", "paged"]
    monkeypatch.setattr(serve.Engine, "_clear_slot", lambda self, slot: None)
    leaky = _streams(jcfg, cfg, queue, geo, STREAM_CASES[:1])
    assert leaky["port", "continuous", "paged"] == \
        out["jax", "continuous", "paged"]


@pytest.mark.parametrize("impl", ["fused_dequant", "lns"])
def test_static_weights_through_the_kernels_match_reference(impl):
    """Static codes (the SSD projections, attention, the MLPs and the
    experts) under a policy that quantizes matmuls (K2 for
    ``fused_dequant``, K3 for ``lns``; their plain versions here, the
    reference's Pallas kernels interpreted): a bucketed prefill's logits
    and the next dense decode step's within rtol = atol = 2e-4 of the
    reference's, and the same greedy tokens."""
    jpol, pol = _matmul_policy(impl)
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True),
                               numerics=jpol, param_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), numerics=pol,
                              param_dtype="float32")
    jeng = jserve.Engine(jcfg, slots=2, max_seq=12, cache_impl="dense",
                         static_weights=True)
    eng = serve.Engine(cfg, slots=2, max_seq=12, cache_impl="dense",
                       device="cpu")
    eng.params = params_from_jax(jax.tree.map(np.asarray, jeng.params), cfg)
    layers = eng.params["blocks"]
    for leaf in (layers[0]["mamba"]["w_B"], layers[1]["ffn"]["w_up"],
                 layers[4]["attn"]["wq"], layers[4]["ffn"]["w_down"]):
        assert isinstance(leaf, QTensor)
    prompts = [np.arange(4) + 7, np.arange(4) + 30]
    jfirst, _ = jeng.prefill_batch(prompts, [0, 1])
    first, _ = eng.prefill_batch(prompts, [0, 1])
    assert first.tolist() == jfirst.tolist()
    pos = np.asarray([4, 4])
    want = jeng.decode(np.asarray(jfirst), pos)
    got = eng.decode(first, pos)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert got.argmax(-1).tolist() == want.argmax(-1).tolist()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("axis", [None, -1, (0, 2)])
def test_quantize_in_slabs_equals_one_pass(monkeypatch, dtype, axis):
    """``quantize`` encodes a slab of ``ENCODE_SLAB`` elements at a time (a
    jamba expert stack would need ~40 GB of int64 temporaries at once):
    the codes and the scale are bitwise those of one pass, per tensor and
    per channel, and per tensor they are the reference's ``quantize``."""
    from repro.core import quant as jquant
    from repro_torch.core import quant

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 12, 7)).astype(np.float32)
                         * 0.02).to(getattr(torch, dtype))
    x[2, 3, 4] = 0.5                    # the absmax in one slab of many
    one = quant.quantize(x, "e4m3", axis=axis)
    monkeypatch.setattr(quant, "ENCODE_SLAB", 170)  # slabs of 2, 2, 1 rows
    slabs = quant.quantize(x, "e4m3", axis=axis)
    assert torch.equal(slabs.codes, one.codes)
    assert torch.equal(slabs.scale, one.scale)
    if axis is None:
        want = jquant.quantize(jnp.asarray(x.float().numpy()), "e4m3")
        np.testing.assert_array_equal(slabs.codes.numpy(),
                                      np.asarray(want.codes))
        np.testing.assert_array_equal(slabs.scale.numpy(),
                                      np.asarray(want.scale))


# --------------------------------------------------------------------------- #
# The port's own bitwise contracts
# --------------------------------------------------------------------------- #
def _prompts(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(s))
            for s in rng.integers(4, 14, size=n)]


@pytest.fixture(scope="module")
def lively():
    _, cfg = _cfgs()
    params = _lively(Model(cfg).init(torch.Generator().manual_seed(0)))
    return cfg, params


def _engine(cfg, params, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 24)
    kw.setdefault("page_size", 4)
    eng = serve.Engine(cfg, rng_seed=0, device="cpu", **kw)
    eng.params = params
    return eng


def _run(cfg, params, queue, scheduler="continuous", **kw):
    eng = _engine(cfg, params, **kw)
    return serve.run(eng, [q.copy() for q in queue], gen=8, quiet=True,
                     scheduler=scheduler)


CONTRACTS = ["rerun", "preempt", "bucketed-paged-dense", "fused-unfused"]


@pytest.mark.parametrize("contract", CONTRACTS)
def test_bitwise_contracts_hold_on_jamba(contract, lively):
    """Each pair of token streams bitwise equal on lively weights (FP8
    pages, stochastic writes); the streams vary."""
    cfg, params = lively
    queue = _prompts(cfg)
    if contract == "rerun":
        (a, _), (b, _) = (_run(cfg, params, queue) for _ in range(2))
    elif contract == "preempt":
        (a, sa), (b, _) = (_run(cfg, params, queue, num_pages=6),
                           _run(cfg, params, queue))
        assert sa["preemptions"] >= 1 and sa["restores"] >= 1
    elif contract == "bucketed-paged-dense":
        (a, _), (b, _) = (_run(cfg, params, queue, "bucketed",
                               cache_impl=impl) for impl in ("paged", "dense"))
    else:
        (a, _), (b, _) = (_run(cfg, params, queue, fused_decode=f)
                          for f in (True, False))
    assert a == b
    assert sum(len(set(o)) > 1 for o in b.values()) >= len(b) - 1


def test_preempt_spills_and_restores_pages_and_states_verbatim(lively):
    """A preempted slot's pages (codes and scales of the attention layers)
    and its SSD rows leave as copies at the spill and come back into
    another slot, on fresh pages, bitwise."""
    cfg, params = lively
    eng = _engine(cfg, params)
    eng.pool.ensure_capacity_batch(np.asarray([5, 5]))
    eng.step_chunk(np.arange(10).reshape(2, 5).astype(np.int32),
                   np.zeros(2, np.int32), np.asarray([5, 5], np.int32))
    pages = list(eng.pool.pages_of[0])
    before = {k: (t[:, 0] if k in SSD_LEAVES else t[:, pages]).clone()
              for k, t in eng.cache.items()}
    record = eng.preempt_slot(0)
    assert set(record["state"]) == set(PAGE_LEAVES + SSD_LEAVES)
    for k, t in record["state"].items():
        want = before[k][:, None] if k in SSD_LEAVES else before[k]
        assert torch.equal(t, want), k
    eng.release(1)
    for t in eng.cache.values():
        t.zero_()
    eng.restore_slot(1, record)
    new = list(eng.pool.pages_of[1])
    for k, t in eng.cache.items():
        got = t[:, 1] if k in SSD_LEAVES else t[:, new]
        assert torch.equal(got, before[k]), k


def test_snapshot_roundtrip_while_preempted(lively, tmp_path):
    """A snapshot taken while a request sits PREEMPTED (its pages and SSD
    rows spilled to the host) restores into a fresh engine: every cache
    leaf and spill tensor ``torch.equal``, and both finish alike."""
    cfg, params = lively
    queue = _prompts(cfg, n=4, seed=3)

    def build():
        eng = _engine(cfg, params, num_pages=6)
        return eng, ContinuousScheduler(eng, chunk=4)

    eng, sched = build()
    for i, p in enumerate(queue):
        sched.add(Request(rid=i, prompt=p.copy(), gen=8))
    for _ in range(200):
        sched.step()
        if sched.preempted:
            break
    else:
        pytest.fail("the pool never forced a preemption")
    save_snapshot(tmp_path, eng, sched)
    eng2, sched2 = build()
    assert load_snapshot(tmp_path, eng2, sched2) == sched.steps
    assert set(eng2.cache) == set(PAGE_LEAVES + SSD_LEAVES)
    for name, t in eng.cache.items():
        assert torch.equal(eng2.cache[name], t), name
    for r, r2 in zip(sched.preempted, sched2.preempted):
        assert set(r.spill["state"]) == set(PAGE_LEAVES + SSD_LEAVES)
        for name, t in r.spill["state"].items():
            assert torch.equal(r2.spill["state"][name], t), name
    assert sched2.run() == sched.run()


def test_cli_serves_jamba(capsys):
    """``--arch jamba-v0.1-52b`` through the serve CLI on the CPU: the
    default policy (bf16 pages), serve_fp8_paged, and the bucketed
    scheduler on the dense cache."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--gen", "4", "--prompt-len", "3,7"]
    runs = [serve.main(base + extra) for extra in (
        [], ["--policy", "serve_fp8_paged"],
        ["--scheduler", "bucketed", "--cache-impl", "dense"])]
    for outputs in runs:
        assert sorted(outputs) == [0, 1, 2]
        assert all(len(o) == 4 for o in outputs.values())
    assert "[serve:continuous:cpu] 3 requests" in capsys.readouterr().out


def test_prefix_cache_and_mesh_are_refused():
    """As in the reference: the prefix cache and mesh serving need a
    pure-GQA paged cache, and a hybrid stack keeps dense per-slot SSD
    states."""
    jcfg, cfg = _cfgs()
    for eng_cls, c, kw in ((jserve.Engine, jcfg, {}),
                           (serve.Engine, cfg, dict(device="cpu"))):
        with pytest.raises(ValueError, match="pure-GQA paged KV cache"):
            eng_cls(c, slots=2, max_seq=8, prefix_cache=True, **kw)
    for mod, c in ((jserve, jcfg), (serve, cfg)):
        assert not mod.Engine.prefix_cache_supported(c)
        with pytest.raises(ValueError, match="pure-GQA paged cache"):
            mod.Engine._validate_mesh(c, _stand_in(2), "paged")
