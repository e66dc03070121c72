"""Rank bodies of the port's tensor-parallel tests (``test_torch_mesh*.py``).

Each function runs in a spawned rank process (``launch.mesh.run_ranks``)
and takes that rank's ``Mesh`` first.  This module imports neither JAX nor
the JAX package, so the ranks start fast; the test files compare what the
ranks return with the JAX package in the parent process.  Every rank runs
the TP=1 engine of a case too, in the same process and thread setting as
its mesh engine.
"""
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve
from repro_torch.models import params_from_jax
from repro_torch.models.quantize import quantize_params
from repro_torch.parallel import sharding
from repro_torch.serving import ContinuousScheduler, Request, load_snapshot
from repro_torch.serving import save_snapshot


def k5_policy():
    """serve_fp8_paged with the SwiGLU gate product through K5 (the
    elementwise op class quantized per tensor)."""
    from repro_torch.numerics import OpPolicy, get_policy

    return get_policy("serve_fp8_paged").replace(elementwise=OpPolicy(
        fmt="e5m2", mode="rne", impl="auto", accum="f32"))


def config(policy="serve_fp8_paged", param_dtype=None, vocab=None):
    if policy == "k5":
        policy = k5_policy()
    kw = dict(policy=policy) if policy else dict(quant="none")
    cfg = get_config("qwen2-0.5b", smoke=True, **kw)
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    if vocab is not None:  # padded columns then sit in the last shard
        cfg = dataclasses.replace(cfg, vocab=vocab)
    return cfg


def lively(params, seed=0):
    """Every leaf redrawn at std 0.5 (streams then follow the context)."""
    g = torch.Generator().manual_seed(seed)

    def redraw(t):
        if isinstance(t, dict):
            return {k: redraw(v) for k, v in t.items()}
        if isinstance(t, list):
            return [redraw(v) for v in t]
        return (torch.randn(t.shape, generator=g) * 0.5).to(t.dtype)

    return redraw(params)


def prompts(cfg, n=4, shared=16, tail=8, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, cfg.vocab, size=shared)
    return [np.concatenate([s, rng.integers(0, cfg.vocab, size=tail)])
            for _ in range(n)]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def engine(cfg, mesh=None, params=None, device="cpu", **kw):
    """The reference tests' engine: continuous paged serving with
    stochastic KV writes, on ``device`` (the mesh's, on a mesh), on
    ``params`` (a whole tree, cut on a mesh) when given."""
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("rng_seed", 0)
    kw.setdefault("stochastic_kv", True)
    eng = serve.Engine(cfg, cache_impl="paged", mesh=mesh, device=device,
                       **kw)
    if params is not None:
        params = _to(params, eng.device)
        eng.params = (params if mesh is None else
                      sharding.shard_params(cfg, params, mesh, cfg.policy))
    return eng


def _cache(eng):
    return {k: v.clone() for k, v in eng.gather_cache().items()}


def _whole_params(case):
    """The case's whole parameter tree: the reference's (numpy leaves)
    carried across, or the TP=1 engine's own draw made lively; with
    ``kv_skew``, the last KV head's K and V projections scaled by it in
    every layer (its rows then set the pages' scales, and a rank's own
    heads do not)."""
    cfg = config(case["policy"], case.get("param_dtype"), case.get("vocab"))
    if case.get("np_params") is not None:
        return params_from_jax(case["np_params"], cfg)
    params = lively(engine(cfg).params)
    if case.get("kv_skew"):
        for block in params["blocks"]:
            for name in ("wk", "bk", "wv", "bv"):
                block["attn"][name][..., -cfg.hd:] *= case["kv_skew"]
    return params


def serve_case(mesh, case: dict) -> dict:
    """One bitwise case: the same queue through the TP=1 engine and the
    mesh engine; returns both streams and caches (the mesh's gathered),
    the prefix hits and the mesh engine's ``serve_mesh_info`` gauge and
    phase spans."""
    cfg = config(case["policy"], case.get("param_dtype"), case.get("vocab"))
    kw = dict(prefix_cache=case.get("prefix", False),
              static_weights=case.get("static", False),
              fused_decode=case.get("fused", True))
    queue = prompts(cfg, **case.get("prompts", {}))
    gen = case.get("gen", 12)
    params = _whole_params(case)
    if case.get("static"):
        params = quantize_params(params, cfg.policy,
                                 period=cfg.layer_pattern_period)
    out = {}
    for tag, m in (("tp1", None), ("tp2", mesh)):
        eng = engine(cfg, m, params, **kw)
        outs, stats = serve.run(eng, [q.copy() for q in queue], gen=gen,
                                quiet=True,
                                scheduler=case.get("scheduler", "continuous"))
        out[tag] = dict(outputs=outs, cache=_cache(eng),
                        hits=stats["prefix_hit_tokens"], tp=eng.tp_size,
                        kv_heads=int(eng.cache["kp"].shape[3]),
                        gauge=eng.tel.gauge_value(
                            "serve_mesh_info",
                            mesh_shape="1" if m is None else "1x2",
                            tp_size=str(eng.tp_size)),
                        phases=sorted(stats["phases"]))
    return out


def partials_case(mesh, inputs: dict) -> dict:
    """The page-sharded combine: this rank's half of every slot's pages
    through ``paged_attention_partials``, merged across the ranks by
    ``combine_partials_psum``; and this rank's whole-table partials."""
    q = torch.from_numpy(inputs["q"])
    kp, vp = torch.from_numpy(inputs["kp"]), torch.from_numpy(inputs["vp"])
    ones = torch.ones(kp.shape[0])
    tables = torch.from_numpy(inputs["tables"])
    B, maxp = tables.shape
    page, KV, G = inputs["page"], inputs["KV"], inputs["G"]
    half = maxp // mesh.tp
    r = mesh.rank
    kw = dict(fmt=None, mode="rne", page_size=page, KV=KV, G=G)
    m, l, o = pa.paged_attention_partials(
        (q.reshape(B, KV * G, -1), None), kp, vp, ones, ones,
        tables[:, r * half:(r + 1) * half].contiguous(),
        torch.full((B,), half * page, dtype=torch.int32), **kw)
    split = pa.combine_partials_psum(m, l, o, mesh)
    return dict(split=split.numpy(), local=[t.numpy() for t in (m, l, o)])


def static_draw_case(mesh) -> dict:
    """The mesh engine's own static-weight draw against the cut of the
    TP=1 engine's: per leaf, codes and scale bitwise."""
    cfg = config()
    whole = engine(cfg, static_weights=True).params
    mine = engine(cfg, mesh, static_weights=True).params
    want = sharding.shard_params(cfg, whole, mesh, cfg.policy)
    bad, n = [], 0

    def walk(a, b, path):
        nonlocal n
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        else:
            n += 1
            pairs = ([(a.codes, b.codes), (a.scale, b.scale)]
                     if hasattr(a, "codes") else [(a, b)])
            if not all(x.shape == y.shape and torch.equal(x, y)
                       for x, y in pairs):
                bad.append(path)

    walk(mine, want, ())
    quantized = sum(1 for layer in mine["blocks"]
                    for part in ("attn", "ffn")
                    for w in layer[part].values() if hasattr(w, "codes"))
    return dict(leaves=n, bad=bad, quantized=quantized)


def logits_case(mesh) -> dict:
    """The LM head on a padded vocabulary (250 of 256 columns), tied and
    untied, inside the engine's hint context: the gathered logits, the
    padded columns masked at their global index, bitwise equal to TP=1's
    (the engine slices the vocabulary before sampling, so its streams
    cannot show the mask)."""
    from repro_torch.models import Model
    from repro_torch.parallel.hints import serve_hint_specs, use_hints

    out = {}
    for tied in (True, False):
        cfg = dataclasses.replace(config(vocab=250), tie_embeddings=tied)
        model = Model(cfg)
        params = lively(model.init(torch.Generator().manual_seed(1)))
        x = (torch.randn((3, cfg.d_model), generator=torch.Generator()
                         .manual_seed(2))).to(cfg.pdtype)
        whole = model._unembed(params, x)
        with use_hints(mesh, serve_hint_specs(cfg, mesh), cfg):
            mine = model._unembed(
                sharding.shard_params(cfg, params, mesh, cfg.policy), x)
        out["tied" if tied else "untied"] = dict(
            equal=bool(torch.equal(mine, whole)),
            masked=bool((whole[:, cfg.vocab:] == -1.0e30).all()),
            shape=tuple(mine.shape))
    return out


def mesh_suite(mesh, cases, partial_inputs) -> dict:
    return dict(cases=[serve_case(mesh, c) for c in cases],
                partials=partials_case(mesh, partial_inputs),
                static_draw=static_draw_case(mesh),
                logits=logits_case(mesh))


# --------------------------------------------------------------------------- #
# Faults on the mesh
# --------------------------------------------------------------------------- #
def preempt_case(mesh, ckpt_dir) -> dict:
    """A tight pool forces a spill on the mesh engine; a snapshot taken
    while a request sits PREEMPTED restores into a fresh mesh engine.
    Returns the uninterrupted TP=1 run's tokens and both mesh runs'."""
    cfg = config()
    params = _whole_params(dict(policy="serve_fp8_paged"))
    queue = prompts(cfg, n=4, shared=0, tail=6, seed=8)
    geo = dict(slots=3, max_seq=16, page_size=4, num_pages=7)
    ref = engine(cfg, None, params, device=mesh.device, **geo)
    base, _ = serve.run(ref, [q.copy() for q in queue], gen=6, quiet=True,
                        scheduler="continuous")

    def build():
        eng = engine(cfg, mesh, params, **geo)
        return eng, ContinuousScheduler(eng, chunk=4)

    eng, sched = build()
    for i, p in enumerate(queue):
        sched.add(Request(rid=i, prompt=p.copy(), gen=6))
    for _ in range(200):
        sched.step()
        if sched.preempted:
            break
    spilled = len(sched.preempted)
    spill_device = {str(t.device) for r in sched.preempted
                    for t in r.spill["state"].values()}
    save_snapshot(ckpt_dir, eng, sched)
    eng2, sched2 = build()
    step = load_snapshot(ckpt_dir, eng2, sched2)
    restored = (step, sched.steps, len(sched2.preempted))
    out1, out2 = sched.run(), sched2.run()
    eng2.pool.assert_invariants()
    return dict(base=base, out1=out1, out2=out2, spilled=spilled,
                restored=restored, spill_device=sorted(spill_device),
                mesh_device=str(mesh.device),
                kv_heads=int(eng2.cache["kp"].shape[3]))


def _device_only_collectives(device) -> None:
    """Make this process's ``all_gather`` and ``all_reduce`` refuse a
    tensor that is not on ``device``, as NCCL refuses host tensors ("No
    backend type associated with device type cpu"); gloo would take it."""
    import torch.distributed as dist

    for name in ("all_gather", "all_reduce"):
        real = getattr(dist, name)

        def strict(*args, _real=real, _name=name, **kw):
            held = [t for a in args
                    for t in (a if isinstance(a, list) else [a])
                    if isinstance(t, torch.Tensor)]
            for t in held:
                if t.device != device:
                    raise RuntimeError(f"{_name}: a tensor on {t.device}, "
                                       f"the mesh runs on {device}")
            return _real(*args, **kw)

        setattr(dist, name, strict)


def card_preempt_case(mesh, ckpt_dir) -> dict:
    """:func:`preempt_case` with the ranks on the card, its TP=1 run
    there too, and collectives that take tensors on the card only: the
    snapshot gathers the PREEMPTED request's host spills through it."""
    from repro_torch.launch.mesh import CUBLAS_DETERMINISTIC

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC
    _device_only_collectives(mesh.device)
    return preempt_case(mesh, ckpt_dir)


def chaos_case(mesh, ckpt_dir) -> dict:
    """A chaos kill at step 7 on the mesh, the engine rebuilt on the mesh
    and restored from the latest snapshot, against the fault-free TP=1
    run."""
    from repro_torch.runtime import fault
    from repro_torch.serving import FaultPlan

    cfg = config()
    params = _whole_params(dict(policy="serve_fp8_paged"))
    queue = prompts(cfg, n=4, shared=4, tail=4, seed=9)
    geo = dict(slots=2, max_seq=16, page_size=4)
    base, base_stats = fault.run_serving(
        lambda: engine(cfg, None, params, **geo), queue, gen=6,
        log=lambda *a: None)
    out, stats = fault.run_serving(
        lambda: engine(cfg, mesh, params, **geo), queue, gen=6,
        log=lambda *a: None, chaos=FaultPlan(kill_at_step=7),
        ckpt_dir=ckpt_dir, snapshot_every=3)
    return dict(base=base, base_restarts=base_stats["restarts"], out=out,
                restarts=stats["restarts"], killed=stats["chaos"]["killed"],
                finished=stats["terminal"].get("finished", 0),
                restored_from=stats["restored_from"],
                heartbeat=os.path.exists(os.path.join(ckpt_dir,
                                                      "heartbeat.json")))


def reshard_case(mesh, ckpt_root) -> dict:
    """Elastic snapshots: a run snapshotted mid-decode on TP=1 restores
    into a TP=2 engine, and one snapshotted on TP=2 into a TP=1 engine;
    both finish with the uninterrupted run's tokens."""
    cfg = config()
    params = _whole_params(dict(policy="serve_fp8_paged"))
    queue = prompts(cfg)

    def scheduled(m):
        eng = engine(cfg, m, params)
        sched = ContinuousScheduler(eng, chunk=4)
        for i, p in enumerate(queue):
            sched.add(Request(rid=i, prompt=p.copy(), gen=10))
        return sched

    base = scheduled(None).run()
    out = {}
    for src, dst, tag in ((None, mesh, "1->2"), (mesh, None, "2->1")):
        sched = scheduled(src)
        for _ in range(6):  # partway: prefills done, decode in flight
            sched.step()
        pending = sched.pending()
        # a TP=1 engine writes alone: one directory a rank
        d = os.path.join(ckpt_root, tag.replace(">", ""),
                         f"rank{mesh.rank}" if src is None else "mesh")
        save_snapshot(d, sched.eng, sched)
        sched2 = scheduled(dst)
        step = load_snapshot(d, sched2.eng, sched2)
        out[tag] = dict(out=sched2.run(), step=step, at=sched.steps,
                        pending=pending)
    return dict(base=base, runs=out)


def fault_suite(mesh, ckpt_root) -> dict:
    return dict(
        preempt=preempt_case(mesh, os.path.join(ckpt_root, "preempt")),
        chaos=chaos_case(mesh, os.path.join(ckpt_root, "chaos")),
        reshard=reshard_case(mesh, ckpt_root))
