"""Rank bodies of the tensor-parallel cases of ``test_torch_moe.py``.

Each function runs in a spawned rank process (``launch.mesh.run_ranks``)
and takes that rank's ``Mesh`` first.  Like ``torch_mesh_workers``, whose
engine and prompts it uses, this module imports neither JAX nor the JAX
package.  Every rank runs the TP=1 engine of a case too, in the same
process and thread setting as its mesh engine.
"""
import dataclasses

import torch_mesh_workers as mw
from repro_torch.configs import get_config
from repro_torch.launch import serve

ARCH = "granite-moe-3b-a800m"


def config(policy="serve_fp8_paged"):
    """granite's smoke config with its full routing: 40 experts, top-8."""
    kw = dict(policy=policy) if policy else dict(quant="none")
    return dataclasses.replace(get_config(ARCH, smoke=True, **kw),
                               n_experts=40, top_k=8)


def lively_params(cfg):
    """The TP=1 engine's own draw, every leaf redrawn at std 0.5 (the
    router included), so that streams follow the context."""
    return mw.lively(mw.engine(cfg).params)


def serve_pair(mesh, scheduler: str) -> dict:
    """The same queue through the TP=1 engine and the mesh engine under
    ``scheduler``: both streams, caches (the mesh's gathered) and KV head
    counts."""
    cfg = config()
    params = lively_params(cfg)
    queue = mw.prompts(cfg)
    out = {}
    for tag, m in (("tp1", None), ("tp2", mesh)):
        eng = mw.engine(cfg, m, params)
        outs, _ = serve.run(eng, [q.copy() for q in queue], gen=12,
                            quiet=True, scheduler=scheduler)
        out[tag] = dict(outputs=outs, cache=mw._cache(eng),
                        kv_heads=int(eng.cache["kp"].shape[3]))
    return out


def moe_suite(mesh) -> dict:
    return {s: serve_pair(mesh, s) for s in ("continuous", "bucketed")}
