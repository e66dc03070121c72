"""Serving sharding rules: which parameter and cache dimensions a
tensor-parallel engine splits, and the functions that cut and gather.

Port of the serving half of ``repro.parallel.sharding``
(``tp_size``, ``_div``, ``serve_param_pspecs``, ``serve_cache_pspecs``).
Concatenation-only: ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` split
by output columns, the embedding by vocab rows (a lookup reads its
owner's row), an untied ``unembed`` by vocab columns; ``wo``, ``w_down``
and every norm and bias replicate.  A spec is the reference's
``PartitionSpec`` as a tuple of axis names (``None`` replicated), one
entry per dimension of the port's leaf: the port keeps one dict per
layer where the reference stacks blocks, so its block specs drop the
reference's leading ``None``.  Static-weight ``codes`` shard like their
weight and ``scale`` replicates.  The paged cache ``{kp, vp: [L, P, page,
KV, hd], ks, vs: [L, P]}`` splits its page codes over the KV heads and
replicates the per-page scales.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from ..core.quant import QTensor

__all__ = ["tp_size", "serve_param_pspecs", "serve_cache_pspecs",
           "param_role", "spec_for", "cut", "shard_params", "place_cache",
           "gather_cache"]

# the roles a weight may take and keep every product a concatenation: a
# projection read by the gathered activations shards its output columns
# (or stays whole); ``wo``/``w_down`` read gathered inputs whole
_CONCAT_ROLES = {
    "embed": ("rows", "replicate"),
    "unembed": ("columns", "replicate"),
    "wq": ("columns", "replicate"), "wk": ("columns", "replicate"),
    "wv": ("columns", "replicate"),
    "w_gate": ("columns", "replicate"), "w_up": ("columns", "replicate"),
}


def tp_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _site(path: Tuple, period: int) -> str:
    """A leaf path's policy site: layer ``i`` of the port's block list is
    the reference's ``blocks.{i % period}``."""
    keys = [str(k % period) if isinstance(k, int) else str(k) for k in path]
    return ".".join(keys)


def param_role(cfg, path: Tuple, shape, tp: int, policy=None) -> str:
    """"columns", "rows" or "replicate" for the weight at ``path`` (e.g.
    ``("blocks", 3, "attn", "wq")``) of ``shape``: the reference's
    ``default_role``, then ``policy.shard_specs``.  Raises for a pinned
    role whose product would need a cross-shard sum."""
    name = path[-1]
    if len(shape) <= 1:  # biases / norm scales
        return "replicate"
    head_tp = _div(cfg.n_heads, tp) and _div(cfg.n_kv_heads, tp)
    vocab_tp = _div(cfg.vocab_padded, tp)
    if name == "embed":
        role = "rows" if vocab_tp else "replicate"
    elif name == "unembed":
        role = "columns" if vocab_tp else "replicate"
    elif name in ("wq", "wk", "wv") and head_tp:
        role = "columns"
    elif name in ("w_gate", "w_up") and _div(cfg.d_ff, tp) and len(shape) == 2:
        role = "columns"
    else:
        role = "replicate"
    if policy is not None and policy.shard_specs:
        override = policy.resolve_shard(_site(path, cfg.layer_pattern_period))
        if override is not None:
            role = override
    if tp > 1 and role != "replicate" and role not in _CONCAT_ROLES.get(name, ()):
        raise ValueError(
            f"{_site(path, cfg.layer_pattern_period)}: role {role!r} would "
            "need a cross-shard sum; tensor-parallel serving shards only "
            f"what concatenates ({name!r} takes "
            f"{_CONCAT_ROLES.get(name, ('replicate',))})")
    return role


def spec_for(role: str, ndim: int) -> tuple:
    if role == "columns":
        return (None,) * (ndim - 1) + ("model",)
    if role == "rows":
        return ("model",) + (None,) * (ndim - 1)
    return (None,) * ndim


def _map(tree, fn: Callable, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def serve_param_pspecs(cfg, params, mesh, policy=None):
    """The spec tree of ``params`` (the port's parameter dict): a tuple
    per tensor leaf, ``{"codes", "scale"}`` specs per ``QTensor`` leaf."""
    tp = tp_size(mesh)

    def rule(path, leaf):
        if isinstance(leaf, QTensor):
            role = param_role(cfg, path, leaf.codes.shape, tp, policy)
            return {"codes": spec_for(role, leaf.codes.ndim),
                    "scale": (None,) * leaf.scale.ndim}
        return spec_for(param_role(cfg, path, leaf.shape, tp, policy),
                        leaf.ndim)

    return _map(params, rule)


def serve_cache_pspecs(cache, mesh):
    """The paged cache's specs: page codes split over the KV heads, scales
    replicated.  Block tables stay host-side, each rank uploading its
    own copy."""
    return {name: ((None, None, None, "model", None) if name in ("kp", "vp")
                   else (None,) * t.ndim)
            for name, t in cache.items()}


def cut(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a contiguous copy), or
    ``t`` itself when the spec replicates it."""
    if tp_size(mesh) == 1 or "model" not in spec:
        return t
    return mesh.local(t, spec.index("model")).contiguous()


def cut_leaf(cfg, path: Tuple, leaf, mesh, policy=None) -> Any:
    """One parameter leaf (a tensor or a ``QTensor``) cut to this rank."""
    tp = tp_size(mesh)
    if isinstance(leaf, QTensor):
        role = param_role(cfg, path, leaf.codes.shape, tp, policy)
        return QTensor(codes=cut(leaf.codes, spec_for(role, leaf.codes.ndim),
                                 mesh),
                       scale=leaf.scale, fmt=leaf.fmt)
    return cut(leaf, spec_for(param_role(cfg, path, leaf.shape, tp, policy),
                              leaf.ndim), mesh)


def shard_params(cfg, params, mesh, policy=None):
    """A whole parameter tree (e.g. the TP=1 engine's) cut to this rank's
    shard: the sharded leaves copied, the replicated ones shared."""
    return _map(params, lambda path, leaf: cut_leaf(cfg, path, leaf, mesh,
                                                    policy))


def place_cache(cache, mesh):
    """The whole (mesh-independent) paged cache cut to this rank's KV
    heads; the scales are shared."""
    specs = serve_cache_pspecs(cache, mesh)
    return {name: cut(t, specs[name], mesh) for name, t in cache.items()}


def gather_cache(cache, mesh):
    """This rank's paged cache gathered into the whole one (every rank
    takes part; each gets the whole cache)."""
    if tp_size(mesh) == 1:
        return dict(cache)
    specs = serve_cache_pspecs(cache, mesh)
    return {name: (mesh.all_gather(t, specs[name].index("model"))
                   if "model" in specs[name] else t)
            for name, t in cache.items()}
