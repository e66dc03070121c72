"""Tensor-parallel hint roles of the serving engine, as a context.

Port of ``repro.parallel.hints``.  Model code calls ``hint(x, role)`` at
the reference's sites; the engine of a mesh activates a (mesh, role ->
spec, config) context around its model calls (:func:`use_hints`).
Outside any context, or on a mesh of one shard, every call here returns
its input: tests and single-device runs are unaffected.

The reference states a layout and lets XLA move the data; the port runs
one process per shard (``launch.mesh``), so a hint moves the data itself,
exactly:

* a sharded role (``tp_heads``, ``tp_kv``, ``ffn_hidden``: a ``"model"``
  entry in the spec) checks that ``x`` holds this rank's block of the
  sharded dimension, and cuts it when ``x`` is whole (a weight that a
  policy's ``shard_specs`` pinned to "replicate");
* a gathering role (``tp_gather``, ``ffn_gather``: fully replicated in
  the spec) all-gathers the shards before the ``wo`` / ``w_down``
  contraction, which then runs whole on every rank;
* ``logits_decode`` is vocab-sharded in the reference's spec, whose
  host copy gathers it; here every rank samples from the whole row, so
  the role gathers too.

Beside the roles, three per-slot reductions span a sharded dimension and
need the maximum over every rank (:func:`tp_max`): the query scale and the
KV row's page scale (the absmax over all heads), and the per-tensor scale
of a quantized gate product.  The model layer takes them
(``models.attention.gqa_decode_paged``, ``models.layers.gated_mlp``) and
passes them down, as the engine's splice does its pages' maxima, so the
kernel wrappers, the page pool and the numerics API issue no collective.
Random bits drawn for every KV head are cut to this rank's heads by
:func:`tp_local`, and a row-sharded embedding is read by
:func:`tp_lookup`.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict

import torch

__all__ = ["use_hints", "hint", "serve_hint_specs", "tp_size",
           "tp_max", "tp_local", "tp_columns", "tp_lookup", "shard_start"]

_ctx: contextvars.ContextVar = contextvars.ContextVar("shard_hints",
                                                      default=None)

# role -> (the dimension it shards or gathers, the config field of that
# dimension's whole size)
_ROLE_DIMS = {
    "tp_heads": (-2, "n_heads"),         # q [B, S, H, hd]
    "tp_kv": (-2, "n_kv_heads"),         # k/v new [B, S, KV, hd]
    "tp_gather": (-2, "n_heads"),        # attention out [B, S, H, dv]
    "ffn_hidden": (-1, "d_ff"),          # g/u [B, S, F]
    "ffn_gather": (-1, "d_ff"),          # gated h [B, S, F]
    "logits_decode": (-1, "vocab_padded"),  # [B, Vp]
}
_GATHERED = ("tp_gather", "ffn_gather", "logits_decode")


@contextlib.contextmanager
def use_hints(mesh, specs: Dict[str, tuple], cfg=None):
    """Activate ``specs`` (:func:`serve_hint_specs`) on ``mesh`` for the
    model calls inside the block; ``cfg`` gives the roles' whole sizes."""
    token = _ctx.set((mesh, specs, cfg))
    try:
        yield
    finally:
        _ctx.reset(token)


def _mesh():
    state = _ctx.get()
    if state is None or state[0].tp == 1:
        return None
    return state[0]


def hint(x: torch.Tensor, role: str) -> torch.Tensor:
    """Lay ``x`` out as ``role`` says on the active mesh (see the module
    docstring); ``x`` itself outside a context or for an unknown role."""
    state = _ctx.get()
    if state is None:
        return x
    mesh, specs, cfg = state
    spec = specs.get(role)
    if mesh.tp == 1 or spec is None or role not in _ROLE_DIMS:
        return x
    dim, field = _ROLE_DIMS[role]
    whole = getattr(cfg, field)
    part = whole // mesh.tp
    n = x.shape[dim]
    if n not in (whole, part):
        raise ValueError(f"hint {role!r}: dimension {dim} of {tuple(x.shape)} "
                         f"is neither {field}={whole} nor its shard {part}")
    if role in _GATHERED:
        return mesh.all_gather(x, dim) if n == part else x
    return mesh.local(x, dim) if n == whole else x


def serve_hint_specs(cfg, mesh) -> Dict[str, tuple]:
    """Serving-time TP hint roles (concatenation-only sharding), the
    reference's ``PartitionSpec`` entries as tuples: only dimensions whose
    cross-shard combination is a concatenation are sharded (attention
    heads / KV head groups, MLP hidden, vocab columns), and the sharded
    activations are gathered before the ``wo`` / ``w_down`` contractions,
    so every matmul sees whole arrays and no value is ever summed across
    shards."""
    return {
        "act": (None, None, None),                # [B, S, D] replicated
        "tp_heads": (None, None, "model", None),  # q [B, S, H, hd]
        "tp_kv": (None, None, "model", None),     # k/v new [B, S, KV, hd]
        "tp_gather": (),                          # attn out, before wo
        "ffn_hidden": (None, None, "model"),      # g/u [B, S, F]
        "ffn_gather": (None, None, None),         # gated h, before w_down
        "logits_decode": (None, "model"),         # [B, Vp] decode logits
    }


def tp_size() -> int:
    """The active mesh's model-axis size (1 outside a context)."""
    state = _ctx.get()
    return 1 if state is None else state[0].tp


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the active mesh's ranks:
    an absmax taken on a shard becomes the whole tensor's (max is exact
    and order-free, and idempotent on a replicated ``x``)."""
    mesh = _mesh()
    return x if mesh is None else mesh.all_max(x)


def tp_local(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (random bits drawn for
    every KV head, a replicated bias of a column-sharded projection)."""
    mesh = _mesh()
    return x if mesh is None else mesh.local(x, dim)


def shard_start(part: int, whole: int) -> int:
    """The first index of this rank's block of a dimension of size
    ``whole`` held as ``part`` elements (0 when it is held whole)."""
    mesh = _mesh()
    if mesh is None or part == whole:
        return 0
    return mesh.rank * part


def _pad_columns(w, whole: int, lo: int, dim: int):
    """``w`` (a tensor or a ``QTensor``) widened to ``whole`` along
    ``dim``, its own block at ``lo`` and zeros (zero codes) elsewhere."""
    codes = getattr(w, "codes", None)
    t = w if codes is None else codes
    shape = list(t.shape)
    shape[dim] = whole
    out = t.new_zeros(shape)
    out.narrow(dim, lo, t.shape[dim]).copy_(t)
    if codes is None:
        return out
    return type(w)(codes=out, scale=w.scale, fmt=w.fmt)


def tp_columns(product, x: torch.Tensor, w, whole: int, dim: int = -1):
    """``product(x, w)`` for a weight that may hold this rank's block of
    ``whole`` output columns along ``dim`` (``-1`` for ``x @ w``, ``0``
    for ``x @ w.T``), returned at this rank's width.

    On the card the block's product is computed as it is inside the whole
    product (``launch.mesh``: cuBLAS without split-K workspaces).  The
    CPU's BLAS picks its kernel by width (MKL-DNN sums a 16-column bf16
    product in another order than a 32-column one), so on CPU tensors the
    product runs at the whole width, the other ranks' columns zero, and
    this rank's block is cut out of it: the TP=1 product's columns bit
    for bit, at TP times the block's work."""
    mesh = _mesh()
    t = getattr(w, "codes", w)
    n = t.shape[dim]
    if mesh is None or n == whole or x.device.type != "cpu":
        return product(x, w)
    lo = mesh.rank * n
    y = product(x, _pad_columns(w, whole, lo, dim))
    return y.narrow(-1, lo, n)


def tp_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table_whole[ids]`` for a table whose rows may be sharded over the
    active mesh: every rank reads the ids it owns, the reads are gathered,
    and each id takes its owner's row, so the result is the whole table's
    row bit for bit (no sum of partial lookups)."""
    mesh = _mesh()
    state = _ctx.get()
    if mesh is None or table.shape[0] == state[2].vocab_padded:
        return table[ids]
    n = table.shape[0]
    mine = table[torch.clamp(ids - mesh.rank * n, 0, n - 1)]
    every = mesh.all_gather(mine[None], 0)            # [tp, *ids, D]
    owner = torch.div(ids, n, rounding_mode="floor")
    idx = owner[None, ..., None].expand(1, *mine.shape)
    return torch.gather(every, 0, idx)[0]
