"""Static (post-training) FP8 weight quantization: port of
``repro.models.quantize``.

Converts eligible matmul weights of a parameter dict to
:class:`repro_torch.core.quant.QTensor` leaves (uint8 codes and a float32
scale), so that weights take 1 byte a parameter on the card.  Under a
policy that leaves matmuls unquantized each product decodes its weight to
the compute dtype first (``numerics.matmul``); under one that quantizes
them the stored codes go straight into ``kernels.ops.matmul_q`` (K2 for
``fused_dequant``, K3 for ``lns``).

The reference quantizes its stacked block weights ``[n_blocks, ...]`` with
one scale per block (``axis=0``); the port keeps one dict per layer, so
each layer's tensor is quantized per tensor, which is the same absmax,
scale and codes, bit for bit.  Everything else eligible (``unembed``) is
per tensor in both.  Embedding tables, norms and biases stay float.  The
per-site weight format comes from the policy's ``weights`` op class and
its overrides, keyed by the reference's site names (``blocks.{j}.attn.wq``
with ``j`` the index within the layer pattern, ``prefix.{i}.ffn.w_up``
for leading dense layer ``i``, whose weights, unstacked in the reference,
are per tensor there too).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.quant import QTensor, quantize
from ..kernels.common import code_to_f32
from ..numerics.policy import Policy

__all__ = ["QUANT_WEIGHT_NAMES", "quantize_params", "quantize_leaf",
           "as_qtensor", "resolve_weight"]

QUANT_WEIGHT_NAMES = {
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_uk", "w_uv",
    "w_dkv", "out_proj", "w_z", "w_x", "w_B", "w_C", "w_dt", "img_proj",
    "unembed",
}


def quantize_params(params, policy: Union[Policy, str, None] = None,
                    *, period: int = 1):
    """Replace eligible weight leaves with :class:`QTensor` carriers.

    ``policy``: a :class:`Policy` (per-site formats through its ``weights``
    op class and overrides), a bare format string (per-tensor in that
    format), or None (E4M3 everywhere).  ``period``: the config's
    ``layer_pattern_period``, which names body layer ``j``'s sites
    ``blocks.{j % period}``, as the reference's scan pattern does (the
    ``prefix`` layers keep their index).
    Returns a new dict; the float leaves that stay are shared."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return quantize_leaf(path, node, policy, period=period)

    return walk(params, ())


def quantize_leaf(path, node, policy: Union[Policy, str, None] = None, *,
                  period: int = 1):
    """One leaf of :func:`quantize_params`: ``node`` at ``path`` (its keys,
    layer indices as ints, e.g. ``("blocks", 7, "attn", "wq")``) as a
    :class:`QTensor` when it is an eligible weight, else itself.  A mesh
    engine calls it on each whole weight as it is drawn, before the cut,
    so the codes and the per-tensor scale are the TP=1 ones."""
    if not (path[-1] in QUANT_WEIGHT_NAMES and node.ndim >= 2):
        return node
    if isinstance(policy, str):
        return quantize(node, policy)
    if policy is None or not policy.weight_quant:
        return quantize(node, "e4m3")
    # a body layer's index is its place in the scan pattern; a leading
    # dense layer's is its own (``prefix.{i}``)
    site = ".".join(str(k % period)
                    if isinstance(k, int) and path[0] == "blocks" else str(k)
                    for k in path)
    return quantize(node, policy.resolve("weights", site).fmt)


_DECODE_TABLES = {}


def _decode_table(fmt: str, device) -> torch.Tensor:
    """``code_to_f32`` of all 256 codes, kept per (format, device): the
    decode of a weight is then one gather, equal to ``code_to_f32``
    element for element."""
    key = (fmt, torch.device(device))
    table = _DECODE_TABLES.get(key)
    if table is None:
        codes = torch.arange(256, dtype=torch.int64).to(torch.uint8)
        table = _DECODE_TABLES[key] = code_to_f32(codes, fmt).to(device)
    return table


def _decode(codes: torch.Tensor, fmt: str) -> torch.Tensor:
    return _decode_table(fmt, codes.device)[codes.to(torch.int32)]


def as_qtensor(w, fmt: Optional[str] = None) -> QTensor:
    """A static-quantized weight as the :class:`QTensor` carrier: a
    QTensor as it is (its own ``fmt`` holds), a legacy ``{"codes",
    "scale"}`` dict (old checkpoints) in ``fmt``, E4M3 by default.  The
    one converter of the dict carrier: ``resolve_weight`` and
    ``numerics.matmul`` both go through it."""
    if isinstance(w, QTensor):
        return w
    return QTensor(codes=w["codes"],
                   scale=torch.as_tensor(w["scale"], dtype=torch.float32),
                   fmt=fmt or "e4m3")


def resolve_weight(w, fmt: Optional[str] = None, dtype=torch.bfloat16):
    """Dequantize a static-quantized weight (a no-op for plain tensors).

    ``w``: a :class:`QTensor`, a legacy ``{"codes", "scale"}`` dict in
    ``fmt`` (:func:`as_qtensor`), or a plain tensor.  The codes decode as
    the reference's bit placement does (``kernels.common.code_to_f32``),
    times the scale in float32, then cast to ``dtype``."""
    if not (isinstance(w, QTensor) or (isinstance(w, dict) and "codes" in w)):
        return w
    q = as_qtensor(w, fmt)
    return (_decode(q.codes, q.fmt) * q.scale).to(dtype)
