"""Decoder stack of the GQA family: the full-sequence forward of
training and prefill, and single-token decode against the dense or the
paged cache.

Port of ``repro.models.transformer.sublayer_forward``/``stack_forward``
and ``sublayer_decode``/``stack_decode`` for GQA attention stacks: a
Python loop over per-layer parameter dicts replaces the reference's scan
over stacked blocks.  The policy site of layer ``i`` is
``blocks.{i % period}``, the reference's name (the index within the scan
pattern).  Each layer's FFN is the gated MLP or the MoE layer
(``models.moe``), by the reference's ``layer_specs`` rule
(:func:`ffn_kind`); the training forward sums the MoE aux losses over
layers, as the reference's scan carry does, and serving drops them.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from .attention import gqa_decode, gqa_decode_paged, gqa_forward
from .layers import gated_mlp, rms_norm
from .moe import moe_ffn


def ffn_kind(cfg, i: int) -> str:
    """Layer ``i``'s FFN, "moe" or "mlp", by the reference's rule (its
    third kind, no FFN, belongs to families the port does not run)."""
    return "moe" if cfg.is_moe_layer(i) else "mlp"


def _ffn(p, x, cfg, ffn: str, site: str, want_aux: bool = False):
    """The FFN half of a sublayer on x (the residual after attention).
    With ``want_aux``, an MoE layer returns (x, moe_lb, moe_z)."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if ffn == "moe":
        out, aux = moe_ffn(p["ffn"], h, cfg, site=f"{site}.ffn")
    else:
        out = gated_mlp(h, p["ffn"], cfg.policy, cfg.act_fn,
                        site=f"{site}.ffn")
    if cfg.sandwich_norm:
        out = rms_norm(out, p["ln2_post"], cfg.norm_eps)
    if want_aux and aux is not None:
        return x + out, aux["moe_lb"], aux["moe_z"]
    return x + out


def sublayer_forward(p, x, cfg, *, positions, is_global: bool = True,
                     ffn: str = "mlp", site: str = "blocks.*",
                     want_cache: bool = False, want_aux: bool = False):
    """One attention + FFN sublayer over a full sequence x [B, S, D].
    Returns the new x, or (x, the layer's dense cache entries) when
    ``want_cache`` (prefill), or (x, moe_lb, moe_z) of an MoE layer when
    ``want_aux`` (training)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out, cache = gqa_forward(p["attn"], h, cfg, is_global=is_global,
                             positions=positions, site=f"{site}.attn",
                             want_cache=want_cache)
    if cfg.sandwich_norm:
        out = rms_norm(out, p["ln1_post"], cfg.norm_eps)
    x = _ffn(p, x + out, cfg, ffn, site, want_aux)
    return (x, cache) if want_cache else x


def stack_forward(layers, x, cfg, *, positions, mode: str = "train"):
    """Every layer over a full sequence.

    ``mode="train"`` returns (the new x, aux {"moe_lb", "moe_z"}: each MoE
    layer's aux losses summed over layers in order, float32 scalars, 0.0
    without MoE layers).  Under the config's ``remat_policy`` "minimal"
    (the reference's ``nothing_saveable``), each layer runs under
    ``torch.utils.checkpoint``: only its input is kept, and its forward,
    quantized matmul kernels and routing included, runs again in the
    backward, as under ``jax.checkpoint``; an MoE layer's aux losses leave
    the checkpoint beside x, so their gradients reach its router.
    ``mode="prefill"`` runs without checkpoints and returns (x, one dense
    cache entry {"k", "v"} [B, S, KV, hd] per layer)."""
    period = cfg.layer_pattern_period
    if mode == "prefill":
        caches = []
        for i, p in enumerate(layers):
            x, c = sublayer_forward(p, x, cfg, positions=positions,
                                    is_global=cfg.is_global_attn_layer(i),
                                    ffn=ffn_kind(cfg, i),
                                    site=f"blocks.{i % period}",
                                    want_cache=True)
            caches.append(c)
        return x, caches
    if mode != "train":
        raise ValueError(f"unknown mode {mode!r}")
    if cfg.remat_policy != "minimal":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported (only "
            "'minimal'; ROADMAP.md Queue 1 item 12)")
    aux = {"moe_lb": 0.0, "moe_z": 0.0}
    for i, p in enumerate(layers):
        ffn = ffn_kind(cfg, i)
        out = checkpoint(sublayer_forward, p, x, cfg, use_reentrant=False,
                         positions=positions,
                         is_global=cfg.is_global_attn_layer(i), ffn=ffn,
                         site=f"blocks.{i % period}", want_aux=True)
        if ffn == "moe":
            x, lb, z = out
            aux = {"moe_lb": aux["moe_lb"] + lb, "moe_z": aux["moe_z"] + z}
        else:
            x = out
    return x, aux


def sublayer_decode(p, x, cfg, *, cache, paged=None, pos=None,
                    is_global: bool = True, ffn: str = "mlp",
                    site: str = "blocks.*"):
    """One attention + FFN sublayer on x [B, 1, D]; the layer's cache
    entries (page tensors with ``paged``, dense {"k", "v"} rows at ``pos``
    without) are updated in place.  Returns the new x."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if paged is not None and "kp" in cache:
        out = gqa_decode_paged(p["attn"], h, cfg, is_global=is_global,
                               cache=cache, paged=paged, site=f"{site}.attn")
    else:
        out = gqa_decode(p["attn"], h, cfg, is_global=is_global,
                         cache=cache, pos=pos, site=f"{site}.attn")
    if cfg.sandwich_norm:
        out = rms_norm(out, p["ln1_post"], cfg.norm_eps)
    return _ffn(p, x + out, cfg, ffn, site)


def stack_decode(layers, cache, x, cfg, *, paged=None, noise=None,
                 pos=None):
    """Run every layer.  Paged (``paged`` given): ``cache`` is {"kp", "vp",
    "ks", "vs"} stacked over layers on the leading axis and ``noise``
    [n_layers, 2, B, KV, hd] or None.  Dense: ``cache`` is one {"k", "v"}
    dict per layer and ``pos`` [B] the new tokens' positions.  Returns the
    new x."""
    period = cfg.layer_pattern_period
    if paged is None:
        for i, p in enumerate(layers):
            x = sublayer_decode(p, x, cfg, cache=cache[i], pos=pos,
                                is_global=cfg.is_global_attn_layer(i),
                                ffn=ffn_kind(cfg, i),
                                site=f"blocks.{i % period}")
        return x
    for i, p in enumerate(layers):
        layer_cache = {name: t[i] for name, t in cache.items()}
        layer_paged = dict(paged, noise=None if noise is None else noise[i])
        x = sublayer_decode(p, x, cfg, cache=layer_cache, paged=layer_paged,
                            is_global=cfg.is_global_attn_layer(i),
                            ffn=ffn_kind(cfg, i), site=f"blocks.{i % period}")
    return x
