"""Decoder stack of the dense GQA family, single-token decode.

Port of ``repro.models.transformer.sublayer_decode``/``stack_decode`` for
the dense pattern: a Python loop over per-layer parameter dicts replaces
the reference's scan over stacked blocks.  The policy site of layer ``i``
is ``blocks.{i % period}``, the reference's name (the index within the
scan pattern).
"""
from __future__ import annotations

from .attention import gqa_decode_paged
from .layers import gated_mlp, rms_norm


def sublayer_decode(p, x, cfg, *, cache, paged, is_global: bool = True,
                    site: str = "blocks.*"):
    """One attention + MLP sublayer on x [B, 1, D]; the layer's page
    tensors in ``cache`` are updated in place.  Returns the new x."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out = gqa_decode_paged(p["attn"], h, cfg, is_global=is_global,
                           cache=cache, paged=paged, site=f"{site}.attn")
    if cfg.sandwich_norm:
        out = rms_norm(out, p["ln1_post"], cfg.norm_eps)
    x = x + out
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    out = gated_mlp(h, p["ffn"], cfg.policy, cfg.act_fn, site=f"{site}.ffn")
    if cfg.sandwich_norm:
        out = rms_norm(out, p["ln2_post"], cfg.norm_eps)
    return x + out


def stack_decode(layers, cache, x, cfg, *, paged, noise=None):
    """Run every layer.  ``cache``: {"kp", "vp", "ks", "vs"} stacked over
    layers on the leading axis; ``noise``: [n_layers, 2, B, KV, hd] or
    None.  Returns the new x."""
    period = cfg.layer_pattern_period
    for i, p in enumerate(layers):
        layer_cache = {name: t[i] for name, t in cache.items()}
        layer_paged = dict(paged, noise=None if noise is None else noise[i])
        x = sublayer_decode(p, x, cfg, cache=layer_cache, paged=layer_paged,
                            is_global=cfg.is_global_attn_layer(i),
                            site=f"blocks.{i % period}")
    return x
