"""Decoder stack: the full-sequence forward of training and prefill, and
single-token decode against the dense or the paged cache.

Port of ``repro.models.transformer.sublayer_forward``/``stack_forward``
and ``sublayer_decode``/``stack_decode``: a Python loop over per-layer
parameter dicts replaces the reference's scan over stacked blocks.
``layers`` is every layer in order, the config's ``first_dense`` leading
layers (the reference's ``prefix``, outside its scan) first.  The policy
site of layer ``i`` is the reference's name (:func:`layer_site`):
``prefix.{i}`` for a leading layer, else ``blocks.{j % period}`` for body
layer ``j = i - first_dense`` (the index within the scan pattern).  Each
layer's mixer is attention (GQA or MLA) or Mamba2's SSD
(:func:`mixer_kind`), and its FFN the gated MLP, the MoE layer
(``models.moe``) or none, by the reference's ``layer_specs`` rule
(:func:`ffn_kind`; a leading layer is an MLP of ``d_ff``); the training
forward sums the MoE aux losses over layers, as the reference's scan
carry does, and serving drops them.  An SSD layer's cache entry is
dense per slot ({"conv", "state"}) and is written whole by every decode
step, its inactive slots' entries kept (the reference's select).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (gqa_decode, gqa_decode_paged, gqa_forward,
                        mla_decode, mla_forward)
from .layers import gated_mlp, rms_norm
from .mamba2 import ssd_decode, ssd_forward
from .moe import add_shared_down, moe_ffn

# the cache leaves of an SSD layer's entry (the others are attention's)
SSD_LEAVES = ("conv", "state")


def mixer_kind(cfg, i: int) -> str:
    """Layer ``i``'s mixer, "attn" or "mamba", by the reference's rule."""
    return "attn" if cfg.is_attn_layer(i) else "mamba"


def ffn_kind(cfg, i: int) -> str:
    """Layer ``i``'s FFN, "moe", "mlp" or "none", by the reference's rule
    (a leading dense layer is always an MLP of ``d_ff``)."""
    if i < cfg.first_dense:
        return "mlp"
    if cfg.is_moe_layer(i):
        return "moe"
    return "none" if cfg.d_ff == 0 else "mlp"


def layer_site(cfg, i: int) -> str:
    """The reference's policy site of layer ``i`` (absolute index)."""
    if i < cfg.first_dense:
        return f"prefix.{i}"
    return f"blocks.{(i - cfg.first_dense) % cfg.layer_pattern_period}"


def _layer_kw(cfg, i: int) -> dict:
    return dict(mixer=mixer_kind(cfg, i),
                is_global=cfg.is_global_attn_layer(i), ffn=ffn_kind(cfg, i),
                site=layer_site(cfg, i))


def _ffn(p, x, cfg, ffn: str, site: str, want_aux: bool = False,
         split_shared: bool = False):
    """The FFN half of a sublayer on x (the residual after the mixer).
    With ``want_aux``, an MoE layer returns (x, moe_lb, moe_z); with
    ``split_shared`` too, one with shared experts returns (x, the routed
    output, the shared experts' hidden activation, moe_lb, moe_z) and
    leaves the rest to :func:`_shared_tail`."""
    if ffn == "none":
        return x
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if ffn == "moe":
        out, aux, *hidden = moe_ffn(p["ffn"], h, cfg, site=f"{site}.ffn",
                                    shared_hidden=split_shared)
        if hidden:
            return x, out, hidden[0], aux["moe_lb"], aux["moe_z"]
    else:
        out = gated_mlp(h, p["ffn"], cfg.policy, cfg.act_fn,
                        site=f"{site}.ffn")
    if cfg.sandwich_norm:
        out = rms_norm(out, p["ln2_post"], cfg.norm_eps)
    if want_aux and aux is not None:
        return x + out, aux["moe_lb"], aux["moe_z"]
    return x + out


def _shared_tail(p, x, out, hidden, cfg, site: str):
    """The end of an MoE layer with shared experts whose checkpoint
    returned ``_ffn``'s split: their down product added to the routed
    output, the post norm, the residual add, in :func:`_ffn`'s order."""
    out = add_shared_down(p["ffn"], out, hidden, cfg, site=f"{site}.ffn")
    if cfg.sandwich_norm:
        out = rms_norm(out, p["ln2_post"], cfg.norm_eps)
    return x + out


def sublayer_forward(p, x, cfg, *, positions, mixer: str = "attn",
                     is_global: bool = True, ffn: str = "mlp",
                     site: str = "blocks.*", want_cache: bool = False,
                     want_aux: bool = False, split_shared: bool = False):
    """One mixer + FFN sublayer over a full sequence x [B, S, D].
    Returns the new x, or (x, the layer's dense cache entries) when
    ``want_cache`` (prefill), or (x, moe_lb, moe_z) of an MoE layer when
    ``want_aux`` (training), or :func:`_ffn`'s split with
    ``split_shared``."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mixer == "mamba":
        out, cache = ssd_forward(p["mamba"], h, cfg)
    elif cfg.attn_impl == "mla":
        out, cache = mla_forward(p["attn"], h, cfg, positions=positions,
                                 site=f"{site}.attn", want_cache=want_cache)
    else:
        out, cache = gqa_forward(p["attn"], h, cfg, is_global=is_global,
                                 positions=positions, site=f"{site}.attn",
                                 want_cache=want_cache)
    if cfg.sandwich_norm:
        out = rms_norm(out, p["ln1_post"], cfg.norm_eps)
    x = _ffn(p, x + out, cfg, ffn, site, want_aux, split_shared)
    return (x, cache) if want_cache else x


def stack_forward(layers, x, cfg, *, positions, mode: str = "train"):
    """Every layer over a full sequence.

    ``mode="train"`` returns (the new x, aux {"moe_lb", "moe_z"}: each MoE
    layer's aux losses summed over layers in order, float32 scalars, 0.0
    without MoE layers).  Under the config's ``remat_policy`` "minimal"
    (the reference's ``nothing_saveable``), each body layer runs under
    ``torch.utils.checkpoint``: only its input is kept, and its forward,
    quantized matmul kernels and routing included, runs again in the
    backward, as under ``jax.checkpoint``; an MoE layer's aux losses leave
    the checkpoint beside x, so their gradients reach its router.  The
    shared experts' down product runs after the checkpoint (its output
    feeds no gradient, so the reference's remat drops it from the
    recompute): each of the layer's products runs twice, forward and
    recompute, but that one, which runs once.  The ``first_dense``
    leading layers run once, without a checkpoint, as the reference's
    ``_run_prefix`` runs them outside its scan's remat.  ``mode="prefill"`` runs without checkpoints and returns
    (x, one dense cache entry per layer: {"k", "v"} [B, S, KV, hd], MLA's
    {"ckv", "kpe"} [B, S, L] and [B, S, dr], or SSD's {"conv", "state"})."""
    if mode == "prefill":
        caches = []
        for i, p in enumerate(layers):
            x, c = sublayer_forward(p, x, cfg, positions=positions,
                                    want_cache=True, **_layer_kw(cfg, i))
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
        kw = _layer_kw(cfg, i)
        split = kw["ffn"] == "moe" and "shared" in p["ffn"]
        if i < cfg.first_dense:
            out = sublayer_forward(p, x, cfg, positions=positions,
                                   want_aux=True, **kw)
        else:
            out = checkpoint(sublayer_forward, p, x, cfg,
                             use_reentrant=False, positions=positions,
                             want_aux=True, split_shared=split, **kw)
        if split:
            x, routed, hidden, lb, z = out
            x = _shared_tail(p, x, routed, hidden, cfg, kw["site"])
        elif kw["ffn"] == "moe":
            x, lb, z = out
        else:
            x = out
            continue
        aux = {"moe_lb": aux["moe_lb"] + lb, "moe_z": aux["moe_z"] + z}
    return x, aux


def _write_entry(cache, new, active) -> None:
    """Write a dense per-slot entry in place: every slot's new leaves, but
    an inactive slot's (``active`` [B] bool, a masked sub-step) old ones,
    selected on the device (the reference's keep-old select)."""
    for name, t in new.items():
        if active is not None:
            t = torch.where(active.view((-1,) + (1,) * (t.ndim - 1)), t,
                            cache[name])
        cache[name].copy_(t)


def sublayer_decode(p, x, cfg, *, cache, paged=None, pos=None,
                    mixer: str = "attn", is_global: bool = True,
                    ffn: str = "mlp", site: str = "blocks.*"):
    """One mixer + FFN sublayer on x [B, 1, D]; the layer's cache entries
    (page tensors with ``paged``, dense {"k", "v"} rows at ``pos``
    without; MLA's dense {"ckv", "kpe"} rows at ``pos``, or at
    ``paged["lengths"]`` under ``paged["active"]``, on either path; SSD's
    {"conv", "state"} whole, inactive slots' kept under
    ``paged["active"]``) are updated in place.  Returns the new x."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mixer == "mamba":
        out, new = ssd_decode(p["mamba"], h, cfg, cache)
        _write_entry(cache, new,
                     None if paged is None else paged.get("active"))
    elif cfg.attn_impl == "mla":
        if paged is not None:
            pos, active = paged["lengths"], paged.get("active")
        else:
            active = None
        out = mla_decode(p["attn"], h, cfg, cache=cache, pos=pos,
                         active=active, site=f"{site}.attn")
    elif paged is not None and "kp" in cache:
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
    """Run every layer.  Paged (``paged`` given): ``cache`` is the paged
    cache, each mixer's tensors stacked over that mixer's layers only on
    the leading axis ({"kp", "vp", "ks", "vs"}, MLA's dense per-slot
    {"ckv", "kpe"}, or SSD's {"conv", "state"}), and ``noise`` [n_attn,
    2, B, KV, hd] (the attention layers' own, in order) or None.  Dense: ``cache`` is one
    dict per layer and ``pos`` [B] the new tokens' positions.  Returns the
    new x."""
    if paged is None:
        for i, p in enumerate(layers):
            x = sublayer_decode(p, x, cfg, cache=cache[i], pos=pos,
                                **_layer_kw(cfg, i))
        return x
    seen = {"attn": 0, "mamba": 0}   # layers of each mixer so far
    for i, p in enumerate(layers):
        kw = _layer_kw(cfg, i)
        j = seen[kw["mixer"]]
        seen[kw["mixer"]] += 1
        ssd = kw["mixer"] == "mamba"
        layer_cache = {name: t[j] for name, t in cache.items()
                       if (name in SSD_LEAVES) == ssd}
        layer_paged = dict(paged, noise=None if noise is None or ssd
                           else noise[j])
        x = sublayer_decode(p, x, cfg, cache=layer_cache, paged=layer_paged,
                            **kw)
    return x
