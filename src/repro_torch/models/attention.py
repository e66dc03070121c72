"""GQA attention: the full-sequence forward of training and decode against
the paged cache (serving; FP8 codes or float pages, as the policy says).

Port of ``repro.models.attention._gqa_qkv``, ``gqa_forward`` and
``gqa_decode_paged``.
"""
from __future__ import annotations

import torch

from .. import numerics
from .layers import chunked_attention, qlinear, rms_norm, rope


def _gqa_qkv(p, x, cfg, positions, use_rope=True, site="blocks.*.attn"):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pol = cfg.policy
    q = qlinear(x, p["wq"], pol, p.get("bq"), site=f"{site}.wq").reshape(B, S, H, hd)
    k = qlinear(x, p["wk"], pol, p.get("bk"), site=f"{site}.wk").reshape(B, S, KV, hd)
    v = qlinear(x, p["wv"], pol, p.get("bv"), site=f"{site}.wv").reshape(B, S, KV, hd)
    if cfg.qk_norm:  # per-head RMSNorm over hd (qwen3/gemma3 style)
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, x, cfg, *, is_global: bool, positions,
                site="blocks.*.attn"):
    """Causal full-sequence self-attention (train): x [B, S, D] -> y
    [B, S, D].  The reference also returns the layer's K/V cache entries
    for prefill; the port's training forward has no use for them."""
    q, k, v = _gqa_qkv(p, x, cfg, positions, site=site)
    window = 0 if is_global else cfg.window
    out = chunked_attention(q, k, v, window=window, cap=cfg.attn_softcap)
    B, S = q.shape[:2]
    return qlinear(out.reshape(B, S, -1), p["wo"], cfg.policy,
                   site=f"{site}.wo")


def gqa_decode_paged(p, x, cfg, *, is_global: bool, cache, paged,
                     use_rope=True, site="blocks.*.attn"):
    """GQA decode of one token per slot against the global page pool.

    x: [B, 1, D]; cache: this layer's page tensors {"kp", "vp", "ks",
    "vs"}, updated in place; paged: the step's shared state
    {"block_tables" [B, maxp] int32, "lengths" [B] int32 (context length
    BEFORE this token), "page_size", "noise" (this layer's [2, B, KV, hd]
    stochastic-rounding noise for K and V, or None: always None for float
    pages), "active" (optional [B] bool write mask), "fused"}.

    The reference derives each slot's KV-write PRNG key here (split the
    layer key, fold in the write position); the port receives the bits
    those keys draw, generated for all layers in one batched call
    (``Model.kv_noise``), so the codes match and the rounding stays
    addressed by (layer, position).  Masked lanes write into the null page
    and never claim a page scale.  Returns y [B, 1, D].
    """
    B = x.shape[0]
    KV = cfg.n_kv_heads
    pol = cfg.policy
    lengths = paged["lengths"]
    block_tables = paged["block_tables"]
    page_size = paged["page_size"]
    q, k_new, v_new = _gqa_qkv(p, x, cfg, lengths[:, None], use_rope,
                               site=site)
    active = paged.get("active")
    noise = paged.get("noise")
    kn, vn = (None, None) if noise is None else (noise[0], noise[1])
    window = 0 if is_global else cfg.window
    if paged.get("fused", True):
        out = numerics.kv_fused_write_attend(
            q, k_new[:, 0], v_new[:, 0], cache["kp"], cache["vp"],
            cache["ks"], cache["vs"], block_tables, lengths, pol,
            n_kv_heads=KV, k_noise=kn, v_noise=vn, write_mask=active,
            window=window, cap=cfg.attn_softcap, site=site,
        )[0]
    else:
        logical = torch.div(lengths, page_size, rounding_mode="floor")
        page_ids = block_tables.gather(1, logical[:, None].to(torch.int64))[:, 0]
        rows = lengths - logical * page_size
        numerics.kv_write_token(pol, cache["kp"], cache["ks"], k_new[:, 0],
                                page_ids, rows, noise=kn, write_mask=active)
        numerics.kv_write_token(pol, cache["vp"], cache["vs"], v_new[:, 0],
                                page_ids, rows, noise=vn, write_mask=active)
        out = numerics.attention(
            q, cache["kp"], cache["vp"], cache["ks"], cache["vs"],
            block_tables, lengths + 1, pol, n_kv_heads=KV, window=window,
            cap=cfg.attn_softcap, site=site,
        )
    return qlinear(out.reshape(B, 1, -1), p["wo"], pol, site=f"{site}.wo")
