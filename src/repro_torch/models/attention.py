"""Attention: GQA's full-sequence forward of training and prefill, its
decode against a dense per-slot cache and against the paged cache
(serving; FP8 codes or float pages, as the policy says), and DeepSeek-V2's
multi-head latent attention (MLA).

Port of ``repro.models.attention._gqa_qkv``, ``gqa_forward``,
``gqa_decode``, ``gqa_decode_paged`` and the MLA functions ``mla_init``,
``_mla_q``, ``_mla_latent``, ``mla_forward`` and ``mla_decode``.  The
dense cache holds FP8 codes at scale 1 when the policy quantizes the KV
cache (``numerics.kv_encode``, RNE) and floats of the parameters' dtype
otherwise.  MLA caches only its compressed latents, {"ckv" [B, S,
kv_lora_rank], "kpe" [B, S, qk_rope_dim]}, in that representation, as
dense per-slot rows on every serving path (no pages).

On a tensor-parallel mesh (``parallel.hints``) each rank holds its block
of the query heads and KV heads: the head counts are read off the
projections, the reference's hint sites check (or cut) them, and the
attention output is gathered over the heads before ``wo``, which runs
whole on every rank.
"""
from __future__ import annotations

import torch

from .. import numerics
from ..kernels.paged_attention import row_amax
from ..parallel.hints import hint, tp_columns, tp_local, tp_max, tp_size
from .layers import (NEG_INF, _dims, chunked_attention, decode_attention,
                     qlinear, rms_norm, rope)
from .quantize import resolve_weight


def _proj(x, p, w: str, b: str, whole: int, pol, site: str):
    """``x @ p[w] + p[b]`` of ``whole`` output columns; on a mesh a
    column-sharded weight gives this rank's block of them
    (``hints.tp_columns``), and the replicated bias its block too."""
    bias = p.get(b)
    if bias is not None and bias.shape[-1] != _dims(p[w])[-1]:
        bias = tp_local(bias, -1)
    y = tp_columns(
        lambda x_, w_: qlinear(x_, w_, pol, None, site=f"{site}.{w}"),
        x, p[w], whole)
    return y if bias is None else y + bias


def _gqa_qkv(p, x, cfg, positions, use_rope=True, site="blocks.*.attn"):
    B, S, _ = x.shape
    hd = cfg.hd
    pol = cfg.policy
    # heads read off the projections: this rank's block on a mesh
    H, KV = cfg.n_heads * hd, cfg.n_kv_heads * hd
    q = _proj(x, p, "wq", "bq", H, pol, site).reshape(B, S, -1, hd)
    k = _proj(x, p, "wk", "bk", KV, pol, site).reshape(B, S, -1, hd)
    v = _proj(x, p, "wv", "bv", KV, pol, site).reshape(B, S, -1, hd)
    if cfg.qk_norm:  # per-head RMSNorm over hd (qwen3/gemma3 style)
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _kv_store(x, cfg):
    """To the dense cache's representation (scale-1 FP8 codes when the
    policy quantizes the KV cache)."""
    return numerics.kv_encode(x, cfg.policy)


def _kv_load(x, cfg):
    return numerics.kv_decode(x, cfg.policy)


def gqa_forward(p, x, cfg, *, is_global: bool, positions,
                site="blocks.*.attn", want_cache: bool = False):
    """Causal full-sequence self-attention (train, prefill): x [B, S, D] ->
    (y [B, S, D], the layer's dense cache entries {"k", "v"}: [B, S, KV,
    hd] in the cache's representation, or None unless ``want_cache``)."""
    q, k, v = _gqa_qkv(p, x, cfg, positions, site=site)
    # serving TP: heads / KV groups sharded (no-ops outside a mesh)
    q = hint(q, "tp_heads")
    k = hint(k, "tp_kv")
    v = hint(v, "tp_kv")
    window = 0 if is_global else cfg.window
    out = chunked_attention(q, k, v, window=window, cap=cfg.attn_softcap)
    B, S = q.shape[:2]
    out = hint(out, "tp_gather")  # all-gather heads before the wo matmul
    y = qlinear(out.reshape(B, S, -1), p["wo"], cfg.policy,
                site=f"{site}.wo")
    if not want_cache:
        return y, None
    return y, {"k": _kv_store(k, cfg), "v": _kv_store(v, cfg)}


def gqa_decode(p, x, cfg, *, is_global: bool, cache, pos, use_rope=True,
               site="blocks.*.attn"):
    """GQA decode of one token per slot against the dense per-slot cache.

    x: [B, 1, D]; cache: this layer's {"k", "v"} [B, W, KV, hd], updated in
    place; pos: [B] (or scalar) positions of the new tokens.  A local layer
    whose cache is no longer than its window is a ring buffer: the new row
    goes to ``pos mod W`` (keys carry RoPE from their absolute position, so
    the rows' order does not matter) and every row is admissible once
    ``pos >= W``.  Returns y [B, 1, D]."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(B)
    q, k_new, v_new = _gqa_qkv(p, x, cfg, pos[:, None], use_rope, site=site)
    if numerics.kv_quantized(cfg.policy):
        k_c, v_c = _kv_store(k_new, cfg), _kv_store(v_new, cfg)
    else:
        k_c = k_new.to(cache["k"].dtype)
        v_c = v_new.to(cache["v"].dtype)
    W = cache["k"].shape[1]
    window = 0 if is_global else cfg.window
    ring = bool(window) and W <= window
    write = torch.remainder(pos, W) if ring else pos
    b_ix = torch.arange(B, device=x.device)
    cache["k"][b_ix, write] = k_c[:, 0]
    cache["v"][b_ix, write] = v_c[:, 0]
    out = decode_attention(q, _kv_load(cache["k"], cfg),
                           _kv_load(cache["v"], cfg), pos=pos,
                           window=0 if ring else window,
                           cap=cfg.attn_softcap, ring=ring)
    return qlinear(out.reshape(B, 1, -1), p["wo"], cfg.policy,
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

    On a mesh the cache and the noise hold this rank's KV heads, and the
    output is gathered over the heads before ``wo``: no value is summed
    across shards, so the stream is the TP=1 stream bit for bit.  The
    page scale of the new K and V rows and the query's scale come from
    absmaxes over every head: this layer takes their maximum over the
    ranks, the one collective of the write, and passes it down.
    """
    B = x.shape[0]
    pol = cfg.policy
    lengths = paged["lengths"]
    block_tables = paged["block_tables"]
    page_size = paged["page_size"]
    q, k_new, v_new = _gqa_qkv(p, x, cfg, lengths[:, None], use_rope,
                               site=site)
    q = hint(q, "tp_heads")
    k_new = hint(k_new, "tp_kv")
    v_new = hint(v_new, "tp_kv")
    KV = k_new.shape[2]
    active = paged.get("active")
    noise = paged.get("noise")
    kn, vn = (None, None) if noise is None else (noise[0], noise[1])
    window = 0 if is_global else cfg.window
    amax = None  # [3, B]: the K row's, V row's and query's absmax
    if tp_size() > 1 and numerics.kv_quantized(pol):
        amax = tp_max(torch.stack([row_amax(t[:, 0])
                                   for t in (k_new, v_new, q)]))
    if paged.get("fused", True):
        out = numerics.kv_fused_write_attend(
            q, k_new[:, 0], v_new[:, 0], cache["kp"], cache["vp"],
            cache["ks"], cache["vs"], block_tables, lengths, pol,
            n_kv_heads=KV, k_noise=kn, v_noise=vn, write_mask=active,
            window=window, cap=cfg.attn_softcap, site=site, amax=amax,
        )[0]
    else:
        logical = torch.div(lengths, page_size, rounding_mode="floor")
        page_ids = block_tables.gather(1, logical[:, None].to(torch.int64))[:, 0]
        rows = lengths - logical * page_size
        ka, va, qa = (None,) * 3 if amax is None else amax
        numerics.kv_write_token(pol, cache["kp"], cache["ks"], k_new[:, 0],
                                page_ids, rows, noise=kn, write_mask=active,
                                amax=ka)
        numerics.kv_write_token(pol, cache["vp"], cache["vs"], v_new[:, 0],
                                page_ids, rows, noise=vn, write_mask=active,
                                amax=va)
        out = numerics.attention(
            q, cache["kp"], cache["vp"], cache["ks"], cache["vs"],
            block_tables, lengths + 1, pol, n_kv_heads=KV, window=window,
            cap=cfg.attn_softcap, site=site, q_amax=qa,
        )
    # gather the head-sharded output BEFORE the wo contraction: the matmul
    # sees the whole array on every shard, so TP adds no partial sums
    out = hint(out, "tp_gather")
    return qlinear(out.reshape(B, 1, -1), p["wo"], pol, site=f"{site}.wo")


# --------------------------------------------------------------------------- #
# MLA (DeepSeek-V2)
# --------------------------------------------------------------------------- #
def mla_init(normal, zeros, cfg, path=()):
    """The reference's MLA leaves, N(0, 0.02^2) weights and a zero
    ``kv_norm`` gain, each drawn by ``normal(path, *shape)`` or
    ``zeros(path, *shape)`` (``Model.init``'s draws)."""
    D, H = cfg.d_model, cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    dv, L = cfg.v_head_dim, cfg.kv_lora_rank
    return {"wq": normal(path + ("wq",), D, H * (dn + dr)),
            "w_dkv": normal(path + ("w_dkv",), D, L + dr),
            "kv_norm": zeros(path + ("kv_norm",), L),
            "w_uk": normal(path + ("w_uk",), L, H * dn),
            "w_uv": normal(path + ("w_uv",), L, H * dv),
            "wo": normal(path + ("wo",), H * dv, D)}


def _mla_q(p, x, cfg, positions, site="blocks.*.attn"):
    """The query's no-RoPE part [B, S, H, dn] and its RoPE part [B, S, H,
    dr], rotated at ``positions``."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = qlinear(x, p["wq"], cfg.policy, site=f"{site}.wq").reshape(
        B, S, cfg.n_heads, dn + dr)
    return q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latent(p, x, cfg, positions, site="blocks.*.attn"):
    """The compressed latent [B, S, L] (RMS-normed) and the shared RoPE
    key [B, S, dr], rotated at ``positions``."""
    B, S, _ = x.shape
    L, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    dkv = qlinear(x, p["w_dkv"], cfg.policy, site=f"{site}.w_dkv")
    ckv = rms_norm(dkv[..., :L], p["kv_norm"], cfg.norm_eps)
    kpe = rope(dkv[..., L:].reshape(B, S, 1, dr), positions, cfg.rope_theta)
    return ckv, kpe.reshape(B, S, dr)


def mla_forward(p, x, cfg, *, positions, site="blocks.*.attn",
                want_cache: bool = False):
    """Causal full-sequence MLA (train, prefill): keys and values expanded
    from the latent (qk dn + dr, v dv per head) through
    :func:`chunked_attention`.  Returns (y [B, S, D], the layer's dense
    cache entries {"ckv", "kpe"} in the cache's representation, or None
    unless ``want_cache``)."""
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    pol = cfg.policy
    q_nope, q_pe = _mla_q(p, x, cfg, positions, site=site)
    ckv, kpe = _mla_latent(p, x, cfg, positions, site=site)
    k_nope = qlinear(ckv, p["w_uk"], pol, site=f"{site}.w_uk").reshape(
        B, S, H, dn)
    v = qlinear(ckv, p["w_uv"], pol, site=f"{site}.w_uv").reshape(
        B, S, H, cfg.v_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, kpe[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    out = chunked_attention(q, k, v)
    y = qlinear(out.reshape(B, S, -1), p["wo"], pol, site=f"{site}.wo")
    if not want_cache:
        return y, None
    return y, {"ckv": _kv_store(ckv, cfg), "kpe": _kv_store(kpe, cfg)}


def mla_decode(p, x, cfg, *, cache, pos, active=None,
               site="blocks.*.attn"):
    """Absorbed-matrices MLA decode of one token per slot, attention in
    the latent space.

    x: [B, 1, D]; cache: this layer's {"ckv" [B, S, L], "kpe" [B, S, dr]},
    updated in place at each slot's ``pos`` ([B] or a scalar); keys at
    ``t <= pos`` are admissible (the rest masked at -2e30).  ``w_uk`` and
    ``w_uv`` (static codes decoded first) multiply in float32, as do the
    scores and the softmax, whose sum is divided by ``max(den, 1e-37)``.
    ``active`` ([B] bool, a masked sub-step of the paged steps): every
    slot attends with its new row written, as in the reference, then an
    inactive slot's row is put back, so its entry is the old one, as the
    reference's select keeps it.  Returns y [B, 1, D]."""
    B = x.shape[0]
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    dv, L = cfg.v_head_dim, cfg.kv_lora_rank
    pol = cfg.policy
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(B)
    positions = pos[:, None]
    q_nope, q_pe = _mla_q(p, x, cfg, positions, site=site)
    ckv_new, kpe_new = _mla_latent(p, x, cfg, positions, site=site)
    if numerics.kv_quantized(pol):
        ckv_new, kpe_new = _kv_store(ckv_new, cfg), _kv_store(kpe_new, cfg)
    else:
        ckv_new = ckv_new.to(cache["ckv"].dtype)
        kpe_new = kpe_new.to(cache["kpe"].dtype)
    b_ix = torch.arange(B, device=x.device)
    old = None
    if active is not None:
        old = {n: cache[n][b_ix, pos].clone() for n in ("ckv", "kpe")}
    cache["ckv"][b_ix, pos] = ckv_new[:, 0]
    cache["kpe"][b_ix, pos] = kpe_new[:, 0]
    ckv = _kv_load(cache["ckv"], cfg).to(torch.float32)
    kpe = _kv_load(cache["kpe"], cfg).to(torch.float32)
    S = ckv.shape[1]

    w_uk = resolve_weight(p["w_uk"], numerics.weight_format(
        pol, f"{site}.w_uk"), x.dtype).reshape(L, H, dn)
    # absorb: q_eff[b, h, l] = sum_d q_nope[b, h, d] w_uk[l, h, d]
    q_eff = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].to(torch.float32),
                         w_uk.to(torch.float32))
    s = torch.einsum("bhl,bsl->bhs", q_eff, ckv)
    s = s + torch.einsum("bhr,bsr->bhs", q_pe[:, 0].to(torch.float32), kpe)
    s = s * (dn + dr) ** -0.5
    t = torch.arange(S, device=x.device)
    s = torch.where((t[None, :] <= pos[:, None])[:, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    pattn = torch.exp(s - m)
    den = pattn.sum(-1, keepdim=True)
    lat = torch.einsum("bhs,bsl->bhl", pattn / torch.clamp_min(den, 1e-37),
                       ckv)
    w_uv = resolve_weight(p["w_uv"], numerics.weight_format(
        pol, f"{site}.w_uv"), x.dtype).reshape(L, H, dv)
    out = torch.einsum("bhl,lhv->bhv", lat, w_uv.to(torch.float32))
    if old is not None:  # no host sync: every slot's row written again
        for n, rows in old.items():
            cache[n][b_ix, pos] = torch.where(
                active[:, None], cache[n][b_ix, pos], rows)
    return qlinear(out.reshape(B, 1, H * dv).to(x.dtype), p["wo"], pol,
                   site=f"{site}.wo")
