"""Top-level model API of the port: init, the paged cache and the paged
decode/mixed steps of the serving path.

Port of the serving part of ``repro.models.model.Model`` for the dense GQA
family.  Parameters are a plain dict: ``embed`` [Vp, D], ``final_norm``
[D], optional ``unembed`` [D, Vp], and ``blocks``, a list of per-layer
dicts with the reference's names (``ln1``, ``attn.wq``/``bq``/...,
``ln2``, ``ffn.w_gate``/``w_up``/``w_down``).  :func:`params_from_jax`
carries a reference ``Model.init`` tree across (the tests' route); the
chip has no JAX, so :meth:`Model.init` draws the same distributions from
a torch ``Generator``.

The paged cache is {"kp", "vp": [n_layers, P, page, KV, hd] uint8,
"ks", "vs": [n_layers, P] float32}; the steps update it in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import numerics
from ..core import prng
from ..serving.page_pool import kv_noise
from .layers import rms_norm, softcap
from .transformer import stack_decode

NEG = -1.0e30


def _check_supported(cfg) -> None:
    if (cfg.family != "dense" or cfg.attn_impl != "gqa" or cfg.first_dense
            or cfg.n_experts):
        raise NotImplementedError(
            f"{cfg.name!r} (family={cfg.family!r}, attn={cfg.attn_impl!r}) "
            "is not ported yet; this slice runs dense GQA stacks "
            "(ROADMAP.md Queue 1 item 13)")
    if not numerics.kv_quantized(cfg.policy):
        raise NotImplementedError(
            "float KV pages are not ported yet; serve with an FP8 KV "
            "policy such as serve_fp8_paged")


def params_from_jax(np_params, cfg) -> Dict[str, Any]:
    """The reference's ``Model.init`` tree (numpy leaves, e.g. from
    ``jax.tree.map(np.asarray, params)``) as the port's parameter dict:
    the ``[n_blocks, ...]`` leading axis of ``params["blocks"]`` is
    unstacked into one dict per layer, names kept.  CPU float tensors in
    the leaves' dtype (bfloat16 leaves become torch bfloat16)."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    def tree(t, fn):
        if isinstance(t, dict):
            return {k: tree(v, fn) for k, v in t.items()}
        return fn(t)

    period = cfg.layer_pattern_period
    blocks = np_params["blocks"]
    n_blocks = np.asarray(blocks[0]["ln1"]).shape[0]
    layers = []
    for b in range(n_blocks):
        for j in range(period):
            layers.append(tree(blocks[j], lambda a: conv(a[b])))
    out = {k: conv(np_params[k])
           for k in ("embed", "final_norm", "unembed") if k in np_params}
    out["blocks"] = layers
    return out


class Model:
    def __init__(self, cfg, max_seq: int = 0):
        _check_supported(cfg)
        self.cfg = cfg
        self.max_seq = max_seq
        self._key_cache = None  # (key words, per-layer K/V write keys)

    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random parameters with the reference's distributions (weights
        N(0, 0.02^2), biases and norm gains 0), on ``generator.device``."""
        cfg = self.cfg
        dev, dt = generator.device, cfg.pdtype
        D, Vp = cfg.d_model, cfg.vocab_padded
        H, KV, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

        def normal(*shape):
            w = torch.randn(shape, generator=generator, device=dev)
            return (w * 0.02).to(dt)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        params: Dict[str, Any] = {"embed": normal(Vp, D)}
        layers = []
        for _ in range(cfg.n_layers):
            attn = {"wq": normal(D, H * hd), "wk": normal(D, KV * hd),
                    "wv": normal(D, KV * hd), "wo": normal(H * hd, D)}
            if cfg.qkv_bias:
                attn.update(bq=zeros(H * hd), bk=zeros(KV * hd),
                            bv=zeros(KV * hd))
            if cfg.qk_norm:
                attn.update(q_norm=zeros(hd), k_norm=zeros(hd))
            layer = {"ln1": zeros(D), "attn": attn, "ln2": zeros(D),
                     "ffn": {"w_gate": normal(D, F), "w_up": normal(D, F),
                             "w_down": normal(F, D)}}
            if cfg.sandwich_norm:
                layer.update(ln1_post=zeros(D), ln2_post=zeros(D))
            layers.append(layer)
        params["blocks"] = layers
        params["final_norm"] = zeros(D)
        if not cfg.tie_embeddings:
            params["unembed"] = normal(D, Vp)
        return params

    # ------------------------------------------------------------------ #
    def _embed(self, params, tokens):
        x = params["embed"][tokens]
        if self.cfg.emb_scale:
            x = x * torch.tensor(self.cfg.d_model**0.5, dtype=x.dtype)
        return x

    def _unembed(self, params, x):
        """Tied or untied LM head; padded vocab columns are set to NEG."""
        cfg = self.cfg
        w = params.get("unembed")
        logits = (x @ w if w is not None else x @ params["embed"].T)
        logits = softcap(logits.to(torch.float32), cfg.final_softcap)
        if cfg.vocab_padded > cfg.vocab:
            logits[..., cfg.vocab:] = NEG
        return logits

    def make_paged_cache(self, num_pages: int, page_size: int,
                         device) -> Dict[str, torch.Tensor]:
        """Zero codes and unit scales for a ``num_pages``-page pool (page 0
        is the reserved null page), stacked over layers."""
        cfg = self.cfg
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.hd)
        return {
            "kp": torch.zeros(shape, dtype=torch.uint8, device=device),
            "vp": torch.zeros(shape, dtype=torch.uint8, device=device),
            "ks": torch.ones((cfg.n_layers, num_pages), dtype=torch.float32,
                             device=device),
            "vs": torch.ones((cfg.n_layers, num_pages), dtype=torch.float32,
                             device=device),
        }

    # ------------------------------------------------------------------ #
    def kv_write_keys(self, key: torch.Tensor, device) -> torch.Tensor:
        """Per-layer (K, V) write keys [n_layers, 2, 2] of a step's stream
        key, derived exactly as the reference does: fold 0 (the block
        stack), split over blocks, fold the pattern index, split into the
        K and V keys.  Computed on the host once per key and cached."""
        words = tuple(int(v) for v in key.tolist())
        if self._key_cache is not None and self._key_cache[0] == (words, device):
            return self._key_cache[1]
        cfg = self.cfg
        period = cfg.layer_pattern_period
        n_blocks = cfg.n_layers // period
        k = torch.tensor(words, dtype=torch.int64)
        blocks = prng.split(prng.fold_in(k, 0), n_blocks)     # [nb, 2]
        per = torch.stack([prng.fold_in(blocks, j) for j in range(period)],
                          dim=1).reshape(cfg.n_layers, 2)
        keys = prng.split(per, 2).to(device)                    # [L, 2, 2]
        self._key_cache = ((words, device), keys)
        return keys

    def kv_noise(self, key: torch.Tensor, positions: torch.Tensor):
        """Stochastic-rounding noise of every KV write of a step, in one
        batched draw: positions [..., B] (each slot's write position) ->
        int64 [..., n_layers, 2, B, KV, hd].  Equal to the reference's
        ``randint(fold_in(k_or_v_key, position), (KV, hd), ...)``."""
        cfg = self.cfg
        keys = self.kv_write_keys(key, positions.device)        # [L, 2, 2]
        lead = positions.shape[:-1]
        pos = positions.reshape(*lead, 1, 1, positions.shape[-1])
        slot_keys = prng.fold_in(keys[..., None, :], pos)       # [.., L,2,B,2]
        fmt = numerics.kv_format(cfg.policy)
        return kv_noise(slot_keys, (cfg.n_kv_heads, cfg.hd), fmt)

    def _paged_token_step(self, params, cache, tokens, lengths,
                          block_tables, *, page_size: int, noise, active,
                          fused: bool):
        """One token per slot at position ``lengths``; returns logits."""
        paged = {"block_tables": block_tables, "lengths": lengths,
                 "page_size": page_size, "active": active, "fused": fused}
        x = self._embed(params, tokens[:, None])
        x = stack_decode(params["blocks"], cache, x, self.cfg, paged=paged,
                         noise=noise)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._unembed(params, x[:, 0])

    def decode_step_paged(self, params, cache, tokens, lengths, block_tables,
                          *, page_size: int, key=None, active=None,
                          fused: bool = True):
        """One decode step against the paged cache: tokens [B], lengths [B]
        (context BEFORE this token), block_tables [B, maxp].  ``key``: the
        stream key of stochastic KV writes (None => deterministic writes);
        ``active``: optional [B] bool write mask.  Returns (logits, cache)
        with the cache updated in place."""
        lengths = lengths.to(torch.int32)
        noise = None if key is None else self.kv_noise(key, lengths)
        logits = self._paged_token_step(
            params, cache, tokens, lengths, block_tables,
            page_size=page_size, noise=noise, active=active, fused=fused)
        return logits, cache

    def step_paged(self, params, cache, tokens, lengths, n_new,
                   block_tables, *, page_size: int, key=None,
                   fused: bool = True):
        """Mixed prefill+decode step (the continuous scheduler's call).

        tokens [B, T]; lengths [B] (context BEFORE the step); n_new [B]
        valid tokens per row (0 idle, 1 decode, >1 a prefill chunk).  Runs
        T single-token sub-steps: sub-step t feeds ``tokens[:, t]`` at
        position ``lengths + min(t, max(n_new - 1, 0))`` with write mask
        ``t < n_new``.  The noise of all T sub-steps is drawn in one
        batched call.  Returns (logits [B, vocab_padded] of each slot's
        last valid token — zeros for idle slots — and the cache)."""
        cfg = self.cfg
        B, T = tokens.shape
        lengths = lengths.to(torch.int32)
        t = torch.arange(T, dtype=torch.int32, device=tokens.device)[:, None]
        pos = lengths + torch.minimum(t, torch.clamp_min(n_new - 1, 0))
        noise = None if key is None else self.kv_noise(key, pos)
        last = torch.zeros((B, cfg.vocab_padded), dtype=torch.float32,
                           device=tokens.device)
        for i in range(T):
            act = i < n_new
            logits = self._paged_token_step(
                params, cache, tokens[:, i], pos[i].to(torch.int32),
                block_tables, page_size=page_size,
                noise=None if noise is None else noise[i], active=act,
                fused=fused)
            last = torch.where(act[:, None], logits, last)
        return last, cache
