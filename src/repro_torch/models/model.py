"""Top-level model API of the port: init, the training loss, prefill and
dense-cache decode (the bucketed scheduler's model calls), and the paged
cache with the paged decode/mixed steps of the serving path.

Port of ``repro.models.model.Model`` for attention stacks: the dense GQA
family (qwen2, qwen3's qk-norm, gemma2/3's sandwich norms, embedding
scale, local/global windows and softcaps), the MoE family (granite-moe-3b-
a800m), served and trained (the loss adds the MoE aux terms), and MLA with
MoE, shared experts and a leading dense layer (deepseek-v2-lite-16b),
served and trained; for the attention-free SSM stack (mamba2-780m),
served and trained; and for the hybrid stack (jamba-v0.1-52b: SSD layers
with one GQA layer a period, MoE and MLP FFNs alternating), served.
Parameters are a plain dict: ``embed`` [Vp, D], ``final_norm`` [D],
optional ``unembed`` [D, Vp], ``blocks``, a list of per-layer dicts with
the reference's names (``ln1``, ``attn.wq``/``bq``/..., ``ln2``,
``ffn.w_gate``/``w_up``/``w_down``; an MoE layer's ``ffn`` is ``router``
float32 [D, E], ``w_gate``/``w_up`` [E, D, F], ``w_down`` [E, F, D] and,
with shared experts, ``shared``; an MLA layer's ``attn`` is ``wq``,
``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv``, ``wo``), and, with
``first_dense`` leading layers, ``prefix``, their list (the reference's
``params["prefix"]``; each an MLP of ``d_ff``).  An SSD layer is ``ln1``
and ``mamba`` (``w_z``, ``w_x``, ``w_B``, ``w_C``, ``w_dt``, the conv
weights and bias, float32 ``A_log``/``Dskip``/``dt_bias``, ``norm``,
``out_proj``), with an FFN where the pattern gives it one (none in
mamba2, an MoE layer or an MLP in jamba).  :func:`params_from_jax`
carries a reference ``Model.init`` tree across (the tests' route); the
chip has no JAX, so :meth:`Model.init` draws the same distributions from
a torch ``Generator``.

The paged cache of a GQA stack is {"kp", "vp": [n_layers, P, page, KV,
hd], "ks", "vs": [n_layers, P] float32}: uint8 FP8 codes with their page
scales when the policy quantizes the KV cache, pages of the parameters'
dtype (scales unread) otherwise; the steps update it in place.  MLA keeps
no pages: its paged cache is the dense per-slot latents {"ckv": [n_layers,
B, S, L], "kpe": [n_layers, B, S, dr]} beside the page pool (the
reference's ``_entry_cache_paged``), scale-1 FP8 codes or floats, and the
pool only accounts for the slots' tokens.  An SSD layer keeps its
{"conv": [n, B, w - 1, d_inner + 2 N] of the parameters' dtype, "state":
[n, B, heads, head_dim, N] float32} per slot likewise, stacked over the
``n`` SSD layers (each mixer's leaves over its own layers).  ``SLOT_LEAVES`` names the leaves indexed
by slot on their second axis (the others by page).  The dense cache is
one dict per layer, {"k", "v": [B, W, KV, hd]}, MLA's {"ckv", "kpe"}
or SSD's {"conv", "state"}, scale-1 FP8 codes or floats of the
parameters' dtype (SSD's as in the paged cache),
with ``W = min(S, window)`` rows for local layers (a ring buffer) and
``S`` for global ones.  Static FP8 weights
(``models.quantize``) are ``QTensor`` leaves in place of float ones.

On a tensor-parallel mesh (``parallel``) a rank's parameters are its cut
of the whole tree (:meth:`Model.init`'s ``leaf`` hook): the embedding
rows are read from their owner (``hints.tp_lookup``), the vocab-sharded
logits are masked at their global columns and gathered, and each rank's
noise is its KV heads' block of the whole draw.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .. import numerics
from ..core import prng
from ..core.quant import QTensor
from ..parallel.hints import (hint, shard_start, tp_columns, tp_local,
                              tp_lookup)
from ..serving.page_pool import kv_noise
from .attention import mla_init
from .layers import rms_norm, softcap
from .mamba2 import dims as ssd_dims
from .mamba2 import mamba2_init
from .moe import moe_init
from .quantize import resolve_weight
from .transformer import (SSD_LEAVES, ffn_kind, mixer_kind, stack_decode,
                          stack_forward)

NEG = -1.0e30

# the paged cache's leaves indexed by slot on their second axis (MLA's
# dense per-slot latents, SSD's conv inputs and states); every other leaf
# is indexed by page there
SLOT_LEAVES = ("ckv", "kpe") + SSD_LEAVES

# families of later slices, with their ROADMAP.md Queue 1 items
_LATER = {"encdec": "11e", "vlm": "11f"}


def _check_supported(cfg) -> None:
    item = _LATER.get(cfg.family)
    attention = (cfg.family in ("dense", "moe")
                 and cfg.attn_impl in ("gqa", "mla")
                 and (cfg.family == "dense") == (cfg.n_experts == 0))
    ssm = (cfg.family == "ssm" and cfg.attn_impl == "none"
           and not cfg.n_experts)
    hybrid = (cfg.family == "hybrid" and cfg.attn_impl == "gqa"
              and not cfg.first_dense)
    if item is not None or not (attention or ssm or hybrid):
        raise NotImplementedError(
            f"{cfg.name!r} (family={cfg.family!r}, attn={cfg.attn_impl!r}) "
            "is not ported yet; the port runs dense GQA stacks (qwen2, "
            "qwen3, gemma2, gemma3), MoE GQA stacks (granite), MLA with "
            "MoE, shared experts and leading dense layers (deepseek), SSM "
            "stacks (mamba2) and hybrid SSD + GQA stacks with MoE or MLP "
            "FFNs (jamba); enc-dec and VLM families arrive with later "
            "slices (ROADMAP.md Queue 1 item "
            f"{item or '11, 11e-11f'})")


def attention_layers(cfg) -> list:
    """The absolute indices of the layers whose mixer is attention, in
    order (every layer of a dense or MoE stack; none of an SSM stack;
    ``i % attn_period == attn_offset`` of a hybrid one)."""
    return [i for i in range(cfg.n_layers) if mixer_kind(cfg, i) == "attn"]


def params_from_jax(np_params, cfg) -> Dict[str, Any]:
    """The reference's ``Model.init`` tree (numpy leaves, e.g. from
    ``jax.tree.map(np.asarray, params)``) as the port's parameter dict:
    the ``[n_blocks, ...]`` leading axis of ``params["blocks"]`` is
    unstacked into one dict per layer, names kept.  CPU float tensors in
    the leaves' dtype and shape (bfloat16 leaves become torch bfloat16;
    an MoE layer's 3-D experts and float32 router come across as they
    are).  A
    quantized tree (``quantize_params``: ``QTensor`` leaves with codes
    ``[n_blocks, ...]`` and per-block scales ``[n_blocks, 1, 1]``) becomes
    port ``QTensor`` leaves, one per layer with its block's scale as a
    scalar.  The reference's ``prefix`` tuple (``first_dense`` leading
    layers, unstacked there) becomes the list ``prefix``."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    def tree(t, fn):
        if isinstance(t, dict):
            return {k: tree(v, fn) for k, v in t.items()}
        if hasattr(t, "codes") and hasattr(t, "scale"):  # a QTensor
            return QTensor(codes=fn(t.codes),
                           scale=fn(t.scale).to(torch.float32).reshape(()),
                           fmt=t.fmt)
        return fn(t)

    period = cfg.layer_pattern_period
    blocks = np_params["blocks"]
    n_blocks = np.asarray(blocks[0]["ln1"]).shape[0]
    layers = []
    for b in range(n_blocks):
        for j in range(period):
            layers.append(tree(blocks[j], lambda a: conv(a[b])))
    out = {k: tree(np_params[k], conv)
           for k in ("embed", "final_norm", "unembed") if k in np_params}
    out["blocks"] = layers
    if "prefix" in np_params:
        out["prefix"] = [tree(p, conv) for p in np_params["prefix"]]
    return out


class Model:
    def __init__(self, cfg, max_seq: int = 0):
        _check_supported(cfg)
        self.cfg = cfg
        self.max_seq = max_seq
        self._key_cache = None  # (key words, per-layer K/V write keys)

    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator, leaf=None) -> Dict[str, Any]:
        """Random parameters with the reference's distributions (weights
        N(0, 0.02^2), biases and norm gains 0), on ``generator.device``.
        ``leaf(path, tensor)``, when given, maps every leaf as soon as it
        is drawn (``path`` e.g. ``("blocks", 3, "attn", "wq")``, or
        ``("prefix", 0, ...)`` for a leading dense layer), so a mesh
        engine keeps its cut of each weight and never holds the whole
        tree; the draws are the same either way."""
        cfg = self.cfg
        dev, dt = generator.device, cfg.pdtype
        D, Vp = cfg.d_model, cfg.vocab_padded
        H, KV, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
        put = leaf if leaf is not None else (lambda path, t: t)

        def normal(path, *shape):
            w = torch.randn(shape, generator=generator, device=dev)
            return put(path, (w * 0.02).to(dt))

        def zeros(path, *shape):
            return put(path, torch.zeros(shape, dtype=dt, device=dev))

        def layer(path, i):
            a, f = path + ("attn",), path + ("ffn",)
            if mixer_kind(cfg, i) == "mamba":
                return {"ln1": zeros(path + ("ln1",), D),
                        "mamba": mamba2_init(generator, cfg, put,
                                             path + ("mamba",)),
                        **ffn_leaves(path, i)}
            if cfg.attn_impl == "mla":
                attn = mla_init(normal, zeros, cfg, a)
            else:
                attn = {"wq": normal(a + ("wq",), D, H * hd),
                        "wk": normal(a + ("wk",), D, KV * hd),
                        "wv": normal(a + ("wv",), D, KV * hd),
                        "wo": normal(a + ("wo",), H * hd, D)}
            if cfg.qkv_bias:
                attn.update(bq=zeros(a + ("bq",), H * hd),
                            bk=zeros(a + ("bk",), KV * hd),
                            bv=zeros(a + ("bv",), KV * hd))
            if cfg.qk_norm:
                attn.update(q_norm=zeros(a + ("q_norm",), hd),
                            k_norm=zeros(a + ("k_norm",), hd))
            out = {"ln1": zeros(path + ("ln1",), D), "attn": attn,
                   **ffn_leaves(path, i)}
            if cfg.sandwich_norm:
                out.update(ln1_post=zeros(path + ("ln1_post",), D),
                           ln2_post=zeros(path + ("ln2_post",), D))
            return out

        def ffn_leaves(path, i):
            f = path + ("ffn",)
            kind = ffn_kind(cfg, i)
            if kind == "none":
                return {}
            ffn = (moe_init(generator, cfg, put, f) if kind == "moe" else
                   {"w_gate": normal(f + ("w_gate",), D, F),
                    "w_up": normal(f + ("w_up",), D, F),
                    "w_down": normal(f + ("w_down",), F, D)})
            return {"ln2": zeros(path + ("ln2",), D), "ffn": ffn}

        n0 = cfg.first_dense
        params: Dict[str, Any] = {"embed": normal(("embed",), Vp, D)}
        if n0:
            params["prefix"] = [layer(("prefix", i), i) for i in range(n0)]
        params["blocks"] = [layer(("blocks", j), n0 + j)
                            for j in range(cfg.n_layers - n0)]
        params["final_norm"] = zeros(("final_norm",), D)
        if not cfg.tie_embeddings:
            params["unembed"] = normal(("unembed",), D, Vp)
        return params

    @staticmethod
    def layers(params) -> list:
        """Every layer's parameters in order: the ``prefix`` (leading dense)
        layers, then ``blocks``."""
        return list(params.get("prefix", ())) + list(params["blocks"])

    # ------------------------------------------------------------------ #
    def _embed(self, params, tokens):
        x = tp_lookup(params["embed"], tokens)  # rows may be sharded
        if self.cfg.emb_scale:
            x = x * torch.tensor(self.cfg.d_model**0.5, dtype=x.dtype)
        return x

    def _unembed(self, params, x):
        """Tied or untied LM head over [..., D] (2-D decode or 3-D train
        activations); padded vocab columns are set to NEG.  On a mesh the
        columns are this rank's block of the vocabulary, masked at their
        global indices, and 2-D decode logits are gathered whole."""
        cfg = self.cfg
        w = params.get("unembed")
        if w is not None:
            w = resolve_weight(
                w, numerics.weight_format(cfg.policy, "unembed"), x.dtype)
        Vp = cfg.vocab_padded
        if w is not None:
            logits = tp_columns(torch.matmul, x, w, Vp)
        else:
            logits = tp_columns(lambda x_, e: x_ @ e.T, x, params["embed"],
                                Vp, dim=0)
        logits = softcap(logits.to(torch.float32), cfg.final_softcap)
        if cfg.vocab_padded > cfg.vocab:
            n = logits.shape[-1]
            lo = shard_start(n, cfg.vocab_padded)
            keep = torch.arange(lo, lo + n, device=logits.device) < cfg.vocab
            logits = torch.where(keep, logits, NEG)
        if logits.ndim == 2:
            logits = hint(logits, "logits_decode")
        return logits

    def _assemble_inputs(self, params, batch) -> Tuple[Any, Any, Any]:
        """Returns (x, positions, labels) of a {tokens, labels} batch (the
        dense family; the reference's VLM and enc-dec inputs are not
        ported)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        return x, positions, batch.get("labels")

    # ------------------------------------------------------------------ #
    def loss_fn(self, params, batch):
        """The reference's loss, ``ce + 0.01 moe_lb + 1e-3 moe_z``, and its
        metrics {ce, moe_lb, moe_z}: the mean next-token cross entropy over
        the valid positions (``labels`` < 0 are ignored, as is the last
        position, the reference's mask; the CE runs over the padded
        vocabulary with the padding at NEG), and the MoE layers' Switch
        load-balance and router z-losses, each summed over layers
        (:func:`stack_forward`).  The dense family has no MoE auxiliary
        terms: they are zeros, as in the reference."""
        cfg = self.cfg
        x, positions, labels = self._assemble_inputs(params, batch)
        x, moe_aux = stack_forward(self.layers(params), x, cfg,
                                   positions=positions)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._unembed(params, x)
        S = x.shape[1]
        pos = torch.arange(S, device=x.device)[None, :]
        mask = ((labels >= 0) & (pos < S - 1)).to(torch.float32)
        safe = torch.clamp_min(labels, 0).to(torch.int64)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe[..., None])[..., 0]
        ce = ((lse - ll) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {k: zero + v for k, v in moe_aux.items()}
        loss = ce + 0.01 * aux["moe_lb"] + 1e-3 * aux["moe_z"]
        return loss, {"ce": ce, **aux}

    # ------------------------------------------------------------------ #
    def prefill(self, params, batch):
        """Full-sequence forward of a batch of equal-length prompts
        {"tokens" [n, S]}: the last position's logits [n, vocab_padded]
        (float32) and one dense cache entry per layer ({"k", "v"} [n, S,
        KV, hd], or MLA's {"ckv", "kpe"}), in the dense cache's
        representation."""
        cfg = self.cfg
        x, positions, _ = self._assemble_inputs(params, batch)
        x, caches = stack_forward(self.layers(params), x, cfg,
                                  positions=positions, mode="prefill")
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x[:, -1]), caches

    def decode_step(self, params, cache, tokens, pos):
        """One decode step against the dense cache: tokens [B], pos a scalar
        or [B] per-slot positions (each slot's new row).  Returns (logits
        [B, vocab_padded] float32, the cache, updated in place)."""
        cfg = self.cfg
        B = tokens.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int64,
                              device=tokens.device).expand(B)
        x = self._embed(params, tokens[:, None])
        x = stack_decode(self.layers(params), cache, x, cfg, pos=pos)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._unembed(params, x[:, 0]), cache

    def _entry_cache(self, i: int, B: int, S: int, device):
        """Layer ``i``'s zero dense cache entry: SSD's {"conv" [B, w - 1,
        d_inner + 2 N] in the parameters' dtype, "state" [B, heads,
        head_dim, N] float32}, MLA's latents {"ckv" [B, S, L], "kpe" [B,
        S, dr]}, or GQA's {"k", "v"}, where a sliding-window layer never
        attends past its window, so it keeps a ring buffer of ``min(S,
        window)`` rows (keys carry RoPE from their absolute position, so
        the rows' order does not matter)."""
        cfg = self.cfg
        if mixer_kind(cfg, i) == "mamba":
            return self._ssd_entry((B,), device)
        dt = (torch.uint8 if numerics.kv_quantized(cfg.policy)
              else cfg.pdtype)
        if cfg.attn_impl == "mla":
            return {"ckv": torch.zeros((B, S, cfg.kv_lora_rank), dtype=dt,
                                       device=device),
                    "kpe": torch.zeros((B, S, cfg.qk_rope_dim), dtype=dt,
                                       device=device)}
        S_eff = S
        if cfg.window and not cfg.is_global_attn_layer(i):
            S_eff = min(S, cfg.window)
        shape = (B, S_eff, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def _ssd_entry(self, lead: tuple, device) -> Dict[str, torch.Tensor]:
        """Zero SSD leaves {conv, state} with the leading axes ``lead``
        (the reference's ``_entry_cache``: the conv inputs in the
        parameters' dtype, whatever the KV policy, the state float32)."""
        cfg = self.cfg
        di, nh, P, N = ssd_dims(cfg)
        return {"conv": torch.zeros(
                    lead + (cfg.ssm_conv_width - 1, di + 2 * N),
                    dtype=cfg.pdtype, device=device),
                "state": torch.zeros(lead + (nh, P, N),
                                     dtype=torch.float32, device=device)}

    def make_cache(self, B: int, S: int, device=None):
        """Zero dense decode cache of ``B`` slots and ``S`` positions: one
        :meth:`_entry_cache` per layer."""
        return [self._entry_cache(i, B, S, device)
                for i in range(self.cfg.n_layers)]

    # ------------------------------------------------------------------ #
    def make_paged_cache(self, num_pages: int, page_size: int, device,
                         slots: int = 0, max_seq: int = 0
                         ) -> Dict[str, torch.Tensor]:
        """Zero pages and unit scales for a ``num_pages``-page pool (page 0
        is the reserved null page), stacked over layers: uint8 codes when
        the policy quantizes the KV cache, else ``cfg.pdtype``.  MLA keeps
        its latents as dense per-slot rows instead (``slots`` x
        ``max_seq``, default the model's ``max_seq``), stacked over layers:
        {"ckv" [n_layers, slots, S, L], "kpe" [n_layers, slots, S, dr]}.
        SSD layers keep {"conv", "state"} per slot (:meth:`_ssd_entry`),
        stacked over the SSD layers: each mixer contributes its own leaves,
        over its own layers."""
        cfg = self.cfg
        n_ssd = sum(mixer_kind(cfg, i) == "mamba"
                    for i in range(cfg.n_layers))
        n_attn = cfg.n_layers - n_ssd
        cache: Dict[str, torch.Tensor] = {}
        if n_ssd:
            if not slots:
                raise ValueError("SSD layers keep dense per-slot states: "
                                 "pass slots")
            cache.update(self._ssd_entry((n_ssd, slots), device))
        if not n_attn:
            return cache
        dt = (torch.uint8 if numerics.kv_quantized(cfg.policy)
              else cfg.pdtype)
        if cfg.attn_impl == "mla":
            S = max_seq or self.max_seq
            if not (slots and S):
                raise ValueError("MLA's paged cache holds dense per-slot "
                                 "latents: pass slots and max_seq")
            cache.update({name: torch.zeros((n_attn, slots, S, width),
                                            dtype=dt, device=device)
                          for name, width in (("ckv", cfg.kv_lora_rank),
                                              ("kpe", cfg.qk_rope_dim))})
            return cache
        shape = (n_attn, num_pages, page_size, cfg.n_kv_heads, cfg.hd)
        cache.update(
            kp=torch.zeros(shape, dtype=dt, device=device),
            vp=torch.zeros(shape, dtype=dt, device=device),
            ks=torch.ones((n_attn, num_pages), dtype=torch.float32,
                          device=device),
            vs=torch.ones((n_attn, num_pages), dtype=torch.float32,
                          device=device))
        return cache

    # ------------------------------------------------------------------ #
    def kv_write_keys(self, key: torch.Tensor, device) -> torch.Tensor:
        """The attention layers' (K, V) write keys [n_attn, 2, 2] of a
        step's stream key, in layer order, derived exactly as the
        reference does: fold 0 (the block stack), split over blocks, fold
        the pattern index, split into the K and V keys; a leading dense
        layer ``i`` folds ``1 + i`` instead of the stack's 0.  Layers
        whose mixer keeps no pages (SSD) take no key: in a hybrid stack
        attention layer ``i`` takes block ``(i - first_dense) // period``'s
        key folded with pattern index ``(i - first_dense) % period``.
        Computed on the host once per key and cached."""
        words = tuple(int(v) for v in key.tolist())
        if self._key_cache is not None and self._key_cache[0] == (words, device):
            return self._key_cache[1]
        cfg = self.cfg
        period = cfg.layer_pattern_period
        n0 = cfg.first_dense
        n_blocks = (cfg.n_layers - n0) // period
        k = torch.tensor(words, dtype=torch.int64)
        blocks = prng.split(prng.fold_in(k, 0), n_blocks)     # [nb, 2]
        per = torch.stack([prng.fold_in(blocks, j) for j in range(period)],
                          dim=1).reshape(n_blocks * period, 2)
        if n0:
            per = torch.cat([prng.fold_in(k, torch.arange(1, 1 + n0)), per])
        per = per[attention_layers(cfg)]
        keys = prng.split(per, 2).to(device)                    # [A, 2, 2]
        self._key_cache = ((words, device), keys)
        return keys

    def kv_noise(self, key, positions: torch.Tensor):
        """Stochastic-rounding noise of every KV write of a step, in one
        batched draw: positions [..., B] (each slot's write position) ->
        int64 [..., n_attn, 2, B, KV, hd], one entry per attention layer
        in order (``stack_decode`` indexes it by the attention layers' own
        count).  Equal to the reference's ``randint(fold_in(k_or_v_key,
        position), (KV, hd), ...)``.  None without a key, when the pages
        are float (their writes draw no noise) or when no layer keeps its
        KV in pages (MLA's latents are dense rows, encoded RNE; an SSM
        stack has no KV).  On a mesh: this rank's KV heads of the whole
        draw, the bits the reference's partitionable threefry gives a
        shard."""
        cfg = self.cfg
        if (key is None or not numerics.kv_quantized(cfg.policy)
                or cfg.attn_impl != "gqa"):
            return None
        keys = self.kv_write_keys(key, positions.device)        # [A, 2, 2]
        lead = positions.shape[:-1]
        pos = positions.reshape(*lead, 1, 1, positions.shape[-1])
        slot_keys = prng.fold_in(keys[..., None, :], pos)       # [.., A,2,B,2]
        fmt = numerics.kv_format(cfg.policy)
        return tp_local(kv_noise(slot_keys, (cfg.n_kv_heads, cfg.hd), fmt),
                        -2)

    def _paged_token_step(self, params, cache, tokens, lengths,
                          block_tables, *, page_size: int, noise, active,
                          fused: bool):
        """One token per slot at position ``lengths``; returns logits."""
        paged = {"block_tables": block_tables, "lengths": lengths,
                 "page_size": page_size, "active": active, "fused": fused}
        x = self._embed(params, tokens[:, None])
        x = stack_decode(self.layers(params), cache, x, self.cfg,
                         paged=paged, noise=noise)
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
        noise = self.kv_noise(key, lengths)
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
        noise = self.kv_noise(key, pos)
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
