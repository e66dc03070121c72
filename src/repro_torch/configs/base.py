"""Model configuration schema: the port's copy of ``repro.configs.base``.

One frozen dataclass describes every architecture of the reference's zoo;
this slice of the port runs the dense GQA family (qwen2-0.5b).  The
legacy ``QuantConfig`` shim is not ported: ``numerics`` holds the
:class:`~repro_torch.numerics.Policy` directly.  ``smoke()`` derives the
same reduced config as the reference for CPU tests.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..numerics.policy import Policy

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention flavor
    attn_impl: str = "gqa"  # gqa | mla | none
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    # sliding-window pattern: period P with the first (P - n_global) layers
    # local; window = local attention span.
    local_global_period: Tuple[int, int] = (1, 1)  # (period, n_global)
    window: int = 0

    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_period: int = 1
    moe_offset: int = 0
    first_dense: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "grouped"

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    attn_period: int = 1
    attn_offset: int = 0

    # enc-dec
    n_enc_layers: int = 0
    enc_context: int = 0

    # vlm
    n_img_tokens: int = 0

    # common
    act_fn: str = "silu"  # silu | gelu
    sandwich_norm: bool = False
    tie_embeddings: bool = False
    emb_scale: bool = False
    norm_eps: float = 1e-6
    pad_vocab_to: int = 2048  # pad embedding table for clean TP
    param_dtype: str = "bfloat16"
    remat_policy: str = "minimal"
    # The numerics policy; None => everything full precision.
    numerics: Optional[Policy] = None

    # ------------------------------------------------------------------ #
    @property
    def policy(self) -> Policy:
        """The numerics policy model layers consume."""
        return self.numerics if self.numerics is not None else Policy()

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        m = self.pad_vocab_to
        return -(-self.vocab // m) * m if m else self.vocab

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def is_attn_layer(self, i: int) -> bool:
        if self.attn_impl == "none":
            return False
        if self.family == "hybrid":
            return i % self.attn_period == self.attn_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return i >= self.first_dense and i % self.moe_period == self.moe_offset

    def is_global_attn_layer(self, i: int) -> bool:
        period, n_global = self.local_global_period
        return i % period >= period - n_global

    @property
    def layer_pattern_period(self) -> int:
        """Length of the repeating layer pattern (the reference's scan
        super-block size)."""
        p = self.local_global_period[0]
        if self.family == "hybrid":
            p = max(p, (self.attn_period * self.moe_period)
                    // math.gcd(self.attn_period, self.moe_period)
                    if self.moe_period else self.attn_period)
        elif self.n_experts:
            p = max(p, self.moe_period)
        return p

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        period = self.layer_pattern_period
        changes = dict(
            name=self.name + "-smoke",
            n_layers=max(2 * period, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128,
            vocab=256,
            pad_vocab_to=64,
            window=min(self.window, 32) if self.window else 0,
        )
        if self.attn_impl == "mla":
            changes.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                           v_head_dim=16)
        if self.n_experts:
            changes.update(n_experts=min(self.n_experts, 8),
                           top_k=min(self.top_k, 2), moe_d_ff=64)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_head_dim=16)
        if self.n_enc_layers:
            changes.update(n_enc_layers=2, enc_context=32)
        if self.n_img_tokens:
            changes.update(n_img_tokens=16)
        return dataclasses.replace(self, **changes)
