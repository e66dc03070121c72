"""Gemma3-12B [hf:google/gemma-3 family; unverified]: 5:1 local:global
attention, qk-norm, 128k context.  Single rope theta used, as in the
reference (the HF config has a local and a global theta)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    qk_norm=True,
    local_global_period=(6, 1),  # 5 local then 1 global
    window=1024,
    emb_scale=True,
    sandwich_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
    act_fn="gelu",
)
