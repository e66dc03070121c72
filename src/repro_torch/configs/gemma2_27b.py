"""Gemma2-27B [arXiv:2408.00118; hf]: alternating local/global attention,
attention + final logit softcaps, sqrt(d) embedding scale."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    attn_softcap=50.0,
    final_softcap=30.0,
    local_global_period=(2, 1),  # local, global, local, global, ...
    window=4096,
    emb_scale=True,
    sandwich_norm=True,
    tie_embeddings=True,
    act_fn="gelu",
)
