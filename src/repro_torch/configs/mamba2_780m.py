"""Mamba2-780M [arXiv:2405.21060; unverified]: attention-free SSD stack (a
copy of the reference's config).

48 layers, d_model 1536, expand 2 (d_inner 3072), head_dim 64 (48 SSD
heads), d_state 128, short conv width 4.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,       # SSD heads = d_inner / ssm_head_dim
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    attn_impl="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    tie_embeddings=True,
    act_fn="silu",
)
