"""Jamba-v0.1-52B [arXiv:2403.19887; hf]: hybrid Mamba+attention 1:7
interleave (attention at layer i % 8 == 4), MoE 16 experts top-2 every
other layer (a copy of the reference's config).  The SSM mixer is the
port's Mamba2 SSD block, as in the reference (Jamba v0.1 ships Mamba-1
with d_state 16).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_period=2,
    moe_offset=1,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_period=8,
    attn_offset=4,
    act_fn="silu",
)
