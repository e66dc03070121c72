"""Granite-MoE-3B-A800M [hf:ibm-granite family; hf]: 40 experts, top-8,
per-expert d_ff 512 (every layer MoE, no dense MLP).  Granite's logit/
embedding multipliers are omitted (noted in DESIGN.md)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    moe_period=1,
    tie_embeddings=True,
    act_fn="silu",
)
