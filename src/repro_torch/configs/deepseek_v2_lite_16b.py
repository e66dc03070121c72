"""DeepSeek-V2-Lite-16B [arXiv:2405.04434; hf]: MLA (kv_lora 512, rope 64,
nope 128), MoE 64 routed top-6 + 2 shared, first layer dense (d_ff 10944).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,        # qk = nope(128) + rope(64)
    d_ff=10944,          # the dense first layer
    vocab=102400,
    attn_impl="mla",
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    moe_period=1,
    first_dense=1,
    act_fn="silu",
)
