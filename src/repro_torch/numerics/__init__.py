"""Numerics policy (which FP8 format, rounding mode and kernel per op
class) and the functional API that resolves it; the port of
``repro.numerics``."""
from .policy import (
    OP_CLASSES,
    OpPolicy,
    Override,
    Policy,
    available_policies,
    get_policy,
    register_policy,
)
from .api import (
    attention,
    dequantize_weight,
    elementwise,
    is_quantized_weight,
    kv_decode,
    kv_encode,
    kv_format,
    kv_fused_write_attend,
    kv_quantized,
    kv_stochastic,
    kv_write_prefill,
    kv_write_token,
    matmul,
    static_matmul_2d,
    weight_format,
)

__all__ = [
    "OP_CLASSES",
    "OpPolicy",
    "Override",
    "Policy",
    "available_policies",
    "get_policy",
    "register_policy",
    "attention",
    "dequantize_weight",
    "elementwise",
    "is_quantized_weight",
    "kv_decode",
    "kv_encode",
    "kv_format",
    "kv_fused_write_attend",
    "kv_quantized",
    "kv_stochastic",
    "kv_write_prefill",
    "kv_write_token",
    "matmul",
    "static_matmul_2d",
    "weight_format",
]
