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
    elementwise,
    kv_format,
    kv_fused_write_attend,
    kv_quantized,
    kv_stochastic,
    kv_write_token,
    matmul,
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
    "elementwise",
    "kv_format",
    "kv_fused_write_attend",
    "kv_quantized",
    "kv_stochastic",
    "kv_write_token",
    "matmul",
    "weight_format",
]
