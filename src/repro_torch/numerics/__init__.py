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
    kv_format,
    kv_fused_write_attend,
    kv_quantized,
    kv_stochastic,
    kv_write_token,
    matmul,
    mul,
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
    "kv_format",
    "kv_fused_write_attend",
    "kv_quantized",
    "kv_stochastic",
    "kv_write_token",
    "matmul",
    "mul",
]
