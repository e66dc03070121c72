"""Architecture registry of the port: ``get_config(arch_id)``.

The port runs the dense GQA family (qwen2-0.5b, qwen3-14b, gemma2-27b,
gemma3-12b), the MoE stack with GQA attention (granite-moe-3b-a800m) and
MLA with MoE, shared experts and a leading dense layer
(deepseek-v2-lite-16b), each served and trained, the attention-free SSM
stack (mamba2-780m), served and trained, and the hybrid SSD + GQA + MoE
stack (jamba-v0.1-52b), served; the reference's other architectures
(enc-dec, VLM) arrive with later slices and are refused by name until
then.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from .base import ModelConfig
from .deepseek_v2_lite_16b import CONFIG as _deepseek
from .gemma2_27b import CONFIG as _gemma2
from .gemma3_12b import CONFIG as _gemma3
from .granite_moe_3b import CONFIG as _granite
from .jamba_v01_52b import CONFIG as _jamba
from .mamba2_780m import CONFIG as _mamba2
from .qwen2_0_5b import CONFIG as _qwen2
from .qwen3_14b import CONFIG as _qwen3

CONFIGS: Dict[str, ModelConfig] = {
    c.name: c for c in [_qwen2, _gemma2, _qwen3, _gemma3, _granite,
                        _deepseek, _mamba2, _jamba]}

# the reference's architectures of later slices, with their ROADMAP.md
# Queue 1 items
_LATER = {"whisper-base": "11e", "llava-next-mistral-7b": "11f"}


def legacy_quant_config(quant: str) -> Dict[str, Any]:
    """The historical ``--quant`` flag values as the fields of the
    reference's ``QuantConfig`` (a dict; the port has no such class).
    ``numerics.policy.from_quant_config`` maps them onto a policy."""
    if quant == "none":
        return {}
    if quant == "fp8_w8":  # static weight-only FP8 (inference)
        return dict(enabled=False, static_weights=True)
    if quant == "fp8_w8kv8":  # weights + KV cache in FP8 (serving)
        return dict(enabled=False, static_weights=True, kv_cache_fp8=True)
    if quant == "fp8_w8_train":  # weight-only quantized training
        return dict(enabled=True, act_quant=False)
    impl = {"fp8_lns": "xla", "fp8_lns_pallas": "lns"}[quant]
    return dict(enabled=True, matmul_impl=impl)


LEGACY_QUANTS = ("none", "fp8_w8", "fp8_w8kv8", "fp8_w8_train", "fp8_lns",
                 "fp8_lns_pallas")


def get_config(arch: str, *, quant: str = "none", smoke: bool = False,
               policy=None) -> ModelConfig:
    """Config lookup + numerics selection.

    ``policy``: a :class:`repro_torch.numerics.Policy` or a registered
    preset name (``serve_fp8_paged``, ``train_fp8``, ...).  ``quant``: the
    deprecated flat flag (``--quant fp8_lns_pallas`` ...), mapped to the
    same policy as the reference's ``QuantConfig.to_policy()``; passing
    both is an error.  With neither, the policy is the one of the
    reference's default ``QuantConfig`` (everything full precision)."""
    if arch not in CONFIGS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet; the port runs "
            f"{sorted(CONFIGS)}; enc-dec and VLM architectures arrive with "
            "later slices (ROADMAP.md Queue 1 item "
            f"{_LATER.get(arch, '11e-11f')})")
    cfg = CONFIGS[arch]
    if smoke:
        cfg = cfg.smoke()
    if policy is not None:
        if quant != "none":
            raise ValueError(
                f"pass either policy={policy!r} or the deprecated "
                f"quant={quant!r}, not both")
        from ..numerics import get_policy

        return dataclasses.replace(cfg, numerics=get_policy(policy))
    from ..numerics.policy import from_quant_config

    return dataclasses.replace(
        cfg, numerics=from_quant_config(legacy_quant_config(quant)))


__all__ = ["CONFIGS", "LEGACY_QUANTS", "ModelConfig", "get_config",
           "legacy_quant_config"]
