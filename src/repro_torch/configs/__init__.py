"""Architecture registry of the port: ``get_config(arch_id)``.

The port runs the dense GQA family; the reference's other architectures
(MoE, MLA, SSM, hybrid, enc-dec, VLM) arrive with later slices and are
refused by name until then.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from .base import ModelConfig
from .qwen2_0_5b import CONFIG as _qwen2

CONFIGS: Dict[str, ModelConfig] = {c.name: c for c in [_qwen2]}


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
            f"architecture {arch!r} is not ported yet; this slice runs "
            f"{sorted(CONFIGS)} (ROADMAP.md Queue 1 item 13)")
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
