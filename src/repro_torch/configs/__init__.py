"""Architecture registry of the port: ``get_config(arch_id)``.

This slice of the port serves the dense GQA family; the reference's other
architectures (MoE, MLA, SSM, hybrid, enc-dec, VLM) arrive with later
slices and are refused by name until then.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ModelConfig
from .qwen2_0_5b import CONFIG as _qwen2

CONFIGS: Dict[str, ModelConfig] = {c.name: c for c in [_qwen2]}


def get_config(arch: str, *, smoke: bool = False, policy=None) -> ModelConfig:
    """Config lookup + numerics selection.  ``policy``: a
    :class:`repro_torch.numerics.Policy`, a registered preset name
    (``serve_fp8_paged``, ...), or None (full precision)."""
    if arch not in CONFIGS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet; this slice serves "
            f"{sorted(CONFIGS)} (ROADMAP.md Queue 1 item 13)")
    cfg = CONFIGS[arch]
    if smoke:
        cfg = cfg.smoke()
    if policy is not None:
        from ..numerics import get_policy

        cfg = dataclasses.replace(cfg, numerics=get_policy(policy))
    return cfg


__all__ = ["CONFIGS", "ModelConfig", "get_config"]
