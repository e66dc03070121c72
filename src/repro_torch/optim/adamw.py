"""AdamW with f32 master weights, global-norm clipping, warmup + cosine LR.

Port of ``repro.optim.adamw``: the reference's update computed as it
computes it (clip by the global norm, bias correction as ``1/(1-b^t)``,
decoupled weight decay as ``p - lr*(u + wd*p)``), which is not
``torch.optim.AdamW``'s update.  Trees are nested dicts and lists of
tensors (the port's parameter layout); the update is functional and
returns new tensors, like the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

__all__ = ["OptConfig", "schedule", "init", "global_norm", "update",
           "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts/lists/tuples (and of trees
    of the same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_frac*lr``."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> Dict[str, Any]:
    """Zero f32 moments shaped like ``params`` and an int32 step 0."""
    zeros = lambda t: tree_map(  # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        t)
    dev = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def update(grads, opt_state, params, cfg: OptConfig
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params, new_opt_state, stats).  params/grads f32."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)

    lr = schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, opt_state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, opt_state["v"],
                 grads)
    t = step.to(torch.float32)
    mhat_c = 1.0 / (1 - b1**t)
    vhat_c = 1.0 / (1 - b2**t)

    def upd(p, m_, v_):
        u = (m_ * mhat_c) / (torch.sqrt(v_ * vhat_c) + cfg.eps)
        return (p - lr * (u + cfg.weight_decay * p)).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
