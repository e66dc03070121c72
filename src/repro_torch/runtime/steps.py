"""The train state and the train step: port of the training part of
``repro.runtime.steps``.

The state is ``{"params": f32 master weights, "opt": AdamW moments and
step}``.  A step casts the master weights to the config's parameter dtype
inside the loss (a differentiable cast), so the gradients come back to the
master in float32, then applies the AdamW update.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..models.model import Model
from ..optim import adamw
from ..optim.adamw import tree_leaves, tree_map

__all__ = ["make_train_state", "build_train_step"]


def make_train_state(model: Model, generator: Optional[torch.Generator] = None,
                     *, params=None) -> Dict[str, Any]:
    """f32 master weights (of ``params``, or of ``model.init(generator)``)
    plus zero AdamW state."""
    if params is None:
        params = model.init(generator)
    master = tree_map(lambda p: p.detach().to(torch.float32).clone(), params)
    return {"params": master, "opt": adamw.init(master)}


def build_train_step(model: Model, opt_cfg: adamw.OptConfig) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``; ``batch`` is
    {tokens, labels} on the state's device."""
    cfg = model.cfg

    def train_step(state, batch):
        master = tree_map(lambda p: p.detach().requires_grad_(True),
                          state["params"])
        compute = tree_map(lambda p: p.to(cfg.pdtype), master)
        loss, metrics = model.loss_fn(compute, batch)
        leaves = tree_leaves(master)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads)])
        grads = tree_map(lambda _: next(grads), master)
        new_params, new_opt, stats = adamw.update(
            grads, state["opt"], state["params"], opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss.detach(), **stats)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
