"""The train state, the train step and the serving steps: port of
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

__all__ = ["make_train_state", "check_trainable", "build_train_step",
           "build_prefill_step", "build_decode_step"]


def make_train_state(model: Model, generator: Optional[torch.Generator] = None,
                     *, params=None) -> Dict[str, Any]:
    """f32 master weights (of ``params``, or of ``model.init(generator)``)
    plus zero AdamW state."""
    if params is None:
        params = model.init(generator)
    master = tree_map(lambda p: p.detach().to(torch.float32).clone(), params)
    return {"params": master, "opt": adamw.init(master)}


def check_trainable(cfg) -> None:
    """Raise for a config the port serves but does not train yet: the
    hybrid family (jamba), whose training is held against JAX by no test
    and which fits one card only as a slice (~210 GB under AdamW at depth
    8), so it waits for FSDP (ROADMAP.md Queue 1 item 12)."""
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"training {cfg.name!r} (family='hybrid') is not ported yet; "
            "the port serves it (ROADMAP.md Queue 1 item 12)")


def build_train_step(model: Model, opt_cfg: adamw.OptConfig) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``; ``batch`` is
    {tokens, labels} on the state's device.  ``metrics`` holds the loss,
    its terms (ce, and the MoE aux losses, zeros without experts) and
    AdamW's statistics.  Every config the port serves trains, MLA,
    shared experts, leading dense layers and the SSD mixer (mamba2)
    included, but the hybrid family (:func:`check_trainable`); what stays
    refused besides is FSDP/TP training (``launch.train``'s ``--mesh``
    beyond 1x1) and ``remat_policy="dots"``
    (``models.transformer.stack_forward``), all ROADMAP.md Queue 1 item
    12."""
    cfg = model.cfg
    check_trainable(cfg)

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


def build_prefill_step(model: Model) -> Callable:
    """``prefill_step(params, batch) -> (logits, caches)``
    (:meth:`Model.prefill`)."""
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def build_decode_step(model: Model) -> Callable:
    """``decode_step(params, cache, tokens, pos) -> (logits, cache)``
    (:meth:`Model.decode_step`, the dense cache updated in place)."""
    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return decode_step
