"""Mixture-of-experts FFN with sorted capacity dispatch: port of
``repro.models.moe`` for serving and training.

Token-choice top-k routing: a float32 router, softmax, the top k
probabilities renormalised over the k.  Dispatch sorts the routed
(token, expert) pairs by expert (stable), ranks each pair within its
expert and keeps the pairs under a static capacity ``C``; the kept
tokens fill ``[E, C, D]`` buffers, three batched expert products run over
them, and each token's k gated outputs are summed back in float32.  The
aux losses (Switch load balance and router z-loss) are returned beside
the output; serving drops them, training adds them to the loss.  Under
a training policy the expert products are the reference's
straight-through FP8 products per (token group, expert)
(``layers.ste_expert_matmul``: K3 or K2 launched once per product over
all experts).

Every step is deterministic on the card, so the port's bitwise contracts
(fused == unfused, prefix on == off, TP=2 == TP=1) hold through the layer:

* the top k are taken by a stable descending sort, so equal
  probabilities pick the lower expert id, as ``jax.lax.top_k`` does;
* the router product runs in float32 with TF32 off: routing is discrete,
  and a last-bit change of a logit can move a token to another expert;
* the kept pairs are unique (expert, rank) cells, written by assignment
  (the dropped pairs go to rows of their own past the buffers), never by
  an atomic scatter-add;
* each token's k contributions are added in float32 one after another in
  ascending expert id, the order of the reference's sorted scatter-add;
  a dropped pair adds its expert's row ``C - 1`` times a zero gate, as in
  the reference's formula;
* under ``grouped`` dispatch (the default) every batch row routes alone,
  so a row's product shapes are fixed by the row count and ``C``, never by
  what the other rows route;
* in the backward, each token's k pair gradients are added in the same
  ascending expert order (:class:`_GatherPairs`), never by the atomic
  scatter-add of a gather's gradient, so a training step's gradients
  repeat bit for bit too.

The reference's ``shard_map`` route has no counterpart: a tensor-parallel
engine replicates the 3-D expert leaves and ``router`` (its serve rules
do too) and computes every expert whole on each rank, with no collective
in the layer, so TP=N equals TP=1 bit for bit at every sequence length.
Shared experts (deepseek-v2-lite: ``n_shared_experts`` x ``moe_d_ff``
wide) are one gated MLP over every token, ``p["shared"]``, added to the
routed output in the layer's dtype under both dispatch modes, as in the
reference.  In training their down product runs outside the layer's
checkpoint (``shared_hidden``), so the backward's recompute skips it, as
the reference's remat does.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import numerics
from .layers import (_act, bmm_experts, gated_hidden, qlinear,
                     ste_expert_matmul)
from .quantize import resolve_weight

__all__ = ["moe_init", "capacity", "route", "dispatch", "moe_ffn",
           "add_shared_down"]


def moe_init(generator: torch.Generator, cfg, put=None, path=()):
    """The reference's MoE leaves drawn from ``generator`` (on its
    device): ``router`` float32 [D, E], ``w_gate``/``w_up`` [E, D, F] and
    ``w_down`` [E, F, D] in the parameter dtype, all N(0, 0.02^2), and
    with shared experts ``shared`` {``w_gate``/``w_up`` [D, Fs],
    ``w_down`` [Fs, D]}, Fs = n_shared_experts x F.  ``put(path,
    tensor)`` maps each leaf as it is drawn (``Model.init``'s hook)."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dev = generator.device
    put = put if put is not None else (lambda p, t: t)

    def normal(name, shape, dtype):
        w = torch.randn(shape, generator=generator, device=dev) * 0.02
        names = name if isinstance(name, tuple) else (name,)
        return put(path + names, w.to(dtype))

    p = {"router": normal("router", (D, E), torch.float32),
         "w_gate": normal("w_gate", (E, D, F), cfg.pdtype),
         "w_up": normal("w_up", (E, D, F), cfg.pdtype),
         "w_down": normal("w_down", (E, F, D), cfg.pdtype)}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * F
        p["shared"] = {
            "w_gate": normal(("shared", "w_gate"), (D, Fs), cfg.pdtype),
            "w_up": normal(("shared", "w_up"), (D, Fs), cfg.pdtype),
            "w_down": normal(("shared", "w_down"), (Fs, D), cfg.pdtype)}
    return p


def capacity(T: int, k: int, E: int, factor: float) -> int:
    c = int(T * k / E * factor)
    return max(8, -(-c // 8) * 8)  # multiple of 8, at least 8


def _router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ router [D, E] in float32, TF32 off on the card (a
    train step's bf16 compute copy of the router is widened first, as the
    reference's dtype promotion does)."""
    x, router = x.to(torch.float32), router.to(torch.float32)
    if x.device.type != "cuda":
        return x @ router
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        return x @ router
    finally:
        matmul.allow_tf32 = saved


def route(router: torch.Tensor, xg: torch.Tensor, k: int):
    """Token groups xg [G, Tg, D] through the router: (logits, probs)
    float32 [G, Tg, E], and each token's k gates (renormalised over the
    k) and expert ids [G, Tg, k], in descending probability, equal
    probabilities in ascending id."""
    logits = _router_logits(xg, router)
    probs = torch.softmax(logits, dim=-1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[..., :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return logits, probs, gates, ids[..., :k]


def dispatch(ids: torch.Tensor, E: int, C: int) -> Dict[str, torch.Tensor]:
    """The reference's sorted capacity dispatch of each group's routed
    pairs, ids [G, Tg, k]: ``order`` (the stable argsort of the flat ids),
    ``tok`` and ``eid`` (each sorted pair's token and expert), ``rank``
    (its place within its expert), ``keep`` (rank < C) and ``rank_c``
    (rank, or C - 1 for a dropped pair), all [G, Tg * k]."""
    G, Tg, k = ids.shape
    flat = ids.reshape(G, Tg * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    eid = torch.gather(flat, 1, order)
    experts = torch.arange(E, device=ids.device).expand(G, E).contiguous()
    starts = torch.searchsorted(eid, experts)
    rank = (torch.arange(Tg * k, device=ids.device)
            - torch.gather(starts, 1, eid))
    keep = rank < C
    return dict(order=order, tok=torch.div(order, k, rounding_mode="floor"),
                eid=eid, rank=rank, keep=keep,
                rank_c=torch.where(keep, rank, C - 1))


def _expert_mm(buf, w, pol, site: str = "", groups: int = 1):
    """[E, G * C, Din] @ [E, Din, Dout] -> [E, G * C, Dout] in ``buf``'s
    dtype, ``buf`` holding each expert's C rows of each of ``groups`` token
    groups; a static FP8 weight is decoded first (``resolve_weight``), as
    in the reference.  Under a policy that quantizes weights on the fly
    (training) the product is the straight-through FP8 product of every
    (group, expert) pair (``layers.ste_expert_matmul``), with the formats
    the reference's ``numerics.matmul`` resolves at ``site``."""
    if numerics.is_quantized_weight(w):
        fmt = numerics.weight_format(pol, site) or "e4m3"
        w = resolve_weight(w, fmt, buf.dtype)
    if pol is not None and pol.ste_weights:
        E, M, Din = buf.shape
        y = ste_expert_matmul(buf.view(E, groups, M // groups, Din), w,
                              *numerics.ste_arguments(pol, site))
        return y.reshape(E, M, -1).to(buf.dtype)
    return bmm_experts(buf, w)


class _GatherPairs(torch.autograd.Function):
    """rows [G, Tg * k, D] = xg [G, Tg, D] at each sorted pair's token, a
    gather whose gradient adds each token's k pair gradients one after
    another in ascending expert id (``pos`` [G, Tg, k]: the sorted
    positions of token t's pairs, in that order), the combine's order: no
    atomic scatter-add, so the backward repeats bit for bit on the
    card."""

    @staticmethod
    def forward(ctx, xg, tok, pos):
        ctx.save_for_backward(pos)
        G, _, D = xg.shape
        return torch.gather(xg, 1, tok[..., None].expand(G, tok.shape[1], D))

    @staticmethod
    def backward(ctx, grad):
        (pos,) = ctx.saved_tensors
        G, Tg, k = pos.shape
        D = grad.shape[-1]
        parts = torch.gather(grad, 1, pos.reshape(G, Tg * k, 1).expand(
            G, Tg * k, D)).view(G, Tg, k, D)
        out = parts[:, :, 0]
        for j in range(1, k):
            out = out + parts[:, :, j]
        return out, None, None


def _dispatch_group(p, xg, cfg, site: str = "blocks.*.ffn"):
    """Sorted capacity dispatch of token groups xg [G, Tg, D], each group
    routed alone (the reference's ``_dispatch_group`` under its vmap).
    Returns (out [G, Tg, D] in xg's dtype, aux {moe_lb, moe_z} [G])."""
    G, Tg, D = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    logits, probs, gates, ids = route(p["router"], xg, k)
    counts = (ids.reshape(G, Tg * k, 1)
              == torch.arange(E, device=dev)).sum(1).to(torch.float32)
    aux = {"moe_lb": E * (probs.mean(1) * counts / (Tg * k)).sum(-1),
           "moe_z": (torch.logsumexp(logits, -1) ** 2).mean(-1)}

    C = capacity(Tg, k, E, cfg.capacity_factor)
    d = dispatch(ids, E, C)
    g = torch.arange(G, device=dev)[:, None]
    # each token's k pairs in ascending expert id: their sorted positions
    pos = torch.empty_like(d["order"]).scatter_(
        1, d["order"], torch.arange(Tg * k, device=dev).expand(G, Tg * k))
    pos = torch.sort(pos.view(G, Tg, k), dim=-1).values
    # the kept pairs' cells of the [E, G, C] buffers, each dropped pair a
    # row of its own past them: every destination is written once
    dest = torch.where(d["keep"], (d["eid"] * G + g) * C + d["rank"],
                       E * G * C + g * (Tg * k)
                       + torch.arange(Tg * k, device=dev))
    rows = _GatherPairs.apply(xg, d["tok"], pos)
    buf = xg.new_zeros((E * G * C + G * Tg * k, D))
    buf[dest.reshape(-1)] = rows.reshape(-1, D)
    buf = buf[:E * G * C].view(E, G * C, D)
    h = _act(_expert_mm(buf, p["w_gate"], cfg.policy, f"{site}.w_gate", G),
             cfg.act_fn)
    h = h * _expert_mm(buf, p["w_up"], cfg.policy, f"{site}.w_up", G)
    y = _expert_mm(h, p["w_down"], cfg.policy, f"{site}.w_down", G)

    pos = pos.view(G, Tg * k)
    cell = (torch.gather(d["eid"], 1, pos) * G + g) * C \
        + torch.gather(d["rank_c"], 1, pos)
    gate = torch.gather(gates.reshape(G, Tg * k), 1,
                        torch.gather(d["order"], 1, pos))
    gate = gate * torch.gather(d["keep"], 1, pos)
    contrib = (y.reshape(E * G * C, D)[cell.reshape(-1)].to(torch.float32)
               .view(G, Tg, k, D) * gate.view(G, Tg, k, 1))
    out = torch.zeros((G, Tg, D), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + contrib[:, :, j]
    return out.to(xg.dtype), aux


def _moe_ffn_grouped(p, x, cfg, site: str = "blocks.*.ffn"):
    """``grouped`` dispatch: every batch row routes alone; the aux losses
    are the rows' mean."""
    out, aux = _dispatch_group(p, x, cfg, site=site)
    return out, {k_: v.mean() for k_, v in aux.items()}


def _moe_ffn_global(p, x, cfg, site: str = "blocks.*.ffn"):
    """``sorted_global`` dispatch: one argsort over all B * S tokens."""
    B, S, D = x.shape
    out, aux = _dispatch_group(p, x.reshape(1, B * S, D), cfg, site=site)
    return out.reshape(B, S, D), {k_: v[0] for k_, v in aux.items()}


def add_shared_down(p, out, hidden, cfg, site: str = "blocks.*.ffn"):
    """The routed output plus the shared experts' down product of their
    hidden activation (:func:`layers.gated_hidden`), in the layer's
    dtype: the last step of :func:`moe_ffn`."""
    return out + qlinear(hidden, p["shared"]["w_down"], cfg.policy,
                         site=f"{site}.shared.w_down")


def moe_ffn(p, x, cfg, site: str = "blocks.*.ffn",
            shared_hidden: bool = False):
    """x [B, S, D] -> (out [B, S, D], aux {moe_lb, moe_z}) under
    ``cfg.moe_dispatch``: ``grouped`` (the default) or
    ``sorted_global``; the shared experts' MLP added.  With
    ``shared_hidden`` (a layer with shared experts under a training
    checkpoint) it returns (the routed output, aux, the shared experts'
    hidden activation) and leaves their down product and its add to
    :func:`add_shared_down`, outside the checkpoint: no gradient reads
    that product's output, so its forward must not run again in the
    recompute, as the reference's remat drops it."""
    if cfg.moe_dispatch == "grouped":
        out, aux = _moe_ffn_grouped(p, x, cfg, site=site)
    else:
        out, aux = _moe_ffn_global(p, x, cfg, site=site)
    if "shared" not in p:
        return out, aux
    hidden = gated_hidden(x, p["shared"], cfg.policy, cfg.act_fn,
                          site=f"{site}.shared")
    if shared_hidden:
        return out, aux, hidden
    return add_shared_down(p, out, hidden, cfg, site), aux
