"""Mamba2's SSD (state-space duality) mixer: the chunked full-sequence
forward of prefill and the single-token decode.  Port of
``repro.models.mamba2``.

The reference's minimal-SSD formulation, kept as it is:

* one B/C group (``n_groups = 1``);
* a short causal depthwise conv over the (x, B, C) channels, whose last
  ``w - 1`` *pre-activation* inputs are the decode cache's ``conv``;
* within a chunk, the quadratic form ``C_i . B_j exp(cum_i - cum_j) dt_j
  x_j`` over ``i >= j``; across chunks, a recurrence of the chunk end
  states, here a loop over the chunks (the reference's ``lax.scan``);
* the gated RMSNorm, then ``out_proj``.

The five input projections are separate weights (``w_z``, ``w_x``,
``w_B``, ``w_C``, ``w_dt``) at the reference's policy sites
``blocks.*.mamba.<name>`` (its ``_proj`` names every layer's sites with
the wildcard), so static FP8 weights and policy overrides reach them as
they do there.  The state math is float32 (the decays underflow in bf16);
``softplus`` is the reference's ``logaddexp(x, 0)``, with no switch to
``x`` above a threshold.

The decode cache entry of a layer is ``{"conv" [B, w - 1, d_inner + 2 N]
in the parameters' dtype, "state" [B, heads, head_dim, N] float32}``: a
summary of everything the slot has seen, not rows addressed by position.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import qlinear, rms_norm

__all__ = ["dims", "mamba2_init", "masked_decay", "ssd_forward",
           "ssd_decode"]


def dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head_dim, d_state)."""
    di = cfg.ssm_expand * cfg.d_model
    return di, di // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_init(generator: torch.Generator, cfg, put=None, path=()):
    """The reference's mixer leaves drawn from ``generator`` (on its
    device): the projections N(0, 0.02^2) and the conv weights N(0,
    0.1^2) in the parameter dtype, a zero conv bias and norm gain,
    float32 ``A_log`` 0, ``Dskip`` 1 and ``dt_bias`` 0.  ``put(path,
    tensor)`` maps each leaf as it is drawn (``Model.init``'s hook)."""
    D = cfg.d_model
    di, nh, _, N = dims(cfg)
    w = cfg.ssm_conv_width
    dt, dev = cfg.pdtype, generator.device
    put = put if put is not None else (lambda p, t: t)

    def normal(name, shape, std):
        t = torch.randn(shape, generator=generator, device=dev) * std
        return put(path + (name,), t.to(dt))

    def const(name, shape, value, dtype):
        return put(path + (name,),
                   torch.full(shape, value, dtype=dtype, device=dev))

    return {
        "w_z": normal("w_z", (D, di), 0.02),
        "w_x": normal("w_x", (D, di), 0.02),
        "w_B": normal("w_B", (D, N), 0.02),
        "w_C": normal("w_C", (D, N), 0.02),
        "w_dt": normal("w_dt", (D, nh), 0.02),
        "conv_x": normal("conv_x", (w, di), 0.1),
        "conv_B": normal("conv_B", (w, N), 0.1),
        "conv_C": normal("conv_C", (w, N), 0.1),
        "conv_b": const("conv_b", (di + 2 * N,), 0.0, dt),
        "A_log": const("A_log", (nh,), 0.0, torch.float32),
        "Dskip": const("Dskip", (nh,), 1.0, torch.float32),
        "dt_bias": const("dt_bias", (nh,), 0.0, torch.float32),
        "norm": const("norm", (di,), 0.0, dt),
        "out_proj": normal("out_proj", (di, D), 0.02),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def masked_decay(diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``exp(diff)`` where ``mask``, else 0: the within-chunk decays.

    Above the diagonal ``diff`` is positive and may pass float32's ``exp``
    range (dt |A| summed over a chunk reaches ~200 at Mamba2's init
    ranges).  The reference's ``where(mask, exp(diff), 0)`` has the same
    forward, but there its untaken branch's gradient is 0 x inf = NaN.
    ``exp(-inf)`` is exactly 0, so masking the exponent instead keeps
    every forward bit and gives a gradient that is finite wherever the
    taken branch's is."""
    return torch.exp(torch.where(
        mask, diff, torch.full((), -torch.inf, dtype=diff.dtype,
                               device=diff.device)))


def _proj(p, x, cfg, site: str = "blocks.*.mamba"):
    """x [B, S, D] -> z [B, S, di], the conv inputs x, B, C (before the
    conv) and dt's raw projection [B, S, nh]."""
    pol = cfg.policy
    return tuple(qlinear(x, p[name], pol, site=f"{site}.{name}")
                 for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _conv_seq(x, w, width: int):
    """Causal depthwise conv along the sequence, per channel: the
    reference's sum of shifted products, in its order."""
    S = x.shape[1]
    pads = F.pad(x, (0, 0, width - 1, 0))
    out = pads[:, 0:S] * w[0]
    for i in range(1, width):
        out = out + pads[:, i:i + S] * w[i]
    return out


def _gate_out(p, y, z, x_dtype, cfg):
    """The gated RMSNorm and ``out_proj`` of y [B, S, di] float32."""
    y = rms_norm(y * F.silu(z.to(torch.float32)), p["norm"], cfg.norm_eps)
    return qlinear(y.to(x_dtype), p["out_proj"], cfg.policy,
                   site="blocks.*.mamba.out_proj")


def ssd_forward(p, x, cfg, chunk: int = 128):
    """Full-sequence SSD of x [B, S, D].  Returns (y [B, S, D], the cache
    entry {conv, state} at the sequence's end).  ``S`` must be a multiple
    of ``min(chunk, S)``, as the reference asserts: nothing is padded."""
    B, S, _ = x.shape
    di, nh, P, N = dims(cfg)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(
            f"ssd_forward needs S % chunk == 0, got S={S}, chunk={chunk} "
            "(the reference asserts it; no padding)")
    nc = S // chunk
    w = cfg.ssm_conv_width
    f32 = torch.float32

    z, xc_raw, Bc_raw, Cc_raw, dtr = _proj(p, x, cfg)
    bias = p["conv_b"]
    xc = F.silu(_conv_seq(xc_raw, p["conv_x"], w) + bias[:di])
    Bc = F.silu(_conv_seq(Bc_raw, p["conv_B"], w) + bias[di:di + N])
    Cc = F.silu(_conv_seq(Cc_raw, p["conv_C"], w) + bias[di + N:])

    xs = xc.reshape(B, nc, chunk, nh, P).to(f32)
    Bm = Bc.reshape(B, nc, chunk, N).to(f32)
    Cm = Cc.reshape(B, nc, chunk, N).to(f32)
    dt = softplus(dtr.to(f32) + p["dt_bias"]).reshape(B, nc, chunk, nh)
    A = -torch.exp(p["A_log"])                   # [nh], negative
    cum = torch.cumsum(dt * A, dim=2)            # [B, nc, L, nh]

    # within a chunk (i >= j): C_i . B_j exp(cum_i - cum_j) dt_j x_j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,L,L,nh]
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    decay = masked_decay(diff, mask[None, None, :, :, None])
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    weight = cb[..., None] * decay * dt[:, :, None]         # [B,nc,L,L,nh]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", weight, xs)

    # the exponents below are <= 0 (cum decreases along the chunk, since
    # dt > 0 and A < 0), so these exponentials never overflow
    # each chunk's end state: sum_j B_j (dt_j x_j) exp(cum_end - cum_j)
    decay_end = torch.exp(cum[:, :, -1:] - cum)             # [B,nc,L,nh]
    states = torch.einsum("bcjn,bcjhp->bchpn", Bm,
                          (decay_end * dt)[..., None] * xs)

    # across chunks: the state entering each chunk, in order
    chunk_decay = torch.exp(cum[:, :, -1])                  # [B, nc, nh]
    s = torch.zeros((B, nh, P, N), dtype=f32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                   # [B,nc,h,p,n]

    # off the diagonal: y_i += C_i . (exp(cum_i) S_prev)
    y_off = (torch.einsum("bcin,bchpn->bcihp", Cm, s_prevs)
             * torch.exp(cum)[..., None])

    y = (y_diag + y_off + xs * p["Dskip"][:, None]).reshape(B, S, di)
    y = _gate_out(p, y, z, x.dtype, cfg)

    # the conv cache: the last w - 1 pre-activation conv inputs
    tail = slice(S - (w - 1), None)
    conv = torch.cat([xc_raw[:, tail], Bc_raw[:, tail], Cc_raw[:, tail]],
                     dim=-1)
    return y, {"conv": conv, "state": s}


def ssd_decode(p, x, cfg, cache) -> Tuple[torch.Tensor, dict]:
    """One token x [B, 1, D] against the cache entry {conv [B, w - 1,
    di + 2 N], state [B, nh, P, N]}.  Returns (y [B, 1, D], the new entry);
    the caller writes it (``models.transformer``)."""
    B = x.shape[0]
    di, nh, P, N = dims(cfg)
    w = cfg.ssm_conv_width
    f32 = torch.float32

    z, xc_raw, Bc_raw, Cc_raw, dtr = _proj(p, x, cfg)
    new_raw = torch.cat([xc_raw, Bc_raw, Cc_raw], dim=-1)    # [B, 1, ch]
    hist = torch.cat([cache["conv"], new_raw.to(cache["conv"].dtype)],
                     dim=1)                                  # [B, w, ch]
    # the three convs as one over the (x, B, C) channels: each channel's
    # products and sums in the reference's order, a third of the launches
    weight = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    out = hist[:, 0] * weight[0]
    for i in range(1, w):
        out = out + hist[:, i] * weight[i]
    out = F.silu(out + p["conv_b"])

    xs = out[:, :di].reshape(B, nh, P).to(f32)
    Bm = out[:, di:di + N].to(f32)
    Cm = out[:, di + N:].to(f32)
    dt = softplus(dtr.to(f32)[:, 0] + p["dt_bias"])          # [B, nh]
    dA = torch.exp(dt * -torch.exp(p["A_log"]))              # [B, nh]

    state = (cache["state"] * dA[:, :, None, None]
             + (dt[:, :, None] * xs)[..., None] * Bm[:, None, None, :])
    y = (torch.einsum("bn,bhpn->bhp", Cm, state)
         + xs * p["Dskip"][None, :, None]).reshape(B, 1, di)
    y = _gate_out(p, y, z, x.dtype, cfg)
    return y, {"conv": hist[:, 1:], "state": state}
