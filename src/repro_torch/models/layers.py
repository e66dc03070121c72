"""Model building blocks: RMSNorm, RoPE, softcap, the policy-resolved
linear and the gated MLP.  Port of the decode-path part of
``repro.models.layers``: plain functions over parameter dicts of tensors,
with the reference's dtype behaviour (norm and rope math in float32, the
result cast back to the input dtype)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import numerics

__all__ = ["rms_norm", "rope", "softcap", "qlinear", "gated_mlp"]


def rms_norm(x, scale, eps=1e-6):
    """RMSNorm with the reference's ``(1 + scale)`` gain."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] int.  Rotates the two
    halves of hd (not interleaved pairs), as the reference does."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


def qlinear(x, w, pol, b=None, site: str = ""):
    """[..., D_in] @ [D_in, D_out] under the numerics policy."""
    return numerics.matmul(x, w, pol, site=site, bias=b)


def _act(x, kind: str):
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def gated_mlp(x, p, pol, act_fn="silu", site: str = "ffn"):
    """SwiGLU/GeGLU: down( act(gate(x)) * up(x) )."""
    g = _act(qlinear(x, p["w_gate"], pol, site=f"{site}.w_gate"), act_fn)
    u = qlinear(x, p["w_up"], pol, site=f"{site}.w_up")
    h = numerics.mul(g, u, pol, site=f"{site}.gate_up")
    return qlinear(h, p["w_down"], pol, site=f"{site}.w_down")
