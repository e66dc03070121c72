"""Model building blocks: RMSNorm, RoPE, softcap, the policy-resolved
linear with its straight-through FP8 matmul, the gated MLP and the
chunked online-softmax attention of the training forward.  Port of
``repro.models.layers``: plain functions over parameter dicts of tensors,
with the reference's dtype behaviour (norm and rope math in float32, the
result cast back to the input dtype)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import numerics
from ..core.quant import quantize
from ..kernels import ops as kops
from ..kernels.common import code_to_f32

__all__ = ["rms_norm", "rope", "softcap", "qlinear", "gated_mlp",
           "chunked_attention", "NEG_INF"]


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


class _STEQMatmul(torch.autograd.Function):
    """FP8 matmul with a straight-through estimator (the reference's
    ``custom_vjp``).  Forward: weights quantized per output channel,
    activations per tensor, product by ``kernels.ops.matmul_q`` (K3 for
    impl ``lns``, K2 for ``fused_dequant``) in float32.  Backward: the
    plain float products of the unquantized operands, in the weight
    dtype."""

    @staticmethod
    def forward(ctx, x2d, w, act_fmt, weight_fmt, impl, act_quant, mode,
                accum):
        ctx.save_for_backward(x2d, w)
        qw = quantize(w, weight_fmt, axis=-1)
        if act_quant:
            qx = quantize(x2d, act_fmt, mode=mode)
            return kops.matmul_q(
                qx, qw, impl=impl, mode=mode,
                compute_dtype=(torch.float32 if accum == "f32"
                               else torch.bfloat16))
        # weight-only: dequantize w, keep activations in compute dtype
        wq = (code_to_f32(qw.codes, qw.fmt) * qw.scale).to(x2d.dtype)
        return (x2d @ wq).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        g = g.to(w.dtype)
        return ((g @ w.T).to(x2d.dtype), (x2d.T @ g).to(w.dtype),
                None, None, None, None, None, None)


def _ste_qmatmul(x2d, w, act_fmt, weight_fmt, impl, act_quant=True,
                 mode="rne", accum="bf16"):
    """[M, K] float @ [K, N] float -> f32 [M, N] through FP8 codes, with
    straight-through gradients (see :class:`_STEQMatmul`)."""
    return _STEQMatmul.apply(x2d, w, act_fmt, weight_fmt, impl, act_quant,
                             mode, accum)


def qlinear(x, w, pol, b=None, site: str = ""):
    """[..., D_in] @ [D_in, D_out] under the numerics policy."""
    return numerics.matmul(x, w, pol, site=site, bias=b)


def _act(x, kind: str):
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def gated_mlp(x, p, pol, act_fn="silu", site: str = "ffn"):
    """SwiGLU/GeGLU: down( act(gate(x)) * up(x) ).

    When the policy quantizes elementwise ops, the gate*up product runs
    through the paper's FP8 LNS multiply (kernel K5,
    ``kernels.fp8_elementwise``) instead of a float multiply.
    """
    g = _act(qlinear(x, p["w_gate"], pol, site=f"{site}.w_gate"), act_fn)
    u = qlinear(x, p["w_up"], pol, site=f"{site}.w_up")
    h = numerics.elementwise("mul", g, u, pol, site=f"{site}.gate_up")
    return qlinear(h, p["w_down"], pol, site=f"{site}.w_down")


# --------------------------------------------------------------------------- #
# Attention (chunked, online softmax: flash-style in plain torch)
# --------------------------------------------------------------------------- #
NEG_INF = -2.0e30


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int):
    """[Sq, Sk] additive bias from position indices."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def chunked_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                      q_chunk=512, kv_chunk=1024):
    """GQA attention in O(q_chunk * kv_chunk) memory, the reference's
    algorithm: q chunks, and an online-softmax pass over kv chunks in
    float32 with running max, sum and accumulator.

    q: [B, Sq, H, hd]; k/v: [B, Sk, KV, hd] with H % KV == 0, q and k at
    the same positions.  Sequences are padded up to a chunk multiple
    (padded k rows masked, padded q rows sliced off).  Returns
    [B, Sq, H, dv] in q.dtype.
    """
    B, Sq0, H, hd = q.shape
    _, Sk0, KV, _ = k.shape
    dv = v.shape[-1]
    G = H // KV
    q_chunk = min(q_chunk, Sq0)
    kv_chunk = min(kv_chunk, Sk0)
    pad_q = (-Sq0) % q_chunk
    pad_k = (-Sk0) % kv_chunk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    Sq, Sk = Sq0 + pad_q, Sk0 + pad_k
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    dev = q.device
    qc = q.reshape(B, nq, q_chunk, KV, G, hd)
    kc = k.reshape(B, nk, kv_chunk, KV, hd)
    vc = v.reshape(B, nk, kv_chunk, KV, dv)
    scale = hd ** -0.5
    outs = []
    for qi in range(nq):
        qb = qc[:, qi].to(torch.float32)           # [B, q_chunk, KV, G, hd]
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, dv), dtype=torch.float32,
                          device=dev)
        for kj in range(nk):
            kb = kc[:, kj].to(torch.float32)
            vb = vc[:, kj].to(torch.float32)
            k_pos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgd,btkd->bkgqt", qb, kb) * scale
            s = softcap(s, cap)
            bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
            if pad_k:
                bias = bias + torch.where(k_pos[None, :] < Sk0, 0.0,
                                          NEG_INF)
            s = s + bias
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd",
                                                       p, vb)
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-37)[..., None])
    out = torch.stack(outs, dim=1)          # [B, nq, KV, G, q_chunk, dv]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, Sq, H, dv)
    return out[:, :Sq0].to(q.dtype)
