"""Model building blocks: RMSNorm, RoPE, softcap, the policy-resolved
linear with its straight-through FP8 matmul (and static FP8 weights), the
MoE layer's straight-through expert products, the gated MLP, the chunked
online-softmax attention of the training forward and prefill, and the
single-position attention of dense-cache decode.  Port of
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
from ..parallel.hints import hint, tp_columns, tp_max

__all__ = ["rms_norm", "rope", "softcap", "qlinear", "gated_mlp",
           "gated_hidden",
           "bmm_experts", "ste_expert_matmul", "chunked_attention",
           "decode_attention", "NEG_INF"]


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


def bmm_experts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[E, M, K] @ [E, K, N]: one batched product on the card; expert by
    expert on the CPU, whose batched BLAS may sum in an order that varies
    with its threading."""
    if a.device.type == "cuda":
        return torch.bmm(a, b)
    return torch.stack([a[e] @ b[e] for e in range(a.shape[0])])


class _STEExpertMatmul(torch.autograd.Function):
    """The expert products of an MoE layer with the straight-through
    estimator: :class:`_STEQMatmul` on every (token group, expert) pair, as
    the reference's ``custom_vjp`` under its two ``vmap``s (over groups in
    ``_dispatch_group``, over experts in ``_expert_mm``).  x [E, G, C, Din]
    (expert e's C rows of group g), w [E, Din, Dout].  Forward: each
    expert's weight quantized per output channel over its own Din rows
    (scales [E, 1, Dout]), each (group, expert) block of activations per
    tensor (scales [E, G, 1, 1]), the codes through one batched
    ``kernels.ops.matmul_q`` (K3 for impl ``lns``, K2 for
    ``fused_dequant``: one launch for all experts), float32 [E, G, C,
    Dout].  Weight-only: each expert's weight decoded, then a float
    product.  Backward: the plain float products of the unquantized
    operands in the weight dtype, ``g @ w^T`` and ``x^T @ g``, batched over
    experts; the weight gradient sums every group's rows in one product
    (the reference adds the groups' products)."""

    @staticmethod
    def forward(ctx, x, w, act_fmt, weight_fmt, impl, act_quant, mode,
                accum):
        ctx.save_for_backward(x, w)
        E, G, C, Din = x.shape
        qw = quantize(w, weight_fmt, axis=(0, 2))
        if act_quant:
            qx = quantize(x, act_fmt, axis=(0, 1), mode=mode)
            return kops.matmul_q(
                qx, qw, impl=impl, mode=mode,
                compute_dtype=(torch.float32 if accum == "f32"
                               else torch.bfloat16))
        # weight-only: dequantize w, keep activations in compute dtype
        wq = (code_to_f32(qw.codes, qw.fmt) * qw.scale).to(x.dtype)
        y = bmm_experts(x.reshape(E, G * C, Din), wq)
        return y.view(E, G, C, -1).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        E, G, C, Din = x.shape
        g = g.to(w.dtype).reshape(E, G * C, -1)
        gx = bmm_experts(g, w.transpose(1, 2)).view(E, G, C, Din)
        gw = bmm_experts(x.reshape(E, G * C, Din).transpose(1, 2), g)
        return (gx.to(x.dtype), gw.to(w.dtype),
                None, None, None, None, None, None)


def ste_expert_matmul(x, w, act_fmt, weight_fmt, impl, act_quant=True,
                      mode="rne", accum="bf16"):
    """x [E, G, C, Din] float @ w [E, Din, Dout] float -> f32 [E, G, C,
    Dout] through FP8 codes, with straight-through gradients (see
    :class:`_STEExpertMatmul`)."""
    return _STEExpertMatmul.apply(x, w, act_fmt, weight_fmt, impl,
                                  act_quant, mode, accum)


def qlinear(x, w, pol, b=None, site: str = ""):
    """[..., D_in] @ [D_in, D_out] under the numerics policy.  ``w`` may be
    a static-quantized weight (``models.quantize``): its codes feed the
    quantized matmul when the policy quantizes matmuls, else it is decoded
    right before a float product (``numerics.matmul``)."""
    return numerics.matmul(x, w, pol, site=site, bias=b)


def _dims(w):
    """Shape of a float or static-quantized weight."""
    codes = getattr(w, "codes", None)
    if codes is None and isinstance(w, dict):
        codes = w["codes"]
    return tuple((w if codes is None else codes).shape)


def _act(x, kind: str):
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def gated_mlp(x, p, pol, act_fn="silu", site: str = "ffn"):
    """SwiGLU/GeGLU: down( act(gate(x)) * up(x) ).

    When the policy quantizes elementwise ops, the gate*up product runs
    through the paper's FP8 LNS multiply (kernel K5,
    ``kernels.fp8_elementwise``) instead of a float multiply.

    Serving TP: ``w_gate``/``w_up`` columns shard over the mesh, so g, u
    and their product hold this rank's block of the hidden dimension (a
    quantized product's per-tensor scale is the maximum over every rank,
    ``reduce=tp_max``), and h is gathered before ``w_down``, which
    runs whole on every rank.  No-ops outside a mesh.
    """
    return qlinear(gated_hidden(x, p, pol, act_fn, site), p["w_down"], pol,
                   site=f"{site}.w_down")


def gated_hidden(x, p, pol, act_fn="silu", site: str = "ffn"):
    """The hidden activation of :func:`gated_mlp`, ``act(gate(x)) *
    up(x)``, gathered whole on a mesh: the input of its ``w_down``
    product."""
    F = _dims(p["w_down"])[0]  # the whole hidden width (w_down is whole)

    def columns(name):  # this rank's block of the F columns, on a mesh
        return tp_columns(lambda x_, w_: qlinear(x_, w_, pol,
                                                 site=f"{site}.{name}"),
                          x, p[name], F)

    g = _act(columns("w_gate"), act_fn)
    u = columns("w_up")
    g = hint(g, "ffn_hidden")
    u = hint(u, "ffn_hidden")
    h = numerics.elementwise("mul", g, u, pol, site=f"{site}.gate_up",
                             reduce=tp_max)
    return hint(h, "ffn_gather")


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


def decode_attention(q, k, v, *, pos, window=0, cap=0.0, ring=False):
    """Single-position attention against a dense per-slot cache, in
    float32 with a two-pass softmax.

    q: [B, 1, H, hd]; k/v: [B, S, KV, hd]; ``pos``: each slot's position
    (the index its new row was written at), a scalar or [B].  Keys at
    ``t <= pos`` are admissible (and within ``window`` of ``pos``); a ring
    cache (``ring=True``, a local layer's ``S = window`` rows written at
    ``pos mod S``) admits every row once ``pos >= S``.  Returns
    [B, 1, H, dv] in q.dtype."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    pos = torch.as_tensor(pos, dtype=torch.int64,
                          device=q.device).expand(B)[:, None]
    qg = q.reshape(B, KV, G, hd).to(torch.float32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.to(torch.float32)) * hd**-0.5
    s = softcap(s, cap)
    t = torch.arange(S, device=q.device)[None, :]
    if ring:
        ok = (t <= pos) | (pos >= S)
    else:
        ok = t <= pos
        if window:
            ok &= (pos - t) < window
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    num = torch.einsum("bkgt,btkd->bkgd", p, v.to(torch.float32))
    den = p.sum(-1, keepdim=True)
    out = (num / torch.clamp_min(den, 1e-37)).reshape(B, 1, H, dv)
    return out.to(q.dtype)
