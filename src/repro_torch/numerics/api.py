"""The functional numerics API the port's model and serving code call.

Port of the part of ``repro.numerics.api`` on the serving and training
paths: every entry point takes the value operands plus a :class:`Policy`
and an optional ``site`` name, resolves ``(fmt, mode, impl, accum)``
internally and dispatches to the kernels, so call sites never thread
numeric strings.  A static FP8 weight (a ``QTensor``, or the legacy
``{"codes", "scale"}`` dict) is decoded into the compute dtype before a
float product, or its stored codes feed ``kernels.ops.matmul_q`` directly
when the policy quantizes matmuls.
"""
from __future__ import annotations

from typing import Optional

import torch

from .policy import SINGLE_FORMAT_IMPLS, OpPolicy, Policy

__all__ = [
    "weight_format",
    "is_quantized_weight",
    "dequantize_weight",
    "static_matmul_2d",
    "ste_arguments",
    "matmul",
    "elementwise",
    "kv_quantized",
    "kv_format",
    "kv_stochastic",
    "kv_write_token",
    "kv_encode",
    "kv_decode",
    "kv_write_prefill",
    "attention",
    "kv_fused_write_attend",
]


_ACCUM_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def weight_format(pol: Optional[Policy], site: str = "") -> Optional[str]:
    """The weight-side FP8 format at ``site`` (None = unquantized)."""
    if pol is None or not pol.weight_quant:
        return None
    return pol.resolve("weights", site).fmt


def is_quantized_weight(w) -> bool:
    from ..core.quant import QTensor

    return isinstance(w, QTensor) or (isinstance(w, dict) and "codes" in w)


def dequantize_weight(w, pol: Optional[Policy] = None,
                      dtype=torch.bfloat16):
    """Static-quantized weight -> ``dtype`` (a no-op for plain tensors);
    the decode is ``models.quantize.resolve_weight``, with the policy's
    weight format for the legacy dict carrier."""
    if not is_quantized_weight(w):
        return w
    from ..models.quantize import resolve_weight

    return resolve_weight(w, weight_format(pol), dtype)


def static_matmul_2d(x2d, qw, pol: Policy, site: str = ""):
    """[M, K] float @ a static QTensor weight -> float32 [M, N], codes end
    to end: x is quantized per tensor in the matmul's format (the
    weight's, when the matmul is unquantized or the impl is the
    single-format LNS product) and multiplied against the stored codes by
    ``kernels.ops.matmul_q``.  The one static matmul body: ``matmul``
    calls it."""
    from ..core.quant import quantize
    from ..kernels import ops as kops

    mp = pol.resolve("matmul", site)
    act_fmt = mp.fmt if mp.quantized else qw.fmt
    if mp.impl in SINGLE_FORMAT_IMPLS and act_fmt != qw.fmt:
        act_fmt = qw.fmt  # the LNS product is single-format
    qx = quantize(x2d, act_fmt, mode=mp.mode)
    return kops.matmul_q(qx, qw, impl=mp.impl, mode=mp.mode,
                         compute_dtype=_ACCUM_DTYPES[mp.accum])


def ste_arguments(pol: Policy, site: str = "") -> tuple:
    """The straight-through matmul's (act_fmt, weight_fmt, impl,
    act_quant, mode, accum) at ``site`` under a policy that quantizes
    weights on the fly, resolved as the reference's ``matmul`` does: the
    activations take the matmul's format when it is quantized, else the
    weights'; the single-format LNS products take the weights'."""
    mp = pol.resolve("matmul", site)
    wp = pol.resolve("weights", site)
    act_fmt = mp.fmt if mp.quantized else wp.fmt
    if mp.impl in SINGLE_FORMAT_IMPLS and act_fmt != wp.fmt:
        act_fmt = wp.fmt  # the LNS product is single-format
    return act_fmt, wp.fmt, mp.impl, mp.quantized, mp.mode, mp.accum


def matmul(x, w, pol: Optional[Policy], *, site: str = "", bias=None):
    """[..., K] @ [K, N] under the policy; the reference's one matmul entry
    point.  ``w`` is a float tensor (STE-quantized, activations and weights
    to FP8 codes with the product by ``kernels.ops.matmul_q``, when the
    policy quantizes weights on the fly; a plain product otherwise) or a
    static-quantized weight: its codes feed :func:`static_matmul_2d` when
    the policy quantizes matmuls, else it is decoded to ``x.dtype`` and
    multiplied.  Returns [..., N] in ``x.dtype``."""
    shape = x.shape
    mp = pol.resolve("matmul", site) if pol is not None else OpPolicy()
    if is_quantized_weight(w):
        from ..models.quantize import as_qtensor

        qw = as_qtensor(w, weight_format(pol))  # the dict: the policy's format
        if pol is not None and mp.quantized:
            y = static_matmul_2d(x.reshape(-1, shape[-1]), qw, pol, site)
            y = y.reshape(*shape[:-1], qw.codes.shape[-1]).to(x.dtype)
        else:
            y = x @ dequantize_weight(qw, pol, x.dtype)
    elif pol is not None and pol.ste_weights:
        from ..models.layers import _ste_qmatmul

        y = _ste_qmatmul(x.reshape(-1, shape[-1]), w,
                         *ste_arguments(pol, site))
        y = y.reshape(*shape[:-1], w.shape[-1]).to(x.dtype)
    else:
        y = x @ w
    return y if bias is None else y + bias


def elementwise(op: str, x, y=None, pol: Optional[Policy] = None, *,
                site: str = "", reduce=None):
    """Paper elementwise op (mul/div/square/recip/sqrt/rsqrt) under the
    policy: quantize -> LNS code-domain op -> dequantize, or the plain
    float op when the policy leaves elementwise in full precision.
    Returns a float tensor in ``x.dtype``.

    Quantized, ``impl="auto"`` resolves to ``"pallas"`` as in the
    reference, which here is kernel K5 for CUDA tensors (its plain version
    for CPU tensors); ``"ref"`` runs the plain version on any device.  The
    codes carry no gradient; the result's gradient flows through the
    per-tensor scales, as in the reference.  ``reduce`` maps each
    per-tensor absmax before its scale is taken (``core.quant.quantize``):
    on a tensor-parallel mesh, the maximum over the ranks' blocks.
    """
    ep = pol.resolve("elementwise", site) if pol is not None else None
    if ep is None or not ep.quantized:
        f = {
            "mul": lambda: x * y,
            "div": lambda: x / y,
            "square": lambda: x * x,
            "recip": lambda: 1.0 / x,
            "sqrt": lambda: torch.sqrt(x),
            "rsqrt": lambda: torch.rsqrt(x),
        }[op]
        return f()
    from ..core.quant import quantize
    from ..kernels import ops as kops

    qx = quantize(x, ep.fmt, reduce=reduce)
    qy = None if y is None else quantize(y, ep.fmt, reduce=reduce)
    impl = "pallas" if ep.impl == "auto" else ep.impl
    out = kops.elementwise_q(op, qx, qy, mode=ep.mode, impl=impl)
    return out.dequantize().to(x.dtype)


# --------------------------------------------------------------------------- #
# KV cache
# --------------------------------------------------------------------------- #
def kv_quantized(pol: Optional[Policy]) -> bool:
    return pol is not None and pol.kv_quantized


def kv_format(pol: Optional[Policy]) -> Optional[str]:
    """The KV-cache FP8 format (None = cache stays in compute dtype)."""
    return pol.kv_fmt if pol is not None else None


def kv_stochastic(pol: Optional[Policy]) -> bool:
    """Whether KV writes use stochastic rounding."""
    return (pol is not None and pol.kv_quantized
            and pol.kv_write.mode == "stochastic")


def _kv_mode(pol: Optional[Policy], op: str, has_noise: bool) -> str:
    """Resolved rounding mode of a KV write: stochastic needs its noise;
    without it the write falls back to the attention-read mode.  No
    policy: round to nearest (the pages are float then, and no mode is
    read)."""
    if pol is None:
        return "rne"
    mode = pol.resolve(op).mode
    if mode == "stochastic" and not has_noise:
        mode = pol.resolve("attention_qk").mode
        if mode == "stochastic":
            mode = "rne"
    return mode


def kv_write_token(pol: Optional[Policy], pages, scales, new, page_ids,
                   rows, *, noise=None, write_mask=None, amax=None):
    """One decode token's K or V into its page, in place (see
    ``serving.page_pool.write_token_page``, also for ``amax``); fmt/mode
    resolved here: FP8 codes when the policy quantizes the KV cache, else
    the float row in the pages' dtype (``fmt=None``)."""
    from ..serving.page_pool import write_token_page

    return write_token_page(
        pages, scales, new, page_ids, rows, fmt=kv_format(pol),
        mode=_kv_mode(pol, "kv_write", noise is not None), noise=noise,
        write_mask=write_mask, amax=amax)


def kv_encode(x, pol: Optional[Policy], *, noise=None):
    """float K/V -> the dense cache's representation: FP8 codes at scale 1
    when the policy quantizes the KV cache, ``x`` itself otherwise.
    Without ``noise`` a stochastic kv_write mode encodes RNE, as the
    reference's dense store always has (unlike the paged writes, whose
    fallback is the attention-read mode)."""
    if pol is None or not pol.kv_quantized:
        return x
    from ..core.quant import encode

    mode = pol.resolve("kv_write").mode
    if mode == "stochastic" and noise is None:
        mode = "rne"
    return encode(x.to(torch.float32), pol.kv_write.fmt, mode, noise=noise)


def kv_decode(x, pol: Optional[Policy]):
    """The dense cache's representation -> float (bit-placement decode)."""
    if not kv_quantized(pol):
        return x
    from ..kernels.common import code_to_f32

    return code_to_f32(x, kv_format(pol))


def kv_write_prefill(pol: Optional[Policy], pages, scales, src, page_ids, *,
                     key=None, amax=None, heads=None):
    """Splice one prefill row of the dense cache into fresh pages, in place
    (see ``serving.page_pool.write_prefill_pages``, also for ``amax`` and
    ``heads``); fmt/mode resolved here, the rescale's mode from the
    policy's ``kv_rescale``."""
    from ..serving.page_pool import write_prefill_pages

    return write_prefill_pages(
        pages, scales, src, page_ids, fmt=kv_format(pol),
        mode=_kv_mode(pol, "kv_rescale", key is not None), key=key,
        amax=amax, heads=heads)


def _attention_qk(pol: Optional[Policy], site: str):
    qk = pol.resolve("attention_qk", site) if pol is not None else OpPolicy()
    mode = qk.mode if qk.mode != "stochastic" else "rne"
    impl = qk.impl if qk.impl in ("kernel", "ref") else "auto"
    return mode, impl


def attention(q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
              pol: Optional[Policy], *, n_kv_heads: int, window: int = 0,
              cap: float = 0.0, site: str = "", q_amax=None):
    """Paged decode attention under the policy: QK^T in the LNS integer
    domain off the page codes when the KV cache is quantized, a float
    product off float pages otherwise (``q_amax``: see
    ``kernels.paged_attention.quantize_q``).  Returns [B, 1, H, dv] in
    q.dtype."""
    from ..kernels.paged_attention import paged_decode_attention

    mode, impl = _attention_qk(pol, site)
    return paged_decode_attention(
        q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
        fmt=kv_format(pol), n_kv_heads=n_kv_heads, mode=mode, window=window,
        cap=cap, impl=impl, q_amax=q_amax)


def kv_fused_write_attend(q, k_new, v_new, k_pages, v_pages, k_scale,
                          v_scale, block_tables, lengths,
                          pol: Optional[Policy], *,
                          n_kv_heads: int, k_noise=None, v_noise=None,
                          write_mask=None, window: int = 0, cap: float = 0.0,
                          site: str = "", amax=None):
    """Fused decode-token KV write + paged attention, policy-resolved: the
    write resolves like :func:`kv_write_token`, the QK^T like
    :func:`attention` (``amax``: see
    ``kernels.paged_attention.fused_decode_write_attend``).  Returns
    ``(out, k_pages, k_scale, v_pages, v_scale)``; the cache tensors are
    updated in place."""
    from ..kernels.paged_attention import fused_decode_write_attend

    mode, impl = _attention_qk(pol, site)
    return fused_decode_write_attend(
        q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, block_tables,
        lengths, fmt=kv_format(pol), n_kv_heads=n_kv_heads, mode=mode,
        kv_mode=_kv_mode(pol, "kv_write", k_noise is not None),
        k_noise=k_noise, v_noise=v_noise, write_mask=write_mask,
        window=window, cap=cap, impl=impl, amax=amax)
