"""The functional numerics API the port's model and serving code call.

Port of the part of ``repro.numerics.api`` on the serving and training
paths: every entry point takes the value operands plus a :class:`Policy`
and an optional ``site`` name, resolves ``(fmt, mode, impl, accum)``
internally and dispatches to the kernels, so call sites never thread
numeric strings.  The static-FP8-weight matmul raises until the slice
that ports it lands.
"""
from __future__ import annotations

from typing import Optional

import torch

from .policy import SINGLE_FORMAT_IMPLS, OpPolicy, Policy

__all__ = [
    "weight_format",
    "matmul",
    "elementwise",
    "kv_quantized",
    "kv_format",
    "kv_stochastic",
    "kv_write_token",
    "attention",
    "kv_fused_write_attend",
]


def _later(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (see ROADMAP.md Queue 1 of the port)")


def weight_format(pol: Optional[Policy], site: str = "") -> Optional[str]:
    """The weight-side FP8 format at ``site`` (None = unquantized)."""
    if pol is None or not pol.weight_quant:
        return None
    return pol.resolve("weights", site).fmt


def matmul(x, w, pol: Optional[Policy], *, site: str = "", bias=None):
    """[..., K] @ [K, N] under the policy; the reference's one matmul entry
    point for float weights: STE-quantized (activations and weights to FP8
    codes, product by ``kernels.ops.matmul_q``) when the policy quantizes
    weights on the fly, a plain product otherwise.  Returns [..., N] in
    ``x.dtype``."""
    if not isinstance(w, torch.Tensor):
        raise _later("static FP8 weights")
    if pol is not None and pol.ste_weights:
        from ..models.layers import _ste_qmatmul

        shape = x.shape
        mp = pol.resolve("matmul", site)
        wp = pol.resolve("weights", site)
        act_fmt = mp.fmt if mp.quantized else wp.fmt
        if mp.impl in SINGLE_FORMAT_IMPLS and act_fmt != wp.fmt:
            act_fmt = wp.fmt  # the LNS product is single-format
        y = _ste_qmatmul(x.reshape(-1, shape[-1]), w, act_fmt, wp.fmt,
                        mp.impl, mp.quantized, mp.mode, mp.accum)
        y = y.reshape(*shape[:-1], w.shape[-1]).to(x.dtype)
    else:
        y = x @ w
    return y if bias is None else y + bias


def elementwise(op: str, x, y=None, pol: Optional[Policy] = None, *,
                site: str = ""):
    """Paper elementwise op (mul/div/square/recip/sqrt/rsqrt) under the
    policy: quantize -> LNS code-domain op -> dequantize, or the plain
    float op when the policy leaves elementwise in full precision.
    Returns a float tensor in ``x.dtype``.

    Quantized, ``impl="auto"`` resolves to ``"pallas"`` as in the
    reference, which here is kernel K5 for CUDA tensors (its plain version
    for CPU tensors); ``"ref"`` runs the plain version on any device.  The
    codes carry no gradient; the result's gradient flows through the
    per-tensor scales, as in the reference.
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

    qx = quantize(x, ep.fmt)
    qy = None if y is None else quantize(y, ep.fmt)
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
                   rows, *, noise=None, write_mask=None):
    """One decode token's K or V into its page, in place (see
    ``serving.page_pool.write_token_page``); fmt/mode resolved here: FP8
    codes when the policy quantizes the KV cache, else the float row in
    the pages' dtype (``fmt=None``)."""
    from ..serving.page_pool import write_token_page

    return write_token_page(
        pages, scales, new, page_ids, rows, fmt=kv_format(pol),
        mode=_kv_mode(pol, "kv_write", noise is not None), noise=noise,
        write_mask=write_mask)


def _attention_qk(pol: Optional[Policy], site: str):
    qk = pol.resolve("attention_qk", site) if pol is not None else OpPolicy()
    mode = qk.mode if qk.mode != "stochastic" else "rne"
    impl = qk.impl if qk.impl in ("kernel", "ref") else "auto"
    return mode, impl


def attention(q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
              pol: Optional[Policy], *, n_kv_heads: int, window: int = 0,
              cap: float = 0.0, site: str = ""):
    """Paged decode attention under the policy: QK^T in the LNS integer
    domain off the page codes when the KV cache is quantized, a float
    product off float pages otherwise.  Returns [B, 1, H, dv] in
    q.dtype."""
    from ..kernels.paged_attention import paged_decode_attention

    mode, impl = _attention_qk(pol, site)
    return paged_decode_attention(
        q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
        fmt=kv_format(pol), n_kv_heads=n_kv_heads, mode=mode, window=window,
        cap=cap, impl=impl)


def kv_fused_write_attend(q, k_new, v_new, k_pages, v_pages, k_scale,
                          v_scale, block_tables, lengths,
                          pol: Optional[Policy], *,
                          n_kv_heads: int, k_noise=None, v_noise=None,
                          write_mask=None, window: int = 0, cap: float = 0.0,
                          site: str = ""):
    """Fused decode-token KV write + paged attention, policy-resolved: the
    write resolves like :func:`kv_write_token`, the QK^T like
    :func:`attention`.  Returns ``(out, k_pages, k_scale, v_pages,
    v_scale)``; the cache tensors are updated in place."""
    from ..kernels.paged_attention import fused_decode_write_attend

    mode, impl = _attention_qk(pol, site)
    return fused_decode_write_attend(
        q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, block_tables,
        lengths, fmt=kv_format(pol), n_kv_heads=n_kv_heads, mode=mode,
        kv_mode=_kv_mode(pol, "kv_write", k_noise is not None),
        k_noise=k_noise, v_noise=v_noise, write_mask=write_mask,
        window=window, cap=cap, impl=impl)
