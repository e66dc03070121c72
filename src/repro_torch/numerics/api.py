"""The functional numerics API the port's model and serving code call.

Port of the part of ``repro.numerics.api`` on the serving path: every entry
point takes the value operands plus a :class:`Policy` and an optional
``site`` name, resolves ``(fmt, mode, impl)`` internally and dispatches to
the kernels, so call sites never thread numeric strings.  The quantized
matmul and elementwise branches (STE training, static FP8 weights, LNS
elementwise) raise until the slices that port kernels K2-K5 land.
"""
from __future__ import annotations

from typing import Optional

import torch

from .policy import Policy

__all__ = [
    "matmul",
    "mul",
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


def matmul(x, w, pol: Optional[Policy], *, site: str = "", bias=None):
    """[..., K] @ [K, N] under the policy; the float branch of the
    reference's one matmul entry point (plain weights, no STE).  Returns
    [..., N] in ``x.dtype``."""
    if pol is not None and pol.ste_weights:
        raise _later("the FP8 STE matmul")
    if not isinstance(w, torch.Tensor):
        raise _later("static FP8 weights")
    y = x @ w
    return y if bias is None else y + bias


def mul(x, y, pol: Optional[Policy], *, site: str = ""):
    """Elementwise product under the policy (the SwiGLU gate): the
    full-precision branch of the reference's ``elementwise("mul", ...)``."""
    if pol is not None and pol.resolve("elementwise", site).quantized:
        raise _later("the LNS elementwise kernel (K5)")
    return x * y


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


def _kv_mode(pol: Policy, op: str, has_noise: bool) -> str:
    """Resolved rounding mode of a KV write: stochastic needs its noise;
    without it the write falls back to the attention-read mode."""
    mode = pol.resolve(op).mode
    if mode == "stochastic" and not has_noise:
        mode = pol.resolve("attention_qk").mode
        if mode == "stochastic":
            mode = "rne"
    return mode


def kv_write_token(pol: Policy, pages, scales, new, page_ids, rows, *,
                   noise=None, write_mask=None):
    """One decode token's K or V into its page, in place (see
    ``serving.page_pool.write_token_page``); fmt/mode resolved here."""
    from ..serving.page_pool import write_token_page

    return write_token_page(
        pages, scales, new, page_ids, rows, fmt=kv_format(pol),
        mode=_kv_mode(pol, "kv_write", noise is not None), noise=noise,
        write_mask=write_mask)


def _attention_qk(pol: Policy, site: str):
    qk = pol.resolve("attention_qk", site)
    mode = qk.mode if qk.mode != "stochastic" else "rne"
    impl = qk.impl if qk.impl in ("kernel", "ref") else "auto"
    return mode, impl


def attention(q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
              pol: Policy, *, n_kv_heads: int, window: int = 0,
              cap: float = 0.0, site: str = ""):
    """Paged decode attention under the policy (QK^T in the LNS integer
    domain off the page codes).  Returns [B, 1, H, dv] in q.dtype."""
    from ..kernels.paged_attention import paged_decode_attention

    mode, impl = _attention_qk(pol, site)
    return paged_decode_attention(
        q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
        fmt=kv_format(pol), n_kv_heads=n_kv_heads, mode=mode, window=window,
        cap=cap, impl=impl)


def kv_fused_write_attend(q, k_new, v_new, k_pages, v_pages, k_scale,
                          v_scale, block_tables, lengths, pol: Policy, *,
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
