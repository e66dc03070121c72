"""Paged decode attention with integer-domain (LNS) QK^T, in PyTorch.

Port of ``repro.kernels.paged_attention``.  The KV cache is a pool of
fixed-size pages of raw FP8 codes plus one float32 scale per page
(:mod:`repro_torch.serving.page_pool`).  Attention is flash-decoding in
two phases, as in the reference:

  1. per (slot, page): softmax partials (m, l, unnormalised o) of the
     slot's one decode query against the page, with every q·k product the
     paper's integer add plus carry-in (``lns_prepare``/``lns_combine``);
  2. a log-sum-exp combine of the partials over pages
     (:func:`_combine_partials`, plain torch here as in the reference).

Phase 1 is kernel K1.  :func:`paged_partials` is its wrapper: for CUDA
tensors it launches the hand-written kernel ``csrc/paged_attention.cu``
(and counts the launch in ``paged_partials.launches``); for CPU tensors it
runs :func:`page_partials_plain`, the plain version the CPU tests and the
chip smoke hold the kernel against.  There is no fallback: a CUDA tensor
either launches the kernel or raises.

:func:`fused_decode_write_attend` is the decode hot path's entry: it
encodes the new token's K/V row codes once, attends with the row spliced
into the gathered page (the kernel never reads the scattered cache), and
scatters the row into the cache.  JAX's functional ``.at[].set`` updates
become in-place ``index_put_`` on the page and scale tensors here; the
caller's tensors are updated and also returned.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.formats import FORMATS
from ..core.quant import encode
from .common import code_to_f32, lns_combine, lns_prepare, lns_tables

__all__ = [
    "NEG_INF",
    "quantize_q",
    "page_partials_plain",
    "paged_partials",
    "paged_attention_ref",
    "paged_decode_attention",
    "fused_decode_write_attend",
]

NEG_INF = -2.0e30


def quantize_q(q: torch.Tensor, fmt: str, mode: str = "rne"):
    """[B, H, hd] float -> (codes [B, H, hd] uint8, scale [B] float32):
    one absmax scale per slot, mapped onto the format's max_normal."""
    fmt_obj = FORMATS[fmt]
    qf = q.to(torch.float32)
    amax = torch.clamp_min(qf.abs().amax(dim=(1, 2)), 1e-12)
    scale = amax / fmt_obj.max_normal
    return encode(qf / scale[:, None, None], fmt_obj, mode), scale


def _insert_rows(gathered, row, logical, rows, mask):
    """Splice one freshly written row per slot into the gathered pages.

    gathered: [B, maxp, page, KV, hd]; row: [B, KV, hd]; logical/rows: [B]
    (logical page and in-page row of each slot's write); mask: [B] bool or
    None.  Equals scatter-then-gather on every lane whose target page the
    slot owns exclusively (the write contract)."""
    B, maxp, page = gathered.shape[:3]
    dev = gathered.device
    sel = torch.arange(maxp, device=dev)[None, :, None] == logical[:, None, None]
    sel = sel & (torch.arange(page, device=dev)[None, None, :]
                 == rows[:, None, None])
    if mask is not None:
        sel = sel & mask.to(torch.bool)[:, None, None]
    return torch.where(sel[..., None, None], row[:, None, None], gathered)


def page_partials_plain(
    q_codes, q_scale, k_pages, v_pages, k_scale, v_scale, block_tables,
    lengths, *, fmt: str, mode: str, KV: int, G: int, window: int = 0,
    cap: float = 0.0, inserts=None,
):
    """Plain version of K1: every (slot, page) softmax partial at once.

    q_codes: [B, KV*G, hd] uint8, q_scale: [B]; pages [P, page, KV, hd]
    uint8 codes with scales [P]; block_tables [B, maxp]; lengths [B] valid
    tokens.  ``inserts`` = (k_row, v_row, logical, rows, mask) splices the
    fused form's new row into the gathered pages.  Returns (m, l, o)
    shaped [B, maxp, KV, G(, dv)].  A fully masked page has m = NEG_INF
    (finite), so it drops out of the combine with weight exactly 0.
    """
    B, maxp = block_tables.shape
    bt = block_tables.to(torch.int64)
    kg, vg = k_pages[bt], v_pages[bt]          # [B, maxp, page, KV, hd]
    ksg, vsg = k_scale[bt], v_scale[bt]        # [B, maxp]
    page = kg.shape[2]
    if inserts is not None:
        k_row, v_row, logical, rows, imask = inserts
        kg = _insert_rows(kg, k_row, logical, rows, imask)
        vg = _insert_rows(vg, v_row, logical, rows, imask)
    hd = q_codes.shape[-1]
    px = lns_prepare(q_codes.reshape(B, KV, G, hd), fmt, mode, side="x")
    py = lns_prepare(kg, fmt, mode, side="y")

    def ex(f):  # [B, KV, G, hd] -> [B, 1, KV, G, 1, hd]
        return None if f is None else f[:, None, :, :, None, :]

    def ey(f):  # [B, maxp, page, KV, hd] -> [B, maxp, KV, 1, page, hd]
        return None if f is None else f.permute(0, 1, 3, 2, 4)[:, :, :, None]

    prod = lns_combine(type(px)(*map(ex, px)), type(py)(*map(ey, py)), fmt)
    qk = q_scale[:, None] * ksg * hd**-0.5                 # [B, maxp]
    s = prod.sum(-1) * qk[:, :, None, None, None]          # [B,maxp,KV,G,page]
    vf = code_to_f32(vg, fmt) * vsg[:, :, None, None, None]
    if cap:
        s = torch.tanh(s / cap) * cap
    dev = s.device
    t = (torch.arange(maxp, device=dev) * page)[None, :, None, None, None]
    t = t + torch.arange(page, device=dev)
    ln = lengths.to(torch.int64)[:, None, None, None, None]
    ok = t < ln
    if window:
        ok = ok & ((ln - 1 - t) < window)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1)                                         # [B, maxp, KV, G]
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    # P.V as an explicit sum over page rows in row order, like the kernel:
    # a batched BLAS product here sums in an order that can change from
    # run to run with the library's threading, which would break the
    # bitwise fused == unfused contract on the CPU.
    vt = vf.permute(0, 1, 3, 2, 4)                         # [B,maxp,KV,page,dv]
    o = p[..., 0, None] * vt[:, :, :, None, 0]
    for r in range(1, page):
        o = o + p[..., r, None] * vt[:, :, :, None, r]     # [B,maxp,KV,G,dv]
    return m, l, o


def _check(t: torch.Tensor, dtype: torch.dtype, shape, name: str):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_LUTS = {}
_SMEM_LIMIT = 48 * 1024  # default dynamic shared memory of one block


def _lib():
    from .cuda_build import load

    lib = load("paged_attention")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lns_paged_partials.argtypes = (
            [vp] * 17 + [ci] * 13 + [cf, cf, vp])
        lib.lns_paged_partials.restype = ci
        lib.lns_paged_partials_smem.argtypes = [ci] * 4
        lib.lns_paged_partials_smem.restype = ci
        lib._typed = True
    return lib


def _launch_k1(q_codes, q_scale, k_pages, v_pages, k_scale, v_scale,
               block_tables, lengths, *, fmt, mode, KV, G, window, cap,
               inserts):
    fmt_obj = FORMATS[fmt]
    dev = q_codes.device
    B, maxp = block_tables.shape
    P, page, _, hd = k_pages.shape
    dv = v_pages.shape[-1]
    _check(q_codes, torch.uint8, (B, KV * G, hd), "q_codes")
    _check(q_scale, torch.float32, (B,), "q_scale")
    _check(k_pages, torch.uint8, (P, page, KV, hd), "k_pages")
    _check(v_pages, torch.uint8, (P, page, KV, dv), "v_pages")
    _check(k_scale, torch.float32, (P,), "k_scale")
    _check(v_scale, torch.float32, (P,), "v_scale")
    _check(block_tables, torch.int32, (B, maxp), "block_tables")
    _check(lengths, torch.int32, (B,), "lengths")
    tensors = [q_codes, q_scale, k_pages, v_pages, k_scale, v_scale,
               block_tables, lengths]
    if inserts is not None:
        k_row, v_row, logical, rows, imask = inserts
        imask = (torch.ones((B,), dtype=torch.int32, device=dev)
                 if imask is None else imask.to(torch.int32))
        ins = [k_row, v_row, logical, rows, imask]
        for t, dt, shp, nm in zip(
                ins, (torch.uint8, torch.uint8) + (torch.int32,) * 3,
                ((B, KV, hd), (B, KV, dv), (B,), (B,), (B,)),
                ("k_row", "v_row", "logical", "rows", "mask")):
            _check(t, dt, shp, nm)
    else:
        ins = [None] * 5
    for t in tensors + [t for t in ins if t is not None]:
        if t.device != dev:
            raise ValueError("all K1 operands must be on one CUDA device")
    key = (fmt, mode, dev)
    lut = _LUTS.get(key)
    if lut is None:
        lut = _LUTS[key] = lns_tables(fmt, mode, device=dev)
    lib = _lib()
    if lib.lns_paged_partials_smem(page, G, hd, dv) > _SMEM_LIMIT:
        raise ValueError(f"K1 geometry page={page} G={G} hd={hd} dv={dv} "
                         "exceeds one block's shared memory")
    m = torch.empty((B, maxp, KV, G), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    o = torch.empty((B, maxp, KV, G, dv), dtype=torch.float32, device=dev)
    ptr = [None if t is None else t.data_ptr()
           for t in tensors + ins + [lut, m, l, o]]
    err = lib.lns_paged_partials(
        *ptr, B, maxp, page, KV, G, hd, dv, fmt_obj.man_bits, fmt_obj.bias,
        fmt_obj.min_normal_code, fmt_obj.max_normal_code, int(window),
        int(inserts is not None), float(cap), float(hd**-0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    paged_partials.launches += 1
    return m, l, o


def paged_partials(
    q_codes, q_scale, k_pages, v_pages, k_scale, v_scale, block_tables,
    lengths, *, fmt: str, mode: str, KV: int, G: int, window: int = 0,
    cap: float = 0.0, inserts=None,
):
    """K1: the (slot, page) softmax partials, same contract as
    :func:`page_partials_plain`.  CUDA tensors launch the hand-written
    kernel (and bump ``paged_partials.launches``); CPU tensors run the
    plain version.  Any other device raises."""
    kw = dict(fmt=fmt, mode=mode, KV=KV, G=G, window=window, cap=cap,
              inserts=inserts)
    args = (q_codes, q_scale, k_pages, v_pages, k_scale, v_scale,
            block_tables, lengths)
    if q_codes.device.type == "cpu":
        return page_partials_plain(*args, **kw)
    if q_codes.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not "
                         f"{q_codes.device}")
    return _launch_k1(*args, **kw)


paged_partials.launches = 0


def _combine_partials(m, l, o):
    """Log-sum-exp combine over pages: m, l [B, maxp, KV, G], o [B, maxp,
    KV, G, dv] -> [B, KV*G, dv]."""
    M = m.amax(dim=1)
    w = torch.exp(m - M[:, None])
    l_tot = (w * l).sum(dim=1)
    o_tot = (w[..., None] * o).sum(dim=1)
    out = o_tot / torch.clamp_min(l_tot, 1e-37)[..., None]
    B, KV, G, dv = out.shape
    return out.reshape(B, KV * G, dv)


def paged_attention_ref(q_op, k_pages, v_pages, k_scale, v_scale,
                        block_tables, lengths, *, fmt, mode, KV, G,
                        window=0, cap=0.0):
    """The plain oracle: plain partials over the pages as they are, then
    the combine.  ``q_op`` = (codes [B, H, hd], scale [B])."""
    m, l, o = page_partials_plain(
        *q_op, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
        fmt=fmt, mode=mode, KV=KV, G=G, window=window, cap=cap)
    return _combine_partials(m, l, o)


def _require_fmt(fmt):
    if fmt is None:
        raise NotImplementedError(
            "float (unquantized) KV pages are not ported yet; this slice "
            "serves FP8 pages (policy serve_fp8_paged)")


def paged_decode_attention(
    q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, *,
    fmt: Optional[str], n_kv_heads: int, mode: str = "rne",
    window: int = 0, cap: float = 0.0, impl: str = "auto",
):
    """Decode attention against the paged cache.

    q: [B, 1, H, hd] float; k/v pages [P, page, KV, hd] uint8 codes with
    scales [P]; block_tables [B, maxp] int32; lengths [B] int32 valid
    tokens.  ``impl``: "kernel"/"auto" (the K1 wrapper) or "ref" (plain
    partials on any device).  Returns [B, 1, H, dv] in q.dtype.
    """
    _require_fmt(fmt)
    B, one, H, hd = q.shape
    if one != 1:
        raise ValueError("paged decode attention is single-position")
    KV, G = n_kv_heads, H // n_kv_heads
    q_op = quantize_q(q.reshape(B, H, hd), fmt)
    kw = dict(fmt=fmt, mode=mode, KV=KV, G=G, window=window, cap=cap)
    if impl == "ref":
        out = paged_attention_ref(q_op, k_pages, v_pages, k_scale, v_scale,
                                  block_tables, lengths, **kw)
    elif impl in ("kernel", "auto"):
        out = _combine_partials(*paged_partials(
            *q_op, k_pages, v_pages, k_scale, v_scale, block_tables,
            lengths, **kw))
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return out.reshape(B, 1, H, -1).to(q.dtype)


def fused_decode_write_attend(
    q, k_new, v_new, k_pages, v_pages, k_scale, v_scale, block_tables,
    lengths, *, fmt: Optional[str], n_kv_heads: int, mode: str = "rne",
    kv_mode: str = "stochastic", k_noise=None, v_noise=None,
    write_mask=None, window: int = 0, cap: float = 0.0, impl: str = "auto",
):
    """Write one decode token's K/V into its page AND attend, in place.

    q: [B, 1, H, hd]; k_new/v_new: [B, KV, hd] float; ``lengths`` are
    pre-write context lengths (the write lands at ``lengths``, attention
    covers ``lengths + 1`` tokens).  ``k_noise``/``v_noise``: [B, KV, hd]
    uniform integers for ``kv_mode="stochastic"`` (drawn by the caller with
    the threefry twin, position-addressed like the reference's per-slot
    keys).  ``write_mask`` [B] bool redirects masked lanes to the null page
    0 without claiming a page scale.

    Order of effects, equal to the reference's functional version: row
    codes and page scales are computed from the old scales; the new scales
    are written; the attention reads the OLD pages with the new row
    spliced in (``impl="kernel"``/``"auto"``) under the new scales; then
    the row codes are scattered into the pages.  ``impl="ref"`` is the
    oracle: scatter first, then plain attention over the scattered pages.

    Returns ``(out [B, 1, H, dv], k_pages, k_scale, v_pages, v_scale)``
    (the updated input tensors).  Bit-identity contract, as in the
    reference: equal to write-then-attend on every lane whose
    ``write_mask`` is set.
    """
    from ..serving.page_pool import token_row_codes

    _require_fmt(fmt)
    B, one, H, hd = q.shape
    if one != 1:
        raise ValueError("fused decode write+attend is single-position")
    page_size = k_pages.shape[1]
    KV, G = n_kv_heads, H // n_kv_heads
    lengths = lengths.to(torch.int32)
    logical = torch.div(lengths, page_size, rounding_mode="floor")
    rows = lengths - logical * page_size
    page_ids = block_tables.gather(1, logical[:, None].to(torch.int64))[:, 0]
    pids_k, k_row, ks_new = token_row_codes(
        k_scale, k_new, page_ids, rows, fmt=fmt, mode=kv_mode,
        noise=k_noise, write_mask=write_mask)
    pids_v, v_row, vs_new = token_row_codes(
        v_scale, v_new, page_ids, rows, fmt=fmt, mode=kv_mode,
        noise=v_noise, write_mask=write_mask)
    k_scale.index_put_((pids_k,), ks_new)
    v_scale.index_put_((pids_v,), vs_new)

    def scatter():
        k_pages.index_put_((pids_k, rows.to(torch.int64)), k_row)
        v_pages.index_put_((pids_v, rows.to(torch.int64)), v_row)

    q_op = quantize_q(q.reshape(B, H, hd), fmt)
    attend_len = lengths + 1
    kw = dict(fmt=fmt, mode=mode, KV=KV, G=G, window=window, cap=cap)
    if impl == "ref":
        scatter()
        out = paged_attention_ref(q_op, k_pages, v_pages, k_scale, v_scale,
                                  block_tables, attend_len, **kw)
    elif impl in ("kernel", "auto"):
        mask = None if write_mask is None else write_mask.to(torch.bool)
        out = _combine_partials(*paged_partials(
            *q_op, k_pages, v_pages, k_scale, v_scale, block_tables,
            attend_len, inserts=(k_row, v_row, logical, rows, mask), **kw))
        scatter()
    else:
        raise ValueError(f"unknown impl {impl!r}")
    out = out.reshape(B, 1, H, -1).to(q.dtype)
    return out, k_pages, k_scale, v_pages, v_scale
