"""Paged decode attention with integer-domain (LNS) QK^T, in PyTorch.

Port of ``repro.kernels.paged_attention``.  The KV cache is a pool of
fixed-size pages, either raw FP8 codes plus one float32 scale per page, or
float pages (the model's dtype; their scales are never read) when the
policy leaves the KV cache unquantized (``fmt=None``)
(:mod:`repro_torch.serving.page_pool`).  Attention is flash-decoding, as
in the reference:

  1. per (slot, page): softmax partials (m, l, unnormalised o) of the
     slot's one decode query against the page, with every q·k product the
     paper's integer add plus carry-in (``lns_prepare``/``lns_combine``)
     on FP8 pages, or a float32 product on float pages;
  2. a log-sum-exp combine of the partials over pages.

Kernel K1 does both in one launch.  :func:`paged_attend` is its wrapper:
for CUDA tensors it launches the hand-written kernel
``csrc/paged_attention.cu``, its LNS instance on FP8 pages (counted in
``paged_attend.launches``) or its float instance on bf16 or float32 pages
(counted in ``paged_attend.float_launches``), which reads only the pages
:func:`admissible_pages` names and combines on the chip; for CPU tensors
it runs the plain version, :func:`page_partials_plain` then
:func:`_combine_partials`, which the CPU tests and the chip smoke hold the
kernel against.  There is no fallback: a CUDA tensor either launches the
kernel or raises.

:func:`fused_decode_write_attend` is the decode hot path's entry: it
encodes the new token's K/V row once (codes, or the float row cast to the
pages' dtype), attends with the row spliced into the gathered page (the
kernel never reads the scattered cache), and scatters the row into the
cache.  JAX's functional ``.at[].set`` updates become in-place
``index_put_`` on the page and scale tensors here; the caller's tensors
are updated and also returned.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.formats import FORMATS
from ..core.quant import encode
from .common import code_to_f32, device_lns_tables, lns_combine, lns_prepare
from .cuda_build import check_launch

__all__ = [
    "NEG_INF",
    "quantize_q",
    "query_operand",
    "admissible_pages",
    "page_partials_plain",
    "paged_attend",
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


def admissible_pages(length: int, window: int, page: int, maxp: int):
    """(first, last): the block-table pages that hold a position the masks
    admit, the only ones K1 reads (its ``page_range`` mirrors this).

    ``last = (length - 1) // page``, ``first = max(0, length - window) //
    page`` with a window, else 0.  Every page outside has every score at
    the finite ``NEG_INF``, so its combine weight is exactly 0.  With no
    admissible position in the table (``length`` 0) the whole table is
    read with every position masked: each page then has m = ``NEG_INF``
    and weight 1, and the output is the mean of all its V rows, as the
    reference's."""
    first, last = 0, -1
    if length > 0:
        last = min((length - 1) // page, maxp - 1)
        first = max(0, length - window) // page if window else 0
    if first > last:
        return 0, maxp - 1
    return first, last


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
    lengths, *, fmt: Optional[str], mode: str, KV: int, G: int,
    window: int = 0, cap: float = 0.0, inserts=None,
):
    """Plain version of K1: every (slot, page) softmax partial at once.

    FP8 pages (``fmt`` names the format): q_codes [B, KV*G, hd] uint8,
    q_scale [B]; pages [P, page, KV, hd] uint8 codes with scales [P].
    Float pages (``fmt=None``): q_codes is the float32 query [B, KV*G, hd],
    the pages are float (bf16 or float32), and q_scale and the page scales
    are not read.  block_tables [B, maxp]; lengths [B] valid tokens.
    ``inserts`` = (k_row, v_row, logical, rows, mask) splices the fused
    form's new row into the gathered pages.  Returns (m, l, o) shaped
    [B, maxp, KV, G(, dv)].  A fully masked page has m = NEG_INF (finite),
    so it drops out of the combine with weight exactly 0.
    """
    B, maxp = block_tables.shape
    bt = block_tables.to(torch.int64)
    kg, vg = k_pages[bt], v_pages[bt]          # [B, maxp, page, KV, hd]
    ksg, vsg = (None, None) if fmt is None else (k_scale[bt], v_scale[bt])
    page = kg.shape[2]
    if inserts is not None:
        k_row, v_row, logical, rows, imask = inserts
        kg = _insert_rows(kg, k_row, logical, rows, imask)
        vg = _insert_rows(vg, v_row, logical, rows, imask)
    hd = q_codes.shape[-1]

    def ex(f):  # [B, KV, G, hd] -> [B, 1, KV, G, 1, hd]
        return None if f is None else f[:, None, :, :, None, :]

    def ey(f):  # [B, maxp, page, KV, hd] -> [B, maxp, KV, 1, page, hd]
        return None if f is None else f.permute(0, 1, 3, 2, 4)[:, :, :, None]

    if fmt is None:
        # q.k as an explicit sum over hd in order, like the kernel (no
        # batched BLAS product: see the P.V loop below)
        qx = ex(q_codes.to(torch.float32).reshape(B, KV, G, hd))
        ky = ey(kg.to(torch.float32))
        s = qx[..., 0] * ky[..., 0]
        for d in range(1, hd):
            s = s + qx[..., d] * ky[..., d]
        s = s * hd**-0.5                                   # [B,maxp,KV,G,page]
        vf = vg.to(torch.float32)
    else:
        px = lns_prepare(q_codes.reshape(B, KV, G, hd), fmt, mode, side="x")
        py = lns_prepare(kg, fmt, mode, side="y")
        prod = lns_combine(type(px)(*map(ex, px)), type(py)(*map(ey, py)),
                           fmt)
        qk = q_scale[:, None] * ksg * hd**-0.5             # [B, maxp]
        s = prod.sum(-1) * qk[:, :, None, None, None]      # [B,maxp,KV,G,page]
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


def _fused_operands(inserts, row_dtype, B, KV, hd, dv, dev):
    """The fused form's five operands, checked (rows in the pages'
    dtype), or five Nones for the unfused form."""
    if inserts is None:
        return [None] * 5
    k_row, v_row, logical, rows, imask = inserts
    imask = (torch.ones((B,), dtype=torch.int32, device=dev)
             if imask is None else imask.to(torch.int32))
    ins = [k_row, v_row, logical, rows, imask]
    for t, dt, shp, nm in zip(
            ins, (row_dtype, row_dtype) + (torch.int32,) * 3,
            ((B, KV, hd), (B, KV, dv), (B,), (B,), (B,)),
            ("k_row", "v_row", "logical", "rows", "mask")):
        _check(t, dt, shp, nm)
    return ins


_SMEM_LIMIT = 232448  # dynamic shared memory one H100 block can use


def _lib():
    from .cuda_build import load

    lib = load("paged_attention")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lns_paged_partials.argtypes = (
            [vp] * 15 + [ci] * 13 + [cf, cf, vp])
        lib.lns_paged_partials.restype = ci
        lib.lns_paged_partials_smem.argtypes = [ci] * 5
        lib.lns_paged_partials_smem.restype = ci
        lib.float_paged_partials.argtypes = (
            [vp] * 11 + [ci] * 10 + [cf, cf, vp])
        lib.float_paged_partials.restype = ci
        lib.float_paged_partials_smem.argtypes = [ci] * 6
        lib.float_paged_partials_smem.restype = ci
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
    ins = _fused_operands(inserts, torch.uint8, B, KV, hd, dv, dev)
    for t in tensors + [t for t in ins if t is not None]:
        if t.device != dev:
            raise ValueError("all K1 operands must be on one CUDA device")
    lut = device_lns_tables(fmt, mode, dev)
    lib = _lib()
    if lib.lns_paged_partials_smem(page, G, hd, dv, maxp) > _SMEM_LIMIT:
        raise ValueError(f"K1 geometry page={page} G={G} hd={hd} dv={dv} "
                         "exceeds one block's shared memory")
    out = torch.empty((B, KV * G, dv), dtype=torch.float32, device=dev)
    ptr = [None if t is None else t.data_ptr()
           for t in tensors + ins + [lut, out]]
    err = lib.lns_paged_partials(
        *ptr, B, maxp, page, KV, G, hd, dv, fmt_obj.man_bits, fmt_obj.bias,
        fmt_obj.min_normal_code, fmt_obj.max_normal_code, int(window),
        int(inserts is not None), float(cap), float(hd**-0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "K1")
    paged_attend.launches += 1
    return out


_FLOAT_PAGES = {torch.bfloat16: 1, torch.float32: 0}  # dtype -> bf16 flag


def _launch_k1_float(q, k_pages, v_pages, block_tables, lengths, *, KV, G,
                     window, cap, inserts):
    dev = q.device
    B, maxp = block_tables.shape
    P, page, _, hd = k_pages.shape
    dv = v_pages.shape[-1]
    dt = k_pages.dtype
    if dt not in _FLOAT_PAGES:
        raise ValueError(f"K1's float instance takes bf16 or float32 pages, "
                         f"got {dt}")
    _check(q, torch.float32, (B, KV * G, hd), "q")
    _check(k_pages, dt, (P, page, KV, hd), "k_pages")
    _check(v_pages, dt, (P, page, KV, dv), "v_pages")
    _check(block_tables, torch.int32, (B, maxp), "block_tables")
    _check(lengths, torch.int32, (B,), "lengths")
    tensors = [q, k_pages, v_pages, block_tables, lengths]
    ins = _fused_operands(inserts, dt, B, KV, hd, dv, dev)
    for t in tensors + [t for t in ins if t is not None]:
        if t.device != dev:
            raise ValueError("all K1 operands must be on one CUDA device")
    lib = _lib()
    if lib.float_paged_partials_smem(page, G, hd, dv, maxp,
                                     _FLOAT_PAGES[dt]) > _SMEM_LIMIT:
        raise ValueError(f"K1 geometry page={page} G={G} hd={hd} dv={dv} "
                         "exceeds one block's shared memory")
    out = torch.empty((B, KV * G, dv), dtype=torch.float32, device=dev)
    ptr = [None if t is None else t.data_ptr()
           for t in tensors + ins + [out]]
    err = lib.float_paged_partials(
        *ptr, B, maxp, page, KV, G, hd, dv, int(window),
        int(inserts is not None), _FLOAT_PAGES[dt], float(cap),
        float(hd**-0.5), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "K1 (float pages)")
    paged_attend.float_launches += 1
    return out


def paged_attend(
    q_codes, q_scale, k_pages, v_pages, k_scale, v_scale, block_tables,
    lengths, *, fmt: Optional[str], mode: str, KV: int, G: int,
    window: int = 0, cap: float = 0.0, inserts=None,
):
    """K1: the attention of each query row, [B, KV*G, dv] float32, with
    the operands of :func:`page_partials_plain`.  CUDA tensors launch the
    hand-written kernel, one launch that reads only the admissible pages
    and combines on the chip: its LNS instance on FP8 pages (bumping
    ``paged_attend.launches``), its float instance on float pages
    (``fmt=None``; bumping ``paged_attend.float_launches``).  CPU tensors
    run the plain version, ``_combine_partials(page_partials_plain(...))``.
    Any other device raises."""
    kw = dict(fmt=fmt, mode=mode, KV=KV, G=G, window=window, cap=cap,
              inserts=inserts)
    args = (q_codes, q_scale, k_pages, v_pages, k_scale, v_scale,
            block_tables, lengths)
    if q_codes.device.type == "cpu":
        return _combine_partials(*page_partials_plain(*args, **kw))
    if q_codes.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not "
                         f"{q_codes.device}")
    if fmt is None:
        return _launch_k1_float(q_codes, k_pages, v_pages, block_tables,
                                lengths, KV=KV, G=G, window=window, cap=cap,
                                inserts=inserts)
    return _launch_k1(*args, **kw)


paged_attend.launches = 0
paged_attend.float_launches = 0


def _combine_partials(m, l, o):
    """Log-sum-exp combine over pages: m, l [B, maxp, KV, G], o [B, maxp,
    KV, G, dv] -> [B, KV*G, dv].  With :func:`page_partials_plain`, K1's
    plain version."""
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
    the combine.  ``q_op`` = :func:`query_operand`'s pair."""
    m, l, o = page_partials_plain(
        *q_op, k_pages, v_pages, k_scale, v_scale, block_tables, lengths,
        fmt=fmt, mode=mode, KV=KV, G=G, window=window, cap=cap)
    return _combine_partials(m, l, o)


def query_operand(q, fmt: Optional[str]):
    """K1's query operand of q [B, H, hd]: (codes [B, H, hd] uint8, scale
    [B]) for FP8 pages, (q in float32, None) for float pages."""
    if fmt is None:
        return q.to(torch.float32), None
    return quantize_q(q, fmt)


def paged_decode_attention(
    q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, *,
    fmt: Optional[str], n_kv_heads: int, mode: str = "rne",
    window: int = 0, cap: float = 0.0, impl: str = "auto",
):
    """Decode attention against the paged cache.

    q: [B, 1, H, hd] float; k/v pages [P, page, KV, hd]: uint8 codes with
    scales [P] when ``fmt`` names a format, float (bf16 or float32) with
    the scales unread when ``fmt`` is None; block_tables [B, maxp] int32;
    lengths [B] int32 valid tokens.  ``impl``: "kernel"/"auto" (the K1
    wrapper, :func:`paged_attend`) or "ref" (plain partials on any device).  Returns
    [B, 1, H, dv] in q.dtype.
    """
    B, one, H, hd = q.shape
    if one != 1:
        raise ValueError("paged decode attention is single-position")
    KV, G = n_kv_heads, H // n_kv_heads
    q_op = query_operand(q.reshape(B, H, hd), fmt)
    kw = dict(fmt=fmt, mode=mode, KV=KV, G=G, window=window, cap=cap)
    if impl == "ref":
        out = paged_attention_ref(q_op, k_pages, v_pages, k_scale, v_scale,
                                  block_tables, lengths, **kw)
    elif impl in ("kernel", "auto"):
        out = paged_attend(*q_op, k_pages, v_pages, k_scale, v_scale,
                           block_tables, lengths, **kw)
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
    0 without claiming a page scale.  With ``fmt=None`` (float pages) the
    row is the new K/V cast to the pages' dtype, no noise is read and the
    scales are left as they are.

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
    from ..serving.page_pool import scatter_token_rows, token_row_codes

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
        noise=k_noise, write_mask=write_mask, store_dtype=k_pages.dtype)
    pids_v, v_row, vs_new = token_row_codes(
        v_scale, v_new, page_ids, rows, fmt=fmt, mode=kv_mode,
        noise=v_noise, write_mask=write_mask, store_dtype=v_pages.dtype)
    if fmt is not None:
        k_scale.index_put_((pids_k,), ks_new)
        v_scale.index_put_((pids_v,), vs_new)

    def scatter():
        scatter_token_rows(k_pages, pids_k, rows, k_row, write_mask)
        scatter_token_rows(v_pages, pids_v, rows, v_row, write_mask)

    q_op = query_operand(q.reshape(B, H, hd), fmt)
    attend_len = lengths + 1
    kw = dict(fmt=fmt, mode=mode, KV=KV, G=G, window=window, cap=cap)
    if impl == "ref":
        scatter()
        out = paged_attention_ref(q_op, k_pages, v_pages, k_scale, v_scale,
                                  block_tables, attend_len, **kw)
    elif impl in ("kernel", "auto"):
        mask = None if write_mask is None else write_mask.to(torch.bool)
        out = paged_attend(*q_op, k_pages, v_pages, k_scale, v_scale,
                           block_tables, attend_len,
                           inserts=(k_row, v_row, logical, rows, mask), **kw)
        scatter()
    else:
        raise ValueError(f"unknown impl {impl!r}")
    out = out.reshape(B, 1, H, -1).to(q.dtype)
    return out, k_pages, k_scale, v_pages, v_scale
