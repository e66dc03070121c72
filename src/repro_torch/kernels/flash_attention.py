"""Tiled online-softmax attention on float inputs (kernel K6): port of
``repro.kernels.flash_attention``.

``flash_attention(q, k, v)`` takes the reference's layout, q
``[B, Sq, H, hd]`` and k/v ``[B, Sk, KV, hd|dv]``, and returns
``[B, Sq, H, dv]`` in ``q.dtype``.  GQA reads KV head ``h // (H / KV)``;
k and v are never repeated in memory.  Causal, sliding-window and softcap
masks are arithmetic on absolute positions.  No model calls it (the
models use ``layers.chunked_attention``, as in the reference): its path
is this entry point with the autotuner behind it, which picks ``(bq, bk)``
when the caller pins none (``autotune.flash_blocks``).

Each output row is an online softmax over the key tiles **in order, bk
keys at a time**, in float32: scores ``(q . k) * hd**-0.5`` (then
``tanh(s / cap) * cap``), masked entries set to the finite ``NEG_INF =
-2e30`` (never -inf), running max, sum and accumulator rescaled by
``exp(m_prev - m_new)``, and ``acc / max(l, 1e-37)`` cast to ``q.dtype``.
Sequences act as if padded with zeros to multiples of the clamped
``bq``/``bk``, as the reference pads them; the kernel reads past the end
as zeros and copies nothing.  Because ``NEG_INF`` is finite, a row with
no admissible key is not 0 or NaN: every entry of it has ``exp(s - m) =
1``, so it is the sum of V over the real keys divided by the *padded* key
length.  Each block of ``bq`` query rows visits only the key tiles
:func:`key_tile_range` gives: those holding an admissible key for one of
its real rows, or every tile when one of them has none.  Skipping the
others is exact (a masked tile after a row's first admissible key adds
``exp(NEG_INF - m) = 0`` at ``corr = 1``; one before it is wiped by
``corr = 0``), so the kernel, the plain version and the reference compute
one function.

CUDA tensors launch the hand-written kernel (``csrc/flash_attention.cu``;
``flash_attention.launches`` counts it): bfloat16 on the tensor cores,
float32 on the CUDA cores.  It reads q, k and v through their strides and
writes the output in place, so a view works without a copy as long as
its feature (last) dimension is contiguous; a view whose last dimension
is strided raises ``ValueError`` (on every device), and nothing is ever
copied silently.  CPU tensors run :func:`flash_attention_plain`; any
other device raises.  Inputs the kernel does not take raise
``ValueError`` before any launch, on every device: a dtype other than
float32 or bfloat16 (one dtype for q, k and v), ``hd`` or ``dv`` above
256, ``bq``/``bk`` outside 8-256, ``H % KV != 0``, an empty sequence, a
strided last dimension, or more than 65,535 (batch, head) pairs.  There is
no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import NEG_INF
from .cuda_build import check_launch

__all__ = ["flash_attention", "flash_attention_plain", "clamp_blocks",
           "key_tile_range"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def clamp_blocks(Sq: int, Sk: int, bq: int, bk: int) -> Tuple[int, int]:
    """The reference's clamp: shrink a block to the sequence length only
    when that length is a multiple of 8 (else keep it and pad)."""
    return (min(bq, Sq if Sq % 8 == 0 else bq),
            min(bk, Sk if Sk % 8 == 0 else bk))


def _check_tensors(q, k, v) -> None:
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.ndim != 4:
            raise ValueError(f"K6: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"K6 takes float32 or bfloat16, one dtype for q, "
                         f"k and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, _, H, hd = q.shape
    Bk, Sk, KV, hdk = k.shape
    if (Bk, Sk, KV) != tuple(v.shape[:3]) or Bk != B or hdk != hd:
        raise ValueError(f"K6: shapes differ: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"K6: H={H} is not a multiple of KV={KV}")
    if q.shape[1] == 0 or Sk == 0:
        raise ValueError("K6 needs at least one query and one key")
    if B * H > 65535:
        raise ValueError(f"K6 takes B * H up to 65535, got {B * H}")
    if max(hd, v.shape[-1]) > MAX_HEAD_DIM:
        raise ValueError(f"K6 takes hd and dv up to {MAX_HEAD_DIM}, got "
                         f"hd={hd}, dv={v.shape[-1]}")
    if not (q.device == k.device == v.device):
        raise ValueError("K6: q, k and v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K6 runs on CUDA or CPU tensors, not {q.device}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"K6 reads {name} through its strides and needs "
                             f"its last dimension contiguous, got strides "
                             f"{t.stride()}")


def _check_blocks(bq: int, bk: int) -> None:
    for b, name in ((bq, "bq"), (bk, "bk")):
        if not 8 <= b <= 256:
            raise ValueError(f"K6 takes {name} in 8-256, got {b}")


def _pad_seq(t: torch.Tensor, to: int) -> torch.Tensor:
    pad = to - t.shape[1]
    return F.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


def key_tile_range(q0: int, rows: int, Sq0: int, k_len: int, bk: int,
                   nk: int, causal: bool, window: int) -> Tuple[int, int]:
    """Key tiles ``[first, last)`` that hold an admissible key for some
    real row (below ``Sq0``) of the query rows ``[q0, q0 + rows)``; all
    ``nk`` tiles if a real row has no admissible key (such a row is
    sum(V) over the real keys divided by ``nk * bk`` and needs every tile);
    ``(0, 0)`` if no row is real.  Row ``qp`` admits the keys
    ``[lo(qp), hi(qp)]``, ``lo = max(0, qp - window + 1)`` (0 without a
    window) and ``hi = min(k_len - 1, qp)`` (``k_len - 1`` without
    causality).  Both never decrease with ``qp`` and ``hi - lo`` is
    concave, so the first and last real rows decide.  The same closed form
    as ``key_tile_range`` in ``csrc/flash_attention.cu``."""
    qa, qz = q0, min(q0 + rows, Sq0) - 1
    if qz < qa:
        return 0, 0

    def lo(qp):
        return max(0, qp - window + 1) if window else 0

    def hi(qp):
        return min(k_len - 1, qp) if causal else k_len - 1

    if lo(qa) > hi(qa) or lo(qz) > hi(qz):
        return 0, nk
    return lo(qa) // bk, hi(qz) // bk + 1


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          cap: float = 0.0, bq: int, bk: int):
    """Plain version of K6: the reference's algorithm, vectorised over
    batch, heads and every query row, with a Python loop over the key
    tiles of ``bk`` keys (k and v zero-padded to a multiple of ``bk``)
    and GQA through a ``[B, KV, G, ...]`` view.  ``bq``/``bk`` are the
    clamped blocks.  Each block of ``bq`` query rows takes only the tiles
    :func:`key_tile_range` gives it: a tile is computed for every row and
    its update kept where the row's block visits it, so the result is
    bit for bit what visiting every tile gives, wherever skipping is
    exact."""
    B, Sq, H, hd = q.shape
    _, Sk0, KV, dv = v.shape
    G = H // KV
    nk = -(-Sk0 // bk)
    Sk = nk * bk
    dev = q.device
    scale = hd ** -0.5
    ranges = [key_tile_range(i, bq, Sq, Sk0, bk, nk, causal, window)
              for i in range(0, Sq, bq)]
    qf = q.to(torch.float32).reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)
    kf = _pad_seq(k, Sk).to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    vf = _pad_seq(v, Sk).to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((B, KV, G, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, KV, G, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, dv), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    for j in range(nk):
        visit = [first <= j < last for first, last in ranges]
        if not any(visit):
            continue
        k_pos = torch.arange(j * bk, (j + 1) * bk, device=dev)[None, :]
        s = (qf @ kf[..., j * bk:(j + 1) * bk, :].transpose(-1, -2)) * scale
        if cap:
            s = torch.tanh(s / cap) * cap
        ok = k_pos < Sk0
        if causal:
            ok = ok & (q_pos >= k_pos)
        if window:
            ok = ok & (q_pos - k_pos < window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + p @ vf[..., j * bk:(j + 1) * bk, :]
        if all(visit):
            m, l, acc = m_new, l_new, acc_new
            continue
        rows = torch.tensor(visit, device=dev).repeat_interleave(bq)[:Sq, None]
        m = torch.where(rows, m_new, m)
        l = torch.where(rows, l_new, l)
        acc = torch.where(rows, acc_new, acc)
    out = acc / torch.clamp(l, min=1e-37)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(q.dtype)


def _lib():
    from .cuda_build import load

    lib = load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention.argtypes = ([vp] * 4 + [ci] * 12 + [cf] * 2
                                        + [ctypes.c_longlong] * 9 + [vp])
        lib.flash_attention.restype = ci
        lib._typed = True
    return lib


def _launch(q, k, v, *, causal, window, cap, bq, bk):
    """Allocate the output [B, Sq, H, dv] and launch K6 once on the
    caller's q, k and v, read through their strides."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, dv = v.shape
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    if out.numel():
        err = _lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd, dv, bq, bk,
            int(causal), int(window), float(hd ** -0.5), float(cap),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream)
        check_launch(err, "K6")
        flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0, bq: Optional[int] = None,
                    bk: Optional[int] = None):
    """K6: q [B, Sq, H, hd], k/v [B, Sk, KV, hd|dv] -> [B, Sq, H, dv] in
    ``q.dtype``.  ``bq``/``bk`` default to ``autotune.flash_blocks`` for
    (Sq, Sk, hd, dv) on q's device and in q's dtype; pass them to pin the tiling.  CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    _check_tensors(q, k, v)
    if bq is None or bk is None:
        from . import autotune

        abq, abk = autotune.flash_blocks(q.shape[1], k.shape[1], q.shape[-1],
                                         v.shape[-1], device=q.device,
                                         dtype=q.dtype)
        bq = abq if bq is None else bq
        bk = abk if bk is None else bk
    _check_blocks(bq, bk)
    bq, bk = clamp_blocks(q.shape[1], k.shape[1], bq, bk)
    kw = dict(causal=bool(causal), window=int(window), cap=float(cap),
              bq=bq, bk=bk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    return _launch(q, k, v, **kw)


flash_attention.launches = 0
