"""Matrix products of FP8 code matrices: the paper's LNS matmul (K3), its
sequential seed form (K4) and the fused-dequant matmul (K2).  Port of
``repro.kernels.lns_matmul``.

All take uint8 codes ``x [M, K]`` and ``w [K, N]`` and return the float32
``[M, N]`` sum of the products; the caller (``ops.matmul_q``) applies the
scales.

* ``impl="lns"`` -- K3, :func:`lns_product_matmul`: each product is the
  paper's integer add ``X + Y + K + c_in`` of the two codes (with the
  Table 2/3 carry-in), decoded wide to float32.  One format for both
  operands.  The kernel evaluates that integer expression once per
  (class of x, code of y) into the exact bf16 table of
  ``common.lns_plane_tables`` and multiplies one-hot planes of x's power
  of two by it on the tensor cores, in a block tile :func:`lns_tile`
  picks per shape.  Plain version: :func:`lns_matmul_plain`.
* ``impl="fused_dequant"`` -- K2, :func:`dequant_matmul`: both sides
  decoded by bit placement, each in its own format (E5M2 activations x
  E4M3 weights), to bf16 (exact for FP8 values) and multiplied on the
  tensor cores with float32 accumulation, in a block tile
  :func:`dequant_tile` picks per shape.  Plain version:
  :func:`dequant_matmul_plain`.
* ``impl="lns_loop"`` -- K4, :func:`lns_loop_matmul`: the same products
  as K3 summed in the order of the reference's seed design, a sequential
  rank-1 k loop; the baseline K3 is measured against.  Its sums run in the
  reference's order (k in order within tiles of ``bk = min(128, K)``, each
  tile's sum added to the output in order), so kernel, plain version and
  reference agree bit for bit.  The kernel takes each product as one
  float multiply-add of A(x) and B[cls(x), y] (:func:`loop_tables`; exact,
  so the add is the sum's own rounding) and may split the k tiles of a
  narrow output among blocks (:func:`loop_split`), adding their sums in
  tile order.  One format for both operands.  Plain version:
  :func:`lns_loop_matmul_plain`.

Each wrapper launches its hand-written CUDA kernel
(``csrc/lns_matmul.cu``) for CUDA tensors and counts the launch in its
``launches`` attribute; for CPU tensors it runs the plain version; any
other device raises.  There is no fallback from the kernel to the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.formats import FORMATS
from .common import (code_to_f32, device_plane_table, lns_combine,
                     lns_plane_tables, lns_prepare)
from .cuda_build import check_launch

__all__ = [
    "lns_matmul",
    "lns_product_matmul",
    "lns_loop_matmul",
    "dequant_matmul",
    "lns_matmul_plain",
    "lns_loop_matmul_plain",
    "dequant_matmul_plain",
    "dequant_tile",
    "lns_tile",
    "loop_bk",
    "loop_split",
    "loop_tables",
]

# Elements of one [M-chunk, K-chunk, N] product tensor of the plain LNS
# version (each int64 temporary of that shape is 8x this many bytes).
_PLAIN_CHUNK = 1 << 22


def lns_matmul_plain(x_codes, w_codes, *, fmt: str, mode: str = "rne",
                     chunk: int = _PLAIN_CHUNK):
    """Plain version of K3: the same integer-add products as the kernel
    (``lns_prepare``/``lns_combine``), summed over K chunk by chunk and
    computed over M in chunks, so the ``[M, K, N]`` product tensor never
    exists whole and full-width shapes fit on the card."""
    M, K = x_codes.shape
    N = w_codes.shape[1]
    px = lns_prepare(x_codes, fmt, mode, side="x")      # fields [M, K]
    py = lns_prepare(w_codes, fmt, mode, side="y")      # fields [K, N]
    out = torch.zeros((M, N), dtype=torch.float32, device=x_codes.device)
    kc = max(1, min(K, 128))
    mc = max(1, min(M, chunk // max(kc * N, 1)))
    for m0 in range(0, M, mc):
        acc = out[m0:m0 + mc]
        for k0 in range(0, K, kc):
            sx = type(px)(*(None if f is None else
                            f[m0:m0 + mc, k0:k0 + kc, None] for f in px))
            sy = type(py)(*(None if f is None else
                            f[None, k0:k0 + kc] for f in py))
            acc += lns_combine(sx, sy, fmt).sum(dim=1)
    return out


def loop_bk(K: int) -> int:
    """K4's k tile: the reference's heuristic ``bk = min(128, K)``."""
    return max(1, min(128, K))


# K4's geometry, mirrored in csrc/lns_matmul.cu: a block owns a LOOP_BM x
# LOOP_BN output tile; the B rows lie in shared memory at a pitch of
# LOOP_PITCH words, and an x word keeps its row's byte offset in the bits
# under LOOP_OFF_MASK.
LOOP_BM, LOOP_BN = 128, 64
LOOP_PITCH = 257
LOOP_OFF_MASK = 0x1FFF

_LOOP_TABLES = {}


def loop_tables(fmt: str, mode: str) -> torch.Tensor:
    """int32 ``[256 + R * 256]`` table of K4's products
    ``A(x) * B[cls(x), y]`` (:func:`common.lns_plane_tables`): first the
    x word of every code, A(x)'s float32 bits (a signed power of two, 0 or
    NaN, so its low 13 mantissa bits are 0) with the byte offset of its
    class's B row in shared memory, ``cls * 4 * LOOP_PITCH``, in those
    bits; then B[r, y] as float32 bits, row by row.  Built once per
    (fmt, mode) and kept."""
    key = (fmt, mode)
    tab = _LOOP_TABLES.get(key)
    if tab is None:
        pt = lns_plane_tables(fmt, mode)
        a_bits = pt.A.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        assert not (a_bits & LOOP_OFF_MASK).any(), "A has mantissa bits"
        off = pt.cls * 4 * LOOP_PITCH
        assert int(off.max()) <= LOOP_OFF_MASK
        words = a_bits | off
        words = torch.where(words >= 2**31, words - 2**32, words)
        tab = _LOOP_TABLES[key] = torch.cat([
            words.to(torch.int32),
            pt.B.float().reshape(-1).view(torch.int32)])
    return tab


_DEVICE_LOOP = {}


def _device_loop_tables(fmt: str, mode: str, device) -> torch.Tensor:
    key = (fmt, mode, torch.device(device))
    tab = _DEVICE_LOOP.get(key)
    if tab is None:
        tab = _DEVICE_LOOP[key] = loop_tables(fmt, mode).to(device)
    return tab


def loop_split(M: int, N: int, K: int, n_sm: int) -> tuple:
    """K4's split of the k tiles for an ``[M, K] x [K, N]`` product on a
    card of ``n_sm`` SMs: ``(splits, tiles per split)``.  Where the
    output's blocks fill at least half the card, one block takes all
    tiles; else the tiles are shared among up to ``n_sm // blocks``
    blocks a tile (never an empty one), whose sums the kernel adds in
    tile order."""
    blocks = -(-M // LOOP_BM) * -(-N // LOOP_BN)
    tiles = max(1, -(-K // loop_bk(K)))
    want = 1 if 2 * blocks >= n_sm else min(tiles, max(1, n_sm // blocks))
    per = -(-tiles // want)
    return -(-tiles // per), per


def lns_loop_matmul_plain(x_codes, w_codes, *, fmt: str, mode: str = "rne",
                          chunk: int = _PLAIN_CHUNK):
    """Plain version of K4, in the reference's order: the products of
    ``lns_mul_to_f32`` (operand fields prepared once, then one
    ``lns_combine`` per k), added one ``[M-chunk, N]`` slice per k within
    tiles of ``bk = min(128, K)`` (K padded by code 0), each tile's sum
    started from 0 and added to the output in order.  Float32 adds of
    whole tensors are exact IEEE operations on every device, so this is
    bitwise the reference's and the kernel's result."""
    M, K = x_codes.shape
    N = w_codes.shape[1]
    bk = loop_bk(K)
    pad = -K % bk
    if pad:
        x_codes = torch.nn.functional.pad(x_codes, (0, pad))
        w_codes = torch.nn.functional.pad(w_codes, (0, 0, 0, pad))
    px = lns_prepare(x_codes, fmt, mode, side="x")      # fields [M, Kp]
    py = lns_prepare(w_codes, fmt, mode, side="y")      # fields [Kp, N]
    out = torch.zeros((M, N), dtype=torch.float32, device=x_codes.device)
    mc = max(1, min(M, chunk // max(N, 1)))
    for m0 in range(0, M, mc):
        for k0 in range(0, K + pad, bk):
            tile = torch.zeros_like(out[m0:m0 + mc])
            for k in range(k0, k0 + bk):
                sx = type(px)(*(None if f is None else f[m0:m0 + mc, k, None]
                                for f in px))
                sy = type(py)(*(None if f is None else f[None, k]
                                for f in py))
                tile += lns_combine(sx, sy, fmt)
            out[m0:m0 + mc] += tile
    return out


def dequant_matmul_plain(x_codes, w_codes, *, fmt: str, w_fmt: str,
                         compute_dtype=torch.float32):
    """Plain version of K2: decode each side by bit placement in its own
    format, round to ``compute_dtype`` (exact for FP8 values) and take one
    float32 product.  A product of two bf16 values is exact in float32, so
    this is the reference's ``dot(..., preferred_element_type=float32)``
    (torch's own bf16 product would round its output to bf16)."""
    x = code_to_f32(x_codes, fmt).to(compute_dtype).to(torch.float32)
    w = code_to_f32(w_codes, w_fmt).to(compute_dtype).to(torch.float32)
    return x @ w


def dequant_tile(M: int, N: int, n_sm: int) -> int:
    """K2's block tile for an [M, N] output on a card of ``n_sm`` SMs:
    128 (128 x 128) when those tiles fill every SM at least once, else 64
    (64 x 64), so narrow outputs still spread over the card."""
    return 128 if -(-M // 128) * -(-N // 128) >= n_sm else 64


LNS_TILES = (128, 64, 32)


def lns_tile(M: int, N: int, n_sm: int) -> int:
    """K3's block tile for an [M, N] output on a card of ``n_sm`` SMs: the
    largest of 128 (128 x 128), 64 (64 x 64) whose tiles fill every SM at
    least once, else 32 (32 x 32), so narrow outputs still spread over
    the card."""
    for t in LNS_TILES[:-1]:
        if -(-M // t) * -(-N // t) >= n_sm:
            return t
    return LNS_TILES[-1]


def _lib():
    from .cuda_build import load

    lib = load("lns_matmul")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lns_matmul.argtypes = [vp] * 4 + [ci] * 10 + [vp]
        lib.lns_matmul.restype = ci
        lib.lns_loop_matmul.argtypes = [vp] * 5 + [ci] * 7 + [vp]
        lib.lns_loop_matmul.restype = ci
        lib.dequant_matmul.argtypes = [vp] * 3 + [ci] * 12 + [vp]
        lib.dequant_matmul.restype = ci
        lib._typed = True
    return lib


def _operands(x_codes, w_codes, what: str):
    """Shape, type and device checks of a kernel launch; returns M, N, K."""
    for t, name in ((x_codes, "x_codes"), (w_codes, "w_codes")):
        if t.dtype != torch.uint8 or t.ndim != 2:
            raise ValueError(f"{what}: {name} must be a 2-D uint8 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    M, K = x_codes.shape
    K2, N = w_codes.shape
    if K != K2:
        raise ValueError(f"{what}: contraction mismatch {tuple(x_codes.shape)}"
                         f" @ {tuple(w_codes.shape)}")
    if w_codes.device != x_codes.device:
        raise ValueError(f"{what}: both operands must be on one device")
    return M, N, K


def _device_type(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not "
                         f"{t.device}")
    return t.device.type


def lns_product_matmul(x_codes, w_codes, *, fmt: str, mode: str = "rne",
                       tile: int | None = None):
    """K3: f32 [M, N] of the paper's LNS products, one format.  CUDA
    tensors launch the kernel (``lns_product_matmul.launches`` counts it)
    in the block tile ``tile`` (128, 64 or 32; :func:`lns_tile` picks it
    when None); CPU tensors run :func:`lns_matmul_plain`."""
    if _device_type(x_codes, "K3") == "cpu":
        return lns_matmul_plain(x_codes, w_codes, fmt=fmt, mode=mode)
    M, N, K = _operands(x_codes, w_codes, "K3")
    dev = x_codes.device
    if tile is None:
        tile = lns_tile(M, N, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    elif tile not in LNS_TILES:
        raise ValueError(f"K3: tile must be one of {LNS_TILES}, not {tile}")
    pt = lns_plane_tables(fmt, mode)
    f = FORMATS[fmt]
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    err = _lib().lns_matmul(
        x_codes.data_ptr(), w_codes.data_ptr(),
        device_plane_table(fmt, mode, dev).data_ptr(), out.data_ptr(), M, N,
        K, pt.R, f.man_bits, f.bias, f.min_normal_code, pt.bad_min,
        int(pt.sign_classes), tile,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "K3")
    lns_product_matmul.launches += 1
    return out


lns_product_matmul.launches = 0


def lns_loop_matmul(x_codes, w_codes, *, fmt: str, mode: str = "rne"):
    """K4: f32 [M, N] of the paper's LNS products, one format, summed in
    the reference's seed order.  CUDA tensors launch the kernel
    (``lns_loop_matmul.launches`` counts it; a split over k tiles adds a
    second, elementwise launch that adds the tiles' sums in order); CPU
    tensors run :func:`lns_loop_matmul_plain`."""
    if _device_type(x_codes, "K4") == "cpu":
        return lns_loop_matmul_plain(x_codes, w_codes, fmt=fmt, mode=mode)
    M, N, K = _operands(x_codes, w_codes, "K4")
    dev = x_codes.device
    tab = _device_loop_tables(fmt, mode, dev)
    R = lns_plane_tables(fmt, mode).R
    bk = loop_bk(K)
    splits, per = loop_split(M, N, K, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    later = max(1, -(-K // bk)) - per if splits > 1 else 0
    sums = torch.empty((later, M, N), dtype=torch.float32, device=dev)
    err = _lib().lns_loop_matmul(
        x_codes.data_ptr(), w_codes.data_ptr(), tab.data_ptr(),
        out.data_ptr(), sums.data_ptr(), M, N, K, bk, R, splits, per,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "K4")
    lns_loop_matmul.launches += 1
    return out


lns_loop_matmul.launches = 0


def dequant_matmul(x_codes, w_codes, *, fmt: str, w_fmt: str,
                   compute_dtype=torch.float32):
    """K2: f32 [M, N] of the decoded operands' products, each side in its
    own format.  CUDA tensors launch the kernel (``dequant_matmul.launches``
    counts it); CPU tensors run :func:`dequant_matmul_plain`.  The kernel's
    products are exact for ``compute_dtype`` bf16 and float32 alike."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K2 computes in float32 or bfloat16, not "
                         f"{compute_dtype}")
    if _device_type(x_codes, "K2") == "cpu":
        return dequant_matmul_plain(x_codes, w_codes, fmt=fmt, w_fmt=w_fmt,
                                    compute_dtype=compute_dtype)
    M, N, K = _operands(x_codes, w_codes, "K2")
    dev = x_codes.device
    fx, fw = FORMATS[fmt], FORMATS[w_fmt]
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    err = _lib().dequant_matmul(
        x_codes.data_ptr(), w_codes.data_ptr(), out.data_ptr(), M, N, K,
        fx.man_bits, fx.bias, fx.min_normal_code, fx.max_normal_code,
        fw.man_bits, fw.bias, fw.min_normal_code, fw.max_normal_code,
        dequant_tile(M, N, torch.cuda.get_device_properties(
            dev).multi_processor_count),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "K2")
    dequant_matmul.launches += 1
    return out


dequant_matmul.launches = 0


def lns_matmul(x_codes, w_codes, *, fmt: str = "e4m3", w_fmt: str | None = None,
               mode: str = "rne", impl: str = "lns",
               compute_dtype=torch.float32):
    """f32 [M, N] matmul of uint8 FP8 code matrices (scales applied by the
    caller).  ``impl``: ``"lns"`` (K3), ``"lns_loop"`` (K4) or
    ``"fused_dequant"`` (K2); ``w_fmt`` (fused_dequant only) lets the
    weights use another format."""
    w_fmt = w_fmt or fmt
    if impl in ("lns", "lns_loop"):
        if w_fmt != fmt:
            raise ValueError("the paper's LNS product is single-format; use "
                             "fused_dequant")
        wrapper = lns_product_matmul if impl == "lns" else lns_loop_matmul
        return wrapper(x_codes, w_codes, fmt=fmt, mode=mode)
    if impl == "fused_dequant":
        return dequant_matmul(x_codes, w_codes, fmt=fmt, w_fmt=w_fmt,
                              compute_dtype=compute_dtype)
    raise ValueError(f"unknown impl {impl!r}")
