// Matrix products of FP8 code matrices for Hopper (sm_90a): the paper's
// LNS matmul (K3), its sequential seed form (K4) and the fused-dequant
// matmul (K2).  All three take uint8 codes
// x [M, K] and w [K, N] (row-major, contiguous) and write float32
// out [M, N] = sum_k product(x[m, k], w[k, n]); the caller applies the
// scales.  K3 and K2 also take a batch of products of one shape in one
// launch, the counterpart of the reference's vmap over pallas_call (its
// MoE expert products, one per expert): blockIdx.z picks the product, whose
// x [M, K], w [K, N] and out [M, N] follow the previous one's in memory;
// each product's blocks run exactly as a launch of its own at the same
// tile, so product e of a batch is bitwise the 2-D launch on it.
//
// K3, lns_matmul_kernel, replaces the Pallas TPU kernel
// repro/kernels/lns_matmul.py::_lns_kernel (impl "lns"), the paper's LNS
// matmul: each product is the integer add of the two codes' magnitudes
// plus the Table 2/3 carry-in bit, decoded wide to float32.  On this card
// it runs as one bf16 tensor-core GEMM over exact one-hot planes.  The
// product factors exactly as P(x, y) = A(x) * B[r(x), y]
// (kernels/common.py::lns_plane_tables): A(x) is x with its mantissa bits
// cleared, decoded (sign * 2^(e - bias); 0 for a zero or subnormal code;
// NaN for a NaN/inf code, which is marked, since its bits would decode to
// a number), r(x) is x's class (its mantissa field, and its sign where the
// carry-in reads the sign: e5m2 ru/rd), and B[r, y] = P(rep_r, y) /
// A(rep_r), where the carry-in, the folded LNS constant and the mantissa
// overflow all live.  So the paper's integer expression is evaluated once
// per (class, code) into B and by bit placement into A: every B entry
// holds man_bits + 1 significant bits and is exact in bf16, A is a power
// of two, and the card's multipliers see only exact operands, whose
// products are exact in float32.  With R classes (8 for e4m3 and for
// e5m2 ru/rd, 4 for the other e5m2 modes) the matmul is
//   out = [A_0 | ... | A_{R-1}] [B_0; ...; B_{R-1}],
// A_r[m, k] = A(x_mk) where r(x_mk) = r and 0 elsewhere: each output sums
// its K products exactly, plus zeros.  Special values follow lns_combine:
// a NaN/inf x is NaN in its plane, a NaN/inf y NaN in every plane, so NaN
// times a zero operand stays NaN.  Products are bitwise the plain
// version's (kernels/lns_matmul.py::lns_matmul_plain); the float32 sums run
// in another order (the tensor cores' over each 16-deep plane step), so
// sums are within the float32 summation bound.
//
// What bounds K3: the function's bytes (codes in, float32 out) against
// its 2 M K N multiply-adds of 8-bit operands at the card's dense 8-bit
// rate, the same figure whatever implements it; at the training shapes
// (M = 1024, qwen2-0.5b's widths) the bytes, 0.023 ms a layer.  The plane
// GEMM does R times the function's multiply-adds at the bf16 rate (0.25
// ms a layer at R = 8).  What holds it below that is not measured (no
// profiler of the card's stalls here); both operands are R-fold expanded
// in shared memory and read by ldmatrix, and the table reads meet bank
// conflicts, which is why x is decoded by bit placement and not through
// a table.  Design:
// warp-level mma.sync m16n8k16 (mma_bf16.cuh) over a plane order
// k' = k R + r, 64 plane columns (64 / R codes) per k step.  Each block
// copies B, w's R plane values of every code, into a 256-entry table in
// shared memory (4 KB at R = 8).  The uint8 codes stream into registers
// two k steps ahead, zero past the ragged edge (code 0 is 0 in every
// plane).  Before the warps multiply step k, each thread turns its codes
// of step k + 1 into plane rows in the other of two bf16 plane buffers,
// one 16-byte store per code: x's one-hot row by bit placement (A(x) in
// the plane of its class, 0 in the others; in registers, no table), w's
// through the table, x row-major and w n-major, so ldmatrix reads both
// without a transpose and neither operand's planes ever exist in device
// memory.  The wrapper picks the block tile per shape (lns_tile): 128 x
// 128 (8 warps of 64 x 32) when those tiles fill the card's SMs at least
// once, else 64 x 64 (4 warps of 32 x 32), else 32 x 32 (2 warps of 16 x
// 32), so the narrow outputs (N = 128) still spread over the card.  No
// split-k: every output's sum runs in one fixed order, the same in every
// tile.  Later work: warpgroup wgmma fed by TMA with a producer warp, and
// fewer planes per k (a plane step holds at most 64 / R nonzero products
// per row).
//
// K4, lns_loop_matmul_kernel, replaces the Pallas TPU kernel
// repro/kernels/lns_matmul.py::_lns_loop_kernel (impl "lns_loop"), the
// seed kernel that K3 is measured against (BENCH_1's speedup row).  Its
// sums follow the reference's order exactly: k in order within tiles of
// bk = min(128, K) (K padded by code 0, whose product is +-0), each tile's
// sum started from +0 and added to the output in order, so K4 is bitwise
// equal to its plain version (kernels/lns_matmul.py::lns_loop_matmul_plain)
// and to the reference.  That order keeps the tensor cores out (an mma adds
// a 16-deep group of products in its own order), so the in-order sums run
// on the CUDA cores.  What bounds it: K3's bound, as it computes K3's
// function (the bytes at the training shapes, counting the 8-bit tensor
// rate that an in-order sum cannot use).  What sets its time: the
// shared-memory port, one table read per product.  Design: each product
// is one fmaf(A(x), B[cls(x), y], tile) with K3's exact factors
// (kernels/common.py::lns_plane_tables; A * B is exact in float32, so the
// multiply-add rounds only the sum, as tile + product does).  Each block
// keeps B as float32 in shared memory, R rows (4 or 8) at a pitch of 257
// words, and stages x of each k as a word that holds A(x)'s bits with the
// byte offset of its class's row in the 13 low mantissa bits, which A
// leaves 0 (kernels/lns_matmul.py::loop_tables), and w as y * 4.  The 32
// lanes of a warp take 32 rows at the same (k, n): their reads share y
// and differ only in the class, in bank (cls + y) mod 32, so they never
// conflict (lanes of one class get one word as a broadcast).  Each lane
// keeps 4 rows x 8 columns of tile sums and running sums in registers,
// reads its x words once per k for its strip and the strip's 8 y values
// as two 16-byte broadcasts, so a product costs one integer add, one
// shared load and one FFMA.  Codes stream through registers into two
// shared buffers 16 k at a time, zero past the ragged edges.  Where a
// narrow output underfills the card, the wrapper splits the k tiles among
// blocks (kernels/lns_matmul.py::loop_split): the first split adds its
// tiles' sums in order itself, the others store each tile's sum, and a
// second, elementwise launch adds them to the first's result in tile
// order; no atomics, so two calls agree bit for bit.
//
// K2, dequant_matmul_kernel, replaces repro/kernels/lns_matmul.py::
// _dequant_kernel (impl "fused_dequant").  Each side is decoded by its own
// format with the reference's bit-placement decode (lns::code_to_f32:
// subnormal, NaN and inf codes decode to 0).  Every FP8 value is exact in
// bf16 and every product of two bf16 values is exact in float32, so bf16
// tensor-core products with float32 sums give the reference's products for
// compute_dtype bf16 and float32 alike; only the order of the sums differs.
// What bounds K2: the bf16 tensor-core rate at the training shapes (M =
// 1024: 3.05e10 FLOP a layer against 77 MB).  What holds it below that
// rate is the decode: every block decodes its x and w tiles again, about
// ten integer operations per two codes, as many issue slots as its
// products take (PERF.md gives the rates).  Design: a tensor-core GEMM
// through warp-level mma.sync m16n8k16 (mma_bf16.cuh).  The uint8 code
// tiles of x [M, K] and w [K, N] stream through a three-stage cp.async
// ring, 32 k at a time, zero-filled past the ragged edge (code 0 decodes
// to 0.0; element-by-element loads where K or N is not a multiple of 16);
// the block decodes each stage arithmetically (two codes per 32-bit
// operation) into one of two padded bf16 tiles, so step k + 1's decode
// overlaps step k's products; the warps multiply with ldmatrix for x and
// ldmatrix.trans for the k-major w.  The wrapper picks the block tile per
// shape: 128 x 128 (8 warps of 64 x 32) when those tiles fill the card's
// SMs at least once, else 64 x 64 (4 warps of 32 x 32).  No split-k: every
// output's sum runs in one fixed order.  Later work: warpgroup wgmma fed
// by TMA with a producer warp, or native FP8 wgmma on codes known to hold
// no subnormal, NaN or inf patterns.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lns_common.cuh"
#include "mma_bf16.cuh"

namespace {

// K3's x decode by bit placement: the bf16 bits of A(c) and the class of
// code c (kernels/common.py::lns_plane_tables holds the same rule).
struct PlaneX {
  int man_bits, bias, min_normal_code, bad_min, sign_classes;
};

// R bf16 plane values of one code: 16 bytes at R = 8, 8 at R = 4.
template <int R>
using PlaneRow = typename std::conditional<R == 8, uint4, uint2>::type;

template <int R>
__device__ __forceinline__ PlaneRow<R> plane_row(const uint32_t (&v)[R / 2]) {
  if constexpr (R == 8) {
    return make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    return make_uint2(v[0], v[1]);
  }
}

// x's one-hot plane row of code c: A(c) as bf16 bits (sign and exponent
// placed, the mantissa cleared) in the plane of its class, 0 in the others.
template <int R>
__device__ __forceinline__ PlaneRow<R> x_plane_row(uint32_t c,
                                                   const PlaneX& px) {
  const uint32_t mag = c & 0x7F, sgn = c >> 7;
  uint32_t a = (sgn << 15) |
               (((mag >> px.man_bits) + 127u - (uint32_t)px.bias) << 7);
  if (mag < (uint32_t)px.min_normal_code) a = 0;
  if (mag >= (uint32_t)px.bad_min) a = 0x7FC0u;  // NaN: marked
  const uint32_t r = (mag & ((1u << px.man_bits) - 1u)) |
                     (px.sign_classes ? sgn << px.man_bits : 0u);
  uint32_t v[R / 2];
#pragma unroll
  for (int i = 0; i < R / 2; ++i)
    v[i] = (r >> 1) == (uint32_t)i ? a << ((r & 1) * 16) : 0u;
  return plane_row<R>(v);
}

constexpr int kPlaneK = 64;           // K3: plane columns per k step
constexpr int kPlaneLd = kPlaneK + 8;  // padded bf16 rows: an odd number
                                       // of 16-byte chunks

template <int R, int BM_, int BN_>
constexpr int plane_smem() {
  return 256 * R * 2 + 2 * 2 * (BM_ + BN_) * kPlaneLd;
}

// K3: a BM x BN output tile per block of WM x WN warps, R planes.  Each
// thread loads, and turns into plane rows, one chunk of XC codes of x and
// one of WC codes of w per k step, two steps ahead in registers.  VEC: K
// and N are multiples of 16 and both bases 16-byte aligned, so the chunks
// load as words; else byte by byte.
template <int R, int BM_, int BN_, int WM, int WN, bool VEC>
__global__ void __launch_bounds__(WM * WN * 32, 512 / (WM * WN * 32))
lns_matmul_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                  const uint16_t* __restrict__ planes,
                  float* __restrict__ out, int M, int N, int K, PlaneX px) {
  static_assert(R == 4 || R == 8, "4 or 8 planes");
  constexpr int T = WM * WN * 32;
  constexpr int KC = kPlaneK / R;           // codes per k step
  constexpr int XC = BM_ * KC / T;          // x codes per thread and step
  constexpr int WC = KC * BN_ / T;          // w codes per thread and step
  constexpr int XT = KC / XC;               // threads per x row
  constexpr int TM = BM_ / WM / 16;         // m16 tiles per warp
  constexpr int TN = BN_ / WN / 8;          // n8 tiles per warp
  static_assert(XC % 4 == 0 && WC % 4 == 0 && XC * T == BM_ * KC &&
                    WC * T == KC * BN_ && XC <= KC,
                "whole 32-bit words of codes per thread and k step");
  static_assert(TN % 2 == 0, "B fragments load in pairs of n8 tiles");
  using Row = PlaneRow<R>;
  extern __shared__ __align__(16) unsigned char smem[];
  Row* wtab = reinterpret_cast<Row*>(smem);     // [256] w's plane values
  __nv_bfloat16* xs =                           // [2][BM][kPlaneLd]
      reinterpret_cast<__nv_bfloat16*>(wtab + 256);
  __nv_bfloat16* ws = xs + 2 * BM_ * kPlaneLd;  // [2][BN][kPlaneLd]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM_, n0 = blockIdx.x * BN_;
  const int wr = (warp / WN) * (BM_ / WM), wc0 = (warp % WN) * (BN_ / WN);
  // product blockIdx.z of a batch: its own x, w and out, the same tiles
  x += (size_t)blockIdx.z * M * K;
  w += (size_t)blockIdx.z * K * N;
  out += (size_t)blockIdx.z * M * N;

  // w's table, code-major: B [R, 256] transposed
  for (int c = tid; c < 256; c += T) {
    uint32_t v[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i)
      v[i] = (uint32_t)planes[2 * i * 256 + c] |
             (uint32_t)planes[(2 * i + 1) * 256 + c] << 16;
    wtab[c] = plane_row<R>(v);
  }

  // this thread's chunks: x row xr, codes [xk, xk + XC) of each k step;
  // w row wk of each k step, columns [wn, wn + WC)
  const int xr = tid / XT, xk = (tid % XT) * XC;
  const int wk = tid % KC, wn = (tid / KC) * WC;
  const bool x_row = m0 + xr < M, w_col = n0 + wn < N;
  const uint8_t* xsrc = x + (size_t)(x_row ? m0 + xr : 0) * K + xk;
  const uint8_t* wsrc = w + (size_t)wk * N + (w_col ? n0 + wn : 0);
  // the codes of the next k step to decode, and of the one after
  uint32_t xc[XC / 4], wcodes[WC / 4], xc2[XC / 4] = {}, wcodes2[WC / 4] = {};

  // codes of k step kt into (xr_, wr_), zeros past the ragged edge
  auto load = [&](int kt, uint32_t(&xr_)[XC / 4], uint32_t(&wr_)[WC / 4]) {
    const int k0 = kt * KC;
    const uint8_t* xp = xsrc + k0;
    const uint8_t* wp = wsrc + (size_t)k0 * N;
    if (VEC) {
      const bool xo = x_row && k0 + xk < K, wo = w_col && k0 + wk < K;
#pragma unroll
      for (int i = 0; i < XC / 4; ++i)
        xr_[i] = xo ? reinterpret_cast<const uint32_t*>(xp)[i] : 0u;
#pragma unroll
      for (int i = 0; i < WC / 4; ++i)
        wr_[i] = wo ? reinterpret_cast<const uint32_t*>(wp)[i] : 0u;
    } else {
#pragma unroll
      for (int i = 0; i < XC / 4; ++i) {
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (x_row && k0 + xk + 4 * i + e < K)
            v |= (uint32_t)xp[4 * i + e] << (8 * e);
        xr_[i] = v;
      }
#pragma unroll
      for (int i = 0; i < WC / 4; ++i) {
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + wk < K && n0 + wn + 4 * i + e < N)
            v |= (uint32_t)wp[4 * i + e] << (8 * e);
        wr_[i] = v;
      }
    }
  };
  // the codes in (xc, wcodes) -> plane buffer buf: x row-major by bit
  // placement, w n-major through its table
  auto decode = [&](int buf) {
    Row* xd = reinterpret_cast<Row*>(xs + buf * BM_ * kPlaneLd +
                                     xr * kPlaneLd) + xk;
#pragma unroll
    for (int j = 0; j < XC; ++j)
      xd[j] = x_plane_row<R>((xc[j / 4] >> (8 * (j % 4))) & 0xFF, px);
    __nv_bfloat16* wd = ws + buf * BN_ * kPlaneLd + wn * kPlaneLd;
#pragma unroll
    for (int j = 0; j < WC; ++j)
      reinterpret_cast<Row*>(wd + j * kPlaneLd)[wk] =
          wtab[(wcodes[j / 4] >> (8 * (j % 4))) & 0xFF];
  };

  float acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nkt = (K + KC - 1) / KC;
  if (nkt > 0) load(0, xc, wcodes);
  __syncthreads();     // w's table is in
  if (nkt > 0) decode(0);
  if (nkt > 1) load(1, xc, wcodes);
  if (nkt > 2) load(2, xc2, wcodes2);
  __syncthreads();
  for (int kt = 0; kt < nkt; ++kt) {
    // step kt + 1's planes into the other buffer, which step kt - 1 read
    // before the last barrier; its codes arrived during step kt - 1
    if (kt + 1 < nkt) decode((kt + 1) & 1);
#pragma unroll
    for (int i = 0; i < XC / 4; ++i) xc[i] = xc2[i];
#pragma unroll
    for (int i = 0; i < WC / 4; ++i) wcodes[i] = wcodes2[i];
    if (kt + 3 < nkt) load(kt + 3, xc2, wcodes2);
    const __nv_bfloat16* xb = xs + (kt & 1) * BM_ * kPlaneLd;
    const __nv_bfloat16* wb = ws + (kt & 1) * BN_ * kPlaneLd;
#pragma unroll
    for (int kk = 0; kk < kPlaneK; kk += 16) {
      uint32_t a[TM][4], b[TN][2];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        mma::ldmatrix_x4(a[i], xb + (wr + i * 16 + mma::a_row(lane)) *
                                        kPlaneLd + kk + mma::a_col(lane));
#pragma unroll
      for (int j = 0; j < TN; j += 2) {
        uint32_t bb[4];
        mma::ldmatrix_x4(bb, wb + (wc0 + j * 8 + mma::bn_row(lane)) *
                                      kPlaneLd + kk + mma::bn_col(lane));
        b[j][0] = bb[0];
        b[j][1] = bb[1];
        b[j + 1][0] = bb[2];
        b[j + 1][1] = bb[3];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          mma::mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wr + i * 16 + (lane >> 2) + (e >> 1) * 8;
        const int n = n0 + wc0 + j * 8 + 2 * (lane & 3) + (e & 1);
        // + 0.0f: a zero sum is +0, as the plain version's
        if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j][e] + 0.0f;
      }
}

template <int R, int BM_, int BN_, int WM, int WN, bool VEC>
int launch_lns(const uint8_t* x, const uint8_t* w, const uint16_t* planes,
               float* out, int M, int N, int K, int batch, const PlaneX& px,
               cudaStream_t stream) {
  constexpr int bytes = plane_smem<R, BM_, BN_>();
  auto kernel = lns_matmul_kernel<R, BM_, BN_, WM, WN, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + BN_ - 1) / BN_, (M + BM_ - 1) / BM_, batch);
  kernel<<<grid, WM * WN * 32, bytes, stream>>>(x, w, planes, out, M, N, K,
                                                px);
  return (int)cudaGetLastError();
}

template <int R>
int launch_lns(const uint8_t* x, const uint8_t* w, const uint16_t* planes,
               float* out, int M, int N, int K, int batch, const PlaneX& px,
               int tile, cudaStream_t s) {
  // K and N multiples of 16 keep every product's base of a batch aligned
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   ((uintptr_t)x & 15) == 0 && ((uintptr_t)w & 15) == 0;
  if (tile == 128)
    return vec ? launch_lns<R, 128, 128, 2, 4, true>(x, w, planes, out, M, N,
                                                     K, batch, px, s)
               : launch_lns<R, 128, 128, 2, 4, false>(x, w, planes, out, M,
                                                      N, K, batch, px, s);
  if (tile == 64)
    return vec ? launch_lns<R, 64, 64, 2, 2, true>(x, w, planes, out, M, N,
                                                   K, batch, px, s)
               : launch_lns<R, 64, 64, 2, 2, false>(x, w, planes, out, M, N,
                                                    K, batch, px, s);
  return vec ? launch_lns<R, 32, 32, 2, 1, true>(x, w, planes, out, M, N, K,
                                                 batch, px, s)
             : launch_lns<R, 32, 32, 2, 1, false>(x, w, planes, out, M, N, K,
                                                  batch, px, s);
}

// K4's geometry (kernels/lns_matmul.py: LOOP_BM, LOOP_BN, LOOP_PITCH,
// LOOP_OFF_MASK).  A block of 8 warps owns a 128 x 64 output tile; warp
// (wm, wn) owns rows wm * 32 kLoopRows + lane + 32 r (r < kLoopRows) and
// columns wn * kLoopStrip .. + kLoopStrip - 1, so each lane keeps
// kLoopRows x kLoopStrip tile sums and as many running sums.
constexpr int kLoopBM = 128, kLoopBN = 64;
constexpr int kLoopThreads = 256;
constexpr int kLoopRows = 4;             // rows per lane
constexpr int kLoopStrip = 8;            // columns per lane
constexpr int kLoopWarpsN = kLoopBN / kLoopStrip;
static_assert(32 * kLoopRows * (8 / kLoopWarpsN) == kLoopBM, "warp grid");
constexpr int kLoopKC = 16;              // k per staged chunk
constexpr int kLoopBkMax = 128;          // K4's k tile, bk = min(128, K)
constexpr int kLoopPitch = 257;          // B row pitch (words): bank r + y
constexpr int kLoopXPitch = kLoopBM + 1; // x words of one k
constexpr int kLoopRMax = 8;
constexpr uint32_t kLoopOffMask = 0x1FFFu;

__global__ void __launch_bounds__(kLoopThreads, 2)
lns_loop_matmul_kernel(const uint8_t* __restrict__ x,
                       const uint8_t* __restrict__ w,
                       const int32_t* __restrict__ tab,
                       float* __restrict__ out, float* __restrict__ sums,
                       int M, int N, int K, int bk, int R, int per,
                       int vec) {
  __shared__ float bsh[kLoopRMax * kLoopPitch];      // B[r, y]
  __shared__ uint32_t xtab[256];                     // x word of each code
  __shared__ uint32_t xs[2][kLoopKC][kLoopXPitch];   // x words, [k][m]
  __shared__ __align__(16) int ys[2][kLoopKC][kLoopBN];  // y * 4, [k][n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kLoopWarpsN, wn = warp % kLoopWarpsN;
  const int m0 = blockIdx.y * kLoopBM, n0 = blockIdx.x * kLoopBN;
  const int tiles = (K + bk - 1) / bk;
  const int t_begin = blockIdx.z * per;
  const int k_begin = t_begin * bk;
  const int k_end = min(min(t_begin + per, tiles) * bk, K);
  const int chunks = (k_end - k_begin + kLoopKC - 1) / kLoopKC;

  for (int i = tid; i < 256; i += kLoopThreads) xtab[i] = (uint32_t)tab[i];
  for (int i = tid; i < R * 256; i += kLoopThreads)
    bsh[(i >> 8) * kLoopPitch + (i & 255)] = __int_as_float(tab[256 + i]);
  __syncthreads();   // the first chunk's staging reads xtab

  // Staging: warps 0-3 load one x row's 16 codes of a chunk (thread r:
  // row m0 + r), warps 4-7 eight w codes (row k of the chunk, columns
  // n0 + 8 g ..), zero past K, M and N; code 0 gives a +-0 product.
  const int sr = tid & 127;
  const bool stage_x = tid < 128;
  const int wk = sr >> 3, wg = sr & 7;
  uint4 xr = make_uint4(0u, 0u, 0u, 0u);
  uint2 wr = make_uint2(0u, 0u);
  auto load = [&](int kc0) {
    if (stage_x) {
      const int m = m0 + sr;
      if (vec) {
        xr = (m < M) ? *reinterpret_cast<const uint4*>(x + (size_t)m * K + kc0)
                     : make_uint4(0u, 0u, 0u, 0u);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < 16; ++j)
          if (m < M && kc0 + j < K)
            v[j >> 2] |= (uint32_t)x[(size_t)m * K + kc0 + j] << (8 * (j & 3));
        xr = make_uint4(v[0], v[1], v[2], v[3]);
      }
    } else {
      const int k = kc0 + wk, n = n0 + 8 * wg;
      if (vec) {
        wr = (k < K && n < N)
                 ? *reinterpret_cast<const uint2*>(w + (size_t)k * N + n)
                 : make_uint2(0u, 0u);
      } else {
        uint32_t v[2] = {0u, 0u};
        for (int j = 0; j < 8; ++j)
          if (k < K && n + j < N)
            v[j >> 2] |= (uint32_t)w[(size_t)k * N + n + j] << (8 * (j & 3));
        wr = make_uint2(v[0], v[1]);
      }
    }
  };
  auto store = [&](int buf) {
    if (stage_x) {
      const uint32_t v[4] = {xr.x, xr.y, xr.z, xr.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        xs[buf][j][sr] = xtab[(v[j >> 2] >> (8 * (j & 3))) & 0xFFu];
    } else {
      int o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = (int)((((j < 4 ? wr.x : wr.y) >> (8 * (j & 3))) & 0xFFu) << 2);
      int4* dst = reinterpret_cast<int4*>(&ys[buf][wk][8 * wg]);
      dst[0] = make_int4(o[0], o[1], o[2], o[3]);
      dst[1] = make_int4(o[4], o[5], o[6], o[7]);
    }
  };

  float acc[kLoopRows][kLoopStrip], tile[kLoopRows][kLoopStrip];
#pragma unroll
  for (int r = 0; r < kLoopRows; ++r)
#pragma unroll
    for (int j = 0; j < kLoopStrip; ++j) acc[r][j] = tile[r][j] = 0.0f;
  const char* bbytes = reinterpret_cast<const char*>(bsh);
  const int row0 = wm * 32 * kLoopRows + lane;
  const int col0 = wn * kLoopStrip;

  if (chunks > 0) {
    load(k_begin);
    store(0);
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int kc0 = k_begin + c * kLoopKC;
    const int buf = c & 1;
    if (c + 1 < chunks) load(kc0 + kLoopKC);   // in flight while we add
#pragma unroll 4
    for (int kk = 0; kk < kLoopKC; ++kk) {
      float a[kLoopRows];
      uint32_t o[kLoopRows];
#pragma unroll
      for (int r = 0; r < kLoopRows; ++r) {
        const uint32_t xw = xs[buf][kk][row0 + 32 * r];
        a[r] = __uint_as_float(xw & ~kLoopOffMask);
        o[r] = xw & kLoopOffMask;
      }
      const int4* yrow = reinterpret_cast<const int4*>(&ys[buf][kk][col0]);
#pragma unroll
      for (int q = 0; q < kLoopStrip / 4; ++q) {
        const int4 y4 = yrow[q];                 // the same for every lane
        const int yy[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < kLoopRows; ++r)
            // A(x) * B[cls(x), y] is exact: fmaf rounds only the sum, as
            // the reference's tile + product does.
            tile[r][4 * q + j] = fmaf(
                a[r], *reinterpret_cast<const float*>(bbytes + o[r] + yy[j]),
                tile[r][4 * q + j]);
      }
    }
    const int done = kc0 + kLoopKC - k_begin;
    if (done % bk == 0 || c + 1 == chunks) {     // a tile's sum is whole
      if (blockIdx.z == 0) {
#pragma unroll
        for (int r = 0; r < kLoopRows; ++r)
#pragma unroll
          for (int j = 0; j < kLoopStrip; ++j) acc[r][j] += tile[r][j];
      } else {
        float* dst = sums + (size_t)(kc0 / bk - per) * M * N;
#pragma unroll
        for (int r = 0; r < kLoopRows; ++r) {
          const int m = m0 + row0 + 32 * r;
#pragma unroll
          for (int j = 0; j < kLoopStrip; ++j)
            if (m < M && n0 + col0 + j < N)
              dst[(size_t)m * N + n0 + col0 + j] = tile[r][j];
        }
      }
#pragma unroll
      for (int r = 0; r < kLoopRows; ++r)
#pragma unroll
        for (int j = 0; j < kLoopStrip; ++j) tile[r][j] = 0.0f;
    }
    if (c + 1 < chunks) store(buf ^ 1);
    __syncthreads();
  }
  if (blockIdx.z == 0) {
#pragma unroll
    for (int r = 0; r < kLoopRows; ++r) {
      const int m = m0 + row0 + 32 * r;
#pragma unroll
      for (int j = 0; j < kLoopStrip; ++j)
        if (m < M && n0 + col0 + j < N)
          out[(size_t)m * N + n0 + col0 + j] = acc[r][j];
    }
  }
}

// The sums of the tiles after the first split's, added to its result in
// tile order: out[i] = ((out[i] + sums[0][i]) + sums[1][i]) + ...
__global__ void lns_loop_matmul_combine_kernel(float* __restrict__ out,
                                               const float* __restrict__ sums,
                                               long long mn, int later) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < mn; i += (long long)gridDim.x * blockDim.x) {
    float v = out[i];
    for (int t = 0; t < later; ++t) v += sums[(size_t)t * mn + i];
    out[i] = v;
  }
}

// K2's decode of one format to bf16 bits, two codes at a time: a normal
// code's bf16 is sign << 15 | (mag << (7 - man_bits)) + ((127 - bias) << 7),
// exactly the top half of lns::code_to_f32's float32; subnormal, NaN and
// inf codes give +0, as there.
struct Bf16Decode {
  uint32_t mul, off2, lo2, hi2;
};

Bf16Decode bf16_decode(const lns::Format& f) {
  const uint32_t off = (uint32_t)(127 - f.bias) << 7;
  const uint32_t lo = 0x8000u - (uint32_t)f.min_normal_code;
  const uint32_t hi = 0x7FFFu - (uint32_t)f.max_normal_code;
  return Bf16Decode{1u << (7 - f.man_bits), off | off << 16, lo | lo << 16,
                    hi | hi << 16};
}

// u holds two codes, in bits 0-7 and 16-23; returns their two bf16 values
// (the first in the low half).  Per half, bit 15 of mag + lo2 says mag >=
// min_normal_code and bit 15 of mag + hi2 says mag > max_normal_code (no
// sum carries into the other half); the byte permute spreads each half's
// bit 15 over the half.
__device__ __forceinline__ uint32_t decode2(uint32_t u, const Bf16Decode& d) {
  const uint32_t mag = u & 0x007F007Fu;
  const uint32_t bits = mag * d.mul + d.off2;
  const uint32_t ok = (mag + d.lo2) & ~(mag + d.hi2);
  uint32_t mask;   // prmt's generic mode: selector bit 3 replicates the msb
  asm("prmt.b32 %0, %1, %2, 0xBB99;" : "=r"(mask) : "r"(ok), "r"(0u));
  return (bits | ((u << 8) & 0x80008000u)) & mask;
}

// 16 codes -> 16 bf16 values (32 bytes, 16-byte aligned at both ends).
__device__ __forceinline__ void decode16(const uint8_t* src, void* dst,
                                         const Bf16Decode& d) {
  const uint4 c = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = decode2(__byte_perm(w[i], 0, 0x4140), d);
    o[2 * i + 1] = decode2(__byte_perm(w[i], 0, 0x4342), d);
  }
  uint4* out = reinterpret_cast<uint4*>(dst);
  out[0] = make_uint4(o[0], o[1], o[2], o[3]);
  out[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

constexpr int kKB = 32;   // K2: k per ring stage
constexpr int kS = 3;     // K2: stages of the code ring

template <int BM_, int BN_>
constexpr int dequant_smem() {
  return kS * (BM_ * kKB + kKB * BN_) +
         2 * 2 * (BM_ * (kKB + 8) + kKB * (BN_ + 8));
}

// K2: a BM x BN output tile per block of WM x WN warps.  Each thread
// copies and decodes one 16-code chunk of x and one of w per k step.
// VEC: K and N are multiples of 16 and both bases 16-byte aligned, so
// the chunks go by cp.async; else byte by byte.
template <int BM_, int BN_, int WM, int WN, bool VEC>
__global__ void __launch_bounds__(WM * WN * 32)
dequant_matmul_kernel(const uint8_t* __restrict__ x,
                      const uint8_t* __restrict__ w, float* __restrict__ out,
                      int M, int N, int K, Bf16Decode dx, Bf16Decode dw) {
  constexpr int T = WM * WN * 32;
  constexpr int LDX = kKB + 8;        // padded bf16 rows: an odd number
  constexpr int LDW = BN_ + 8;        // of 16-byte chunks
  constexpr int TM = BM_ / WM / 16;   // m16 tiles per warp
  constexpr int TN = BN_ / WN / 8;    // n8 tiles per warp
  static_assert(TN % 2 == 0, "B fragments load in pairs of n8 tiles");
  static_assert(BM_ * kKB / 16 == T && kKB * BN_ / 16 == T,
                "one chunk of x and one of w per thread and k step");
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* xc = smem;                           // [kS][BM][kKB] x codes
  uint8_t* wc = xc + kS * BM_ * kKB;            // [kS][kKB][BN] w codes
  __nv_bfloat16* xs =                           // [2][BM][LDX] decoded x
      reinterpret_cast<__nv_bfloat16*>(wc + kS * kKB * BN_);
  __nv_bfloat16* ws = xs + 2 * BM_ * LDX;       // [2][kKB][LDW] decoded w

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM_, n0 = blockIdx.x * BN_;
  const int wr = (warp / WN) * (BM_ / WM), wc0 = (warp % WN) * (BN_ / WN);
  // product blockIdx.z of a batch: its own x, w and out, the same tiles
  x += (size_t)blockIdx.z * M * K;
  w += (size_t)blockIdx.z * K * N;
  out += (size_t)blockIdx.z * M * N;
  // this thread's chunks: x row xr, codes [xk, xk + 16) of each k step;
  // w row wk of each k step, columns [wn, wn + 16)
  const int xr = tid / (kKB / 16), xk = (tid % (kKB / 16)) * 16;
  const int wk = tid / (BN_ / 16), wn = (tid % (BN_ / 16)) * 16;
  const bool x_row = m0 + xr < M, w_col = n0 + wn < N;
  const uint8_t* xsrc = x + (size_t)(x_row ? m0 + xr : 0) * K + xk;
  const uint8_t* wsrc = w + (size_t)wk * N + (w_col ? n0 + wn : 0);

  // codes of k step kt into ring stage st, zeros past the ragged edge
  auto load = [&](int kt, int st) {
    const int k0 = kt * kKB;
    uint8_t* xd = xc + st * BM_ * kKB + xr * kKB + xk;
    uint8_t* wd = wc + st * kKB * BN_ + wk * BN_ + wn;
    const uint8_t* xs_ = xsrc + k0;
    const uint8_t* ws_ = wsrc + (size_t)k0 * N;
    if (VEC) {
      const bool xo = x_row && k0 + xk < K, wo = w_col && k0 + wk < K;
      mma::cp_async16(xd, xo ? xs_ : x, xo ? 16 : 0);
      mma::cp_async16(wd, wo ? ws_ : w, wo ? 16 : 0);
    } else {
      for (int e = 0; e < 16; ++e) {
        xd[e] = (x_row && k0 + xk + e < K) ? xs_[e] : 0;
        wd[e] = (k0 + wk < K && n0 + wn + e < N) ? ws_[e] : 0;
      }
    }
  };
  // ring stage st -> bf16 buffer buf
  auto decode = [&](int st, int buf) {
    decode16(xc + st * BM_ * kKB + xr * kKB + xk,
             xs + buf * BM_ * LDX + xr * LDX + xk, dx);
    decode16(wc + st * kKB * BN_ + wk * BN_ + wn,
             ws + buf * kKB * LDW + wk * LDW + wn, dw);
  };

  float acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nkt = (K + kKB - 1) / kKB;
#pragma unroll
  for (int st = 0; st < kS; ++st) {
    if (st < nkt) load(st, st);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<kS - 1>();
  __syncthreads();
  if (nkt > 0) decode(0, 0);
  for (int kt = 0; kt < nkt; ++kt) {
    mma::cp_async_wait<kS - 2>();
    __syncthreads();   // codes kt + 1 are in and step kt is decoded; step
                       // kt - 1's products and step kt's decode are done
    if (kt + kS < nkt) load(kt + kS, kt % kS);
    mma::cp_async_commit();
    if (kt + 1 < nkt) decode((kt + 1) % kS, (kt + 1) & 1);
    const __nv_bfloat16* xb = xs + (kt & 1) * BM_ * LDX;
    const __nv_bfloat16* wb = ws + (kt & 1) * kKB * LDW;
#pragma unroll
    for (int kk = 0; kk < kKB; kk += 16) {
      uint32_t a[TM][4], b[TN][2];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        mma::ldmatrix_x4(a[i], xb + (wr + i * 16 + mma::a_row(lane)) * LDX +
                                   kk + mma::a_col(lane));
#pragma unroll
      for (int j = 0; j < TN; j += 2) {
        uint32_t bb[4];
        mma::ldmatrix_x4_trans(bb, wb + (kk + mma::bk_row(lane)) * LDW +
                                       wc0 + j * 8 + mma::bk_col(lane));
        b[j][0] = bb[0];
        b[j][1] = bb[1];
        b[j + 1][0] = bb[2];
        b[j + 1][1] = bb[3];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          mma::mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wr + i * 16 + (lane >> 2) + (e >> 1) * 8;
        const int n = n0 + wc0 + j * 8 + 2 * (lane & 3) + (e & 1);
        if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j][e];
      }
}

template <int BM_, int BN_, int WM, int WN, bool VEC>
int launch_dequant(const uint8_t* x, const uint8_t* w, float* out, int M,
                   int N, int K, int batch, const lns::Format& fx,
                   const lns::Format& fw, cudaStream_t stream) {
  constexpr int bytes = dequant_smem<BM_, BN_>();
  auto kernel = dequant_matmul_kernel<BM_, BN_, WM, WN, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + BN_ - 1) / BN_, (M + BM_ - 1) / BM_, batch);
  kernel<<<grid, WM * WN * 32, bytes, stream>>>(
      x, w, out, M, N, K, bf16_decode(fx), bf16_decode(fw));
  return (int)cudaGetLastError();
}

template <int BM_, int BN_, int WM, int WN>
int launch_dequant(const uint8_t* x, const uint8_t* w, float* out, int M,
                   int N, int K, int batch, const lns::Format& fx,
                   const lns::Format& fw, cudaStream_t stream) {
  // K and N multiples of 16 keep every product's base of a batch aligned
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   ((uintptr_t)x & 15) == 0 && ((uintptr_t)w & 15) == 0;
  return vec ? launch_dequant<BM_, BN_, WM, WN, true>(x, w, out, M, N, K,
                                                      batch, fx, fw, stream)
             : launch_dequant<BM_, BN_, WM, WN, false>(x, w, out, M, N, K,
                                                       batch, fx, fw, stream);
}

}  // namespace

extern "C" {

// K3 on `stream`: `planes` is lns_plane_tables(fmt, mode).B, bf16 [R, 256]
// (R = 4 or 8); x's bit rule from (man_bits, bias, min_normal_code,
// bad_min, sign_classes); `tile` the block tile, 128, 64 or 32.  `batch`
// products in one launch: x [batch, M, K], w [batch, K, N] and out
// [batch, M, N], each product blockIdx.z summed as a launch of its own.
// Returns cudaGetLastError() (0 on success).
int lns_matmul(const void* x, const void* w, const void* planes, void* out,
               int M, int N, int K, int batch, int R, int man_bits, int bias,
               int min_normal_code, int bad_min, int sign_classes, int tile,
               void* stream) {
  if ((R != 4 && R != 8) || (tile != 128 && tile != 64 && tile != 32) ||
      batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const PlaneX px{man_bits, bias, min_normal_code, bad_min, sign_classes};
  const uint8_t* xc = (const uint8_t*)x;
  const uint8_t* wc = (const uint8_t*)w;
  const uint16_t* p = (const uint16_t*)planes;
  const cudaStream_t s = (cudaStream_t)stream;
  return R == 8 ? launch_lns<8>(xc, wc, p, (float*)out, M, N, K, batch, px,
                                tile, s)
                : launch_lns<4>(xc, wc, p, (float*)out, M, N, K, batch, px,
                                tile, s);
}

// K4 on `stream`: `tab` is kernels/lns_matmul.py::loop_tables(fmt, mode)
// (R B rows, R = 4 or 8), bk = min(128, K) the k tile; the k tiles are
// split `splits` ways, `per` tiles a block, and the sums of the tiles
// after the first `per` go through `sums` ([tiles - per, M, N] float32)
// to a second, elementwise launch.  Returns cudaGetLastError() (0 on
// success).
int lns_loop_matmul(const void* x, const void* w, const void* tab,
                    void* out, void* sums, int M, int N, int K, int bk,
                    int R, int splits, int per, void* stream) {
  if (bk < 1 || bk > kLoopBkMax || (K > 0 && bk != K && bk % kLoopKC) ||
      (R != 4 && R != 8) || splits < 1 || per < 1)
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int vec = K % 16 == 0 && N % 8 == 0 && ((uintptr_t)x & 15) == 0 &&
                  ((uintptr_t)w & 7) == 0;
  lns_loop_matmul_kernel<<<dim3((N + kLoopBN - 1) / kLoopBN,
                                (M + kLoopBM - 1) / kLoopBM, splits),
                           kLoopThreads, 0, s>>>(
      (const uint8_t*)x, (const uint8_t*)w, (const int32_t*)tab,
      (float*)out, (float*)sums, M, N, K, bk, R, per, vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long mn = (long long)M * N;
  const int later = (K + bk - 1) / bk - per;
  const long long blocks = (mn + 255) / 256;
  lns_loop_matmul_combine_kernel<<<(int)(blocks < 132 * 16 ? blocks
                                                           : 132 * 16),
                                   256, 0, s>>>((float*)out,
                                                (const float*)sums, mn,
                                                later);
  return (int)cudaGetLastError();
}

// K2 on `stream`: x decoded by format (x_*), w by format (w_*); `tile`
// the block tile, 128 (128 x 128) or 64 (64 x 64).  `batch` products in
// one launch, as for K3.  Returns cudaGetLastError() (0 on success).
int dequant_matmul(const void* x, const void* w, void* out, int M, int N,
                   int K, int batch, int x_man_bits, int x_bias,
                   int x_min_normal_code, int x_max_normal_code,
                   int w_man_bits, int w_bias, int w_min_normal_code,
                   int w_max_normal_code, int tile, void* stream) {
  const lns::Format fx{x_man_bits, x_bias, x_min_normal_code,
                       x_max_normal_code};
  const lns::Format fw{w_man_bits, w_bias, w_min_normal_code,
                       w_max_normal_code};
  if ((tile != 64 && tile != 128) || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const uint8_t* xc = (const uint8_t*)x;
  const uint8_t* wc = (const uint8_t*)w;
  const cudaStream_t s = (cudaStream_t)stream;
  return tile == 128
             ? launch_dequant<128, 128, 2, 4>(xc, wc, (float*)out, M, N, K,
                                              batch, fx, fw, s)
             : launch_dequant<64, 64, 2, 2>(xc, wc, (float*)out, M, N, K,
                                            batch, fx, fw, s);
}

}  // extern "C"
