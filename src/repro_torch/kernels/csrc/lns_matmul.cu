// Matrix products of FP8 code matrices for Hopper (sm_90a): the paper's
// LNS matmul (K3), its sequential seed form (K4) and the fused-dequant
// matmul (K2).  All three take uint8 codes
// x [M, K] and w [K, N] (row-major, contiguous) and write float32
// out [M, N] = sum_k product(x[m, k], w[k, n]); the caller applies the
// scales.
//
// K3, lns_matmul_kernel, replaces the Pallas TPU kernel
// repro/kernels/lns_matmul.py::_lns_kernel (impl "lns").  Each product is
// the paper's integer add of the two operands' prepared magnitudes plus
// the Table 2/3 carry-in bit, placed into the float32 exponent and
// mantissa fields (lns::lns_product, shared with K1); no float multiplier
// is used.  The operands' prepared fields come from the 256-entry tables
// of kernels/common.py::lns_tables (side x = activations, side y =
// weights; the carry masks differ by side), so one kernel serves every
// (format, mode) pair.  Products are bit-exact against the plain version;
// the float32 sum over k runs in k order inside each thread, another
// order than the TPU's chunked [bm, ck, bn] sum, so sums are allclose.
//
// What bounds K3 on this card: integer operations.  M*N*K products, each
// compiled to nine 32-bit integer instructions in the inner loop (five
// LOP3 for the carry, zero and NaN tests and the sign merge, two IMAD and
// one VIADD for the adds and the carry select, one SHF), two FSEL and one
// float add; chip_smoke.py counts them from the SASS.  The card runs
// 32-bit integer instructions on 64 lanes per SM, half its float32 lanes,
// so at the chip smoke's 1024 x 896 x 4864 the ~4e10 integer instructions
// against ~2 MB of codes set the time.  Design, first version: a 2-D
// tiled kernel, one 256-thread block per 64 x 64 output tile; per 32-deep
// k step the block turns its x and w code tiles into prepared (mag, flags)
// pairs in shared memory through the tables (the per-operand work is done
// once per tile element, not once per product), and each thread keeps a
// 4 x 4 register micro-tile, so each product costs two shared-memory
// reads shared by four products plus the integer combine.  Ragged edges
// are masked in the kernel: a missing element is a zero operand, whose
// product is exactly 0.  Later work: pack the fields to cut shared-memory
// traffic, larger micro-tiles, a split-k or smaller tile for narrow N.
//
// K4, lns_loop_matmul_kernel, replaces the Pallas TPU kernel
// repro/kernels/lns_matmul.py::_lns_loop_kernel (impl "lns_loop"), the
// seed kernel that K3 is measured against (BENCH_1's speedup row), and
// keeps its design: each block owns an output tile (16 x 16, one output
// per thread) and the k loop is a sequential rank-1 update in which every
// product looks both operands' fields up in the 256-entry tables of
// kernels/common.py::lns_tables (K3 prepares each tile element once) and
// combines them with lns::lns_product.  The sums follow the reference's
// order exactly: k in order within tiles of bk = min(128, K) (K padded by
// code 0, whose product is +0), each tile's sum started from 0 and added
// to the output in order, so K4 is bitwise equal to its plain version
// (kernels/lns_matmul.py::lns_loop_matmul_plain) and to the reference.
// What bounds it: integer instructions, as K3, but more of them per
// product (two table lookups each, and the loop's own); chip_smoke.py
// counts them from the SASS.  The k loop is not unrolled, so that loop is
// the product count's one instruction stream.
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

#include "lns_common.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int TM = 4, TN = 4;
constexpr int RX = BN / TN;          // 16 threads across a tile's columns
constexpr int kThreads = (BM / TM) * RX;  // 256

__global__ void __launch_bounds__(kThreads)
lns_matmul_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                  const int32_t* __restrict__ lut, float* __restrict__ out,
                  int M, int N, int K, int man_bits) {
  __shared__ int2 tab[2][256];        // (mag, flags) of every code, x and y
  __shared__ int2 xs[BK][BM + 1];     // prepared x tile, k-major (+1: banks)
  __shared__ int2 ws[BK][BN];         // prepared w tile
  const int tid = threadIdx.x;
  const int tx = tid % RX, ty = tid / RX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int2 zero = make_int2(0, lns::kZeroBit);  // masked edge operand

  for (int i = tid; i < 512; i += kThreads)
    tab[i >> 8][i & 255] = make_int2(lut[2 * i], lut[2 * i + 1]);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? tab[0][x[(size_t)m * K + k]] : zero;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      ws[r][c] = (k < K && n < N) ? tab[1][w[(size_t)k * N + n]] : zero;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      int2 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * RX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += lns::lns_product(a[i].x, a[i].y, b[j].x, b[j].y,
                                        man_bits);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * RX;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

constexpr int LT = 16;               // K4 output tile: LT x LT
constexpr int kLoopBkMax = 128;      // K4's k tile, bk = min(128, K)

__global__ void __launch_bounds__(LT * LT)
lns_loop_matmul_kernel(const uint8_t* __restrict__ x,
                       const uint8_t* __restrict__ w,
                       const int32_t* __restrict__ lut,
                       float* __restrict__ out, int M, int N, int K, int bk,
                       int man_bits) {
  __shared__ int2 tab[2][256];        // (mag, flags) of every code, x and y
  __shared__ uint8_t xs[LT][kLoopBkMax];   // x codes of the k tile
  __shared__ uint8_t ws[kLoopBkMax][LT];   // w codes of the k tile
  const int tid = threadIdx.x;
  const int tx = tid % LT, ty = tid / LT;
  const int m0 = blockIdx.y * LT, n0 = blockIdx.x * LT;
  const int m = m0 + ty, n = n0 + tx;

  for (int i = tid; i < 512; i += LT * LT)
    tab[i >> 8][i & 255] = make_int2(lut[2 * i], lut[2 * i + 1]);
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += bk) {   // the last tile padded by code 0
    __syncthreads();
    for (int i = tid; i < LT * bk; i += LT * LT) {
      const int r = i / bk, c = i % bk;
      const int mm = m0 + r, k = k0 + c;
      xs[r][c] = (mm < M && k < K) ? x[(size_t)mm * K + k] : 0;
    }
    for (int i = tid; i < bk * LT; i += LT * LT) {
      const int r = i / LT, c = i % LT;
      const int k = k0 + r, nn = n0 + c;
      ws[r][c] = (k < K && nn < N) ? w[(size_t)k * N + nn] : 0;
    }
    __syncthreads();
    float tile = 0.0f;
#pragma unroll 1
    for (int kk = 0; kk < bk; ++kk) {
      const int2 a = tab[0][xs[ty][kk]];
      const int2 b = tab[1][ws[kk][tx]];
      tile += lns::lns_product(a.x, a.y, b.x, b.y, man_bits);
    }
    acc += tile;
  }
  if (m < M && n < N) out[(size_t)m * N + n] = acc;
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
                   int N, int K, const lns::Format& fx, const lns::Format& fw,
                   cudaStream_t stream) {
  constexpr int bytes = dequant_smem<BM_, BN_>();
  auto kernel = dequant_matmul_kernel<BM_, BN_, WM, WN, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + BN_ - 1) / BN_, (M + BM_ - 1) / BM_);
  kernel<<<grid, WM * WN * 32, bytes, stream>>>(
      x, w, out, M, N, K, bf16_decode(fx), bf16_decode(fw));
  return (int)cudaGetLastError();
}

template <int BM_, int BN_, int WM, int WN>
int launch_dequant(const uint8_t* x, const uint8_t* w, float* out, int M,
                   int N, int K, const lns::Format& fx, const lns::Format& fw,
                   cudaStream_t stream) {
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   ((uintptr_t)x & 15) == 0 && ((uintptr_t)w & 15) == 0;
  return vec ? launch_dequant<BM_, BN_, WM, WN, true>(x, w, out, M, N, K, fx,
                                                      fw, stream)
             : launch_dequant<BM_, BN_, WM, WN, false>(x, w, out, M, N, K,
                                                       fx, fw, stream);
}

dim3 grid_of(int M, int N) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM);
}

}  // namespace

extern "C" {

// K3 on `stream`; `lut` is lns_tables(fmt, mode): int32 [2, 256, 2].
// Returns cudaGetLastError() (0 on success).
int lns_matmul(const void* x, const void* w, const void* lut, void* out,
               int M, int N, int K, int man_bits, void* stream) {
  if (M > 0 && N > 0)
    lns_matmul_kernel<<<grid_of(M, N), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const uint8_t*)w, (const int32_t*)lut,
        (float*)out, M, N, K, man_bits);
  return (int)cudaGetLastError();
}

// K4 on `stream`; `lut` as for K3, bk = min(128, K) the k tile.
// Returns cudaGetLastError() (0 on success).
int lns_loop_matmul(const void* x, const void* w, const void* lut,
                    void* out, int M, int N, int K, int bk, int man_bits,
                    void* stream) {
  if (bk < 1 || bk > kLoopBkMax) return (int)cudaErrorInvalidValue;
  if (M > 0 && N > 0)
    lns_loop_matmul_kernel<<<dim3((N + LT - 1) / LT, (M + LT - 1) / LT),
                             LT * LT, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const uint8_t*)w, (const int32_t*)lut,
        (float*)out, M, N, K, bk, man_bits);
  return (int)cudaGetLastError();
}

// K2 on `stream`: x decoded by format (x_*), w by format (w_*); `tile`
// the block tile, 128 (128 x 128) or 64 (64 x 64).
// Returns cudaGetLastError() (0 on success).
int dequant_matmul(const void* x, const void* w, void* out, int M, int N,
                   int K, int x_man_bits, int x_bias, int x_min_normal_code,
                   int x_max_normal_code, int w_man_bits, int w_bias,
                   int w_min_normal_code, int w_max_normal_code, int tile,
                   void* stream) {
  const lns::Format fx{x_man_bits, x_bias, x_min_normal_code,
                       x_max_normal_code};
  const lns::Format fw{w_man_bits, w_bias, w_min_normal_code,
                       w_max_normal_code};
  if (tile != 64 && tile != 128) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const uint8_t* xc = (const uint8_t*)x;
  const uint8_t* wc = (const uint8_t*)w;
  const cudaStream_t s = (cudaStream_t)stream;
  return tile == 128
             ? launch_dequant<128, 128, 2, 4>(xc, wc, (float*)out, M, N, K,
                                              fx, fw, s)
             : launch_dequant<64, 64, 2, 2>(xc, wc, (float*)out, M, N, K, fx,
                                            fw, s);
}

}  // extern "C"
