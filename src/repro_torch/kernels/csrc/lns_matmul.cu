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
// subnormal, NaN and inf codes decode to 0) and the tiles are multiplied
// with float32 accumulation.  Every FP8 value is exact in bf16 and every
// product of two is exact in float32, so float32 FMA gives the products a
// bf16 MXU would, for compute_dtype bf16 and float32 alike.  What bounds
// K2: bytes at small M, the bf16 tensor-core rate at large M.  Design,
// first version: the same 64 x 64 tiles and 4 x 4 micro-tiles, codes
// decoded in registers on their way into shared memory, FMA on the CUDA
// cores, so K2 runs far below the tensor-core bound it is held to.  Later
// work: wgmma on bf16 tiles fed by TMA, or native FP8 wgmma on codes known
// to hold no subnormal, NaN or inf patterns.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lns_common.cuh"

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

__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const uint8_t* __restrict__ x,
                      const uint8_t* __restrict__ w, float* __restrict__ out,
                      int M, int N, int K, lns::Format fx, lns::Format fw) {
  __shared__ float xs[BK][BM + 1];    // decoded x tile, k-major (+1: banks)
  __shared__ float ws[BK][BN];        // decoded w tile
  const int tid = threadIdx.x;
  const int tx = tid % RX, ty = tid / RX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K)
          ? lns::code_to_f32(x[(size_t)m * K + k], fx) : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      ws[r][c] = (k < K && n < N)
          ? lns::code_to_f32(w[(size_t)k * N + n], fw) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * RX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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

// K2 on `stream`: x decoded by format (x_*), w by format (w_*).
// Returns cudaGetLastError() (0 on success).
int dequant_matmul(const void* x, const void* w, void* out, int M, int N,
                   int K, int x_man_bits, int x_bias, int x_min_normal_code,
                   int x_max_normal_code, int w_man_bits, int w_bias,
                   int w_min_normal_code, int w_max_normal_code,
                   void* stream) {
  const lns::Format fx{x_man_bits, x_bias, x_min_normal_code,
                       x_max_normal_code};
  const lns::Format fw{w_man_bits, w_bias, w_min_normal_code,
                       w_max_normal_code};
  if (M > 0 && N > 0)
    dequant_matmul_kernel<<<grid_of(M, N), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)x, (const uint8_t*)w, (float*)out, M, N, K, fx, fw);
  return (int)cudaGetLastError();
}

}  // extern "C"
