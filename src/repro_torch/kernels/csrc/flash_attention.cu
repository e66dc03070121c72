// Tiled online-softmax attention on float inputs for Hopper (sm_90a):
// kernel K6.  Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::_flash_kernel.
//
// Layout: the caller's own tensors, read through their strides (in
// elements, the last dimension contiguous): q [B, Sq, H, hd], k
// [B, Sk, KV, hd], v [B, Sk, KV, dv]; out [B, Sq, H, dv] contiguous,
// written in place.  Sq and Sk are the real lengths: the reference's zero
// padding to multiples of bq and bk is done by zero-filled loads past Sk
// and stores masked past Sq, never by a copy.  Query head h of batch b
// reads KV head h / (H/KV): k and v are never repeated in memory.
//
// What it computes, per output row: the reference's online softmax over
// the key tiles in order, bk keys at a time, in float32.  Scores are
// (q . k) * scale, then tanh(s / cap) * cap when cap != 0; the mask on
// absolute positions (k_pos < Sk, q_pos >= k_pos when causal, q_pos -
// k_pos < window when window) sets the finite NEG_INF = -2e30, never -inf;
// the running max m, sum l and accumulator are rescaled by
// exp(m_prev - m_new); the output is acc / max(l, 1e-37).
//
// The tile skip (key_tile_range, mirrored in kernels/flash_attention.py):
// a group of 64 query rows visits only the key tiles [first, last) that
// hold an admissible key for one of its real rows.  That is exact: a
// masked tile after a row's first admissible key has m_new == m_prev, so
// corr = exp(0) = 1 and every p = exp(-2e30 - m) = 0; a masked tile before
// it is wiped by corr = exp(-2e30 - m) = 0 at the first admissible tile.
// The one exception is a real row with no admissible key at all: with the
// finite NEG_INF every entry of it has p = 1, so it is sum(V) over the real
// keys divided by the padded key length nk * bk.  A group holding such a
// row visits every tile.  At qwen2-0.5b S 8192 causal with 128 x 128 tiles
// the visited tiles hold 1.016x the admissible pairs, half of every tile;
// at gemma2-27b's window of 4096 they are 0.387 of every tile.  Blocks take
// the query tiles last to first, so under a causal mask the longest start
// first.
//
// What bounds it on this card: operations.  Each admissible (query, key)
// pair costs hd multiply-adds for the score and dv for P.V, against a few
// bytes per row of q, k, v and out (at qwen2-0.5b S 8192: 1.2e11 FLOP
// against 33.5 MB, 0.12 ms at the bf16 tensor-core rate).  The bf16 body
// is held back by its CUDA-core work per score, not by the tensor cores:
// the exp2 on the quarter-rate MUFU unit, the scale, max and sum, and the
// P split's conversions take more issue slots than the HMMAs of an hd = 64
// head (chip_smoke.py and PERF.md give the rates).
//
// bfloat16 body (flash_attention_bf16_kernel): the tensor cores, through
// warp-level mma.sync m16n8k16 with float32 accumulation (mma_bf16.cuh).
// One 128-thread block per (batch x head, query tile of bq rows), the
// tile's rows taken 64 at a time, 16 per warp.  S = Q K^T multiplies the
// bf16 values exactly (a product of two bf16 values is exact in float32),
// so it is the reference's float32 dot with sums in another order; scale
// is applied after the product, as in the reference.  The scale, softcap,
// mask, max, exponential and sum run in registers on the accumulator
// fragments, each row's max and sum by a pairwise tree over the thread's
// values and a shuffle among the four lanes that hold the row; no score
// tile goes through shared memory.  Scores are kept in units of log2(e),
// so the exponential is one exp2 (the same function, within a few float32
// ulps).  O += P V takes P from the same registers (an m16n8 accumulator
// pair is an m16k16 A fragment) as p = p_hi + p_lo, p_hi = bf16(p), p_lo =
// bf16(p - p_hi), both products accumulated into one float32 fragment:
// each weight keeps about 2^-17 of relative accuracy, where one bf16 P
// (2^-9) would risk the one-ulp bf16 gate at rows with few keys.  K and V
// stream through a three-stage cp.async ring in shared memory, K of chunk
// i, V of chunk i, K of chunk i + 1, ..., each loaded two stages ahead of
// its use (rows padded to an odd number of 16-byte chunks, so ldmatrix is
// free of bank conflicts).  A chunk is 32, 64 or 128 keys, a compile-time
// width so that every fragment loop unrolls without a guard: the whole key
// tile when it fits (128 keys at dv <= 64, 64 above, less while the ring
// would not fit the 227 KB of shared memory), else a part of it, each part
// one more rescaling point, which changes rounding only.  Keys past a
// tile's end inside a chunk carry p = 0 exactly; features past hd and dv
// are zero-filled.  Views whose strides or base are not 16-byte multiples
// are loaded element by element, synchronously.
//
// float32 body (flash_attention_f32_kernel): the CUDA cores, as the first
// version of this kernel, with the same tile skip, order and strided
// loads.  The tensor cores have no float32 product of float32 accuracy
// (TF32 keeps 10 mantissa bits), and the float32 gate is rtol = atol =
// 1e-4 against a float32 plain version; a 3xTF32 or bf16 x 3 split is
// later work.  One 256-thread block per (batch x head, query tile), 64
// rows at a time; scores through shared memory by 4 x 4 register
// micro-tiles of FMA, k and v streamed in 64-key chunks (hd = dv = 256 at
// bk = 256 fits, 201 KB).
// Later work for both: warpgroup wgmma fed by TMA, warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -2.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;   // 227 KB: a block's shared memory
constexpr int R = 64;              // query rows per row group

struct Params {
  int B, H, KV, Sq, Sk, hd, dv, bq, bk, nk, causal, window;
  float scale, cap;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;   // element strides
  int vec;             // 16-byte loads allowed (bf16 body)
  int ldq;             // bf16 body: padded smem row size of q and k
  int ldkv, lds;       // float32 body: kv chunk row size, score row stride
};

// Key tiles [first, last) holding an admissible key for some real row
// (below Sq) of the query rows [q0, q0 + rows); every tile [0, nk) if a
// real row has no admissible key; [0, 0) if no row is real.  Row qp admits
// the keys [lo(qp), hi(qp)]; lo and hi never decrease with qp and hi - lo
// is concave, so the first and last real rows decide.  The same closed
// form as kernels/flash_attention.py::key_tile_range.
__device__ __forceinline__ int admit_lo(int qp, int window) {
  return window ? max(0, qp - window + 1) : 0;
}
__device__ __forceinline__ int admit_hi(int qp, int k_len, int causal) {
  return causal ? min(k_len - 1, qp) : k_len - 1;
}
__device__ __forceinline__ void key_tile_range(
    int q0, int rows, int Sq, int k_len, int bk, int nk, int causal,
    int window, int* first, int* last) {
  const int qa = q0, qz = min(q0 + rows, Sq) - 1;
  if (qz < qa) {
    *first = *last = 0;
    return;
  }
  if (admit_lo(qa, window) > admit_hi(qa, k_len, causal) ||
      admit_lo(qz, window) > admit_hi(qz, k_len, causal)) {
    *first = 0;
    *last = nk;
    return;
  }
  *first = admit_lo(qa, window) / bk;
  *last = admit_hi(qz, k_len, causal) / bk + 1;
}

__device__ __forceinline__ bool admissible(int qp, int kp, const Params& p) {
  bool ok = kp < p.Sk;
  if (p.causal) ok = ok && qp >= kp;
  if (p.window) ok = ok && qp - kp < p.window;
  return ok;
}

// ------------------------------------------------------------------------ //
// bfloat16: tensor cores
// ------------------------------------------------------------------------ //
constexpr int kTcThreads = 128;    // 4 warps x 16 query rows
constexpr int kStages = 3;         // the K/V ring: K(0), V(0), K(1), ...

// rows x cols bf16 values of a row-major global tile into shared memory
// (row stride ld), row r valid when ok_row(r), columns past `cols_real`
// zero; cols is a multiple of 8.  16-byte cp.async when vec (each thread
// steps through the chunks without a division), else element by element.
template <typename OkRow>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int rows,
                                          int cols, int cols_real, int vec,
                                          OkRow ok_row) {
  if (vec) {
    const int cpr = cols / 8;   // 16-byte chunks per row
    const int dr = kTcThreads / cpr, dc = kTcThreads % cpr;
    int r = threadIdx.x / cpr, c = threadIdx.x % cpr;
    while (r < rows) {
      const int d = c * 8;
      const bool ok = ok_row(r) && d < cols_real;
      mma::cp_async16(dst + r * ld + d, ok ? src + r * row_stride + d : src,
                      ok ? 16 : 0);
      r += dr;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kTcThreads) {
      const int r = i / cols, d = i % cols;
      dst[r * ld + d] = (ok_row(r) && d < cols_real)
                            ? src[r * row_stride + d]
                            : __float2bfloat16(0.0f);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// DVT: dv rounded up to 64, 128 or 256 (the output accumulator's width);
// KC: keys per chunk, 32, 64 or 128.  Both are compile-time, so every
// fragment loop unrolls without a guard and the ldmatrix loads of a step
// issue together ahead of its products.
template <int DVT, int KC>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + R * p.ldq;   // kStages x [KC][max(ldq, ldv)]
  constexpr int ldv = DVT + 8;            // an odd number of 16-byte chunks
  const int stage = KC * max(p.ldq, ldv);
  const int hdp = (p.hd + 15) / 16 * 16;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const __nv_bfloat16* qb = q + b * p.qb + h * p.qh;
  const __nv_bfloat16* kb = k + b * p.kb + kvh * p.kh;
  const __nv_bfloat16* vb = v + b * p.vb + kvh * p.vh;
  const int cpt = (p.bk + KC - 1) / KC;   // chunks per key tile
  // the last query tiles first: under a causal mask they visit the most
  // key tiles, and started last they would run alone at the end
  const int qt = gridDim.x - 1 - blockIdx.x;

  for (int g0 = 0; g0 < p.bq; g0 += R) {
    const int rows = min(R, p.bq - g0);
    const int row0 = qt * p.bq + g0;   // absolute position of row 0
    int first, last;
    key_tile_range(row0, rows, p.Sq, p.Sk, p.bk, p.nk, p.causal, p.window,
                   &first, &last);
    if (first >= last) continue;   // no real row in this group
    const int nc = (last - first) * cpt;

    // ring element e: the keys of chunk e / 2 (tile t, keys [t * bk + c0,
    // + KC)), K when e is even, V when odd, into stage e % kStages; rows
    // past the tile's end or past Sk are zeros
    auto load_elem = [&](int e) {
      if (e >= 2 * nc) return;
      const int i = e >> 1, t = first + i / cpt, c0 = (i % cpt) * KC;
      const int key0 = t * p.bk + c0, nvalid = min(KC, p.bk - c0);
      auto ok = [&](int r) { return r < nvalid && key0 + r < p.Sk; };
      __nv_bfloat16* dst = ring + (e % kStages) * stage;
      if (e & 1)
        load_tile(dst, ldv, vb + key0 * p.vs, p.vs, KC, DVT, p.dv, p.vec, ok);
      else
        load_tile(dst, p.ldq, kb + key0 * p.ks, p.ks, KC, hdp, p.hd, p.vec,
                  ok);
    };
    // wait for ring element e, then refill the stage element e - 1 held
    // with element e + 2
    auto next_elem = [&](int e) {
      mma::cp_async_wait<kStages - 2>();
      __syncthreads();   // element e is in; everyone is done with e - 1
      load_elem(e + 2);
      mma::cp_async_commit();
    };

    __syncthreads();   // the previous row group is done with qs and the ring
    load_tile(qs, p.ldq, qb + row0 * p.qs, p.qs, R, hdp, p.hd, p.vec,
              [&](int r) { return r < rows && row0 + r < p.Sq; });
    load_elem(0);
    mma::cp_async_commit();
    load_elem(1);
    mma::cp_async_commit();

    const int qw = row0 + warp * 16;                 // the warp's rows
    const int qr = qw + (lane >> 2);                 // rows qr and qr + 8
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float acc[DVT / 8][4];
#pragma unroll
    for (int n = 0; n < DVT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

    for (int i = 0; i < nc; ++i) {
      next_elem(2 * i);   // K of chunk i
      const int t = first + i / cpt, c0 = (i % cpt) * KC;
      const int key0 = t * p.bk + c0, nvalid = min(KC, p.bk - c0);
      const __nv_bfloat16* ks = ring + ((2 * i) % kStages) * stage;

      // S = Q K^T: float32 sums of exact bf16 products
      float s[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      for (int d0 = 0; d0 < hdp; d0 += 16) {
        uint32_t a[4], bb[KC / 16][4];
        mma::ldmatrix_x4(a, qs + (warp * 16 + mma::a_row(lane)) * p.ldq +
                                d0 + mma::a_col(lane));
#pragma unroll
        for (int j = 0; j < KC / 16; ++j)
          mma::ldmatrix_x4(bb[j], ks + (j * 16 + mma::bn_row(lane)) * p.ldq +
                                      d0 + mma::bn_col(lane));
#pragma unroll
        for (int j = 0; j < KC / 16; ++j) {
          mma::mma_bf16(s[2 * j], a, bb[j][0], bb[j][1]);
          mma::mma_bf16(s[2 * j + 1], a, bb[j][2], bb[j][3]);
        }
      }

      // scale, softcap, mask; the chunk's row max.  A chunk whose keys are
      // all in the tile and admissible for all of the warp's rows skips
      // the mask.
      const int kz = key0 + KC - 1;   // the chunk's last key
      const bool open = nvalid == KC && kz < p.Sk &&
                        (!p.causal || qw >= kz) &&
                        (!p.window || qw + 15 - key0 < p.window);
      // (each branch is uniform and taken once per chunk, around its loop)
      // Scores are kept in units of log2(e) (x log2e), so p = exp2(s - m)
      // is one MUFU.EX2: the same function as expf on the natural scores,
      // within a few float32 ulps.
      if (p.cap != 0.0f) {
        const float cap2 = p.cap * kLog2e;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = tanhf(s[j][e] * p.scale / p.cap) * cap2;
      } else {
        const float scale2 = p.scale * kLog2e;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
      }
      if (!open) {
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * (lane & 3) + (e & 1);
            if (col >= nvalid)
              s[j][e] = -INFINITY;   // past the tile's end: p = 0 exactly
            else if (!admissible(qr + (e >> 1) * 8, key0 + col, p))
              s[j][e] = kNegInf;
          }
        }
      }
      // each row's max and sum over the thread's values by a pairwise
      // tree (short dependency chains), then over the row's four lanes
      float red[2][KC / 8];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        red[0][j] = fmaxf(s[j][0], s[j][1]);
        red[1][j] = fmaxf(s[j][2], s[j][3]);
      }
#pragma unroll
      for (int w = 1; w < KC / 8; w *= 2)
#pragma unroll
        for (int j = 0; j + w < KC / 8; j += 2 * w) {
          red[0][j] = fmaxf(red[0][j], red[0][j + w]);
          red[1][j] = fmaxf(red[1][j], red[1][j + w]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(red[r][0]));
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        red[0][j] = s[j][0] + s[j][1];
        red[1][j] = s[j][2] + s[j][3];
      }
#pragma unroll
      for (int w = 1; w < KC / 8; w *= 2)
#pragma unroll
        for (int j = 0; j + w < KC / 8; j += 2 * w) {
          red[0][j] += red[0][j + w];
          red[1][j] += red[1][j + w];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * corr[r] + quad_sum(red[r][0]);
#pragma unroll
      for (int n = 0; n < DVT / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // O += P V, P = p_hi + p_lo from the score registers
      next_elem(2 * i + 1);   // V of chunk i
      const __nv_bfloat16* vs = ring + ((2 * i + 1) % kStages) * stage;
#pragma unroll
      for (int j = 0; j < KC / 16; ++j) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {   // x: a0..a3 of the A fragment
          const float p0 = s[2 * j + (x >> 1)][2 * (x & 1)];
          const float p1 = s[2 * j + (x >> 1)][2 * (x & 1) + 1];
          hi[x] = mma::pack_bf16(p0, p1);
          lo[x] = mma::pack_bf16(p0 - mma::bf16_lo(hi[x]),
                                 p1 - mma::bf16_hi(hi[x]));
        }
        uint32_t bb[DVT / 16][4];
#pragma unroll
        for (int n = 0; n < DVT / 16; ++n)
          mma::ldmatrix_x4_trans(bb[n], vs + (j * 16 + mma::bk_row(lane)) *
                                                 ldv + n * 16 +
                                             mma::bk_col(lane));
#pragma unroll
        for (int n = 0; n < DVT / 16; ++n) {
          mma::mma_bf16(acc[2 * n], hi, bb[n][0], bb[n][1]);
          mma::mma_bf16(acc[2 * n + 1], hi, bb[n][2], bb[n][3]);
        }
#pragma unroll
        for (int n = 0; n < DVT / 16; ++n) {
          mma::mma_bf16(acc[2 * n], lo, bb[n][0], bb[n][1]);
          mma::mma_bf16(acc[2 * n + 1], lo, bb[n][2], bb[n][3]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qr + 8 * r;
      if (qp >= p.Sq || qp - row0 >= rows) continue;
      const float den = fmaxf(l[r], 1e-37f);
      __nv_bfloat16* orow = out + ((size_t)(b * p.Sq + qp) * p.H + h) * p.dv;
#pragma unroll
      for (int n = 0; n < DVT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = n * 8 + 2 * (lane & 3) + e;
          if (d < p.dv) orow[d] = __float2bfloat16(acc[n][2 * r + e] / den);
        }
      }
    }
  }
}

template <int DVT, int KC>
int launch_bf16_kc(const void* q, const void* k, const void* v, void* out,
                   const Params& p, int nbytes, cudaStream_t stream) {
  auto kernel = flash_attention_bf16_kernel<DVT, KC>;
  if (nbytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.B * p.H);
  kernel<<<grid, kTcThreads, nbytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, p);
  return (int)cudaGetLastError();
}

// The chunk: the fewest keys of 32, 64 or 128 that hold a key tile (two
// or more chunks a tile above 128), at most 64 at dv > 64 (the score
// fragments and the accumulator share the registers: 128 keys there leave
// one block per SM), and smaller while the ring does not fit the 227 KB of
// shared memory.
template <int DVT>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                Params p, cudaStream_t stream) {
  p.ldq = (p.hd + 15) / 16 * 16 + 8;   // an odd number of 16-byte chunks:
  const int ldv = DVT + 8;             // ldmatrix rows in 8 bank groups
  const int ld = p.ldq > ldv ? p.ldq : ldv;
  auto bytes = [&](int kc) {
    return (int)sizeof(__nv_bfloat16) * (R * p.ldq + kStages * kc * ld);
  };
  int kc = p.bk <= 32 ? 32 : p.bk <= 64 ? 64 : 128;
  if (DVT > 64 && kc > 64) kc = 64;
  while (kc > 32 && bytes(kc) > kMaxSmem) kc /= 2;
  if constexpr (DVT == 64) {
    if (kc == 128)
      return launch_bf16_kc<DVT, 128>(q, k, v, out, p, bytes(kc), stream);
  }
  if (kc == 64)
    return launch_bf16_kc<DVT, 64>(q, k, v, out, p, bytes(kc), stream);
  return launch_bf16_kc<DVT, 32>(q, k, v, out, p, bytes(kc), stream);
}

// ------------------------------------------------------------------------ //
// float32: CUDA cores
// ------------------------------------------------------------------------ //
constexpr int kThreads = 256;   // 16 x 16
constexpr int C = 64;           // keys per shared-memory chunk
constexpr int TI = R / 16;      // rows per thread
constexpr int TC = C / 16;      // keys per thread in the score tile

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  const int ldq = p.hd | 1;          // odd: conflict-free columns
  float* qs = smem;                  // [R][ldq]  the row group's queries
  float* kv = qs + R * ldq;          // a chunk of k [C][ldq] or v [C][dv]
  float* ss = kv + C * p.ldkv;       // [R][lds]  the tile's scores / p
  __shared__ float m_s[R], l_s[R], corr_s[R];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const float* qb = q + b * p.qb + h * p.qh;
  const float* kb = k + b * p.kb + kvh * p.kh;
  const float* vb = v + b * p.vb + kvh * p.vh;
  const int qt = gridDim.x - 1 - blockIdx.x;   // the last query tiles first

  for (int g0 = 0; g0 < p.bq; g0 += R) {
    const int rows = min(R, p.bq - g0);
    const int row0 = qt * p.bq + g0;   // absolute position of row 0
    int first, last;
    key_tile_range(row0, rows, p.Sq, p.Sk, p.bk, p.nk, p.causal, p.window,
                   &first, &last);
    if (first >= last) continue;   // no real row in this group
    __syncthreads();  // the previous row group is done with qs and m_s
    for (int i = tid; i < R * p.hd; i += kThreads) {
      const int r = i / p.hd, d = i % p.hd;
      qs[r * ldq + d] = (r < rows && row0 + r < p.Sq)
                            ? qb[(row0 + r) * p.qs + d] : 0.0f;
    }
    if (tid < R) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.0f;
    }
    float acc[TI][NJ];
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

    for (int t = first; t < last; ++t) {
      const int k0 = t * p.bk;
      // scores of the tile, C keys at a time
      for (int c0 = 0; c0 < p.bk; c0 += C) {
        const int cn = min(C, p.bk - c0);
        __syncthreads();  // kv is free, qs and m_s are written
        for (int i = tid; i < cn * p.hd; i += kThreads) {
          const int c = i / p.hd, d = i % p.hd, kp = k0 + c0 + c;
          kv[c * ldq + d] = kp < p.Sk ? kb[kp * p.ks + d] : 0.0f;
        }
        __syncthreads();
        float s[TI][TC];
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < p.hd; ++d) {
          float a[TI], bv[TC];
#pragma unroll
          for (int i = 0; i < TI; ++i) a[i] = qs[(ty + 16 * i) * ldq + d];
#pragma unroll
          for (int j = 0; j < TC; ++j) bv[j] = kv[(tx + 16 * j) * ldq + d];
#pragma unroll
          for (int i = 0; i < TI; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          const int r = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const int c = tx + 16 * j;
            if (c >= cn) continue;
            float x = s[i][j] * p.scale;
            if (p.cap != 0.0f) x = tanhf(x / p.cap) * p.cap;
            ss[r * p.lds + c0 + c] =
                admissible(row0 + r, k0 + c0 + c, p) ? x : kNegInf;
          }
        }
      }
      __syncthreads();
      // online softmax over the tile: four threads per row
      {
        const int r = tid / 4, part = tid % 4;
        float* row = ss + r * p.lds;
        float mt = kNegInf;
        for (int c = part; c < p.bk; c += 4) mt = fmaxf(mt, row[c]);
        mt = quad_max(mt);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mt);
        float sum = 0.0f;
        for (int c = part; c < p.bk; c += 4) {
          const float e = expf(row[c] - m_new);
          row[c] = e;
          sum += e;
        }
        sum = quad_sum(sum);
        if (part == 0) {
          const float corr = expf(m_prev - m_new);
          corr_s[r] = corr;
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const float corr = corr_s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
      }
      // acc += P . V, C keys at a time
      for (int c0 = 0; c0 < p.bk; c0 += C) {
        const int cn = min(C, p.bk - c0);
        __syncthreads();  // kv is free
        for (int i = tid; i < cn * p.dv; i += kThreads) {
          const int c = i / p.dv, d = i % p.dv, kp = k0 + c0 + c;
          kv[c * p.dv + d] = kp < p.Sk ? vb[kp * p.vs + d] : 0.0f;
        }
        __syncthreads();
        for (int c = 0; c < cn; ++c) {
          float pr[TI], vv[NJ];
#pragma unroll
          for (int i = 0; i < TI; ++i) pr[i] = ss[(ty + 16 * i) * p.lds + c0 + c];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int d = tx + 16 * j;
            vv[j] = d < p.dv ? kv[c * p.dv + d] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < TI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // l_s is final
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int r = ty + 16 * i, qp = row0 + r;
      if (r >= rows || qp >= p.Sq) continue;
      const float l = fmaxf(l_s[r], 1e-37f);
      float* orow = out + ((size_t)(b * p.Sq + qp) * p.H + h) * p.dv;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < p.dv) orow[d] = acc[i][j] / l;
      }
    }
  }
}

template <int NJ>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               Params p, cudaStream_t stream) {
  p.ldkv = (p.hd | 1) > p.dv ? (p.hd | 1) : p.dv;
  p.lds = (p.bk + 31) / 32 * 32 + 16;   // two rows of a warp 16 banks apart
  const size_t bytes =
      sizeof(float) * ((size_t)R * (p.hd | 1) + (size_t)C * p.ldkv +
                       (size_t)R * p.lds);
  auto kernel = flash_attention_f32_kernel<NJ>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, p.B * p.H);
  kernel<<<grid, kThreads, bytes, stream>>>((const float*)q, (const float*)k,
                                            (const float*)v, (float*)out, p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

extern "C" {

// K6 on `stream`.  dtype 0 = float32, 1 = bfloat16 (q, k, v and out).
// Sq, Sk: the real lengths; q/k/v strides in elements (batch, sequence,
// head; the feature dimension is contiguous); out [B, Sq, H, dv]
// contiguous.  Returns a CUDA error code (0 on success): cudaGetLastError()
// after the launch, or the error of a shape the kernel does not take.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int dtype, int B, int H, int KV, int Sq, int Sk, int hd,
                    int dv, int bq, int bk, int causal, int window,
                    float scale, float cap, long long q_sb, long long q_ss,
                    long long q_sh, long long k_sb, long long k_ss,
                    long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, void* stream) {
  if (KV <= 0 || H % KV || hd < 1 || hd > 256 || dv < 1 || dv > 256 ||
      bq < 1 || bq > 256 || bk < 1 || bk > 256 || Sq < 0 || Sk < 1 ||
      B * H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  Params p{};
  p.B = B; p.H = H; p.KV = KV; p.Sq = Sq; p.Sk = Sk; p.hd = hd; p.dv = dv;
  p.bq = bq; p.bk = bk; p.nk = (Sk + bk - 1) / bk;
  p.causal = causal; p.window = window; p.scale = scale; p.cap = cap;
  p.qb = q_sb; p.qs = q_ss; p.qh = q_sh;
  p.kb = k_sb; p.ks = k_ss; p.kh = k_sh;
  p.vb = v_sb; p.vs = v_ss; p.vh = v_sh;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (dv <= 16) return launch_f32<1>(q, k, v, out, p, s);
    if (dv <= 32) return launch_f32<2>(q, k, v, out, p, s);
    if (dv <= 64) return launch_f32<4>(q, k, v, out, p, s);
    if (dv <= 128) return launch_f32<8>(q, k, v, out, p, s);
    return launch_f32<16>(q, k, v, out, p, s);
  }
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss,
                                k_sh, v_sb, v_ss, v_sh};
  p.vec = aligned16(q) && aligned16(k) && aligned16(v) && hd % 8 == 0 &&
          dv % 8 == 0;
  for (long long st : strides) p.vec = p.vec && st % 8 == 0;
  if (dv <= 64) return launch_bf16<64>(q, k, v, out, p, s);
  if (dv <= 128) return launch_bf16<128>(q, k, v, out, p, s);
  return launch_bf16<256>(q, k, v, out, p, s);
}

}  // extern "C"
