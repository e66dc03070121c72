// Tiled online-softmax attention on float inputs for Hopper (sm_90a):
// kernel K6.  Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::_flash_kernel.
//
// Layout (the wrapper pads and folds, kernels/flash_attention.py::_launch):
// q [B*H, Sq, hd], k [B*KV, Sk, hd], v [B*KV, Sk, dv], out [B*H, Sq, dv],
// contiguous, float32 or bfloat16; Sq and Sk are multiples of bq and bk,
// the padded rows zero.  Query head h of batch b reads KV head
// b*KV + h / (H/KV): k and v are never repeated in memory.
//
// What it computes, per output row: the reference's online softmax over
// the key tiles in order, bk keys at a time, in float32.  Scores are
// (q . k) * scale, then tanh(s / cap) * cap when cap != 0; the mask on
// absolute positions (k_pos < k_len, q_pos >= k_pos when causal,
// q_pos - k_pos < window when window) sets the finite NEG_INF = -2e30,
// never -inf; the running max m, sum l and accumulator are rescaled by
// expf(m_prev - m_new); the output is acc / max(l, 1e-37).  Every key
// tile is computed, fully masked ones too: with a finite NEG_INF a row
// with no admissible key is the sum of V over the real keys divided by
// the padded key length (every masked entry has exp(s - m) = 1), and a
// kernel that skipped masked tiles would give something else.
//
// What bounds it on this card: operations.  Each (query, key) pair costs
// hd multiply-adds for the score and dv for P.V, all of them computed
// (no tile skip), against a few bytes per row of q, k, v and out; at
// qwen2-0.5b S = 8192 that is 2.4e11 FLOP against ~30 MB.  Design, first
// version: one 256-thread block per (batch x head, query tile of bq
// rows), the tile's rows taken 64 at a time.  For each key tile, the
// scores go through shared memory: k streamed in chunks of 64 keys
// (so bk = 256 at hd = 256 still fits), each thread a 4 x 4 register
// micro-tile of scores with float32 FMA on the CUDA cores; then four
// threads per row take the tile's max, expf and sum; then v is streamed
// in 64-key chunks and each thread accumulates a 4 x (dv/16) tile of the
// output in registers.  Shared memory: 64 q rows, one 64-key chunk and
// the 64 x bk score tile, up to 201 KB (hd = dv = 256, bk = 256; above
// 48 KB by opting in).  Later work: bf16 mma/wgmma for both products,
// TMA loads, and a tile skip that keeps the no-admissible-key rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e30f;
constexpr int kThreads = 256;   // 16 x 16
constexpr int R = 64;           // query rows per row group
constexpr int C = 64;           // keys per shared-memory chunk
constexpr int TI = R / 16;      // rows per thread
constexpr int TC = C / 16;      // keys per thread in the score tile

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

struct Params {
  int H, KV, Sq, Sk, k_len, hd, dv, bq, bk, causal, window;
  float scale, cap;
  int ldq, ldkv, lds;  // q/k and score row strides, kv chunk row size
};

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Params p) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [R][ldq]  the row group's queries
  float* kv = qs + R * p.ldq;        // a chunk of k [C][ldq] or v [C][dv]
  float* ss = kv + C * p.ldkv;       // [R][lds]  the tile's scores / p
  __shared__ float m_s[R], l_s[R], corr_s[R];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int kvh = (bh / p.H) * p.KV + (bh % p.H) / (p.H / p.KV);
  const T* qb = q + (size_t)bh * p.Sq * p.hd;
  const T* kb = k + (size_t)kvh * p.Sk * p.hd;
  const T* vb = v + (size_t)kvh * p.Sk * p.dv;
  T* ob = out + (size_t)bh * p.Sq * p.dv;
  const int nk = p.Sk / p.bk;

  for (int g0 = 0; g0 < p.bq; g0 += R) {
    const int rows = min(R, p.bq - g0);
    const int row0 = blockIdx.x * p.bq + g0;  // absolute position of row 0
    __syncthreads();  // the previous row group is done with qs and m_s
    for (int i = tid; i < R * p.hd; i += kThreads) {
      const int r = i / p.hd, d = i % p.hd;
      qs[r * p.ldq + d] =
          r < rows ? load_f(qb, (size_t)(row0 + r) * p.hd + d) : 0.0f;
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

    for (int t = 0; t < nk; ++t) {
      const int k0 = t * p.bk;
      // scores of the tile, C keys at a time
      for (int c0 = 0; c0 < p.bk; c0 += C) {
        const int cn = min(C, p.bk - c0);
        __syncthreads();  // kv is free, qs and m_s are written
        for (int i = tid; i < cn * p.hd; i += kThreads) {
          const int c = i / p.hd, d = i % p.hd;
          kv[c * p.ldq + d] = load_f(kb, (size_t)(k0 + c0 + c) * p.hd + d);
        }
        __syncthreads();
        float s[TI][TC];
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < p.hd; ++d) {
          float a[TI], b[TC];
#pragma unroll
          for (int i = 0; i < TI; ++i) a[i] = qs[(ty + 16 * i) * p.ldq + d];
#pragma unroll
          for (int j = 0; j < TC; ++j) b[j] = kv[(tx + 16 * j) * p.ldq + d];
#pragma unroll
          for (int i = 0; i < TI; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          const int r = ty + 16 * i, qp = row0 + r;
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const int c = tx + 16 * j, kp = k0 + c0 + c;
            if (c >= cn) continue;
            float x = s[i][j] * p.scale;
            if (p.cap != 0.0f) x = tanhf(x / p.cap) * p.cap;
            bool ok = kp < p.k_len;
            if (p.causal) ok = ok && qp >= kp;
            if (p.window) ok = ok && qp - kp < p.window;
            ss[r * p.lds + c0 + c] = ok ? x : kNegInf;
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
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mt);
        float sum = 0.0f;
        for (int c = part; c < p.bk; c += 4) {
          const float e = expf(row[c] - m_new);
          row[c] = e;
          sum += e;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
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
          const int c = i / p.dv, d = i % p.dv;
          kv[c * p.dv + d] = load_f(vb, (size_t)(k0 + c0 + c) * p.dv + d);
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
      const int r = ty + 16 * i;
      if (r >= rows) continue;
      const float l = fmaxf(l_s[r], 1e-37f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < p.dv) store_f(ob, (size_t)(row0 + r) * p.dv + d, acc[i][j] / l);
      }
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           const Params& p, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * ((size_t)R * p.ldq + (size_t)C * p.ldkv +
                       (size_t)R * p.lds);
  auto kernel = flash_attention_kernel<T, NJ>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(p.Sq / p.bq, B * p.H);
  kernel<<<grid, kThreads, bytes, stream>>>((const T*)q, (const T*)k,
                                            (const T*)v, (T*)out, p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dv(const void* q, const void* k, const void* v, void* out,
                int B, const Params& p, cudaStream_t stream) {
  if (p.dv <= 16) return launch<T, 1>(q, k, v, out, B, p, stream);
  if (p.dv <= 32) return launch<T, 2>(q, k, v, out, B, p, stream);
  if (p.dv <= 64) return launch<T, 4>(q, k, v, out, B, p, stream);
  if (p.dv <= 128) return launch<T, 8>(q, k, v, out, B, p, stream);
  return launch<T, 16>(q, k, v, out, B, p, stream);
}

}  // namespace

extern "C" {

// K6 on `stream`.  dtype 0 = float32, 1 = bfloat16 (q, k, v and out).
// Sq, Sk: padded lengths (multiples of bq, bk); k_len: real key count.
// Returns a CUDA error code (0 on success): cudaGetLastError() after the
// launch, or the error of a shape the kernel does not take.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int dtype, int B, int H, int KV, int Sq, int Sk,
                    int k_len, int hd, int dv, int bq, int bk, int causal,
                    int window, float scale, float cap, void* stream) {
  if (KV <= 0 || H % KV || hd < 1 || hd > 256 || dv < 1 || dv > 256 ||
      bq < 1 || bq > 256 || bk < 1 || bk > 256 || Sq % bq || Sk % bk ||
      B * H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  Params p{H, KV, Sq, Sk, k_len, hd, dv, bq, bk, causal, window, scale, cap,
           0, 0, 0};
  p.ldq = hd | 1;                         // odd: conflict-free columns
  p.ldkv = (hd | 1) > dv ? (hd | 1) : dv;
  p.lds = (bk + 31) / 32 * 32 + 16;       // two rows of a warp 16 banks apart
  const cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? dispatch_dv<float>(q, k, v, out, B, p, s)
                    : dispatch_dv<__nv_bfloat16>(q, k, v, out, B, p, s);
}

}  // extern "C"
