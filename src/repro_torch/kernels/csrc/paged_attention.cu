// Paged decode attention: softmax partials of one decode query per (slot,
// page, KV head), for Hopper (sm_90a), in two instances: LNS QK^T off FP8
// page codes, and a float q.k off float (bf16 or float32) pages.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (_paged_kernel, launched from _paged_kernel_call), both branches of its
// _page_partial.  For each (slot b, block-table page j, KV head):
//
//   FP8 pages (lns_paged_partials_kernel):
//   s[g, t] = (sum_d lns_mul(q[g, d], k[t, d])) * q_scale[b] * k_scale[pid]
//             * hd^-0.5,   v = decode(v[t, e]) * v_scale[pid];
//   float pages (float_paged_partials_kernel<T>, T = bf16 or float):
//   s[g, t] = (sum_d q[g, d] * float(k[t, d])) * hd^-0.5,  v = float(v[t, e])
//             (no page scale is read);
//
//   then softcap, the length and window masks, and in both
//   m[g] = max_t s,  p = exp(s - m),  l[g] = sum_t p,
//   o[g, e] = sum_t p[g, t] * v[t, e].
//
// lns_mul is the paper's integer-add multiply with the Table 2/3 carry-in,
// decoded wide to float32.  The per-code operand fields (magnitude with
// the folded constants, packed carry mask, sign, zero and bad flags) come
// from a 256-entry table built by kernels/common.py (lns_tables), so one
// kernel serves every (format, mode) pair.  The fused form splices the new
// token's row (codes, or the float row in the pages' dtype) into the
// gathered page when logical[b] == j and imask[b] != 0; the cache scatter
// happens outside.
//
// What bounds it on this card: bytes.  Per (slot, page, head) it reads one
// page of K and V (2 * page * hd elements: 1 byte each as codes, 2 as
// bf16) and writes G*(dv + 2) floats of partials; the arithmetic is a few
// hundred operations per byte read at most, far below the card's rates.
// Design, first version: one 128-thread block per (slot, page, head); the
// G query rows, the page's K and its V rows (widened to float32) live in
// shared memory; each (g, t) score is an hd-sum in fixed order by one
// thread, so results are deterministic and fused == unfused holds bit for
// bit.  Later work: keep the partials out of device memory (combine
// in-kernel), and read only the valid pages.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lns_common.cuh"

namespace {

using lns::lns_product;

constexpr float kNegInf = -2.0e30f;  // finite: the combine needs exp(m - M) == 0
constexpr int kThreads = 128;

// The softcap, then the length and window masks, of one scaled score.
__device__ __forceinline__ float masked_score(float s, float cap, int pos,
                                              int len, int window) {
  if (cap != 0.0f) s = tanhf(s / cap) * cap;
  bool ok = pos < len;
  if (window) ok = ok && (len - 1 - pos) < window;
  return ok ? s : kNegInf;
}

// m, l and the un-normalised o of the G rows of scores sc [G, page]
// (overwritten with p) against the page's float V rows vf [page, dv];
// writes rows row0 .. row0 + G - 1 of the partials.  Fixed summation
// order: page rows in order, one thread per (g) and per (g, e).
__device__ __forceinline__ void softmax_pv(float* sc, const float* vf, int G,
                                           int page, int dv, size_t row0,
                                           float* m_out, float* l_out,
                                           float* o_out) {
  const int tid = threadIdx.x;
  for (int g = tid; g < G; g += kThreads) {
    float* sg = sc + g * page;
    float m = sg[0];
    for (int t = 1; t < page; ++t) {
      const float s = sg[t];
      m = (isnan(s) || s > m) ? s : m;  // NaN-propagating, like the reference
    }
    float l = 0.0f;
    for (int t = 0; t < page; ++t) {
      const float e = expf(sg[t] - m);
      sg[t] = e;
      l += e;
    }
    m_out[row0 + g] = m;
    l_out[row0 + g] = l;
  }
  __syncthreads();

  for (int i = tid; i < G * dv; i += kThreads) {
    const int g = i / dv, e = i - g * dv;
    const float* pg = sc + g * page;
    float acc = 0.0f;
    for (int t = 0; t < page; ++t) acc += pg[t] * vf[t * dv + e];
    o_out[(row0 + g) * dv + e] = acc;
  }
}

struct Params {
  const uint8_t* q_codes;       // [B, KV*G, hd]
  const float* q_scale;         // [B]
  const uint8_t* k_pages;       // [P, page, KV, hd]
  const uint8_t* v_pages;       // [P, page, KV, dv]
  const float* k_scale;         // [P]
  const float* v_scale;         // [P]
  const int32_t* block_tables;  // [B, maxp]
  const int32_t* lengths;       // [B] valid tokens (post-write)
  const uint8_t* k_rows;        // [B, KV, hd]  fused only
  const uint8_t* v_rows;        // [B, KV, dv]  fused only
  const int32_t* logical;       // [B]          fused only
  const int32_t* rows;          // [B]          fused only
  const int32_t* imask;         // [B]          fused only
  const int32_t* lut;           // [2, 256, 2]  (mag, flags) for x and y
  float* m_out;                 // [B, maxp, KV, G]
  float* l_out;                 // [B, maxp, KV, G]
  float* o_out;                 // [B, maxp, KV, G, dv]
  int maxp, page, KV, G, hd, dv;
  lns::Format fmt;
  int window, fused;
  float cap, inv_sqrt_hd;
};

__global__ void __launch_bounds__(kThreads)
lns_paged_partials_kernel(const Params p) {
  const int j = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = p.G, hd = p.hd, dv = p.dv, page = p.page;

  extern __shared__ int smem[];
  int* qmag = smem;                          // [G, hd]
  int* qflg = qmag + G * hd;                 // [G, hd]
  int* ylut = qflg + G * hd;                 // [256, 2]
  float* vf = (float*)(ylut + 512);          // [page, dv] decoded * scale
  float* sc = vf + page * dv;                // [G, page] scores, then p
  uint8_t* kc = (uint8_t*)(sc + G * page);   // [page, hd] K codes

  const int pid = p.block_tables[(size_t)b * p.maxp + j];
  const int len = p.lengths[b];
  const bool hit = p.fused && p.logical[b] == j && p.imask[b] != 0;
  const int hit_row = hit ? p.rows[b] : -1;
  const float vs = p.v_scale[pid];

  for (int i = tid; i < 512; i += kThreads) ylut[i] = p.lut[512 + i];
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    const unsigned c = p.q_codes[((size_t)b * p.KV * G + kv * G + g) * hd + d];
    qmag[i] = p.lut[2 * c];
    qflg[i] = p.lut[2 * c + 1];
  }
  for (int i = tid; i < page * hd; i += kThreads) {
    const int t = i / hd, d = i - t * hd;
    kc[i] = t == hit_row
        ? p.k_rows[((size_t)b * p.KV + kv) * hd + d]
        : p.k_pages[(((size_t)pid * page + t) * p.KV + kv) * hd + d];
  }
  for (int i = tid; i < page * dv; i += kThreads) {
    const int t = i / dv, e = i - t * dv;
    const unsigned c = t == hit_row
        ? p.v_rows[((size_t)b * p.KV + kv) * dv + e]
        : p.v_pages[(((size_t)pid * page + t) * p.KV + kv) * dv + e];
    vf[i] = lns::code_to_f32(c, p.fmt) * vs;
  }
  __syncthreads();

  const float qk = (p.q_scale[b] * p.k_scale[pid]) * p.inv_sqrt_hd;
  for (int i = tid; i < G * page; i += kThreads) {
    const int g = i / page, t = i - g * page;
    const int* xm = qmag + g * hd;
    const int* xf = qflg + g * hd;
    const uint8_t* kr = kc + t * hd;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) {
      const unsigned c = kr[d];
      acc += lns_product(xm[d], xf[d], ylut[2 * c], ylut[2 * c + 1],
                         p.fmt.man_bits);
    }
    sc[i] = masked_score(acc * qk, p.cap, j * page + t, len, p.window);
  }
  __syncthreads();
  softmax_pv(sc, vf, G, page, dv,
             (((size_t)b * p.maxp + j) * p.KV + kv) * G,
             p.m_out, p.l_out, p.o_out);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct FloatParams {
  const float* q;               // [B, KV*G, hd] float32
  const T* k_pages;             // [P, page, KV, hd]
  const T* v_pages;             // [P, page, KV, dv]
  const int32_t* block_tables;  // [B, maxp]
  const int32_t* lengths;       // [B] valid tokens (post-write)
  const T* k_rows;              // [B, KV, hd]  fused only
  const T* v_rows;              // [B, KV, dv]  fused only
  const int32_t* logical;       // [B]          fused only
  const int32_t* rows;          // [B]          fused only
  const int32_t* imask;         // [B]          fused only
  float* m_out;                 // [B, maxp, KV, G]
  float* l_out;                 // [B, maxp, KV, G]
  float* o_out;                 // [B, maxp, KV, G, dv]
  int maxp, page, KV, G, hd, dv;
  int window, fused;
  float cap, inv_sqrt_hd;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
float_paged_partials_kernel(const FloatParams<T> p) {
  const int j = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = p.G, hd = p.hd, dv = p.dv, page = p.page;
  const int ks = hd + 1;  // padded K row: the (g, t) threads of a warp
                          // read distinct banks

  extern __shared__ float fsm[];
  float* qf = fsm;                           // [G, hd]
  float* kf = qf + G * hd;                   // [page, hd + 1]
  float* vf = kf + page * ks;                // [page, dv]
  float* sc = vf + page * dv;                // [G, page] scores, then p

  const int pid = p.block_tables[(size_t)b * p.maxp + j];
  const int len = p.lengths[b];
  const bool hit = p.fused && p.logical[b] == j && p.imask[b] != 0;
  const int hit_row = hit ? p.rows[b] : -1;

  for (int i = tid; i < G * hd; i += kThreads)
    qf[i] = p.q[((size_t)b * p.KV * G + kv * G) * hd + i];
  for (int i = tid; i < page * hd; i += kThreads) {
    const int t = i / hd, d = i - t * hd;
    kf[t * ks + d] = widen(t == hit_row
        ? p.k_rows[((size_t)b * p.KV + kv) * hd + d]
        : p.k_pages[(((size_t)pid * page + t) * p.KV + kv) * hd + d]);
  }
  for (int i = tid; i < page * dv; i += kThreads) {
    const int t = i / dv, e = i - t * dv;
    vf[i] = widen(t == hit_row
        ? p.v_rows[((size_t)b * p.KV + kv) * dv + e]
        : p.v_pages[(((size_t)pid * page + t) * p.KV + kv) * dv + e]);
  }
  __syncthreads();

  for (int i = tid; i < G * page; i += kThreads) {
    const int g = i / page, t = i - g * page;
    const float* xq = qf + g * hd;
    const float* kr = kf + t * ks;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) acc += xq[d] * kr[d];
    sc[i] = masked_score(acc * p.inv_sqrt_hd, p.cap, j * page + t, len,
                         p.window);
  }
  __syncthreads();
  softmax_pv(sc, vf, G, page, dv,
             (((size_t)b * p.maxp + j) * p.KV + kv) * G,
             p.m_out, p.l_out, p.o_out);
}

template <typename T>
int launch_float(const void* q, const void* k_pages, const void* v_pages,
                 const void* block_tables, const void* lengths,
                 const void* k_rows, const void* v_rows, const void* logical,
                 const void* rows, const void* imask, void* m_out,
                 void* l_out, void* o_out, int B, int maxp, int page, int KV,
                 int G, int hd, int dv, int window, int fused, float cap,
                 float inv_sqrt_hd, size_t smem, cudaStream_t stream) {
  FloatParams<T> p;
  p.q = (const float*)q;
  p.k_pages = (const T*)k_pages;
  p.v_pages = (const T*)v_pages;
  p.block_tables = (const int32_t*)block_tables;
  p.lengths = (const int32_t*)lengths;
  p.k_rows = (const T*)k_rows;
  p.v_rows = (const T*)v_rows;
  p.logical = (const int32_t*)logical;
  p.rows = (const int32_t*)rows;
  p.imask = (const int32_t*)imask;
  p.m_out = (float*)m_out;
  p.l_out = (float*)l_out;
  p.o_out = (float*)o_out;
  p.maxp = maxp; p.page = page; p.KV = KV; p.G = G; p.hd = hd; p.dv = dv;
  p.window = window; p.fused = fused;
  p.cap = cap; p.inv_sqrt_hd = inv_sqrt_hd;
  const dim3 grid(maxp, KV, B);
  float_paged_partials_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper checks it against the limit.
int lns_paged_partials_smem(int page, int G, int hd, int dv) {
  return (2 * G * hd + 512 + page * dv + G * page) * 4 + page * hd;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int lns_paged_partials(
    const void* q_codes, const void* q_scale, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* lengths, const void* k_rows,
    const void* v_rows, const void* logical, const void* rows,
    const void* imask, const void* lut, void* m_out, void* l_out,
    void* o_out, int B, int maxp, int page, int KV, int G, int hd, int dv,
    int man_bits, int bias, int min_normal_code, int max_normal_code,
    int window, int fused, float cap, float inv_sqrt_hd, void* stream) {
  Params p;
  p.q_codes = (const uint8_t*)q_codes;
  p.q_scale = (const float*)q_scale;
  p.k_pages = (const uint8_t*)k_pages;
  p.v_pages = (const uint8_t*)v_pages;
  p.k_scale = (const float*)k_scale;
  p.v_scale = (const float*)v_scale;
  p.block_tables = (const int32_t*)block_tables;
  p.lengths = (const int32_t*)lengths;
  p.k_rows = (const uint8_t*)k_rows;
  p.v_rows = (const uint8_t*)v_rows;
  p.logical = (const int32_t*)logical;
  p.rows = (const int32_t*)rows;
  p.imask = (const int32_t*)imask;
  p.lut = (const int32_t*)lut;
  p.m_out = (float*)m_out;
  p.l_out = (float*)l_out;
  p.o_out = (float*)o_out;
  p.maxp = maxp; p.page = page; p.KV = KV; p.G = G; p.hd = hd; p.dv = dv;
  p.fmt = lns::Format{man_bits, bias, min_normal_code, max_normal_code};
  p.window = window; p.fused = fused;
  p.cap = cap; p.inv_sqrt_hd = inv_sqrt_hd;
  const dim3 grid(maxp, KV, B);
  const size_t smem = lns_paged_partials_smem(page, G, hd, dv);
  lns_paged_partials_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Shared memory one block of the float instance needs.
int float_paged_partials_smem(int page, int G, int hd, int dv) {
  return (G * hd + page * (hd + 1) + page * dv + G * page) * 4;
}

// The float-page instance: pages of bf16 (bf16_pages != 0) or float32,
// a float32 q.  Launch on `stream`; returns cudaGetLastError().
int float_paged_partials(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, const void* k_rows,
    const void* v_rows, const void* logical, const void* rows,
    const void* imask, void* m_out, void* l_out, void* o_out, int B,
    int maxp, int page, int KV, int G, int hd, int dv, int window, int fused,
    int bf16_pages, float cap, float inv_sqrt_hd, void* stream) {
  const size_t smem = float_paged_partials_smem(page, G, hd, dv);
  if (bf16_pages)
    return launch_float<__nv_bfloat16>(
        q, k_pages, v_pages, block_tables, lengths, k_rows, v_rows, logical,
        rows, imask, m_out, l_out, o_out, B, maxp, page, KV, G, hd, dv,
        window, fused, cap, inv_sqrt_hd, smem, (cudaStream_t)stream);
  return launch_float<float>(
      q, k_pages, v_pages, block_tables, lengths, k_rows, v_rows, logical,
      rows, imask, m_out, l_out, o_out, B, maxp, page, KV, G, hd, dv, window,
      fused, cap, inv_sqrt_hd, smem, (cudaStream_t)stream);
}

}  // extern "C"
