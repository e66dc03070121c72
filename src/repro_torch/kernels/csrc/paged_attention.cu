// Paged decode attention with integer-domain (LNS) QK^T: softmax partials
// of one decode query per (slot, page, KV head), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (_paged_kernel, launched from _paged_kernel_call).  It computes what
// that kernel computes, for each (slot b, block-table page j, KV head):
//
//   s[g, t] = (sum_d lns_mul(q[g, d], k[t, d])) * q_scale[b] * k_scale[pid]
//             * hd^-0.5, then softcap, then the length and window masks;
//   m[g] = max_t s,  p = exp(s - m),  l[g] = sum_t p,
//   o[g, e] = sum_t p[g, t] * decode(v[t, e]) * v_scale[pid]
//
// where lns_mul is the paper's integer-add multiply with the Table 2/3
// carry-in, decoded wide to float32.  The per-code operand fields
// (magnitude with the folded constants, packed carry mask, sign, zero and
// bad flags) come from a 256-entry table built by kernels/common.py
// (lns_tables), so one kernel serves every (format, mode) pair.  The fused
// form splices the new token's row codes into the gathered page when
// logical[b] == j and imask[b] != 0; the cache scatter happens outside.
//
// What bounds it on this card: bytes.  Per (slot, page, head) it reads one
// page of K and V codes (2 * page * hd bytes) and writes G*(dv + 2) floats
// of partials; the integer adds are a few hundred per byte read, far below
// the card's integer rate.  Design, first version: one 128-thread block per
// (slot, page, head); the G query rows' prepared fields, the page's K codes
// and its decoded V rows live in shared memory; each (g, t) score is an
// hd-sum in fixed order by one thread, so results are deterministic and
// fused == unfused holds bit for bit.  Later work: keep the partials out of
// device memory (combine in-kernel), and read only the valid pages.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lns_common.cuh"

namespace {

using lns::lns_product;

constexpr float kNegInf = -2.0e30f;  // finite: the combine needs exp(m - M) == 0
constexpr int kThreads = 128;

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
    float s = acc * qk;
    if (p.cap != 0.0f) s = tanhf(s / p.cap) * p.cap;
    const int pos = j * page + t;
    bool ok = pos < len;
    if (p.window) ok = ok && (len - 1 - pos) < p.window;
    sc[i] = ok ? s : kNegInf;
  }
  __syncthreads();

  const size_t row0 = (((size_t)b * p.maxp + j) * p.KV + kv) * G;
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
    p.m_out[row0 + g] = m;
    p.l_out[row0 + g] = l;
  }
  __syncthreads();

  for (int i = tid; i < G * dv; i += kThreads) {
    const int g = i / dv, e = i - g * dv;
    const float* pg = sc + g * page;
    float acc = 0.0f;
    for (int t = 0; t < page; ++t) acc += pg[t] * vf[t * dv + e];
    p.o_out[(row0 + g) * dv + e] = acc;
  }
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

}  // extern "C"
