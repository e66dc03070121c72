// Paged decode attention for Hopper (sm_90a): one decode query per (slot,
// KV head) against its paged cache, softmax and the combine over pages on
// the chip, in one launch per call.  Two instances: LNS QK^T off FP8 page
// codes, and a float q.k off float (bf16 or float32) pages.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (_paged_kernel, launched from _paged_kernel_call), both branches of its
// _page_partial, together with the log-sum-exp combine the JAX package
// runs after it (_combine_partials): the per-page partials never leave the
// chip.  For each page j of slot b and KV head kv:
//
//   FP8 pages (lns_paged_partials_kernel):
//   s[g, t] = (sum_d lns_mul(q[g, d], k[t, d])) * q_scale[b] * k_scale[pid]
//             * hd^-0.5,   v = decode(v[t, e]) * v_scale[pid];
//   float pages (float_paged_partials_kernel<T>, T = bf16 or float):
//   s[g, t] = (sum_d q[g, d] * float(k[t, d])) * hd^-0.5,  v = float(v[t, e])
//             (no page scale is read);
//
//   then softcap, the length and window masks, the page's partials
//   m = max_t s, p = exp(s - m), l = sum_t p, o = sum_t p v, and
//   out = sum_j w_j o_j / max(sum_j w_j l_j, 1e-37), w_j = exp(m_j - max m).
//
// lns_mul is the paper's integer-add multiply with the Table 2/3 carry-in,
// decoded wide to float32; the per-code operand fields come from the
// 256-entry table of kernels/common.py (lns_tables), so one kernel serves
// every (format, mode) pair.  The fused form splices the new token's row
// (codes, or the float row in the pages' dtype) into page logical[b] when
// imask[b] != 0; the cache scatter happens outside.
//
// Admissible pages (kernels/paged_attention.py::admissible_pages mirrors
// page_range below): only pages first..last hold a position the masks
// admit, last = (len - 1) / page, first = max(0, len - window) / page with
// a window, else 0.  Every other page has every score at the finite
// NEG_INF, so its weight in the combine is exactly 0 and it is not read.
// A slot with no admissible position (len 0) reads its whole block table
// with every position masked: each page then has m = NEG_INF and weight 1,
// and the output is the mean of all maxp * page V rows, as the reference's.
//
// What bounds it on this card: bytes.  It must read the query, the K and V
// rows of the admissible pages (1 byte per element as codes, 2 as bf16),
// their scales and the block tables, and write [B, KV*G, dv] float32; its
// 2 KV G tokens (hd + dv) operations come to fewer per byte read than the
// card's float32 rate over its memory rate, so the floor is those bytes
// over the memory rate.
//
// Design: one thread-block cluster of C = min(8, maxp) blocks per (slot,
// KV head), grid (C, KV, B), each block of up to four groups of 128
// threads (as many as fit the shared memory).  The n admissible pages are
// cut into V = C x groups contiguous shares, group v of the cluster taking
// first + v n / V .. first + (v + 1) n / V - 1, so a block's groups hold
// consecutive shares and one SM keeps several pages in flight.  A group
// walks its share in page order: the next page's K and V rows arrive by
// cp.async into a second buffer while this one is scored straight from its
// raw rows (a thread takes the d = part, part + S, ... of one row t for
// eight query rows at once, so each K element is decoded once; the S
// lanes of a row add up by shuffles in a fixed tree) and folded into a
// running (m, l, o) by the online softmax, P.V likewise reading each V
// element once for four query rows.  The LNS product runs in an add-only
// form (add_form below), equal to kernels/common.py::lns_combine value
// for value.  Two blocks fit an SM (64 registers a thread), so every
// cluster of the grid is resident at once.  Then each block combines
// its groups in group order and stores the result into rank 0's shared
// memory (distributed shared memory); after one cluster barrier rank 0
// combines the blocks in rank order and writes the output.  A share with
// no page contributes nothing.  No atomics and no device workspace: the
// order of every sum is fixed by the geometry and the lengths, so two
// calls on the same inputs agree bit for bit and fused == unfused holds.
// Left for later: fusing the FP8 row encode (token_row_codes) and the page
// scatter into this launch.
//
// Partials mode (m_out non-null; kernels/paged_attention.py::
// paged_attention_partials): rank 0 stops before the divide and writes the
// combined, un-normalised state of its (slot, KV head), M and l [B, KV, G]
// into m_out and l_out and o into out, for a combine across shards of the
// pages (combine_partials_psum).  The combine itself is unchanged, so the
// default output is bitwise what it was.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lns_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -2.0e30f;  // finite, as the reference's NEG_INF
constexpr int kGroupThreads = 128;   // one group walks one share of pages
constexpr int kMaxGroups = 4;        // groups in one block
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kRowBlock = 8;         // query rows a score thread sums
constexpr int kPvBlock = 4;          // query rows a P.V thread sums
constexpr int kRowPad = 16;          // bytes after each page row in shared
                                     // memory: rows start in other banks
constexpr int kSmemLimit = 232448;   // dynamic shared memory of one block
constexpr unsigned kFull = 0xffffffffu;

// The softcap, then the length and window masks, of one scaled score.
__device__ __forceinline__ float masked_score(float s, float cap, int pos,
                                              int len, int window) {
  if (cap != 0.0f) s = tanhf(s / cap) * cap;
  bool ok = pos < len;
  if (window) ok = ok && (len - 1 - pos) < window;
  return ok ? s : kNegInf;
}

// max that propagates NaN, like the reference's
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// The block-table pages that hold an admissible position (see the top).
__device__ __forceinline__ void page_range(int len, int window, int page,
                                           int maxp, int* first, int* last) {
  int lo = 0, hi = -1;
  if (len > 0) {
    hi = min((len - 1) / page, maxp - 1);
    lo = window ? max(0, len - window) / page : 0;
  }
  if (lo > hi) {  // no admissible position: every page, every row masked
    lo = 0;
    hi = maxp - 1;
  }
  *first = lo;
  *last = hi;
}

// The barrier of one group's 128 threads (barrier 0 is the block's).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(kGroupThreads)
               : "memory");
}

// Asynchronous global -> shared copies of N bytes (N = 4, 8 or 16; both
// addresses N-aligned).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One page's rows of one KV head, [page, row_bytes], into dst (rows
// kRowPad bytes apart) by a group's threads; row hit_row (if any) comes
// from hit_src instead (the fused form's new row).
template <int N>
__device__ __forceinline__ void copy_rows_n(uint8_t* dst, const uint8_t* pages,
                                            const uint8_t* hit_src, int pid,
                                            int page, int KV, int kv,
                                            int row_bytes, int hit_row,
                                            int gtid) {
  const int per_row = row_bytes / N;
  for (int i = gtid; i < page * per_row; i += kGroupThreads) {
    const int t = i / per_row, c = (i - t * per_row) * N;
    const uint8_t* src =
        t == hit_row ? hit_src
                     : pages + (((size_t)pid * page + t) * KV + kv) * row_bytes;
    uint8_t* row = dst + t * (row_bytes + kRowPad);
    if constexpr (N == 1)
      row[c] = src[c];
    else
      cp_async<N>(row + c, src + c);
  }
}

__device__ __forceinline__ void copy_rows(int vec, uint8_t* dst,
                                          const uint8_t* pages,
                                          const uint8_t* hit_src, int pid,
                                          int page, int KV, int kv,
                                          int row_bytes, int hit_row,
                                          int gtid) {
  if (vec == 16)
    copy_rows_n<16>(dst, pages, hit_src, pid, page, KV, kv, row_bytes,
                    hit_row, gtid);
  else if (vec == 8)
    copy_rows_n<8>(dst, pages, hit_src, pid, page, KV, kv, row_bytes,
                   hit_row, gtid);
  else if (vec == 4)
    copy_rows_n<4>(dst, pages, hit_src, pid, page, KV, kv, row_bytes,
                   hit_row, gtid);
  else
    copy_rows_n<1>(dst, pages, hit_src, pid, page, KV, kv, row_bytes,
                   hit_row, gtid);
}

// The widest copy (16, 8, 4 or 1 bytes) that divides both row lengths and
// every base address.
int copy_width(int k_row_bytes, int v_row_bytes, const void* const* bases,
               int n_bases) {
  for (int vec = 16; vec > 1; vec /= 2) {
    bool ok = k_row_bytes % vec == 0 && v_row_bytes % vec == 0;
    for (int i = 0; i < n_bases; ++i)
      ok = ok && (bases[i] == nullptr || (uintptr_t)bases[i] % vec == 0);
    if (ok) return vec;
  }
  return 1;
}

// What both instances share.
struct Common {
  const int32_t* block_tables;  // [B, maxp]
  const int32_t* lengths;       // [B] valid tokens (post-write)
  const int32_t* logical;       // [B]          fused only
  const int32_t* rows;          // [B]          fused only
  const int32_t* imask;         // [B]          fused only
  float* out;                   // [B, KV*G, dv]
  float* m_out;                 // [B, KV, G]   partials mode only
  float* l_out;                 // [B, KV, G]   partials mode only
  int maxp, page, KV, G, hd, dv;
  int window, fused, vec;
  float cap, inv_sqrt_hd;
};

__host__ __device__ __forceinline__ size_t up16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// G rounded up to whole row blocks (the query operands' padding rows are
// zeros, so the unrolled sums need no guard)
__host__ __device__ __forceinline__ int padded_rows(int G) {
  return (G + kRowBlock - 1) / kRowBlock * kRowBlock;
}

__host__ __device__ __forceinline__ int cluster_size(int maxp) {
  return maxp < kMaxCluster ? maxp : kMaxCluster;
}

// Byte offsets into one block's dynamic shared memory: what the block
// shares, then one region per group (offsets inside it).
struct Layout {
  size_t prep, slots, scratch, pages, group, group_stride;
  size_t raw, sc, orun, stats, raw_stride, total;
};

// el: bytes of a page element; prep: bytes of the instance's query operand
// (and tables).
__host__ __device__ __forceinline__ Layout layout(int el, size_t prep,
                                                  int page, int G, int hd,
                                                  int dv, int maxp,
                                                  int groups) {
  const int C = cluster_size(maxp);
  const size_t share = (size_t)(maxp + C - 1) / C;  // most pages of a block
  Layout L;
  size_t o = 0;
  L.prep = o;     o += up16(prep);
  L.slots = o;    // rank 0: each block's m, l [G] and o [G, dv]; its flag
  o += up16(((size_t)kMaxCluster * (2 * G + G * dv) + kMaxCluster) * 4);
  L.scratch = o;  // weights [kMaxCluster, G], m and l [G], group flags
  o += up16(((size_t)(kMaxCluster + 2) * G + kMaxGroups) * 4);
  L.pages = o;    o += up16(share * 3 * 4);  // the block's page ids, scales
  L.group = o;
  size_t g = 0;
  L.raw_stride = up16((size_t)page * ((hd + dv) * el + 2 * kRowPad));
  L.raw = g;    g += 2 * L.raw_stride;                   // two pages' K, V
  L.sc = g;     g += up16((size_t)G * page * 4);         // scores, then p
  L.orun = g;   g += up16((size_t)G * dv * 4);           // running o
  L.stats = g;  g += up16((size_t)4 * G * 4);  // m, l, alpha, beta
  L.group_stride = g;
  L.total = o + (size_t)groups * g;
  return L;
}

// ---- the LNS instance: FP8 codes, one scale per page --------------------
struct LnsParams {
  Common c;
  const uint8_t* q_codes;  // [B, KV*G, hd]
  const float* q_scale;    // [B]
  const uint8_t* k_pages;  // [P, page, KV, hd]
  const uint8_t* v_pages;  // [P, page, KV, dv]
  const float* k_scale;    // [P]
  const float* v_scale;    // [P]
  const uint8_t* k_rows;   // [B, KV, hd]  fused only
  const uint8_t* v_rows;   // [B, KV, dv]  fused only
  const int32_t* lut;      // [2, 256, 2]  (mag, flags) for x and y
  lns::Format fmt;
};

// The paper's product in an add-only form: an operand's fields (mag,
// flags) from lns_tables become {m, c, z}: m = sign << 31 + mag << (23 -
// man_bits) (two's complement), c its carry mask, z = 1, or 0 for a zero
// code and NaN for a NaN/inf code, whose m and c are 0.  Then
// lns_combine(x, y) == as_float(m_x + m_y + carry << (23 - man_bits)) * z_x
// * z_y, value for value (a zero product may come out as -0, which leaves
// every sum unchanged), with one integer add for the magnitudes and signs.
__device__ __forceinline__ int4 add_form(int mag, int flags, int man_bits) {
  if (flags & (lns::kZeroBit | lns::kBadBit))
    return make_int4(0, 0,
                     (flags & lns::kBadBit) ? 0x7fc00000
                                            : __float_as_int(0.0f), 0);
  return make_int4((int)(((unsigned)flags & lns::kSignBit) +
                         ((unsigned)mag << (23 - man_bits))),
                   flags & lns::kCarryMask, __float_as_int(1.0f), 0);
}

struct LnsInst {
  using Params = LnsParams;
  using KOp = int4;  // the add form of a K code
  static constexpr int kEl = 1;
  // the y-side add forms [256], then q's [padded rows, hd]
  __host__ __device__ static size_t prep_bytes(int G, int hd) {
    return 256 * 16 + (size_t)padded_rows(G) * hd * 16;
  }
  __device__ static void prepare(const Params& p, int b, int kv,
                                 uint8_t* prep, int tid, int nthreads) {
    int4* ytab = (int4*)prep;
    int4* qop = ytab + 256;
    const int G = p.c.G, hd = p.c.hd, mb = p.fmt.man_bits;
    for (int i = tid; i < 256; i += nthreads)
      ytab[i] = add_form(p.lut[512 + 2 * i], p.lut[512 + 2 * i + 1], mb);
    const uint8_t* q = p.q_codes + ((size_t)b * p.c.KV + kv) * G * hd;
    for (int i = tid; i < padded_rows(G) * hd; i += nthreads) {
      if (i < G * hd) {
        const unsigned c = q[i];
        qop[i] = add_form(p.lut[2 * c], p.lut[2 * c + 1], mb);
      } else {
        qop[i] = make_int4(0, 0, 0, 0);  // a padding row: products 0
      }
    }
  }
  // the query's scale, and the K and V scales of page pid
  __device__ static float q_scale(const Params& p, int b) {
    return p.q_scale[b];
  }
  __device__ static float k_scale(const Params& p, int pid) {
    return p.k_scale[pid];
  }
  __device__ static float v_scale(const Params& p, int pid) {
    return p.v_scale[pid];
  }
  // element d of a raw K row as an operand, element e of a raw V row as
  // float
  __device__ static KOp k_op(const uint8_t* prep, const uint8_t* krow,
                             int d) {
    return ((const int4*)prep)[krow[d]];
  }
  __device__ static float v_val(const Params& p, const uint8_t* vrow, int e,
                                float vs) {
    return lns::code_to_f32(vrow[e], p.fmt) * vs;
  }
  // acc + q[g, d] y, the paper's product
  __device__ static float fma(const Params& p, const uint8_t* prep, int g,
                              int d, KOp y, float acc) {
    const int4 x = ((const int4*)prep)[256 + g * p.c.hd + d];
    const int carry = (x.y & y.y) ? 1 << (23 - p.fmt.man_bits) : 0;
    return fmaf(__int_as_float(x.x + y.x + carry),
                __int_as_float(x.z) * __int_as_float(y.z), acc);
  }
};

// ---- the float instance: bf16 or float32 pages, a float32 q -------------
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct FloatParams {
  Common c;
  const float* q;      // [B, KV*G, hd] float32
  const T* k_pages;    // [P, page, KV, hd]
  const T* v_pages;    // [P, page, KV, dv]
  const T* k_rows;     // [B, KV, hd]  fused only
  const T* v_rows;     // [B, KV, dv]  fused only
};

template <typename T>
struct FloatInst {
  using Params = FloatParams<T>;
  using KOp = float;
  static constexpr int kEl = sizeof(T);
  // q [padded rows, hd]
  __host__ __device__ static size_t prep_bytes(int G, int hd) {
    return (size_t)padded_rows(G) * hd * 4;
  }
  __device__ static void prepare(const Params& p, int b, int kv,
                                 uint8_t* prep, int tid, int nthreads) {
    float* qf = (float*)prep;
    const int n = p.c.G * p.c.hd;
    const float* q = p.q + ((size_t)b * p.c.KV + kv) * n;
    for (int i = tid; i < padded_rows(p.c.G) * p.c.hd; i += nthreads)
      qf[i] = i < n ? q[i] : 0.0f;  // a padding row: products 0
  }
  // float pages have no scales: 1 stands for each (never read)
  __device__ static float q_scale(const Params&, int) { return 1.0f; }
  __device__ static float k_scale(const Params&, int) { return 1.0f; }
  __device__ static float v_scale(const Params&, int) { return 1.0f; }
  __device__ static KOp k_op(const uint8_t*, const uint8_t* krow, int d) {
    return widen(((const T*)krow)[d]);
  }
  __device__ static float v_val(const Params&, const uint8_t* vrow, int e,
                                float) {
    return widen(((const T*)vrow)[e]);
  }
  __device__ static float fma(const Params& p, const uint8_t* prep, int g,
                              int d, KOp y, float acc) {
    return fmaf(((const float*)prep)[g * p.c.hd + d], y, acc);
  }
};

// n softmax states (m, l, o) to combine in order: state i has m[i *
// mstride + g], l[i * mstride + g] and o[i * ostride + g * dv + e]; a state
// with flags[i] == 0 read no page and is left out.
struct States {
  const float* m; const float* l; const float* o;
  int mstride, ostride;
  const int* flags;
  int n;
};

// The combined m and l of each row g (threads g < G) and the weights
// w[i, g] = exp(m_i - m) of the states, as the reference's combine; N
// bounds st.n, so every state's load is in flight at once.
template <int N>
__device__ __forceinline__ void combine_weights(const States& st, int G,
                                                float* w, float* m_out,
                                                float* l_out, int tid,
                                                int nthreads) {
  for (int g = tid; g < G; g += nthreads) {
    float mi[N], li[N];
    bool fi[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      fi[i] = i < st.n && st.flags[i];
      mi[i] = fi[i] ? st.m[i * st.mstride + g] : 0.0f;
      li[i] = fi[i] ? st.l[i * st.mstride + g] : 0.0f;
    }
    float M = 0.0f;
    bool any = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!fi[i]) continue;
      M = any ? nan_max(M, mi[i]) : mi[i];
      any = true;
    }
    float lt = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float wi = 0.0f;
      if (fi[i]) {
        wi = expf(mi[i] - M);
        lt += wi * li[i];
      }
      if (i < st.n) w[i * G + g] = wi;
    }
    m_out[g] = M;
    l_out[g] = lt;
  }
}

// Element i (row g) of the combined, unnormalised o; after the weights.
template <int N>
__device__ __forceinline__ float combine_o(const States& st, const float* w,
                                           int G, int g, int i) {
  float oi[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    oi[k] = k < st.n && st.flags[k] ? st.o[k * st.ostride + i] : 0.0f;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < st.n && st.flags[k]) acc += w[k * G + g] * oi[k];
  return acc;
}

__host__ __device__ __forceinline__ int pow2_at_most(int x, int cap) {
  int r = 1;
  while (r * 2 <= x && r * 2 <= cap) r *= 2;
  return r;
}

template <class I>
__device__ __forceinline__ void paged_attend(const typename I::Params& ip,
                                             const uint8_t* k_pages,
                                             const uint8_t* v_pages,
                                             const uint8_t* k_rows,
                                             const uint8_t* v_rows) {
  using KOp = typename I::KOp;
  const Common& p = ip.c;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;  // the cluster spans x: grid (C, KV, B)
  const int rank = (int)cluster.block_rank();
  const int kv = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nthreads = blockDim.x, groups = nthreads / kGroupThreads;
  const int grp = tid / kGroupThreads, gtid = tid - grp * kGroupThreads;
  const int lane = tid & 31, gwarp = gtid >> 5;
  const int G = p.G, hd = p.hd, dv = p.dv, page = p.page, KV = p.KV;
  const int el = I::kEl;

  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout(el, I::prep_bytes(G, hd), page, G, hd, dv, p.maxp,
                          groups);
  uint8_t* prep = smem + L.prep;
  float* slots = (float*)(smem + L.slots);  // rank 0: [C, 2G + G dv]
  const int slot_len = 2 * G + G * dv;
  int* slot_flag = (int*)(slots + kMaxCluster * slot_len);
  float* w = (float*)(smem + L.scratch);    // [kMaxCluster, G]
  float* msum = w + kMaxCluster * G;        // [G]
  float* lsum = msum + G;                   // [G]
  int* gflag = (int*)(lsum + G);            // [kMaxGroups] read a page
  int* spid = (int*)(smem + L.pages);       // the block's page ids
  const int share_max = (p.maxp + C - 1) / C;
  float* sks = (float*)(spid + share_max);  // their K scales
  float* svs = sks + share_max;             // their V scales
  uint8_t* gb = smem + L.group + grp * L.group_stride;
  uint8_t* raw = gb + L.raw;
  float* sc = (float*)(gb + L.sc);
  float* o_run = (float*)(gb + L.orun);
  float* m_run = (float*)(gb + L.stats);
  float* l_run = m_run + G;
  float* alpha = l_run + G;
  float* beta = alpha + G;

  const int len = p.lengths[b];
  int first, last;
  page_range(len, p.window, page, p.maxp, &first, &last);
  const int n = last - first + 1, V = C * groups, v = rank * groups + grp;
  const int blo = first + rank * n / C, bhi = first + (rank + 1) * n / C;
  const int lo = first + v * n / V, hi = first + (v + 1) * n / V;
  const bool ins = p.fused && p.imask[b] != 0;
  const int hit_page = ins ? p.logical[b] : -1;
  const int hit_row = ins ? p.rows[b] : -1;
  const int k_bytes = hd * el, v_bytes = dv * el;
  const int k_stride = k_bytes + kRowPad, v_stride = v_bytes + kRowPad;
  const uint8_t* k_hit =
      ins ? k_rows + ((size_t)b * KV + kv) * k_bytes : nullptr;
  const uint8_t* v_hit =
      ins ? v_rows + ((size_t)b * KV + kv) * v_bytes : nullptr;
  const int32_t* bt = p.block_tables + (size_t)b * p.maxp;

  auto issue = [&](int j, int slot, int pid) {
    uint8_t* rk = raw + slot * L.raw_stride;
    const int hr = j == hit_page ? hit_row : -1;
    copy_rows(p.vec, rk, k_pages, k_hit, pid, page, KV, kv, k_bytes, hr,
              gtid);
    copy_rows(p.vec, rk + (size_t)page * k_stride, v_pages, v_hit, pid,
              page, KV, kv, v_bytes, hr, gtid);
    cp_async_commit();
  };

  // in flight together: the query's operands (all warps but the last),
  // the block's page ids and scales (the last warp), each group's first
  // page
  const int helpers = nthreads - 32;
  if (tid >= helpers) {
    for (int k = tid - helpers; k < bhi - blo; k += 32) {
      const int pid = bt[blo + k];
      spid[k] = pid;
      sks[k] = I::k_scale(ip, pid);
      svs[k] = I::v_scale(ip, pid);
    }
  } else {
    I::prepare(ip, b, kv, prep, tid, helpers);
  }
  if (lo < hi) issue(lo, 0, bt[lo]);
  for (int i = gtid; i < G * dv; i += kGroupThreads) o_run[i] = 0.0f;
  for (int g = gtid; g < G; g += kGroupThreads) {
    m_run[g] = kNegInf;
    l_run[g] = 0.0f;
  }
  const float q_s = I::q_scale(ip, b);
  __syncthreads();

  // scores: thread (t, part) sums its d = part, part + S, ... for
  // kRowBlock query rows at once, then the S lanes of a row t add up in a
  // fixed tree
  const int S = pow2_at_most(kGroupThreads / page, 32);
  const int s_rounds = (page * S + kGroupThreads - 1) / kGroupThreads;
  // softmax: LG lanes per query row
  const int LG = page <= 32 && (page & (page - 1)) == 0 ? page : 32;
  const int rows_per_warp = 32 / LG, sub = lane / LG, sl = lane - sub * LG;
  // P.V: thread (gp, e) sums rows g = gp, gp + GP, ... for column e
  const int GP = dv < kGroupThreads ? kGroupThreads / dv : 1;
  const int o_rounds = (GP * dv + kGroupThreads - 1) / kGroupThreads;

  for (int j = lo; j < hi; ++j) {
    const int slot = (j - lo) & 1;
    if (j + 1 < hi) {
      issue(j + 1, slot ^ 1, spid[j + 1 - blo]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_sync(grp);
    const uint8_t* rk = raw + slot * L.raw_stride;
    const uint8_t* rv = rk + (size_t)page * k_stride;

    const float scale = (q_s * sks[j - blo]) * p.inv_sqrt_hd;
    for (int r = 0; r < s_rounds; ++r) {
      const int i = r * kGroupThreads + gtid;
      const int t = i / S, part = i - t * S;
      const uint8_t* krow = rk + t * k_stride;
      for (int g0 = 0; g0 < G; g0 += kRowBlock) {
        float acc[kRowBlock];
#pragma unroll
        for (int k = 0; k < kRowBlock; ++k) acc[k] = 0.0f;
        if (t < page) {
          for (int d = part; d < hd; d += S) {
            const KOp y = I::k_op(prep, krow, d);
#pragma unroll
            for (int k = 0; k < kRowBlock; ++k)
              acc[k] = I::fma(ip, prep, g0 + k, d, y, acc[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kRowBlock; ++k)
          for (int off = S >> 1; off; off >>= 1)
            acc[k] += __shfl_xor_sync(kFull, acc[k], off);
        if (t < page && part == 0) {
#pragma unroll
          for (int k = 0; k < kRowBlock; ++k)
            if (g0 + k < G)
              sc[(g0 + k) * page + t] = masked_score(
                  acc[k] * scale, p.cap, j * page + t, len, p.window);
        }
      }
    }
    group_sync(grp);

    // the page's m and l per row, folded into the running state; sc
    // becomes p = exp(s - m)
    for (int g_base = gwarp * rows_per_warp; g_base < G;
         g_base += (kGroupThreads / 32) * rows_per_warp) {
      const int g = g_base + sub;
      const bool row = g < G;
      float* sg = sc + g * page;
      float m = __int_as_float(0xff800000);  // -inf
      if (row)
        for (int t = sl; t < page; t += LG) m = nan_max(m, sg[t]);
      for (int off = LG >> 1; off; off >>= 1)
        m = nan_max(m, __shfl_xor_sync(kFull, m, off));
      float l = 0.0f;
      if (row)
        for (int t = sl; t < page; t += LG) {
          const float e = expf(sg[t] - m);
          sg[t] = e;
          l += e;
        }
      for (int off = LG >> 1; off; off >>= 1)
        l += __shfl_xor_sync(kFull, l, off);
      if (row && sl == 0) {
        float mn = m, a = 0.0f;  // the share's first page: nothing to scale
        if (j > lo) {
          mn = nan_max(m_run[g], m);
          a = expf(m_run[g] - mn);
        }
        const float bw = expf(m - mn);
        l_run[g] = a * l_run[g] + bw * l;
        m_run[g] = mn;
        alpha[g] = a;
        beta[g] = bw;
      }
    }
    group_sync(grp);

    const float vs = svs[j - blo];
    for (int r = 0; r < o_rounds; ++r) {
      const int i = r * kGroupThreads + gtid;
      const int gp = i / dv, e = i - gp * dv;
      if (gp < GP) {
        for (int g0 = gp; g0 < G; g0 += GP * kPvBlock) {
          float acc[kPvBlock];
          const float* pr[kPvBlock];  // rows past G read row G - 1, unused
#pragma unroll
          for (int k = 0; k < kPvBlock; ++k) {
            acc[k] = 0.0f;
            pr[k] = sc + min(g0 + k * GP, G - 1) * page;
          }
          for (int t = 0; t < page; ++t) {
            const float x = I::v_val(ip, rv + t * v_stride, e, vs);
#pragma unroll
            for (int k = 0; k < kPvBlock; ++k) acc[k] += pr[k][t] * x;
          }
#pragma unroll
          for (int k = 0; k < kPvBlock; ++k) {
            const int g = g0 + k * GP;
            if (g < G)
              o_run[g * dv + e] =
                  alpha[g] * o_run[g * dv + e] + beta[g] * acc[k];
          }
        }
      }
    }
    group_sync(grp);
  }
  if (gtid == 0) gflag[grp] = lo < hi;
  __syncthreads();

  // the block's groups, in group order, into rank 0's slot [rank]
  const float* m0 = (const float*)(smem + L.group + L.stats);
  const States gst{m0, m0 + G, (const float*)(smem + L.group + L.orun),
                   (int)(L.group_stride / 4), (int)(L.group_stride / 4),
                   gflag, groups};
  float* dst = cluster.map_shared_rank(slots, 0) + rank * slot_len;
  combine_weights<kMaxGroups>(gst, G, w, dst, dst + G, tid, nthreads);
  if (tid == 0) {
    int any = 0;
    for (int k = 0; k < groups; ++k) any |= gflag[k];
    *cluster.map_shared_rank(slot_flag + rank, 0) = any;
  }
  __syncthreads();
  for (int i = tid; i < G * dv; i += nthreads)
    dst[2 * G + i] = combine_o<kMaxGroups>(gst, w, G, i / dv, i);
  cluster.sync();
  if (rank != 0) return;  // rank 0 reads only its own shared memory now

  // the blocks, in rank order, into the output
  const States cst{slots, slots + G, slots + 2 * G, slot_len, slot_len,
                   slot_flag, C};
  combine_weights<kMaxCluster>(cst, G, w, msum, lsum, tid, nthreads);
  __syncthreads();
  float* out = p.out + ((size_t)b * KV + kv) * G * dv;
  if (p.m_out != nullptr) {  // partials mode: the state, un-normalised
    const size_t row = ((size_t)b * KV + kv) * G;
    for (int g = tid; g < G; g += nthreads) {
      p.m_out[row + g] = msum[g];
      p.l_out[row + g] = lsum[g];
    }
    for (int i = tid; i < G * dv; i += nthreads)
      out[i] = combine_o<kMaxCluster>(cst, w, G, i / dv, i);
    return;
  }
  for (int i = tid; i < G * dv; i += nthreads) {
    const int g = i / dv;
    const float lt = lsum[g];
    out[i] = combine_o<kMaxCluster>(cst, w, G, g, i) /
             (isnan(lt) ? lt : fmaxf(lt, 1e-37f));
  }
}

// Two blocks an SM (64 registers a thread): with one, a 14-SM GPC holds one
// cluster of 8 and the card only 15, so 16 clusters ran in two waves.
__global__ void __launch_bounds__(kMaxGroups * kGroupThreads, 2)
lns_paged_partials_kernel(const LnsParams p) {
  paged_attend<LnsInst>(p, p.k_pages, p.v_pages, p.k_rows, p.v_rows);
}

template <typename T>
__global__ void __launch_bounds__(kMaxGroups * kGroupThreads, 2)
float_paged_partials_kernel(const FloatParams<T> p) {
  paged_attend<FloatInst<T>>(
      p, (const uint8_t*)p.k_pages, (const uint8_t*)p.v_pages,
      (const uint8_t*)p.k_rows, (const uint8_t*)p.v_rows);
}

// Groups per block: the most (4, 2 or 1) whose shared memory fits.
template <class I>
int groups_that_fit(const Common& c, size_t* smem) {
  int groups = kMaxGroups;
  for (;; groups /= 2) {
    *smem = layout(I::kEl, I::prep_bytes(c.G, c.hd), c.page, c.G, c.hd,
                   c.dv, c.maxp, groups).total;
    if (groups == 1 || *smem <= (size_t)kSmemLimit) return groups;
  }
}

// One cluster of min(8, maxp) blocks per (slot, KV head); returns the
// launch's error code (0 on success).
template <class I>
int launch_cluster(void (*kernel)(typename I::Params),
                   const typename I::Params& p, int B, cudaStream_t stream) {
  size_t smem;
  const int groups = groups_that_fit<I>(p.c, &smem);
  static size_t opted = 48 * 1024;  // the default limit
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    opted = kSmemLimit;
  }
  const int C = cluster_size(p.c.maxp);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, p.c.KV, B);
  cfg.blockDim = dim3(groups * kGroupThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the wrapper raises on the code
    return (int)e;
  }
  return (int)cudaGetLastError();
}

Common common(const void* block_tables, const void* lengths,
              const void* logical, const void* rows, const void* imask,
              void* out, void* m_out, void* l_out, int maxp, int page,
              int KV, int G, int hd, int dv, int window, int fused,
              float cap, float inv_sqrt_hd) {
  Common c;
  c.block_tables = (const int32_t*)block_tables;
  c.lengths = (const int32_t*)lengths;
  c.logical = (const int32_t*)logical;
  c.rows = (const int32_t*)rows;
  c.imask = (const int32_t*)imask;
  c.out = (float*)out;
  c.m_out = (float*)m_out;
  c.l_out = (float*)l_out;
  c.maxp = maxp; c.page = page; c.KV = KV; c.G = G; c.hd = hd; c.dv = dv;
  c.window = window; c.fused = fused; c.vec = 1;
  c.cap = cap; c.inv_sqrt_hd = inv_sqrt_hd;
  return c;
}

template <typename T>
int launch_float(const void* q, const void* k_pages, const void* v_pages,
                 const void* k_rows, const void* v_rows, const Common& c,
                 int B, cudaStream_t stream) {
  FloatParams<T> p;
  p.c = c;
  p.q = (const float*)q;
  p.k_pages = (const T*)k_pages;
  p.v_pages = (const T*)v_pages;
  p.k_rows = (const T*)k_rows;
  p.v_rows = (const T*)v_rows;
  const void* bases[4] = {k_pages, v_pages, k_rows, v_rows};
  p.c.vec = copy_width(c.hd * (int)sizeof(T), c.dv * (int)sizeof(T), bases,
                       4);
  return launch_cluster<FloatInst<T>>(float_paged_partials_kernel<T>, p, B,
                                      stream);
}

}  // namespace

extern "C" {

// Shared memory one block of one group needs; the wrapper checks it
// against the limit (the launch takes up to four groups where they fit).
int lns_paged_partials_smem(int page, int G, int hd, int dv, int maxp) {
  return (int)layout(1, LnsInst::prep_bytes(G, hd), page, G, hd, dv, maxp, 1)
      .total;
}

// Launch on `stream`; returns the launch's CUDA error code (0 on success).
// out: [B, KV*G, dv] float32, the attention of each query row; with m_out
// and l_out ([B, KV, G] float32, both null or both not) the partials mode:
// out the un-normalised o, m_out and l_out the state's M and l.
int lns_paged_partials(
    const void* q_codes, const void* q_scale, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* lengths, const void* k_rows,
    const void* v_rows, const void* logical, const void* rows,
    const void* imask, const void* lut, void* out, void* m_out, void* l_out,
    int B, int maxp, int page, int KV, int G, int hd, int dv, int man_bits,
    int bias, int min_normal_code, int max_normal_code, int window,
    int fused, float cap, float inv_sqrt_hd, void* stream) {
  LnsParams p;
  p.c = common(block_tables, lengths, logical, rows, imask, out, m_out,
               l_out, maxp, page, KV, G, hd, dv, window, fused, cap,
               inv_sqrt_hd);
  p.q_codes = (const uint8_t*)q_codes;
  p.q_scale = (const float*)q_scale;
  p.k_pages = (const uint8_t*)k_pages;
  p.v_pages = (const uint8_t*)v_pages;
  p.k_scale = (const float*)k_scale;
  p.v_scale = (const float*)v_scale;
  p.k_rows = (const uint8_t*)k_rows;
  p.v_rows = (const uint8_t*)v_rows;
  p.lut = (const int32_t*)lut;
  p.fmt = lns::Format{man_bits, bias, min_normal_code, max_normal_code};
  const void* bases[4] = {k_pages, v_pages, k_rows, v_rows};
  p.c.vec = copy_width(hd, dv, bases, 4);
  return launch_cluster<LnsInst>(lns_paged_partials_kernel, p, B,
                                 (cudaStream_t)stream);
}

// Shared memory one block of one group of the float instance needs.
int float_paged_partials_smem(int page, int G, int hd, int dv, int maxp,
                              int bf16_pages) {
  return (int)layout(bf16_pages ? 2 : 4, (size_t)G * hd * 4, page, G, hd, dv,
                     maxp, 1).total;
}

// The float-page instance: pages of bf16 (bf16_pages != 0) or float32,
// a float32 q; out, m_out and l_out as above.  Launch on `stream`;
// returns the launch's error code.
int float_paged_partials(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, const void* k_rows,
    const void* v_rows, const void* logical, const void* rows,
    const void* imask, void* out, void* m_out, void* l_out, int B, int maxp,
    int page, int KV, int G, int hd, int dv, int window, int fused,
    int bf16_pages, float cap, float inv_sqrt_hd, void* stream) {
  const Common c = common(block_tables, lengths, logical, rows, imask, out,
                          m_out, l_out, maxp, page, KV, G, hd, dv, window,
                          fused, cap, inv_sqrt_hd);
  if (bf16_pages)
    return launch_float<__nv_bfloat16>(q, k_pages, v_pages, k_rows, v_rows,
                                       c, B, (cudaStream_t)stream);
  return launch_float<float>(q, k_pages, v_pages, k_rows, v_rows, c, B,
                             (cudaStream_t)stream);
}

}  // extern "C"
