// The paper's six FP8 operations elementwise over uint8 code tensors for
// Hopper (sm_90a): kernel K5.
//
// Replaces the Pallas TPU kernels repro/kernels/fp8_elementwise.py::
// _unary_kernel and _binary_kernel, which apply core/lns.py::lns_op to
// (rows, 128) tiles.  K5 computes what lns_op computes, element by
// element, with integer operations only: the sign and magnitude fields,
// the core add (mul), subtract (div), shift (square, sqrt) or negate
// (recip, rsqrt), the folded constant K and the Table 2/3 carry-in bit,
// then clamp and flush, then the special-code cases in the reference's
// order (later cases override earlier ones; NaN wins last).  No table of
// results is read: the only table is the cell's carry bit, a function of
// bits 0-3 and 7 of each operand (1,024 bits), built on the host by the
// tested plain carry_in (kernels/common.py::elementwise_carry_table) and
// passed by value as a kernel parameter.
//
// What bounds K5 on this card: bytes for large tensors -- each code read
// once and each result written once, 3 bytes per binary element and 2 per
// unary, against 3.35 TB/s of HBM -- and launch latency for the small
// tensors of a decode sub-step.  The integer work is close behind: the
// card runs 32-bit integer instructions on 64 lanes per SM, about five in
// the time HBM moves one byte, so a rule of a few tens of instructions a
// code would set the time itself (chip_smoke.py counts the compiled
// stream from the SASS).
//
// Design: the rule runs on four codes of a 32-bit word at once
// (lns_word; kernels/fp8_elementwise.py::packed_rule_model repeats it
// step for step, and the CPU tests hold that model bit for bit against
// the reference in all 69 cells).  The field tests are byte-wise adds that
// set bit 7 of a byte (mx + 0x80 - lo: x is normal or more; mx + 0x80 -
// bad_from: x is NaN/inf), turned into byte masks by prmt's sign
// replication.  The op's expression is a byte per code (mx + my, mx + 127
// - my, 2 mx, 127 - mx, mx >> 1, 64 - ceil(mx / 2); never above 255 with
// the carry), spread by prmt into the 16-bit lanes of two registers, two
// codes each, where one add puts K on it with a bias that leaves a lane
// mag + 0x8000 - lo (so bit 15 says mag >= lo and no lane borrows from
// its neighbour) and one 16x2 minimum saturates it; prmt packs the low
// bytes back and replicates bit 15 into the underflow mask.  The special
// cases are byte-mask selects.  The carry stays a lookup: each block puts
// the cell's 32 words into shared memory at x's index (x & 0xF, or 0xF0
// | x & 0xF with the sign: 32 words in 32 banks), and a funnel shift by
// y's index picks the bit.  Each thread loads two 16-byte vectors of
// each operand ahead of the pair it computes, in a grid sized from the
// element count (small tensors get small blocks, so a decode sub-step's
// gate spreads over more SMs).  A scalar loop takes the n % 16 tail, and
// every element when any pointer is not 16-byte aligned (a view with a
// storage offset is legal input), through the same rule on one code.
// `op` is a template parameter (6 instantiations).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kMul = 0, kDiv = 1, kSquare = 2, kRecip = 3, kSqrt = 4, kRsqrt = 5 };

// One (format, op, mode) cell: the lane constants of
// kernels/fp8_elementwise.py::packed_constants and the carry bits (bit
// carry_index(y) of word carry_index(x)).
struct Cell {
  uint32_t kb2, hb2, lo4, cl4, cb4, hi4;
  uint32_t carry[32];
};

constexpr int kMaxThreads = 256;
constexpr int kAhead = 2;                  // 16-byte vectors a thread loads
constexpr uint32_t kNan4 = 0x7F7F7F7Fu;    // the NaN code of both formats

// PTX prmt.b32: byte j of the result is byte (s_j & 7) of {b, a}, or that
// byte's bit 7 replicated when s_j & 8 (s_j the selector's nibble j).
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// Bytes of a where the byte mask m is 0xFF, of b where it is 0.
__device__ __forceinline__ uint32_t sel(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

// Byte masks from bit 7 of each byte.
__device__ __forceinline__ uint32_t mask7(uint32_t v) {
  return prmt(v, 0u, 0xBA98u);
}

// lns_op on the four codes of X (and Y), packed as they lie in memory.
template <int OP>
__device__ __forceinline__ uint32_t lns_word(uint32_t X, uint32_t Y,
                                             const Cell& c,
                                             const uint32_t* tab) {
  constexpr bool kBinary = OP == kMul || OP == kDiv;
  if (!kBinary) Y = 0u;
  const uint32_t AX = X & 0x7F7F7F7Fu, AY = Y & 0x7F7F7F7Fu;
  const uint32_t XNM = mask7(AX + c.cl4);          // x normal or more
  const uint32_t YNM = mask7(AY + c.cl4);
  uint32_t BM = mask7(kBinary ? (AX + c.cb4) | (AY + c.cb4) : AX + c.cb4);
  // carry: x's index selects a word, y's index (the low 5 bits of each
  // byte of IY; the funnel shift reads no more) a bit of it
  const uint32_t IX = (X & 0x0F0F0F0Fu) | (mask7(X) & 0xF0F0F0F0u);
  const uint32_t IY =
      kBinary ? (Y & 0x0F0F0F0Fu) | ((Y >> 3) & 0xF0F0F0F0u) : 0u;
  uint32_t cw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = tab[prmt(IX, 0u, 0x4440u | i)];
    cw[i] = __funnelshift_r(w, w, IY >> (8 * i));
  }
  const uint32_t C4 = prmt(prmt(cw[0], cw[1], 0x0040u),
                           prmt(cw[2], cw[3], 0x4000u), 0x7610u) &
                      0x01010101u;
  // the op's byte, with the carry
  const uint32_t NX = ~X & 0x7F7F7F7Fu;
  uint32_t sum;
  if (OP == kMul) {
    sum = AX + AY + C4;
  } else if (OP == kDiv) {
    sum = AX + (~Y & 0x7F7F7F7Fu) + C4;
  } else if (OP == kSquare) {
    sum = AX + AX + C4;
  } else if (OP == kRecip) {
    sum = NX + C4;
  } else if (OP == kSqrt) {
    sum = ((X >> 1) & 0x3F3F3F3Fu) + C4;
  } else {
    sum = (((NX + 0x01010101u) >> 1) & 0x7F7F7F7Fu) + C4;
  }
  // two codes a register: K, saturation, the underflow bit
  const uint32_t TE = __vminu2(prmt(sum, 0u, 0x4240u) + c.kb2, c.hb2);
  const uint32_t TO = __vminu2(prmt(sum, 0u, 0x4341u) + c.kb2, c.hb2);
  const uint32_t NUF = prmt(TE, TO, 0xFBD9u);      // 0xFF: mag >= lo
  const uint32_t MAG = (prmt(TE, TO, 0x6240u) & NUF) + c.lo4;
  // the special cases in the reference's order, NaN last
  uint32_t out;
  if (OP == kMul) {
    out = (MAG & NUF & XNM & YNM) | ((X ^ Y) & 0x80808080u);
  } else if (OP == kDiv) {
    const uint32_t S = (X ^ Y) & 0x80808080u;
    out = sel(YNM, (MAG & NUF & XNM) | S, S | sel(XNM, c.hi4, kNan4));
  } else if (OP == kSquare || OP == kSqrt) {
    out = MAG & NUF & XNM;
  } else {
    out = sel(XNM, MAG & NUF, c.hi4);
    if (OP == kRecip) out |= X & 0x80808080u;
  }
  if (OP == kSqrt || OP == kRsqrt) BM |= mask7(X);  // a sign bit: NaN
  return sel(BM, kNan4, out);
}

template <int OP>
__device__ __forceinline__ uint4 lns_vec(const uint4& a, const uint4& b,
                                         const Cell& c,
                                         const uint32_t* tab) {
  return make_uint4(lns_word<OP>(a.x, b.x, c, tab),
                    lns_word<OP>(a.y, b.y, c, tab),
                    lns_word<OP>(a.z, b.z, c, tab),
                    lns_word<OP>(a.w, b.w, c, tab));
}

template <int OP>
__global__ void __launch_bounds__(kMaxThreads)
fp8_elementwise_kernel(const uint8_t* __restrict__ x,
                       const uint8_t* __restrict__ y,
                       uint8_t* __restrict__ out, long long n, int aligned,
                       const Cell cell) {
  constexpr bool kBinary = OP == kMul || OP == kDiv;
  __shared__ uint32_t tab[256];   // words 0-15 and 240-255 are read
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) tab[i < 16 ? i : 224 + i] = cell.carry[i];
  }
  __syncthreads();

  const long long threads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (aligned) {
    const long long nv = n >> 4;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* yv = reinterpret_cast<const uint4*>(y);
    uint4* ov = reinterpret_cast<uint4*>(out);
    // vectors tid, tid + threads, ...: kAhead of them loaded, then computed
    for (long long i0 = tid; i0 < nv; i0 += kAhead * threads) {
      uint4 a[kAhead], b[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const long long i = i0 + u * threads;
        a[u] = b[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < nv) {
          a[u] = xv[i];
          if (kBinary) b[u] = yv[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const long long i = i0 + u * threads;
        if (i < nv) ov[i] = lns_vec<OP>(a[u], b[u], cell, tab);
      }
    }
    done = nv << 4;
  }
  for (long long i = done + tid; i < n; i += threads)
    out[i] = (uint8_t)lns_word<OP>(x[i], kBinary ? y[i] : 0u, cell, tab);
}

template <int OP>
void launch(const uint8_t* x, const uint8_t* y, uint8_t* out, long long n,
            const Cell& cell, cudaStream_t stream) {
  const int aligned = ((uintptr_t)x | (uintptr_t)y | (uintptr_t)out) % 16 == 0;
  const long long nv = aligned ? n >> 4 : 0;
  const long long scalar = n - (nv << 4);
  // Large tensors: 256 threads a block, kAhead vectors a thread.  Small
  // ones (a decode sub-step's gate): 64 threads a block, one vector a
  // thread, so more SMs share them.
  const bool large = nv >= 132LL * kMaxThreads * kAhead;
  const int threads = large || scalar >= 132LL * kMaxThreads ? kMaxThreads
                                                             : 64;
  const long long per_block = (long long)threads * (large ? kAhead : 1);
  long long blocks = (nv + per_block - 1) / per_block;
  const long long tail_blocks = (scalar + threads - 1) / threads;
  if (blocks < tail_blocks) blocks = tail_blocks;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;
  fp8_elementwise_kernel<OP><<<(int)blocks, threads, 0, stream>>>(
      x, y, out, n, aligned, cell);
}

}  // namespace

// out[i] = lns_op(fmt, op, mode, x[i], y[i]) for i < n; `y` is null for
// the unary ops.  `consts` points to the six words of packed_constants
// (kb2, hb2, lo4, cl4, cb4, hi4) and `carry` to the cell's 32 words, both
// in host memory.  Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for an unknown op).
extern "C" int fp8_elementwise(int op, const uint8_t* x, const uint8_t* y,
                               uint8_t* out, long long n,
                               const uint32_t* consts,
                               const uint32_t* carry, void* stream) {
  Cell cell;
  cell.kb2 = consts[0];
  cell.hb2 = consts[1];
  cell.lo4 = consts[2];
  cell.cl4 = consts[3];
  cell.cb4 = consts[4];
  cell.hi4 = consts[5];
  for (int i = 0; i < 32; ++i) cell.carry[i] = carry[i];
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kMul: launch<kMul>(x, y, out, n, cell, s); break;
    case kDiv: launch<kDiv>(x, y, out, n, cell, s); break;
    case kSquare: launch<kSquare>(x, y, out, n, cell, s); break;
    case kRecip: launch<kRecip>(x, y, out, n, cell, s); break;
    case kSqrt: launch<kSqrt>(x, y, out, n, cell, s); break;
    case kRsqrt: launch<kRsqrt>(x, y, out, n, cell, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
