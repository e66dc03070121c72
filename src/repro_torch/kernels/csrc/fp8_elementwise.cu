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
// passed by value as a kernel parameter; each block copies its 32 words
// into shared memory, where 32 lanes reading 32 different words hit 32
// different banks.
//
// What bounds K5 on this card: bytes for large tensors -- each code read
// once and each result written once, 3 bytes per binary element and 2 per
// unary, against 3.35 TB/s of HBM -- and launch latency for the small
// tensors of a decode sub-step.  The integer work is close behind: the
// card runs 32-bit integer instructions on 64 lanes per SM, about five in
// the time HBM moves one byte, and lns_op as written here compiles to a
// few tens of them per element, so the compiled instruction stream, not
// the bytes, may set the time (chip_smoke.py counts it from the SASS).
// Design, first version: one thread per 16 codes, each operand read with
// one 128-bit load in a grid-stride loop; a scalar loop takes the n % 16
// tail, and every element when any pointer is not 16-byte aligned (a view
// with a storage offset is legal input).  `op` is a template parameter
// (6 instantiations).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kMul = 0, kDiv = 1, kSquare = 2, kRecip = 3, kSqrt = 4, kRsqrt = 5 };

// One (format, op, mode) cell: what lns_op needs of the format, the
// folded constant of core/lns.py::folded_constant and the carry bits
// (bit carry_index(y) of word carry_index(x)).
struct Cell {
  int k;          // folded constant added to the sign-free magnitudes
  int lo, hi;     // min_normal_code, max_normal_code
  int nan_code;   // canonical NaN magnitude code
  int bad_from;   // magnitudes >= this are NaN (or inf for e5m2)
  uint32_t carry[32];
};

constexpr int kThreads = 256;

// Bits 0-3 and the sign bit 7 of a code: all any carry-in expression reads.
__device__ __forceinline__ unsigned carry_index(unsigned v) {
  return (v & 0xFu) | ((v >> 7) << 4);
}

template <int OP>
__device__ __forceinline__ unsigned lns_elem(unsigned x, unsigned y,
                                             const Cell& c,
                                             const uint32_t* carry) {
  constexpr bool kBinary = OP == kMul || OP == kDiv;
  const int mx = x & 0x7F, sx = x >> 7;
  const int my = y & 0x7F, sy = y >> 7;
  int mag, sign;
  if (OP == kMul) {
    mag = mx + my + c.k;
    sign = sx ^ sy;
  } else if (OP == kDiv) {
    mag = mx - my + c.k;
    sign = sx ^ sy;
  } else if (OP == kSquare) {
    mag = (mx << 1) + c.k;
    sign = 0;
  } else if (OP == kRecip) {
    mag = c.k - mx;
    sign = sx;
  } else if (OP == kSqrt) {
    mag = (mx >> 1) + c.k;
    sign = 0;
  } else {
    // (-mx) >> 1 with an arithmetic shift is floor(-mx / 2) = -ceil(mx / 2);
    // written on the non-negative mx so no shift of a negative int occurs.
    mag = c.k - ((mx + 1) >> 1);
    sign = 0;
  }
  mag += (carry[carry_index(x)] >> (kBinary ? carry_index(y) : 0u)) & 1u;
  mag = mag < c.lo ? 0 : min(mag, c.hi);  // flush underflow, saturate
  unsigned out = ((unsigned)sign << 7) | (unsigned)mag;

  const bool xz = mx < c.lo, yz = kBinary && my < c.lo;
  const bool bad = mx >= c.bad_from || (kBinary && my >= c.bad_from);
  const unsigned s7 = (unsigned)sign << 7;
  if (OP == kMul) {
    if (xz || yz) out = s7;
  } else if (OP == kDiv) {
    if (xz && !yz) out = s7;
    if (yz) out = s7 | (unsigned)(xz ? c.nan_code : c.hi);
  } else if (OP == kSquare) {
    if (xz) out = 0;
  } else if (OP == kRecip) {
    if (xz) out = s7 | (unsigned)c.hi;
  } else if (OP == kSqrt) {
    if (xz) out = 0;
    if (sx) out = (unsigned)c.nan_code;
  } else {
    if (xz) out = (unsigned)c.hi;
    if (sx) out = (unsigned)c.nan_code;
  }
  if (bad) out = (unsigned)c.nan_code;
  return out;
}

// Four codes packed in a 32-bit word.
template <int OP>
__device__ __forceinline__ uint32_t lns_word(uint32_t a, uint32_t b,
                                             const Cell& c,
                                             const uint32_t* carry) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r |= lns_elem<OP>((a >> (8 * i)) & 0xFFu, (b >> (8 * i)) & 0xFFu, c,
                      carry) << (8 * i);
  return r;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
fp8_elementwise_kernel(const uint8_t* __restrict__ x,
                       const uint8_t* __restrict__ y,
                       uint8_t* __restrict__ out, long long n, int aligned,
                       const Cell cell) {
  constexpr bool kBinary = OP == kMul || OP == kDiv;
  __shared__ uint32_t carry[32];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) carry[i] = cell.carry[i];  // static offsets
  }
  __syncthreads();

  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (aligned) {
    const long long nv = n >> 4;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* yv = reinterpret_cast<const uint4*>(y);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 a = xv[i];
      const uint4 b = kBinary ? yv[i] : make_uint4(0u, 0u, 0u, 0u);
      uint4 r;
      r.x = lns_word<OP>(a.x, b.x, cell, carry);
      r.y = lns_word<OP>(a.y, b.y, cell, carry);
      r.z = lns_word<OP>(a.z, b.z, cell, carry);
      r.w = lns_word<OP>(a.w, b.w, cell, carry);
      ov[i] = r;
    }
    done = nv << 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = (uint8_t)lns_elem<OP>(x[i], kBinary ? y[i] : 0u, cell, carry);
}

template <int OP>
void launch(const uint8_t* x, const uint8_t* y, uint8_t* out, long long n,
            const Cell& cell, cudaStream_t stream) {
  const int aligned = ((uintptr_t)x | (uintptr_t)y | (uintptr_t)out) % 16 == 0;
  const long long items = aligned ? (n >> 4) + (n & 15) : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fp8_elementwise_kernel<OP><<<(int)blocks, kThreads, 0, stream>>>(
      x, y, out, n, aligned, cell);
}

}  // namespace

// out[i] = lns_op(fmt, op, mode, x[i], y[i]) for i < n; `y` is null for
// the unary ops.  `carry` points to the cell's 32 host-memory words.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue
// for an unknown op).
extern "C" int fp8_elementwise(int op, const uint8_t* x, const uint8_t* y,
                               uint8_t* out, long long n, int k, int lo,
                               int hi, int nan_code, int bad_from,
                               const uint32_t* carry, void* stream) {
  Cell cell;
  cell.k = k;
  cell.lo = lo;
  cell.hi = hi;
  cell.nan_code = nan_code;
  cell.bad_from = bad_from;
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
