// Device helpers shared by the port's LNS kernels (K1 paged attention,
// K2 fused-dequant matmul): the flag bits of the prepared operands' table
// (kernels/common.py::lns_tables, which K1 reads) and the bit-placement
// decode of an FP8 code, mirroring kernels/common.py::code_to_f32, which
// the CPU tests hold bit for bit against the JAX package.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lns {

// Bit layout of the flags word of kernels/common.py::lns_tables: factored
// carry mask in bits 0..15, zero (FTZ) and bad (NaN/inf) flags, sign at 31.
constexpr int kCarryMask = 0xFFFF;
constexpr int kZeroBit = 1 << 16;
constexpr int kBadBit = 1 << 17;
constexpr unsigned kSignBit = 0x80000000u;

// What code_to_f32 needs to know of one FP8 format.
struct Format {
  int man_bits, bias, min_normal_code, max_normal_code;
};

// FP8 code -> float32 by bit placement; subnormal, NaN and inf codes -> 0,
// as the reference's code_to_f32.
__device__ __forceinline__ float code_to_f32(unsigned c, const Format& f) {
  const unsigned mag = c & 0x7Fu;
  const unsigned exp = mag >> f.man_bits;
  const unsigned man = mag & ((1u << f.man_bits) - 1u);
  const unsigned bits = ((c >> 7) << 31) |
                        ((unsigned)((int)exp - f.bias + 127) << 23) |
                        (man << (23 - f.man_bits));
  const bool normal = mag >= (unsigned)f.min_normal_code &&
                      mag <= (unsigned)f.max_normal_code;
  return normal ? __uint_as_float(bits) : 0.0f;
}

}  // namespace lns
