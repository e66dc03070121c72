// Warp-level tensor-core helpers shared by the port's bf16 kernels (K2
// fused-dequant matmul, K6 flash attention) on Hopper (sm_90a):
// mma.sync m16n8k16 on bf16 fragments with float32 accumulation,
// ldmatrix from shared-memory tiles whose row stride is an odd number of
// 16-byte chunks (a row padded by 8 bf16 values), so the eight rows of an
// 8 x 8 matrix fall in eight different bank groups, and cp.async 16-byte
// copies with zero-fill for the ragged edge.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), for lane l,
// g = l / 4, t = l % 4:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1),
//                           a2 = (g, 2t+8..2t+9), a3 = (g+8, 2t+8..2t+9);
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g);
//   C (16 x 8, float32):    c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// So the C fragments of two adjacent n8 tiles are, element for element, the
// A fragment of one 16 x 16 tile: a score accumulator feeds the next
// product from registers.  Each 32-bit register holds two bf16 values, the
// lower column in the low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and receives in r[i] its part of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: for B operands stored k-major.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Row and column of the 16 x 16 tile whose address lane `lane` gives, so
// that ldmatrix_x4 returns the A fragment of a row-major tile ...
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
// ... the B fragments (b0, b1 of n8 tile 0, then of n8 tile 1) of a tile
// stored n-major ([n][k], as K in S = Q K^T), row = n, column = k ...
__device__ __forceinline__ int bn_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int bn_col(int lane) { return lane & 8; }
// ... and, with ldmatrix_x4_trans, those of a tile stored k-major ([k][n],
// as V in O = P V or w in x w), row = k, column = n.
__device__ __forceinline__ int bk_row(int lane) { return lane & 15; }
__device__ __forceinline__ int bk_col(int lane) { return (lane >> 4) << 3; }

// c += a * b on the tensor cores: 16 x 16 bf16 by 16 x 8 bf16, float32 sums.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest even into one register (x in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_lo(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t r) {
  return __uint_as_float(r & 0xFFFF0000u);
}

// 16 bytes from global to shared memory, asynchronously; with src_bytes 0
// nothing is read and the 16 bytes are zeros (the ragged edge).  Both
// addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `n` of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

}  // namespace mma
