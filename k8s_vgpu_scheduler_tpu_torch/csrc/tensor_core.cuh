// Building blocks of the bf16 tensor-core kernels (flash_fwd.cu,
// flash_bwd.cu): 16-byte and 4-byte cp.async copies into shared memory,
// ldmatrix fragment loads and the mma.sync m16n8k16 bf16 -> f32 product.
//
// Fragment layouts of one m16n8k16 product, per lane (g = lane / 4,
// t4 = lane % 4):
// - A (16x16, row-major): a0 row g, columns 2*t4 and 2*t4+1; a1 row g+8;
//   a2 row g, columns 2*t4+8 and +9; a3 row g+8, the same columns;
// - B (16x8, "col": stored as 8 rows of 16): b0 rows 2*t4, 2*t4+1 of
//   column g; b1 rows 2*t4+8, +9;
// - C (16x8, f32): c0, c1 row g, columns 2*t4 and 2*t4+1; c2, c3 row g+8.
// So the C fragments of two adjacent 8-column n-tiles, packed to bf16
// pairs, are the A fragment of one 16-deep k-step: a product's result
// feeds the next product without leaving registers.
//
// A matrix stored [row][col] with rows padded to a multiple of 16 bytes
// is read, per ldmatrix_x4, from these lane addresses (elements):
// - as A: row lane % 16, column (lane / 16) * 8;
// - as the B of two n-tiles (rows of the stored matrix are B's columns):
//   row lane % 8 + (lane / 16) * 8, column ((lane / 8) % 2) * 8;
// - as B transposed (rows of the stored matrix are B's rows), with
//   ldmatrix_x4_trans: row lane % 16, column (lane / 16) * 8.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with `full` false it reads nothing and
// writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}

// The same for 4 bytes (one f32).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one m16n8k16 tile: a is 16x16 bf16 (row), b 16x8 (col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 as one bf16 pair, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk from the C fragments of n-tiles 2kk and
// 2kk+1, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace tc
