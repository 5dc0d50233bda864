// Warp-level tensor-core and copy helpers of the pool backward
// (attn_pool_bwd.cu): mma.sync m16n8k16 bf16 with fp32 accumulators,
// ldmatrix, cp.async.
//
// Fragment layouts of mma.m16n8k16 (thread (g, t) = (lane / 4, lane % 4)):
//   A [16 x 16]: a0 = (row g, k 2t..2t+1), a1 = (row g+8, k 2t..), a2 = (row g, k 2t+8..),
//                a3 = (row g+8, k 2t+8..)
//   B [16 x 8]:  b0 = (k 2t..2t+1, col g), b1 = (k 2t+8.., col g)
//   C [16 x 8]:  c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, cols 2t, 2t+1)
// The C fragments of two adjacent 8-column tiles are exactly the A fragment of
// one 16-deep k-step (pack c0,c1 -> a0; c2,c3 -> a1 of the first tile, a2, a3
// of the second), so a product's result can feed the next product from
// registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i.  Thread (g, t) receives row g, columns 2t, 2t+1 of
// each matrix — or, with .trans, rows 2t, 2t+1 of column g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

}  // namespace mma
