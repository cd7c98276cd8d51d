// Warp-wide tensor-core instructions (sm_80 and later), for the bf16
// products of probe_tiles.cu and of the row-tile kernels (row_tile.cuh):
// ldmatrix from shared memory into mma fragments, and the m16n8k16 bf16
// product with f32 sums. Layouts are the PTX ISA's; with
// g = lane / 4, t = lane % 4 and each 32-bit register two bf16, the lower
// index in the low half:
//   A (m16 x k16, row-major): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//     a3 (g + 8, 2t + 8..);
//   B (k16 x n8): b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g);
//   C (m16 x n8, f32): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace dstt {

// Four 8 x 8 b16 matrices; lanes 8i ... 8i + 7 give the shared addresses of
// matrix i's eight rows (16 bytes each). Lane l takes, of matrix i, into
// r[i] the pair (row l / 4, columns 2 (l % 4), 2 (l % 4) + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// The same, transposed: lane l takes (rows 2 (l % 4), 2 (l % 4) + 1, column
// l / 4), so that rows of k give a B fragment straight from [k][n].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// c += a b, one warp's m16 x n8 x k16 product, bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace dstt
