// Shared helpers of the port's attention kernels: the sm_80+ warp-level
// bf16 tensor-core product m16n8k16 (fp32 accumulate) and fragment packing.
//
// Fragment layout of mma.sync.m16n8k16.row.col (PTX ISA), with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = (row g,   cols 2t, 2t+1)   a1 = (row g+8, cols 2t, 2t+1)
//                         a2 = (row g,   cols 2t+8, 2t+9) a3 = (row g+8, cols 2t+8, 2t+9)
//   B (16x8, k x n):      b0 = (k 2t, 2t+1; col g)        b1 = (k 2t+8, 2t+9; col g)
//   C (16x8, fp32):       c0, c1 = (row g,   cols 2t, 2t+1)
//                         c2, c3 = (row g+8, cols 2t, 2t+1)
// In every packed 32-bit register the lower half holds the lower index.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdu {

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two consecutive bf16 of shared memory as one register (4-byte aligned).
__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. Without .trans, register i holds (row g, cols 2t,
// 2t+1) of matrix i; with .trans, (rows 2t, 2t+1; col g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// 16-byte asynchronous copy to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of a row-major [L, D] bf16 matrix into a shared
// ROWS x DP tile with cp.async (D % 8 == 0, 16-byte aligned base); rows past L
// and columns past D are zero-filled. Commits no group.
template <int ROWS, int DP, int LDS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* sm,
                                                const __nv_bfloat16* g,
                                                int row0, int L, int D) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int gr = row0 + r;
    const bool in = gr < L && c < D;
    cp_async_16(sm + r * LDS + c, in ? g + (size_t)gr * D + c : g, in ? 16 : 0);
  }
}

// Copy rows [row0, row0 + ROWS) of a row-major [L, D] bf16 matrix into a
// shared tile of ROWS x DP (row stride LDS elements), zero-filling rows past
// L and columns past D. ``vec`` allows 16-byte loads (D % 8 == 0 and a
// 16-byte aligned base).
template <int ROWS, int DP, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm,
                                          const __nv_bfloat16* g, int row0,
                                          int L, int D, bool vec) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < L) {
      const __nv_bfloat16* src = g + (size_t)gr * D + c;
      if (vec) {
        if (c < D) val = *reinterpret_cast<const uint4*>(src);
      } else {
        __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tmp[j] = (c + j < D) ? src[j] : __ushort_as_bfloat16((unsigned short)0);
        val = *reinterpret_cast<const uint4*>(tmp);
      }
    }
    *reinterpret_cast<uint4*>(sm + r * LDS + c) = val;
  }
}

}  // namespace mdu
