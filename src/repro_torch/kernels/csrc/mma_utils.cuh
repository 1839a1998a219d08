// Tensor-core and async-copy helpers shared by the Hopper kernels
// (flash_attention.cu, ssd_scan.cu): mma.sync m16n8k16 with bf16 inputs
// and fp32 accumulation, ldmatrix fragment loads, cp.async 16-byte copies
// with zero fill, and the XOR swizzle of the shared-memory tiles they read.
//
// Tiles of bf16 rows live in shared memory as 16-byte chunks; chunk ch of
// row r is stored at chunk swizzle<COLS>(r, ch) of that row, so the eight
// rows that one ldmatrix 8x8 matrix reads (same logical chunk, eight
// consecutive rows) fall on eight distinct groups of four banks.  Rows are
// stored as they arrive (no padding, no transpose): the .trans form of
// ldmatrix turns a [k][n] tile into the B fragment of a product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

// c += a * b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col),
// c 16x8 fp32.  Lane l holds rows l/4 and l/4 + 8, columns 2*(l%4) + {0,1}.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives one 32-bit register of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16 bytes from global to shared memory, bypassing L1; bytes past
// src_bytes (0 or 16) are written as zeros and not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// physical 16-byte chunk of logical chunk ch in row r of a tile whose rows
// hold COLS bf16 (COLS / 8 chunks): the eight rows an 8x8 matrix spans get
// eight distinct bank groups whatever the row length.  The XOR stays inside
// the row: rows of a multiple of 8 chunks XOR by r & 7; rows of 12 (head
// dim 96, a row 48 words long, so consecutive rows start 0 or 4 bank groups
// apart) XOR chunks 0-7 by r & 7 and chunks 8-11 among themselves by
// (r >> 1) & 3, which also gives eight rows eight distinct bank groups.
template <int COLS>
__device__ __forceinline__ int swizzle(int r, int ch) {
  constexpr int CPR = COLS / 8;
  static_assert(CPR % 8 == 0 || CPR == 12 || CPR <= 4,
                "no swizzle for this row length");
  if constexpr (CPR == 12)
    return ch < 8 ? ch ^ (r & 7) : 8 + ((ch - 8) ^ ((r >> 1) & 3));
  else if constexpr (CPR >= 8) return ch ^ (r & 7);
  else if constexpr (CPR == 4) return ch ^ ((r >> 1) & 3);
  else if constexpr (CPR == 2) return ch ^ ((r >> 2) & 1);
  else return ch;
}

// element offset of chunk ch of row r in a swizzled tile
template <int COLS>
__device__ __forceinline__ int tile_off(int r, int ch) {
  return r * COLS + swizzle<COLS>(r, ch) * 8;
}

// Rows [0, ROWS) x columns [0, COLS) of a bf16 view with row stride rs
// into a swizzled tile; zeros outside [0, nrows) x [0, ncols).  vec: the
// view's rows start on 16-byte boundaries and ncols % 8 == 0, so whole
// chunks go by cp.async (the caller commits and waits); otherwise element
// by element.  Threads tid of nthreads share the tile.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int nrows, int ncols,
                                          bool vec, int tid, int nthreads) {
  constexpr int CPR = COLS / 8;
  for (int e = tid; e < ROWS * CPR; e += nthreads) {
    const int r = e / CPR, ch = e % CPR;
    __nv_bfloat16* d = dst + tile_off<COLS>(r, ch);
    const bool ok = r < nrows && ch * 8 < ncols;
    if (vec) {
      cp_async16(d, ok ? src + r * rs + ch * 8 : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = ch * 8 + i;
        d[i] = (r < nrows && c < ncols) ? src[r * rs + c]
                                        : __float2bfloat16(0.f);
      }
    }
  }
}

// every row of a view starts on a 16-byte boundary: base pointer and the
// strides (in bf16 elements) of its outer dimensions
__host__ __forceinline__ bool aligned16(const void* ptr, long long s0,
                                        long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

}  // namespace mma
