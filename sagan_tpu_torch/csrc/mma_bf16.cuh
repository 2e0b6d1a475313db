// Warp-level tensor-core helpers for Hopper (sm_90a), shared by the bf16
// attention kernels (attention_flash_mma.cu, whose builds are also the
// tensor-core variants of the study forward S1) and the bf16 folded
// forward S2 (attention_folded.cu): mma.sync bf16 -> fp32 in the PTX ISA's
// fragment layouts, ldmatrix / movmatrix, cp.async and the staging of
// row-major tiles by it, bf16x2 packing and the quad reductions of a C
// fragment's row.
//
// Fragment layouts (g = lane / 4, t = lane % 4):
//   A 16x16 (row): a0 row g, cols 2t, 2t+1; a1 row g+8; a2 row g, cols
//                  2t+8, 2t+9; a3 row g+8, cols 2t+8, 2t+9
//   A 16x8  (row): a0 row g, cols 2t, 2t+1; a1 row g+8
//   B 16x8  (col): b0 rows 2t, 2t+1 of col g; b1 rows 2t+8, 2t+9
//   B 8x8   (col): b0 rows 2t, 2t+1 of col g
//   C/D 16x8 fp32: d0, d1 row g, cols 2t, 2t+1; d2, d3 row g+8
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// D += A B for one m16n8k16 tile: A 16x16 bf16 (row), B 16x8 bf16 (col),
// D 16x8 fp32, in the PTX ISA's fragment layouts
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D += A B for one m16n8k8 tile: A 16x8 bf16 (row), B 8x8 bf16 (col)
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// two floats as bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}
// x rounded to bf16 and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// 2^x on the SFU (ex2.approx, flush to zero): 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: lanes 8i..8i+7 give the 16-byte rows of matrix i; each lane
// receives row g, cols 2t, 2t+1 of every matrix (with .trans: rows 2t,
// 2t+1 of col g)
__device__ __forceinline__ uint32_t ldsm_x1(const void* row) {
  uint32_t r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r) : "r"(smem_addr(row)));
  return r;
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1) : "r"(smem_addr(row)));
}

// the transpose of an 8x8 bf16 matrix held as one C-fragment-like word a
// lane (row g, cols 2t, 2t+1): the lane receives rows 2t, 2t+1 of col g
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// cp.async of kBytes (4, 8 or 16) from global to shared memory, of which
// the first `src_bytes` are read and the rest zero-filled (0: all zeros,
// nothing read)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "cp.async size");
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(kBytes),
                    "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most kPending committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// 16-byte units of a staged row of w bf16: at least one (narrow rows are
// zero-padded to 8 values), and an odd count, so that the 8 rows an
// ldmatrix reads fall in distinct banks
__host__ __device__ constexpr int row_units(int w) {
  return w < 8 ? 1 : (w / 8) % 2 ? w / 8 : w / 8 + 1;
}

// cp.async rows [r0, r0 + rows) of a row-major [total, W] bf16 matrix to
// dst, whose rows are row_units(W) * 16 bytes; rows past `total` are
// zero-filled. A chunk is one row of up to 16 bytes, or 16 bytes of one.
template <int W, int kThreads>
__device__ __forceinline__ void stage_rows(char* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int rows, int total) {
  constexpr int kChunk = 2 * W < 16 ? 2 * W : 16;
  constexpr int kPer = 2 * W / kChunk;
  constexpr int kStride = row_units(W) * 16;
  for (int i = threadIdx.x; i < rows * kPer; i += kThreads) {
    const int r = i / kPer, part = i % kPer;
    const bool in = r0 + r < total;
    const char* s = reinterpret_cast<const char*>(
                        src + (size_t)(in ? r0 + r : 0) * W) + part * kChunk;
    cp_async<kChunk>(dst + r * kStride + part * kChunk, s, in ? kChunk : 0);
  }
}

__device__ __forceinline__ void zero_smem(char* p, int bytes, int threads) {
  for (int i = threadIdx.x; i < bytes / 16; i += threads)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// let `kernel` take `bytes` of dynamic shared memory (past the 48 KB a
// launch gets without asking)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace
