// SAGAN attention forward, O = softmax(Q K^T) V, for Hopper (sm_90a): the
// single-pass kernel and the flash forward, one key-tiled loop.
//
// Replaces two TPU kernels of sagan_tpu/ops/pallas_attention.py:
//  * _fwd_kernel (launched by _fwd, behind attention_fused), which held
//    all of K/V resident in VMEM: attention_fwd_kernel here;
//  * _flash_fwd_kernel (launched by _flash_fwd, the forward of the flash
//    path for key sets too large for VMEM), which also writes the row
//    log-sum-exp lse = max + log(sum exp(logit - max)) as fp32 [B, N, 1]
//    for the flash backward: attention_flash_fwd_kernel here.
// Same function: logits are UNSCALED (no 1/sqrt(d)), the softmax runs in
// fp32, accumulation is fp32 and the output is written in the input type.
// Operands are bf16 or fp32, all three of one type.
//
//   q [B, N, D]   k [B, M, D]   v [B, M, C]   ->   o [B, N, C], row-major
//                                                  (+ lse [B, N] fp32)
//
// What bounds it on the H100: at SAGAN's head widths (D = 2..32) the
// contractions are far too thin for the tensor cores to help without
// padding D to 16, so this kernel runs them as fp32 FMAs on the CUDA cores.
// Per (query, key) pair it does D + C FMAs and one exponential: at the
// church64 64-map site (B=64, N=4096, M=1024, D=2, C=8) that is 2.7e9 FMAs
// (~80 us at the 67 TFLOP/s fp32 peak) and 2.7e8 exponentials (~64 us on
// the SFUs at 16 per clock per SM), against ~2 us to move its 6.6 MB; at
// the church512 512-map site (B=4, N=262144, M=65536) 6.9e11 FMAs (~21 ms)
// and 6.9e10 exponentials (~16 ms) against ~30 us for its 21 MB in bf16.
// So the floor of this design is the CUDA-core arithmetic, not memory.
//
// Design (simple and right, not yet fast):
//  * one block per (tile of kRows query rows, batch element), one thread
//    per query row; the row's q lives in registers;
//  * K/V are walked in tiles of kTile (32) keys staged (as fp32) in shared
//    memory, so the kernel is right for any M: the TPU's single-pass and
//    flash kernels differ only in whether K/V fit VMEM, and on Hopper one
//    loop serves both;
//  * an online softmax over the key tiles: running max, running sum and
//    fp32 acc[C] in registers, one rescale per tile, acc / l at the end
//    (the TPU kernels also divide the skinny [N, C] side, not the
//    probabilities); the flash kernel adds the lse write.
//
// The value width C is fixed per build (-DSAGAN_ATTN_C=8, 16, ...): each
// width is its own small library holding both kernels, so the widths build
// in parallel and a run builds only the widths it uses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef SAGAN_ATTN_C
#error "build with -DSAGAN_ATTN_C=<value width>"
#endif

namespace {

// The tiles may be set at build time (-DSAGAN_FWD_ROWS=, -DSAGAN_FWD_TILE=)
// for the tile studies (sagan_tpu_torch/tools/bench_attn_floor*.py); the
// defaults below are the shipped kernels.
#ifdef SAGAN_FWD_ROWS
constexpr int kRows = SAGAN_FWD_ROWS;
#else
constexpr int kRows = 64;  // query rows per block, one per thread
#endif
#ifdef SAGAN_FWD_TILE
constexpr int kTile = SAGAN_FWD_TILE;
#else
// keys staged in shared memory per step; wide values keep fewer logits
// in registers beside acc[C] (and build in half the time)
constexpr int kTile = SAGAN_ATTN_C >= 64 ? 16 : 32;
#endif
static_assert(kRows % 32 == 0 && kRows <= 1024, "kRows: whole warps");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The key-tiled online softmax of one query row per thread; writes o and,
// when kLse, the row's lse.
template <typename T, int D, int C, bool kLse>
__device__ __forceinline__ void fwd_rows(const T* __restrict__ q,
                                         const T* __restrict__ k,
                                         const T* __restrict__ v,
                                         T* __restrict__ o,
                                         float* __restrict__ lse, int n,
                                         int m) {
  static_assert(kTile * (D + C) * sizeof(float) <= 48 * 1024,
                "K/V tile past the 48 KB of static shared memory");
  __shared__ float ks[kTile][D];
  __shared__ float vs[kTile][C];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const T* kb = k + (size_t)b * m * D;
  const T* vb = v + (size_t)b * m * C;

  float qr[D];
  const T* qrow = q + ((size_t)b * n + (live ? row : 0)) * D;
#pragma unroll
  for (int i = 0; i < D; ++i) qr[i] = live ? to_f32(qrow[i]) : 0.f;

  float acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) acc[i] = 0.f;
  float mx = -INFINITY;  // running max of the logits seen so far
  float l = 0.f;         // running sum of exp(logit - mx)

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tm = min(kTile, m - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kTile * D; i += kRows)
      ks[i / D][i % D] = i < tm * D ? to_f32(kb[(size_t)t0 * D + i]) : 0.f;
    for (int i = threadIdx.x; i < kTile * C; i += kRows)
      vs[i / C][i % C] = i < tm * C ? to_f32(vb[(size_t)t0 * C + i]) : 0.f;
    __syncthreads();

    float s[kTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) dot = fmaf(qr[i], ks[j][i], dot);
      s[j] = j < tm ? dot : -INFINITY;  // keys past M weigh exp(-inf) = 0
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(mx, tile_max);
    const float scale = __expf(mx - m_new);  // 0 on the first tile
    // the tile's terms are summed on their own and added to the running
    // sums once a tile, so that terms far below the row's max are not lost
    // against a large running sum (65,536 keys at the 512 map)
    float tl = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = __expf(s[j] - m_new);
      tl += s[j];
    }
    l = fmaf(l, scale, tl);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < kTile; ++j) t = fmaf(s[j], vs[j][i], t);
      acc[i] = fmaf(acc[i], scale, t);
    }
    mx = m_new;
  }

  if (live) {
    const size_t r = (size_t)b * n + row;
    T* orow = o + r * C;
#pragma unroll
    for (int i = 0; i < C; ++i) store(orow + i, acc[i] / l);
    if constexpr (kLse) lse[r] = mx + logf(l);
  }
}

// Two kernels (and not a runtime flag) so that a profile tells the
// single-pass forward from the flash one by name.
template <typename T, int D, int C>
__global__ void __launch_bounds__(kRows)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int n,
                         int m) {
  fwd_rows<T, D, C, false>(q, k, v, o, nullptr, n, m);
}

template <typename T, int D, int C>
__global__ void __launch_bounds__(kRows)
    attention_flash_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               float* __restrict__ lse, int n, int m) {
  fwd_rows<T, D, C, true>(q, k, v, o, lse, n, m);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int n, int m, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, b);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  if (lse)
    attention_flash_fwd_kernel<T, D, SAGAN_ATTN_C>
        <<<grid, kRows, 0, stream>>>(q_, k_, v_, static_cast<T*>(o), lse, n,
                                     m);
  else
    attention_fwd_kernel<T, D, SAGAN_ATTN_C>
        <<<grid, kRows, 0, stream>>>(q_, k_, v_, static_cast<T*>(o), n, m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int n, int m, int d,
                       cudaStream_t stream) {
  switch (d) {
    case 2: return launch<T, 2>(q, k, v, o, lse, b, n, m, stream);
    case 4: return launch<T, 4>(q, k, v, o, lse, b, n, m, stream);
    case 8: return launch<T, 8>(q, k, v, o, lse, b, n, m, stream);
    case 16: return launch<T, 16>(q, k, v, o, lse, b, n, m, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, b, n, m, stream);
  }
  return cudaErrorInvalidValue;
}

int forward(const void* q, const void* k, const void* v, void* o, void* lse,
            int b, int n, int m, int d, int c, int is_bf16, void* stream) {
  if (c != SAGAN_ATTN_C) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, l, b, n, m, d, st)
                 : dispatch_d<float>(q, k, v, o, l, b, n, m, d, st);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// `is_bf16` selects bf16 operands, else fp32; `c` must be SAGAN_ATTN_C.
// The caller checks shapes, contiguity and the supported D before calling.
extern "C" int sagan_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int n,
                                   int m, int d, int c, int is_bf16,
                                   void* stream) {
  return forward(q, k, v, o, nullptr, b, n, m, d, c, is_bf16, stream);
}

// The flash forward: also writes lse, fp32 [B, N] (the caller's [B, N, 1]).
extern "C" int sagan_attention_flash_fwd(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int b, int n, int m, int d, int c,
                                         int is_bf16, void* stream) {
  if (lse == nullptr) return cudaErrorInvalidValue;
  return forward(q, k, v, o, lse, b, n, m, d, c, is_bf16, stream);
}
