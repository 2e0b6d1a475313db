// SAGAN attention forward with the theta/phi projections folded in, for
// Hopper (sm_90a): logits = (x W) xb^T with W = W_theta W_phi^T, the same
// pre-softmax function as (x W_theta)(xb W_phi)^T, with the [N, M]
// contraction at the channel width Cin = 16 instead of d = 2 and q, k never
// written to device memory.
//
//   x [B, N, 16]   xb [B, M, 16]   w [16, 16]
//   v [B, M, 8] given (kVGiven)  or  wg [16, 8] with V = xb wg in-kernel
//   -> o [B, N, 8], row-major, all in the input type (bf16 or fp32).
//
// Replaces two TPU study kernels:
//  * tools/bench_attn_floor.py k_folded :194 (_call_folded :173): v given;
//  * tools/bench_attn_floor256.py _folded_kernel :199 (:246): the flash
//    form with V = xb Wg computed per key block in the kernel (the g
//    projection folded in too).
// Same arithmetic as both: x W summed in fp32 and rounded to the input
// type (:205, :217), the logits an fp32 sum over Cin, V = xb Wg summed in
// fp32 and rounded to the input type (:220-221), an online softmax in
// fp32, P rounded to the input type for E.V and the row sum l taken from
// fp32 P (:211, :227); o = acc / l.
//
// Design: K1's loop (attention_fwd.cu), one thread a query row on the CUDA
// cores. W (and Wg) sit in shared memory; a row's x W is formed once, in
// registers; xb is staged in tiles of kTile keys (and, without v, each
// tile's V = xb Wg is computed once a block into shared memory). What bounds
// it: Cin + C = 24 multiply-adds and one exponential a (query, key) pair
// on the CUDA cores, against d + C = 10 for K1 on projected q, k: the fold
// saves the projections' bytes (a few MB) and pays 8x the score work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CIN = 16;   // channels of x (church64's and church256's maps)
constexpr int C = 8;      // value width
constexpr int kRows = 64;  // query rows per block, one per thread
constexpr int kTile = 32;  // keys staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T and back (the JAX bodies' .astype(x.dtype))
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, bool kVGiven>
__global__ void __launch_bounds__(kRows)
    attention_folded_kernel(const T* __restrict__ x, const T* __restrict__ xb,
                            const T* __restrict__ w,
                            const T* __restrict__ vw, T* __restrict__ o,
                            int n, int m) {
  __shared__ float ws[CIN][CIN];
  __shared__ float wgs[kVGiven ? 1 : CIN][C];
  __shared__ float xbs[kTile][CIN];
  __shared__ float vs[kTile][C];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const T* xbb = xb + (size_t)b * m * CIN;
  const T* vb = kVGiven ? vw + (size_t)b * m * C : nullptr;
  const T tag{};

  for (int i = threadIdx.x; i < CIN * CIN; i += kRows)
    ws[i / CIN][i % CIN] = to_f32(w[i]);
  if constexpr (!kVGiven) {
    for (int i = threadIdx.x; i < CIN * C; i += kRows)
      wgs[i / C][i % C] = to_f32(vw[i]);
  }
  __syncthreads();

  // this row's x W, summed in fp32 and rounded to T
  float xr[CIN], xw[CIN];
  const T* xrow = x + ((size_t)b * n + (live ? row : 0)) * CIN;
#pragma unroll
  for (int i = 0; i < CIN; ++i) xr[i] = live ? to_f32(xrow[i]) : 0.f;
#pragma unroll
  for (int j = 0; j < CIN; ++j) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < CIN; ++i) t = fmaf(xr[i], ws[i][j], t);
    xw[j] = round_to(t, tag);
  }

  float acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) acc[i] = 0.f;
  float mx = -INFINITY;  // running max of the logits seen so far
  float l = 0.f;         // running sum of exp(logit - mx)

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tm = min(kTile, m - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kTile * CIN; i += kRows)
      xbs[i / CIN][i % CIN] =
          i < tm * CIN ? to_f32(xbb[(size_t)t0 * CIN + i]) : 0.f;
    if constexpr (kVGiven) {
      for (int i = threadIdx.x; i < kTile * C; i += kRows)
        vs[i / C][i % C] = i < tm * C ? to_f32(vb[(size_t)t0 * C + i]) : 0.f;
    } else {
      __syncthreads();  // the tile's xb is staged
      // V = xb Wg for the tile's keys, once a block, rounded to T
      for (int i = threadIdx.x; i < kTile * C; i += kRows) {
        const int j = i / C, c = i % C;
        float t = 0.f;
#pragma unroll
        for (int r = 0; r < CIN; ++r) t = fmaf(xbs[j][r], wgs[r][c], t);
        vs[j][c] = round_to(t, tag);
      }
    }
    __syncthreads();

    float s[kTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < CIN; ++i) dot = fmaf(xw[i], xbs[j][i], dot);
      s[j] = j < tm ? dot : -INFINITY;  // keys past M weigh exp(-inf) = 0
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(mx, tile_max);
    const float scale = __expf(mx - m_new);  // 0 on the first tile
    float tl = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float e = __expf(s[j] - m_new);
      tl += e;                  // l from fp32 P
      s[j] = round_to(e, tag);  // P in the input type for E.V
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
    T* orow = o + ((size_t)b * n + row) * C;
#pragma unroll
    for (int i = 0; i < C; ++i) store(orow + i, acc[i] / l);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* xb, const void* w,
                   const void* vw, void* o, int b, int n, int m, bool v_given,
                   cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, b);
  const T* x_ = static_cast<const T*>(x);
  const T* xb_ = static_cast<const T*>(xb);
  const T* w_ = static_cast<const T*>(w);
  const T* vw_ = static_cast<const T*>(vw);
  if (v_given)
    attention_folded_kernel<T, true><<<grid, kRows, 0, stream>>>(
        x_, xb_, w_, vw_, static_cast<T*>(o), n, m);
  else
    attention_folded_kernel<T, false><<<grid, kRows, 0, stream>>>(
        x_, xb_, w_, vw_, static_cast<T*>(o), n, m);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `vw` is v [B, M, 8] when `v_given`, else wg [16, 8]; `is_bf16` selects
// bf16 operands, else fp32; cin must be 16 and c 8. The caller checks
// shapes and contiguity before calling.
extern "C" int sagan_attention_folded(const void* x, const void* xb,
                                      const void* w, const void* vw, void* o,
                                      int b, int n, int m, int cin, int c,
                                      int v_given, int is_bf16,
                                      void* stream) {
  if (cin != CIN || c != C) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, xb, w, vw, o, b, n, m, v_given,
                                         st)
                 : launch<float>(x, xb, w, vw, o, b, n, m, v_given, st);
}
