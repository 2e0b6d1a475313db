// SAGAN attention forward, O = softmax(Q K^T) V, for Hopper (sm_90a).
//
// Replaces the TPU kernel sagan_tpu/ops/pallas_attention.py::_fwd_kernel
// (launched by _fwd, behind attention_fused).  Same function: logits are
// UNSCALED (no 1/sqrt(d)), the softmax runs in fp32, accumulation is fp32
// and the output is written in the input type.  Operands are bf16 or fp32,
// all three of one type.
//
//   q [B, N, D]   k [B, M, D]   v [B, M, C]   ->   o [B, N, C], row-major.
//
// What bounds it on the H100: at SAGAN's head widths (D = 2..32) the
// contractions are far too thin for the tensor cores to help without
// padding D to 16, so this kernel runs them as fp32 FMAs on the CUDA cores.
// Per (query, key) pair it does D + C FMAs and one exponential: at the
// church64 64-map site (B=64, N=4096, M=1024, D=2, C=8) that is 2.7e9 FMAs
// (~80 us at the 67 TFLOP/s fp32 peak) and 2.7e8 exponentials (~64 us on
// the SFUs at 16 per clock per SM), against ~2 us to move its 6.6 MB.  So
// the floor of this design is the CUDA-core arithmetic, not memory.
//
// Design (first port: simple and right, not yet fast):
//  * one block per (tile of kRows query rows, batch element), one thread
//    per query row; the row's q lives in registers;
//  * the TPU kernel held all of K/V resident in VMEM; here K/V are walked
//    in tiles of kTile (32) keys staged (as fp32) in shared memory, so the
//    kernel is right for any M and the key-blocked flash forward can
//    reuse it;
//  * an online softmax over the key tiles: running max, running sum and
//    fp32 acc[C] in registers, one rescale per tile, acc / l at the end
//    (the TPU kernel also divides the skinny [N, C] side, not the
//    probabilities).
//
// The value width C is fixed per build (-DSAGAN_ATTN_C=8, 16, ...): each
// width is its own small library, so the widths build in parallel and a
// run builds only the widths it uses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef SAGAN_ATTN_C
#error "build with -DSAGAN_ATTN_C=<value width>"
#endif

namespace {

constexpr int kRows = 64;  // query rows per block, one per thread
// keys staged in shared memory per step; wide values keep fewer logits
// in registers beside acc[C] (and build in half the time)
constexpr int kTile = SAGAN_ATTN_C >= 64 ? 16 : 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, int C>
__global__ void __launch_bounds__(kRows)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int n,
                         int m) {
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
    l *= scale;
#pragma unroll
    for (int i = 0; i < C; ++i) acc[i] *= scale;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = __expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] = fmaf(p, vs[j][i], acc[i]);
    }
    mx = m_new;
  }

  if (live) {
    T* orow = o + ((size_t)b * n + row) * C;
#pragma unroll
    for (int i = 0; i < C; ++i) store(orow + i, acc[i] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int n, int m, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, b);
  attention_fwd_kernel<T, D, SAGAN_ATTN_C><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int b, int n, int m, int d, cudaStream_t stream) {
  switch (d) {
    case 2: return launch<T, 2>(q, k, v, o, b, n, m, stream);
    case 4: return launch<T, 4>(q, k, v, o, b, n, m, stream);
    case 8: return launch<T, 8>(q, k, v, o, b, n, m, stream);
    case 16: return launch<T, 16>(q, k, v, o, b, n, m, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, n, m, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `is_bf16` selects bf16 operands, else fp32; `c` must be SAGAN_ATTN_C.
// The caller checks shapes, contiguity and the supported D before calling.
extern "C" int sagan_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int n,
                                   int m, int d, int c, int is_bf16,
                                   void* stream) {
  if (c != SAGAN_ATTN_C) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, b, n, m, d, st)
                 : dispatch_d<float>(q, k, v, o, b, n, m, d, st);
}
