// SAGAN attention backward, the VJP of O = softmax(Q K^T) V, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sagan_tpu/ops/pallas_attention.py::_bwd_kernel
// (launched by _bwd_call, the custom-VJP backward of attention_fused).
// Same function: logits are UNSCALED, the softmax is recomputed from
// (q, k, v) rather than stored, all arithmetic is fp32, and
//
//   P = softmax(Q K^T)      dP = G V^T      delta_i = sum_j P_ij dP_ij
//   dL = P (.) (dP - delta)  dQ = dL K   dK = dL^T Q   dV = P^T G
//
// with dq written in q's type and dk, dv summed in fp32 and written once
// in k's and v's types.  Operands are bf16 or fp32, all four of one type.
//
//   q [B, N, D]  k [B, M, D]  v [B, M, C]  g [B, N, C]   (row-major)
//   -> dq [B, N, D]  dk [B, M, D]  dv [B, M, C]
//
// What differs from the TPU: there the grid runs in order on one core, so
// the kernel accumulated dK/dV across query blocks in a resident output
// block.  On Hopper blocks run in parallel and in no order, so the sum
// over queries is split into two deterministic kernels (no atomics, the
// same bits every run):
//
//  (a) query-major, one thread per query row, K/V walked in shared-memory
//      tiles as in the forward (attention_fwd.cu).  One pass with online
//      rescaling: with e_j = exp(s_j - max), dp_j = g_i . v_j,
//        l = sum e_j,  A = sum e_j dp_j,  S1 = sum e_j dp_j k_j,
//        S2 = sum e_j k_j      (all rescaled when the running max moves)
//      then delta = A / l and dq = (S1 - delta S2) / l.  It also writes
//      the row's final max, 1/l and delta as fp32 [B, N] statistics.
//  (b) key-major, one thread per key row j, query rows walked in
//      shared-memory tiles with their statistics.  The probabilities are
//      exact (final max and 1/l), so there is no rescaling:
//        p = exp(q_i . k_j - max_i) / l_i,   dl = p (g_i . v_j - delta_i)
//        dk += dl q_i,   dv += p g_i        (fp32 registers, written once)
//
// What bounds it on the H100: as in the forward, the contractions are D
// and C deep (2..32 and 8..128), far too thin for the tensor cores, so
// both kernels run fp32 FMAs on the CUDA cores.  Per (query, key) pair:
// (a) does 3D + C FMAs and one exponential, (b) 2D + 2C FMAs and one
// exponential.  At the church64 64-map site (B=64, N=4096, M=1024, D=2,
// C=8) that is 9.1e9 FMAs (~0.27 ms at the 67 TFLOP/s fp32 peak) and
// 5.4e8 exponentials (~0.13 ms on the SFUs), against ~20 MB of traffic in
// bf16 with the row statistics (~6 us): CUDA-core arithmetic binds, as it
// does for the forward.
//
// The value width C is fixed per build (-DSAGAN_ATTN_C=8, 16, ...), one
// small library per width like the forward, so the widths build in
// parallel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef SAGAN_ATTN_C
#error "build with -DSAGAN_ATTN_C=<value width>"
#endif

namespace {

constexpr int kRows = 64;  // rows per block, one per thread (both kernels)
// keys per shared-memory tile in (a): wide values keep fewer logits in
// registers beside S1, S2, g
constexpr int kKeyTile = SAGAN_ATTN_C >= 64 ? 16 : 32;
constexpr int kQueryTile = 32;  // query rows per shared-memory tile in (b)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// (a): dq and the row statistics (max, 1/l, delta), stats [3][B][N].
template <typename T, int D, int C>
__global__ void __launch_bounds__(kRows)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            T* __restrict__ dq, float* __restrict__ stats,
                            int b_total, int n, int m) {
  __shared__ float ks[kKeyTile][D];
  __shared__ float vs[kKeyTile][C];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const T* kb = k + (size_t)b * m * D;
  const T* vb = v + (size_t)b * m * C;
  const size_t r = (size_t)b * n + (live ? row : 0);

  float qr[D], gr[C];
#pragma unroll
  for (int i = 0; i < D; ++i) qr[i] = live ? to_f32(q[r * D + i]) : 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) gr[i] = live ? to_f32(g[r * C + i]) : 0.f;

  float s1[D], s2[D];
#pragma unroll
  for (int i = 0; i < D; ++i) s1[i] = s2[i] = 0.f;
  float mx = -INFINITY;  // running max of the logits seen so far
  float l = 0.f;         // running sum of e_j
  float a = 0.f;         // running sum of e_j dp_j

  for (int t0 = 0; t0 < m; t0 += kKeyTile) {
    const int tm = min(kKeyTile, m - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kKeyTile * D; i += kRows)
      ks[i / D][i % D] = i < tm * D ? to_f32(kb[(size_t)t0 * D + i]) : 0.f;
    for (int i = threadIdx.x; i < kKeyTile * C; i += kRows)
      vs[i / C][i % C] = i < tm * C ? to_f32(vb[(size_t)t0 * C + i]) : 0.f;
    __syncthreads();

    float s[kKeyTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeyTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) dot = fmaf(qr[i], ks[j][i], dot);
      s[j] = j < tm ? dot : -INFINITY;  // keys past M weigh exp(-inf) = 0
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(mx, tile_max);
    const float scale = __expf(mx - m_new);  // 0 on the first tile
    l *= scale;
    a *= scale;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      s1[i] *= scale;
      s2[i] *= scale;
    }
#pragma unroll
    for (int j = 0; j < kKeyTile; ++j) {
      const float e = __expf(s[j] - m_new);
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) dp = fmaf(gr[i], vs[j][i], dp);
      const float edp = e * dp;
      l += e;
      a += edp;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        s1[i] = fmaf(edp, ks[j][i], s1[i]);
        s2[i] = fmaf(e, ks[j][i], s2[i]);
      }
    }
    mx = m_new;
  }

  if (live) {
    const float linv = 1.f / l;
    const float delta = a * linv;
#pragma unroll
    for (int i = 0; i < D; ++i)
      store(dq + r * D + i, (s1[i] - delta * s2[i]) * linv);
    const size_t plane = (size_t)b_total * n;
    stats[r] = mx;
    stats[plane + r] = linv;
    stats[2 * plane + r] = delta;
  }
}

// (b): dk and dv from the statistics of (a).
template <typename T, int D, int C>
__global__ void __launch_bounds__(kRows)
    attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             const float* __restrict__ stats,
                             T* __restrict__ dk, T* __restrict__ dv,
                             int b_total, int n, int m) {
  __shared__ float qs[kQueryTile][D];
  __shared__ float gs[kQueryTile][C];
  __shared__ float st[3][kQueryTile];

  const int b = blockIdx.y;
  const int col = blockIdx.x * kRows + threadIdx.x;
  const bool live = col < m;
  const T* qb = q + (size_t)b * n * D;
  const T* gb = g + (size_t)b * n * C;
  const size_t plane = (size_t)b_total * n;
  const float* stb = stats + (size_t)b * n;
  const size_t r = (size_t)b * m + (live ? col : 0);

  float kr[D], vr[C];
#pragma unroll
  for (int i = 0; i < D; ++i) kr[i] = live ? to_f32(k[r * D + i]) : 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) vr[i] = live ? to_f32(v[r * C + i]) : 0.f;

  float dkr[D], dvr[C];
#pragma unroll
  for (int i = 0; i < D; ++i) dkr[i] = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) dvr[i] = 0.f;

  for (int t0 = 0; t0 < n; t0 += kQueryTile) {
    const int tn = min(kQueryTile, n - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kQueryTile * D; i += kRows)
      qs[i / D][i % D] = i < tn * D ? to_f32(qb[(size_t)t0 * D + i]) : 0.f;
    for (int i = threadIdx.x; i < kQueryTile * C; i += kRows)
      gs[i / C][i % C] = i < tn * C ? to_f32(gb[(size_t)t0 * C + i]) : 0.f;
    for (int i = threadIdx.x; i < 3 * kQueryTile; i += kRows) {
      const int which = i / kQueryTile, j = i % kQueryTile;
      // rows past N get max +inf: exp(s - inf) = 0, so they add nothing
      st[which][j] = j < tn ? stb[which * plane + t0 + j]
                            : (which == 0 ? INFINITY : 0.f);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kQueryTile; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) s = fmaf(qs[j][i], kr[i], s);
      const float p = __expf(s - st[0][j]) * st[1][j];
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) dp = fmaf(gs[j][i], vr[i], dp);
      const float dl = p * (dp - st[2][j]);
#pragma unroll
      for (int i = 0; i < D; ++i) dkr[i] = fmaf(dl, qs[j][i], dkr[i]);
#pragma unroll
      for (int i = 0; i < C; ++i) dvr[i] = fmaf(p, gs[j][i], dvr[i]);
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < D; ++i) store(dk + r * D + i, dkr[i]);
#pragma unroll
    for (int i = 0; i < C; ++i) store(dv + r * C + i, dvr[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, void* dq, void* dk, void* dv, float* stats,
                   int b, int n, int m, cudaStream_t stream) {
  constexpr int C = SAGAN_ATTN_C;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(g);
  attention_bwd_dq_kernel<T, D, C><<<dim3((n + kRows - 1) / kRows, b), kRows,
                                     0, stream>>>(
      q_, k_, v_, g_, static_cast<T*>(dq), stats, b, n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<T, D, C><<<dim3((m + kRows - 1) / kRows, b),
                                      kRows, 0, stream>>>(
      q_, k_, v_, g_, stats, static_cast<T*>(dk), static_cast<T*>(dv), b, n,
      m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* g, void* dq, void* dk, void* dv,
                       float* stats, int b, int n, int m, int d,
                       cudaStream_t stream) {
  switch (d) {
    case 2: return launch<T, 2>(q, k, v, g, dq, dk, dv, stats, b, n, m, stream);
    case 4: return launch<T, 4>(q, k, v, g, dq, dk, dv, stats, b, n, m, stream);
    case 8: return launch<T, 8>(q, k, v, g, dq, dk, dv, stats, b, n, m, stream);
    case 16:
      return launch<T, 16>(q, k, v, g, dq, dk, dv, stats, b, n, m, stream);
    case 32:
      return launch<T, 32>(q, k, v, g, dq, dk, dv, stats, b, n, m, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() after
// each (0 on success).  `stats` is fp32 scratch of 3 * b * n floats.
// `is_bf16` selects bf16 operands, else fp32; `c` must be SAGAN_ATTN_C.
// The caller checks shapes, contiguity and the supported D before calling.
extern "C" int sagan_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* g, void* dq,
                                   void* dk, void* dv, void* stats, int b,
                                   int n, int m, int d, int c, int is_bf16,
                                   void* stream) {
  if (c != SAGAN_ATTN_C) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(stats);
  return is_bf16
             ? dispatch_d<__nv_bfloat16>(q, k, v, g, dq, dk, dv, s, b, n, m,
                                         d, st)
             : dispatch_d<float>(q, k, v, g, dq, dk, dv, s, b, n, m, d, st);
}
