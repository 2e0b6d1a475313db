// SAGAN attention flash backward, the VJP of O = softmax(Q K^T) V from the
// forward's stored (O, lse), for Hopper (sm_90a).
//
// Replaces three TPU kernels of sagan_tpu/ops/pallas_attention.py, the
// backward of the flash path (key sets too large for VMEM), on fp32
// operands, and on bf16 where a caller names engine="fma" (the tile
// studies' -D builds and chip_smoke time them there); bf16's own engine
// runs all three on the tensor cores (attention_flash_mma.cu):
//  * _flash_dq_kernel (launched by _flash_bwd): dQ, key blocks innermost
//    -> attention_flash_dq_kernel (K4);
//  * _flash_dkv_kernel (launched by _flash_bwd): dK, dV, query blocks
//    innermost -> attention_flash_dkv_kernel (K5);
//  * _flash_dqkv_kernel (launched by _flash_bwd_fused): all three from one
//    score recompute, dQ as per-key-block partials summed afterwards
//    -> attention_flash_dqkv_kernel (K6).
// Same function, with the probabilities exact from the stored lse (no
// running max, no 1/l) and the flash identity for delta:
//
//   p_ij = exp(q_i . k_j - lse_i)     delta_i = g_i . o_i   (fp32, in-kernel)
//   dl_ij = p_ij (g_i . v_j - delta_i)
//   dq_i = sum_j dl_ij k_j   dk_j = sum_i dl_ij q_i   dv_j = sum_i p_ij g_i
//
// all in fp32, dq written in q's type and dk, dv summed in fp32 registers
// and written once in k's and v's types.  Operands are bf16 or fp32, all
// of one type; lse is fp32.  Row-major:
//
//   q [B, N, D]  k [B, M, D]  v [B, M, C]  g, o [B, N, C]  lse [B, N]
//   -> dq [B, N, D] (K4) | dk [B, M, D], dv [B, M, C] (K5)
//   -> dk, dv and dq partials fp32 [B, NKB, N, D] (K6, NKB key blocks)
//
// What differs from the TPU: there the grid runs in order on one core, so
// the kernels sum dQ across key blocks, and dK/dV across query blocks, in
// an output block that stays resident.  On Hopper blocks run in parallel
// and in no order, so every sum is owned by one thread or one block and
// nothing is accumulated with atomics (the same bits every run):
//  (K4) query-major, one thread per query row, K/V walked in shared-memory
//       tiles as in the forward (attention_fwd.cu); dq in registers,
//       summed per tile, per 1024-key group, then over the groups.
//  (K5) key-major, kThreads threads per block, each owning KPT keys (k, v,
//       dk, dv in registers; several keys a thread at narrow widths, so a
//       staged query row is reused from registers), query rows walked in
//       shared-memory tiles with their lse and delta; no rescaling since p
//       is exact.
//  (K6) K5's loop, and each (query row, key) pair's dl k_j summed over the
//       block's keys: over a thread's keys in registers, over a warp's
//       lanes by shuffles, over the warps through shared memory; each
//       block writes its partial dq row once.  The TPU kernel wrote the
//       same per-key-block partials to an HBM slab and let XLA sum them;
//       here the caller sums them (torch.sum).  The partial buffer is
//       B * NKB * N * D * 4 bytes: at the church512 512-map site (B=4,
//       N=262144, M=65536, D=2) with KB = 1024 keys per block, 537 MB,
//       where 128 keys per block would need 4.3 GB.
//  delta is computed in each kernel from g and o, as the TPU kernels do
//  (a warp per staged row in K5/K6, the row's thread in K4).
//
// What bounds it on the H100: as in the forward, the contractions are D
// and C deep (2..32 and 8..128), far too thin for the tensor cores, so
// all three run fp32 FMAs on the CUDA cores.  Per (query, key) pair K4
// does 2D + C FMAs, K5 2D + 2C, K6 3D + 2C, and each one exponential: at
// the 512-map site (6.9e10 pairs at B=4, D=2, C=8) K6 is 1.5e12 FMAs
// (~45 ms at the 67 TFLOP/s fp32 peak) and 6.9e10 exponentials (~16 ms on
// the SFUs), against ~50 MB of traffic in bf16 (~15 us) and ~1 GB for the
// partials (~0.3 ms): CUDA-core arithmetic binds.
//
// The value width C is fixed per build (-DSAGAN_ATTN_C=8, 16, ...), one
// small library per width holding all three kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef SAGAN_ATTN_C
#error "build with -DSAGAN_ATTN_C=<value width>"
#endif

namespace {

// The tiles may be set at build time for the tile studies
// (sagan_tpu_torch/tools/bench_attn_bwd256.py, bench_attn_floor512.py):
// -DSAGAN_BWD_ROWS=, -DSAGAN_BWD_KEY_TILE= (K4), -DSAGAN_BWD_THREADS= and
// -DSAGAN_BWD_KPT= (K5/K6, keys a thread at the narrowest widths,
// D + C <= 10). The defaults below are the shipped kernels.
#ifdef SAGAN_BWD_ROWS
constexpr int kRows = SAGAN_BWD_ROWS;
#else
constexpr int kRows = 64;  // K4: query rows per block, one per thread
#endif
#ifdef SAGAN_BWD_KEY_TILE
constexpr int kKeyTile = SAGAN_BWD_KEY_TILE;
#else
// K4: keys per shared-memory tile
constexpr int kKeyTile = SAGAN_ATTN_C >= 64 ? 16 : 32;
#endif
// K4: tiles a dq group sums; the 1,024-key groups set the numerics and
// stay fixed whatever the tile
constexpr int kGroupTiles = 1024 / kKeyTile;
static_assert(1024 % kKeyTile == 0, "kKeyTile must divide 1024");
#ifdef SAGAN_BWD_THREADS
constexpr int kThreads = SAGAN_BWD_THREADS;
#else
constexpr int kThreads = 256;  // K5/K6: threads per block
#endif
#ifdef SAGAN_BWD_KPT
constexpr int kNarrowKeys = SAGAN_BWD_KPT;
#else
constexpr int kNarrowKeys = 4;
#endif
constexpr int kWarps = kThreads / 32;
static_assert(kRows % 32 == 0 && kRows <= 1024, "kRows: whole warps");
static_assert(kThreads % 32 == 0 && kThreads <= 1024,
              "kThreads: whole warps");

// K5/K6: keys each thread owns; narrow rows keep several keys' k, v, dk
// and dv in registers (20 floats a key at D=2, C=8)
template <int D, int C>
__host__ __device__ constexpr int keys_per_thread() {
  return D + C <= 10 ? kNarrowKeys : D + C <= 20 ? 2 : 1;
}
// K5/K6: query rows per shared-memory tile (the widest D halves it to
// keep the per-warp dq sums within 48 KB of static shared memory)
template <int D>
__host__ __device__ constexpr int query_tile() {
  return D >= 32 ? 16 : 32;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// K4: dq from (o, lse); one thread per query row.
template <typename T, int D, int C>
__global__ void __launch_bounds__(kRows)
    attention_flash_dq_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ g,
                              const T* __restrict__ o,
                              const float* __restrict__ lse,
                              T* __restrict__ dq, int n, int m) {
  static_assert(kKeyTile * (D + C) * sizeof(float) <= 48 * 1024,
                "K/V tile past the 48 KB of static shared memory");
  __shared__ float ks[kKeyTile][D];
  __shared__ float vs[kKeyTile][C];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const T* kb = k + (size_t)b * m * D;
  const T* vb = v + (size_t)b * m * C;
  const size_t r = (size_t)b * n + (live ? row : 0);

  float qr[D], gr[C];
  float delta = 0.f;  // g . o in fp32, from o as stored
#pragma unroll
  for (int i = 0; i < D; ++i) qr[i] = live ? to_f32(q[r * D + i]) : 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    gr[i] = live ? to_f32(g[r * C + i]) : 0.f;
    delta = fmaf(gr[i], live ? to_f32(o[r * C + i]) : 0.f, delta);
  }
  // rows past N: lse +inf makes every p exp(-inf) = 0
  const float lr = live ? lse[r] : INFINITY;

  // dq in three levels: a tile's terms, a group of kGroupTiles tiles
  // (1024 keys, K6's key block at the 512 map), then the groups.  One
  // running sum over 65,536 keys lost the terms far below it: at the
  // 512 map that put dq ~1e-4 relative off its float64 value.
  float acc[D], grp[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = grp[i] = 0.f;

  for (int t0 = 0; t0 < m; t0 += kKeyTile) {
    const int tm = min(kKeyTile, m - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kKeyTile * D; i += kRows)
      ks[i / D][i % D] = i < tm * D ? to_f32(kb[(size_t)t0 * D + i]) : 0.f;
    for (int i = threadIdx.x; i < kKeyTile * C; i += kRows)
      vs[i / C][i % C] = i < tm * C ? to_f32(vb[(size_t)t0 * C + i]) : 0.f;
    __syncthreads();

    float tile[D];
#pragma unroll
    for (int i = 0; i < D; ++i) tile[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kKeyTile; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) s = fmaf(qr[i], ks[j][i], s);
      const float p = j < tm ? __expf(s - lr) : 0.f;  // keys past M: 0
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) dp = fmaf(gr[i], vs[j][i], dp);
      const float dl = p * (dp - delta);
#pragma unroll
      for (int i = 0; i < D; ++i) tile[i] = fmaf(dl, ks[j][i], tile[i]);
    }
#pragma unroll
    for (int i = 0; i < D; ++i) grp[i] += tile[i];
    if ((t0 / kKeyTile) % kGroupTiles == kGroupTiles - 1) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        acc[i] += grp[i];
        grp[i] = 0.f;
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < D; ++i) store(dq + r * D + i, acc[i] + grp[i]);
  }
}

// K5 (kDq false) and K6 (kDq true): key-major; thread t of block x owns
// keys x * KB + t + s * kThreads, s < KPT (KB = kThreads * KPT), so the
// loads of k and v are coalesced.
template <typename T, int D, int C, bool kDq>
__device__ __forceinline__ void flash_kv(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const T* __restrict__ o, const float* __restrict__ lse,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_part,
    int n, int m) {
  constexpr int KPT = keys_per_thread<D, C>();
  constexpr int KB = kThreads * KPT;
  constexpr int TQ = query_tile<D>();
  static_assert((TQ * (D + C + 2) + (kDq ? kWarps : 1) * TQ * D) *
                        sizeof(float) <= 48 * 1024,
                "query tile past the 48 KB of static shared memory");
  __shared__ float qs[TQ][D];
  __shared__ float gs[TQ][C];
  __shared__ float ls[TQ];  // lse of the staged rows (+inf past N)
  __shared__ float ds[TQ];  // delta of the staged rows (0 past N)
  __shared__ float red[kDq ? kWarps : 1][TQ][D];  // per-warp dq sums

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* qb = q + (size_t)b * n * D;
  const T* gb = g + (size_t)b * n * C;
  const T* ob = o + (size_t)b * n * C;
  const float* lb = lse + (size_t)b * n;

  float kr[KPT][D], vr[KPT][C], dkr[KPT][D], dvr[KPT][C];
  bool live[KPT];
#pragma unroll
  for (int s = 0; s < KPT; ++s) {
    const int col = blockIdx.x * KB + threadIdx.x + s * kThreads;
    live[s] = col < m;
    const size_t r = (size_t)b * m + (live[s] ? col : 0);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      kr[s][i] = live[s] ? to_f32(k[r * D + i]) : 0.f;
      dkr[s][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      vr[s][i] = live[s] ? to_f32(v[r * C + i]) : 0.f;
      dvr[s][i] = 0.f;
    }
  }

  for (int t0 = 0; t0 < n; t0 += TQ) {
    const int tn = min(TQ, n - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < TQ * D; i += kThreads)
      qs[i / D][i % D] = i < tn * D ? to_f32(qb[(size_t)t0 * D + i]) : 0.f;
    for (int i = threadIdx.x; i < TQ * C; i += kThreads)
      gs[i / C][i % C] = i < tn * C ? to_f32(gb[(size_t)t0 * C + i]) : 0.f;
    // delta_j = g_j . o_j, one warp a row
    for (int j = warp; j < TQ; j += kWarps) {
      float part = 0.f;
      if (j < tn) {
        const size_t base = (size_t)(t0 + j) * C;
        for (int i = lane; i < C; i += 32)
          part = fmaf(to_f32(gb[base + i]), to_f32(ob[base + i]), part);
      }
      part = warp_sum(part);
      if (lane == 0) {
        ds[j] = part;
        ls[j] = j < tn ? lb[t0 + j] : INFINITY;
      }
    }
    __syncthreads();

    for (int j = 0; j < TQ; ++j) {
      float dqr[D];
#pragma unroll
      for (int i = 0; i < D; ++i) dqr[i] = 0.f;
#pragma unroll
      for (int s = 0; s < KPT; ++s) {
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) sc = fmaf(qs[j][i], kr[s][i], sc);
        const float p = live[s] ? __expf(sc - ls[j]) : 0.f;
        float dp = 0.f;
#pragma unroll
        for (int i = 0; i < C; ++i) dp = fmaf(gs[j][i], vr[s][i], dp);
        const float dl = p * (dp - ds[j]);
#pragma unroll
        for (int i = 0; i < D; ++i) dkr[s][i] = fmaf(dl, qs[j][i], dkr[s][i]);
#pragma unroll
        for (int i = 0; i < C; ++i) dvr[s][i] = fmaf(p, gs[j][i], dvr[s][i]);
        if constexpr (kDq) {
#pragma unroll
          for (int i = 0; i < D; ++i) dqr[i] = fmaf(dl, kr[s][i], dqr[i]);
        }
      }
      if constexpr (kDq) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float sum = warp_sum(dqr[i]);
          if (lane == 0) red[warp][j][i] = sum;
        }
      }
    }

    if constexpr (kDq) {
      __syncthreads();  // every warp's sums are in red
      float* out = dq_part + ((size_t)(b * gridDim.x + blockIdx.x) * n +
                              t0) * D;
      for (int e = threadIdx.x; e < tn * D; e += kThreads) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[w][e / D][e % D];
        out[e] = sum;
      }
    }
  }

#pragma unroll
  for (int s = 0; s < KPT; ++s) {
    if (!live[s]) continue;
    const size_t r =
        (size_t)b * m + blockIdx.x * KB + threadIdx.x + s * kThreads;
#pragma unroll
    for (int i = 0; i < D; ++i) store(dk + r * D + i, dkr[s][i]);
#pragma unroll
    for (int i = 0; i < C; ++i) store(dv + r * C + i, dvr[s][i]);
  }
}

template <typename T, int D, int C>
__global__ void __launch_bounds__(kThreads)
    attention_flash_dkv_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ g,
                               const T* __restrict__ o,
                               const float* __restrict__ lse,
                               T* __restrict__ dk, T* __restrict__ dv, int n,
                               int m) {
  flash_kv<T, D, C, false>(q, k, v, g, o, lse, dk, dv, nullptr, n, m);
}

template <typename T, int D, int C>
__global__ void __launch_bounds__(kThreads)
    attention_flash_dqkv_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ g,
                                const T* __restrict__ o,
                                const float* __restrict__ lse,
                                T* __restrict__ dk, T* __restrict__ dv,
                                float* __restrict__ dq_part, int n, int m) {
  flash_kv<T, D, C, true>(q, k, v, g, o, lse, dk, dv, dq_part, n, m);
}

enum Which { kDqOnly = 0, kDkvOnly = 1, kFused = 2 };

struct Args {
  const void *q, *k, *v, *g, *o;
  const float* lse;
  void *dq, *dk, *dv;
  float* dq_part;
  int b, n, m;
};

template <typename T, int D>
cudaError_t launch(Which which, const Args& a, cudaStream_t stream) {
  constexpr int C = SAGAN_ATTN_C;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  const T* o = static_cast<const T*>(a.o);
  constexpr int KB = kThreads * keys_per_thread<D, C>();
  const dim3 kv_grid((a.m + KB - 1) / KB, a.b);
  switch (which) {
    case kDqOnly:
      attention_flash_dq_kernel<T, D, C>
          <<<dim3((a.n + kRows - 1) / kRows, a.b), kRows, 0, stream>>>(
              q, k, v, g, o, a.lse, static_cast<T*>(a.dq), a.n, a.m);
      break;
    case kDkvOnly:
      attention_flash_dkv_kernel<T, D, C><<<kv_grid, kThreads, 0, stream>>>(
          q, k, v, g, o, a.lse, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.n, a.m);
      break;
    case kFused:
      attention_flash_dqkv_kernel<T, D, C><<<kv_grid, kThreads, 0, stream>>>(
          q, k, v, g, o, a.lse, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.dq_part, a.n, a.m);
      break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which which, const Args& a, int d,
                       cudaStream_t stream) {
  switch (d) {
    case 2: return launch<T, 2>(which, a, stream);
    case 4: return launch<T, 4>(which, a, stream);
    case 8: return launch<T, 8>(which, a, stream);
    case 16: return launch<T, 16>(which, a, stream);
    case 32: return launch<T, 32>(which, a, stream);
  }
  return cudaErrorInvalidValue;
}

int run(Which which, const Args& a, int d, int c, int is_bf16,
        void* stream) {
  if (c != SAGAN_ATTN_C) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(which, a, d, st)
                 : dispatch_d<float>(which, a, d, st);
}

}  // namespace

// Each launches one kernel on `stream` and returns cudaGetLastError() (0
// on success).  `is_bf16` selects bf16 operands, else fp32 (lse is fp32
// either way); `c` must be SAGAN_ATTN_C.  The caller checks shapes,
// contiguity and the supported D before calling.

// K4: dq [B, N, D].
extern "C" int sagan_attention_flash_dq(const void* q, const void* k,
                                        const void* v, const void* g,
                                        const void* o, const void* lse,
                                        void* dq, int b, int n, int m, int d,
                                        int c, int is_bf16, void* stream) {
  const Args a{q, k, v, g, o, static_cast<const float*>(lse), dq, nullptr,
               nullptr, nullptr, b, n, m};
  return run(kDqOnly, a, d, c, is_bf16, stream);
}

// K5: dk [B, M, D], dv [B, M, C].
extern "C" int sagan_attention_flash_dkv(const void* q, const void* k,
                                         const void* v, const void* g,
                                         const void* o, const void* lse,
                                         void* dk, void* dv, int b, int n,
                                         int m, int d, int c, int is_bf16,
                                         void* stream) {
  const Args a{q, k, v, g, o, static_cast<const float*>(lse), nullptr, dk,
               dv, nullptr, b, n, m};
  return run(kDkvOnly, a, d, c, is_bf16, stream);
}

// K6: dk, dv and the dq partials, fp32 [B, NKB, N, D] with NKB =
// ceil(M / sagan_attention_flash_keys_per_block(d)), every element
// written.
extern "C" int sagan_attention_flash_dqkv(const void* q, const void* k,
                                          const void* v, const void* g,
                                          const void* o, const void* lse,
                                          void* dk, void* dv, void* dq_part,
                                          int b, int n, int m, int d, int c,
                                          int is_bf16, void* stream) {
  const Args a{q, k, v, g, o, static_cast<const float*>(lse), nullptr, dk,
               dv, static_cast<float*>(dq_part), b, n, m};
  return run(kFused, a, d, c, is_bf16, stream);
}

// Keys per block of K5 and K6 at head width d (0 for an unsupported d).
extern "C" int sagan_attention_flash_keys_per_block(int d) {
  constexpr int C = SAGAN_ATTN_C;
  switch (d) {
    case 2: return kThreads * keys_per_thread<2, C>();
    case 4: return kThreads * keys_per_thread<4, C>();
    case 8: return kThreads * keys_per_thread<8, C>();
    case 16: return kThreads * keys_per_thread<16, C>();
    case 32: return kThreads * keys_per_thread<32, C>();
  }
  return 0;
}
