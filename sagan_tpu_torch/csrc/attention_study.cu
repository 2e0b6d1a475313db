// SAGAN attention study forward for Hopper (sm_90a), its CUDA-core engine:
// the variants of the attention floor studies, O = softmax(Q K^T) V with
// unscaled logits, at the widths of every study shape, d = 2 and c = 8:
//
//   q [B, N, 2]   k [B, M, 2]   v [B, M, 8]   ->   o [B, N, 8], row-major,
//   all in the input type (bf16 or fp32).
//
// Replaces, with the tensor-core variants, the TPU study kernels of
// tools/bench_attn_floor.py (_call :82 with the bodies k_current :98,
// k_vpu_scores :110, k_exp2 :124, k_nomax :136, k_noexp :147, k_e16 :159,
// k_ev_vpu :216) and the stripped-math flash floors of
// tools/bench_attn_floor256.py (_floor_kernel :132, also run by
// tools/bench_attn_floor512.py :137). Each variant removes or moves one
// candidate bottleneck of the shipped forward (K1/K3), so that its time
// beside K1's says what that part costs on this card.
//
// The variants have two engines (ops/cuda_attention_study.py):
//  * fma, here: K1's key-tiled online-softmax loop (attention_fwd.cu), one
//    thread a query row on the CUDA cores, fp32 P in E.V. With the default
//    math it issues K1's operations in K1's order and computes K1's bits.
//  * mma, not here: the tensor-core variants are builds of the shipped
//    bf16 K1/K3 body (attention_flash_mma.cu fwd_mma_body) with the
//    variant's math switched at build time (-DSAGAN_MMA_MATH=,
//    -DSAGAN_MMA_FMA_SCORES=1); mma_exp2 is the shipped kernel itself.
//
// The math of each variant (the plain versions in ops/attention_study.py
// compute the same):
//  exp    e = exp(s - m), online max with one rescale a tile;
//  exp2   e = exp2(s log2e - m log2e);
//  nomax  e = exp(s), no max and no rescale (also the T3/T5 "nomaxcorr"
//         floor, whose max stays -inf and whose correction is 1);
//  noexp  NOT attention: T1's e = s - M with M the row's max over all keys,
//         o = sum e v / sum e. Since e is linear in s, the kernel keeps
//         sum s v, sum s, sum v and the running max and forms
//         o = (sum s v - M sum v) / (sum s - M count) at the end: no
//         transcendental and no second pass (the TPU's flash "noexp" floor
//         was NaN: its 0 * -inf correction);
//  e16    P rounded to bf16 before both the row sum and E.V.
//
// What bounds it: at d = 2 and c = 8 each (query, key) pair costs one
// exponential on the SFUs (16 a clock an SM) and ~14 fp32 instructions on
// the CUDA cores; the bytes are a few MB.
//
// The tiles take K1's defines (-DSAGAN_FWD_ROWS=, -DSAGAN_FWD_TILE=), so
// the floors run at any of K1's tile points.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 2;  // query/key width of every study shape
constexpr int C = 8;  // value width of every study shape
constexpr float kLog2e = 1.4426950408889634f;

enum Math { kExp = 0, kExp2 = 1, kNoMax = 2, kNoExp = 3, kE16 = 4 };

// the fma variants, first in ops/attention_study.py VARIANTS
enum Variant { kFma = 0, kFmaExp2, kFmaNoMax, kFmaNoExp, kFmaE16, kVariants };

#ifdef SAGAN_FWD_ROWS
constexpr int kRows = SAGAN_FWD_ROWS;
#else
constexpr int kRows = 64;  // query rows per block, one per thread (K1's)
#endif
#ifdef SAGAN_FWD_TILE
constexpr int kTile = SAGAN_FWD_TILE;
#else
constexpr int kTile = 32;  // keys staged per step (K1's at c = 8)
#endif
static_assert(kRows % 32 == 0 && kRows <= 1024, "kRows: whole warps");
static_assert(kRows % C == 0, "noexp: a thread stages one channel of v");
static_assert(kTile * (D + C) * sizeof(float) <= 48 * 1024,
              "K/V tile past the 48 KB of static shared memory");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, int kMath>
__global__ void __launch_bounds__(kRows)
    study_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int n,
                     int m) {
  __shared__ float ks[kTile][D];
  __shared__ float vs[kTile][C];
  __shared__ float vred[kMath == kNoExp ? kRows : 1];  // noexp: sum v

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const T* kb = k + (size_t)b * m * D;
  const T* vb = v + (size_t)b * m * C;

  float qr[D];
  const T* qrow = q + ((size_t)b * n + (live ? row : 0)) * D;
#pragma unroll
  for (int i = 0; i < D; ++i) qr[i] = live ? to_f32(qrow[i]) : 0.f;

  float acc[C];  // sum e v (noexp: sum s v)
#pragma unroll
  for (int i = 0; i < C; ++i) acc[i] = 0.f;
  float mx = -INFINITY;  // running max of the logits seen so far
  float nmx = INFINITY;  // exp2: -mx * log2e as rounded
  float l = 0.f;         // running sum of e (noexp: sum s)
  // noexp: this thread's share of sum v: the values it stages are all of
  // channel threadIdx.x % C (kRows is a multiple of C)
  float vpart = 0.f;

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tm = min(kTile, m - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kTile * D; i += kRows)
      ks[i / D][i % D] = i < tm * D ? to_f32(kb[(size_t)t0 * D + i]) : 0.f;
    for (int i = threadIdx.x; i < kTile * C; i += kRows) {
      const float x = i < tm * C ? to_f32(vb[(size_t)t0 * C + i]) : 0.f;
      vs[i / C][i % C] = x;
      if constexpr (kMath == kNoExp) vpart += x;
    }
    __syncthreads();

    float s[kTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) dot = fmaf(qr[i], ks[j][i], dot);
      if constexpr (kMath == kNoExp) {
        s[j] = j < tm ? dot : 0.f;  // keys past M add nothing
        tile_max = j < tm ? fmaxf(tile_max, dot) : tile_max;
      } else {
        s[j] = j < tm ? dot : -INFINITY;  // keys past M weigh 0
        tile_max = fmaxf(tile_max, s[j]);
      }
    }

    if constexpr (kMath == kNoExp) {
      mx = fmaxf(mx, tile_max);
      float ts = 0.f;
#pragma unroll
      for (int j = 0; j < kTile; ++j) ts += s[j];
      l += ts;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < kTile; ++j) t = fmaf(s[j], vs[j][i], t);
        acc[i] += t;
      }
      continue;
    }

    float scale = 1.f;
    if constexpr (kMath == kNoMax) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) s[j] = __expf(s[j]);
    } else if constexpr (kMath == kExp2) {
      mx = fmaxf(mx, tile_max);
      const float nm = -mx * kLog2e;
      // the rescale between the rounded -max*log2e of two tiles: exactly
      // 1 while the max holds (exp2(max*log2e - round(max*log2e)) drifts
      // 1e-3 over the 2,048 tiles of 65,536 keys); 0 on the first tile
      scale = exp2f(nm - nmx);
      nmx = nm;
#pragma unroll
      for (int j = 0; j < kTile; ++j) s[j] = exp2f(fmaf(s[j], kLog2e, nm));
    } else {  // kExp and kE16: K1's arithmetic
      const float m_new = fmaxf(mx, tile_max);
      scale = __expf(mx - m_new);  // 0 on the first tile
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        s[j] = __expf(s[j] - m_new);
        if constexpr (kMath == kE16) s[j] = round_bf16(s[j]);
      }
      mx = m_new;
    }
    // the tile's terms summed on their own, then added once a tile (K1's)
    float tl = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) tl += s[j];
    if constexpr (kMath == kNoMax) {
      l += tl;
    } else {
      l = fmaf(l, scale, tl);
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < kTile; ++j) t = fmaf(s[j], vs[j][i], t);
      if constexpr (kMath == kNoMax) {
        acc[i] += t;
      } else {
        acc[i] = fmaf(acc[i], scale, t);
      }
    }
  }

  float sv[C];  // noexp: sum v over all keys, once a block
  if constexpr (kMath == kNoExp) {
    vred[threadIdx.x] = vpart;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < C; ++i) {
      sv[i] = 0.f;
      for (int t = i; t < kRows; t += C) sv[i] += vred[t];
    }
  }

  if (live) {
    T* orow = o + ((size_t)b * n + row) * C;
    if constexpr (kMath == kNoExp) {
      const float den = l - mx * (float)m;
#pragma unroll
      for (int i = 0; i < C; ++i)
        store(orow + i, (acc[i] - mx * sv[i]) / den);
    } else {
#pragma unroll
      for (int i = 0; i < C; ++i) store(orow + i, acc[i] / l);
    }
  }
}

template <typename T, int kMath>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int b, int n, int m, cudaStream_t stream) {
  study_fma_kernel<T, kMath><<<dim3((n + kRows - 1) / kRows, b), kRows, 0,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma_variant(int variant, const void* q, const void* k,
                               const void* v, void* o, int b, int n, int m,
                               cudaStream_t st) {
  switch (variant) {
    case kFma: return launch_fma<T, kExp>(q, k, v, o, b, n, m, st);
    case kFmaExp2: return launch_fma<T, kExp2>(q, k, v, o, b, n, m, st);
    case kFmaNoMax: return launch_fma<T, kNoMax>(q, k, v, o, b, n, m, st);
    case kFmaNoExp: return launch_fma<T, kNoExp>(q, k, v, o, b, n, m, st);
    case kFmaE16: return launch_fma<T, kE16>(q, k, v, o, b, n, m, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches fma `variant` (its index in ops/attention_study.py VARIANTS,
// whose fma variants come first) on `stream`; returns cudaGetLastError()
// (0 on success). `is_bf16` selects bf16 operands, else fp32; d must be 2
// and c 8. The caller checks shapes, contiguity and alignment before
// calling.
extern "C" int sagan_attention_study(const void* q, const void* k,
                                     const void* v, void* o, int b, int n,
                                     int m, int d, int c, int variant,
                                     int is_bf16, void* stream) {
  if (d != D || c != C || variant < 0 || variant >= kVariants)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fma_variant<__nv_bfloat16>(variant, q, k, v, o, b,
                                                      n, m, st)
                 : launch_fma_variant<float>(variant, q, k, v, o, b, n, m,
                                             st);
}
