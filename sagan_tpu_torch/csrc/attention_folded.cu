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
// What bounds it: one exponential a (query, key) pair on the SFUs, as K1
// and K3; the contractions are Cin + C = 24 multiply-adds a pair, against
// d + C = 10 for K1 and K3 on projected q, k. The fold saves the
// projections' passes (a few MB) and pays 2.4x the contraction work.
//
// bf16, attention_folded_mma_kernel: both contractions on the tensor cores
// (mma.sync bf16 -> fp32), K3's loop (attention_flash_mma.cu). A warp owns
// one m16 tile of query rows; its x W is summed in fp32 on the CUDA cores
// once, rounded to bf16 and held as the A fragment of an m16n8k16 mma, Cin
// = 16 being exactly the mma's depth (K3 pads d = 2 to k8). xb is staged
// in 64-key tiles by cp.async in rows of row_units(16) 16-byte units, read
// by ldmatrix as the B fragments of the logits; an online softmax as K3's
// (exp2 with one FFMA into ex2.approx, l from fp32 P), P rounded to bf16
// as the A fragment of P V, V's B fragments by ldmatrix.trans. In the wg
// form each tile's V = xb Wg is one m16n8k16 mma a warp (its 16 keys as the
// rows, Cin as k, c = 8 as n8), rounded to bf16 and stored as V's rows,
// once a block.
//
// fp32, attention_folded_kernel: K1's loop (attention_fwd.cu) on the CUDA
// cores, one thread a query row (the tensor cores take fp32 only as TF32,
// which misses the study's 1e-5). W (and Wg) sit in shared memory; a row's
// x W is formed once, in registers; xb is staged in tiles of kTile keys
// (and, without v, each tile's V = xb Wg is computed once a block into
// shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int CIN = 16;   // channels of x (church64's and church256's maps)
constexpr int C = 8;      // value width
constexpr float kLog2e = 1.4426950408889634f;

// ---- fp32: the CUDA cores -------------------------------------------------

constexpr int kRows = 64;  // query rows per block, one per thread
constexpr int kTile = 32;  // keys staged per step

// in fp32 the JAX bodies' roundings to the input type (.astype(x.dtype))
// keep every value as it is
template <bool kVGiven>
__global__ void __launch_bounds__(kRows)
    attention_folded_kernel(const float* __restrict__ x,
                            const float* __restrict__ xb,
                            const float* __restrict__ w,
                            const float* __restrict__ vw,
                            float* __restrict__ o, int n, int m) {
  __shared__ float ws[CIN][CIN];
  __shared__ float wgs[kVGiven ? 1 : CIN][C];
  __shared__ float xbs[kTile][CIN];
  __shared__ float vs[kTile][C];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool live = row < n;
  const float* xbb = xb + (size_t)b * m * CIN;
  const float* vb = kVGiven ? vw + (size_t)b * m * C : nullptr;

  for (int i = threadIdx.x; i < CIN * CIN; i += kRows)
    ws[i / CIN][i % CIN] = w[i];
  if constexpr (!kVGiven) {
    for (int i = threadIdx.x; i < CIN * C; i += kRows)
      wgs[i / C][i % C] = vw[i];
  }
  __syncthreads();

  // this row's x W, summed in fp32
  float xr[CIN], xw[CIN];
  const float* xrow = x + ((size_t)b * n + (live ? row : 0)) * CIN;
#pragma unroll
  for (int i = 0; i < CIN; ++i) xr[i] = live ? xrow[i] : 0.f;
#pragma unroll
  for (int j = 0; j < CIN; ++j) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < CIN; ++i) t = fmaf(xr[i], ws[i][j], t);
    xw[j] = t;
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
      xbs[i / CIN][i % CIN] = i < tm * CIN ? xbb[(size_t)t0 * CIN + i] : 0.f;
    if constexpr (kVGiven) {
      for (int i = threadIdx.x; i < kTile * C; i += kRows)
        vs[i / C][i % C] = i < tm * C ? vb[(size_t)t0 * C + i] : 0.f;
    } else {
      __syncthreads();  // the tile's xb is staged
      // V = xb Wg for the tile's keys, once a block
      for (int i = threadIdx.x; i < kTile * C; i += kRows) {
        const int j = i / C, c = i % C;
        float t = 0.f;
#pragma unroll
        for (int r = 0; r < CIN; ++r) t = fmaf(xbs[j][r], wgs[r][c], t);
        vs[j][c] = t;
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
      tl += e;  // l and E.V from fp32 P
      s[j] = e;
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
    float* orow = o + ((size_t)b * n + row) * C;
#pragma unroll
    for (int i = 0; i < C; ++i) orow[i] = acc[i] / l;
  }
}

cudaError_t launch_fp32(const void* x, const void* xb, const void* w,
                        const void* vw, void* o, int b, int n, int m,
                        bool v_given, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, b);
  const auto* x_ = static_cast<const float*>(x);
  const auto* xb_ = static_cast<const float*>(xb);
  const auto* w_ = static_cast<const float*>(w);
  const auto* vw_ = static_cast<const float*>(vw);
  auto* o_ = static_cast<float*>(o);
  if (v_given)
    attention_folded_kernel<true><<<grid, kRows, 0, stream>>>(
        x_, xb_, w_, vw_, o_, n, m);
  else
    attention_folded_kernel<false><<<grid, kRows, 0, stream>>>(
        x_, xb_, w_, vw_, o_, n, m);
  return cudaGetLastError();
}

// ---- bf16: the tensor cores -----------------------------------------------

constexpr int kMmaWarps = 4;  // a warp one m16 tile of query rows
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows a block
constexpr int kKeyTile = 64;              // keys a stage
constexpr int kGroups = kKeyTile / 8;     // n8 key groups a tile
constexpr int kXbRow = row_units(CIN) * 16;  // bytes of a staged xb row
constexpr int kVRow = row_units(C) * 16;     // bytes of a staged V row
constexpr int kXbBytes = kKeyTile * kXbRow;
static_assert(CIN == 16 && C == 8, "one k16 step of x W, one n8 tile of V");
static_assert(kKeyTile == 16 * kMmaWarps, "the wg form: a warp's 16 keys of "
              "V a tile");

template <bool kVGiven>
__global__ void __launch_bounds__(kMmaThreads)
    attention_folded_mma_kernel(const bf16* __restrict__ x,
                                const bf16* __restrict__ xb,
                                const bf16* __restrict__ w,
                                const bf16* __restrict__ vw,
                                bf16* __restrict__ o, int n, int m) {
  // a tile's xb rows, then its V rows (staged, or xb Wg); ldmatrix reads
  // only the 32 bytes of each xb row that cp.async writes, so the padding
  // stays as it is
  __shared__ __align__(16) char smem[kXbBytes + kKeyTile * kVRow];
  char* xs = smem;
  char* vs = smem + kXbBytes;

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // rows g and g + 8 of the warp's row tile
  const int t = lane & 3;   // keys (channels) 2t and 2t + 1 of each n8
  const int row0 = (blockIdx.x * kMmaWarps + warp) * 16;
  const bf16* xbb = xb + (size_t)b * m * CIN;
  const bf16* vb = kVGiven ? vw + (size_t)b * m * C : nullptr;

  // x W of rows g and g + 8 at columns 2t, 2t + 1, 2t + 8, 2t + 9, summed
  // in fp32 and rounded to bf16: the A fragment of the logits' mma
  uint32_t xa[4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    float xr[CIN];
    const uint4* x4 = reinterpret_cast<const uint4*>(
        x + ((size_t)b * n + (row < n ? row : 0)) * CIN);
#pragma unroll
    for (int i = 0; i < CIN / 8; ++i) {
      const uint4 u = row < n ? x4[i] : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack_bf16(words[j]);
        xr[8 * i + 2 * j] = f.x;
        xr[8 * i + 2 * j + 1] = f.y;
      }
    }
    float xw[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 2 * t + (c & 1) + 8 * (c >> 1);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < CIN; ++i)
        sum = fmaf(xr[i], __bfloat162float(w[i * CIN + col]), sum);
      xw[c] = sum;
    }
    xa[r] = pack_bf16(xw[0], xw[1]);      // a0, a1: columns 2t, 2t + 1
    xa[2 + r] = pack_bf16(xw[2], xw[3]);  // a2, a3: columns 2t + 8, 2t + 9
  }
  // the wg form: Wg's B fragment (rows 2t, 2t + 1 and 2t + 8, 2t + 9 of
  // column g)
  uint32_t wgf[2] = {0u, 0u};
  if constexpr (!kVGiven) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wgf[i] = pack_bf16(__bfloat162float(vw[(2 * t + 8 * i) * C + g]),
                         __bfloat162float(vw[(2 * t + 8 * i + 1) * C + g]));
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // rows g, g + 8; channels 2t, +1
  float mx[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float nm[2] = {INFINITY, INFINITY};    // -max log2e as rounded
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const int tiles = (m + kKeyTile - 1) / kKeyTile;
  for (int it = 0; it < tiles; ++it) {
    __syncthreads();  // every warp is done with the last tile
    stage_rows<CIN, kMmaThreads>(xs, xbb, it * kKeyTile, kKeyTile, m);
    if constexpr (kVGiven)
      stage_rows<C, kMmaThreads>(vs, vb, it * kKeyTile, kKeyTile, m);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (!kVGiven) {
      // V = xb Wg: warp w's 16 keys of the tile as the m16 rows, rounded
      // to bf16 and stored as V's rows (keys past M: xb is 0, so V is 0)
      uint32_t a[4];
      ldsm_x4(a[0], a[1], a[2], a[3],
              xs + (16 * warp + (lane & 15)) * kXbRow + (lane >> 4) * 16);
      float vv[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(vv, a[0], a[1], a[2], a[3], wgf[0], wgf[1]);
      uint32_t* vw32 = reinterpret_cast<uint32_t*>(vs);
      vw32[(16 * warp + g) * (kVRow / 4) + t] = pack_bf16(vv[0], vv[1]);
      vw32[(16 * warp + g + 8) * (kVRow / 4) + t] = pack_bf16(vv[2], vv[3]);
      __syncthreads();
    }

    // B fragments of xb^T: key group h's rows, channels 2t, 2t + 1 (and
    // + 8, + 9) of key g
    uint32_t kf[kGroups][2];
#pragma unroll
    for (int h0 = 0; h0 < kGroups; h0 += 2)
      ldsm_x4(kf[h0][0], kf[h0][1], kf[h0 + 1][0], kf[h0 + 1][1],
              xs + (8 * (h0 + (lane >> 4)) + (lane & 7)) * kXbRow +
                  ((lane >> 3) & 1) * 16);
    // logits: s[h][0..1] row g, s[h][2..3] row g + 8, keys 8h + 2t, + 1
    float s[kGroups][4];
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
      mma_bf16(s[h], xa[0], xa[1], xa[2], xa[3], kf[h][0], kf[h][1]);
    }
    const int tm = m - it * kKeyTile;
    if (tm < kKeyTile) {  // keys past M weigh 0
#pragma unroll
      for (int h = 0; h < kGroups; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * h + 2 * t + (e & 1) >= tm) s[h][e] = -INFINITY;
    }

    // the online softmax, K3's: e = 2^(s log2e - m log2e) in place of s
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int h = 0; h < kGroups; ++h)
        tmax = fmaxf(tmax, fmaxf(s[h][2 * r], s[h][2 * r + 1]));
      const float m_new = fmaxf(mx[r], quad_max(tmax));
      const float nm_new = -m_new * kLog2e;
      // exactly 1 while the max holds; 0 on the first tile
      const float scale = nm_new != nm[r] ? ex2(nm_new - nm[r]) : 1.f;
      mx[r] = m_new;
      nm[r] = nm_new;
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < kGroups; ++h) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[h][e] = ex2(fmaf(s[h][e], kLog2e, nm_new));
          sum += s[h][e];
        }
      }
      acc[2 * r] *= scale;
      acc[2 * r + 1] *= scale;
      l[r] = fmaf(l[r], scale, sum);
    }

    // acc += P V, 16 keys an mma: key groups 2u and 2u + 1 are the A
    // fragment of keys 16u..16u+15; V's B fragments by ldmatrix.trans
#pragma unroll
    for (int u = 0; u < kGroups / 2; u += 2) {
      uint32_t vf[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
          "{%0, %1, %2, %3}, [%4];\n"
          : "=r"(vf[0]), "=r"(vf[1]), "=r"(vf[2]), "=r"(vf[3])
          : "r"(smem_addr(vs + (16 * u + lane) * kVRow)));
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float* lo = s[2 * (u + w)];
        const float* hi = s[2 * (u + w) + 1];
        mma_bf16(acc, pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                 pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]),
                 vf[2 * w], vf[2 * w + 1]);
      }
    }
  }

  uint32_t* ow = reinterpret_cast<uint32_t*>(o) + (size_t)b * n * (C / 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const int row = row0 + g + 8 * r;
    if (row < n)
      ow[(size_t)row * (C / 2) + t] =
          pack_bf16(acc[2 * r] / lsum, acc[2 * r + 1] / lsum);
  }
}

cudaError_t launch_mma(const void* x, const void* xb, const void* w,
                       const void* vw, void* o, int b, int n, int m,
                       bool v_given, cudaStream_t stream) {
  const dim3 grid((n + kMmaRows - 1) / kMmaRows, b);
  const auto* x_ = static_cast<const bf16*>(x);
  const auto* xb_ = static_cast<const bf16*>(xb);
  const auto* w_ = static_cast<const bf16*>(w);
  const auto* vw_ = static_cast<const bf16*>(vw);
  auto* o_ = static_cast<bf16*>(o);
  if (v_given)
    attention_folded_mma_kernel<true><<<grid, kMmaThreads, 0, stream>>>(
        x_, xb_, w_, vw_, o_, n, m);
  else
    attention_folded_mma_kernel<false><<<grid, kMmaThreads, 0, stream>>>(
        x_, xb_, w_, vw_, o_, n, m);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `vw` is v [B, M, 8] when `v_given`, else wg [16, 8]; `is_bf16` selects
// bf16 operands (the tensor-core kernel, which reads rows of x, xb and v
// as 16-byte chunks: their storage must be 16-byte aligned), else fp32
// (the CUDA-core kernel); cin must be 16 and c 8. The caller checks shapes,
// contiguity and alignment before calling.
extern "C" int sagan_attention_folded(const void* x, const void* xb,
                                      const void* w, const void* vw, void* o,
                                      int b, int n, int m, int cin, int c,
                                      int v_given, int is_bf16,
                                      void* stream) {
  if (cin != CIN || c != C) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_mma(x, xb, w, vw, o, b, n, m, v_given, st)
                 : launch_fp32(x, xb, w, vw, o, b, n, m, v_given, st);
}
