// SAGAN spectral normalisation, fused, for Hopper (sm_90a): K7.
//
// Replaces the TPU kernel sagan_tpu/ops/pallas_spectral.py::_sn_kernel
// (launched by _sn_call).  Same function, all in fp32: for the weight W
// matricized [F, O] (F the fan-in, O the output channels) and the stored
// SN vector u [O],
//
//   n_iter times:  v = l2n(W u),   u = l2n(W^T v)     l2n(x) = x / (|x| + eps)
//   sigma = (W^T v) . u,           W_bar = W / (sigma + eps)
//
// and it writes W_bar, the new u, v [F] and sigma (the backward's
// residuals).  The gradient is the closed form dW = g/s - (<g,W>/s^2) v u^T
// in plain torch, as it is XLA ops in the JAX package.
//
// Layout.  Each layer passes its weight in its own layout, viewed as a
// contiguous [A, O, R] with the output channel in the middle: Dense and
// Embedding [in, out] are A = in, R = 1; Conv OIHW is A = 1, R = cin k^2;
// ConvT IOHW is A = cin, R = k^2.  The fan-in index is f = a R + r, and W
// is indexed that way here: no copy of W is made to matricize it.
//
// What bounds it on the H100: bytes.  An iteration is two matrix-vector
// products (4 F O FLOPs), far below the CUDA cores' rate; the least traffic
// is one read of W and one write of W_bar, 8 F O bytes (the 4.62 M-element
// imagenet128 G stem: 37 MB, ~11 us at 3.35 TB/s).  The TPU kernel holds W
// whole in VMEM; an SM's shared memory holds none of the large weights, so
// the work spans the grid, in three kernels at n_iter = 1:
//
//  (a) sn_rows_kernel: each block walks a run of tiles of W's rows (a few
//      slabs a, or a range of r in one slab), each tile staged once in
//      shared memory with 8 loads in flight a thread.  Per row v_raw[f] =
//      sum_o W[f,o] u[o]; then, while the tile is resident, the tile's
//      share of W^T v_raw is added to the block's fp32 sum [O] in shared
//      memory, written once as the block's partial [blocks, O].  One read
//      of W gives both products: W^T l2n(v_raw) = W^T v_raw / (|v_raw| + eps).
//  (b) sn_colsum_kernel: u2_raw[o] = sum of the partials over the blocks,
//      32 columns a block, 8 threads a column, in a fixed order.
//  (c) sn_finish_kernel: every block computes |v_raw|, u2 = u2_raw /
//      (|v_raw| + eps), u_new = l2n(u2) and sigma = u2 . u_new (the JAX
//      kernel's sigma, no third pass over W) in the same order, so all get
//      the same bits; block 0 writes v, u_new and sigma, and all of them
//      write W_bar = W / (sigma + eps).
//
// No atomics: the same bits every run.  A further iteration runs (a), (b)
// and (c) on one block without the scale.  A tile whose row does not fit
// the shared memory (O above ~25,000) is read from device memory twice,
// and its block's sum kept in the partial itself.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kLoadUnroll = 8;             // tile loads in flight a thread
constexpr int kColumns = 32;               // sn_colsum_kernel: columns a block
constexpr int kSlices = 8;                 //   and threads a column
constexpr int kFinishThreads = 256;
constexpr long long kTileFloats = 8192;    // a tile's target size
constexpr long long kMaxRowBlocks = 3 * 132;
constexpr long long kMaxFinishBlocks = 2 * 132;
constexpr int kScaleUnroll = 4;            // W_bar items in flight a thread
constexpr long long kMaxSmemBytes = 200 * 1024;

// How sn_rows_kernel cuts W [A, O, R]: a tile is `ta` slabs by `tr` of r
// (one of the two is whole: ta = 1, or tr = R), staged in shared memory with
// a row stride `stride` (tr made odd, so neighbouring o hit other banks).
struct Geometry {
  long long A, O, R;
  long long ta, tr, stride;
  long long tiles_r;     // tiles across one slab's r
  long long ntiles;      // tiles in all
  long long per_block;   // tiles a block walks
  long long blocks;
  int cached;            // tile and the block's sum in shared memory
  long long smem;        // dynamic shared memory bytes of sn_rows_kernel
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

Geometry geometry(long long A, long long O, long long R) {
  Geometry g;
  g.A = A;
  g.O = O;
  g.R = R;
  if (R >= 32) {
    // rows strided by R: a tile is a range of r in one slab, 32 wide or a
    // multiple of 32, read as O segments of tr consecutive floats
    long long tr = kTileFloats / O;
    tr = tr >= 32 ? (tr / 32) * 32 : (tr < 1 ? 1 : tr);
    g.ta = 1;
    g.tr = tr < R ? tr : R;
  } else {
    // short slabs (Dense, Embedding, ConvT): a tile is whole slabs,
    // contiguous in memory
    long long ta = kTileFloats / (O * R);
    ta = ta < 1 ? 1 : ta;
    g.ta = ta < A ? ta : A;
    g.tr = R;
  }
  g.stride = g.tr | 1;
  g.tiles_r = cdiv(R, g.tr);
  g.ntiles = cdiv(A, g.ta) * g.tiles_r;
  g.blocks = g.ntiles < kMaxRowBlocks ? g.ntiles : kMaxRowBlocks;
  g.per_block = cdiv(g.ntiles, g.blocks);
  g.blocks = cdiv(g.ntiles, g.per_block);
  const long long small = (kRowThreads + g.ta * g.tr) * 4;   // red + vrow
  const long long big = (g.ta * O * g.stride + O) * 4;        // tile + sum
  g.cached = small + big <= kMaxSmemBytes;
  g.smem = g.cached ? small + big : small;
  return g;
}

// W at (a_l, o, r_l) of the tile whose element (0, 0, 0) is `base` in
// device memory, read from the staged tile when CACHED
template <bool CACHED>
__device__ __forceinline__ float tile_at(const float* tile,
                                         const float* __restrict__ base,
                                         long long O, long long R,
                                         long long stride, int a_l,
                                         long long o, int r_l) {
  const long long row = (long long)a_l * O + o;
  if constexpr (CACHED) {
    return tile[row * stride + r_l];
  } else {
    return __ldg(base + row * R + r_l);
  }
}

// (a): v_raw of every row of the block's tiles into `vraw` [F], and the
// block's partial of W^T v_raw into part[blockIdx.x] [O]
template <bool CACHED>
__global__ void __launch_bounds__(kRowThreads)
    sn_rows_kernel(const float* __restrict__ w, const float* __restrict__ u,
                   float* __restrict__ vraw, float* __restrict__ part,
                   Geometry g) {
  extern __shared__ float smem[];
  const long long O = g.O, R = g.R, stride = g.stride;
  float* tile = smem;
  float* sum = smem + (CACHED ? g.ta * O * stride : 0);
  float* red = sum + (CACHED ? O : 0);
  float* vrow = red + kRowThreads;
  const int tid = threadIdx.x;
  const long long t_begin = (long long)blockIdx.x * g.per_block;
  const long long t_end = t_begin + g.per_block < g.ntiles
                              ? t_begin + g.per_block
                              : g.ntiles;
  // the block's sum of W^T v_raw: each thread owns o = tid + k kRowThreads
  float* my_sum = CACHED ? sum : part + (long long)blockIdx.x * O;
  for (long long o = tid; o < O; o += kRowThreads) my_sum[o] = 0.f;

  for (long long t = t_begin; t < t_end; ++t) {
    const long long a0 = (t / g.tiles_r) * g.ta;
    const long long r0 = (t % g.tiles_r) * g.tr;
    const int ta = (int)(g.ta < g.A - a0 ? g.ta : g.A - a0);
    const int tr = (int)(g.tr < R - r0 ? g.tr : R - r0);
    const int nrows = ta * tr;
    // element (a_l, o, r_l) of the tile at base[(a_l O + o) R + r_l]
    const float* base = w + a0 * O * R + r0;
    if constexpr (CACHED) {
      const long long n = (long long)ta * O * tr;
      for (long long i0 = tid; i0 < n; i0 += kLoadUnroll * kRowThreads) {
        float x[kLoadUnroll];
#pragma unroll
        for (int k = 0; k < kLoadUnroll; ++k) {
          const long long i = i0 + (long long)k * kRowThreads;
          if (i < n) {
            const long long row = i / tr;   // a_l O + o
            x[k] = __ldg(base + row * R + (i - row * tr));
          }
        }
#pragma unroll
        for (int k = 0; k < kLoadUnroll; ++k) {
          const long long i = i0 + (long long)k * kRowThreads;
          if (i < n) {
            const long long row = i / tr;
            tile[row * stride + (i - row * tr)] = x[k];
          }
        }
      }
      __syncthreads();
    }

    // v_raw: `tpr` threads a row, each over every tpr-th o, summed in
    // order through `red`; neighbouring threads read neighbouring words
    // (along o when a tile row is one slab's, else along r)
    int tpr = 1;
    while (tpr < kRowThreads && nrows * tpr * 2 <= kRowThreads) tpr *= 2;
    const int rpp = kRowThreads / tpr;   // rows a pass
    const int rl = tr == 1 ? tid / tpr : tid % rpp;
    const int j = tr == 1 ? tid % tpr : tid / rpp;
    for (int p0 = 0; p0 < nrows; p0 += rpp) {
      const int rho = p0 + rl;
      float acc = 0.f;
      if (rho < nrows) {
        const int a_l = rho / tr, r_l = rho % tr;
        for (long long o = j; o < O; o += tpr)
          acc += tile_at<CACHED>(tile, base, O, R, stride, a_l, o, r_l) *
                 __ldg(u + o);
      }
      red[tid] = acc;
      __syncthreads();
      if (tid < rpp && p0 + tid < nrows) {
        float s = 0.f;
        for (int jj = 0; jj < tpr; ++jj)
          s += red[tr == 1 ? tid * tpr + jj : jj * rpp + tid];
        const int rho2 = p0 + tid;
        vrow[rho2] = s;
        vraw[(a0 + rho2 / tr) * R + r0 + rho2 % tr] = s;
      }
      __syncthreads();
    }

    // this tile's share of W^T v_raw: one thread an o, rows in order
    for (long long o = tid; o < O; o += kRowThreads) {
      float acc = 0.f;
      for (int a_l = 0; a_l < ta; ++a_l)
        for (int r_l = 0; r_l < tr; ++r_l)
          acc += tile_at<CACHED>(tile, base, O, R, stride, a_l, o, r_l) *
                 vrow[a_l * tr + r_l];
      my_sum[o] += acc;
    }
    __syncthreads();   // the next tile overwrites tile and vrow
  }
  if constexpr (CACHED) {
    float* my_part = part + (long long)blockIdx.x * O;
    for (long long o = tid; o < O; o += kRowThreads) my_part[o] = sum[o];
  }
}

// (b): u2_raw[o] = sum over the blocks b of part[b][o]: thread (c, s) sums
// b = s, s + kSlices, ... of column c, then the slices in order
__global__ void __launch_bounds__(kColumns * kSlices)
    sn_colsum_kernel(const float* __restrict__ part,
                     float* __restrict__ u2raw, long long blocks,
                     long long O) {
  __shared__ float red[kSlices][kColumns];
  const int c = threadIdx.x % kColumns, s = threadIdx.x / kColumns;
  const long long o = (long long)blockIdx.x * kColumns + c;
  float acc = 0.f;
  if (o < O) {
#pragma unroll 8
    for (long long b = s; b < blocks; b += kSlices) acc += part[b * O + o];
  }
  red[s][c] = acc;
  __syncthreads();
  if (s == 0 && o < O) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) total += red[k][c];
    u2raw[o] = total;
  }
}

// Sum of x over the block, the same bits every run, returned to every
// thread; `scratch` holds 33 floats
__device__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float s = lane < (int)(blockDim.x / 32) ? scratch[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) scratch[32] = s;
  }
  __syncthreads();
  const float total = scratch[32];
  __syncthreads();   // scratch free for the next sum
  return total;
}

// out[i] = in[i] / s over the grid, kScaleUnroll items in flight a thread
template <typename T>
__device__ __forceinline__ void scale_items(const T* __restrict__ in,
                                            T* __restrict__ out,
                                            long long items, float s) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i0 < items; i0 += kScaleUnroll * step) {
    T x[kScaleUnroll];
#pragma unroll
    for (int k = 0; k < kScaleUnroll; ++k) {
      const long long i = i0 + k * step;
      if (i < items) x[k] = in[i];
    }
#pragma unroll
    for (int k = 0; k < kScaleUnroll; ++k) {
      const long long i = i0 + k * step;
      if (i < items) {
        if constexpr (sizeof(T) == sizeof(float4)) {
          x[k].x = x[k].x / s;
          x[k].y = x[k].y / s;
          x[k].z = x[k].z / s;
          x[k].w = x[k].w / s;
        } else {
          x[k] = x[k] / s;
        }
        out[i] = x[k];
      }
    }
  }
}

// (c): the norms and sigma, in every block alike; block 0 writes v = l2n(
// v_raw), u_new = l2n(u2_raw / (|v_raw| + eps)) and sigma; with SCALE every
// block then writes its share of W_bar = W / (sigma + eps), four floats an
// item when VEC
template <bool SCALE, bool VEC>
__global__ void __launch_bounds__(kFinishThreads)
    sn_finish_kernel(const float* __restrict__ vraw,
                     const float* __restrict__ u2raw, float* __restrict__ v,
                     float* __restrict__ u_new, float* __restrict__ sigma,
                     const float* __restrict__ w, float* __restrict__ wbar,
                     long long F, long long O, long long n, float eps) {
  __shared__ float scratch[33];
  const int tid = threadIdx.x;
  const bool first = blockIdx.x == 0;
  float ss = 0.f;
  for (long long f = tid; f < F; f += kFinishThreads) ss += vraw[f] * vraw[f];
  const float nv = sqrtf(block_sum(ss, scratch)) + eps;
  float su = 0.f;
  for (long long o = tid; o < O; o += kFinishThreads) {
    const float u2 = u2raw[o] / nv;
    su += u2 * u2;
  }
  const float nu = sqrtf(block_sum(su, scratch)) + eps;
  float sg = 0.f;
  for (long long o = tid; o < O; o += kFinishThreads) {
    const float u2 = u2raw[o] / nv;
    const float un = u2 / nu;
    sg += u2 * un;
    if (first) u_new[o] = un;
  }
  const float sig = block_sum(sg, scratch);
  if (first) {
    for (long long f = tid; f < F; f += kFinishThreads) v[f] = vraw[f] / nv;
    if (tid == 0) sigma[0] = sig;
  }
  if constexpr (SCALE) {
    if constexpr (VEC) {
      scale_items(reinterpret_cast<const float4*>(w),
                  reinterpret_cast<float4*>(wbar), n / 4, sig + eps);
    } else {
      scale_items(w, wbar, n, sig + eps);
    }
  }
}

cudaError_t allow_smem() {
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        sn_rows_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(sn_rows_kernel<false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kMaxSmemBytes);
  }();
  return err;
}

}  // namespace

// Blocks of sn_rows_kernel for W viewed as [A, O, R]: the caller's fp32
// partial scratch holds blocks * O floats.
extern "C" long long sagan_spectral_norm_blocks(long long A, long long O,
                                                long long R) {
  return geometry(A, O, R).blocks;
}

// K7 on `stream`: w [A, O, R] and u [O] fp32 in; wbar [A, O, R], u_new [O],
// v [A R] and sigma [1] fp32 out; `vraw` [A R], `u2raw` [O] and `part`
// (sagan_spectral_norm_blocks(A, O, R) * O floats) are fp32 scratch.
// Returns cudaGetLastError() after each launch (0 on success).  The caller
// checks devices, types, shapes and contiguity; n_iter >= 1.
extern "C" int sagan_spectral_norm(const void* w, const void* u, void* wbar,
                                   void* u_new, void* v, void* sigma,
                                   void* vraw, void* u2raw, void* part,
                                   long long A, long long O, long long R,
                                   int n_iter, float eps, void* stream) {
  if (A < 1 || O < 1 || R < 1 || n_iter < 1) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(A, O, R);
  const long long F = A * R, n = A * O * R;
  const float* w_ = static_cast<const float*>(w);
  float* wbar_ = static_cast<float*>(wbar);
  float* vraw_ = static_cast<float*>(vraw);
  float* u2raw_ = static_cast<float*>(u2raw);
  float* part_ = static_cast<float*>(part);
  float* v_ = static_cast<float*>(v);
  float* un_ = static_cast<float*>(u_new);
  float* sigma_ = static_cast<float*>(sigma);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wbar) % 16 == 0;
  long long grid = cdiv(vec ? n / 4 : n, kFinishThreads * kScaleUnroll);
  grid = grid < kMaxFinishBlocks ? grid : kMaxFinishBlocks;
  for (int it = 0; it < n_iter; ++it) {
    // the first iteration starts from the stored u, the next from u_new
    const float* u_in = it == 0 ? static_cast<const float*>(u) : un_;
    if (g.cached) {
      sn_rows_kernel<true><<<(unsigned)g.blocks, kRowThreads, g.smem, st>>>(
          w_, u_in, vraw_, part_, g);
    } else {
      sn_rows_kernel<false><<<(unsigned)g.blocks, kRowThreads, g.smem, st>>>(
          w_, u_in, vraw_, part_, g);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sn_colsum_kernel<<<(unsigned)cdiv(O, kColumns), kColumns * kSlices, 0,
                       st>>>(part_, u2raw_, g.blocks, O);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (it + 1 < n_iter) {
      sn_finish_kernel<false, false><<<1, kFinishThreads, 0, st>>>(
          vraw_, u2raw_, v_, un_, sigma_, w_, wbar_, F, O, n, eps);
    } else if (vec) {
      sn_finish_kernel<true, true><<<(unsigned)grid, kFinishThreads, 0, st>>>(
          vraw_, u2raw_, v_, un_, sigma_, w_, wbar_, F, O, n, eps);
    } else {
      sn_finish_kernel<true, false><<<(unsigned)grid, kFinishThreads, 0,
                                      st>>>(
          vraw_, u2raw_, v_, un_, sigma_, w_, wbar_, F, O, n, eps);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
