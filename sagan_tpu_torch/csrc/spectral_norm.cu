// SAGAN spectral normalisation, grouped, for Hopper (sm_90a): K7.
//
// Replaces the TPU kernel sagan_tpu/ops/pallas_spectral.py::_sn_kernel
// (:31, launched by _sn_call at :63), which normalizes one weight a call,
// with one call over a table of weights: every spectrally normalized weight
// of a net (imagenet128_cond: G's 25, D's 28).  Per weight the function is
// the TPU kernel's, all in fp32: for W matricized [F, O] (F the fan-in, O
// the output channels) and the stored SN vector u [O],
//
//   n_iter times:  v = l2n(W u),   u = l2n(W^T v)     l2n(x) = x / (|x| + eps)
//   sigma = (W^T v) . u,           W_bar = W / (sigma + eps)
//
// and it writes W_bar in the layer's compute dtype (fp32 or bf16, rounded
// once from the fp32 quotient), u_new, v [F] and sigma (the backward's
// residuals), and u_new into the layer's own u buffer when the layer
// trains.  The backward is the closed form of the JAX package's _sn_bwd
// (pallas_spectral.py:96, XLA ops there), grouped too:
//
//   dW = g / s - (<g, W> / s^2) v u^T,        s = sigma + eps.
//
// Layout.  Each layer passes its weight in its own layout, viewed as a
// contiguous [A, O, R] with the output channel in the middle: Dense and
// Embedding [in, out] are A = in, R = 1; Conv OIHW is A = 1, R = cin k^2;
// ConvT IOHW is A = cin, R = k^2.  The fan-in index is f = a R + r, and W
// is indexed that way here: no copy of W is made to matricize it.
//
// What bounds it on the H100: bytes.  An iteration is two matrix-vector
// products (4 F O FLOPs), far below the CUDA cores' rate.  The least
// traffic of a table is one read of W and one write of W_bar: 6 bytes an
// element with a bf16 W_bar, 8 with fp32 (imagenet128_cond's G table, 7.38
// M elements, 13.2 us at 3.35 TB/s in bf16; D's, 3.60 M, 6.4 us); the
// backward reads g and W and writes dW, 10 (bf16 g) or 12 bytes an element.
// One weight a call, the three kernels of a small weight cost more in
// launches and in grids that fill a few SMs than in bytes (41 of the 53
// weights are under 1 MB).  So each pass runs once over the whole table:
//
//  (a) rows: all tiles of all weights form one work list, the largest
//      weight's first, an item being a run of tiles of one weight sized
//      to spread the table over the SMs (4 blocks an SM at most).  Each
//      tile is staged once in shared memory with 16-byte loads, 4 in
//      flight a thread, u beside it; per row v_raw[f] = sum_o W[f,o] u[o];
//      then, while the tile is resident, its share of W^T v_raw is added
//      to the item's fp32 sum [O] (a group of threads an o where O is
//      small, so no thread walks a long column alone), written once as the
//      item's partial.  One read of W gives both products: W^T l2n(v_raw)
//      = W^T v_raw / (|v_raw| + eps).
//  (b) colsum: u2_raw[o] = the sum of the weight's partials, 32 columns a
//      block, 8 threads a column, in a fixed order; each block also forms
//      |v_raw| and its 32 columns' sum of u2^2, u2 = u2_raw / (|v_raw| +
//      eps).
//  (c) finish: every item of a weight sums those column blocks' sums in
//      order, so all get the same |u2| and sigma = u2 . u_new = |u2|^2 /
//      (|u2| + eps) (the JAX kernel's sigma); the weight's first item
//      writes v, u_new (and the layer's u) and sigma, and each item scales
//      its chunk, W_bar = W / (sigma + eps), reading W again.
//
// The three passes run as three launches (sn_group_{rows,colsum,finish}_
// kernel, the shipped design), or as one cooperative launch with
// grid-wide barriers between them (sn_group_coop_kernel, `design` 1,
// timed beside it in PERF.md: slower at G's table, where its 128
// registers allow 2 blocks an SM, and level at D's).  A further iteration
// (n_iter > 1, per weight) runs the passes again from u_new, its finish
// writing no W_bar.  The backward runs two passes over the table's
// weights that took a gradient, over the finish pass's chunks: per-chunk
// partials of <g, W>, then dW, every chunk of a weight summing that
// weight's partials in the same order.  No atomics anywhere: the same
// bits every run.
//
// The table is a kernel parameter (__grid_constant__, up to kMaxWeights
// weights: 7 KB of the 32 KB that CUDA 12.1+ allows, read through uniform
// registers), built by the C entry points below from the wrapper's plan
// (shapes, tiles, work lists and offsets, ops/cuda_spectral.py `_plan`)
// and this call's pointers.  A tile whose row does not fit the shared
// memory (O above ~25,000) is read from device memory twice, and its
// item's sum kept in the partial itself.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // every kernel
constexpr int kLoadUnroll = 4;             // 16-byte tile loads in flight
constexpr int kColumns = 32;               // colsum: columns a block
constexpr int kSlices = 8;                 //   and threads a column
constexpr int kScaleUnroll = 4;            // W_bar, dW items in flight a thread
constexpr int kMaxWeights = 32;            // weights a table
constexpr long long kMaxSmemBytes = 200 * 1024;

// flags of a weight: from the plan ...
constexpr int kCached = 1;     // tile and the item's sum in shared memory
constexpr int kVecTile = 2;    // the tile's rows take 16-byte loads
// ... and from the call
constexpr int kAligned = 4;    // w, and g in the backward, 16-byte aligned

// the plan's fields of a weight, one int64 each, in the order of
// ops/cuda_spectral.py PLAN_FIELDS
enum PlanField {
  P_A, P_O, P_R, P_TA, P_TR, P_STRIDE, P_TILES_R, P_NTILES, P_PER_ITEM,
  P_ITEMS, P_ITEM0, P_COL0, P_CHUNK0, P_CHUNKS, P_CHUNK, P_N_ITER, P_FLAGS,
  P_FLAT_OFF, P_STAT_OFF, P_SCRATCH_OFF, P_DOT_OFF, kPlanFields
};

// One weight of the forward's table.  W [A, O, R] is cut into tiles of `ta`
// slabs by `tr` of r (one of the two whole: ta = 1, or tr = R), staged with
// a row stride `stride` (tr made odd, so neighbouring o hit other banks);
// rows items [item0, item0 + items) walk `per_item` tiles each, colsum
// blocks [col0, col0 + ceil(O / 32)), finish items [chunk0, chunk0 +
// chunks) scale `chunk` elements each.
struct Entry {
  const float* w;
  const float* u;        // the first iteration's start
  float* u_store;        // the layer's u (set at the last iteration), or null
  void* wbar;            // fp32 or bf16 (Table::bf16)
  float* u_new;          // [O]
  float* v;              // [F]
  float* sigma;          // [1]
  float* vraw;           // [F] scratch
  float* u2raw;          // [O] scratch
  float* part;           // [items, O] scratch
  float* csum;           // [ceil(O / 32)] scratch: sums of u2^2 by 32 columns
  float* nv;             // [1] scratch: |v_raw| + eps
  long long A, O, R, ta, tr, stride, tiles_r, ntiles, per_item;
  long long items, item0, col0, chunk0, chunks, chunk;
  int n_iter, flags;
};

struct Table {
  Entry e[kMaxWeights];
  int n, bf16;
};

// One weight of the backward's table: its chunks [chunk0, chunk0 + chunks),
// `chunk` elements each, as the finish pass cuts it
struct BwdEntry {
  const void* g;         // fp32 or bf16 (BwdTable::g_bf16)
  const float* w;
  float* dw;
  const float* u;        // the forward's u_new
  const float* v;
  const float* sigma;
  float* dots;           // [items] scratch
  long long O, R, n, chunk0, chunks, chunk;
  int flags, pad;
};

struct BwdTable {
  BwdEntry e[kMaxWeights];
  int n, g_bf16;
};

// the entry whose work list [start, start + count) holds item k, by
// binary search: the entries' lists are consecutive, in table order
template <typename E>
__device__ __forceinline__ int entry_of(const E* e, int n, long long k,
                                        long long E::*start) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (e[mid].*start <= k) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
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

// Stage `rows` rows of `tr` floats, row r at base + r R, into `tile` with
// row stride `stride`.  VEC: 16-byte loads (tr % 4 == 0, or contiguous rows,
// tr == R, with a scalar tail; base 16-byte aligned either way).
template <bool VEC>
__device__ __forceinline__ void stage_tile(float* tile,
                                           const float* __restrict__ base,
                                           int rows, int tr, long long R,
                                           long long stride) {
  const int n = rows * tr, tid = threadIdx.x;
  int done = 0;
  if constexpr (VEC) {
    const int n4 = n / 4;
    for (int i0 = tid; i0 < n4; i0 += kLoadUnroll * kThreads) {
      float4 x[kLoadUnroll];
#pragma unroll
      for (int k = 0; k < kLoadUnroll; ++k) {
        const int i = i0 + k * kThreads;
        if (i < n4) {
          // four consecutive elements: one row (tr % 4 == 0), or rows that
          // are contiguous in W (tr == R)
          const int e = 4 * i, row = e / tr;
          x[k] = __ldg(reinterpret_cast<const float4*>(
              base + (long long)row * R + (e - row * tr)));
        }
      }
#pragma unroll
      for (int k = 0; k < kLoadUnroll; ++k) {
        const int i = i0 + k * kThreads;
        if (i < n4) {
          const float xs[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
          int row = 4 * i / tr, rl = 4 * i - row * tr;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            tile[row * stride + rl] = xs[c];
            if (++rl == tr) {
              rl = 0;
              ++row;
            }
          }
        }
      }
    }
    done = 4 * n4;
  }
  for (int i0 = done + tid; i0 < n; i0 += kLoadUnroll * kThreads) {
    float x[kLoadUnroll];
#pragma unroll
    for (int k = 0; k < kLoadUnroll; ++k) {
      const int e = i0 + k * kThreads;
      if (e < n) {
        const int row = e / tr;
        x[k] = __ldg(base + (long long)row * R + (e - row * tr));
      }
    }
#pragma unroll
    for (int k = 0; k < kLoadUnroll; ++k) {
      const int e = i0 + k * kThreads;
      if (e < n) {
        const int row = e / tr;
        tile[row * stride + (e - row * tr)] = x[k];
      }
    }
  }
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

// (a), item j of weight E: v_raw of every row of the item's tiles into
// E.vraw, and the item's partial of W^T v_raw into E.part[j].  CACHED: the
// tile, the item's sum and u in shared memory.
template <bool CACHED>
__device__ void rows_item(const Entry& E, long long j,
                          const float* __restrict__ u, float* smem) {
  const long long O = E.O, R = E.R, stride = E.stride;
  float* tile = smem;
  float* sum = smem + (CACHED ? E.ta * O * stride : 0);
  float* us = sum + (CACHED ? O : 0);
  float* red = us + (CACHED ? O : 0);
  float* vrow = red + kThreads;
  const int tid = threadIdx.x;
  const long long t_begin = j * E.per_item;
  const long long t_end =
      t_begin + E.per_item < E.ntiles ? t_begin + E.per_item : E.ntiles;
  // the item's sum of W^T v_raw: each thread owns o = tid + k kThreads
  // (W^T v below keeps that ownership, or gives o to one group of lanes)
  float* my_sum = CACHED ? sum : E.part + j * O;
  for (long long o = tid; o < O; o += kThreads) {
    my_sum[o] = 0.f;
    if constexpr (CACHED) us[o] = __ldg(u + o);
  }
  const float* u_at = CACHED ? us : u;
  // W^T v: `tpo` threads an o when O is under the block's threads
  int tpo = 1;
  while (tpo < kThreads && O * tpo * 2 <= kThreads) tpo *= 2;

  for (long long t = t_begin; t < t_end; ++t) {
    const long long a0 = (t / E.tiles_r) * E.ta;
    const long long r0 = (t % E.tiles_r) * E.tr;
    const int ta = (int)(E.ta < E.A - a0 ? E.ta : E.A - a0);
    const int tr = (int)(E.tr < R - r0 ? E.tr : R - r0);
    const int nrows = ta * tr;
    // element (a_l, o, r_l) of the tile at base[(a_l O + o) R + r_l]
    const float* base = E.w + a0 * O * R + r0;
    if constexpr (CACHED) {
      if ((E.flags & kVecTile) && (E.flags & kAligned)) {
        stage_tile<true>(tile, base, ta * (int)O, tr, R, stride);
      } else {
        stage_tile<false>(tile, base, ta * (int)O, tr, R, stride);
      }
    }
    __syncthreads();   // the tile (and at the first, us) staged

    // v_raw: `tpr` threads a row, each over every tpr-th o, summed in
    // order through `red`; neighbouring threads read neighbouring words
    // (along o when a tile row is one slab's, else along r)
    int tpr = 1;
    while (tpr < kThreads && nrows * tpr * 2 <= kThreads) tpr *= 2;
    const int rpp = kThreads / tpr;   // rows a pass
    const int rl = tr == 1 ? tid / tpr : tid % rpp;
    const int jj0 = tr == 1 ? tid % tpr : tid / rpp;
    for (int p0 = 0; p0 < nrows; p0 += rpp) {
      const int rho = p0 + rl;
      float acc = 0.f;
      if (rho < nrows) {
        const int a_l = rho / tr, r_l = rho % tr;
#pragma unroll 4
        for (long long o = jj0; o < O; o += tpr)
          acc += tile_at<CACHED>(tile, base, O, R, stride, a_l, o, r_l) *
                 u_at[o];
      }
      // a row's tpr partials in order: through warp shuffles first when
      // they fill whole warps (tr == 1 and tpr >= 32: a row's threads are
      // consecutive), else all through `red`
      const bool by_warp = tr == 1 && tpr >= 32;
      if (by_warp) {
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (tid % 32 == 0) red[tid / 32] = acc;
      } else {
        red[tid] = acc;
      }
      __syncthreads();
      if (tid < rpp && p0 + tid < nrows) {
        float s = 0.f;
        if (by_warp) {
          for (int w = 0; w < tpr / 32; ++w) s += red[tid * (tpr / 32) + w];
        } else {
          for (int jj = 0; jj < tpr; ++jj)
            s += red[tr == 1 ? tid * tpr + jj : jj * rpp + tid];
        }
        const int rho2 = p0 + tid;
        vrow[rho2] = s;
        E.vraw[(a0 + rho2 / tr) * R + r0 + rho2 % tr] = s;
      }
      __syncthreads();
    }

    // this tile's share of W^T v_raw, the rows in order: one thread an o,
    // or (O under kThreads / 2) `tpo` consecutive threads an o, each over
    // every tpo-th row, their partials summed through shuffles and `red`
    if (tpo == 1) {
      for (long long o = tid; o < O; o += kThreads) {
        float acc = 0.f;
        for (int a_l = 0; a_l < ta; ++a_l) {
#pragma unroll 4
          for (int r_l = 0; r_l < tr; ++r_l)
            acc += tile_at<CACHED>(tile, base, O, R, stride, a_l, o, r_l) *
                   vrow[a_l * tr + r_l];
        }
        my_sum[o] += acc;
      }
    } else {
      const int o = tid / tpo, k = tid % tpo;
      float acc = 0.f;
      if (o < O) {
#pragma unroll 4
        for (int rho = k; rho < nrows; rho += tpo)
          acc += tile_at<CACHED>(tile, base, O, R, stride, rho / tr, o,
                                 rho % tr) * vrow[rho];
      }
      const int lanes = tpo < 32 ? tpo : 32;
      for (int off = lanes / 2; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off, lanes);
      if (tpo > 32) {
        if (tid % 32 == 0) red[tid / 32] = acc;
        __syncthreads();
        if (k == 0 && o < O) {
          float s = 0.f;
          for (int w = 0; w < tpo / 32; ++w) s += red[o * (tpo / 32) + w];
          my_sum[o] += s;
        }
      } else if (k == 0 && o < O) {
        my_sum[o] += acc;
      }
    }
    __syncthreads();   // the next tile overwrites tile, red and vrow
  }
  if constexpr (CACHED) {
    float* my_part = E.part + j * O;
    for (long long o = tid; o < O; o += kThreads) my_part[o] = sum[o];
  }
}

// (a) for work item k of iteration `it`
__device__ void rows_work(const Table& t, long long k, int it, float* smem) {
  const Entry E = t.e[entry_of(t.e, t.n, k, &Entry::item0)];
  if (it >= E.n_iter) return;
  // the first iteration starts from the stored u, the next from u_new
  const float* u = it == 0 ? E.u : E.u_new;
  __syncthreads();   // the block's previous item is done with smem
  if (E.flags & kCached) {
    rows_item<true>(E, k - E.item0, u, smem);
  } else {
    rows_item<false>(E, k - E.item0, u, smem);
  }
}

// (b) for colsum block k: u2_raw[o] = sum over the weight's items b of
// part[b][o]: thread (c, s) sums b = s, s + kSlices, ... of column c, then
// the slices in order.  Every block of the weight also computes |v_raw| +
// eps (the first writes it to E.nv) and the sum of u2^2 = (u2_raw /
// (|v_raw| + eps))^2 over its 32 columns, in order, into E.csum.
__device__ void colsum_work(const Table& t, long long k, int it, float eps) {
  __shared__ float red[kSlices][kColumns];
  __shared__ float scratch[33];
  const Entry E = t.e[entry_of(t.e, t.n, k, &Entry::col0)];
  if (it >= E.n_iter) return;
  const int tid = threadIdx.x;
  const int c = tid % kColumns, s = tid / kColumns;
  const long long o = (k - E.col0) * kColumns + c;
  float acc = 0.f;
  if (o < E.O) {
#pragma unroll 8
    for (long long b = s; b < E.items; b += kSlices)
      acc += E.part[b * E.O + o];
  }
  const long long F = E.A * E.R;
  float ss = 0.f;
#pragma unroll 4
  for (long long f = tid; f < F; f += kThreads) ss += E.vraw[f] * E.vraw[f];
  const float nv = sqrtf(block_sum(ss, scratch)) + eps;   // syncs red too
  red[s][c] = acc;
  __syncthreads();
  if (s == 0) {
    float total = 0.f;
#pragma unroll
    for (int q = 0; q < kSlices; ++q) total += red[q][c];
    float u2sq = 0.f;
    if (o < E.O) {
      E.u2raw[o] = total;
      const float u2 = total / nv;
      u2sq = u2 * u2;
    }
    red[1][c] = u2sq;
  }
  __syncthreads();
  if (tid == 0) {
    float sq = 0.f;
    for (int q = 0; q < kColumns; ++q) sq += red[1][q];
    E.csum[k - E.col0] = sq;
    if (k == E.col0) E.nv[0] = nv;
  }
}

// (c) for finish item k: sigma, from the colsum blocks' sums of u2^2 in
// order, in every item of the weight alike: |u2| + eps = sqrt(sum) + eps,
// sigma = u2 . u_new = sum / (|u2| + eps).  The weight's first item writes
// v = v_raw / (|v_raw| + eps), u_new = u2 / (|u2| + eps), sigma and, at
// the last iteration, the layer's u; at the last iteration every item then
// writes its chunk of W_bar = W / (sigma + eps), kScaleUnroll float4s in
// flight a thread when w is aligned
__device__ void finish_work(const Table& t, long long k, int it, float eps) {
  __shared__ float scratch[33];
  const Entry E = t.e[entry_of(t.e, t.n, k, &Entry::chunk0)];
  const long long j = k - E.chunk0;
  const bool last = it + 1 == E.n_iter;
  if (it >= E.n_iter || (j > 0 && !last)) return;
  const int tid = threadIdx.x;
  const long long F = E.A * E.R, O = E.O;
  const long long blocks = (O + kColumns - 1) / kColumns;
  float su = 0.f;
  for (long long b = tid; b < blocks; b += kThreads) su += E.csum[b];
  const float sq = block_sum(su, scratch);
  const float nu = sqrtf(sq) + eps;
  const float sig = sq / nu;
  if (j == 0) {
    const float nv = E.nv[0];
    for (long long o = tid; o < O; o += kThreads) {
      const float un = E.u2raw[o] / nv / nu;
      E.u_new[o] = un;
      if (last && E.u_store != nullptr) E.u_store[o] = un;
    }
    for (long long f = tid; f < F; f += kThreads) E.v[f] = E.vraw[f] / nv;
    if (tid == 0) E.sigma[0] = sig;
  }
  if (!last) return;
  const float s = sig + eps;
  const long long n = F * O;
  const long long s0 = j * E.chunk;                     // a multiple of 4
  const long long s1 = s0 + E.chunk < n ? s0 + E.chunk : n;
  long long i = s0;
  if (E.flags & kAligned) {
    const long long q1 = s1 / 4;
    const float4* w4 = reinterpret_cast<const float4*>(E.w);
    for (long long q0 = s0 / 4 + tid; q0 < q1;
         q0 += kScaleUnroll * kThreads) {
      float4 x[kScaleUnroll];
#pragma unroll
      for (int k = 0; k < kScaleUnroll; ++k) {
        const long long q = q0 + k * kThreads;
        if (q < q1) x[k] = __ldg(w4 + q);
      }
#pragma unroll
      for (int k = 0; k < kScaleUnroll; ++k) {
        const long long q = q0 + k * kThreads;
        if (q < q1) {
          const float4 y = make_float4(x[k].x / s, x[k].y / s, x[k].z / s,
                                       x[k].w / s);
          if (t.bf16) {
            const __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
            uint2 p;
            p.x = *reinterpret_cast<const unsigned int*>(&lo);
            p.y = *reinterpret_cast<const unsigned int*>(&hi);
            reinterpret_cast<uint2*>(E.wbar)[q] = p;
          } else {
            reinterpret_cast<float4*>(E.wbar)[q] = y;
          }
        }
      }
    }
    i = 4 * q1;
  }
  for (i += tid; i < s1; i += kThreads) {
    const float x = __ldg(E.w + i) / s;
    if (t.bf16) {
      reinterpret_cast<__nv_bfloat16*>(E.wbar)[i] = __float2bfloat16_rn(x);
    } else {
      reinterpret_cast<float*>(E.wbar)[i] = x;
    }
  }
}

// the three-launch design: one kernel a pass, one block a work item
__global__ void __launch_bounds__(kThreads, 4)
    sn_group_rows_kernel(const __grid_constant__ Table t, int it) {
  extern __shared__ float smem[];
  rows_work(t, blockIdx.x, it, smem);
}

__global__ void __launch_bounds__(kThreads)
    sn_group_colsum_kernel(const __grid_constant__ Table t, int it,
                           float eps) {
  colsum_work(t, blockIdx.x, it, eps);
}

__global__ void __launch_bounds__(kThreads)
    sn_group_finish_kernel(const __grid_constant__ Table t, int it,
                           float eps) {
  finish_work(t, blockIdx.x, it, eps);
}

// the cooperative design: every pass in one launch, the grid walking each
// pass's work list, a grid-wide barrier between passes
__global__ void __launch_bounds__(kThreads)
    sn_group_coop_kernel(const __grid_constant__ Table t, int max_iter,
                         long long rows_items, long long col_blocks,
                         long long fin_items, float eps) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < max_iter; ++it) {
    for (long long k = blockIdx.x; k < rows_items; k += gridDim.x)
      rows_work(t, k, it, smem);
    grid.sync();
    for (long long k = blockIdx.x; k < col_blocks; k += gridDim.x)
      colsum_work(t, k, it, eps);
    grid.sync();
    for (long long k = blockIdx.x; k < fin_items; k += gridDim.x)
      finish_work(t, k, it, eps);
    if (it + 1 < max_iter) grid.sync();
  }
}

// g at element i as fp32
__device__ __forceinline__ float g_at(const void* g, long long i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(g)[i])
              : __ldg(reinterpret_cast<const float*>(g) + i);
}

// four g values from element 4 q (aligned)
__device__ __forceinline__ float4 g4_at(const void* g, long long q,
                                        int bf16) {
  if (bf16) {
    const uint2 p = reinterpret_cast<const uint2*>(g)[q];
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&p.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&p.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return __ldg(reinterpret_cast<const float4*>(g) + q);
}

// backward pass 1, chunk k: its partial of <g, W>
__global__ void __launch_bounds__(kThreads)
    sn_group_dot_kernel(const __grid_constant__ BwdTable t) {
  __shared__ float scratch[33];
  const BwdEntry E =
      t.e[entry_of(t.e, t.n, blockIdx.x, &BwdEntry::chunk0)];
  const long long j = blockIdx.x - E.chunk0;
  const long long s0 = j * E.chunk;                     // a multiple of 4
  const long long s1 = s0 + E.chunk < E.n ? s0 + E.chunk : E.n;
  const int tid = threadIdx.x;
  float acc = 0.f;
  long long i = s0;
  if (E.flags & kAligned) {
    const long long q1 = s1 / 4;
    const float4* w4 = reinterpret_cast<const float4*>(E.w);
#pragma unroll 4
    for (long long q = s0 / 4 + tid; q < q1; q += kThreads) {
      const float4 w = __ldg(w4 + q), g = g4_at(E.g, q, t.g_bf16);
      acc += g.x * w.x;
      acc += g.y * w.y;
      acc += g.z * w.z;
      acc += g.w * w.w;
    }
    i = 4 * q1;
  }
  for (i += tid; i < s1; i += kThreads)
    acc += g_at(E.g, i, t.g_bf16) * __ldg(E.w + i);
  const float total = block_sum(acc, scratch);
  if (tid == 0) E.dots[j] = total;
}

// v[f] u[o] at element i = (a, o, r) of [A, O, R], f = a R + r; n < 2^31
__device__ __forceinline__ float vu_at(const BwdEntry& E, unsigned i) {
  const unsigned R = (unsigned)E.R, O = (unsigned)E.O;
  const unsigned q = i / R, r = i - q * R, a = q / O, o = q - a * O;
  return __ldg(E.v + a * R + r) * __ldg(E.u + o);
}

// backward pass 2, chunk k: dW = g / s - (<g, W> / s^2) v u^T, the
// weight's partials summed in the same order by every chunk; g / s a
// quotient, as the plain version computes it
__global__ void __launch_bounds__(kThreads)
    sn_group_grad_kernel(const __grid_constant__ BwdTable t, float eps) {
  __shared__ float scratch[33];
  const BwdEntry E =
      t.e[entry_of(t.e, t.n, blockIdx.x, &BwdEntry::chunk0)];
  const long long j = blockIdx.x - E.chunk0;
  const int tid = threadIdx.x;
  float acc = 0.f;
  for (long long b = tid; b < E.chunks; b += kThreads) acc += E.dots[b];
  const float inner = block_sum(acc, scratch);
  const float s = E.sigma[0] + eps;
  const float coef = inner / (s * s);
  const long long s0 = j * E.chunk;
  const long long s1 = s0 + E.chunk < E.n ? s0 + E.chunk : E.n;
  long long i = s0;
  if (E.flags & kAligned) {
    const long long q1 = s1 / 4;
    const unsigned R = (unsigned)E.R, O = (unsigned)E.O;
    for (long long q0 = s0 / 4 + tid; q0 < q1;
         q0 += kScaleUnroll * kThreads) {
      float4 gk[kScaleUnroll];
#pragma unroll
      for (int k = 0; k < kScaleUnroll; ++k) {
        const long long q = q0 + k * kThreads;
        if (q < q1) gk[k] = g4_at(E.g, q, t.g_bf16);
      }
#pragma unroll
      for (int k = 0; k < kScaleUnroll; ++k) {
        const long long q = q0 + k * kThreads;
        if (q >= q1) continue;
        const float gs[4] = {gk[k].x, gk[k].y, gk[k].z, gk[k].w};
        float d[4];
        // (a, o, r) of element 4 q, then carried along r, o, a
        const unsigned e = (unsigned)(4 * q);
        unsigned row = e / R, r = e - row * R;
        unsigned a = row / O, o = row - a * O;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float vu = __ldg(E.v + a * R + r) * __ldg(E.u + o);
          d[c] = gs[c] / s - coef * vu;
          if (++r == R) {
            r = 0;
            if (++o == O) {
              o = 0;
              ++a;
            }
          }
        }
        reinterpret_cast<float4*>(E.dw)[q] =
            make_float4(d[0], d[1], d[2], d[3]);
      }
    }
    i = 4 * q1;
  }
  for (i += tid; i < s1; i += kThreads)
    E.dw[i] = g_at(E.g, i, t.g_bf16) / s - coef * vu_at(E, (unsigned)i);
}

cudaError_t allow_smem() {
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        sn_group_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(sn_group_coop_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kMaxSmemBytes);
  }();
  return err;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Table limit and plan width, for the wrapper to check against its own.
extern "C" int sagan_sn_group_limits(int* max_weights, int* plan_fields) {
  *max_weights = kMaxWeights;
  *plan_fields = kPlanFields;
  return 0;
}

// K7 forward on `stream` over n <= kMaxWeights weights: `plan` (n rows of
// kPlanFields int64, table order), `ptrs` (n rows of w, u and the layer's
// u or 0, the same order), W_bar's flat buffer (fp32, or bf16 when
// `bf16`), `stats` (u_new, v, sigma a weight at its stat_off) and
// `scratch` (v_raw, u2_raw and the partials at its scratch_off), fp32;
// the work lists' lengths and the rows pass's shared memory.  `design`: 0
// three launches an iteration, 1 one cooperative launch.  Returns
// cudaGetLastError() after each launch (0 on success).  The caller checks
// devices, types, shapes and contiguity; every n_iter >= 1.
extern "C" int sagan_sn_group_forward(const long long* plan, int n,
                                      const long long* ptrs, void* wbar,
                                      int bf16, float* stats, float* scratch,
                                      long long rows_items,
                                      long long col_blocks,
                                      long long fin_items, int max_iter,
                                      long long smem, float eps, int design,
                                      void* stream) {
  if (n < 1 || n > kMaxWeights || max_iter < 1 || smem > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  Table t;
  t.n = n;
  t.bf16 = bf16;
  for (int i = 0; i < n; ++i) {
    const long long* p = plan + (long long)i * kPlanFields;
    Entry& E = t.e[i];
    E.w = reinterpret_cast<const float*>(ptrs[3 * i]);
    E.u = reinterpret_cast<const float*>(ptrs[3 * i + 1]);
    E.u_store = reinterpret_cast<float*>(ptrs[3 * i + 2]);
    E.wbar = bf16 ? static_cast<void*>(static_cast<__nv_bfloat16*>(wbar) +
                                       p[P_FLAT_OFF])
                  : static_cast<void*>(static_cast<float*>(wbar) +
                                       p[P_FLAT_OFF]);
    E.A = p[P_A];
    E.O = p[P_O];
    E.R = p[P_R];
    const long long F = E.A * E.R;
    E.u_new = stats + p[P_STAT_OFF];
    E.v = E.u_new + E.O;
    E.sigma = E.v + F;
    E.vraw = scratch + p[P_SCRATCH_OFF];
    E.u2raw = E.vraw + F;
    E.part = E.u2raw + E.O;
    E.csum = E.part + p[P_ITEMS] * E.O;
    E.nv = E.csum + (E.O + kColumns - 1) / kColumns;
    E.ta = p[P_TA];
    E.tr = p[P_TR];
    E.stride = p[P_STRIDE];
    E.tiles_r = p[P_TILES_R];
    E.ntiles = p[P_NTILES];
    E.per_item = p[P_PER_ITEM];
    E.items = p[P_ITEMS];
    E.item0 = p[P_ITEM0];
    E.col0 = p[P_COL0];
    E.chunk0 = p[P_CHUNK0];
    E.chunks = p[P_CHUNKS];
    E.chunk = p[P_CHUNK];
    E.n_iter = (int)p[P_N_ITER];
    E.flags = (int)p[P_FLAGS] | (aligned16(E.w) ? kAligned : 0);
    if (E.n_iter < 1 || E.n_iter > max_iter) return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    static long long occ_smem = -1;
    static int per_sm = 0, sms = 0;
    if (occ_smem != smem) {
      int dev = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, sn_group_coop_kernel, kThreads, (size_t)smem);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      occ_smem = smem;
    }
    long long most = rows_items > col_blocks ? rows_items : col_blocks;
    most = most > fin_items ? most : fin_items;
    const long long room = (long long)per_sm * sms;
    unsigned grid = (unsigned)(most < room ? most : room);
    void* args[] = {&t, &max_iter, &rows_items, &col_blocks, &fin_items,
                    &eps};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(sn_group_coop_kernel), dim3(grid),
        dim3(kThreads), args, (size_t)smem, st);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  if (design != 0) return cudaErrorInvalidValue;
  for (int it = 0; it < max_iter; ++it) {
    sn_group_rows_kernel<<<(unsigned)rows_items, kThreads, (size_t)smem,
                           st>>>(t, it);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sn_group_colsum_kernel<<<(unsigned)col_blocks, kThreads, 0, st>>>(t, it,
                                                                     eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    sn_group_finish_kernel<<<(unsigned)fin_items, kThreads, 0, st>>>(t, it,
                                                                     eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K7 backward on `stream` over the weights of the forward's plan whose
// gradient pointer is not 0: `ptrs` (n rows of g or 0, and w, table
// order), g fp32 or bf16 (`g_bf16`), dW's flat fp32 buffer (at each
// weight's flat_off), the forward's `stats` and the fp32 `dots` scratch
// (at each weight's dot_off).  Two launches; returns cudaGetLastError()
// after each (0 on success).
extern "C" int sagan_sn_group_backward(const long long* plan, int n,
                                       const long long* ptrs, int g_bf16,
                                       float* dw, const float* stats,
                                       float* dots, float eps, void* stream) {
  if (n < 1 || n > kMaxWeights) return cudaErrorInvalidValue;
  BwdTable t;
  t.n = 0;
  t.g_bf16 = g_bf16;
  long long chunks = 0;   // the live weights' chunks, consecutive
  for (int i = 0; i < n; ++i) {
    if (ptrs[2 * i] == 0) continue;   // no gradient reached this weight
    const long long* p = plan + (long long)i * kPlanFields;
    BwdEntry& E = t.e[t.n++];
    E.g = reinterpret_cast<const void*>(ptrs[2 * i]);
    E.w = reinterpret_cast<const float*>(ptrs[2 * i + 1]);
    E.dw = dw + p[P_FLAT_OFF];
    E.O = p[P_O];
    E.R = p[P_R];
    E.n = p[P_A] * E.O * E.R;
    E.u = stats + p[P_STAT_OFF];
    E.v = E.u + E.O;
    E.sigma = E.v + p[P_A] * E.R;
    E.dots = dots + p[P_DOT_OFF];
    E.chunk0 = chunks;
    E.chunks = p[P_CHUNKS];
    E.chunk = p[P_CHUNK];
    E.flags = aligned16(E.g) && aligned16(E.w) ? kAligned : 0;
    E.pad = 0;
    chunks += E.chunks;
  }
  if (t.n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sn_group_dot_kernel<<<(unsigned)chunks, kThreads, 0, st>>>(t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sn_group_grad_kernel<<<(unsigned)chunks, kThreads, 0, st>>>(t, eps);
  return cudaGetLastError();
}
