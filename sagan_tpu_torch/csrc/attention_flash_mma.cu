// SAGAN attention in bf16 on Hopper's tensor cores (sm_90a, mma.sync bf16
// -> fp32): the single-pass forward and backward, and the flash forward
// and both flash backwards (fused, and dq apart from dk, dv).
//
// Replaces six TPU kernels of sagan_tpu/ops/pallas_attention.py on bf16
// operands (fp32 operands keep the CUDA-core kernels of attention_fwd.cu,
// attention_bwd.cu and attention_flash_bwd.cu: the tensor cores take fp32
// only as TF32):
//  * _fwd_kernel (K1, launched by _fwd): attention_fwd_mma_kernel here.
//    K3's loop without the lse store: the two compute the same o.
//  * _bwd_kernel (K2, launched by _bwd_call): attention_bwd_stats_mma_
//    kernel, attention_bwd_grads_mma_kernel and attention_bwd_dq_sum_
//    kernel here, from (q, k, v, g) alone, as the TPU kernel: the softmax
//    is recomputed, and delta = sum_j p_ij dp_ij comes from dP = G V^T
//    (K2 has no o). dl = p (dp - delta) rounded to bf16 (k's type) before
//    the dQ and dK products, dV from p rounded to bf16 (v's type); dq in
//    q's type, dk and dv fp32 sums written once in k's and v's types.
//  * _flash_fwd_kernel (K3, launched by _flash_fwd):
//    attention_flash_fwd_mma_kernel here. fp32 scores, online max and sum,
//    E rounded to bf16 for the E.V product (the mma's operand type, as
//    the TPU kernel casts e to v's type), o = acc / l in bf16 and
//    lse = max + log l in fp32.
//  * _flash_dqkv_kernel (K6, launched by _flash_bwd_fused, with
//    _bwd_tile_grads and _accum_dkv): attention_flash_dqkv_mma_kernel
//    here, after attention_flash_delta_kernel. p = exp(s - lse) and
//    delta = sum g o in fp32; dl = p (g.v - delta) rounded to bf16 (k's
//    type) before the dK and dQ products; dV from p rounded to bf16 (v's
//    type). The mma operands are bf16, so both roundings are the TPU
//    kernel's by construction.
//  * _flash_dq_kernel (K4, launched by _flash_bwd, :444) and
//    _flash_dkv_kernel (K5, :515), the two-kernel backward that the route
//    takes where K6's dq partials would pass the slab budget (church512's
//    512 map at B >= 13): attention_flash_dq_mma_kernel and
//    attention_flash_dkv_mma_kernel here, after one delta pass
//    (attention_flash_dq_delta_kernel) that both read. The same p, delta
//    and roundings as K6: dl in bf16 (k's type) before the dQ and dK
//    products, p in bf16 (v's type) before dV.
//
//   q [B, N, D]  k [B, M, D]  v [B, M, C]  g, o [B, N, C]  lse [B, N] fp32
//   -> o [B, N, C] (K1), and lse (K3)
//   -> dq [B, N, D], dk [B, M, D], dv [B, M, C] (K2)
//   -> dk, dv and dq partials fp32 [B, NKB, N, D] (K6, NKB key blocks,
//      summed by the caller in key-block order)
//   -> dq (K4) | dk, dv (K5)
//
// What bounds them on the H100: per (query, key) pair one exponential on
// the SFUs (16 a clock an SM: 16.4 ms for the 6.9e10 pairs of church512's
// 512 map at B = 4, 0.064 ms for the 2.7e8 of church64 G's 64 map at
// B = 64), a few fp32 instructions (the exponent's FFMA, the row max and
// sum in K1 and K3; dl's FSUB and FMUL in K6; bf16 packing) and, on the
// tensor cores, the thin contractions padded to the mma's shapes: d = 2
// padded to k = 8 (m16n8k8) for the scores, c = 8 exactly n8 or k8. The
// bytes are a few tens of MB (~20 us at the 512 map, ~3 us at the 64
// map), so the SFU and the rate at which those instructions are issued
// bind, not memory. K2 takes two exponentials a pair (its scores are
// recomputed twice): a floor of 0.128 ms at the 64 map. So does the pair
// K4 + K5 (each recomputes p): 16.4 ms a kernel at the 512 map at B = 4,
// besides its padded thin contractions (K4: S and dP on m16n8k8, dQ on
// m16n8k16 with d = 2 padded to n8; K5: S^T, dP^T, dV and dK as in K6).
//
// K3's design (FlashAttention-2's forward on mma.sync), each choice the
// fastest of the alternatives the study times (the switches below;
// PERF.md §6 has the readings):
//  * a block of 4 warps, a warp one m16 row tile; Q's A fragments stay in
//    registers, zero past d and past N;
//  * K and V walked in 64-key tiles, each staged by cp.async between two
//    barriers (the SM's other blocks run while one loads), zero-filled
//    past M; staged rows are 16-byte multiples, padded to an odd count of
//    16-byte units so ldmatrix reads them without bank conflicts;
//  * the exponent is one FFMA, s log2e - m log2e, into ex2.approx; the
//    rescale factor is exactly 1 while a row's max holds, and every tile
//    rescales (4 multiplies a lane);
//  * only a ragged last tile masks keys past M (full tiles run no mask);
//  * the scores' C fragments are, packed to bf16, the A fragments of P.V
//    (two n8 score tiles are one k16 tile of P), and V's B fragments come
//    from ldmatrix.trans of the row-major staged V.
//
// K1's design: K3's loop (one body, fwd_mma_body), with the tiles chosen
// for the single-pass shapes (M <= 5,857 keys, at most 1,024 on the model
// paths), each choice timed against its alternative by the 64-map study
// (sagan_tpu_torch/tools/bench_attn_floor.py, k1_mma; PERF.md §6):
//  * the whole key set is staged once, by cp.async in one group, where it
//    fits kK1WholeBytes of shared memory (church64 G's 64 map: 1,024 keys
//    of 32 bytes, 32 KB), so the key loop runs without a barrier; a key
//    set past it is walked in 64-key tiles as K3 walks them. A K3 shape
//    never fits; a single-pass one mostly does;
//  * a block of 8 warps, a warp one m16 row tile: 128 query rows a block,
//    2,048 blocks at church64 G's 64 map at B = 64. Each choice alone
//    reads slower than the two together (K3's tile walk with 8 warps
//    slowest); two row tiles a warp read slower too.
//
// K2's design: two passes over the pairs and a sum, 3 launches, no
// atomics (the same bits every run):
//  * (a) attention_bwd_stats_mma_kernel, K1's loop (fwd_mma_body again, the
//    key set staged as K1 stages it, 4 warps a block)
//    with dP = G V^T on the mma beside S = Q K^T (m16n8k8 where c = 8): the
//    online max, l = sum e and A = sum e dp in fp32 from the C fragments,
//    and each row's (-lse log2e, delta = A / l) written as the float2 that
//    K6 reads, padded rows (-inf, 0). delta is not taken from g . o: K2
//    keeps no o;
//  * (b) attention_bwd_grads_mma_kernel, K6's key-major body on those
//    pairs, with the key block sized to fill the card: K6's 8 x KT m16 key
//    tiles, KT halved (down to 1) while the grid holds fewer than kK2Fill
//    blocks an SM (church64 G's 64 map at B = 64: KT 2, 256 keys, 256
//    blocks, where K6's 1,024 keys would make 64 blocks for 132 SMs; both
//    K6's key block and a fill of 2 blocks an SM read slower there);
//  * (c) attention_bwd_dq_sum_kernel sums the fp32 dq partials of (b),
//    [B, NKB, N, D], in key-block order and writes dq in bf16 (16.8 MB of
//    partials at the 64 map).
//
// K6's design (FlashAttention-2's backward, key-major as the CUDA-core
// K6):
//  * attention_flash_delta_kernel first writes, for every query row,
//    (-lse log2e, delta = g . o) fp32, rows padded to the query tile with
//    (-inf, 0) so that a padded row's p is exactly 0;
//  * a block of W warps owns a key block of W x KT m16 key tiles (KT from
//    the register budget of the dK and dV accumulators: 8 at d = 2,
//    c = 8), staged once in shared memory; dK and dV accumulate in fp32 C
//    fragments. W is 16 (2,048 keys at d = 2, c = 8) at d <= 16, 8 at
//    d = 32: k6_warps, below;
//  * the block walks the query rows in 64-row tiles (Q, dO and the
//    (-lse log2e, delta) pairs) staged by cp.async in a ring of 3;
//  * the query tile, the warps, the key tiles a warp and the ring are
//    switches at build time (SAGAN_K6_*, below), for the backward
//    studies' sweep of K6's (query tile, key block) (bench_attn_bwd256
//    and bench_attn_floor512, k6_mma; PERF.md §6);
//  * S^T = K Q^T and dP^T = V dO^T on the mma with keys as its M rows, so
//    P^T and dS^T, packed to bf16, are the A fragments of dV += P^T dO and
//    dK += dS^T Q; dS itself, for dQ = dS K, is dS^T transposed in
//    registers by movmatrix (four 8x8 blocks make the A fragment), one
//    mma per 16 queries and 16 keys rather than D FMAs a pair on the CUDA
//    cores, and with dl rounded to bf16 as the TPU kernel rounds it;
//  * keys past M are staged as zeros, so their dQ terms are 0 and their dK
//    and dV are not written; no pair needs a mask;
//  * each warp sums its key tiles' dQ in its mma accumulators, the warps'
//    sums meet in shared memory in warp order, and the block writes its
//    fp32 dq partial rows once: no atomics, the same bits every run.
//
// K4's design (FlashAttention-2's dq pass; K3's loop, fwd_mma_body, with
// kOutDq):
//  * a block of 4 warps, a warp one m16 tile of query rows, Q and dO held
//    as A fragments in registers, each row's (-lse log2e, delta) read once
//    from the delta pass;
//  * K and V walked in 64-key tiles staged by cp.async as K3 stages them;
//    per tile S = Q K^T and dP = dO V^T on the mma, p = 2^(s log2e -
//    lse log2e) with the exponent one FFMA, no online max and no rescale
//    (p is exact from lse), dl = p (dp - delta);
//  * dl's C fragments, packed to bf16, are the A fragments of dQ += dl K
//    (two n8 score tiles make one k16 tile, as K3 builds P for P V), K's B
//    fragments by ldmatrix.trans of its row-major staged rows;
//  * dq sums a 1,024-key group in fp32 C fragments and adds it to the
//    row's running fp32 sum once a group, in key order (the groups of the
//    CUDA-core K4 and of PLAIN_KEY_BLOCK); a warp owns its rows' whole sum:
//    no partials, no atomics, the same bits every run;
//  * keys past M are staged as zeros and only a ragged last tile masks.
// K5's design: K6's key-major body (dqkv_mma_body) with dQ switched off at
// compile time: no movmatrix, no dQ mma, no warp sum through shared memory
// and no partial slab; 8 warps own 8 x KT m16 key tiles (K6's KT) with dK
// and dV in fp32 C fragments, written once in k's and v's types, and walk
// the query rows in 64-row tiles through K6's cp.async ring; its
// registers are left to the compiler (145 at d = 2, c = 8: one block an
// SM). Each choice is the fastest of the study's flips (bench_attn_floor512
// k45_mma; PERF.md §6): K4's 128-key stage, its 8-warp block, K5 at twice
// K6's KT and K5 held to two blocks an SM each read slower.
//
// The value width C is fixed per build (-DSAGAN_ATTN_C=8, 16, ...), one
// small library per width holding all the kernels; D in {2, 4, 8, 16,
// 32} is a template argument.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

#ifndef SAGAN_ATTN_C
#error "build with -DSAGAN_ATTN_C=<value width>"
#endif

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// ---- K3 and K1: the forward; K2's stats pass ------------------------------

// Each of K3's design choices can be flipped at build time, for the study
// of what each is worth (sagan_tpu_torch/tools/bench_attn_floor512.py):
// -DSAGAN_MMA_STAGES=3 stages the tiles by cp.async in a ring of 3 (the
// next two load while one is used), -DSAGAN_MMA_ROW_TILES=2 gives a warp
// two m16 row tiles,
// -DSAGAN_MMA_MASK_ALL=1 masks every tile and
// -DSAGAN_MMA_VOTE=1 skips the rescale in a tile where no row's max moved
// (a warp vote). The defaults are the shipped kernel. They leave K1 and
// K2 as they are.
#ifdef SAGAN_MMA_STAGES
constexpr int kFwdStages = SAGAN_MMA_STAGES;
#else
constexpr int kFwdStages = 1;
#endif
#ifdef SAGAN_MMA_MASK_ALL
constexpr bool kMaskAll = SAGAN_MMA_MASK_ALL;
#else
constexpr bool kMaskAll = false;
#endif
#ifdef SAGAN_MMA_VOTE
constexpr bool kVote = SAGAN_MMA_VOTE;
#else
constexpr bool kVote = false;
#endif
static_assert(kFwdStages >= 1, "SAGAN_MMA_STAGES: at least one stage");

// The math of K1 and K3, switched at build time: the tensor-core variants
// of the study forward S1 are these builds (ops/cuda_attention_study.py
// MMA_VARIANT_DEFINES), each removing or moving one part of the shipped
// forward, so that its time beside the default's says what that part
// costs. -DSAGAN_MMA_MATH= takes
//  exp    e = __expf(s - m), the rescale __expf(m_old - m_new) (in place
//         of the exponent's one FFMA into ex2.approx);
//  nomax  e = __expf(s): no max and no rescale;
//  noexp  NOT attention: e = s - M with M the row's max over all keys,
//         o = sum e v / sum e. e is linear in s, so the pass keeps sum s v,
//         sum s, sum v and the running max, and forms o = (sum s v -
//         M sum v) / (sum s - M count) at the end: no transcendental, no
//         rescale. s is not in [0, 1], so s v takes two bf16 mmas (s and
//         its rounding residue, s to ~2^-16); sum v is one more mma of
//         ones by V's fragments, so each warp sums each key once, however
//         the keys were staged. Its lse is not a log-sum-exp;
//  e16    the exp math with P rounded to bf16 before the row sum too.
// -DSAGAN_MMA_FMA_SCORES=1 computes S = Q K^T with fmaf in the C
// fragment's layout (row g and g + 8, keys 2t and 2t + 1 of each n8
// group) in place of the m16n8k8 mma (d <= 8; wider d keeps the mma).
// The default, exp2 with one FFMA, is the shipped kernel. They leave K2's
// stats pass and K4 as they are.
enum Math { kMath_exp2, kMath_exp, kMath_nomax, kMath_noexp, kMath_e16 };
#define SAGAN_PASTE(a, b) a##b
#define SAGAN_MATH(name) SAGAN_PASTE(kMath_, name)
#ifdef SAGAN_MMA_MATH
constexpr Math kMath = SAGAN_MATH(SAGAN_MMA_MATH);
#else
constexpr Math kMath = kMath_exp2;
#endif
#ifdef SAGAN_MMA_FMA_SCORES
constexpr bool kFmaScores = SAGAN_MMA_FMA_SCORES;
#else
constexpr bool kFmaScores = false;
#endif

// K1's and K2's choices, flipped at build time for the 64-map study
// (sagan_tpu_torch/tools/bench_attn_floor.py, k1_mma and k2_mma):
// -DSAGAN_K1_WHOLE_BYTES=0 walks every key set in 64-key tiles as K3 does
// (else the whole key set is staged once where it fits that many bytes;
// K2's stats pass follows the same rule), -DSAGAN_K1_ROW_TILES=2 gives a
// warp two m16 row tiles, -DSAGAN_K1_WARPS=4 makes a block 4 warps, and
// -DSAGAN_K2_FILL=0 gives K2's gradient pass K6's key block (else KT is
// halved while the grid holds fewer than that many blocks an SM). The
// defaults are the shipped kernels.
#ifdef SAGAN_K1_WHOLE_BYTES
constexpr int kK1WholeBytes = SAGAN_K1_WHOLE_BYTES;
#else
constexpr int kK1WholeBytes = 48 * 1024;
#endif
#ifdef SAGAN_K1_ROW_TILES
constexpr int kK1RowTiles = SAGAN_K1_ROW_TILES;
#else
constexpr int kK1RowTiles = 1;
#endif
#ifdef SAGAN_K1_WARPS
constexpr int kK1Warps = SAGAN_K1_WARPS;
#else
constexpr int kK1Warps = 8;
#endif
#ifdef SAGAN_K2_FILL
constexpr int kK2Fill = SAGAN_K2_FILL;
#else
constexpr int kK2Fill = 1;
#endif
static_assert(kK1WholeBytes <= 227 * 1024, "SAGAN_K1_WHOLE_BYTES: at most "
              "the 227 KB of shared memory a block can have");

// K4's and K5's choices, flipped at build time for the 512-map study
// (sagan_tpu_torch/tools/bench_attn_floor512.py, k45_mma):
// -DSAGAN_K4_TILE=128 stages K4's keys 128 at a time (two 64-key register
// tiles between one pair of barriers), -DSAGAN_K4_WARPS=8 makes K4's block
// 8 warps, -DSAGAN_K5_KT_SCALE=2 gives K5's warps twice K6's key tiles,
// and -DSAGAN_K5_MIN_BLOCKS=2 asks the compiler for two K5 blocks an SM
// (at most 128 registers a thread; else it leaves K5's registers to the
// compiler). The defaults are the shipped kernels.
#ifdef SAGAN_K4_TILE
constexpr int kK4Tile = SAGAN_K4_TILE;
#else
constexpr int kK4Tile = 64;
#endif
#ifdef SAGAN_K4_WARPS
constexpr int kK4Warps = SAGAN_K4_WARPS;
#else
constexpr int kK4Warps = 4;
#endif
#ifdef SAGAN_K5_KT_SCALE
constexpr int kK5KtScale = SAGAN_K5_KT_SCALE;
#else
constexpr int kK5KtScale = 1;
#endif
#ifdef SAGAN_K5_MIN_BLOCKS
constexpr int kK5MinBlocks = SAGAN_K5_MIN_BLOCKS;
#else
constexpr int kK5MinBlocks = 1;
#endif

constexpr int kFwdWarps = 4;
constexpr int kFwdTile = 64;  // keys a stage
constexpr int kFwdGroups = kFwdTile / 8;  // n8 key groups a tile
constexpr int kStatsWarps = 4;  // K2's stats pass: 64 query rows a block
constexpr int kStatsRows = 16 * kStatsWarps;
// K4 adds a 1,024-key group's dq to the row's running sum once a group:
// the groups of the CUDA-core K4 and of the plain version
// (ops/attention.py PLAIN_KEY_BLOCK); one running sum over 65,536 keys
// loses the terms far below it
constexpr int kDqGroupTiles = 1024 / kFwdTile;
static_assert(kK4Tile % kFwdTile == 0 && 1024 % kK4Tile == 0,
              "SAGAN_K4_TILE: a multiple of 64 keys that divides 1,024");

// m16 row tiles a warp
#ifdef SAGAN_MMA_ROW_TILES
constexpr int kRowTiles = SAGAN_MMA_ROW_TILES;
#else
constexpr int kRowTiles = 1;
#endif

// what a pass of fwd_mma_body writes
enum FwdOut { kOutFlash, kOutFwd, kOutStats, kOutDq };

template <int D, int C>
struct FwdSmem {
  static constexpr int kKRow = row_units(D) * 16;
  static constexpr int kVRow = row_units(C) * 16;
  static constexpr int kK = kFwdTile * kKRow;
  static constexpr int kStage = kK + kFwdTile * kVRow;
};

// shared memory of a forward-shaped pass: a stage for every tile of the
// key set where it is staged whole, else a ring of `stages`
template <int D, int C>
__host__ __device__ inline int fwd_smem_bytes(int m, bool whole, int stages) {
  const int tiles = (m + kFwdTile - 1) / kFwdTile;
  return (whole ? tiles : stages) * FwdSmem<D, C>::kStage;
}

// the key set of a K1 or K2 stats pass is staged whole where it fits
template <int D, int C>
__host__ inline bool stage_whole(int m) {
  return fwd_smem_bytes<D, C>(m, true, 1) <= kK1WholeBytes;
}

// K1, K3, K2's stats pass and K4: a block of kWarps warps, RT m16 row
// tiles a warp, walks the key set in 64-key tiles (staged whole where
// kWhole, else kST tiles at a time through a cp.async ring of kStages)
// with the mma scores. kOutFlash and kOutFwd take an online softmax,
// accumulate P V and write o (and, for kOutFlash, lse) to `out`;
// kOutStats computes dP = G V^T beside the scores, accumulates
// A = sum e dp, and writes each row's (-lse log2e, A / l), rows n..npad-1
// (-inf, 0). kOutDq reads those pairs from `ld` (no softmax state: p is
// exact from lse), computes dP as the stats do, accumulates dL K with
// dL = p (dp - delta) rounded to bf16, and writes dq to `out`.
template <int D, int C, int kOut, int kWarps, int RT, int kStages,
          bool kWhole, int kST = 1>
__device__ __forceinline__ void fwd_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ gin,
    bf16* __restrict__ out, float* __restrict__ lse,
    float2* __restrict__ ld, int n, int m, int npad) {
  constexpr int kThreads = 32 * kWarps;
  constexpr bool kStats = kOut == kOutStats;
  constexpr bool kFlash = kOut == kOutFlash;
  constexpr bool kDq = kOut == kOutDq;
  constexpr bool kDp = kStats || kDq;  // dP = G V^T beside the scores
  constexpr bool kK8 = D <= 8;       // scores on m16n8k8
  constexpr int KS = kK8 ? 1 : D / 16;  // k16 steps of the scores
  constexpr bool kCK8 = C == 8;      // dP on m16n8k8
  constexpr int CS = kCK8 ? 1 : C / 16;  // k16 steps of dP
  constexpr int NT = C / 8;          // n8 channel tiles
  constexpr int DT = (D + 7) / 8;    // n8 dim tiles of dQ
  constexpr int OT = kDq ? DT : NT;  // n8 tiles of the accumulated product
  constexpr bool kMask = kFlash && kMaskAll;
  constexpr bool kVt = kFlash && kVote;
  // the math switches act on K1 and K3 alone
  constexpr bool kFwd = kFlash || kOut == kOutFwd;
  constexpr Math kM = kFwd ? kMath : kMath_exp2;
  constexpr bool kEx = kM == kMath_exp || kM == kMath_e16;  // __expf(s - m)
  constexpr bool kE16 = kM == kMath_e16;
  constexpr bool kNoMax = kM == kMath_nomax;
  constexpr bool kNoExp = kM == kMath_noexp;
  constexpr bool kFmaS = kFwd && kFmaScores && kK8;  // scores by fmaf
  static_assert(kST == 1 || (!kWhole && kStages == 1),
                "several tiles a stage: synchronous staging only");
  using S = FwdSmem<D, C>;
  extern __shared__ __align__(16) char smem[];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // rows g and g + 8 of each row tile
  const int t = lane & 3;   // keys (channels) 2t and 2t + 1 of each n8
  const int row0 = (blockIdx.x * kWarps + warp) * 16 * RT;
  const bf16* kb = k + (size_t)b * m * D;
  const bf16* vb = v + (size_t)b * m * C;
  const int tiles = (m + kFwdTile - 1) / kFwdTile;
  // the shared-memory slot of a 64-key tile
  auto slot = [&](int tile) {
    return kWhole ? tile : (tile / kST % kStages) * kST + tile % kST;
  };

  // the padding of staged rows is never written by cp.async: zero it
  zero_smem(smem, (kWhole ? tiles : kStages * kST) * S::kStage, kThreads);
  __syncthreads();
  auto load = [&](int stage) {  // tiles stage * kST .. + kST - 1
#pragma unroll
    for (int i = 0; i < kST; ++i) {
      const int tile = stage * kST + i;
      if (tile < tiles) {
        char* st = smem + slot(tile) * S::kStage;
        stage_rows<D, kThreads>(st, kb, tile * kFwdTile, kFwdTile, m);
        stage_rows<C, kThreads>(st + S::kK, vb, tile * kFwdTile, kFwdTile,
                                m);
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  if constexpr (kWhole) {
    for (int s = 0; s < tiles; ++s) load(s);
  } else {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) load(s);
  }

  // Q's (and, for the stats, G's) A fragments: a row's w values are w/2
  // words; zero past w and N
  auto aword = [&](const bf16* base, int w, int row, int word) -> uint32_t {
    return row < n && 2 * word < w
               ? reinterpret_cast<const uint32_t*>(base)[
                     ((size_t)b * n + row) * (w / 2) + word]
               : 0u;
  };
  uint32_t qa[RT][KS][4];
  uint32_t ga[RT][kDp ? CS : 1][4];
  // the fma scores: rows g and g + 8 of each row tile, all d values, fp32
  float qv[RT][2][kFmaS ? D : 1];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    const int lo = row0 + 16 * rt + g;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[rt][ks][0] = aword(q, D, lo, 8 * ks + t);
      qa[rt][ks][1] = aword(q, D, lo + 8, 8 * ks + t);
      qa[rt][ks][2] = aword(q, D, lo, 8 * ks + 4 + t);
      qa[rt][ks][3] = aword(q, D, lo + 8, 8 * ks + 4 + t);
    }
    if constexpr (kFmaS) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int w = 0; w < D / 2; ++w) {
          const float2 x = unpack_bf16(aword(q, D, lo + 8 * r, w));
          qv[rt][r][2 * w] = x.x;
          qv[rt][r][2 * w + 1] = x.y;
        }
    }
    if constexpr (kDp) {
#pragma unroll
      for (int cs = 0; cs < CS; ++cs) {
        ga[rt][cs][0] = aword(gin, C, lo, 8 * cs + t);
        ga[rt][cs][1] = aword(gin, C, lo + 8, 8 * cs + t);
        ga[rt][cs][2] = aword(gin, C, lo, 8 * cs + 4 + t);
        ga[rt][cs][3] = aword(gin, C, lo + 8, 8 * cs + 4 + t);
      }
    }
  }

  // acc: P V (dq: one 1,024-key group's dL K, added to tot once a group)
  float acc[RT][kStats ? 1 : OT][4], tot[RT][kDq ? DT : 1][4];
  float mx[RT][2], nm[RT][2], l[RT][2];  // running max, -max log2e, sum
  float asum[RT][2];                     // the stats' sum of e dp
  float sv[kNoExp ? NT : 1][4] = {};     // noexp: sum v (1 V, every row)
  float2 lq[RT][2];  // dq: the row's (-lse log2e, delta); padded (-inf, 0)
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
    for (int j = 0; j < (kStats ? 1 : OT); ++j)
      acc[rt][j][0] = acc[rt][j][1] = acc[rt][j][2] = acc[rt][j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < (kDq ? DT : 1); ++j)
      tot[rt][j][0] = tot[rt][j][1] = tot[rt][j][2] = tot[rt][j][3] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[rt][r] = -INFINITY;
      nm[rt][r] = INFINITY;
      l[rt][r] = 0.f;
      asum[rt][r] = 0.f;
      if constexpr (kDq) {
        const int row = row0 + 16 * rt + g + 8 * r;
        lq[rt][r] = row < n ? ld[(size_t)b * npad + row]
                            : make_float2(-INFINITY, 0.f);
      }
    }
  }

  if constexpr (kWhole) {
    cp_async_wait<0>();  // the whole key set has landed
    __syncthreads();
  }
  for (int it = 0; it < tiles; ++it) {
    if constexpr (kWhole) {
      // staged once: no barrier in the loop
    } else if constexpr (kStages == 1) {
      if (it % kST == 0) {
        __syncthreads();  // every thread is done with the last stage
        load(it / kST);
        cp_async_wait<0>();
        __syncthreads();
      }
    } else {
      cp_async_wait<kStages - 2>();  // tile `it` has landed
      __syncthreads();  // ... for every thread, all done with it - 1
      load(it + kStages - 1);
    }
    const char* ks_ = smem + slot(it) * S::kStage;
    const char* vs = ks_ + S::kK;

    // B fragments of K^T: key group h's rows, d values as the mma's k
    uint32_t kf[kFwdGroups][KS][2];
    if constexpr (kFmaS) {
      // no B fragments: each lane reads its keys' rows below
    } else if constexpr (kK8) {
#pragma unroll
      for (int h0 = 0; h0 < kFwdGroups; h0 += 4)
        ldsm_x4(kf[h0][0][0], kf[h0 + 1][0][0], kf[h0 + 2][0][0],
                kf[h0 + 3][0][0], ks_ + (8 * h0 + lane) * S::kKRow);
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int h0 = 0; h0 < kFwdGroups; h0 += 2)
          ldsm_x4(kf[h0][ks][0], kf[h0][ks][1], kf[h0 + 1][ks][0],
                  kf[h0 + 1][ks][1],
                  ks_ + (8 * (h0 + (lane >> 4)) + (lane & 7)) * S::kKRow +
                      (2 * ks + ((lane >> 3) & 1)) * 16);
      }
    }

    // scores: s[rt][h][0..1] row g, s[rt][h][2..3] row g + 8, keys
    // 8h + 2t, + 1
    float s[RT][kFwdGroups][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
      for (int h = 0; h < kFwdGroups; ++h) {
        s[rt][h][0] = s[rt][h][1] = s[rt][h][2] = s[rt][h][3] = 0.f;
        if constexpr (kFmaS) {
          // keys 8h + 2t and 8h + 2t + 1, d values in order
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t* kr = reinterpret_cast<const uint32_t*>(
                ks_ + (8 * h + 2 * t + (e & 1)) * S::kKRow);
#pragma unroll
            for (int w = 0; w < D / 2; ++w) {
              const float2 x = unpack_bf16(kr[w]);
              s[rt][h][e] = fmaf(qv[rt][e >> 1][2 * w], x.x, s[rt][h][e]);
              s[rt][h][e] = fmaf(qv[rt][e >> 1][2 * w + 1], x.y, s[rt][h][e]);
            }
          }
        } else if constexpr (kK8) {
          mma_bf16_k8(s[rt][h], qa[rt][0][0], qa[rt][0][1], kf[h][0][0]);
        } else {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            mma_bf16(s[rt][h], qa[rt][ks][0], qa[rt][ks][1], qa[rt][ks][2],
                     qa[rt][ks][3], kf[h][ks][0], kf[h][ks][1]);
        }
      }
    }
    // dP = G V^T (the stats, dq) in the scores' layout; V's B fragments
    // loaded a few key groups at a time (a wide C would hold 16 words a
    // group). Keys past M are staged as zeros: their dp is 0
    float dp[RT][kDp ? kFwdGroups : 1][4];
    if constexpr (kDp) {
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int h = 0; h < kFwdGroups; ++h)
          dp[rt][h][0] = dp[rt][h][1] = dp[rt][h][2] = dp[rt][h][3] = 0.f;
      if constexpr (kCK8) {
#pragma unroll
        for (int h0 = 0; h0 < kFwdGroups; h0 += 4) {
          uint32_t vf[4];
          ldsm_x4(vf[0], vf[1], vf[2], vf[3], vs + (8 * h0 + lane) * S::kVRow);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int rt = 0; rt < RT; ++rt)
              mma_bf16_k8(dp[rt][h0 + i], ga[rt][0][0], ga[rt][0][1], vf[i]);
        }
      } else {
#pragma unroll
        for (int cs = 0; cs < CS; ++cs) {
#pragma unroll
          for (int h0 = 0; h0 < kFwdGroups; h0 += 2) {
            uint32_t vf[4];
            ldsm_x4(vf[0], vf[1], vf[2], vf[3],
                    vs + (8 * (h0 + (lane >> 4)) + (lane & 7)) * S::kVRow +
                        (2 * cs + ((lane >> 3) & 1)) * 16);
#pragma unroll
            for (int rt = 0; rt < RT; ++rt) {
              mma_bf16(dp[rt][h0], ga[rt][cs][0], ga[rt][cs][1], ga[rt][cs][2],
                       ga[rt][cs][3], vf[0], vf[1]);
              mma_bf16(dp[rt][h0 + 1], ga[rt][cs][0], ga[rt][cs][1],
                       ga[rt][cs][2], ga[rt][cs][3], vf[2], vf[3]);
            }
          }
        }
      }
    }
    const int tm = m - it * kFwdTile;
    const bool ragged = kMask || tm < kFwdTile;
    // keys past M weigh 0: only the ragged last tile has them
    if (ragged) {
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int h = 0; h < kFwdGroups; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * h + 2 * t + (e & 1) >= tm) s[rt][h][e] = -INFINITY;
    }

    if constexpr (kDq) {
      // p = 2^(s log2e - lse log2e) exactly, dL = p (dp - delta) in place
      // of s; a masked key's p is 2^-inf = 0
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int h = 0; h < kFwdGroups; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = lq[rt][e >> 1];
            s[rt][h][e] = ex2(fmaf(s[rt][h][e], kLog2e, x.x)) *
                          (dp[rt][h][e] - x.y);
          }
    } else {
      // the online softmax: e = 2^(s log2e - m log2e) in place of s
      float scale[RT][2], tl[RT][2], ta[RT][2];
      bool moved = false;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if constexpr (kNoMax || kNoExp) {
            // nomax: e = exp(s); noexp: e stays s (the max is taken over
            // keys within M, then a key past M adds 0); no rescale
            float tmax = -INFINITY, sum = 0.f;
#pragma unroll
            for (int h = 0; h < kFwdGroups; ++h) {
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e) {
                if constexpr (kNoMax) {
                  s[rt][h][e] = __expf(s[rt][h][e]);
                } else {
                  tmax = fmaxf(tmax, s[rt][h][e]);
                  if (ragged && s[rt][h][e] == -INFINITY) s[rt][h][e] = 0.f;
                }
                sum += s[rt][h][e];
              }
            }
            if constexpr (kNoExp) mx[rt][r] = fmaxf(mx[rt][r], quad_max(tmax));
            tl[rt][r] = sum;
            continue;
          }
          float tmax = -INFINITY;
#pragma unroll
          for (int h = 0; h < kFwdGroups; ++h)
            tmax = fmaxf(tmax, fmaxf(s[rt][h][2 * r], s[rt][h][2 * r + 1]));
          const float m_new = fmaxf(mx[rt][r], quad_max(tmax));
          const float nm_new = -m_new * kLog2e;
          // exactly 1 while the max holds; 0 on the first tile
          const bool up = nm_new != nm[rt][r];
          moved |= up;
          if constexpr (kEx)
            scale[rt][r] = __expf(mx[rt][r] - m_new);
          else
            scale[rt][r] = up ? ex2(nm_new - nm[rt][r]) : 1.f;
          mx[rt][r] = m_new;
          nm[rt][r] = nm_new;
          float sum = 0.f, asm_ = 0.f;
#pragma unroll
          for (int h = 0; h < kFwdGroups; ++h) {
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              s[rt][h][e] = kEx ? __expf(s[rt][h][e] - m_new)
                                : ex2(fmaf(s[rt][h][e], kLog2e, nm_new));
              if constexpr (kE16) s[rt][h][e] = round_bf16(s[rt][h][e]);
              sum += s[rt][h][e];
              if constexpr (kStats)
                asm_ = fmaf(s[rt][h][e], dp[rt][h][e], asm_);
            }
          }
          tl[rt][r] = sum;  // the tile's terms, added to l once
          ta[rt][r] = asm_;
        }
      }
      if constexpr (kStats) {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[rt][r] = fmaf(l[rt][r], scale[rt][r], tl[rt][r]);
            asum[rt][r] = fmaf(asum[rt][r], scale[rt][r], ta[rt][r]);
          }
        continue;
      }
      if constexpr (kNoMax || kNoExp) {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int r = 0; r < 2; ++r) l[rt][r] += tl[rt][r];
      } else if (!kVt || __any_sync(kFull, moved)) {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            acc[rt][j][0] *= scale[rt][0];
            acc[rt][j][1] *= scale[rt][0];
            acc[rt][j][2] *= scale[rt][1];
            acc[rt][j][3] *= scale[rt][1];
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) l[rt][r] = fmaf(l[rt][r], scale[rt][r],
                                                      tl[rt][r]);
        }
      } else {  // every scale is 1: the same bits as fmaf(l, 1, tl)
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int r = 0; r < 2; ++r) l[rt][r] += tl[rt][r];
      }
    }

    // acc += P V (dq: dL K), 16 keys an mma: key groups 2u and 2u + 1 of
    // the scores are the A fragment of keys 16u..16u+15; V's (K's) B
    // fragments by ldmatrix.trans of its staged rows, two k16 steps at a
    // time
    const char* os = kDq ? ks_ : vs;
    constexpr int kORow = kDq ? S::kKRow : S::kVRow;
#pragma unroll
    for (int u = 0; u < kFwdGroups / 2; u += 2) {
      uint32_t pa[RT][2][4];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const float* lo = s[rt][2 * (u + w)];
          const float* hi = s[rt][2 * (u + w) + 1];
          pa[rt][w][0] = pack_bf16(lo[0], lo[1]);
          pa[rt][w][1] = pack_bf16(lo[2], lo[3]);
          pa[rt][w][2] = pack_bf16(hi[0], hi[1]);
          pa[rt][w][3] = pack_bf16(hi[2], hi[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < (kStats ? 1 : OT); ++j) {
        uint32_t vf[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(vf[0]), "=r"(vf[1]), "=r"(vf[2]), "=r"(vf[3])
            : "r"(smem_addr(os + (16 * u + lane) * kORow + 16 * j)));
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
          for (int w = 0; w < 2; ++w)
            mma_bf16(acc[rt][j], pa[rt][w][0], pa[rt][w][1], pa[rt][w][2],
                     pa[rt][w][3], vf[2 * w], vf[2 * w + 1]);
        }
        if constexpr (kNoExp) {
#pragma unroll
          for (int w = 0; w < 2; ++w) {
#pragma unroll
            for (int rt = 0; rt < RT; ++rt) {
              // s's rounding residue, a second bf16 term of s v
              const float* lo = s[rt][2 * (u + w)];
              const float* hi = s[rt][2 * (u + w) + 1];
              mma_bf16(acc[rt][j],
                       pack_bf16(lo[0] - round_bf16(lo[0]),
                                 lo[1] - round_bf16(lo[1])),
                       pack_bf16(lo[2] - round_bf16(lo[2]),
                                 lo[3] - round_bf16(lo[3])),
                       pack_bf16(hi[0] - round_bf16(hi[0]),
                                 hi[1] - round_bf16(hi[1])),
                       pack_bf16(hi[2] - round_bf16(hi[2]),
                                 hi[3] - round_bf16(hi[3])),
                       vf[2 * w], vf[2 * w + 1]);
            }
            // sum v: ones (bf16 1.0 in both halves) by V's fragments
            constexpr uint32_t kOnes = 0x3f803f80u;
            mma_bf16(sv[j], kOnes, kOnes, kOnes, kOnes, vf[2 * w],
                     vf[2 * w + 1]);
          }
        }
      }
    }
    if constexpr (kDq) {
      if ((it + 1) % kDqGroupTiles == 0) {  // a group's end, in key order
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int j = 0; j < DT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[rt][j][e] += acc[rt][j][e];
              acc[rt][j][e] = 0.f;
            }
      }
    }
  }

  if constexpr (kStats) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lsum = quad_sum(l[rt][r]);
        const float a = quad_sum(asum[rt][r]);
        const int row = row0 + 16 * rt + g + 8 * r;
        if (t == 0 && row < npad)
          ld[(size_t)b * npad + row] =
              row < n ? make_float2(nm[rt][r] - log2f(lsum), a / lsum)
                      : make_float2(-INFINITY, 0.f);
      }
    }
  } else if constexpr (kDq) {
    // dq rows g, g + 8, dims 8j + 2t, + 1, in q's type
    uint32_t* dw = reinterpret_cast<uint32_t*>(out) + (size_t)b * n * (D / 2);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * rt + g + 8 * r;
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < DT; ++j)
          if (8 * j + 2 * t < D)
            dw[(size_t)row * (D / 2) + 4 * j + t] = pack_bf16(
                tot[rt][j][2 * r] + acc[rt][j][2 * r],
                tot[rt][j][2 * r + 1] + acc[rt][j][2 * r + 1]);
      }
    }
  } else {
    uint32_t* ow = reinterpret_cast<uint32_t*>(out) + (size_t)b * n * (C / 2);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lsum = quad_sum(l[rt][r]);
        const int row = row0 + 16 * rt + g + 8 * r;
        if (row >= n) continue;
        if constexpr (kNoExp) {
          // o = (sum s v - M sum v) / (sum s - M count)
          const float den = lsum - mx[rt][r] * (float)m;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            ow[(size_t)row * (C / 2) + 4 * j + t] = pack_bf16(
                (acc[rt][j][2 * r] - mx[rt][r] * sv[j][0]) / den,
                (acc[rt][j][2 * r + 1] - mx[rt][r] * sv[j][1]) / den);
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            ow[(size_t)row * (C / 2) + 4 * j + t] = pack_bf16(
                acc[rt][j][2 * r] / lsum, acc[rt][j][2 * r + 1] / lsum);
        }
        // nomax: no max taken, so the lse is log l alone
        if constexpr (kFlash)
          if (t == 0)
            lse[(size_t)b * n + row] = (kNoMax ? 0.f : mx[rt][r]) + logf(lsum);
      }
    }
  }
}

template <int D, int C>
__global__ void __launch_bounds__(32 * kFwdWarps)
    attention_flash_fwd_mma_kernel(const bf16* __restrict__ q,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   bf16* __restrict__ o,
                                   float* __restrict__ lse, int n, int m) {
  fwd_mma_body<D, C, kOutFlash, kFwdWarps, kRowTiles, kFwdStages, false>(
      q, k, v, nullptr, o, lse, nullptr, n, m, 0);
}

template <int D, int C, bool kWhole>
__global__ void __launch_bounds__(32 * kK1Warps)
    attention_fwd_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             bf16* __restrict__ o, int n, int m) {
  fwd_mma_body<D, C, kOutFwd, kK1Warps, kK1RowTiles, 1, kWhole>(
      q, k, v, nullptr, o, nullptr, nullptr, n, m, 0);
}

template <int D, int C, bool kWhole>
__global__ void __launch_bounds__(32 * kStatsWarps)
    attention_bwd_stats_mma_kernel(const bf16* __restrict__ q,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const bf16* __restrict__ g,
                                   float2* __restrict__ ld, int n, int m,
                                   int npad) {
  fwd_mma_body<D, C, kOutStats, kStatsWarps, 1, 1, kWhole>(
      q, k, v, g, nullptr, nullptr, ld, n, m, npad);
}

// ---- K6 and K2's gradient pass: the key-major backward ----------------------

// the shipped key-major pass: K2's gradient pass's and K5's (K6's block:
// k6_warps)
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdQTile = 64;  // query rows a stage
constexpr int kBwdStages = 3;
constexpr int kDeltaThreads = 256;

// K6's choices, flipped at build time for the backward studies
// (sagan_tpu_torch/tools/bench_attn_bwd256.py and bench_attn_floor512.py,
// k6_mma: the TPU study's (BN, BM) sweep of its fused backward):
// -DSAGAN_K6_Q_TILE=128 walks the query rows in tiles of that many (BN;
// else 64; 32 builds, but spills at 128 registers a thread, and the
// studies leave it out), -DSAGAN_K6_WARPS=4 or 8 makes K6's block that
// many warps at every width (else k6_warps' 16 or 8, below),
// -DSAGAN_K6_KEY_TILES=4 or 16 gives each warp that
// many m16 key tiles at d = 2, c = 8 (else 8; other widths scale their
// count alike, down to 1), so that a block owns warps x 16 x key tiles
// keys (BM), and -DSAGAN_K6_STAGES=2 or 4 makes the cp.async ring of
// query tiles that deep (else 3). The defaults are the shipped kernel. They
// leave K2's gradient pass, K5 and the delta rows of K2, K4 and K5 as
// they are; K6's delta pass pads the rows to K6's own query tile.
#ifdef SAGAN_K6_Q_TILE
constexpr int kK6QTile = SAGAN_K6_Q_TILE;
#else
constexpr int kK6QTile = kBwdQTile;
#endif
#ifdef SAGAN_K6_KEY_TILES
constexpr int kK6KeyTiles = SAGAN_K6_KEY_TILES;
#else
constexpr int kK6KeyTiles = 8;
#endif
#ifdef SAGAN_K6_STAGES
constexpr int kK6Stages = SAGAN_K6_STAGES;
#else
constexpr int kK6Stages = kBwdStages;
#endif
static_assert(kK6QTile % 16 == 0 && kK6QTile > 0,
              "SAGAN_K6_Q_TILE: a multiple of 16 query rows");
#ifdef SAGAN_K6_WARPS
static_assert(SAGAN_K6_WARPS >= 1 && SAGAN_K6_WARPS <= 32,
              "SAGAN_K6_WARPS: 1 to 32");
#endif
static_assert(kK6KeyTiles >= 1, "SAGAN_K6_KEY_TILES: at least 1");
static_assert(kK6Stages >= 2, "SAGAN_K6_STAGES: a ring of at least 2");

// m16 key tiles a warp owns: as many as keep its dK and dV accumulators
// (4 floats a lane per n8 tile) within 64 registers
template <int D, int C>
__host__ __device__ constexpr int bwd_key_tiles() {
  return 4 * ((D + 7) / 8 + C / 8) <= 8    ? 8
         : 4 * ((D + 7) / 8 + C / 8) <= 16 ? 4
         : 4 * ((D + 7) / 8 + C / 8) <= 32 ? 2
                                           : 1;
}
// K6's: the shipped count scaled by kK6KeyTiles / 8, at least 1
template <int D, int C>
__host__ __device__ constexpr int k6_key_tiles() {
  return bwd_key_tiles<D, C>() * kK6KeyTiles / 8 > 0
             ? bwd_key_tiles<D, C>() * kK6KeyTiles / 8
             : 1;
}
// K6's warps a block at head width D. The shipped block at d <= 16: 16
// warps, 512 threads, __launch_bounds__(512), so at most 128 registers a
// thread (128 at d = 2, c = 8, no spill; the 8-warp block spills 4 bytes
// there), one block an SM, 2,048 keys a block at d = 2, c = 8 and 81,408
// bytes of shared memory. It takes the SM that two 8-warp blocks would
// share and writes half their fp32 dq partials. At church512's 512 map
// (N 262,144, M 65,536; NVIDIA H100 80GB HBM3, 700 W): B = 4 29.750 ms
// against the 8-warp block's 31.130, B = 8 59.364 against 61.591, with
// 536.9 MB of partials against 1,073.7 (K4 + K5: 50.895, 101.265). At
// d = 32 the 16-warp block's dq sums (16 x 64 rows x 32 floats) take its
// shared memory past the SM's 227 KB at c >= 32, so d = 32 keeps 8 warps.
// A SAGAN_K6_WARPS build: that many at every width.
template <int D>
__host__ __device__ constexpr int k6_warps() {
#ifdef SAGAN_K6_WARPS
  return SAGAN_K6_WARPS;
#else
  return D <= 16 ? 16 : kBwdWarps;
#endif
}
template <int D, int C>
__host__ __device__ constexpr int k6_keys_per_block() {
  return k6_warps<D>() * 16 * k6_key_tiles<D, C>();
}
// K5's: the shipped count, times kK5KtScale
template <int D, int C>
__host__ __device__ constexpr int k5_key_tiles() {
  return kK5KtScale * bwd_key_tiles<D, C>();
}

// shared memory of the key-major pass of W warps of KT key tiles, QT query
// rows a stage in a ring of ST; without dQ (K5) no dq sums
template <int D, int C, int KT, bool kDq = true, int W = kBwdWarps,
          int QT = kBwdQTile, int ST = kBwdStages>
struct BwdSmem {
  static constexpr int KB = W * 16 * KT;
  static constexpr int kDRow = row_units(D) * 16;
  static constexpr int kCRow = row_units(C) * 16;
  static constexpr int kV = KB * kDRow;              // offset of V's rows
  static constexpr int kRing = kV + KB * kCRow;      // offset of the ring
  static constexpr int kG = QT * kDRow;              // in a stage: dO
  static constexpr int kLd = kG + QT * kCRow;        // (-lse log2e, delta)
  static constexpr int kStage = kLd + QT * 8;
  static constexpr int kRed = kRing + ST * kStage;   // dq sums
  static constexpr int kBytes = kRed + (kDq ? W * QT * D * 4 : 0);
};
// K6's
template <int D, int C>
using K6Smem = BwdSmem<D, C, k6_key_tiles<D, C>(), true, k6_warps<D>(),
                       kK6QTile, kK6Stages>;

// (-lse log2e, delta = g . o) fp32 of every query row, rows n..npad-1
// (the last query tile's padding) (-inf, 0)
template <int C>
__device__ __forceinline__ void delta_body(const bf16* __restrict__ g,
                                           const bf16* __restrict__ o,
                                           const float* __restrict__ lse,
                                           float2* __restrict__ ld, int n,
                                           int npad) {
  const int b = blockIdx.y;
  const int row = blockIdx.x * kDeltaThreads + threadIdx.x;
  if (row >= npad) return;
  float2 out = make_float2(-INFINITY, 0.f);
  if (row < n) {
    const size_t r = (size_t)b * n + row;
    const uint4* g4 = reinterpret_cast<const uint4*>(g + r * C);
    const uint4* o4 = reinterpret_cast<const uint4*>(o + r * C);
    float delta = 0.f;
#pragma unroll
    for (int i = 0; i < C / 8; ++i) {
      const uint4 a = g4[i], c = o4[i];
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 x = unpack_bf16(aw[w]), y = unpack_bf16(cw[w]);
        delta = fmaf(x.x, y.x, delta);
        delta = fmaf(x.y, y.y, delta);
      }
    }
    out = make_float2(-lse[r] * kLog2e, delta);
  }
  ld[(size_t)b * npad + row] = out;
}

// K6's delta pass, and K4's and K5's (one pass that both read): two names,
// so that a profile tells the two backwards apart
template <int C>
__global__ void __launch_bounds__(kDeltaThreads)
    attention_flash_delta_kernel(const bf16* __restrict__ g,
                                 const bf16* __restrict__ o,
                                 const float* __restrict__ lse,
                                 float2* __restrict__ ld, int n, int npad) {
  delta_body<C>(g, o, lse, ld, n, npad);
}
template <int C>
__global__ void __launch_bounds__(kDeltaThreads)
    attention_flash_dq_delta_kernel(const bf16* __restrict__ g,
                                    const bf16* __restrict__ o,
                                    const float* __restrict__ lse,
                                    float2* __restrict__ ld, int n,
                                    int npad) {
  delta_body<C>(g, o, lse, ld, n, npad);
}

// K6's, K2's and K5's key-major pass: a block of W warps owns W x KT m16
// key tiles and writes their dk, dv and (kDq: K6, K2) its fp32 dq partial
// rows, from the (-lse log2e, delta) pairs in `ld`, walking the query rows
// in tiles of QT through a cp.async ring of ST. Without dQ there is no
// movmatrix, no dQ mma and no warp sum through shared memory
template <int D, int C, int KT, bool kDq, int W = kBwdWarps,
          int QT = kBwdQTile, int ST = kBwdStages>
__device__ __forceinline__ void dqkv_mma_body(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v,
                                              const bf16* __restrict__ g,
                                              const float2* __restrict__ ld,
                                              bf16* __restrict__ dk,
                                              bf16* __restrict__ dv,
                                              float* __restrict__ dq_part,
                                              int n, int m, int npad) {
  constexpr bool kDK8 = D <= 8;       // S^T on m16n8k8
  constexpr int DS = kDK8 ? 1 : D / 16;  // its k16 steps
  constexpr bool kCK8 = C == 8;       // dP^T on m16n8k8
  constexpr int CS = kCK8 ? 1 : C / 16;
  constexpr int DT = (D + 7) / 8;     // n8 tiles of dK and dQ
  constexpr int NT = C / 8;           // n8 tiles of dV
  using S = BwdSmem<D, C, KT, kDq, W, QT, ST>;
  constexpr int kThreads = 32 * W;
  extern __shared__ __align__(16) char smem[];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;  // C rows g, g + 8: keys (dQ: queries)
  const int t = lane & 3;    // C cols 2t, 2t + 1: queries (dims, channels)
  const int key0 = blockIdx.x * S::KB;
  const int tiles = npad / QT;
  const bf16* qb = q + (size_t)b * n * D;
  const bf16* gb = g + (size_t)b * n * C;
  const float2* ldb = ld + (size_t)b * npad;
  float* red = reinterpret_cast<float*>(smem + S::kRed);

  zero_smem(smem, S::kRed, kThreads);  // padding of the staged rows
  __syncthreads();
  stage_rows<D, kThreads>(smem, k + (size_t)b * m * D, key0, S::KB, m);
  stage_rows<C, kThreads>(smem + S::kV, v + (size_t)b * m * C, key0,
                          S::KB, m);
  cp_async_commit();
  auto load = [&](int tile) {
    if (tile < tiles) {
      char* st = smem + S::kRing + (tile % ST) * S::kStage;
      const int r0 = tile * QT;
      stage_rows<D, kThreads>(st, qb, r0, QT, n);
      stage_rows<C, kThreads>(st + S::kG, gb, r0, QT, n);
      for (int i = threadIdx.x; i < QT; i += kThreads)
        cp_async<8>(st + S::kLd + 8 * i, ldb + r0 + i, 8);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) load(s);

  float dka[KT][DT][4], dva[KT][NT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
      dka[kt][j][0] = dka[kt][j][1] = dka[kt][j][2] = dka[kt][j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      dva[kt][j][0] = dva[kt][j][1] = dva[kt][j][2] = dva[kt][j][3] = 0.f;
  }
  const int lrow = lane & 15;  // the ldmatrix row this lane addresses
  const char* kst = smem + (warp * KT * 16 + lrow) * S::kDRow;
  const char* vst = smem + S::kV + (warp * KT * 16 + lrow) * S::kCRow;

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<ST - 2>();  // the key block and tile `it`
    __syncthreads();  // every thread is done with tile it - 1 and red
    load(it + ST - 1);
    const char* st = smem + S::kRing + (it % ST) * S::kStage;
    const float2* lds = reinterpret_cast<const float2*>(st + S::kLd);

#pragma unroll 1
    for (int qc = 0; qc < QT / 16; ++qc) {
      // what the warp's key tiles share for these 16 queries: the B
      // fragments of Q^T and dO^T (queries as n, in two n8 groups), of dO
      // (queries as k, for dV) and of Q (queries as k, for dK), and the
      // (-lse log2e, delta) of the lane's queries 2t, 2t + 1 of each group
      const char* qs = st + (16 * qc + lrow) * S::kDRow;
      const char* gs = st + S::kG + (16 * qc + lrow) * S::kCRow;
      uint32_t qb2[2][DS][2], gb2[2][CS][2], gt[NT][2], qt[DT][2];
      if constexpr (kDK8) {
        ldsm_x2(qb2[0][0][0], qb2[1][0][0], qs);
      } else {
#pragma unroll
        for (int ks = 0; ks < DS; ++ks) {
          // matrices: (queries 0-7, 8 dims), (0-7, next 8), (8-15, ...)
          const char* a = st + (16 * qc + 8 * (lane >> 4) + (lane & 7)) *
                                   S::kDRow + (2 * ks + ((lane >> 3) & 1)) * 16;
          ldsm_x4(qb2[0][ks][0], qb2[0][ks][1], qb2[1][ks][0], qb2[1][ks][1],
                  a);
        }
      }
      if constexpr (kCK8) {
        ldsm_x2(gb2[0][0][0], gb2[1][0][0], gs);
      } else {
#pragma unroll
        for (int ks = 0; ks < CS; ++ks) {
          const char* a = st + S::kG +
                          (16 * qc + 8 * (lane >> 4) + (lane & 7)) * S::kCRow +
                          (2 * ks + ((lane >> 3) & 1)) * 16;
          ldsm_x4(gb2[0][ks][0], gb2[0][ks][1], gb2[1][ks][0], gb2[1][ks][1],
                  a);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) ldsm_x2_t(gt[j][0], gt[j][1], gs + 16 * j);
#pragma unroll
      for (int j = 0; j < DT; ++j) ldsm_x2_t(qt[j][0], qt[j][1], qs + 16 * j);
      float2 lq[2][2];
#pragma unroll
      for (int grp = 0; grp < 2; ++grp)
#pragma unroll
        for (int e = 0; e < 2; ++e) lq[grp][e] = lds[16 * qc + 8 * grp + 2 * t + e];

      float dq[DT][4];
      if constexpr (kDq) {
#pragma unroll
        for (int j = 0; j < DT; ++j)
          dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
      }

#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        // A fragments of K and V (keys as rows), B fragments of K (keys
        // as k, for dQ)
        const char* kr = kst + kt * 16 * S::kDRow;
        const char* vr = vst + kt * 16 * S::kCRow;
        uint32_t ka[DS][4], va[CS][4], kbq[DT][2];
        if constexpr (kDK8) {
          ldsm_x2(ka[0][0], ka[0][1], kr);
        } else {
#pragma unroll
          for (int ks = 0; ks < DS; ++ks)
            ldsm_x4(ka[ks][0], ka[ks][1], ka[ks][2], ka[ks][3],
                    kr + (2 * ks + (lane >> 4)) * 16);
        }
        if constexpr (kCK8) {
          ldsm_x2(va[0][0], va[0][1], vr);
        } else {
#pragma unroll
          for (int ks = 0; ks < CS; ++ks)
            ldsm_x4(va[ks][0], va[ks][1], va[ks][2], va[ks][3],
                    vr + (2 * ks + (lane >> 4)) * 16);
        }
        if constexpr (kDq) {
#pragma unroll
          for (int j = 0; j < DT; ++j)
            ldsm_x2_t(kbq[j][0], kbq[j][1], kr + 16 * j);
        }

        // S^T and dP^T: keys g, g + 8 (rows) by queries 2t, 2t + 1 of
        // each n8 group
        float sT[2][4], dpT[2][4];
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sT[grp][e] = dpT[grp][e] = 0.f;
          if constexpr (kDK8) {
            mma_bf16_k8(sT[grp], ka[0][0], ka[0][1], qb2[grp][0][0]);
          } else {
#pragma unroll
            for (int ks = 0; ks < DS; ++ks)
              mma_bf16(sT[grp], ka[ks][0], ka[ks][1], ka[ks][2], ka[ks][3],
                       qb2[grp][ks][0], qb2[grp][ks][1]);
          }
          if constexpr (kCK8) {
            mma_bf16_k8(dpT[grp], va[0][0], va[0][1], gb2[grp][0][0]);
          } else {
#pragma unroll
            for (int ks = 0; ks < CS; ++ks)
              mma_bf16(dpT[grp], va[ks][0], va[ks][1], va[ks][2], va[ks][3],
                       gb2[grp][ks][0], gb2[grp][ks][1]);
          }
        }
        // p = exp(s - lse) and dl = p (dp - delta), in place
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = lq[grp][e & 1];
            sT[grp][e] = ex2(fmaf(sT[grp][e], kLog2e, x.x));
            dpT[grp][e] = sT[grp][e] * (dpT[grp][e] - x.y);
          }
        }
        // P^T and dS^T in bf16 as A fragments (keys by 16 queries);
        // blocks (keys 0-7 | 8-15, queries 0-7 | 8-15)
        const uint32_t p00 = pack_bf16(sT[0][0], sT[0][1]);
        const uint32_t p10 = pack_bf16(sT[0][2], sT[0][3]);
        const uint32_t p01 = pack_bf16(sT[1][0], sT[1][1]);
        const uint32_t p11 = pack_bf16(sT[1][2], sT[1][3]);
        const uint32_t d00 = pack_bf16(dpT[0][0], dpT[0][1]);
        const uint32_t d10 = pack_bf16(dpT[0][2], dpT[0][3]);
        const uint32_t d01 = pack_bf16(dpT[1][0], dpT[1][1]);
        const uint32_t d11 = pack_bf16(dpT[1][2], dpT[1][3]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(dva[kt][j], p00, p10, p01, p11, gt[j][0], gt[j][1]);
#pragma unroll
        for (int j = 0; j < DT; ++j)
          mma_bf16(dka[kt][j], d00, d10, d01, d11, qt[j][0], qt[j][1]);
        if constexpr (kDq) {
          // dS (queries by keys) from dS^T's four blocks transposed
          const uint32_t s00 = movmatrix_t(d00), s01 = movmatrix_t(d01);
          const uint32_t s10 = movmatrix_t(d10), s11 = movmatrix_t(d11);
#pragma unroll
          for (int j = 0; j < DT; ++j)
            mma_bf16(dq[j], s00, s01, s10, s11, kbq[j][0], kbq[j][1]);
        }
      }

      if constexpr (kDq) {
        // this warp's dq of the 16 queries: rows g, g + 8, dims 8j + 2t,
        // + 1
        float* rw = red + (warp * QT + 16 * qc) * D;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const int dim = 8 * j + 2 * t;
          if (dim < D) {
            rw[gq * D + dim] = dq[j][0];
            rw[gq * D + dim + 1] = dq[j][1];
            rw[(gq + 8) * D + dim] = dq[j][2];
            rw[(gq + 8) * D + dim + 1] = dq[j][3];
          }
        }
      }
    }

    if constexpr (kDq) {
      __syncthreads();  // every warp's dq sums are in red
      const int r0 = it * QT;
      float* out =
          dq_part + ((size_t)(b * gridDim.x + blockIdx.x) * n + r0) * D;
      const int valid = min(QT, n - r0) * D;
      for (int e = threadIdx.x; e < valid; e += kThreads) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) sum += red[w * QT * D + e];
        out[e] = sum;
      }
    }
  }

  // dK and dV of the warp's keys: rows g, g + 8 of each key tile
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + (warp * KT + kt) * 16 + gq + 8 * r;
      if (key >= m) continue;
      uint32_t* dkw = reinterpret_cast<uint32_t*>(dk) + ((size_t)b * m + key) * (D / 2);
      uint32_t* dvw = reinterpret_cast<uint32_t*>(dv) + ((size_t)b * m + key) * (C / 2);
#pragma unroll
      for (int j = 0; j < DT; ++j)
        if (8 * j + 2 * t < D)
          dkw[4 * j + t] = pack_bf16(dka[kt][j][2 * r], dka[kt][j][2 * r + 1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        dvw[4 * j + t] = pack_bf16(dva[kt][j][2 * r], dva[kt][j][2 * r + 1]);
    }
  }
}

template <int D, int C>
__global__ void __launch_bounds__(32 * k6_warps<D>())
    attention_flash_dqkv_mma_kernel(const bf16* __restrict__ q,
                                    const bf16* __restrict__ k,
                                    const bf16* __restrict__ v,
                                    const bf16* __restrict__ g,
                                    const float2* __restrict__ ld,
                                    bf16* __restrict__ dk,
                                    bf16* __restrict__ dv,
                                    float* __restrict__ dq_part, int n,
                                    int m, int npad) {
  dqkv_mma_body<D, C, k6_key_tiles<D, C>(), true, k6_warps<D>(), kK6QTile,
                kK6Stages>(q, k, v, g, ld, dk, dv, dq_part, n, m, npad);
}

// K5: dk, dv from the (-lse log2e, delta) pairs, K6's body without dQ
template <int D, int C>
__global__ void __launch_bounds__(kBwdThreads, kK5MinBlocks)
    attention_flash_dkv_mma_kernel(const bf16* __restrict__ q,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const bf16* __restrict__ g,
                                   const float2* __restrict__ ld,
                                   bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int n, int m,
                                   int npad) {
  dqkv_mma_body<D, C, k5_key_tiles<D, C>(), false>(q, k, v, g, ld, dk, dv,
                                                     nullptr, n, m, npad);
}

// K4: dq from the (-lse log2e, delta) pairs, query-major on K3's loop
template <int D, int C>
__global__ void __launch_bounds__(32 * kK4Warps)
    attention_flash_dq_mma_kernel(const bf16* __restrict__ q,
                                  const bf16* __restrict__ k,
                                  const bf16* __restrict__ v,
                                  const bf16* __restrict__ g,
                                  const float2* __restrict__ ld,
                                  bf16* __restrict__ dq, int n, int m,
                                  int npad) {
  fwd_mma_body<D, C, kOutDq, kK4Warps, 1, 1, false, kK4Tile / kFwdTile>(
      q, k, v, g, dq, nullptr, const_cast<float2*>(ld), n, m, npad);
}

template <int D, int C, int KT>
__global__ void __launch_bounds__(kBwdThreads)
    attention_bwd_grads_mma_kernel(const bf16* __restrict__ q,
                                   const bf16* __restrict__ k,
                                   const bf16* __restrict__ v,
                                   const bf16* __restrict__ g,
                                   const float2* __restrict__ ld,
                                   bf16* __restrict__ dk,
                                   bf16* __restrict__ dv,
                                   float* __restrict__ dq_part, int n, int m,
                                   int npad) {
  dqkv_mma_body<D, C, KT, true>(q, k, v, g, ld, dk, dv, dq_part, n, m,
                                npad);
}

// K2's dq: the sum of the gradient pass's fp32 partials [B, NKB, N * D]
// in key-block order, in bf16 (q's type)
constexpr int kSumThreads = 256;
__global__ void __launch_bounds__(kSumThreads)
    attention_bwd_dq_sum_kernel(const float* __restrict__ part,
                                bf16* __restrict__ dq, int per, int nkb) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= per) return;
  const float* p = part + (size_t)b * nkb * per + i;
  float sum = 0.f;
  for (int kb = 0; kb < nkb; ++kb) sum += p[(size_t)kb * per];
  dq[(size_t)b * per + i] = __float2bfloat16(sum);
}

// query rows of the (-lse log2e, delta) scratch: n padded to the tile
// (K2's, K4's and K5's; K6's to its own query tile)
int delta_rows(int n) { return (n + kBwdQTile - 1) / kBwdQTile * kBwdQTile; }
int k6_delta_rows(int n) { return (n + kK6QTile - 1) / kK6QTile * kK6QTile; }
// K2's stats pass writes every row of that scratch, one block a tile
static_assert(kStatsRows == kBwdQTile, "stats rows a block: K6's query tile");

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int n, int m, cudaStream_t st) {
  constexpr int C = SAGAN_ATTN_C;
  constexpr int rows = 16 * kRowTiles * kFwdWarps;
  constexpr int bytes = kFwdStages * FwdSmem<D, C>::kStage;
  auto kernel = attention_flash_fwd_mma_kernel<D, C>;
  static const cudaError_t allowed = allow_smem(kernel, bytes);
  if (allowed != cudaSuccess) return allowed;
  kernel<<<dim3((n + rows - 1) / rows, b), 32 * kFwdWarps, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, n, m);
  return cudaGetLastError();
}

// K1: the whole key set staged once where it fits, else 64-key tiles
template <int D>
cudaError_t launch_fwd1(const void* q, const void* k, const void* v, void* o,
                        int b, int n, int m, cudaStream_t st) {
  constexpr int C = SAGAN_ATTN_C;
  constexpr int rows = 16 * kK1RowTiles * kK1Warps;
  const dim3 grid((n + rows - 1) / rows, b);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(o);
  if (stage_whole<D, C>(m)) {
    auto kernel = attention_fwd_mma_kernel<D, C, true>;
    static const cudaError_t allowed = allow_smem(kernel, kK1WholeBytes);
    if (allowed != cudaSuccess) return allowed;
    kernel<<<grid, 32 * kK1Warps, fwd_smem_bytes<D, C>(m, true, 1), st>>>(
        qp, kp, vp, op, n, m);
  } else {
    attention_fwd_mma_kernel<D, C, false>
        <<<grid, 32 * kK1Warps, FwdSmem<D, C>::kStage, st>>>(qp, kp, vp, op,
                                                             n, m);
  }
  return cudaGetLastError();
}

// the card's SMs (the current device's; asked once)
int sm_count() {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return sms;
}

// m16 key tiles a warp of K2's gradient pass owns: K6's KT, halved while
// the grid holds fewer than kK2Fill blocks an SM (kK2Fill 0: K6's KT)
template <int D, int C>
int k2_key_tiles(int b, int m, int sms) {
  int kt = bwd_key_tiles<D, C>();
  while (kK2Fill > 0 && kt > 1 &&
         (long long)b * ((m + kBwdWarps * 16 * kt - 1) /
                         (kBwdWarps * 16 * kt)) <
             (long long)kK2Fill * sms)
    kt /= 2;
  return kt;
}

struct K2Args {
  const void *q, *k, *v, *g;
  void *dq, *dk, *dv;
  float2* ld;
  float* part;
  int b, n, m;
};

template <int D, int KT>
cudaError_t launch_k2_grads(const K2Args& a, int npad, cudaStream_t st) {
  constexpr int C = SAGAN_ATTN_C;
  using S = BwdSmem<D, C, KT>;
  auto kernel = attention_bwd_grads_mma_kernel<D, C, KT>;
  static const cudaError_t allowed = allow_smem(kernel, S::kBytes);
  if (allowed != cudaSuccess) return allowed;
  kernel<<<dim3((a.m + S::KB - 1) / S::KB, a.b), kBwdThreads, S::kBytes,
           st>>>(static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                 static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
                 a.ld, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
                 a.part, a.n, a.m, npad);
  return cudaGetLastError();
}

// K2: (a) the stats, (b) the gradients with dq partials, (c) their sum
template <int D>
cudaError_t launch_k2(const K2Args& a, cudaStream_t st) {
  constexpr int C = SAGAN_ATTN_C;
  constexpr int kMaxKT = bwd_key_tiles<D, C>();
  const int npad = delta_rows(a.n);
  const dim3 sgrid(npad / kStatsRows, a.b);
  const auto* qp = static_cast<const bf16*>(a.q);
  const auto* kp = static_cast<const bf16*>(a.k);
  const auto* vp = static_cast<const bf16*>(a.v);
  const auto* gp = static_cast<const bf16*>(a.g);
  if (stage_whole<D, C>(a.m)) {
    auto kernel = attention_bwd_stats_mma_kernel<D, C, true>;
    static const cudaError_t allowed = allow_smem(kernel, kK1WholeBytes);
    if (allowed != cudaSuccess) return allowed;
    kernel<<<sgrid, 32 * kStatsWarps, fwd_smem_bytes<D, C>(a.m, true, 1),
             st>>>(qp, kp, vp, gp, a.ld, a.n, a.m, npad);
  } else {
    attention_bwd_stats_mma_kernel<D, C, false>
        <<<sgrid, 32 * kStatsWarps, FwdSmem<D, C>::kStage, st>>>(
            qp, kp, vp, gp, a.ld, a.n, a.m, npad);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int kt = k2_key_tiles<D, C>(a.b, a.m, sm_count());
  if (kt == 1) err = launch_k2_grads<D, 1>(a, npad, st);
  if constexpr (kMaxKT >= 2)
    if (kt == 2) err = launch_k2_grads<D, 2>(a, npad, st);
  if constexpr (kMaxKT >= 4)
    if (kt == 4) err = launch_k2_grads<D, 4>(a, npad, st);
  if constexpr (kMaxKT >= 8)
    if (kt == 8) err = launch_k2_grads<D, 8>(a, npad, st);
  if (err != cudaSuccess) return err;

  const int per = a.n * D;
  const int nkb = (a.m + kBwdWarps * 16 * kt - 1) / (kBwdWarps * 16 * kt);
  attention_bwd_dq_sum_kernel<<<dim3((per + kSumThreads - 1) / kSumThreads,
                                     a.b),
                                kSumThreads, 0, st>>>(
      a.part, static_cast<bf16*>(a.dq), per, nkb);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *q, *k, *v, *g, *o;
  const float* lse;
  void *dk, *dv;
  float* dq_part;
  float2* ld;
  int b, n, m;
};

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  constexpr int C = SAGAN_ATTN_C;
  using S = K6Smem<D, C>;
  static_assert(S::kBytes <= 227 * 1024, "K6's shared memory passes the SM's");
  const int npad = k6_delta_rows(a.n);
  attention_flash_delta_kernel<C>
      <<<dim3((npad + kDeltaThreads - 1) / kDeltaThreads, a.b),
         kDeltaThreads, 0, st>>>(static_cast<const bf16*>(a.g),
                                 static_cast<const bf16*>(a.o), a.lse, a.ld,
                                 a.n, npad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = attention_flash_dqkv_mma_kernel<D, C>;
  static const cudaError_t allowed = allow_smem(kernel, S::kBytes);
  if (allowed != cudaSuccess) return allowed;
  kernel<<<dim3((a.m + S::KB - 1) / S::KB, a.b), 32 * k6_warps<D>(),
           S::kBytes, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g), a.ld,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.dq_part, a.n,
      a.m, npad);
  return cudaGetLastError();
}

// K4 and K5: q, k, v, g, the (-lse log2e, delta) pairs, and the outputs
// (K4: dq; K5: dk, dv)
struct K45Args {
  const void *q, *k, *v, *g;
  const float2* ld;
  void *out0, *out1;
  int b, n, m;
};

template <int D>
cudaError_t launch_dq(const K45Args& a, cudaStream_t st) {
  constexpr int C = SAGAN_ATTN_C;
  constexpr int rows = 16 * kK4Warps;
  constexpr int bytes = kK4Tile / kFwdTile * FwdSmem<D, C>::kStage;
  auto kernel = attention_flash_dq_mma_kernel<D, C>;
  static const cudaError_t allowed = allow_smem(kernel, bytes);
  if (allowed != cudaSuccess) return allowed;
  kernel<<<dim3((a.n + rows - 1) / rows, a.b), 32 * kK4Warps, bytes, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g), a.ld,
      static_cast<bf16*>(a.out0), a.n, a.m, delta_rows(a.n));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const K45Args& a, cudaStream_t st) {
  constexpr int C = SAGAN_ATTN_C;
  using S = BwdSmem<D, C, k5_key_tiles<D, C>(), false>;
  auto kernel = attention_flash_dkv_mma_kernel<D, C>;
  static const cudaError_t allowed = allow_smem(kernel, S::kBytes);
  if (allowed != cudaSuccess) return allowed;
  kernel<<<dim3((a.m + S::KB - 1) / S::KB, a.b), kBwdThreads, S::kBytes,
           st>>>(static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                 static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.g),
                 a.ld, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
                 a.n, a.m, delta_rows(a.n));
  return cudaGetLastError();
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on
// success). Operands are bf16 only (`is_bf16` must be 1); lse is fp32;
// `c` must be SAGAN_ATTN_C. The caller checks shapes, contiguity and the
// supported D before calling.

// K1: o [B, N, C].
extern "C" int sagan_attention_fwd_mma(const void* q, const void* k,
                                       const void* v, void* o, int b, int n,
                                       int m, int d, int c, int is_bf16,
                                       void* stream) {
  if (c != SAGAN_ATTN_C || !is_bf16) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_fwd1<2>(q, k, v, o, b, n, m, st);
    case 4: return launch_fwd1<4>(q, k, v, o, b, n, m, st);
    case 8: return launch_fwd1<8>(q, k, v, o, b, n, m, st);
    case 16: return launch_fwd1<16>(q, k, v, o, b, n, m, st);
    case 32: return launch_fwd1<32>(q, k, v, o, b, n, m, st);
  }
  return cudaErrorInvalidValue;
}

// K2: dq [B, N, D], dk, dv, from (q, k, v, g); three launches. `ld` is
// fp32 scratch of [B, sagan_attention_flash_mma_delta_rows(N), 2] and
// `part` of [B, sagan_attention_bwd_mma_key_blocks(B, M, d), N, D].
extern "C" int sagan_attention_bwd_mma(const void* q, const void* k,
                                       const void* v, const void* g,
                                       void* dq, void* dk, void* dv,
                                       void* ld, void* part, int b, int n,
                                       int m, int d, int c, int is_bf16,
                                       void* stream) {
  if (c != SAGAN_ATTN_C || !is_bf16) return cudaErrorInvalidValue;
  const K2Args a{q, k, v, g, dq, dk, dv, static_cast<float2*>(ld),
                 static_cast<float*>(part), b, n, m};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_k2<2>(a, st);
    case 4: return launch_k2<4>(a, st);
    case 8: return launch_k2<8>(a, st);
    case 16: return launch_k2<16>(a, st);
    case 32: return launch_k2<32>(a, st);
  }
  return cudaErrorInvalidValue;
}

// Key blocks of K2's gradient pass, each one fp32 dq partial [N, D], at
// batch b, m keys and head width d on the current device (0 for an
// unsupported d).
extern "C" int sagan_attention_bwd_mma_key_blocks(int b, int m, int d) {
  constexpr int C = SAGAN_ATTN_C;
  int kt = 0;
  switch (d) {
    case 2: kt = k2_key_tiles<2, C>(b, m, sm_count()); break;
    case 4: kt = k2_key_tiles<4, C>(b, m, sm_count()); break;
    case 8: kt = k2_key_tiles<8, C>(b, m, sm_count()); break;
    case 16: kt = k2_key_tiles<16, C>(b, m, sm_count()); break;
    case 32: kt = k2_key_tiles<32, C>(b, m, sm_count()); break;
    default: return 0;
  }
  return (m + kBwdWarps * 16 * kt - 1) / (kBwdWarps * 16 * kt);
}

// K3: o [B, N, C] and lse, fp32 [B, N] (the caller's [B, N, 1]).
extern "C" int sagan_attention_flash_fwd_mma(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int b, int n, int m,
                                             int d, int c, int is_bf16,
                                             void* stream) {
  if (c != SAGAN_ATTN_C || !is_bf16 || lse == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 2: return launch_fwd<2>(q, k, v, o, l, b, n, m, st);
    case 4: return launch_fwd<4>(q, k, v, o, l, b, n, m, st);
    case 8: return launch_fwd<8>(q, k, v, o, l, b, n, m, st);
    case 16: return launch_fwd<16>(q, k, v, o, l, b, n, m, st);
    case 32: return launch_fwd<32>(q, k, v, o, l, b, n, m, st);
  }
  return cudaErrorInvalidValue;
}

// K6: dk, dv and the dq partials, fp32 [B, NKB, N, D] with NKB =
// ceil(M / sagan_attention_flash_mma_keys_per_block(d)), every element
// written; `ld` is fp32 scratch of [B, sagan_attention_flash_mma_delta_rows
// (N), 2] for the (-lse log2e, delta) pairs.
extern "C" int sagan_attention_flash_dqkv_mma(
    const void* q, const void* k, const void* v, const void* g,
    const void* o, const void* lse, void* dk, void* dv, void* dq_part,
    void* ld, int b, int n, int m, int d, int c, int is_bf16, void* stream) {
  if (c != SAGAN_ATTN_C || !is_bf16) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, g, o, static_cast<const float*>(lse), dk, dv,
                  static_cast<float*>(dq_part), static_cast<float2*>(ld), b,
                  n, m};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_bwd<2>(a, st);
    case 4: return launch_bwd<4>(a, st);
    case 8: return launch_bwd<8>(a, st);
    case 16: return launch_bwd<16>(a, st);
    case 32: return launch_bwd<32>(a, st);
  }
  return cudaErrorInvalidValue;
}

// K4 and K5's delta pass: each query row's (-lse log2e, delta = g . o),
// fp32, to `ld` [B, sagan_attention_flash_mma_delta_rows(N), 2] (rows
// past N (-inf, 0)), which both kernels read.  `m` and `d` are not used.
extern "C" int sagan_attention_flash_delta_mma(const void* g, const void* o,
                                               const void* lse, void* ld,
                                               int b, int n, int m, int d,
                                               int c, int is_bf16,
                                               void* stream) {
  if (c != SAGAN_ATTN_C || !is_bf16) return cudaErrorInvalidValue;
  const int npad = delta_rows(n);
  attention_flash_dq_delta_kernel<SAGAN_ATTN_C>
      <<<dim3((npad + kDeltaThreads - 1) / kDeltaThreads, b), kDeltaThreads,
         0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(g), static_cast<const bf16*>(o),
          static_cast<const float*>(lse), static_cast<float2*>(ld), n, npad);
  return cudaGetLastError();
}

// K4: dq [B, N, D] from the delta pass's `ld`.
extern "C" int sagan_attention_flash_dq_mma(const void* q, const void* k,
                                            const void* v, const void* g,
                                            const void* ld, void* dq, int b,
                                            int n, int m, int d, int c,
                                            int is_bf16, void* stream) {
  if (c != SAGAN_ATTN_C || !is_bf16) return cudaErrorInvalidValue;
  const K45Args a{q, k, v, g, static_cast<const float2*>(ld), dq, nullptr,
                  b, n, m};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_dq<2>(a, st);
    case 4: return launch_dq<4>(a, st);
    case 8: return launch_dq<8>(a, st);
    case 16: return launch_dq<16>(a, st);
    case 32: return launch_dq<32>(a, st);
  }
  return cudaErrorInvalidValue;
}

// K5: dk [B, M, D], dv [B, M, C] from the delta pass's `ld`.
extern "C" int sagan_attention_flash_dkv_mma(const void* q, const void* k,
                                             const void* v, const void* g,
                                             const void* ld, void* dk,
                                             void* dv, int b, int n, int m,
                                             int d, int c, int is_bf16,
                                             void* stream) {
  if (c != SAGAN_ATTN_C || !is_bf16) return cudaErrorInvalidValue;
  const K45Args a{q, k, v, g, static_cast<const float2*>(ld), dk, dv, b, n,
                  m};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_dkv<2>(a, st);
    case 4: return launch_dkv<4>(a, st);
    case 8: return launch_dkv<8>(a, st);
    case 16: return launch_dkv<16>(a, st);
    case 32: return launch_dkv<32>(a, st);
  }
  return cudaErrorInvalidValue;
}

// Keys per block of K6 at head width d, as this build's K6 defines and
// k6_warps set them (0 for an unsupported d).
extern "C" int sagan_attention_flash_mma_keys_per_block(int d) {
  constexpr int C = SAGAN_ATTN_C;
  switch (d) {
    case 2: return k6_keys_per_block<2, C>();
    case 4: return k6_keys_per_block<4, C>();
    case 8: return k6_keys_per_block<8, C>();
    case 16: return k6_keys_per_block<16, C>();
    case 32: return k6_keys_per_block<32, C>();
  }
  return 0;
}

// Rows of K6's (-lse log2e, delta) scratch for n query rows: n padded to
// this build's K6 query tile (the shipped build's 64 are also the rows of
// K2's, K4's and K5's scratch, which no K6 define changes).
extern "C" int sagan_attention_flash_mma_delta_rows(int n) {
  return k6_delta_rows(n);
}
