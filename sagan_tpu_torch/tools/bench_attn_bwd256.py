"""Tile study of the flash attention backward at church256 G's 256-map
site, [B=16, N=65536, M=16384, d=2, c=8] bf16, on one GPU.

    python -m sagan_tpu_torch.tools.bench_attn_bwd256 [--quick]

The port of the JAX package's TPU study ``tools/bench_attn_bwd256.py``
(T4): its dq and dkv block sweeps and its fused (BN, BM) sweep. The
TPU's grid blocks have no meaning on the card: the points here are the
kernels' own tiles, each built into its own library. The ``*_tiles``
sweeps time the first, CUDA-core design (``BWD_POINTS`` of
``csrc/attention_flash_bwd.cu``: K4's query rows a block and keys a
tile, K5's and K6's threads a block and keys a thread; ``engine="fma"``,
which fp32 ships on); ``k45_mma`` and ``k6_mma`` the tensor-core kernels
that bf16 ships on (``csrc/attention_flash_mma.cu``). Sections, all on
the shipped K3's (o, lse), the tensor-core K3 in bf16:

  k4_tiles  K4 (dq) at each point, max|Δ| against K4 at the shipped point
  k5_tiles  K5 (dk, dv) at each point, max|Δ| against K5 shipped
  k6_tiles  the CUDA-core K6 (the fused one-pass backward) at each point,
            its dq, dk, dv max|Δ| against K4 + K5 at the shipped points,
            and the size of its fp32 dq partials
  k6_mma    the tensor-core K6 at each (query tile, key block) point
            (``K6_MMA_POINTS``, builds of the shipped K6: 1,024 or 512
            keys a block through the warps, 4,096 or 1,024 through the
            key tiles a warp, 128 query rows a stage, a ring of 2 or 4),
            the TPU study's fused (BN, BM) sweep: its ms, the shape and
            size of its fp32 dq partials (its own library's key block)
            and its dq, dk, dv max|Δ| against the CUDA-core K4 + K5 at
            the shipped points
            within ``BWD_TOL`` (it rounds dl and p to bf16 before the
            products, as the TPU kernel and the plain version do; K4 and
            K5 keep them fp32)
  k45_mma   the shipped tensor-core K4 + K5 (one delta pass for both), then
            the pair with one design choice flipped a point
            (``K45_MMA_POINTS``: K4's keys staged 128 at a time, K4's
            block of 8 warps, K5 at twice K6's key tiles, K5 held to two
            blocks an SM), the TPU study's dq and dkv block sweeps: the
            pair's time and each kernel's alone, dq held against the plain
            backward on the check rows, dk and dv against the shipped
            K6's
  anchor    the CUDA-core K4 + K5 at the shipped point, and K4's dq held
            against the plain backward on the check rows (``held``)
  library   the backward's library call (autograd through ``sdpa_padded``)
            and plain version (``attention_flash_bwd_reference`` in
            query-row chunks)

No number in the JAX study's docstring is a target here: those are TPU
v5e numbers.
"""

from __future__ import annotations

import math

from ..ops import cuda_attention as ca
from ..ops.attention import attention_flash_bwd_reference, plain_chunk
from ..ops.cuda_attention_study import (BWD_POINTS, K6_MMA_DEFINES,
                                        K6_MMA_POINTS, K45_MMA_DEFINES,
                                        K45_MMA_POINTS, bwd_tiles)
from ._study import (BF16_TOL, BWD_TOL, SHAPES, Study, held, max_delta,
                     sdpa_padded)

SECTIONS = ("k4_tiles", "k5_tiles", "k6_tiles", "k6_mma", "k45_mma",
            "anchor", "library")
# as bench_attn_floor's
HELD = ("k4_tiles", "k5_tiles", "k6_tiles", "k6_mma", "k45_mma", "anchor")
TIMING = (5, 3, 1)


def deltas(got, want, tol: float = BF16_TOL) -> dict:
    """max|Δ| of each output against ``want``, each beside its limit
    (``tol`` × max|want| of that output; ``BF16_TOL``: both kernels sum in
    fp32 and round the outputs to bf16)."""
    rows = [max_delta(a, b, tol) for a, b in zip(got, want)]
    return {"max_abs_err": [r["max_abs_err"] for r in rows],
            "limit": [r["limit"] for r in rows],
            "ok": all(r["ok"] for r in rows)}


def partials(st: Study, tiles: tuple, engine: str,
             batches: tuple = ()) -> dict:
    """The shape and size of the fp32 dq partials of K6 on ``engine``
    built with ``tiles`` at the study's shape, and their size at each
    batch of ``batches`` by arithmetic, as ``partial_mb_b<B>`` (null on
    the CPU)."""
    if not st.on_card:
        return {"partials": None, "partial_mb": None,
                **{f"partial_mb_b{b}": None for b in batches}}
    part = ca.dq_partial_shape(*st.shape, tiles, engine)
    mb = 4 * math.prod(part) / 1e6
    return {"partials": part, "partial_mb": mb,
            **{f"partial_mb_b{b}": mb * b / part[0] for b in batches}}


def k6_mma_sweep(st: Study, args: tuple, want, batches: tuple = ()):
    """The ``k6_mma`` sweep: the tensor-core K6 on ``args`` (q, k, v, o,
    lse, g) at each ``K6_MMA_POINTS`` point, its dq, dk, dv held against
    ``want`` within ``BWD_TOL``, with its partials (``partials``);
    returns the fastest point."""
    def point(p):
        tiles = K6_MMA_DEFINES[p]
        return ca.attention_flash_dqkv, (*args, tiles, st.mma), {
            **deltas(ca.attention_flash_dqkv(*args, tiles, st.mma), want,
                     BWD_TOL),
            **partials(st, tiles, "mma", batches)}

    return st.sweep("k6_mma", K6_MMA_POINTS, point)


def k45_mma_sweep(st: Study, args: tuple, fused) -> tuple:
    """The ``k45_mma`` sweep: the tensor-core K4 + K5 on ``args`` at each
    ``K45_MMA_POINTS`` point, the pair's time and each kernel's alone, dq
    held against the plain backward on the check rows and dk, dv against
    ``fused`` (the shipped K6's), within ``BWD_TOL``; returns the fastest
    point."""
    q, k, v, o, lse, g = args

    def point(p):
        tiles = K45_MMA_DEFINES[p]
        dq, dk, dv = ca.attention_flash_dq_dkv(*args, tiles, st.mma)
        checks = [held(dq, lambda q, o, lse, g, k, v:
                       attention_flash_bwd_reference(q, k, v, o, lse, g)[0],
                       (q, o, lse, g), (k, v), BWD_TOL),
                  max_delta(dk, fused[1], BWD_TOL),
                  max_delta(dv, fused[2], BWD_TOL)]
        alone = {f"{name}_{key}": x
                 for name, fn in (("k4", ca.attention_flash_dq),
                                  ("k5", ca.attention_flash_dkv))
                 for key, x in st.time(fn, *args, tiles, st.mma).items()}
        return ca.attention_flash_dq_dkv, (*args, tiles, st.mma), {
            **alone, "max_abs_err": [x["max_abs_err"] for x in checks],
            "limit": [x["limit"] for x in checks],
            "ok": all(x["ok"] for x in checks)}

    return st.sweep("k45_mma", K45_MMA_POINTS, point)


def main(argv=None) -> dict:
    st = Study("bench_attn_bwd256", SHAPES["256"], argv, TIMING, __doc__)
    q, k, v, g = st.data()
    o, lse = ca.attention_flash_fwd(q, k, v)
    args = (q, k, v, o, lse, g)
    b, n, m, d, c = st.shape
    dq = ca.attention_flash_dq(*args, (), st.fma)
    dk, dv = ca.attention_flash_dkv(*args, (), st.fma)

    def k4(p):
        tiles = bwd_tiles(p)
        return ca.attention_flash_dq, (*args, tiles, st.fma), deltas(
            (ca.attention_flash_dq(*args, tiles, st.fma),), (dq,))

    def k5(p):
        tiles = bwd_tiles(p)
        return ca.attention_flash_dkv, (*args, tiles, st.fma), deltas(
            ca.attention_flash_dkv(*args, tiles, st.fma), (dk, dv))

    def k6(p):
        tiles = bwd_tiles(p)
        return ca.attention_flash_dqkv, (*args, tiles, st.fma), {
            **deltas(ca.attention_flash_dqkv(*args, tiles, st.fma),
                     (dq, dk, dv)),
            **partials(st, tiles, "fma")}

    st.sweep("k4_tiles", BWD_POINTS, k4)
    st.sweep("k5_tiles", BWD_POINTS, k5)
    st.sweep("k6_tiles", BWD_POINTS, k6)
    k6_mma_sweep(st, args, (dq, dk, dv))
    k45_mma_sweep(st, args, ca.attention_flash_dqkv(*args))
    st.record("anchor", "k4_k5", {
        **st.time(ca.attention_flash_dq_dkv, *args, (), st.fma),
        **held(dq, lambda q, o, lse, g, k, v: attention_flash_bwd_reference(
            q, k, v, o, lse, g)[0], (q, o, lse, g), (k, v), BWD_TOL)})
    st.record("library", "sdpa_bwd", st.time(sdpa_padded(q, k, v, g)))
    st.record("library", "plain", st.time(
        attention_flash_bwd_reference, *args, plain_chunk(b, n, m)))
    return st.finish()


if __name__ == "__main__":
    main()
