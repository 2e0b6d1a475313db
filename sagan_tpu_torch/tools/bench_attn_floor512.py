"""Tile and floor study of the flash attention path at church512 G's
512-map site, [B=4, N=262144, M=65536, d=2, c=8] bf16, on one GPU.

    python -m sagan_tpu_torch.tools.bench_attn_floor512 [--quick]

The port of the JAX package's TPU study ``tools/bench_attn_floor512.py``
(T5). K3-K6 ship on the tensor cores (``csrc/attention_flash_mma.cu``,
bf16); their tile sweeps time the first, CUDA-core design
(``engine="fma"``). Sections:

  k3_mma      the shipped K3, then K3 with one design choice flipped a
              point (``MMA_POINTS``: a cp.async ring of 3 stages, two row
              tiles a warp, a mask on every tile, a warp vote that skips
              the rescale; the __expf exponent is the floors' ``mma``),
              each held against the plain forward on the check rows
              (``held``)
  k3_tiles    the CUDA-core K3 at each tile point (``FWD_POINTS``), each
              held against the plain forward
  floors      the study forward's ``nomax`` and ``noexp`` floors beside
              its default, on both engines, the fma engine at the fastest
              K3 point, and ``mma_exp2``, the shipped K3 itself, each held
              against its plain version (as ``bench_attn_floor256``)
  k6_mma      the tensor-core K6 at each (query tile, key block) point
              (``K6_MMA_POINTS``), the TPU study's fused (BN, BM) sweep
              (``bench_bwd_fused``), as ``bench_attn_bwd256``'s: ms, the
              shape and size of its fp32 dq partials, their size at B = 8
              (arithmetic, not a run) and its max|Δ| against the CUDA-core
              K4 + K5 within ``BWD_TOL``
  k6_tiles    the CUDA-core K6 at each point (``BWD_POINTS``) with the
              size of its partials and its max|Δ| against the CUDA-core
              K4 + K5 at the shipped points
  k45_mma     the shipped tensor-core K4 + K5 (the two-kernel backward,
              one delta pass for both), then the pair with one design
              choice flipped a point (``K45_MMA_POINTS``: K4's keys
              staged 128 at a time, K4's block of 8 warps, K5 at twice
              K6's key tiles, K5 held to two blocks an SM): the
              pair's time and each kernel's alone,
              dq held against the plain backward on the check rows, dk
              and dv against the shipped K6's
  slab        the shipped K6's launch alone against K6 with the sum of its
              partials (``part.sum(dim=1)``)
  two_kernel  K4 + K5 on both engines against the shipped K6 at B = 4
  past_budget the map at B = 8, church512's step (past
              ``DQ_SLAB_BUDGET`` at 1,024 keys a block, inside it at the
              shipped K6's 2,048): the shipped tensor-core
              K4 + K5, then K6 at each ``k6_mma`` point of the run, each
              held against the CUDA-core K4 + K5 within ``BWD_TOL``, with
              its partials' size and whether it fits the budget
  library     ``sdpa_padded`` forward, and its backward through autograd
              (the plain versions at this map: chip_smoke phase 8)
  step        a church512 training step (example_configs/church512_attn.py,
              B = 4) with and without attention

No number in the JAX study's docstring is a target here: those are TPU
v5e numbers.
"""

from __future__ import annotations

from ..ops import cuda_attention as ca
from ..ops.attention import DQ_SLAB_BUDGET
from ..ops.cuda_attention_study import (BWD_POINTS, K6_MMA_DEFINES,
                                        K6_MMA_POINTS, bwd_tiles)
from ._study import (BWD_TOL, SHAPES, Study, church512_config, floors,
                     k3_mma_sweep, k3_sweep, sdpa_padded, step_segments)
from .bench_attn_bwd256 import (deltas, k6_mma_sweep, k45_mma_sweep,
                                partials)

SECTIONS = ("k3_mma", "k3_tiles", "floors", "k6_mma", "k6_tiles", "k45_mma",
            "slab", "two_kernel", "past_budget", "library", "step")
# as bench_attn_floor's
HELD = ("k3_mma", "k3_tiles", "floors", "k6_mma", "k6_tiles", "k45_mma",
        "past_budget")
TIMING = (5, 3, 1)
# church512's B = 8 step, past the slab budget at 1,024 keys a block
PAST_BUDGET_BATCH = 8


def past_budget(st: Study) -> None:
    """The ``past_budget`` section at B = ``PAST_BUDGET_BATCH``: the
    shipped tensor-core K4 + K5, then K6 at each ``k6_mma`` point of the
    run, each held against the CUDA-core K4 + K5; a K6 point's row gives
    its partials' MB (``k6_mma``'s arithmetic) and whether they fit
    ``DQ_SLAB_BUDGET`` (null on the CPU)."""
    q, k, v, g = st.data(PAST_BUDGET_BATCH)
    o, lse = ca.attention_flash_fwd(q, k, v)
    args = (q, k, v, o, lse, g)
    want = ca.attention_flash_dq_dkv(*args, (), st.fma)
    st.record("past_budget", "k4_k5", {
        **st.time(ca.attention_flash_dq_dkv, *args, (), st.mma),
        **deltas(ca.attention_flash_dq_dkv(*args, (), st.mma), want,
                 BWD_TOL)})
    for p in st.points(K6_MMA_POINTS):
        tiles = K6_MMA_DEFINES[p]
        mb = st.sections["k6_mma"]["x".join(p)][
            f"partial_mb_b{PAST_BUDGET_BATCH}"]
        st.record("past_budget", "x".join(p), {
            **st.time(ca.attention_flash_dqkv, *args, tiles, st.mma),
            **deltas(ca.attention_flash_dqkv(*args, tiles, st.mma), want,
                     BWD_TOL),
            "partial_mb": mb,
            "fits_budget": None if mb is None else mb * 1e6 <= DQ_SLAB_BUDGET})


def main(argv=None) -> dict:
    st = Study("bench_attn_floor512", SHAPES["512"], argv, TIMING, __doc__)
    q, k, v, g = st.data()
    k3_mma_sweep(st, q, k, v)
    floors(st, q, k, v, k3_sweep(st, q, k, v))

    o, lse = ca.attention_flash_fwd(q, k, v)
    args = (q, k, v, o, lse, g)
    want = ca.attention_flash_dq_dkv(*args, (), st.fma)
    k6_mma_sweep(st, args, want, (PAST_BUDGET_BATCH,))

    def k6(p):
        tiles = bwd_tiles(p)
        return ca.attention_flash_dqkv, (*args, tiles, st.fma), {
            **deltas(ca.attention_flash_dqkv(*args, tiles, st.fma), want),
            **partials(st, tiles, "fma")}

    st.sweep("k6_tiles", BWD_POINTS, k6)
    del want
    k45_mma_sweep(st, args, ca.attention_flash_dqkv(*args))
    if st.on_card:
        # the kernel alone writes the partials; the wrapper adds their sum
        st.record("slab", "k6_kernel", st.time(
            ca.attention_flash_dqkv_partials, *args))
    full = st.record("slab", "k6_with_sum",
                     st.time(ca.attention_flash_dqkv, *args))
    if st.on_card:
        diff = full["ms"] - st.sections["slab"]["k6_kernel"]["ms"]
        st.record("slab", "sum", {"difference": diff,
                                  "share": diff / full["ms"]})
    st.record("two_kernel", "k4_k5", st.time(ca.attention_flash_dq_dkv,
                                             *args))
    st.record("two_kernel", "k4_k5_fma", st.time(
        ca.attention_flash_dq_dkv, *args, (), st.fma))
    st.record("two_kernel", "k6", st.time(ca.attention_flash_dqkv, *args))
    del o, lse, args
    st.record("library", "sdpa", st.time(sdpa_padded, q, k, v))
    st.record("library", "sdpa_bwd", st.time(sdpa_padded(q, k, v, g)))
    del q, k, v, g
    past_budget(st)

    st.record("step", "church512", step_segments(
        st, church512_config(), steps=3 if st.quick else 10))
    return st.finish()


if __name__ == "__main__":
    main()
