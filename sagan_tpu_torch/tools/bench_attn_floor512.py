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
  k6_mma      the shipped K6 with the size of its fp32 dq partials and
              its max|Δ| against the CUDA-core K4 + K5 (within
              ``BWD_TOL``, as ``bench_attn_bwd256``)
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
  library     ``sdpa_padded`` forward, and its backward through autograd
              (the plain versions at this map: chip_smoke phase 8)
  step        a church512 training step (example_configs/church512_attn.py,
              B = 4) with and without attention

No number in the JAX study's docstring is a target here: those are TPU
v5e numbers.
"""

from __future__ import annotations

from ..ops import cuda_attention as ca
from ..ops.attention import attention_flash_bwd_reference
from ..ops.cuda_attention_study import (BWD_POINTS, K45_MMA_DEFINES,
                                        K45_MMA_POINTS, bwd_tiles)
from ._study import (BWD_TOL, SHAPES, Study, church512_config, floors, held,
                     k3_mma_sweep, k3_sweep, max_delta, sdpa_padded,
                     step_segments)
from .bench_attn_bwd256 import deltas, partials

SECTIONS = ("k3_mma", "k3_tiles", "floors", "k6_mma", "k6_tiles", "k45_mma",
            "slab", "two_kernel", "library", "step")
# as bench_attn_floor's
HELD = ("k3_mma", "k3_tiles", "floors", "k6_mma", "k6_tiles", "k45_mma")
TIMING = (5, 3, 1)


def main(argv=None) -> dict:
    st = Study("bench_attn_floor512", SHAPES["512"], argv, TIMING, __doc__)
    q, k, v, g = st.data()
    k3_mma_sweep(st, q, k, v)
    floors(st, q, k, v, k3_sweep(st, q, k, v))

    o, lse = ca.attention_flash_fwd(q, k, v)
    args = (q, k, v, o, lse, g)
    want = ca.attention_flash_dq_dkv(*args, (), st.fma)
    fused = ca.attention_flash_dqkv(*args)
    st.record("k6_mma", "shipped", {
        **st.time(ca.attention_flash_dqkv, *args),
        **deltas(fused, want, BWD_TOL), **partials(st, (), "mma")})

    def k6(p):
        tiles = bwd_tiles(p)
        return ca.attention_flash_dqkv, (*args, tiles, st.fma), {
            **deltas(ca.attention_flash_dqkv(*args, tiles, st.fma), want),
            **partials(st, tiles, "fma")}

    st.sweep("k6_tiles", BWD_POINTS, k6)
    del want

    def k45(p):
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

    st.sweep("k45_mma", K45_MMA_POINTS, k45)
    del fused
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

    st.record("step", "church512", step_segments(
        st, church512_config(), steps=3 if st.quick else 10))
    return st.finish()


if __name__ == "__main__":
    main()
