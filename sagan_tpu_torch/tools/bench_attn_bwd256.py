"""Tile study of the flash attention backward at church256 G's 256-map
site, [B=16, N=65536, M=16384, d=2, c=8] bf16, on one GPU.

    python -m sagan_tpu_torch.tools.bench_attn_bwd256 [--quick]

The port of the JAX package's TPU study ``tools/bench_attn_bwd256.py``
(T4). The TPU's (BN, BM) grid blocks have no meaning on the card: the
points here are the kernels' own tiles (``BWD_POINTS``: K4's query rows a
block and keys a tile, K5's and K6's threads a block and keys a thread),
each built into its own library of ``csrc/attention_flash_bwd.cu``, the
first, CUDA-core design (``engine="fma"``: bf16's own engine runs K4-K6
on the tensor cores). Sections, all on the shipped K3's (o, lse), the
tensor-core K3 in bf16:

  k4_tiles  K4 (dq) at each point, max|Δ| against K4 at the shipped point
  k5_tiles  K5 (dk, dv) at each point, max|Δ| against K5 shipped
  k6_tiles  the CUDA-core K6 (the fused one-pass backward) at each point,
            its dq, dk, dv max|Δ| against K4 + K5 at the shipped points,
            and the size of its fp32 dq partials
  k6_mma    the shipped K6, on the tensor cores
            (``csrc/attention_flash_mma.cu``), its max|Δ| against K4 + K5
            within ``BWD_TOL`` (it rounds dl and p to bf16 before the
            products, as the TPU kernel and the plain version do; K4 and
            K5 keep them fp32) and its partials
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
from ..ops.cuda_attention_study import BWD_POINTS, bwd_tiles
from ._study import (BF16_TOL, BWD_TOL, SHAPES, Study, held, max_delta,
                     sdpa_padded)

SECTIONS = ("k4_tiles", "k5_tiles", "k6_tiles", "k6_mma", "anchor",
            "library")
# as bench_attn_floor's
HELD = ("k4_tiles", "k5_tiles", "k6_tiles", "k6_mma", "anchor")
TIMING = (5, 3, 1)


def deltas(got, want, tol: float = BF16_TOL) -> dict:
    """max|Δ| of each output against ``want``, each beside its limit
    (``tol`` × max|want| of that output; ``BF16_TOL``: both kernels sum in
    fp32 and round the outputs to bf16)."""
    rows = [max_delta(a, b, tol) for a, b in zip(got, want)]
    return {"max_abs_err": [r["max_abs_err"] for r in rows],
            "limit": [r["limit"] for r in rows],
            "ok": all(r["ok"] for r in rows)}


def partials(st: Study, tiles: tuple, engine: str) -> dict:
    """The shape and size of K6's fp32 dq partials on ``engine`` at the
    study's shape (null on the CPU)."""
    if not st.on_card:
        return {"partials": None, "partial_mb": None}
    part = ca.dq_partial_shape(*st.shape, tiles, engine)
    return {"partials": part, "partial_mb": 4 * math.prod(part) / 1e6}


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
    st.record("k6_mma", "shipped", {
        **st.time(ca.attention_flash_dqkv, *args),
        **deltas(ca.attention_flash_dqkv(*args), (dq, dk, dv), BWD_TOL),
        **partials(st, (), "mma")})
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
