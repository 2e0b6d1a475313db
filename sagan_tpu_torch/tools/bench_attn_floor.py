"""Speed-of-light study of the single-pass attention forward (K1) at
church64 G's 64-map site, [B=64, N=4096, M=1024, d=2, c=8] bf16, on one
GPU: what bounds it on this card.

    python -m sagan_tpu_torch.tools.bench_attn_floor [--quick]

The port of the JAX package's TPU study ``tools/bench_attn_floor.py`` (T1,
T2): every variant of the study forward on both engines (the CUDA cores,
``csrc/attention_study.cu``; the tensor cores, builds of the shipped K1
body, ``mma_exp2`` being K1 itself), each removing or moving one candidate
bottleneck of K1 (the exponential, the online max, the contractions, P's
type); the folded-projection forward (``csrc/attention_folded.cu``, bf16
on the tensor cores). Sections:

  variants  every study variant (``ops.attention_study.VARIANTS``) beside
            K1 on the CUDA cores ("k1", ``engine="fma"``), each held
            against its plain version (``held``); each correct-math
            variant's max|Δ| against K1 too (the fma engine's default is
            K1's arithmetic: limit 0, bit for bit)
  k1_tiles  the CUDA-core K1 at each tile point (``FWD_POINTS``: rows a
            block, keys a tile), the shipped one marked, each held against
            the plain forward
  k1_mma    the shipped tensor-core K1 (bf16's engine), then K1 with one
            design choice flipped a point (``K1_MMA_POINTS``: K3's 64-key
            tile walk, 4 warps a block, two row tiles a warp), each held
            against the plain forward
  k2_mma    the shipped tensor-core K2, then K2 with one design choice
            flipped a point (``K2_MMA_POINTS``: K6's key block, a fill of
            2 blocks an SM, the stats pass on K3's tile walk), beside
            the CUDA-core K2 ("fma"); each held, dq, dk and dv, against
            the plain backward on batch elements 0 and B − 1 (each
            element's gradients are its own), with the size of its dq
            partials
  folded    softmax((x WθWφᵀ) x̄ᵀ) v in one kernel, held against its plain
            version, and against K1 fed the projected q, k (the
            projections as ``torch.matmul``, timed with and without
            them): max|Δ| and correlation
  library   ``scaled_dot_product_attention`` at the same shape, q and k
            zero-padded to a width its flash kernels take (``sdpa_padded``),
            forward and (``sdpa_bwd``) its backward through autograd

No number in the JAX study's docstring is a target here: those are TPU
v5e numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.attention import attention_bwd_reference, attention_reference
from ..ops.attention_study import VARIANTS, WRONG_MATH, folded_reference
from ..ops.cuda_attention import (attention_bwd_fused, attention_fused,
                                  bwd_mma_key_blocks)
from ..ops.cuda_attention_study import (FWD_POINTS, K1_MMA_DEFINES,
                                        K1_MMA_POINTS, K2_MMA_DEFINES,
                                        K2_MMA_POINTS, attention_folded,
                                        attention_study, fwd_tiles)
from ._study import (BF16_TOL, BWD_TOL, CIN, SHAPES, Study, held,
                     held_variant, max_delta, sdpa_padded)

SECTIONS = ("variants", "k1_tiles", "k1_mma", "k2_mma", "folded", "library")
# the sections (or section/row) whose every row holds its output against
# a plain version or a shipped kernel: a max|Δ| beside its limit
HELD = ("variants", "k1_tiles", "k1_mma", "k2_mma", "folded/folded")
TIMING = (50, 5, 3)  # iters, reps, warmup: K1 takes ~0.3 ms


def both(first: dict, second: dict, against: tuple) -> dict:
    """Two ``max_delta`` rows as one, each limit beside its error."""
    return {"against": list(against),
            "max_abs_err": [first["max_abs_err"], second["max_abs_err"]],
            "limit": [first["limit"], second["limit"]],
            "ok": first["ok"] and second["ok"]}


def held_bwd(got, q, k, v, g) -> dict:
    """max|Δ| of a backward's (dq, dk, dv) against the plain backward on
    batch elements 0 and B − 1, each output beside its limit (``BWD_TOL``
    × max|plain|: the plain version rounds dL, E and g/l to bf16 on the
    way, the kernel p and dl)."""
    ends = [0, q.shape[0] - 1]
    want = attention_bwd_reference(*(t[ends] for t in (q, k, v, g)))
    rows = [max_delta(x[ends], y, BWD_TOL) for x, y in zip(got, want)]
    return {"max_abs_err": [r["max_abs_err"] for r in rows],
            "limit": [r["limit"] for r in rows],
            "ok": all(r["ok"] for r in rows)}


def main(argv=None) -> dict:
    st = Study("bench_attn_floor", SHAPES["64"], argv, TIMING, __doc__)
    q, k, v, g = st.data()
    k1 = attention_fused(q, k, v, (), st.fma)
    st.record("variants", "k1", {
        **st.time(attention_fused, q, k, v, (), st.fma),
        **held_variant(k1, q, k, v, "fma")})
    for variant in VARIANTS:
        out = attention_study(q, k, v, variant)
        row = {"engine": VARIANTS[variant][0], "ports": VARIANTS[variant][2],
               **st.time(attention_study, q, k, v, variant)}
        plain = held_variant(out, q, k, v, variant)
        if variant in WRONG_MATH:
            row |= plain
        else:
            # on the CPU "K1" is the plain forward, whose P is bf16
            exact = variant == "fma" and st.on_card
            row |= both(plain, max_delta(out, k1, 0.0 if exact else BF16_TOL),
                        ("plain", "k1"))
        st.record("variants", variant, row)

    st.sweep("k1_tiles", FWD_POINTS, lambda p: (
        attention_fused, (q, k, v, fwd_tiles(p), st.fma),
        held_variant(attention_fused(q, k, v, fwd_tiles(p), st.fma), q, k,
                     v, "fma")))

    # the tensor-core K1, and each of its design choices flipped
    st.sweep("k1_mma", K1_MMA_POINTS, lambda p: (
        attention_fused, (q, k, v, K1_MMA_DEFINES[p], st.mma),
        held(attention_fused(q, k, v, K1_MMA_DEFINES[p], st.mma),
             attention_reference, (q,), (k, v))))

    # the tensor-core K2, each of its design choices flipped, and the
    # CUDA-core K2 beside them
    b, n, m, d, c = st.shape

    def k2(p):
        tiles = K2_MMA_DEFINES[p]
        blocks = bwd_mma_key_blocks(b, m, d, c, tiles) if st.on_card \
            else None
        return attention_bwd_fused, (q, k, v, g, tiles, st.mma), {
            **held_bwd(attention_bwd_fused(q, k, v, g, tiles, st.mma), q, k,
                       v, g),
            "key_blocks": blocks,
            "partial_mb": None if blocks is None else
            4 * b * blocks * n * d / 1e6}

    st.sweep("k2_mma", K2_MMA_POINTS, k2)
    st.record("k2_mma", "fma", {
        **st.time(attention_bwd_fused, q, k, v, g, (), st.fma),
        **held_bwd(attention_bwd_fused(q, k, v, g, (), st.fma), q, k, v, g)})

    # the projection-folded logits: X·(WθWφᵀ)·X̄ᵀ against K1 on the
    # projected q = X Wθ, k = X̄ Wφ of the same tokens
    rng = np.random.default_rng(1)
    x, xb = (torch.from_numpy(rng.standard_normal(s)).to(st.device,
                                                          torch.bfloat16)
             for s in ((b, n, CIN), (b, m, CIN)))
    wth, wph = (torch.from_numpy(rng.standard_normal((CIN, d))
                                 / np.sqrt(CIN)).to(st.device, torch.bfloat16)
                for _ in range(2))
    wfold = (wth.float() @ wph.float().T).to(torch.bfloat16)

    def projected(x, xb, v):
        return attention_fused(torch.matmul(x, wth), torch.matmul(xb, wph), v)

    qp, kp = torch.matmul(x, wth), torch.matmul(xb, wph)
    out_fold = attention_folded(x, xb, wfold, v=v)
    out_proj = attention_fused(qp, kp, v)
    st.record("folded", "k1_projected_qk", st.time(attention_fused, qp, kp, v))
    st.record("folded", "k1_with_projections", st.time(projected, x, xb, v))
    corr = np.corrcoef(out_fold.float().flatten().cpu().numpy(),
                       out_proj.float().flatten().cpu().numpy())[0, 1]
    # the two forms round at other places (x W vs x Wθ and x̄ Wφ), so the
    # logits differ by bf16 roundings: a correlation, as the JAX study
    plain = held(out_fold, lambda x, xb, v: folded_reference(x, xb, wfold,
                                                             v=v),
                 (x,), (xb, v))
    st.record("folded", "folded", {
        **st.time(attention_folded, x, xb, wfold, v), **plain,
        "max_abs_err_vs_projected": (out_fold.float()
                                     - out_proj.float()).abs().max().item(),
        "corr": float(corr), "ok": plain["ok"] and bool(corr > 0.99)})

    st.record("library", "sdpa", st.time(sdpa_padded, q, k, v))
    st.record("library", "sdpa_bwd", st.time(sdpa_padded(q, k, v, g)))
    return st.finish()


if __name__ == "__main__":
    main()
