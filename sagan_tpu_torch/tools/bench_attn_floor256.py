"""Speed-of-light study of the flash attention path at church256 G's
256-map site, [B=16, N=65536, M=16384, d=2, c=8] bf16, on one GPU.

    python -m sagan_tpu_torch.tools.bench_attn_floor256 [--quick]

The port of the JAX package's TPU study ``tools/bench_attn_floor256.py``
(T3). Sections:

  k3_tiles  the flash forward K3 at each tile point (``FWD_POINTS``), the
            shipped one marked, each held against the plain forward on the
            check rows (``held``)
  floors    at the fastest point: the study forward's ``nomax`` (no max,
            no rescale: the JAX study's ``nomaxcorr``) and ``noexp`` (no
            transcendental; NOT attention) beside its default, on both
            engines (``csrc/attention_study.cu`` on the CUDA cores; on the
            tensor cores builds of the shipped K3, beside ``mma_exp2``, K3
            itself), each held against its plain version. The JAX study's
            own
            ``noexp`` floor was NaN everywhere (its first key block's
            correction is -inf, and 0 x -inf); this one takes T1's math
  folded    the projection mega-kernel (``csrc/attention_folded.cu``, V =
            X̄ Wg in the kernel, bf16 on the tensor cores), held against
            its plain version, against
            three ``torch.matmul`` projections + K3, and their correlation
  bwd       the two-kernel backward K4 + K5 on K3's (o, lse), then each
            alone
  step      a church256 training step (B = 16) with and without attention
  library   the forward's library call (``sdpa_padded``) and plain version
            (``attention_flash_reference`` in query-row chunks)

No number in the JAX study's docstring is a target here: those are TPU
v5e numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.attention import attention_flash_reference, plain_chunk
from ..ops.attention_study import folded_reference
from ..ops.cuda_attention import (attention_flash_dkv, attention_flash_dq,
                                  attention_flash_fwd)
from ..ops.cuda_attention_study import FWD_POINTS, attention_folded, fwd_tiles
from ._study import (CIN, SHAPES, Study, church256_config, floors, held,
                     k3_sweep, sdpa_padded, step_segments)

SECTIONS = ("k3_tiles", "floors", "folded", "bwd", "library", "step")
HELD = ("k3_tiles", "floors", "folded/folded")  # as bench_attn_floor's
TIMING = (5, 3, 1)


def main(argv=None) -> dict:
    st = Study("bench_attn_floor256", SHAPES["256"], argv, TIMING, __doc__)
    q, k, v, g = st.data()
    floors(st, q, k, v, k3_sweep(st, q, k, v))

    b, n, m, d, c = st.shape
    rng = np.random.default_rng(1)
    x, xb = (torch.from_numpy(rng.standard_normal(s)).to(st.device,
                                                          torch.bfloat16)
             for s in ((b, n, CIN), (b, m, CIN)))
    wt, wp, wg = (torch.from_numpy(rng.standard_normal(s) * 0.25).to(
        st.device, torch.bfloat16) for s in ((CIN, d), (CIN, d), (CIN, c)))
    w = (wt.float() @ wp.float().T).to(torch.bfloat16)

    def unfolded(x, xb):
        # what the step pays: three projections and the flash forward
        return attention_flash_fwd(torch.matmul(x, wt), torch.matmul(xb, wp),
                                   torch.matmul(xb, wg))[0]

    o_f, o_u = attention_folded(x, xb, w, wg=wg), unfolded(x, xb)
    corr = np.corrcoef(o_f.float().flatten().cpu().numpy(),
                       o_u.float().flatten().cpu().numpy())[0, 1]
    st.record("folded", "folded", {
        **st.time(lambda: attention_folded(x, xb, w, wg=wg)),
        **held(o_f, lambda x, xb: folded_reference(x, xb, w, wg=wg), (x,),
               (xb,))})
    st.record("folded", "k3_with_projections", {
        **st.time(unfolded, x, xb), "corr": float(corr),
        "ok": bool(corr > 0.99)})
    del x, xb, o_f, o_u

    o, lse = attention_flash_fwd(q, k, v)
    st.record("bwd", "k4_k5", st.time(lambda: (
        attention_flash_dq(q, k, v, o, lse, g),
        attention_flash_dkv(q, k, v, o, lse, g))))
    st.record("bwd", "k4", st.time(attention_flash_dq, q, k, v, o, lse, g))
    st.record("bwd", "k5", st.time(attention_flash_dkv, q, k, v, o, lse, g))
    del o, lse

    st.record("library", "sdpa", st.time(sdpa_padded, q, k, v))
    st.record("library", "plain", st.time(
        attention_flash_reference, q, k, v, plain_chunk(b, n, m)))
    del q, k, v, g

    st.record("step", "church256", step_segments(
        st, church256_config(), steps=3 if st.quick else 10))
    return st.finish()


if __name__ == "__main__":
    main()
