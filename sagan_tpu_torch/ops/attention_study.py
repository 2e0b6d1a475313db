"""Plain PyTorch versions of the attention study kernels: the test oracles
of the study forward S1 (its CUDA-core engine ``csrc/attention_study.cu``,
its tensor-core variants the builds of ``csrc/attention_flash_mma.cu``
that :mod:`~sagan_tpu_torch.ops.cuda_attention_study` names) and of
``csrc/attention_folded.cu`` (S2, the folded-projection forward), and what
their wrappers run for tensors on the CPU.

Each study variant is a forward ``softmax(q kᵀ) v`` (unscaled logits)
with one part changed, the math of a TPU study body of
``tools/bench_attn_floor.py`` (``VARIANTS`` names it). A variant runs on
one of two engines, which round P differently for E·V:

* ``fma``, the CUDA cores (K1's loop): P stays fp32 in E·V
  (``k_ev_vpu``);
* ``mma``, the tensor cores (the shipped K1/K3 body, built with the
  variant's math): P is cast to v's type for E·V, the row sum taken from
  fp32 P (``k_current``); ``mma_exp2`` is the shipped kernel.

The maths: ``exp`` (e = exp(s − max)); ``exp2`` (e = exp2(s·log2e −
max·log2e)); ``nomax`` (e = exp(s), no max: T1's ``k_nomax`` and the
T3/T5 ``nomaxcorr`` floor); ``noexp`` (NOT attention: e = s − max, fp32
throughout, T1's ``k_noexp``; the kernels form it from linear sums, see
the CUDA source); ``e16`` (P rounded to bf16 before both the row sum and
E·V, ``k_e16``).

Both functions take an optional query-row ``chunk``, as the plain
versions of :mod:`~sagan_tpu_torch.ops.attention` do, and sum E·V one
``PLAIN_KEY_BLOCK`` of keys at a time.
"""

from __future__ import annotations

import torch

from .attention import _key_blocked_matmul, _row_chunks

LOG2E = 1.4426950408889634

# variant: (engine, math, the TPU body whose math it has), in the order of
# the CUDA source's Variant enum
VARIANTS = {
    "fma": ("fma", "exp", "k_ev_vpu"),
    "fma_exp2": ("fma", "exp2", "k_exp2"),
    "fma_nomax": ("fma", "nomax", "k_nomax"),
    "fma_noexp": ("fma", "noexp", "k_noexp"),
    "fma_e16": ("fma", "e16", "k_e16"),
    "mma": ("mma", "exp", "k_current"),
    "mma_fma_scores": ("mma", "exp", "k_vpu_scores"),
    "mma_exp2": ("mma", "exp2", "k_exp2"),
    "mma_nomax": ("mma", "nomax", "k_nomax"),
    "mma_noexp": ("mma", "noexp", "k_noexp"),
    "mma_e16": ("mma", "e16", "k_e16"),
}
# the variants whose output is not attention
WRONG_MATH = ("fma_noexp", "mma_noexp")


def study_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, variant: str,
                              chunk: int | None = None) -> torch.Tensor:
    """The study forward ``variant`` of q [B,N,D], k [B,M,D], v [B,M,C]:
    fp32 logits, e by the variant's math, l = Σ e in fp32, E·V summed in
    fp32 (P cast to v's type first on the mma engine, except for noexp),
    o = E·V / l in q's type; ``chunk`` query rows at a time."""
    engine, math, _ = VARIANTS[variant]
    kt, vf = k.float().transpose(1, 2), v.float()
    out = []
    for rows in _row_chunks(q.shape[1], chunk):
        s = torch.matmul(q[:, rows].float(), kt)
        if math == "nomax":
            e = torch.exp(s)
        elif math == "noexp":
            e = s - s.amax(dim=-1, keepdim=True)
        elif math == "exp2":
            mx = s.amax(dim=-1, keepdim=True)
            e = torch.exp2(s * LOG2E - mx * LOG2E)
        else:
            e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        if math == "e16":
            e = e.to(torch.bfloat16).float()
        lsum = e.sum(dim=-1, keepdim=True)
        if engine == "mma" and math != "noexp":
            e = e.to(v.dtype).float()
        out.append((_key_blocked_matmul(e, vf) / lsum).to(q.dtype))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def folded_reference(x: torch.Tensor, xb: torch.Tensor, w: torch.Tensor,
                     v: torch.Tensor | None = None,
                     wg: torch.Tensor | None = None,
                     chunk: int | None = None) -> torch.Tensor:
    """Attention with the projections folded in, as ``k_folded`` (v
    given) and ``_folded_kernel`` (``wg`` given, V = xb·Wg) compute it:
    x [B,N,Cin] · w [Cin,Cin] summed in fp32 and cast to x's type, logits
    (x W)·xbᵀ in fp32, V = xb·Wg in fp32 cast to x's type, e = exp(s −
    max), l = Σ e in fp32, E (cast to V's type) · V in fp32, o = E·V / l in
    x's type; ``chunk`` query rows at a time."""
    if (v is None) == (wg is None):
        raise ValueError("folded_reference takes exactly one of v and wg")
    xw = torch.matmul(x.float(), w.float()).to(x.dtype).float()
    if v is None:
        v = torch.matmul(xb.float(), wg.float()).to(x.dtype)
    xbt, vf = xb.float().transpose(1, 2), v.float()
    out = []
    for rows in _row_chunks(x.shape[1], chunk):
        s = torch.matmul(xw[:, rows], xbt)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        lsum = e.sum(dim=-1, keepdim=True)
        o = _key_blocked_matmul(e.to(v.dtype).float(), vf) / lsum
        out.append(o.to(x.dtype))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)
