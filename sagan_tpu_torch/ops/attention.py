"""SAGAN self-attention core op: ``softmax(Q Kᵀ) V`` over flattened
feature-map tokens.

Port of ``sagan_tpu/ops/attention.py``.  Plain PyTorch versions of the
forward and of its VJP, in JAX's layouts (q [B, N, D], k [B, M, D],
v [B, M, C]):

* :func:`attention_reference`, the forward: the test oracle, and what a
  CPU tensor runs;
* :func:`attention_bwd_reference`, the backward with the arithmetic of
  the TPU kernel ``pallas_attention.py::_bwd_kernel``: the oracle of the
  CUDA backward, and what a CPU tensor's gradient runs;
* :func:`attention_flash_reference` and
  :func:`attention_flash_bwd_reference`, the flash path's forward (with
  the row log-sum-exp) and backward from the stored (o, lse), with the
  arithmetic of ``_flash_fwd_kernel`` and ``_bwd_tile_grads`` /
  ``_accum_dkv``: the oracles of the CUDA flash kernels.

Each takes an optional query-row ``chunk``: the dense [B, N, M] fp32
logits of the church512 512-map site would take 275 GB, so on the card
the plain versions run there only a chunk of query rows at a time.
Chunking changes no row's formula: only the shapes of the products, which
a library may round apart, and the order of the backward's fp32 dK and
dV sums.  The flash versions also sum over keys one ``PLAIN_KEY_BLOCK``
at a time, as the JAX flash kernels do.

:func:`attention` routes per call (:func:`single_pass`, as the JAX
package's dispatch; :func:`flash_bwd_fused`, the port's own rule): through
:class:`sagan_tpu_torch.ops.cuda_attention.FusedAttention` (K1/K2) where
the single-pass kernels take the shape, else through
:class:`~sagan_tpu_torch.ops.cuda_attention.FlashAttention` (K3, and K6
or K4 + K5).  Both run the CUDA kernels for CUDA tensors, at every N (the
JAX package's ``N >= 256`` rule is a TPU tiling matter and does not carry
over), and the plain versions for CPU tensors.

Logits are **unscaled** (no 1/sqrt(d)), per the original SAGAN.
"""

from __future__ import annotations

import torch

# fp32 bytes of one [B, chunk, M] logit block of the plain path on a call
# that names no chunk (attention(use_pallas=False))
PLAIN_CHUNK_BYTES = 1 << 30


# keys per block of the plain flash versions' sums over keys: the JAX flash
# kernels add one key block's fp32 product at a time to their accumulator
# (pallas_attention.py:467-469).  At the 512 map one fp32 product over all
# 65,536 keys agreed with a single running sum over them and, like it, lost
# the terms far below that sum: its dq sat ~1e-4 of max|dq| off the key-
# blocked sums, which are within 4e-6 of float64 (chip_smoke phase 8)
PLAIN_KEY_BLOCK = 1024


def plain_chunk(b: int, n: int, m: int) -> int | None:
    """Query rows per chunk that keep one fp32 [B, rows, M] block within
    ``PLAIN_CHUNK_BYTES``, or None when all N rows fit."""
    rows = max(1, PLAIN_CHUNK_BYTES // (4 * b * m))
    return None if rows >= n else rows


def _row_chunks(n: int, chunk: int | None):
    step = n if chunk is None else chunk
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _key_blocked_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, R, M] @ b [B, M, X] in fp32 as the sum of its
    ``PLAIN_KEY_BLOCK``-key products, in key order."""
    out = None
    for keys in _row_chunks(a.shape[-1], PLAIN_KEY_BLOCK):
        part = torch.matmul(a[..., keys], b[:, keys])
        out = part if out is None else out + part
    return out


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        chunk: int | None = None) -> torch.Tensor:
    """Unfused oracle: fp32 logits and softmax, probabilities cast to
    ``v.dtype``, fp32 accumulation, output in ``q.dtype``; ``chunk``
    query rows at a time."""
    kt, vf = k.float().transpose(1, 2), v.float()
    out = []
    for rows in _row_chunks(q.shape[1], chunk):
        logits = torch.matmul(q[:, rows].float(), kt)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out.append(torch.matmul(probs.float(), vf).to(q.dtype))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, g: torch.Tensor):
    """(dq, dk, dv) of :func:`attention_reference` at output cotangent
    ``g`` [B, N, C], step for step as ``_bwd_kernel``: fp32 logits,
    E = exp(L − max), l⁻¹; dP = g Vᵀ and δ = Σ(E ⊙ dP) l⁻¹;
    dL = E ⊙ (dP − δ) l⁻¹, cast to k's type before the dQ and dK products;
    dV = Eᵀ (g l⁻¹) with both operands in v's type.  Products of
    same-typed operands accumulate in fp32; dq comes out in q's type, dk
    and dv are fp32 sums cast to k's and v's types."""
    f32 = torch.float32
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    linv = 1.0 / e.sum(dim=-1, keepdim=True)                # [B, N, 1]
    dp = torch.matmul(g.float(), v.float().transpose(1, 2))  # [B, N, M]
    delta = (e * dp).sum(dim=-1, keepdim=True) * linv
    dlog = (e * (dp - delta) * linv).to(k.dtype).to(f32)
    dq = torch.matmul(dlog, k.float())
    dk = torch.matmul(dlog.transpose(1, 2), q.float())
    e_v = e.to(v.dtype).to(f32)
    g_v = (g.float() * linv).to(v.dtype).to(f32)
    dv = torch.matmul(e_v.transpose(1, 2), g_v)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_flash_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, chunk: int | None = None):
    """(o, lse) as ``_flash_fwd_kernel`` leaves them: fp32 logits,
    E = exp(L − max) over the whole key set, cast to v's type for an E V
    summed in fp32 one ``PLAIN_KEY_BLOCK`` of keys at a time, divided by
    l = Σ E; o in q's type and lse = max + log l fp32 [B, N, 1].  ``chunk``
    query rows at a time."""
    kt, vf = k.float().transpose(1, 2), v.float()
    outs, lses = [], []
    for rows in _row_chunks(q.shape[1], chunk):
        logits = torch.matmul(q[:, rows].float(), kt)
        mx = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - mx)
        lsum = e.sum(dim=-1, keepdim=True)
        out = _key_blocked_matmul(e.to(v.dtype).float(), vf) / lsum
        outs.append(out.to(q.dtype))
        lses.append(mx + torch.log(lsum))
    if len(outs) == 1:
        return outs[0], lses[0]
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def attention_flash_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, g: torch.Tensor,
                                  chunk: int | None = None):
    """(dq, dk, dv) from the forward's stored (o, lse) at output cotangent
    ``g``, step for step as ``_bwd_tile_grads`` and ``_accum_dkv``:
    P = exp(L − lse) in fp32; δ = Σ g ⊙ o in fp32 from o as stored;
    dL = P ⊙ (g Vᵀ − δ) cast to k's type; dQ = dL K (one
    ``PLAIN_KEY_BLOCK`` of keys at a time), dK = dLᵀ Q and
    dV = (P in v's type)ᵀ g, each an fp32 sum; dq cast to q's type, dk and
    dv to k's and v's.  ``chunk`` query rows at a time: dq is per row, and
    dk, dv sum the chunks' fp32 parts."""
    f32 = torch.float32
    kf, vt = k.float(), v.float().transpose(1, 2)
    kt = kf.transpose(1, 2)
    dqs = []
    dk = torch.zeros(k.shape, dtype=f32, device=k.device)
    dv = torch.zeros(v.shape, dtype=f32, device=v.device)
    for rows in _row_chunks(q.shape[1], chunk):
        qf, gf = q[:, rows].float(), g[:, rows].float()
        p = torch.exp(torch.matmul(qf, kt) - lse[:, rows])
        delta = (gf * o[:, rows].float()).sum(dim=-1, keepdim=True)
        dlog = (p * (torch.matmul(gf, vt) - delta)).to(k.dtype).to(f32)
        dqs.append(_key_blocked_matmul(dlog, kf).to(q.dtype))
        dk += torch.matmul(dlog.transpose(1, 2), qf)
        dv += torch.matmul(p.to(v.dtype).to(f32).transpose(1, 2), gf)
    dq = dqs[0] if len(dqs) == 1 else torch.cat(dqs, dim=1)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


# -- routing -----------------------------------------------------------------
#
# single_pass is the port's copy of the JAX package's rule
# (sagan_tpu/ops/pallas_attention.py), as shape arithmetic: it budgets a
# TPU core's VMEM at 128-lane padded widths and decides only the route,
# not the CUDA kernels' tiling, so that the two packages take the same
# algorithm at the same shape.  The fused backward's rule is the port's
# own (flash_bwd_fused): the JAX one sized TPU VMEM blocks.

VMEM_BUDGET = 12 * 1024 * 1024              # pallas_attention.py:81
# bytes of K6's fp32 dq partials a backward may write: a memory cap on
# the call's scratch, not a speed rule (in bf16 K6 is 1.7x faster than
# the tensor-core K4 + K5 at church512's map, B = 4 and 8, NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md §6).  At 768 MiB the port takes K6 wherever
# the JAX package takes its fused backward at a model shape with B <= 4,
# and K4 + K5 at most shapes where it does not; the bf16 K6's 2,048-key
# block halves its partials, so the 512 map without attn_downsample takes
# K6 at B = 2 and 3 (537 and 805 MB) where the JAX package takes its
# two-kernel backward.  church512's 512 map writes 536.9 MB at B = 8 and
# takes K6 in bf16 up to B = 12 (805 MB), K4 + K5 from B = 13; in fp32
# (1,024 keys a block) K6 up to B = 6
DQ_SLAB_BUDGET = 768 * 1024 * 1024
# warps a block of the bf16 K2's gradient pass and K5
# (csrc/attention_flash_mma.cu kBwdWarps) and of the bf16 K6 at d <= 16
# (k6_warps), and threads a block of the fp32 K6
# (csrc/attention_flash_bwd.cu kThreads)
MMA_BWD_WARPS = 8
MMA_K6_WARPS = 16
FMA_BWD_THREADS = 256


def _lanes(dim: int) -> int:
    return -(-dim // 128) * 128


def single_pass(m: int, d: int, c: int) -> bool:
    """True where the JAX ``_pick_block`` (:126) accepts: the backward's
    footprint ``_bwd_vmem_bytes`` (:114-123) at the smallest query block,
    8 rows, fits ``VMEM_BUDGET``.  At the port's widths (d ≤ 32, c ≤ 128
    pad to 128 lanes) that is M ≤ 5,857, so every model shape up to
    M = 4096.  It does not depend on N: the JAX picker's N divisibility
    and its ``N >= 256`` rule are TPU tiling matters."""
    dc = _lanes(d) + _lanes(c)
    return (3 * 8 * _lanes(m) * 4 + 2 * m * dc * 4 + 3 * 8 * dc * 4
            <= VMEM_BUDGET)


def mma_key_tiles(d: int, c: int) -> int:
    """m16 key tiles a warp of the bf16 key-major pass owns (K6, K2's
    gradient pass; ``attention_flash_mma.cu`` bwd_key_tiles): as many (8,
    4, 2 or 1) as keep a lane's dK and dV accumulators, 4 floats an n8
    tile of d and of c, within 64 registers."""
    acc = 4 * (-(-d // 8) + c // 8)
    return 8 if acc <= 8 else 4 if acc <= 16 else 2 if acc <= 32 else 1


def k6_warps(d: int) -> int:
    """Warps a block of the bf16 K6 at head width d
    (``attention_flash_mma.cu`` k6_warps): 16 at d <= 16, where one block
    takes the SM two 8-warp blocks would share and writes half their dq
    partials; 8 at d = 32, where 16 warps' shared memory would pass the
    SM's."""
    return MMA_K6_WARPS if d <= 16 else MMA_BWD_WARPS


def fused_keys_per_block(d: int, c: int, itemsize: int) -> int:
    """Keys a block of K6 owns, for each of which it writes one fp32 dq
    partial [N, d].  bf16 (``attention_flash_mma.cu``): :func:`k6_warps`
    warps of :func:`mma_key_tiles` 16-key tiles.  fp32
    (``attention_flash_bwd.cu``): 256 threads of 4, 2 or 1 keys by
    d + c."""
    if itemsize == 2:
        return k6_warps(d) * 16 * mma_key_tiles(d, c)
    return FMA_BWD_THREADS * (4 if d + c <= 10 else 2 if d + c <= 20 else 1)


# blocks an SM the bf16 K2's gradient pass aims for
# (attention_flash_mma.cu kK2Fill): its key block is K6's, halved while the
# grid holds fewer (church64 G's 64 map at B = 64: 256 keys, 256 blocks,
# where K6's 1,024 would make 64 blocks for the H100's 132 SMs)
K2_FILL = 1


def k2_key_blocks(b: int, m: int, d: int, c: int, sms: int,
                  fill: int = K2_FILL) -> int:
    """Key blocks of the bf16 K2's gradient pass on a card of ``sms`` SMs,
    each of which writes one fp32 dq partial [N, d]: 8 warps of KT 16-key
    tiles, KT from :func:`mma_key_tiles` and halved (down to 1) while
    B x blocks < ``fill`` x ``sms`` (``fill`` 0: K6's 8-warp key block).
    The Python copy of the library's rule (``k2_key_tiles``), which
    chip_smoke holds against it."""
    tiles = mma_key_tiles(d, c)
    while fill > 0 and tiles > 1 and \
            b * -(-m // (MMA_BWD_WARPS * 16 * tiles)) < fill * sms:
        tiles //= 2
    return -(-m // (MMA_BWD_WARPS * 16 * tiles))


def dq_slab_bytes(b: int, n: int, m: int, d: int, c: int,
                  itemsize: int) -> int:
    """Bytes of K6's fp32 dq partials, [B, ceil(M / key block), N, d]."""
    return b * -(-m // fused_keys_per_block(d, c, itemsize)) * n * d * 4


def flash_bwd_fused(b: int, n: int, m: int, d: int, c: int,
                    itemsize: int) -> bool:
    """True where the flash backward takes the fused one-pass kernel K6:
    its dq partials stay within ``DQ_SLAB_BUDGET``; else the two-kernel
    backward K4 + K5, which needs no scratch."""
    return dq_slab_bytes(b, n, m, d, c, itemsize) <= DQ_SLAB_BUDGET


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              use_pallas: bool | None = None) -> torch.Tensor:
    """The kernels for CUDA tensors, the plain versions for CPU tensors,
    forward and backward alike: the single-pass pair where
    :func:`single_pass` accepts, the flash path otherwise.

    ``use_pallas=False`` keeps the config key's JAX meaning: the plain
    path on any device, differentiated by autograd, in query-row chunks
    where the logits would pass ``PLAIN_CHUNK_BYTES``.  ``None`` and
    ``True`` take the kernels wherever the tensors lie on the card."""
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    if use_pallas is False:
        return attention_reference(q, k, v, chunk=plain_chunk(b, n, m))
    from .cuda_attention import FlashAttention, FusedAttention
    if single_pass(m, d, c):
        return FusedAttention.apply(q, k, v)
    return FlashAttention.apply(q, k, v)
