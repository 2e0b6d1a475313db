"""Wrappers of the attention study kernels, for the studies of
``sagan_tpu_torch/tools/bench_attn_*.py``:

* :func:`attention_study`, the study forward (S1), the port of the TPU
  study kernels of ``tools/bench_attn_floor.py`` (``_call`` and its
  bodies) and of the flash floors of ``tools/bench_attn_floor256.py``
  (``_floor_kernel``), one ``variant`` of
  :data:`~sagan_tpu_torch.ops.attention_study.VARIANTS` a call.  Its
  ``fma`` variants run ``csrc/attention_study.cu`` on the CUDA cores; its
  ``mma`` variants are builds of the shipped bf16 K1/K3 body
  (``csrc/attention_flash_mma.cu``) with the variant's math switched at
  build time (:data:`MMA_VARIANT_DEFINES`), launched through K1's entry
  where :func:`~sagan_tpu_torch.ops.attention.single_pass` takes the
  shape and K3's otherwise (its lse discarded), so that
  ``"mma_exp2"`` is the shipped kernel itself;
* :func:`attention_folded`, the folded-projection forward
  (``csrc/attention_folded.cu``, S2), the port of ``k_folded``
  (``tools/bench_attn_floor.py``) and ``_folded_kernel``
  (``tools/bench_attn_floor256.py``): bf16 on the tensor cores, fp32 on
  the CUDA cores.

Each launches its kernel for tensors on the card and raises on anything
the kernel does not take; it runs the plain version
(:mod:`~sagan_tpu_torch.ops.attention_study`) only for tensors on the CPU.
``STUDY_LAUNCHES`` and ``FOLDED_LAUNCHES`` count the launches (an ``mma``
variant's counts here, not with K1's or K3's).

The tile points of the studies' sweeps of the shipped kernels are here
too (``FWD_POINTS``, ``BWD_POINTS``, and the design flips of the
tensor-core kernels, ``MMA_POINTS``, ``K1_MMA_POINTS``,
``K2_MMA_POINTS``, ``K45_MMA_POINTS``, ``K6_MMA_POINTS``), with
:func:`build_specs`, every library the studies load, for one parallel
build.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import cuda_attention as ca
from .attention import plain_chunk, single_pass
from .attention_study import (VARIANTS, folded_reference,
                              study_attention_reference)

SOURCE = "attention_study"
FOLDED_SOURCE = "attention_folded"
D, C, CIN = 2, 8, 16  # the widths of every study shape

STUDY_LAUNCHES = 0
FOLDED_LAUNCHES = 0

# K1/K3 (csrc/attention_fwd.cu): (query rows a block, keys a tile); the
# first is the shipped point
FWD_POINTS = ((64, 32), (128, 32), (32, 32), (64, 16), (64, 64))
# K4 (query rows a block, keys a tile) and K5/K6 (threads a block, keys a
# thread) of csrc/attention_flash_bwd.cu, one library each; the first is
# the shipped point
BWD_POINTS = ((64, 32, 256, 4), (128, 32, 128, 4), (32, 32, 512, 2),
              (64, 64, 256, 1))
# S1's tensor-core variants: the shipped K1/K3 body
# (csrc/attention_flash_mma.cu fwd_mma_body) built with the variant's math
# switches, one library each; mma_exp2 is the shipped library
MMA_VARIANT_DEFINES = {
    "mma": ("-DSAGAN_MMA_MATH=exp",),
    "mma_fma_scores": ("-DSAGAN_MMA_MATH=exp", "-DSAGAN_MMA_FMA_SCORES=1"),
    "mma_exp2": (),
    "mma_nomax": ("-DSAGAN_MMA_MATH=nomax",),
    "mma_noexp": ("-DSAGAN_MMA_MATH=noexp",),
    "mma_e16": ("-DSAGAN_MMA_MATH=e16",),
}
# the tensor-core K3 (csrc/attention_flash_mma.cu) with one design choice
# flipped a point, each its own library; the first is the shipped kernel
# (its __expf exponent is S1's mma variant, timed beside it as a floor)
MMA_DEFINES = {
    ("shipped",): (),
    ("ring_staging",): ("-DSAGAN_MMA_STAGES=3",),
    ("two_row_tiles",): ("-DSAGAN_MMA_ROW_TILES=2",),
    ("mask_every_tile",): ("-DSAGAN_MMA_MASK_ALL=1",),
    ("vote_skip",): ("-DSAGAN_MMA_VOTE=1",),
}
MMA_POINTS = tuple(MMA_DEFINES)
# the tensor-core K1 and K2 (csrc/attention_flash_mma.cu) with one of their
# design choices flipped a point, each its own library; the first is the
# shipped kernel.  K1: K3's 64-key tile walk in place of the whole key set
# staged once, 4 warps a block in place of 8, two m16 row tiles a warp.
# K2: K6's key block (no halving to fill the card), a fill of 2 blocks an
# SM in place of 1, the stats pass on K3's tile walk.
K1_MMA_DEFINES = {
    ("shipped",): (),
    ("tile_walk",): ("-DSAGAN_K1_WHOLE_BYTES=0",),
    ("four_warps",): ("-DSAGAN_K1_WARPS=4",),
    ("two_row_tiles",): ("-DSAGAN_K1_ROW_TILES=2",),
}
K2_MMA_DEFINES = {
    ("shipped",): (),
    ("k6_key_block",): ("-DSAGAN_K2_FILL=0",),
    ("fill_2",): ("-DSAGAN_K2_FILL=2",),
    ("stats_tile_walk",): ("-DSAGAN_K1_WHOLE_BYTES=0",),
}
K1_MMA_POINTS = tuple(K1_MMA_DEFINES)
K2_MMA_POINTS = tuple(K2_MMA_DEFINES)
# the tensor-core K4 and K5 (csrc/attention_flash_mma.cu) with one design
# choice flipped a point, each its own library; the first is the shipped
# pair.  K4: keys staged 128 at a time in place of 64, 8 warps a block in
# place of 4; K5: twice K6's key tiles a warp, two blocks an SM (at most
# 128 registers a thread) in place of the compiler's choice
K45_MMA_DEFINES = {
    ("shipped",): (),
    ("k4_tile_128",): ("-DSAGAN_K4_TILE=128",),
    ("k4_eight_warps",): ("-DSAGAN_K4_WARPS=8",),
    ("k5_kt_x2",): ("-DSAGAN_K5_KT_SCALE=2",),
    ("k5_two_blocks",): ("-DSAGAN_K5_MIN_BLOCKS=2",),
}
K45_MMA_POINTS = tuple(K45_MMA_DEFINES)
# the tensor-core K6 (csrc/attention_flash_mma.cu) at other (query tile,
# key block) points, the port of the TPU study's (BN, BM) sweep of its
# fused backward, each its own library; the first is the shipped kernel:
# 16 warps of 8 m16 key tiles (2,048 keys a block at d = 2, c = 8), 64
# query rows a stage, a cp.async ring of 3.  A point flips one of them,
# its label giving its keys a block at d = 2, c = 8: 1,024 or 512 keys
# through the warps (8, the block K6 shipped with before 16, or 4),
# 4,096 or 1,024 through the key tiles a warp (16, 4), 128 query rows a
# stage, a ring of 2 or 4.  The key block also sets
# the size of the fp32 dq partials.  -DSAGAN_K6_Q_TILE=32 is left out:
# ptxas spills it at 128 registers a thread (PERF.md §6)
K6_MMA_DEFINES = {
    ("shipped",): (),
    ("keys_1024_warps8",): ("-DSAGAN_K6_WARPS=8",),
    ("keys_4096_kt16",): ("-DSAGAN_K6_KEY_TILES=16",),
    ("keys_512_warps4",): ("-DSAGAN_K6_WARPS=4",),
    ("keys_1024_kt4",): ("-DSAGAN_K6_KEY_TILES=4",),
    ("q_tile_128",): ("-DSAGAN_K6_Q_TILE=128",),
    ("ring_2",): ("-DSAGAN_K6_STAGES=2",),
    ("ring_4",): ("-DSAGAN_K6_STAGES=4",),
}
K6_MMA_POINTS = tuple(K6_MMA_DEFINES)


def fwd_tiles(point) -> tuple:
    """The ``-D`` defines of forward tile point ``(rows, tile)``; the
    shipped point's are ``()``, the library the model runs."""
    if tuple(point) == FWD_POINTS[0]:
        return ()
    rows, tile = point
    return f"-DSAGAN_FWD_ROWS={rows}", f"-DSAGAN_FWD_TILE={tile}"


def bwd_tiles(point) -> tuple:
    """The ``-D`` defines of backward tile point ``(rows, key_tile,
    threads, keys_per_thread)``; the shipped point's are ``()``."""
    if tuple(point) == BWD_POINTS[0]:
        return ()
    rows, tile, threads, kpt = point
    return (f"-DSAGAN_BWD_ROWS={rows}", f"-DSAGAN_BWD_KEY_TILE={tile}",
            f"-DSAGAN_BWD_THREADS={threads}", f"-DSAGAN_BWD_KPT={kpt}")


def variant_build(variant: str) -> tuple:
    """(engine, defines) of study ``variant``: ``("fma", ())``, the
    CUDA-core S1 (``csrc/attention_study.cu``, whose tile defines the call
    names), or ``("mma", defines)``, the build of
    ``csrc/attention_flash_mma.cu`` that runs it."""
    if VARIANTS[variant][0] == "fma":
        return "fma", ()
    return "mma", MMA_VARIANT_DEFINES[variant]


def mma_entry(m: int) -> str:
    """The entry point an ``mma`` variant launches at M keys: K1's where
    :func:`~sagan_tpu_torch.ops.attention.single_pass` takes the study's
    shape, as the route does, else K3's."""
    return ("sagan_attention_fwd_mma" if single_pass(m, D, C)
            else "sagan_attention_flash_fwd_mma")


def build_specs() -> list:
    """``_build.build`` specs of every library the studies load: S1's fma
    engine at every forward tile point (it takes K1's tile defines), S2,
    K1/K3 and K4-K6 at value width 8 at every tile point, and the
    tensor-core K1-K6 at every ``MMA_VARIANT_DEFINES``, ``MMA_POINTS``,
    ``K1_MMA_POINTS``, ``K2_MMA_POINTS``, ``K45_MMA_POINTS`` and
    ``K6_MMA_POINTS`` point (one library a set of defines)."""
    specs = [(SOURCE, fwd_tiles(p)) for p in FWD_POINTS]
    specs.append((FOLDED_SOURCE, ()))
    for p in FWD_POINTS:
        specs += ca.build_specs((C,), ("attention_fwd",), fwd_tiles(p))
    for p in BWD_POINTS:
        specs += ca.build_specs((C,), ("attention_flash_bwd",), bwd_tiles(p))
    mma = [*MMA_VARIANT_DEFINES.values(), *MMA_DEFINES.values(),
           *K1_MMA_DEFINES.values(), *K2_MMA_DEFINES.values(),
           *K45_MMA_DEFINES.values(), *K6_MMA_DEFINES.values()]
    for defines in dict.fromkeys(mma):
        specs += ca.build_specs((C,), ("attention_flash_mma",), defines)
    return specs


@functools.cache
def _study_entry(tiles: tuple):
    fn = _build.load(SOURCE, tiles).sagan_attention_study
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _folded_entry():
    fn = _build.load(FOLDED_SOURCE).sagan_attention_folded
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attention_study(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    variant: str, tiles: tuple = ()) -> torch.Tensor:
    """The study forward ``variant`` of q [B,N,2], k [B,M,2], v [B,M,8]
    -> [B,N,8] in q.dtype; ``tiles`` are K1's tile defines for the fma
    engine (:func:`fwd_tiles`; the mma variants take their own,
    :func:`variant_build`)."""
    global STUDY_LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown study variant {variant!r}; one of "
                         f"{', '.join(VARIANTS)}")
    if ca._on_cpu(q, k, v):
        return study_attention_reference(
            q, k, v, variant, plain_chunk(q.shape[0], q.shape[1],
                                          k.shape[1]))
    ca._check(q, k, v)
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    if (d, c) != (D, C):
        raise ValueError(f"the study kernel is built for d={D}, c={C}, got "
                         f"d={d} c={c}")
    engine, defines = variant_build(variant)
    o = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    if engine == "mma":
        if tiles:
            raise ValueError(f"study variant {variant} is a build of the "
                             f"tensor-core K1/K3; it takes no tile defines")
        if q.dtype != torch.bfloat16:
            raise TypeError(f"study variant {variant} runs on the tensor "
                            f"cores in bf16, got {q.dtype}")
        ca._check_mma_alignment(q, k, v)
        entry = mma_entry(m)
        tensors = (q, k, v, o) if entry == "sagan_attention_fwd_mma" else (
            q, k, v, o, torch.empty((b, n, 1), dtype=torch.float32,
                                    device=q.device))
        ca._launch(entry, tensors, q, c, defines)
        STUDY_LAUNCHES += 1
        return o
    if any(t.data_ptr() % (16 if t is v else 4) for t in (q, k, v)):
        raise ValueError("the study kernel reads rows of q, k as 4-byte and "
                         "of v as 16-byte words: their storage must be "
                         "aligned so")
    with torch.cuda.device(q.device):
        err = _study_entry(tuple(tiles))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, m,
            d, c, list(VARIANTS).index(variant), ca._IS_BF16[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention_study {variant} launch failed: CUDA "
                           f"error {err}")
    STUDY_LAUNCHES += 1
    return o


def attention_folded(x: torch.Tensor, xb: torch.Tensor, w: torch.Tensor,
                     v: torch.Tensor | None = None,
                     wg: torch.Tensor | None = None) -> torch.Tensor:
    """softmax((x W) xbᵀ) V of x [B,N,16], xb [B,M,16], w [16,16], with
    V = v [B,M,8] given or xb·wg (wg [16,8]) in the kernel -> [B,N,8] in
    x.dtype."""
    global FOLDED_LAUNCHES
    if (v is None) == (wg is None):
        raise ValueError("attention_folded takes exactly one of v and wg")
    vw = v if wg is None else wg
    if ca._on_cpu(x, xb, w, vw):
        return folded_reference(x, xb, w, v, wg, plain_chunk(
            x.shape[0], x.shape[1], xb.shape[1]))
    named = {"x": x, "xb": xb, "w": w, "v" if wg is None else "wg": vw}
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in named.values()):
        raise ValueError("attention_folded needs x, xb, w and v (or wg) on "
                         "one CUDA device")
    if x.dtype not in ca._IS_BF16 or any(t.dtype != x.dtype
                                         for t in named.values()):
        raise TypeError("attention_folded takes float32 or bfloat16 "
                        "tensors of one dtype")
    if x.dim() != 3 or xb.dim() != 3:
        raise ValueError("attention_folded takes x [B,N,16], xb [B,M,16]")
    b, n, cin = x.shape
    m = xb.shape[1]
    want = {"x": (b, n, CIN), "xb": (b, m, CIN), "w": (CIN, CIN),
            "v": (b, m, C), "wg": (CIN, C)}
    if any(tuple(t.shape) != want[name] for name, t in named.items()):
        raise ValueError(
            f"attention_folded is built for Cin={CIN}, c={C}; got "
            + ", ".join(f"{name} {tuple(t.shape)}"
                        for name, t in named.items()))
    if min(b, n, m) < 1 or b > 65535:
        raise ValueError(f"attention_folded needs 1 <= B <= 65535 and "
                         f"N, M >= 1, got B={b} N={n} M={m}")
    if not all(t.is_contiguous() for t in named.values()):
        raise ValueError("attention_folded needs contiguous tensors")
    if x.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for name, t in named.items()
            if name in ("x", "xb", "v")):
        raise ValueError("the bf16 attention_folded reads rows of x, xb and "
                         "v as 16-byte chunks: their storage must be 16-byte "
                         "aligned")
    o = torch.empty((b, n, C), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _folded_entry()(
            x.data_ptr(), xb.data_ptr(), w.data_ptr(), vw.data_ptr(),
            o.data_ptr(), b, n, m, cin, C, int(wg is None),
            ca._IS_BF16[x.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention_folded launch failed: CUDA error "
                           f"{err}")
    FOLDED_LAUNCHES += 1
    return o
