"""Wrappers of the hand-written CUDA attention kernels and their autograd
Functions:

* :func:`attention_fused`, the single-pass forward
  (``csrc/attention_fwd.cu``), the port of the TPU kernel
  ``sagan_tpu/ops/pallas_attention.py::_fwd_kernel`` (K1);
* :func:`attention_bwd_fused`, its backward (``csrc/attention_bwd.cu``),
  the port of ``_bwd_kernel`` (K2);
* :func:`attention_flash_fwd`, the flash forward with the row log-sum-exp,
  the port of ``_flash_fwd_kernel`` (K3);
* :func:`attention_flash_dq`, :func:`attention_flash_dkv` and
  :func:`attention_flash_dqkv`, the flash backward from the stored
  (o, lse), the ports of ``_flash_dq_kernel`` (K4), ``_flash_dkv_kernel``
  (K5) and the fused ``_flash_dqkv_kernel`` (K6), and
  :func:`attention_flash_dq_dkv`, K4 then K5 as the two-kernel backward
  runs them;
* :class:`FusedAttention` (K1 forward, K2 backward) and
  :class:`FlashAttention` (K3 forward; K6, or K4 + K5, backward by
  :func:`~sagan_tpu_torch.ops.attention.flash_bwd_fused`), the
  ``torch.autograd.Function`` pairs, as the JAX package's ``custom_vjp``
  pairs them.

Every kernel has two engines.  ``mma``
(``csrc/attention_flash_mma.cu``) runs the contractions of every (query,
key) pair on the tensor cores and takes bf16 only; ``fma`` (K1 and K3 in
``csrc/attention_fwd.cu``, K2 in ``csrc/attention_bwd.cu``, K4-K6 in
``csrc/attention_flash_bwd.cu``) runs them as fp32 FMAs on the CUDA cores
and takes bf16 and fp32.  The dtype picks the engine: bf16 tensors take
``mma``, fp32 tensors ``fma`` (the tensor cores would take fp32 only as
TF32, which misses the fp32 limit of 1e-4).  That is a dtype rule, not a
fallback: a failed build or launch raises.  ``engine="fma"`` names the
CUDA-core kernels for bf16 too, which the studies and ``chip_smoke.py``
time beside the tensor-core ones; the model's path never passes it.
The ``mma`` K2 is three launches of one call: a query-major stats pass
(each row's -lse log2e and delta), a key-major gradient pass after K6's
with fp32 dq partials over key blocks sized to fill the card
(:func:`~sagan_tpu_torch.ops.attention.k2_key_blocks`), and their
sum in key-block order.  The ``mma`` K4 and K5 read each query row's
(-lse log2e, delta) from a delta pass that the two-kernel backward runs
once for both (:func:`attention_flash_dq_dkv`); a K4 or K5 called alone
runs it first.

Each wrapper launches its kernel for tensors on the card and raises on
anything the kernel does not take; it runs the plain version
(:mod:`~sagan_tpu_torch.ops.attention`) only for tensors on the CPU.
There is no fallback from a failed build or launch.

``LAUNCHES``, ``BWD_LAUNCHES``, ``FLASH_FWD_LAUNCHES``,
``FLASH_DQ_LAUNCHES``, ``FLASH_DKV_LAUNCHES`` and ``FLASH_DQKV_LAUNCHES``
count the kernels' launches (K1-K6 on the ``fma`` engine), and
``FWD_MMA_LAUNCHES``, ``BWD_MMA_LAUNCHES``, ``FLASH_FWD_MMA_LAUNCHES``,
``FLASH_DQ_MMA_LAUNCHES``, ``FLASH_DKV_MMA_LAUNCHES`` and
``FLASH_DQKV_MMA_LAUNCHES`` those of the ``mma`` K1-K6 (the delta pass
of the two-kernel backward counts with K4's launch), so a run can show
that its attention went through them.

The wrappers of K1 and K3-K6 take ``tiles``, ``-D`` defines that build
their library at other tiles (``csrc/attention_fwd.cu``'s
``SAGAN_FWD_ROWS``, ``SAGAN_FWD_TILE``; ``csrc/attention_flash_bwd.cu``'s
``SAGAN_BWD_ROWS``, ``SAGAN_BWD_KEY_TILE``, ``SAGAN_BWD_THREADS``,
``SAGAN_BWD_KPT``; with ``engine="mma"``, ``csrc/attention_flash_mma.cu``'s
``SAGAN_MMA_*``, each of which flips one of K3's design choices, and
``SAGAN_K1_*``, ``SAGAN_K2_*``, ``SAGAN_K4_*``, ``SAGAN_K5_*`` and
``SAGAN_K6_*``, K1's, K2's, K4's, K5's and K6's), for the studies; the
default ``()`` is the shipped library.  A K6 built with other defines
reports its own key block and delta rows, and the wrapper sizes its
scratch from them.  Tile defines without an engine
name the ``fma`` kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from . import _build
from .attention import (attention_bwd_reference, attention_flash_bwd_reference,
                        attention_flash_reference, attention_reference,
                        flash_bwd_fused, fused_keys_per_block, plain_chunk)

SOURCE = "attention_fwd"
BWD_SOURCE = "attention_bwd"
FLASH_BWD_SOURCE = "attention_flash_bwd"
MMA_SOURCE = "attention_flash_mma"
ENGINES = ("mma", "fma")
SUPPORTED_D = (2, 4, 8, 16, 32)
SUPPORTED_C = (8, 16, 32, 64, 128)
_IS_BF16 = {torch.float32: 0, torch.bfloat16: 1}

# the C entry points: {name: (source, tensor pointers)}; each also takes
# b, n, m, d, c, is_bf16 and the stream
_ENTRIES = {
    "sagan_attention_fwd": (SOURCE, 4),                # q k v o
    "sagan_attention_flash_fwd": (SOURCE, 5),          # q k v o lse
    "sagan_attention_bwd": (BWD_SOURCE, 8),            # q k v g dq dk dv stats
    "sagan_attention_flash_dq": (FLASH_BWD_SOURCE, 7),    # q k v g o lse dq
    "sagan_attention_flash_dkv": (FLASH_BWD_SOURCE, 8),   # ... lse dk dv
    "sagan_attention_flash_dqkv": (FLASH_BWD_SOURCE, 9),  # ... dk dv part
    "sagan_attention_flash_fwd_mma": (MMA_SOURCE, 5),     # q k v o lse
    "sagan_attention_flash_dqkv_mma": (MMA_SOURCE, 10),   # ... part ld
    "sagan_attention_fwd_mma": (MMA_SOURCE, 4),           # q k v o
    "sagan_attention_bwd_mma": (MMA_SOURCE, 9),   # q k v g dq dk dv ld part
    "sagan_attention_flash_delta_mma": (MMA_SOURCE, 4),   # g o lse ld
    "sagan_attention_flash_dq_mma": (MMA_SOURCE, 6),      # q k v g ld dq
    "sagan_attention_flash_dkv_mma": (MMA_SOURCE, 7),     # ... ld dk dv
}

LAUNCHES = 0
BWD_LAUNCHES = 0
FLASH_FWD_LAUNCHES = 0
FLASH_DQ_LAUNCHES = 0
FLASH_DKV_LAUNCHES = 0
FLASH_DQKV_LAUNCHES = 0
FLASH_FWD_MMA_LAUNCHES = 0
FLASH_DQ_MMA_LAUNCHES = 0
FLASH_DKV_MMA_LAUNCHES = 0
FLASH_DQKV_MMA_LAUNCHES = 0
FWD_MMA_LAUNCHES = 0
BWD_MMA_LAUNCHES = 0


def build_specs(widths=SUPPORTED_C,
                sources=(SOURCE, BWD_SOURCE, FLASH_BWD_SOURCE, MMA_SOURCE),
                tiles: tuple = ()) -> list:
    """``_build.build`` specs of the kernels: one library per source and
    value width (and tile defines ``tiles``)."""
    return [(src, (f"-DSAGAN_ATTN_C={c}", *tiles)) for src in sources
            for c in widths]


@functools.cache
def _entry(name: str, c: int, tiles: tuple = ()):
    """The C entry point ``name`` of its library for value width ``c``
    built with ``tiles``."""
    source, pointers = _ENTRIES[name]
    fn = getattr(_build.load(*build_specs((c,), (source,), tiles)[0]), name)
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _int_fn(source: str, name: str, c: int, tiles: tuple = (),
            ints: int = 1):
    fn = getattr(_build.load(*build_specs((c,), (source,), tiles)[0]), name)
    fn.argtypes = [ctypes.c_int] * ints
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def keys_per_block(d: int, c: int, tiles: tuple = (),
                   engine: str = "mma") -> int:
    """Keys each block of K6 on ``engine`` (and of the ``fma`` K5) owns at
    widths (d, c), as its library built with ``tiles`` reports it: K6
    writes one fp32 dq partial [N, d] per block of them."""
    if engine == "mma":
        return _int_fn(MMA_SOURCE, "sagan_attention_flash_mma_keys_per_block",
                       c, tiles)(d)
    return _int_fn(FLASH_BWD_SOURCE, "sagan_attention_flash_keys_per_block",
                   c, tiles)(d)


def dq_partial_shape(b: int, n: int, m: int, d: int, c: int,
                     tiles: tuple = (), engine: str = "mma") -> tuple:
    """Shape of the fp32 dq partials of K6 on ``engine``:
    [B, ceil(M / key block), N, d] (4 bytes an element).  The key block
    is :func:`~sagan_tpu_torch.ops.attention.fused_keys_per_block`'s,
    which the route rule sizes the slab by, except for a K6 built with
    ``tiles``, whose library reports its own (:func:`keys_per_block`)."""
    if tiles:
        kb = keys_per_block(d, c, tiles, engine)
    else:
        kb = fused_keys_per_block(d, c, 2 if engine == "mma" else 4)
    return b, -(-m // kb), n, d


def _engine(q: torch.Tensor, engine: str | None, tiles: tuple) -> str:
    """The engine of a K1-K6 call on CUDA tensors: ``engine``
    as named, else ``mma`` for bf16 without tile defines and ``fma``
    otherwise; raises for ``mma`` on fp32."""
    if engine is None:
        engine = "mma" if q.dtype == torch.bfloat16 and not tiles else "fma"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine == "mma" and q.dtype != torch.bfloat16:
        raise TypeError(f"the mma engine runs on the tensor cores in bf16, "
                        f"got {q.dtype}")
    return engine


def _refuse_engine_off_card(engine: str | None) -> None:
    if engine is not None:
        raise ValueError(f"engine={engine!r} names a CUDA kernel; CPU tensors "
                         f"run the plain version")


def _check_mma_alignment(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the mma kernels copy rows in 16-byte chunks: the "
                         "tensors' storage must be 16-byte aligned")


def _launch(name: str, tensors, q: torch.Tensor, c: int,
            tiles: tuple = ()) -> None:
    """Launch entry ``name`` of the library built with ``tiles`` on
    ``tensors`` (q first) on the current stream; raises if the launch
    failed."""
    b, n, d = q.shape
    m = tensors[1].shape[1]
    with torch.cuda.device(q.device):
        err = _entry(name, c, tuple(tiles))(
            *(t.data_ptr() for t in tensors), b, n, m, d, c,
            _IS_BF16[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           g: torch.Tensor | None = None, o: torch.Tensor | None = None,
           lse: torch.Tensor | None = None) -> None:
    named = {"q": q, "k": k, "v": v} | ({} if g is None else {"g": g}) \
        | ({} if o is None else {"o": o})
    every = named | ({} if lse is None else {"lse": lse})
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in every.values()):
        raise ValueError(
            f"attention kernel needs {', '.join(every)} on one CUDA device, "
            f"got {', '.join(str(t.device) for t in every.values())}")
    if q.dtype not in _IS_BF16 or any(t.dtype != q.dtype
                                      for t in named.values()):
        raise TypeError(
            f"attention kernel takes float32 or bfloat16 {', '.join(named)} "
            f"of one dtype, got "
            f"{', '.join(str(t.dtype) for t in named.values())}")
    if any(t.dim() != 3 for t in every.values()):
        raise ValueError("attention kernel takes q [B,N,D], k [B,M,D], "
                         "v [B,M,C], g and o [B,N,C] and lse [B,N,1]")
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    want = {"k": (b, m, d), "g": (b, n, c), "o": (b, n, c), "lse": (b, n, 1)}
    if v.shape[0] != b or any(tuple(every[name].shape) != shape
                              for name, shape in want.items()
                              if name in every):
        raise ValueError(
            "attention shapes disagree: " + ", ".join(
                f"{name} {tuple(t.shape)}" for name, t in every.items()))
    if lse is not None and lse.dtype != torch.float32:
        raise TypeError(f"attention kernel takes lse in float32, got "
                        f"{lse.dtype}")
    if min(b, n, m) < 1 or b > 65535:
        raise ValueError(f"attention kernel needs 1 <= B <= 65535 and "
                         f"N, M >= 1, got B={b} N={n} M={m}")
    if d not in SUPPORTED_D or c not in SUPPORTED_C:
        raise ValueError(f"attention kernel is built for d in {SUPPORTED_D} "
                         f"and c in {SUPPORTED_C}, got d={d} c={c}")
    if not all(t.is_contiguous() for t in every.values()):
        raise ValueError(
            f"attention kernel needs contiguous {', '.join(every)}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _cpu_chunk(q: torch.Tensor, k: torch.Tensor) -> int | None:
    """Query rows a CPU call of a plain flash version takes at a time:
    church512's 512 map would otherwise hold [B, 262144, 65536] fp32
    logits, 68 GB at B=1."""
    return plain_chunk(q.shape[0], q.shape[1], k.shape[1])


def attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    tiles: tuple = (), engine: str | None = None
                    ) -> torch.Tensor:
    """softmax(q kᵀ) v with unscaled logits.  q [B,N,D], k [B,M,D],
    v [B,M,C] -> [B,N,C] in q.dtype, on ``engine`` (by default ``mma``
    for bf16, ``fma`` for fp32).  Not differentiable itself: the model
    calls it through :class:`FusedAttention`."""
    global LAUNCHES, FWD_MMA_LAUNCHES
    if _on_cpu(q, k, v):
        _refuse_engine_off_card(engine)
        return attention_reference(q, k, v)
    _check(q, k, v)
    engine = _engine(q, engine, tuple(tiles))
    b, n, _ = q.shape
    c = v.shape[2]
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    if engine == "mma":
        _check_mma_alignment(q, k, v)
        _launch("sagan_attention_fwd_mma", (q, k, v, out), q, c, tiles)
        FWD_MMA_LAUNCHES += 1
    else:
        _launch("sagan_attention_fwd", (q, k, v, out), q, c, tiles)
        LAUNCHES += 1
    return out


@functools.cache
def bwd_mma_key_blocks(b: int, m: int, d: int, c: int,
                       tiles: tuple = ()) -> int:
    """Key blocks of the ``mma`` K2's gradient pass at (B, M, d, c) on the
    card (the library reads the SM count of the device current at its
    first call), as its library (built with ``tiles``) reports them: K2
    writes one fp32 dq partial [N, d] per block, [B, blocks, N, d] in all
    (:func:`~sagan_tpu_torch.ops.attention.k2_key_blocks` is the
    rule)."""
    return _int_fn(MMA_SOURCE, "sagan_attention_bwd_mma_key_blocks", c,
                   tiles, ints=3)(b, m, d)


def attention_bwd_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, tiles: tuple = (),
                        engine: str | None = None):
    """(dq, dk, dv) of softmax(q kᵀ) v at output cotangent g [B,N,C]:
    dq in q's dtype, dk and dv summed in fp32 and cast to k's and v's; on
    ``engine`` (by default ``mma`` for bf16, ``fma`` for fp32).  The
    ``mma`` K2's scratch comes from ``torch.empty`` here: each query row's
    (-lse log2e, delta), fp32 [B, rows padded to 64, 2], and the dq
    partials, fp32 [B, key blocks, N, d]."""
    global BWD_LAUNCHES, BWD_MMA_LAUNCHES
    if _on_cpu(q, k, v, g):
        _refuse_engine_off_card(engine)
        return attention_bwd_reference(q, k, v, g)
    _check(q, k, v, g)
    engine = _engine(q, engine, tuple(tiles))
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if engine == "mma":
        _check_mma_alignment(q, k, v, g)
        blocks = bwd_mma_key_blocks(b, m, d, c, tuple(tiles))
        ld = torch.empty((b, _delta_rows(n, c), 2), dtype=torch.float32,
                         device=q.device)
        part = torch.empty((b, blocks, n, d), dtype=torch.float32,
                           device=q.device)
        _launch("sagan_attention_bwd_mma", (q, k, v, g, dq, dk, dv, ld, part),
                q, c, tiles)
        BWD_MMA_LAUNCHES += 1
    else:
        stats = torch.empty((3, b, n), dtype=torch.float32, device=q.device)
        _launch("sagan_attention_bwd", (q, k, v, g, dq, dk, dv, stats), q, c,
                tiles)
        BWD_LAUNCHES += 1
    return dq, dk, dv


def attention_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        tiles: tuple = (), engine: str | None = None):
    """(o, lse): softmax(q kᵀ) v in q.dtype and the row log-sum-exp of the
    unscaled logits, fp32 [B, N, 1], as the flash backward takes them; on
    ``engine`` (by default ``mma`` for bf16, ``fma`` for fp32)."""
    global FLASH_FWD_LAUNCHES, FLASH_FWD_MMA_LAUNCHES
    if _on_cpu(q, k, v):
        _refuse_engine_off_card(engine)
        return attention_flash_reference(q, k, v, _cpu_chunk(q, k))
    _check(q, k, v)
    engine = _engine(q, engine, tuple(tiles))
    b, n, _ = q.shape
    c = v.shape[2]
    o = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, 1), dtype=torch.float32, device=q.device)
    if engine == "mma":
        _check_mma_alignment(q, k, v)
        _launch("sagan_attention_flash_fwd_mma", (q, k, v, o, lse), q, c,
                tiles)
        FLASH_FWD_MMA_LAUNCHES += 1
    else:
        _launch("sagan_attention_flash_fwd", (q, k, v, o, lse), q, c, tiles)
        FLASH_FWD_LAUNCHES += 1
    return o, lse


def _flash_delta(q, o, lse, g, tiles: tuple = ()) -> torch.Tensor:
    """The ``mma`` K4's and K5's delta pass on CUDA tensors: each query
    row's (-lse log2e, delta = g . o), fp32 [B, N padded to 64, 2], padded
    rows (-inf, 0)."""
    b, n, _ = q.shape
    c = g.shape[2]
    ld = torch.empty((b, _delta_rows(n, c), 2), dtype=torch.float32,
                     device=q.device)
    _launch("sagan_attention_flash_delta_mma", (g, o, lse, ld), q, c, tiles)
    return ld


def _check_ld(ld: torch.Tensor, q: torch.Tensor, c: int) -> None:
    """``ld`` as the delta pass writes it for q: fp32 [B, N padded, 2],
    contiguous, on q's device."""
    want = (q.shape[0], _delta_rows(q.shape[1], c), 2)
    if (tuple(ld.shape) != want or ld.dtype != torch.float32
            or ld.device != q.device or not ld.is_contiguous()):
        raise ValueError(f"ld must be contiguous float32 {want} on "
                         f"{q.device}, got {ld.dtype} {tuple(ld.shape)} on "
                         f"{ld.device}")


def attention_flash_dq(q, k, v, o, lse, g, tiles: tuple = (),
                       engine: str | None = None,
                       ld: torch.Tensor | None = None) -> torch.Tensor:
    """dq in q's dtype from the stored (o, lse) at cotangent g (K4, on
    ``engine``, by default ``mma`` for bf16 and ``fma`` for fp32).  The
    ``mma`` K4 reads each query row's (-lse log2e, delta) from ``ld``, the
    delta pass's scratch (:func:`attention_flash_dq_dkv` runs it once for
    K4 and K5), and without it runs the delta pass first."""
    global FLASH_DQ_LAUNCHES, FLASH_DQ_MMA_LAUNCHES
    if _on_cpu(q, k, v, o, lse, g):
        _refuse_engine_off_card(engine)
        return attention_flash_bwd_reference(q, k, v, o, lse, g,
                                             _cpu_chunk(q, k))[0]
    _check(q, k, v, g, o, lse)
    engine = _engine(q, engine, tuple(tiles))
    c = v.shape[2]
    dq = torch.empty_like(q)
    if engine == "mma":
        _check_mma_alignment(q, k, v, g, o)
        if ld is None:
            ld = _flash_delta(q, o, lse, g, tiles)
        _check_ld(ld, q, c)
        _launch("sagan_attention_flash_dq_mma", (q, k, v, g, ld, dq), q, c,
                tiles)
        FLASH_DQ_MMA_LAUNCHES += 1
    else:
        _launch("sagan_attention_flash_dq", (q, k, v, g, o, lse, dq), q, c,
                tiles)
        FLASH_DQ_LAUNCHES += 1
    return dq


def attention_flash_dkv(q, k, v, o, lse, g, tiles: tuple = (),
                        engine: str | None = None,
                        ld: torch.Tensor | None = None):
    """(dk, dv), fp32 sums cast to k's and v's dtypes, from the stored
    (o, lse) at cotangent g (K5, on ``engine`` as K4; ``ld`` as K4's)."""
    global FLASH_DKV_LAUNCHES, FLASH_DKV_MMA_LAUNCHES
    if _on_cpu(q, k, v, o, lse, g):
        _refuse_engine_off_card(engine)
        return attention_flash_bwd_reference(q, k, v, o, lse, g,
                                             _cpu_chunk(q, k))[1:]
    _check(q, k, v, g, o, lse)
    engine = _engine(q, engine, tuple(tiles))
    c = v.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if engine == "mma":
        _check_mma_alignment(q, k, v, g, o)
        if ld is None:
            ld = _flash_delta(q, o, lse, g, tiles)
        _check_ld(ld, q, c)
        _launch("sagan_attention_flash_dkv_mma", (q, k, v, g, ld, dk, dv), q,
                c, tiles)
        FLASH_DKV_MMA_LAUNCHES += 1
    else:
        _launch("sagan_attention_flash_dkv", (q, k, v, g, o, lse, dk, dv), q,
                c, tiles)
        FLASH_DKV_LAUNCHES += 1
    return dk, dv


def attention_flash_dq_dkv(q, k, v, o, lse, g, tiles: tuple = (),
                           engine: str | None = None):
    """(dq, dk, dv): K4 then K5 on ``engine`` (by default the dtype's), as
    the two-kernel backward runs them; on ``mma`` after one delta pass
    that both read (three launches)."""
    if _on_cpu(q, k, v, o, lse, g):
        _refuse_engine_off_card(engine)
        return attention_flash_bwd_reference(q, k, v, o, lse, g,
                                             _cpu_chunk(q, k))
    _check(q, k, v, g, o, lse)
    engine = _engine(q, engine, tuple(tiles))
    ld = None
    if engine == "mma":
        _check_mma_alignment(q, k, v, g, o)
        ld = _flash_delta(q, o, lse, g, tiles)
    return (attention_flash_dq(q, k, v, o, lse, g, tiles, engine, ld),
            *attention_flash_dkv(q, k, v, o, lse, g, tiles, engine, ld))


def attention_flash_dqkv(q, k, v, o, lse, g, tiles: tuple = (),
                         engine: str | None = None):
    """(dq, dk, dv) from one score recompute (K6, on ``engine``, by default
    ``mma`` for bf16 and ``fma`` for fp32): dk and dv fp32 sums cast to
    k's and v's dtypes, dq the sum of the kernel's fp32 per-key-block
    partials in key-block order, cast to q's dtype."""
    if _on_cpu(q, k, v, o, lse, g):
        _refuse_engine_off_card(engine)
        return attention_flash_bwd_reference(q, k, v, o, lse, g,
                                             _cpu_chunk(q, k))
    part, dk, dv = attention_flash_dqkv_partials(q, k, v, o, lse, g, tiles,
                                                 engine)
    # the partials are summed outside the kernel, as the JAX package sums
    # its slab outside its kernel (pallas_attention.py:737)
    return part.sum(dim=1).to(q.dtype), dk, dv


@functools.cache
def _delta_rows(n: int, c: int, tiles: tuple = ()) -> int:
    """Rows of the ``mma`` K6's (-lse log2e, delta) scratch for n query
    rows, n padded to the query tile of its library built with ``tiles``.
    The shipped library's are also the rows of K2's, K4's and K5's scratch
    (64-row tiles, which no define of K6 changes)."""
    return _int_fn(MMA_SOURCE, "sagan_attention_flash_mma_delta_rows", c,
                   tiles)(n)


def attention_flash_dqkv_partials(q, k, v, o, lse, g, tiles: tuple = (),
                                  engine: str | None = None):
    """K6's launch alone, on CUDA tensors: (the fp32 dq partials
    [B, NKB, N, d], dk, dv).  The ``mma`` K6 first writes, in a kernel of
    its own, each query row's (-lse log2e, delta) to fp32 scratch; the
    pair counts as one launch.  Both are sized by the library built with
    ``tiles`` (its K6 defines set the key block and the query tile)."""
    global FLASH_DQKV_LAUNCHES, FLASH_DQKV_MMA_LAUNCHES
    _check(q, k, v, g, o, lse)
    engine = _engine(q, engine, tuple(tiles))
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    part = torch.empty(dq_partial_shape(b, n, m, d, c, tuple(tiles), engine),
                       dtype=torch.float32, device=q.device)
    if engine == "mma":
        _check_mma_alignment(q, k, v, g, o)
        ld = torch.empty((b, _delta_rows(n, c, tuple(tiles)), 2),
                         dtype=torch.float32, device=q.device)
        _launch("sagan_attention_flash_dqkv_mma",
                (q, k, v, g, o, lse, dk, dv, part, ld), q, c, tiles)
        FLASH_DQKV_MMA_LAUNCHES += 1
    else:
        _launch("sagan_attention_flash_dqkv",
                (q, k, v, g, o, lse, dk, dv, part), q, c, tiles)
        FLASH_DQKV_LAUNCHES += 1
    return part, dk, dv


class FusedAttention(torch.autograd.Function):
    """softmax(q kᵀ) v whose forward is :func:`attention_fused` and whose
    backward is :func:`attention_bwd_fused`, each on its dtype's engine;
    like the JAX custom VJP it keeps (q, k, v), not the softmax, and only
    when a gradient is needed."""

    @staticmethod
    def forward(ctx, q, k, v):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v)
        return attention_fused(q, k, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # the cotangent arrives as a view through the caller's
        # transpose/reshape; the kernel takes contiguous rows
        with span("attention.bwd"):
            return attention_bwd_fused(q, k, v, g.contiguous())


class FlashAttention(torch.autograd.Function):
    """softmax(q kᵀ) v on the flash path: forward
    :func:`attention_flash_fwd`, which keeps (q, k, v, o, lse) only when a
    gradient is needed (``_attention_flash_fwd``); backward
    :func:`attention_flash_dqkv` where its dq partials fit
    (:func:`~sagan_tpu_torch.ops.attention.flash_bwd_fused`), else
    :func:`attention_flash_dq_dkv` (K4 and K5).  Each on its dtype's
    engine."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = attention_flash_fwd(q, k, v)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        b, n, d = q.shape
        m, c = v.shape[1], v.shape[2]
        with span("attention.bwd"):
            g = g.contiguous()
            if flash_bwd_fused(b, n, m, d, c, q.element_size()):
                return attention_flash_dqkv(q, k, v, o, lse, g)
            return attention_flash_dq_dkv(q, k, v, o, lse, g)
