"""The spectral norm K7, grouped: one call normalizes a table of weights
(every SN weight of a net).  The wrappers of the hand-written CUDA kernels
``csrc/spectral_norm.cu``, the port of the TPU kernel
``sagan_tpu/ops/pallas_spectral.py::_sn_kernel`` and of its closed-form
backward ``_sn_bwd``; their plain PyTorch versions; and
:class:`SpectralNormGroup`, the ``torch.autograd.Function`` that pairs
them.

A weight is passed in its layer's own layout with its output channels on
axis ``out_dim`` and viewed as a contiguous ``[A, O, R]`` (:func:`sn_view`),
so the fan-in index is f = a·R + r and no copy matricizes it.  A group
writes every W̄ into one flat buffer in the group's dtype (fp32, or bf16
for a bf16 layer: the fp32 quotient rounded once) and every weight's
(u_new, v, sigma) into one flat fp32 ``stats`` buffer, at offsets that
:func:`group_plan` fixes from the shapes alone (:func:`split_stats` cuts
them out).  A layer that trains has its ``u`` overwritten with u_new in
the same call.

:func:`sn_group_forward` and :func:`sn_group_backward` launch the kernels
for tensors on the card and raise on anything they do not take; they run
the plain versions (:func:`spectral_norm_reference`,
:func:`sn_bwd_reference`, weight by weight) only for tensors on the CPU.
There is no fallback from a failed build or launch.  ``LAUNCHES`` counts
grouped forward calls, ``WEIGHTS`` the weights they normalized and
``BWD_LAUNCHES`` grouped backward calls, so a run can show that its
spectral norms went through the kernels.
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from . import _build

SOURCE = "spectral_norm"
LAUNCHES = 0
WEIGHTS = 0
BWD_LAUNCHES = 0

# the kernels' design: 0 three launches a pass set (rows, colsum, finish),
# 1 one cooperative launch with grid-wide barriers (PERF.md: both timed)
DESIGN = 0
MAX_WEIGHTS = 32            # csrc kMaxWeights: weights a call
_THREADS = 256
_TILE_FLOATS = 8192         # a rows tile's target size
_MAX_SMEM = 200 * 1024      # csrc kMaxSmemBytes
_ROWS_ITEMS = 3 * 132       # the rows pass's target work items: 3 an SM
_CHUNK_ITEMS = 8 * 132      # the finish pass's and the backward's
_MIN_CHUNK = 8192           # elements a finish or backward item, at least
_PAD = 64                   # elements: a weight's offset in the flat buffers
_CACHED, _VEC_TILE = 1, 2   # csrc kCached, kVecTile
# a weight's row of the plan, int64 each, in csrc PlanField's order
PLAN_FIELDS = ("A", "O", "R", "ta", "tr", "stride", "tiles_r", "ntiles",
               "per_item", "items", "item0", "col0", "chunk0", "chunks",
               "chunk", "n_iter", "flags", "flat_off", "stat_off",
               "scratch_off", "dot_off")


def build_specs() -> list:
    """``_build.build`` specs of the kernels: one library."""
    return [(SOURCE, ())]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.sagan_sn_group_forward.argtypes = (
        [ptr, i32, ptr, ptr, i32, ptr, ptr, i64, i64, i64, i32, i64,
         ctypes.c_float, i32, ptr])
    lib.sagan_sn_group_forward.restype = i32
    lib.sagan_sn_group_backward.argtypes = (
        [ptr, i32, ptr, i32, ptr, ptr, ptr, ctypes.c_float, ptr])
    lib.sagan_sn_group_backward.restype = i32
    lib.sagan_sn_group_limits.argtypes = [ctypes.POINTER(i32)] * 2
    lib.sagan_sn_group_limits.restype = i32
    most, fields = i32(), i32()
    lib.sagan_sn_group_limits(ctypes.byref(most), ctypes.byref(fields))
    if (most.value, fields.value) != (MAX_WEIGHTS, len(PLAN_FIELDS)):
        raise RuntimeError(f"{SOURCE}.cu takes {most.value} weights of "
                           f"{fields.value} plan fields, the wrapper "
                           f"{MAX_WEIGHTS} of {len(PLAN_FIELDS)}")
    return lib


def sn_view(shape, out_dim: int) -> tuple[int, int, int]:
    """(A, O, R) of a weight of ``shape`` whose output channels lie on
    axis ``out_dim``: the axes before it, it, and the axes after it."""
    d = out_dim % len(shape)
    return math.prod(shape[:d]), shape[d], math.prod(shape[d + 1:])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tiles(a: int, o: int, r: int) -> dict:
    """How the rows pass cuts W [A, O, R]: a tile is ``ta`` slabs by
    ``tr`` of r (one of the two whole), staged with the odd row stride
    ``stride``, in shared memory with its item's sum when it fits."""
    if r >= 32:
        # rows strided by R: a tile is a range of r in one slab, 32 wide
        # or a multiple of 32, read as O segments of tr consecutive floats
        tr = _TILE_FLOATS // o
        tr = (tr // 32) * 32 if tr >= 32 else max(tr, 1)
        ta, tr = 1, min(tr, r)
    else:
        # short slabs (Dense, Embedding, ConvT): whole slabs, contiguous
        ta, tr = min(max(_TILE_FLOATS // (o * r), 1), a), r
    stride = tr | 1
    small = (_THREADS + ta * tr) * 4                    # red + vrow
    big = (ta * o * stride + 2 * o) * 4                 # tile, sum, u
    cached = small + big <= _MAX_SMEM
    # 16-byte loads: rows of a multiple of 4 floats, or contiguous tiles
    # that start on a multiple of 4
    vec = (ta * o * r) % 4 == 0 if tr == r else (r % 4 == 0 and tr % 4 == 0)
    return {"ta": ta, "tr": tr, "stride": stride,
            "tiles_r": _cdiv(r, tr), "ntiles": _cdiv(a, ta) * _cdiv(r, tr),
            "flags": (_CACHED if cached else 0) | (_VEC_TILE if vec else 0),
            "smem": small + big if cached else small}


class GroupPlan(NamedTuple):
    """Where a group of weights goes: the kernels' table rows (``rows``,
    PLAN_FIELDS each, largest weight first; ``order[k]`` is the caller's
    index of row k) and, in the caller's order, each weight's shape,
    contiguous strides, (A, O, R) and offsets in the flat W̄ and stats
    buffers; the buffers' sizes and the passes' work-list lengths."""
    rows: array.array
    order: tuple
    shapes: tuple
    strides: tuple
    views: tuple
    flat_offs: tuple
    stat_offs: tuple
    flat: int
    stats: int
    scratch: int
    dots: int
    rows_items: int
    col_blocks: int
    chunks: int
    max_iter: int
    smem: int


@functools.lru_cache(maxsize=128)
def _plan(key: tuple) -> GroupPlan:
    """The plan of ``key``: ((shape, out_dim, n_iter), ...)."""
    shapes = tuple(shape for shape, _, _ in key)
    views = tuple(sn_view(shape, d) for shape, d, _ in key)
    sizes = [a * o * r for a, o, r in views]
    if any(size >= 2 ** 31 for size in sizes):
        raise ValueError("K7 takes weights of fewer than 2^31 elements")
    total = sum(sizes)
    target = min(max(total // _ROWS_ITEMS, _TILE_FLOATS), 8 * _TILE_FLOATS)
    # the finish pass's items and the backward's: chunks of W
    chunk = _cdiv(max(_MIN_CHUNK, total // _CHUNK_ITEMS), 1024) * 1024
    fields, flat_offs, stat_offs = [], [], []
    flat = stats = scratch = dots = 0
    for (shape, _, n_iter), (a, o, r), size in zip(key, views, sizes):
        f = a * r
        t = _tiles(a, o, r)
        per_item = max(1, round(target / (t["ta"] * t["tr"] * o)))
        items = _cdiv(t["ntiles"], per_item)
        fields.append({**t, "A": a, "O": o, "R": r, "per_item": per_item,
                       "items": items, "chunk": chunk,
                       "chunks": _cdiv(size, chunk), "n_iter": n_iter,
                       "flat_off": flat, "stat_off": stats,
                       "scratch_off": scratch, "dot_off": dots})
        flat_offs.append(flat)
        stat_offs.append(stats)
        flat += _cdiv(size, _PAD) * _PAD
        stats += o + f + 1                              # u_new, v, sigma
        # v_raw, u2_raw, the rows items' partials, the colsum blocks' sums
        # of u2^2, |v_raw| + eps
        scratch += f + o + items * o + _cdiv(o, 32) + 1
        dots += fields[-1]["chunks"]
    # the work lists: the largest weight's items first, so the small ones
    # fill the SMs the large ones leave
    order = tuple(sorted(range(len(key)), key=lambda i: -sizes[i]))
    starts = dict.fromkeys(("item0", "col0", "chunk0"), 0)
    rows = array.array("q")
    for i in order:
        row = fields[i]
        for start, count in (("item0", row["items"]),
                             ("col0", _cdiv(row["O"], 32)),
                             ("chunk0", row["chunks"])):
            row[start] = starts[start]
            starts[start] += count
        rows.extend(row[name] for name in PLAN_FIELDS)
    strides = tuple(tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))
                    for shape in shapes)
    return GroupPlan(rows, order, shapes, strides, views, tuple(flat_offs),
                     tuple(stat_offs), flat, stats, scratch, dots,
                     starts["item0"], starts["col0"], starts["chunk0"],
                     max(n for _, _, n in key),
                     max(row["smem"] for row in fields))


def group_plan(ws, n_iters, out_dims) -> GroupPlan:
    """The (cached) plan of weights of ``ws``' shapes."""
    return _plan(tuple((tuple(w.shape), d, n)
                       for w, d, n in zip(ws, out_dims, n_iters)))


def split_stats(stats: torch.Tensor, plan: GroupPlan) -> list:
    """[(u_new [O], v [F], sigma []) of each weight] in ``stats``."""
    out = []
    for (a, o, r), off in zip(plan.views, plan.stat_offs):
        f = a * r
        out.append((stats[off:off + o], stats[off + o:off + o + f],
                    stats[off + o + f]))
    return out


def spectral_norm_reference(w: torch.Tensor, u: torch.Tensor, n_iter: int,
                            eps: float, out_dim: int):
    """The plain version of one weight: ``_sn_kernel``'s body in torch,
    fp32 multiply-and-reduce in its order.  Returns (w_bar, u_new, v [F],
    sigma [])."""
    a, o, r = sn_view(w.shape, out_dim)
    w3 = w.float().reshape(a, o, r)
    u = u.float()
    for _ in range(n_iter):
        v = (w3 * u.view(1, o, 1)).sum(dim=1)              # [A, R]
        v = v / (torch.linalg.vector_norm(v) + eps)
        u2 = (w3 * v.view(a, 1, r)).sum(dim=(0, 2))        # [O]
        u = u2 / (torch.linalg.vector_norm(u2) + eps)
    sigma = (u2 * u).sum()
    return (w3 / (sigma + eps)).reshape(w.shape), u, v.reshape(-1), sigma


def sn_bwd_reference(g: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor, sigma: torch.Tensor, eps: float,
                     out_dim: int) -> torch.Tensor:
    """The plain backward of one weight, ``_sn_bwd``: dW = g/s − (⟨g,
    W⟩/s²)·v uᵀ with s = sigma + eps, in w's layout, fp32."""
    a, o, r = sn_view(w.shape, out_dim)
    g = g.float()
    s = sigma + eps
    inner = (g * w).sum()
    outer = (v.view(a, 1, r) * u.view(1, o, 1)).reshape(w.shape)
    return g / s - (inner / (s * s)) * outer


def _check(tensors) -> torch.device:
    """The one CUDA device of ``tensors``, all fp32 and contiguous."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device or device.type != "cuda":
            raise ValueError(f"the spectral_norm kernels need every w and u "
                             f"on one CUDA device, got {t.device} beside "
                             f"{device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the spectral_norm kernels take float32 w and "
                            f"u, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the spectral_norm kernels need contiguous w "
                             "and u")
    return device


def _launched(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def sn_group_forward(ws, us, n_iters, out_dims, eps: float = 1e-12,
                     dtype: torch.dtype = torch.float32, store=None,
                     design: int | None = None):
    """K7 over the weights ``ws`` (fp32, output channels on ``out_dims``)
    from their SN vectors ``us``, ``n_iters`` power iterations each: one
    grouped call.  Returns (w_bars in ws' shapes and ``dtype``, views of
    one flat buffer; the flat fp32 ``stats``, see :func:`split_stats`).
    Where ``store[i]``, u_new is written into ``us[i]`` too.  ``design``
    (default ``DESIGN``) picks the kernels' launch design."""
    global LAUNCHES, WEIGHTS
    n = len(ws)
    store = tuple(store) if store is not None else (False,) * n
    if not 0 < n <= MAX_WEIGHTS:
        raise ValueError(f"K7 takes 1 to {MAX_WEIGHTS} weights a call, "
                         f"got {n}")
    if min(n_iters) < 1:
        raise ValueError(f"spectral_norm needs n_iter >= 1, got {n_iters}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K7 writes W_bar in float32 or bfloat16, not "
                        f"{dtype}")
    plan = group_plan(ws, n_iters, out_dims)
    device = ws[0].device
    flat = torch.empty(plan.flat, dtype=dtype, device=device)
    stats = torch.empty(plan.stats, dtype=torch.float32, device=device)
    if all(w.device.type == "cpu" and u.device.type == "cpu"
           for w, u in zip(ws, us)):
        with torch.no_grad():
            parts = split_stats(stats, plan)
            for i, (w, u) in enumerate(zip(ws, us)):
                w_bar, u_new, v, sigma = spectral_norm_reference(
                    w, u, n_iters[i], eps, out_dims[i])
                off = plan.flat_offs[i]
                flat[off:off + w.numel()].copy_(w_bar.reshape(-1))
                u_st, v_st, sigma_st = parts[i]
                u_st.copy_(u_new)
                v_st.copy_(v)
                sigma_st.copy_(sigma)
                if store[i]:
                    u.copy_(u_new)
    else:
        device = _check([*ws, *us])
        lib = _lib()
        scratch = torch.empty(plan.scratch, dtype=torch.float32,
                              device=device)
        ptrs = array.array("q")
        for i in plan.order:
            ptrs.extend((ws[i].data_ptr(), us[i].data_ptr(),
                         us[i].data_ptr() if store[i] else 0))
        with torch.cuda.device(device):
            _launched(lib.sagan_sn_group_forward(
                plan.rows.buffer_info()[0], n, ptrs.buffer_info()[0],
                flat.data_ptr(), int(dtype == torch.bfloat16),
                stats.data_ptr(), scratch.data_ptr(), plan.rows_items,
                plan.col_blocks, plan.chunks, plan.max_iter, plan.smem,
                eps, DESIGN if design is None else design,
                torch.cuda.current_stream().cuda_stream),
                "sagan_sn_group_forward")
        LAUNCHES += 1
        WEIGHTS += n
    w_bars = [flat.as_strided(shape, stride, off) for shape, stride, off
              in zip(plan.shapes, plan.strides, plan.flat_offs)]
    return w_bars, stats


def sn_group_backward(gs, ws, stats, n_iters, out_dims,
                      eps: float = 1e-12) -> list:
    """The closed-form backward of :func:`sn_group_forward`: dW (fp32, in
    ws' shapes) of every weight whose gradient ``gs[i]`` (in W̄'s dtype)
    is not None, from the forward's ``stats``; None for the rest.  One
    grouped call of two launches on the card."""
    global BWD_LAUNCHES
    plan = group_plan(ws, n_iters, out_dims)
    live = [i for i, g in enumerate(gs) if g is not None]
    if not live:
        return [None] * len(ws)
    if all(gs[i].device.type == "cpu" for i in live):
        parts = split_stats(stats, plan)
        return [None if g is None else
                sn_bwd_reference(g, w, *parts[i], eps, out_dims[i])
                for i, (g, w) in enumerate(zip(gs, ws))]
    device = _check([*ws, stats])
    g_dtype = gs[live[0]].dtype
    if g_dtype not in (torch.float32, torch.bfloat16) or any(
            gs[i].dtype != g_dtype or gs[i].device != device for i in live):
        raise TypeError(f"the spectral_norm backward takes float32 or "
                        f"bfloat16 gradients of one dtype on {device}, got "
                        f"{[(gs[i].dtype, gs[i].device) for i in live]}")
    gs = [None if g is None else g.contiguous() for g in gs]
    lib = _lib()
    dw = torch.empty(plan.flat, dtype=torch.float32, device=device)
    dots = torch.empty(plan.dots, dtype=torch.float32, device=device)
    ptrs = array.array("q")
    for i in plan.order:
        ptrs.extend((0 if gs[i] is None else gs[i].data_ptr(),
                     ws[i].data_ptr()))
    with torch.cuda.device(device):
        _launched(lib.sagan_sn_group_backward(
            plan.rows.buffer_info()[0], len(ws), ptrs.buffer_info()[0],
            int(g_dtype == torch.bfloat16), dw.data_ptr(), stats.data_ptr(),
            dots.data_ptr(), eps, torch.cuda.current_stream().cuda_stream),
            "sagan_sn_group_backward")
    BWD_LAUNCHES += 1
    return [None if g is None else dw.as_strided(shape, stride, off)
            for g, shape, stride, off
            in zip(gs, plan.shapes, plan.strides, plan.flat_offs)]


class SpectralNormGroup(torch.autograd.Function):
    """(*w_bars, stats) = K7 of the weights ``ws`` (``spec``: their u's,
    n_iters, out_dims, eps, W̄'s dtype, which u's to store), forward
    :func:`sn_group_forward`; backward :func:`sn_group_backward` for the
    W̄'s that took a gradient, none to u."""

    @staticmethod
    def forward(ctx, spec, *ws):
        us, n_iters, out_dims, eps, dtype, store = spec
        ctx.set_materialize_grads(False)
        w_bars, stats = sn_group_forward(ws, us, n_iters, out_dims, eps,
                                         dtype, store)
        ctx.save_for_backward(*ws, stats)
        ctx.spec = (n_iters, out_dims, eps)
        ctx.mark_non_differentiable(stats)
        return (*w_bars, stats)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        *ws, stats = ctx.saved_tensors
        n_iters, out_dims, eps = ctx.spec
        gs = [g if need else None
              for g, need in zip(grads[:-1], ctx.needs_input_grad[1:])]
        return (None, *sn_group_backward(gs, ws, stats, n_iters, out_dims,
                                         eps))


def spectral_norm_group(ws, us, n_iters, out_dims, eps: float = 1e-12,
                        dtypes=None, store=None) -> list:
    """W̄ of every weight (``dtypes[i]``, fp32 by default), through
    :class:`SpectralNormGroup`: one grouped call for each dtype and each
    run of ``MAX_WEIGHTS`` weights.  Where ``store[i]``, ``us[i]`` takes
    u_new."""
    n = len(ws)
    dtypes = dtypes or (torch.float32,) * n
    store = store or (False,) * n
    parts = {}
    for i, dtype in enumerate(dtypes):
        parts.setdefault(dtype, []).append(i)
    out = [None] * n
    for dtype, idx in parts.items():
        for k in range(0, len(idx), MAX_WEIGHTS):
            sub = idx[k:k + MAX_WEIGHTS]
            spec = (tuple(us[i] for i in sub), tuple(n_iters[i] for i in sub),
                    tuple(out_dims[i] for i in sub), eps, dtype,
                    tuple(store[i] for i in sub))
            *w_bars, _ = SpectralNormGroup.apply(spec, *(ws[i] for i in sub))
            for i, w_bar in zip(sub, w_bars):
                out[i] = w_bar
    return out


def spectral_norm_fused(w: torch.Tensor, u: torch.Tensor, n_iter: int = 1,
                        eps: float = 1e-12, out_dim: int = -1):
    """(w_bar, u_new, v, sigma) of ``n_iter`` power iterations from ``u``
    on the fp32 weight ``w`` (output channels on ``out_dim``), a group of
    one: w_bar in w's shape, u_new [O], v [F] in the fan-in order f = a·R
    + r, sigma []."""
    if n_iter < 1:
        raise ValueError(f"spectral_norm needs n_iter >= 1, got {n_iter}")
    (w_bar,), stats = sn_group_forward([w], [u], [n_iter], [out_dim], eps)
    plan = group_plan([w], [n_iter], [out_dim])
    return (w_bar, *split_stats(stats, plan)[0])
