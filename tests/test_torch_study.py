"""The attention study kernels' plain versions
(``sagan_tpu_torch/ops/attention_study.py``) against the JAX package's TPU
study bodies (``tools/bench_attn_floor.py``, ``tools/bench_attn_floor256.py``)
run in interpret-mode ``pallas_call``s, on the same numpy inputs at a tiny
shape (B = 2, N = 64, M = 48, d = 2, c = 8, Cin = 16; the folded forward at
one more); the tile-define plumbing of the shipped kernels' libraries; S1's
tensor-core variants as builds of the shipped K1/K3 library and the entry
each launches (the card's checks and launch stubbed out); K6's (query
tile, key block) points as builds of the shipped K6 whose scratch its own
library sizes (stubbed too), and the plain backward they are held to
against ``_flash_bwd_fused`` (``tools/bench_attn_bwd256.py``'s fused
sweep) at each (BN, BM) of that sweep; the four studies' wiring on the
CPU; and the SASS counter of ``tools/sass_mix.py``.

Tolerances, as a share of max|JAX|: fp32 1e-5 (the same function, summed
in another order; the JAX flash bodies rescale per key block); bf16 8e-3,
about two bf16 ulps (both round o to bf16, and the port's fma engine keeps
P in fp32 where a JAX body rounds it to bf16, as its noexp keeps e = s − max
in fp32)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sagan_tpu_torch.ops import _build
from sagan_tpu_torch.ops import attention as attention_ops
from sagan_tpu_torch.ops import cuda_attention, cuda_attention_study
from sagan_tpu_torch.ops.attention import attention_flash_bwd_reference
from sagan_tpu_torch.ops.attention_study import (VARIANTS, folded_reference,
                                                 study_attention_reference)
from sagan_tpu_torch.tools import (_study, bench_attn_bwd256, bench_attn_floor,
                                   bench_attn_floor256, bench_attn_floor512)
from tools import bench_attn_floor as t1
from tools.bench_attn_floor256 import _floor_kernel, _folded_kernel

B, N, M, D, C, CIN = 2, 64, 48, 2, 8, 16
BN, BM = 32, 16  # the interpret-mode blocks: query rows, keys (flash)
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
VMEM = pltpu.VMEM
_TINY = {}  # each study's --tiny result, kept for the later tests of it


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _share(got: torch.Tensor, want) -> float:
    want = np.asarray(want.astype(jnp.float32))
    return np.abs(got.float().numpy() - want).max() / np.abs(want).max()


def _t1_call(body, dtype):
    """T1's ``_call`` at the tiny shape: a block of BN query rows against
    all M keys."""
    spec = functools.partial(pl.BlockSpec, memory_space=VMEM)
    return pl.pallas_call(
        body, grid=(B, N // BN),
        in_specs=[spec((1, BN, D), lambda i, j: (i, j, 0)),
                  spec((1, M, D), lambda i, j: (i, 0, 0)),
                  spec((1, M, C), lambda i, j: (i, 0, 0))],
        out_specs=spec((1, BN, C), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((B, N, C), getattr(jnp, dtype)),
        interpret=True)


def _flash_call(body, dtype, cin=None, shape=(B, N, M)):
    """T3's flash wiring (``bench_floors`` :169, ``bench_folded`` :246) at
    ``shape`` (B, N, M), by default the tiny one: q (or x) blocks of BN
    rows, k (or xb) and v blocks of BM keys, the running (acc, max, sum) in
    scratch."""
    B, N, M = shape
    spec = functools.partial(pl.BlockSpec, memory_space=VMEM)
    if cin is None:
        ins = [spec((1, BN, D), lambda i, j, kk: (i, j, 0)),
               spec((1, BM, D), lambda i, j, kk: (i, kk, 0)),
               spec((1, BM, C), lambda i, j, kk: (i, kk, 0))]
    else:
        ins = [spec((1, BN, cin), lambda i, j, kk: (i, j, 0)),
               spec((1, BM, cin), lambda i, j, kk: (i, kk, 0)),
               spec((cin, cin), lambda i, j, kk: (0, 0)),
               spec((cin, C), lambda i, j, kk: (0, 0))]
    return pl.pallas_call(
        body, grid=(B, N // BN, M // BM), in_specs=ins,
        out_specs=spec((1, BN, C), lambda i, j, kk: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((B, N, C), getattr(jnp, dtype)),
        scratch_shapes=[VMEM((1, BN, C), jnp.float32),
                        VMEM((1, BN, 1), jnp.float32),
                        VMEM((1, BN, 1), jnp.float32)],
        interpret=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_study_variant_matches_its_jax_body(variant, dtype):
    """Each variant against the T1 body whose math it has (``VARIANTS``),
    on both engines."""
    arrays = _arrays((B, N, D), (B, M, D), (B, M, C))
    body = getattr(t1, VARIANTS[variant][2])
    want = _t1_call(body, dtype)(*_jax(arrays, dtype))
    got = study_attention_reference(*_port(arrays, dtype), variant)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, N, C)
    assert _share(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["fma_nomax", "mma_nomax"])
def test_nomax_matches_the_jax_flash_nomaxcorr_floor(variant, dtype):
    """T3/T5's ``nomaxcorr`` floor: its max stays -inf and its correction
    1, so it is T1's ``k_nomax`` over key blocks."""
    arrays = _arrays((B, N, D), (B, M, D), (B, M, C), seed=1)
    body = functools.partial(_floor_kernel, nk=M // BM, mode="nomaxcorr")
    want = _flash_call(body, dtype)(*_jax(arrays, dtype))
    got = study_attention_reference(*_port(arrays, dtype), variant)
    assert _share(got, want) <= TOL[dtype]


def test_jax_flash_noexp_floor_is_nan():
    """The JAX flash ``noexp`` floor is NaN everywhere: its running max
    starts at -inf, so the first key block's correction mi - m_new + 1 is
    -inf and li * corr is 0 * -inf.  The TPU study timed it and never read
    it; the port's flash noexp floor takes T1's finite math instead."""
    arrays = _arrays((B, N, D), (B, M, D), (B, M, C), seed=2)
    body = functools.partial(_floor_kernel, nk=M // BM, mode="noexp")
    out = np.asarray(_flash_call(body, "float32")(*_jax(arrays, "float32")))
    assert np.isnan(out).all()
    got = study_attention_reference(*_port(arrays, "float32"), "fma_noexp")
    assert torch.isfinite(got).all()


def test_noexp_linear_sums_give_the_plain_noexp():
    """The kernels' noexp: e = s - M is linear in s, so o = (Σ s v -
    M Σ v) / (Σ s - M count) from one pass of sums equals T1's e = s -
    rowmax."""
    q, k, v = _port(_arrays((B, N, D), (B, M, D), (B, M, C), seed=3),
                    "float32")
    s = q.double() @ k.double().transpose(1, 2)
    mx = s.amax(-1, keepdim=True)
    linear = ((s @ v.double() - mx * v.double().sum(1, keepdim=True))
              / (s.sum(-1, keepdim=True) - mx * M))
    want = study_attention_reference(q, k, v, "fma_noexp")
    assert (linear.float() - want).abs().max() <= 1e-5 * want.abs().max()


def _folded_case(form, dtype, shape=(B, N, M)):
    """``folded_reference`` against T2's ``k_folded`` (v given) or T3's
    ``_folded_kernel`` (V = xb Wg) at ``shape`` (B, N, M): max|Δ| as a
    share of max|JAX|."""
    B, N, M = shape
    x, xb, wt, wp, v, wg = _arrays((B, N, CIN), (B, M, CIN), (CIN, D),
                                   (CIN, D), (B, M, C), (CIN, C), seed=4)
    w = (wt / 4) @ (wp / 4).T
    wg = wg / 4
    if form == "v":
        spec = functools.partial(pl.BlockSpec, memory_space=VMEM)
        call = pl.pallas_call(
            t1.k_folded, grid=(B, N // BN),
            in_specs=[spec((1, BN, CIN), lambda i, j: (i, j, 0)),
                      spec((1, M, CIN), lambda i, j: (i, 0, 0)),
                      spec((CIN, CIN), lambda i, j: (0, 0)),
                      spec((1, M, C), lambda i, j: (i, 0, 0))],
            out_specs=spec((1, BN, C), lambda i, j: (i, j, 0)),
            out_shape=jax.ShapeDtypeStruct((B, N, C), getattr(jnp, dtype)),
            interpret=True)
        want = call(*_jax([x, xb, w, v], dtype))
        tx, txb, tw, tv = _port([x, xb, w, v], dtype)
        got = folded_reference(tx, txb, tw, v=tv)
    else:
        body = functools.partial(_folded_kernel, nk=M // BM)
        want = _flash_call(body, dtype, cin=CIN, shape=shape)(
            *_jax([x, xb, w, wg], dtype))
        tx, txb, tw, twg = _port([x, xb, w, wg], dtype)
        got = folded_reference(tx, txb, tw, wg=twg)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, N, C)
    return _share(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["v", "wg"])
def test_folded_matches_its_jax_body(form, dtype):
    """v given: T2's ``k_folded``; V = xb Wg: T3's ``_folded_kernel``."""
    assert _folded_case(form, dtype) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["v", "wg"])
def test_folded_matches_its_jax_body_at_another_shape(form, dtype):
    """The same at B = 1, N = 96, M = 80 (three query blocks, five key
    blocks): the oracle that the bf16 tensor-core S2 is held to on the
    card."""
    assert _folded_case(form, dtype, (1, 96, 80)) <= TOL[dtype]


def test_study_wrappers_take_the_plain_versions_on_the_cpu():
    q, k, v = _port(_arrays((B, N, D), (B, M, D), (B, M, C), seed=5),
                    "bfloat16")
    x, xb, w, wg = _port(_arrays((B, N, CIN), (B, M, CIN), (CIN, CIN),
                                 (CIN, C), seed=6), "bfloat16")
    before = (cuda_attention_study.STUDY_LAUNCHES,
              cuda_attention_study.FOLDED_LAUNCHES)
    for variant in VARIANTS:
        assert torch.equal(
            cuda_attention_study.attention_study(q, k, v, variant),
            study_attention_reference(q, k, v, variant))
    assert torch.equal(cuda_attention_study.attention_folded(x, xb, w, wg=wg),
                       folded_reference(x, xb, w, wg=wg))
    assert before == (cuda_attention_study.STUDY_LAUNCHES,
                      cuda_attention_study.FOLDED_LAUNCHES)
    with pytest.raises(ValueError):
        cuda_attention_study.attention_study(q, k, v, "nope")
    with pytest.raises(ValueError):
        cuda_attention_study.attention_folded(x, xb, w)


def test_tile_defines_build_their_own_libraries():
    """Each tile point has its own library (a distinct path), the shipped
    point is the model's library, and the default specs keep their form."""
    assert cuda_attention.build_specs((8,), ("attention_fwd",)) == [
        ("attention_fwd", ("-DSAGAN_ATTN_C=8",))]
    fwd = [cuda_attention_study.fwd_tiles(p)
           for p in cuda_attention_study.FWD_POINTS]
    bwd = [cuda_attention_study.bwd_tiles(p)
           for p in cuda_attention_study.BWD_POINTS]
    assert fwd[0] == () and bwd[0] == ()
    for source, tiles in (("attention_fwd", fwd),
                          ("attention_flash_bwd", bwd)):
        paths = {_build.library_path(source, ("-DSAGAN_ATTN_C=8", *t))
                 for t in tiles}
        assert len(paths) == len(tiles)
    specs = cuda_attention_study.build_specs()
    assert len(set(specs)) == len(specs)
    assert ("attention_fwd", ("-DSAGAN_ATTN_C=8",)) in specs
    assert ("attention_flash_bwd", ("-DSAGAN_ATTN_C=8", *bwd[1])) in specs
    assert ("attention_study", fwd[2]) in specs
    assert ("attention_folded", ()) in specs


MMA_VARIANTS = [name for name, (engine, _, _) in VARIANTS.items()
                if engine == "mma"]
# chip_smoke's STUDY_SITES: (B, N, M) of the 64 map, a 4,096-row chunk of
# the 256 and 512 maps, and the ragged shape
STUDY_SITES = {"64 map": (64, 4096, 1024), "256 map chunk": (1, 4096, 16384),
               "512 map chunk": (1, 4096, 65536), "ragged": (3, 100, 37)}


@pytest.mark.parametrize("variant", MMA_VARIANTS)
def test_each_mma_variant_is_one_build_of_the_shipped_k1_k3_library(variant):
    """``build_specs()`` holds one ``attention_flash_mma`` library for each
    tensor-core variant, built with that variant's defines (mma_exp2's
    none: the shipped library itself), each a library of its own, and S1
    has no tensor-core kernel of its own."""
    cas = cuda_attention_study
    defines = cas.MMA_VARIANT_DEFINES[variant]
    spec = ("attention_flash_mma", ("-DSAGAN_ATTN_C=8", *defines))
    assert spec in cas.build_specs()
    assert (defines == ()) == (variant == "mma_exp2")
    paths = {_build.library_path(*cuda_attention.build_specs(
        (8,), ("attention_flash_mma",), cas.MMA_VARIANT_DEFINES[name])[0])
        for name in MMA_VARIANTS}
    assert len(paths) == len(MMA_VARIANTS)
    source = (_build.CSRC / "attention_study.cu").read_text()
    assert "mma.sync" not in source and "mma_bf16" not in source
    assert all(name == "attention_study" or "study" not in name
               for name, _ in cas.build_specs())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_each_variant_maps_to_the_fma_engine_or_its_define_set(variant):
    """``fma`` variants run ``csrc/attention_study.cu``; each ``mma``
    variant is the build whose defines switch the shipped body to its math
    (``-DSAGAN_MMA_MATH=<math>``, none for exp2) and, for T1's
    ``k_vpu_scores``, its scores to fmaf."""
    engine, math, body = VARIANTS[variant]
    got_engine, defines = cuda_attention_study.variant_build(variant)
    assert got_engine == engine
    if engine == "fma":
        assert defines == ()
        return
    assert defines in cuda_attention_study.MMA_VARIANT_DEFINES.values()
    want = () if math == "exp2" else (f"-DSAGAN_MMA_MATH={math}",)
    if body == "k_vpu_scores":
        want += ("-DSAGAN_MMA_FMA_SCORES=1",)
    assert defines == want


@pytest.mark.parametrize("variant", MMA_VARIANTS)
@pytest.mark.parametrize("site", list(STUDY_SITES))
def test_mma_variant_launches_k1_or_k3_by_single_pass(site, variant,
                                                      monkeypatch):
    """On the card (its checks and launch stubbed out: CPU tensors stand
    in for CUDA ones) a tensor-core variant launches K1's entry where
    ``single_pass`` takes the shape and K3's otherwise (with an fp32 lse it
    discards), from its own build, once, counted as a study launch and not
    as K1's or K3's; fp32 and tile defines raise."""
    b, _, m = STUDY_SITES[site]
    n = 8  # the entry depends on M alone
    q, k, v = (torch.zeros(s, dtype=torch.bfloat16)
               for s in ((b, n, D), (b, m, D), (b, m, C)))
    calls = []
    monkeypatch.setattr(cuda_attention, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(cuda_attention, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(cuda_attention, "_check_mma_alignment",
                        lambda *t: None)
    monkeypatch.setattr(cuda_attention, "_launch",
                        lambda name, ts, q, c, tiles=(): calls.append(
                            (name, ts, c, tiles)))
    counts = (cuda_attention.FWD_MMA_LAUNCHES,
              cuda_attention.FLASH_FWD_MMA_LAUNCHES)
    before = cuda_attention_study.STUDY_LAUNCHES
    out = cuda_attention_study.attention_study(q, k, v, variant)
    assert out.shape == (b, n, C) and out.dtype == torch.bfloat16
    (name, tensors, c, tiles), = calls
    k1 = attention_ops.single_pass(m, D, C)
    assert k1 == (m <= 1024)  # the 64 map and the ragged site take K1
    assert name == ("sagan_attention_fwd_mma" if k1
                    else "sagan_attention_flash_fwd_mma")
    assert name == cuda_attention_study.mma_entry(m)
    assert tensors[:4] == (q, k, v, out) and c == C
    assert len(tensors) == (4 if k1 else 5)
    if not k1:
        assert tensors[4].shape == (b, n, 1)
        assert tensors[4].dtype == torch.float32
    assert tiles == cuda_attention_study.MMA_VARIANT_DEFINES[variant]
    assert cuda_attention_study.STUDY_LAUNCHES == before + 1
    assert counts == (cuda_attention.FWD_MMA_LAUNCHES,
                      cuda_attention.FLASH_FWD_MMA_LAUNCHES)
    with pytest.raises(TypeError, match="bf16"):
        cuda_attention_study.attention_study(q.float(), k.float(), v.float(),
                                             variant)
    with pytest.raises(ValueError, match="tile defines"):
        cuda_attention_study.attention_study(q, k, v, variant, ("-DX=1",))
    assert len(calls) == 1


@pytest.mark.parametrize("study", [bench_attn_floor, bench_attn_floor256,
                                   bench_attn_bwd256, bench_attn_floor512],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_study_runs_tiny_on_the_cpu(study, capsys):
    result = _TINY[study] = study.main(["--device", "cpu", "--tiny"])
    assert set(result["sections"]) >= set(study.SECTIONS)
    assert result["device"] == "cpu" and result["shape"] == [B, N, M, D, C]
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "cpu: nothing measured"
    assert out[-1].startswith('{"study": ')
    rows = [row for rows in result["sections"].values()
            for row in rows.values()]
    assert all(row.get("ok", True) for row in rows)
    assert all(row.get("ms") is None for row in rows)
    held = [row for section, rows in result["sections"].items()
            for key, row in rows.items()
            if (section in study.HELD or f"{section}/{key}" in study.HELD)
            and key != "best"]
    assert held and all("max_abs_err" in row for row in held)


def test_study_needs_a_card_or_tiny():
    with pytest.raises(ValueError, match="--tiny"):
        bench_attn_floor.main(["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_attn_floor.main([])


@pytest.mark.parametrize("batch, row, caught", [
    (0, 0, True), (0, 2047, True), (1, 4095, True), (1, 4032, True),
    (0, 2048, False), (1, 4031, False)])
def test_held_checks_the_check_rows(batch, row, caught):
    """A study's ``held`` compares the first 2,048 query rows of batch 0
    and the last 64 of the last batch element with the plain version: an
    error on one of those rows fails the row, one elsewhere does not."""
    q, k, v = _port(_arrays((2, 4096, D), (2, M, D), (2, M, C), seed=7),
                    "float32")
    got = study_attention_reference(q, k, v, "fma")
    got[batch, row] += 1.0
    row_ = _study.held_variant(got, q, k, v, "fma")
    assert row_["ok"] is not caught
    assert (row_["max_abs_err"] > row_["limit"]) is caught


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_padded_is_attention_on_the_cpu(dtype):
    """The library call beside the kernels: q and k zero-padded to 8 wide
    give the same logits, so the same attention, forward and backward."""
    q, k, v, g = _port(_arrays((B, N, D), (B, M, D), (B, M, C), (B, N, C),
                               seed=8), dtype)
    want = study_attention_reference(q, k, v, "fma")
    assert _study.max_delta(_study.sdpa_padded(q, k, v), want,
                            TOL[dtype])["ok"]
    dq, dk, dv = _study.sdpa_padded(q, k, v, g)()
    assert dq.shape == (B, 1, N, _study.SDPA_WIDTH)
    assert dv.shape == (B, 1, M, C)
    assert not dq[..., D:].any() and not dk[..., D:].any()
    qr, kr, vr = (t.float().requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(torch.softmax(qr @ kr.transpose(1, 2), -1) @ vr,
                              (qr, kr, vr), g.float())
    for got, r in zip((dq[:, 0, :, :D], dk[:, 0, :, :D], dv[:, 0]), ref):
        assert _study.max_delta(got, r, 2 * TOL[dtype])["ok"]


# -- the tensor-core K6's (query tile, key block) points (k6_mma) -----------

K6_POINTS = list(cuda_attention_study.K6_MMA_POINTS)
# each K6 define's default: the shipped K6 (attention_flash_mma.cu) at
# d = 2
K6_DEFAULTS = {"SAGAN_K6_Q_TILE": 64, "SAGAN_K6_WARPS": 16,
               "SAGAN_K6_KEY_TILES": 8, "SAGAN_K6_STAGES": 3}


def _k6_build(tiles: tuple) -> dict:
    """The K6 define values of a point's build: the defaults, with the
    point's own defines in their place."""
    values = dict(K6_DEFAULTS)
    for flag in tiles:
        name, value = flag.removeprefix("-D").split("=")
        values[name] = int(value)
    return values


@pytest.mark.parametrize("point", K6_POINTS, ids="x".join)
def test_each_k6_point_is_one_define_set_and_its_own_library(point):
    """Each point flips one K6 define away from its shipped value (the
    shipped point none: the model's library itself), reaches 512, 1,024,
    2,048 or 4,096 keys a block at d = 2, c = 8, as its label says, and
    builds a library of its own, which ``build_specs()`` holds."""
    cas = cuda_attention_study
    tiles = cas.K6_MMA_DEFINES[point]
    assert (tiles == ()) == (point == ("shipped",)) == (point == K6_POINTS[0])
    assert len(tiles) <= 1 and all(t.startswith("-DSAGAN_K6_") for t in tiles)
    build = _k6_build(tiles)
    assert all(build[name] != K6_DEFAULTS[name] for name in
               (t.removeprefix("-D").split("=")[0] for t in tiles))
    keys = build["SAGAN_K6_WARPS"] * 16 * build["SAGAN_K6_KEY_TILES"]
    assert keys in (512, 1024, 2048, 4096)
    assert point[0] == "shipped" and keys == 2048 \
        or not point[0].startswith("keys_") \
        or point[0].startswith(f"keys_{keys}_")
    assert build["SAGAN_K6_Q_TILE"] in (64, 128)   # 32 spills: left out
    assert build["SAGAN_K6_STAGES"] in (2, 3, 4)
    spec = ("attention_flash_mma", ("-DSAGAN_ATTN_C=8", *tiles))
    assert spec in cas.build_specs()
    paths = {_build.library_path(*cuda_attention.build_specs(
        (8,), ("attention_flash_mma",), cas.K6_MMA_DEFINES[p])[0])
        for p in K6_POINTS}
    assert len(paths) == len(K6_POINTS)


def _function(source: str, name: str) -> str:
    """The text of the C++ function or kernel ``name`` in ``source``, from
    its name in its definition to the brace that closes its body."""
    for match in re.finditer(rf"\b{name}\(", source):
        line = source[source.rfind("\n", 0, match.start()) + 1:
                      match.start()]
        rest = source[match.end():]
        if "//" in line or -1 < rest.find(";") < rest.find("{"):
            continue                      # a comment or a call
        depth = 0
        for i in range(match.end() + rest.find("{"), len(source)):
            depth += {"{": 1, "}": -1}.get(source[i], 0)
            if depth == 0:
                return source[match.start():i + 1]
    raise AssertionError(f"{name}: no definition")


def test_k6_defines_reach_k6_alone_in_the_source():
    """The K6 switches size K6's kernel, its launch, its delta rows and the
    key block its library reports; K2's gradient pass, K5 and the delta
    rows of K2, K4 and K5 take the shipped constants."""
    source = (_build.CSRC / "attention_flash_mma.cu").read_text()
    k6 = ("attention_flash_dqkv_mma_kernel", "launch_bwd", "k6_delta_rows",
           "sagan_attention_flash_mma_keys_per_block",
           "sagan_attention_flash_mma_delta_rows")
    shipped = ("attention_flash_dkv_mma_kernel", "attention_bwd_grads_mma_kernel",
               "launch_dkv", "launch_dq", "launch_k2", "launch_k2_grads",
               "k2_key_tiles", "delta_rows", "sagan_attention_flash_delta_mma",
               "sagan_attention_bwd_mma_key_blocks")
    for name in k6:
        assert "K6" in _function(source, name) or "k6_" in _function(
            source, name), name
    for name in shipped:
        body = _function(source, name)
        assert "kK6" not in body and "k6_" not in body \
            and "K6Smem" not in body, name


@pytest.fixture
def fresh_k6_caches():
    """``keys_per_block`` and ``_delta_rows`` cache what a library
    reported: clear them around a test that stubs the libraries."""
    cuda_attention.keys_per_block.cache_clear()
    cuda_attention._delta_rows.cache_clear()
    yield
    cuda_attention.keys_per_block.cache_clear()
    cuda_attention._delta_rows.cache_clear()


@pytest.mark.parametrize("point", K6_POINTS, ids="x".join)
def test_k6_point_sizes_its_scratch_from_its_own_library(point, monkeypatch,
                                                         fresh_k6_caches):
    """On the card (its checks, libraries and launches stubbed out: CPU
    tensors stand in for CUDA ones) ``attention_flash_dqkv(..., tiles,
    "mma")`` launches K6 from the point's own library, with fp32 dq
    partials of that library's key block and (-lse log2e, delta) scratch
    of its query tile, and the partials' shape says the same; K4 + K5 and
    K2 called beside it carry no define and size their scratch by the
    shipped library.  The shipped point asks no library for its shape."""
    tiles = cuda_attention_study.K6_MMA_DEFINES[point]
    build = _k6_build(tiles)
    keys = build["SAGAN_K6_WARPS"] * 16 * build["SAGAN_K6_KEY_TILES"]
    rows = build["SAGAN_K6_Q_TILE"]
    asked, launched = [], []

    def int_fn(source, name, c, tiles=(), ints=1):
        asked.append((name, tiles))
        got = _k6_build(tiles)
        if name.endswith("keys_per_block"):
            return lambda d: got["SAGAN_K6_WARPS"] * 16 * got[
                "SAGAN_K6_KEY_TILES"]
        assert name.endswith("delta_rows"), name
        return lambda n: -(-n // got["SAGAN_K6_Q_TILE"]) * got[
            "SAGAN_K6_Q_TILE"]

    monkeypatch.setattr(cuda_attention, "_int_fn", int_fn)
    monkeypatch.setattr(cuda_attention, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(cuda_attention, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(cuda_attention, "_check_mma_alignment",
                        lambda *t: None)
    monkeypatch.setattr(cuda_attention, "_launch",
                        lambda name, ts, q, c, tiles=(): launched.append(
                            (name, tuple(tiles), [tuple(t.shape)
                                                  for t in ts])))
    monkeypatch.setattr(cuda_attention, "bwd_mma_key_blocks",
                        lambda *a: 1)
    b, n, m = 2, 100, 2100
    q, k, v, g = (torch.zeros(s, dtype=torch.bfloat16) for s in (
        (b, n, D), (b, m, D), (b, m, C), (b, n, C)))
    o, lse = torch.zeros(b, n, C, dtype=torch.bfloat16), torch.zeros(b, n, 1)
    part = (b, -(-m // keys), n, D)
    assert cuda_attention.dq_partial_shape(b, n, m, D, C, tiles,
                                           "mma") == part
    cuda_attention.attention_flash_dqkv(q, k, v, o, lse, g, tiles, "mma")
    (name, got_tiles, shapes), = launched
    assert name == "sagan_attention_flash_dqkv_mma" and got_tiles == tiles
    assert shapes[8] == part
    assert shapes[9] == (b, -(-n // rows) * rows, 2)
    launched.clear()
    cuda_attention.attention_flash_dq_dkv(q, k, v, o, lse, g, engine="mma")
    cuda_attention.attention_bwd_fused(q, k, v, g, engine="mma")
    assert [(name, t) for name, t, _ in launched] == [
        ("sagan_attention_flash_delta_mma", ()),
        ("sagan_attention_flash_dq_mma", ()),
        ("sagan_attention_flash_dkv_mma", ()),
        ("sagan_attention_bwd_mma", ())]
    # K4 + K5's and K2's scratch: 100 rows padded to the shipped 64
    assert launched[0][2][3] == (b, 128, 2)
    assert launched[3][2][7] == (b, 128, 2)
    assert ("sagan_attention_flash_mma_delta_rows", ()) in asked
    if tiles:
        assert ("sagan_attention_flash_mma_keys_per_block", tiles) in asked
        assert ("sagan_attention_flash_mma_delta_rows", tiles) in asked
    else:
        assert ("sagan_attention_flash_mma_keys_per_block", ()) not in asked


@pytest.mark.parametrize("study", [bench_attn_bwd256, bench_attn_floor512],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_backward_studies_carry_the_tensor_core_sweeps(study):
    """T4 and T5 on the CPU: ``k6_mma`` and ``k45_mma`` sweep the
    tensor-core points that ``--quick`` keeps (the shipped one and the
    next), each row held and carrying its partials' fields (null on the
    CPU); T5 also gives each K6 point's partials at B = 8 and runs the
    ``past_budget`` section there."""
    result = _TINY.get(study) or study.main(["--device", "cpu", "--tiny"])
    sections = result["sections"]
    cas = cuda_attention_study
    for name, points in (("k6_mma", cas.K6_MMA_POINTS),
                         ("k45_mma", cas.K45_MMA_POINTS)):
        keys = ["x".join(p) for p in points[:2]]
        assert list(sections[name]) == [*keys, "best"]
        assert sections[name]["best"]["point"] == list(points[0])
        for key in keys:
            row = sections[name][key]
            assert row["ok"] and len(row["max_abs_err"]) == 3
            assert row["shipped"] is (key == keys[0])
    for key in ("x".join(p) for p in cas.K6_MMA_POINTS[:2]):
        row = sections["k6_mma"][key]
        assert row["partials"] is None and row["partial_mb"] is None
        if study is bench_attn_floor512:
            assert row["partial_mb_b8"] is None
            budget = sections["past_budget"][key]
            assert budget["ok"] and budget["fits_budget"] is None
    if study is bench_attn_floor512:
        assert list(sections["past_budget"])[0] == "k4_k5"


# the TPU study's fused (BN, BM) sweep (tools/bench_attn_bwd256.py
# SWEEP_BN, SWEEP_BM) at a small shape that every point divides
FUSED_SWEEP = [(bn, bm) for bn in (128, 256, 512) for bm in (512, 1024, 2048)]
FUSED_SHAPE = (1, 512, 2048)


@functools.cache
def _fused_inputs():
    """q, k, v, g in bf16 at ``FUSED_SHAPE``, d = 2, c = 8, and JAX's
    flash forward's (o, lse) of them (interpret mode)."""
    from sagan_tpu.ops import pallas_attention as pa
    b, n, m = FUSED_SHAPE
    q, k, v, g = _jax(_arrays((b, n, D), (b, m, D), (b, m, C), (b, n, C),
                              seed=10), "bfloat16")
    o, lse = pa._flash_fwd(q, k, v, 256, 512, 1, interpret=True)
    return q, k, v, g, o, lse


@pytest.mark.parametrize("bn,bm", FUSED_SWEEP)
def test_plain_backward_matches_jax_fused_backward_at_the_study_blocks(bn,
                                                                       bm):
    """The plain backward, which every ``k6_mma`` point is held to (and
    the CUDA-core K4 + K5 the studies hold them against), equals the TPU
    kernel ``_flash_bwd_fused`` in interpret mode at each (BN, BM) of the
    TPU study's fused sweep, on the same (o, lse): bf16 ``TOL``, both
    round dl and p to bf16 before the products."""
    from sagan_tpu.ops import pallas_attention as pa
    q, k, v, g, o, lse = _fused_inputs()
    want = pa._flash_bwd_fused(q, k, v, o, lse, g, bn, bm, interpret=True)
    tq, tk, tv, tg, to = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                          .to(torch.bfloat16) for x in (q, k, v, g, o))
    got = attention_flash_bwd_reference(tq, tk, tv, to,
                                        torch.from_numpy(np.array(lse)), tg)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.bfloat16 and x.shape == w.shape, name
        assert _share(x, w) <= TOL["bfloat16"], (name, _share(x, w))


def test_sass_mix_counts_the_innermost_tensor_core_loop():
    """``tools/sass_mix.py`` on a SASS listing of two nested loops, the
    inner one holding the HMMAs: it finds that loop, its length, the
    length of the loop around it, and its opcodes."""
    from sagan_tpu_torch.tools import sass_mix

    body = ["MOV R1, R2", "HMMA.1688.F32.BF16 R4, R8, R10, R4",
            "MUFU.EX2 R5, R5", "@P0 FFMA R6, R6, R7, R6",
            "BRA 0x20", "S2R R0, SR_TID.X", "BRA 0x10", "EXIT"]
    listing = "Function : _Zkernel\n" + "\n".join(
        f"        /*{16 * (i + 1):04x}*/                   {text} ;"
        for i, text in enumerate(body))
    (name, text), = sass_mix.functions(listing).items()
    assert name == "_Zkernel"
    mix = sass_mix.inner_mix(text)
    assert mix["range"] == ["0x20", "0x50"] and mix["instructions"] == 4
    assert mix["around"] == 7
    assert mix["by_opcode"] == {"HMMA": 1, "MUFU": 1, "FFMA": 1, "BRA": 1}
