"""The attention study kernels' plain versions
(``sagan_tpu_torch/ops/attention_study.py``) against the JAX package's TPU
study bodies (``tools/bench_attn_floor.py``, ``tools/bench_attn_floor256.py``)
run in interpret-mode ``pallas_call``s, on the same numpy inputs at a tiny
shape (B = 2, N = 64, M = 48, d = 2, c = 8, Cin = 16; the folded forward at
one more); the tile-define plumbing of the shipped kernels' libraries; S1's
tensor-core variants as builds of the shipped K1/K3 library and the entry
each launches (the card's checks and launch stubbed out); and the four
studies' wiring on the CPU.

Tolerances, as a share of max|JAX|: fp32 1e-5 (the same function, summed
in another order; the JAX flash bodies rescale per key block); bf16 8e-3,
about two bf16 ulps (both round o to bf16, and the port's fma engine keeps
P in fp32 where a JAX body rounds it to bf16, as its noexp keeps e = s − max
in fp32)."""

import functools

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
    result = study.main(["--device", "cpu", "--tiny"])
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
