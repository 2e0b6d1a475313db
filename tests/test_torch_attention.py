"""Port attention (sagan_tpu_torch/ops) against the JAX package: the plain
forward against JAX ``attention_reference`` and against the Pallas kernel
``attention_fused`` run in interpret mode, and the plain backward against
``jax.vjp`` of both, on the same numpy inputs.

Forward tolerances: fp32 1e-5 (same arithmetic, other summation order);
bf16 2e-2 (outputs of magnitude < 4, where one bf16 ulp is <= 2^-6, and
both sides round the probabilities and the output to bf16).

Backward tolerances, per gradient, as a share of its largest magnitude:
fp32 1e-5 (same arithmetic, other order); bf16 against the Pallas kernel
4e-3, one bf16 ulp (2^-8): the plain backward rounds dL, E and g/l to
bf16 where the TPU kernel does; bf16 against autodiff of
``attention_reference`` 2e-2, which rounds at other places (the
probabilities, not dL)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu.ops.attention import attention_reference as jax_reference
from sagan_tpu.ops.pallas_attention import attention_fused as jax_fused
from sagan_tpu_torch.ops import _build, cuda_attention
from sagan_tpu_torch.ops.attention import (attention, attention_bwd_reference,
                                           attention_reference)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [(2, 8), (2, 16), (4, 8), (4, 16)]
# (d, c) of every church64 site: G's 64 and 32 maps, D's 8 and 4 maps
TRAIN_SHAPES = [(2, 8), (4, 16), (8, 32), (16, 64)]
BWD_TOL = {("float32", "pallas"): 1e-5, ("float32", "reference"): 1e-5,
           ("bfloat16", "pallas"): 4e-3, ("bfloat16", "reference"): 2e-2}


def _inputs(d, c, b=2, n=256, m=64, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n, d).astype(np.float32),
            rs.randn(b, m, d).astype(np.float32),
            rs.randn(b, m, c).astype(np.float32))


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c", SHAPES)
def test_plain_matches_jax_reference(d, c, dtype):
    arrays = _inputs(d, c)
    want = np.asarray(jax_reference(*_jax(arrays, dtype)), np.float32)
    got = attention_reference(*_port(arrays, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c", SHAPES)
def test_plain_matches_pallas_kernel_interpreted(d, c, dtype):
    arrays = _inputs(d, c, seed=1)
    want = np.asarray(jax_fused(*_jax(arrays, dtype), interpret=True),
                      np.float32)
    got = attention(*_port(arrays, dtype))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dtype])


COUNTERS = ("LAUNCHES", "BWD_LAUNCHES", "FWD_MMA_LAUNCHES",
            "BWD_MMA_LAUNCHES")


def _counts():
    return [getattr(cuda_attention, name) for name in COUNTERS]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_tensors_take_the_plain_version_without_a_launch(dtype):
    """Neither engine's counter moves on the CPU: bf16 would take the
    tensor-core K1 and K2 on the card, fp32 the CUDA-core ones."""
    q, k, v = _port(_inputs(2, 8), dtype)
    before = _counts()
    want = attention_reference(q, k, v)
    for out in (attention(q, k, v), attention(q, k, v, use_pallas=True),
                attention(q, k, v, use_pallas=False),
                cuda_attention.attention_fused(q, k, v)):
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    g = torch.ones_like(want)
    for got, ref in zip(cuda_attention.attention_bwd_fused(q, k, v, g),
                        attention_bwd_reference(q, k, v, g)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert _counts() == before


def test_kernel_wrapper_refuses_tensors_off_cpu_and_cuda():
    # neither the plain version nor a silent copy: a device the kernel
    # does not run on raises
    q = torch.empty(1, 4, 2, device="meta")
    k = torch.empty(1, 2, 2, device="meta")
    v = torch.empty(1, 2, 8, device="meta")
    before = cuda_attention.LAUNCHES
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_attention.attention_fused(q, k, v)
    assert cuda_attention.LAUNCHES == before


def test_kernel_builds_one_library_per_value_width():
    specs = cuda_attention.build_specs()
    sources = ("attention_fwd", "attention_bwd", "attention_flash_bwd",
               "attention_flash_mma")
    for source in sources:
        assert [defs for name, defs in specs if name == source] == [
            (f"-DSAGAN_ATTN_C={c}",) for c in cuda_attention.SUPPORTED_C]
    assert len(specs) == len(sources) * len(cuda_attention.SUPPORTED_C)


def test_entry_points_take_their_pointers_from_their_sources():
    """Each C entry point's tensor pointers (ctypes passes each as a
    c_void_p) and its library's source, the tensor-core K1, K2, K3 and K6
    in ``attention_flash_mma.cu``; K6's also takes its delta scratch, K2's
    its delta and dq-partial scratch."""
    entries = cuda_attention._ENTRIES
    assert entries["sagan_attention_fwd_mma"] == ("attention_flash_mma", 4)
    # q k v g dq dk dv, and its delta and dq-partial scratch
    assert entries["sagan_attention_bwd_mma"] == ("attention_flash_mma", 9)
    assert entries["sagan_attention_fwd"] == ("attention_fwd", 4)
    assert entries["sagan_attention_bwd"] == ("attention_bwd", 8)
    assert entries["sagan_attention_flash_fwd_mma"] == (
        "attention_flash_mma", 5)
    assert entries["sagan_attention_flash_dqkv_mma"] == (
        "attention_flash_mma", 10)
    assert entries["sagan_attention_flash_fwd"] == ("attention_fwd", 5)
    assert entries["sagan_attention_flash_dqkv"] == (
        "attention_flash_bwd", 9)
    sources = {src for src, _ in entries.values()}
    assert sources == {"attention_fwd", "attention_bwd",
                       "attention_flash_bwd", "attention_flash_mma"}
    for src in sources:
        assert (_build.CSRC / f"{src}.cu").exists()


def test_a_shared_header_is_in_every_library_hash(tmp_path, monkeypatch):
    """The libraries include ``csrc/mma_bf16.cuh``: an edit of a header
    must build a new library, as an edit of the source does."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("k", ("-DX=1",))
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k", ("-DX=1",)) != before
    assert (_build.CSRC / "k.cu").exists()


def _bwd_inputs(d, c, seed=2):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32)
            for s in ((2, 256, d), (2, 64, d), (2, 64, c), (2, 256, c))]


@pytest.mark.parametrize("against", ["pallas", "reference"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c", TRAIN_SHAPES)
def test_plain_backward_matches_jax_vjp(d, c, dtype, against):
    """``attention_bwd_reference`` against ``jax.vjp`` of the Pallas kernel
    in interpret mode (its backward is ``_bwd_kernel``) and of the JAX
    ``attention_reference`` (autodiff)."""
    arrays = _bwd_inputs(d, c)
    fn = ((lambda q, k, v: jax_fused(q, k, v, interpret=True))
          if against == "pallas" else jax_reference)
    jq, jk, jv, jg = _jax(arrays, dtype)
    _, vjp = jax.vjp(fn, jq, jk, jv)
    got = attention_bwd_reference(*_port(arrays, dtype))
    for name, x, want in zip(("dq", "dk", "dv"), got, vjp(jg)):
        assert x.dtype == getattr(torch, dtype), name
        want = np.asarray(want, np.float32)
        err = np.abs(x.float().numpy() - want).max()
        assert err <= BWD_TOL[dtype, against] * np.abs(want).max(), (
            name, err, np.abs(want).max())


def test_attention_on_cpu_goes_through_the_autograd_function():
    q, k, v, g = (t.requires_grad_(i < 3) for i, t in
                  enumerate(_port(_bwd_inputs(4, 16, seed=3), "float32")))
    before = _counts()
    out = attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FusedAttentionBackward"
    # the model hands the backward a non-contiguous cotangent
    wide = out.transpose(1, 2).reshape(2, 16, 16, 16)
    grads = torch.autograd.grad(wide, (q, k, v),
                                g.transpose(1, 2).reshape(2, 16, 16, 16))
    want = attention_bwd_reference(q.detach(), k.detach(), v.detach(), g)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with torch.no_grad():
        assert attention(q, k, v).grad_fn is None
    assert attention(q.detach(), k.detach(), v.detach()).grad_fn is None
    assert _counts() == before


def test_backward_wrapper_refuses_tensors_off_cpu_and_cuda():
    q, k = torch.empty(1, 4, 2, device="meta"), torch.empty(1, 2, 2,
                                                            device="meta")
    v, g = torch.empty(1, 2, 8, device="meta"), torch.empty(1, 4, 8,
                                                            device="meta")
    before = cuda_attention.BWD_LAUNCHES
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_attention.attention_bwd_fused(q, k, v, g)
    assert cuda_attention.BWD_LAUNCHES == before
