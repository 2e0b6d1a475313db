"""Port attention (sagan_tpu_torch/ops) against the JAX package: the plain
version against JAX ``attention_reference`` and against the Pallas kernel
``attention_fused`` run in interpret mode, on the same numpy inputs.

Tolerances: fp32 1e-5 (same arithmetic, other summation order); bf16
2e-2 (outputs of magnitude < 4, where one bf16 ulp is <= 2^-6, and both
sides round the probabilities and the output to bf16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu.ops.attention import attention_reference as jax_reference
from sagan_tpu.ops.pallas_attention import attention_fused as jax_fused
from sagan_tpu_torch.ops import cuda_attention
from sagan_tpu_torch.ops.attention import attention, attention_reference

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [(2, 8), (2, 16), (4, 8), (4, 16)]


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


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v = _port(_inputs(2, 8), "float32")
    before = cuda_attention.LAUNCHES
    want = attention_reference(q, k, v)
    for out in (attention(q, k, v), attention(q, k, v, use_pallas=True),
                attention(q, k, v, use_pallas=False),
                cuda_attention.attention_fused(q, k, v)):
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert cuda_attention.LAUNCHES == before


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
    assert [defs for _, defs in specs] == [
        (f"-DSAGAN_ATTN_C={c}",) for c in cuda_attention.SUPPORTED_C]
    assert {name for name, _ in specs} == {"attention_fwd"}
