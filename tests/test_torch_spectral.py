"""The fused spectral norm of the port (``ops/cuda_spectral.py``, K7's plain
version on the CPU, and ``spectral_normalize(backend="pallas")``) against
the JAX package's fused kernel ``_sn_call`` / ``spectral_normalize_fused``
in interpret mode, on the same numpy-seeded weights and ``u``.

Each layer passes its own layout: Dense and Embedding ``[in, out]`` as in
JAX, Conv OIHW and ConvTranspose IOHW against JAX's HWIO.  Tolerances:
W̄, u_new, v and sigma within 1e-5 (the same fp32 multiply-and-reduce in
another summation order); the gradient, through the closed-form VJP on
both sides, within 1e-4 (as ``tests/test_pallas_kernels.py`` holds the
JAX fused gradient to the XLA one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu.ops.pallas_spectral import _sn_call, spectral_normalize_fused
from sagan_tpu_torch.nn import layers as tlayers
from sagan_tpu_torch.ops import cuda_spectral
from sagan_tpu_torch.ops.cuda_spectral import (sn_view, spectral_norm_fused,
                                               spectral_norm_reference)
from sagan_tpu_torch.ops.spectral import spectral_normalize
from sagan_tpu_torch.tools.profiling import (PORT_KERNELS, SN_KERNELS,
                                             attention_kernels)

TOL = 1e-5
GRAD_TOL = 1e-4
EPS = 1e-12

# (name, JAX shape, permutation JAX -> port, the port's out_dim): Dense and
# Embedding keep [in, out]; Conv HWIO -> OIHW; ConvT HWIO -> IOHW
LAYOUTS = {
    "dense": ((24, 10), (0, 1), -1),
    "dense_head_o1": ((40, 1), (0, 1), -1),
    "embedding": ((7, 12), (0, 1), -1),
    "conv_oihw": ((3, 3, 6, 10), (3, 2, 0, 1), 0),
    "conv_1x1_oihw": ((1, 1, 16, 2), (3, 2, 0, 1), 0),
    "conv_transpose_iohw": ((3, 3, 6, 10), (2, 3, 0, 1), 1),
}


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    w = rs.randn(*shape).astype(np.float32)
    u = rs.randn(shape[-1]).astype(np.float32)
    return w, u / np.linalg.norm(u)


def _to_port(w, perm):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(perm)))


def _to_jax(t, perm):
    return t.detach().numpy().transpose(np.argsort(perm))


@pytest.mark.parametrize("n_iter", [1, 3])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plain_k7_matches_the_jax_kernel(name, n_iter):
    """W̄, u_new, v and sigma of the plain K7 against ``_sn_call`` in
    interpret mode.  JAX's v runs over its HWIO rows (h, w, i); the port's
    over (i, h, w), its own layout's fan-in order."""
    shape, perm, out_dim = LAYOUTS[name]
    w, u = _inputs(shape, seed=len(name) + n_iter)
    w_mat = jnp.asarray(w.reshape(-1, shape[-1]))
    jw, ju, jv, js = _sn_call(w_mat, jnp.asarray(u)[None, :], n_iter, EPS,
                              interpret=True)
    w_bar, u_new, v, sigma = spectral_norm_fused(
        _to_port(w, perm), torch.from_numpy(u), n_iter, EPS, out_dim)
    np.testing.assert_allclose(_to_jax(w_bar, perm),
                               np.asarray(jw).reshape(shape), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(u_new.numpy(), np.asarray(ju)[0], atol=TOL)
    np.testing.assert_allclose(float(sigma), float(np.asarray(js)[0, 0]),
                               rtol=TOL)
    # JAX's v over HWIO rows, put in the port's fan-in order
    jv = np.asarray(jv)[:, 0]
    if len(shape) == 4:
        jv = jv.reshape(shape[:3]).transpose(2, 0, 1).reshape(-1)
    np.testing.assert_allclose(v.numpy(), jv, atol=TOL)
    if shape[-1] == 1:   # O = 1: sigma is |w|
        np.testing.assert_allclose(float(sigma), np.linalg.norm(w), rtol=TOL)


@pytest.mark.parametrize("n_iter", [1, 3])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_pallas_backend_gradient_matches_jax(name, n_iter):
    """The gradient of sum(W̄ · t) in W through ``SpectralNormFused``
    against ``jax.grad`` through the JAX fused custom VJP; no gradient
    reaches u."""
    shape, perm, out_dim = LAYOUTS[name]
    w, u = _inputs(shape, seed=10 + len(name) + n_iter)
    t = np.random.RandomState(2).randn(*shape).astype(np.float32)

    def loss(w_):
        w_bar, _ = spectral_normalize_fused(w_, jnp.asarray(u), n_iter=n_iter,
                                            interpret=True)
        return jnp.sum(w_bar * t)

    want = np.asarray(jax.grad(loss)(jnp.asarray(w)))
    tw = _to_port(w, perm).requires_grad_()
    tu = torch.from_numpy(u).requires_grad_()
    w_bar, u_new = spectral_normalize(tw, tu, n_iter, out_dim=out_dim,
                                      backend="pallas")
    assert not u_new.requires_grad
    gw, gu = torch.autograd.grad((w_bar * _to_port(t, perm)).sum(), (tw, tu),
                                 allow_unused=True)
    assert gu is None
    np.testing.assert_allclose(_to_jax(gw, perm), want, atol=GRAD_TOL,
                               rtol=GRAD_TOL)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_pallas_and_xla_backends_agree(name):
    """The port's two backends on one weight: W̄ and u_new within 1e-5,
    and the gradients (closed form against autograd through sigma) within
    1e-4, at 20 iterations, where both have converged."""
    shape, perm, out_dim = LAYOUTS[name]
    w, u = _inputs(shape, seed=20 + len(name))
    t = _to_port(np.random.RandomState(3).randn(*shape).astype(np.float32),
                 perm)
    out = {}
    for backend in ("xla", "pallas"):
        tw = _to_port(w, perm).requires_grad_()
        w_bar, u_new = spectral_normalize(tw, torch.from_numpy(u), 20,
                                          out_dim=out_dim, backend=backend)
        out[backend] = (w_bar.detach(), u_new,
                        torch.autograd.grad((w_bar * t).sum(), tw)[0])
    for a, b, tol in zip(out["xla"], out["pallas"], (TOL, TOL, GRAD_TOL)):
        torch.testing.assert_close(b, a, atol=tol, rtol=tol)


def test_sn_view_puts_the_output_channels_in_the_middle():
    assert sn_view((1128, 4096), -1) == (1128, 4096, 1)
    assert sn_view((256, 128, 3, 3), 0) == (1, 256, 1152)
    assert sn_view((256, 128, 3, 3), 1) == (256, 128, 9)
    assert sn_view((1000, 256), -1) == (1000, 256, 1)


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    w, u = _inputs((5, 4), seed=0)
    before = cuda_spectral.LAUNCHES
    got = spectral_norm_fused(torch.from_numpy(w), torch.from_numpy(u), 2,
                              EPS, -1)
    want = spectral_norm_reference(torch.from_numpy(w), torch.from_numpy(u),
                                   2, EPS, -1)
    assert cuda_spectral.LAUNCHES == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bad_iterations_and_backends_raise():
    w, u = torch.randn(4, 3), torch.randn(3)
    with pytest.raises(ValueError, match="n_iter"):
        spectral_normalize(w, u, 0, backend="pallas")
    with pytest.raises(ValueError, match="n_iter"):
        spectral_norm_fused(w, u, 0)
    with pytest.raises(ValueError, match="backend"):
        spectral_normalize(w, u, backend="bogus")
    with pytest.raises(ValueError, match="backend"):
        tlayers.set_sn_backend(tlayers.Dense(3, 4, sn=True), "bogus")


def test_set_sn_backend_routes_every_sn_layer_and_only_those():
    net = torch.nn.Sequential(tlayers.Dense(3, 4, sn=True),
                              tlayers.Conv(4, 2, kernel=1),
                              tlayers.ConvTranspose(2, 2, kernel=3, sn=True))
    tlayers.set_sn_backend(net, "pallas")
    assert [m.sn_backend for m in net] == ["pallas", "xla", "pallas"]
    # per model: a new layer still takes the plain function
    assert tlayers.Dense(3, 4, sn=True).sn_backend == "xla"


def test_profile_names_pick_out_k7():
    """The breakdown tools sum the grouped K7's three forward kernels under
    one row and count one launch a call (its finish kernel), and its two
    backward kernels under another, as a profile names them."""
    ns = "void (anonymous namespace)::"
    table = "((anonymous namespace)::Table, int)"
    bwd = "((anonymous namespace)::BwdTable)"
    kernels = {
        f"{ns}sn_group_rows_kernel{table}": (3.0, 4),
        f"{ns}sn_group_colsum_kernel{table}": (1.0, 4),
        f"{ns}sn_group_finish_kernel((anonymous namespace)::Table, int, "
        f"float)": (2.0, 4),
        f"{ns}sn_group_dot_kernel{bwd}": (0.5, 2),
        f"{ns}sn_group_grad_kernel((anonymous namespace)::BwdTable, "
        f"float)": (1.5, 2),
        f"{ns}attention_fwd_kernel<float, 2, 8>(float const*)": (5.0, 4)}
    assert attention_kernels(kernels, per=2, table=SN_KERNELS) == {
        "K7 spectral_norm": {"ms": 3.0, "launches": 2},
        "K7 spectral_norm_bwd": {"ms": 1.0, "launches": 1}}
    rows = attention_kernels(kernels, per=2, table=PORT_KERNELS)
    assert rows["K1 attention_fwd"] == {"ms": 2.5, "launches": 2}
    assert rows["K7 spectral_norm"] == {"ms": 3.0, "launches": 2}
