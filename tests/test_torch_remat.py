"""Rematerialization (``remat: True``) in the port, mirroring
tests/test_remat.py: each G and D stage runs under
``torch.utils.checkpoint`` (``nn.layers.remat``) and is recomputed in the
backward, and nothing changes numerically: outputs, gradients, SN ``u``
and BN running stats (or BN's accumulated moments) are those of the
unrematted nets, and u and BN move once per forward, on the plain SN path
and the grouped one; the forward keeps fewer bytes for the backward; and a
remat training step matches the JAX package's remat step.

Tolerances: remat on against off in the port is held exactly (the same
operations on the same values); the step against JAX as in
test_torch_train_step.
"""

import copy

import numpy as np
import pytest
import torch

from sagan_tpu_torch.convert import flat_from_jax_tree, jax_flat_from_module
from sagan_tpu_torch.models import get_discriminator, get_generator
from sagan_tpu_torch.nn import layers
from sagan_tpu_torch.nn.attention import SelfAttention
from sagan_tpu_torch.utils.config import resolve_config

from test_torch_accum import RESNET8
from test_torch_train_step import (CONFIG, RTOL, SCALARS,
                                   _assert_close_state, _run_both)

BASE = {**CONFIG, "z_dim": 16, "num_classes": 5}


def _nets(remat, **kw):
    """Seeded G (training mode) and D of BASE with ``kw``, every attention
    gate open, and the same weights whatever ``remat``."""
    cfg = resolve_config({**BASE, **kw, "remat": remat}, num_local_devices=1)
    gen = get_generator(cfg, rng=torch.Generator().manual_seed(0)).train()
    disc = get_discriminator(cfg, rng=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in [*gen.modules(), *disc.modules()]:
            if isinstance(m, SelfAttention):
                m.sigma.fill_(0.5)
    assert gen.remat is disc.remat is remat
    return gen, disc


def _inputs(n=4):
    z = torch.randn(n, 16, generator=torch.Generator().manual_seed(3))
    return z, torch.arange(n) % 5


def _run(gen, disc, forwards=1):
    """G's fakes through D ``forwards`` times (D's u moves each time), one
    backward of the sum of squares: (outputs, grads of G and D, every
    buffer after)."""
    z, labels = _inputs()
    fake = gen(z, labels)
    outs = [disc(fake, labels) for _ in range(forwards)]
    loss = sum((o ** 2).sum() for o in outs) + (fake ** 2).sum()
    params = [*gen.parameters(), *disc.parameters()]
    grads = torch.autograd.grad(loss, params)
    bufs = {f"{tag}.{k}": v.clone() for tag, net in (("G", gen), ("D", disc))
            for k, v in net.named_buffers()}
    return [o.detach() for o in outs], grads, bufs


def _assert_same(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    assert a[2].keys() == b[2].keys()
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k


@pytest.mark.parametrize("sn_backend", ["xla", "pallas"])
@pytest.mark.parametrize("model,cond", [("vanilla", False),
                                        ("vanilla", True),
                                        ("resnet", False),
                                        ("resnet", True)])
def test_remat_changes_nothing_and_state_moves_once(model, cond,
                                                    sn_backend):
    kw = {"model": model, "use_label": cond, "use_cond_bn": cond,
          "use_pallas_sn": sn_backend == "pallas"}
    runs = {}
    for remat in (False, True):
        gen, disc = _nets(remat, **kw)
        before = {k: v.clone() for k, v in gen.named_buffers()}
        runs[remat] = _run(gen, disc)
    _assert_same(runs[True], runs[False])
    # and the state did move (once, as the unrematted forward moves it)
    moved = [k for k, v in before.items() if not torch.equal(
        v, runs[True][2][f"G.{k}"])]
    assert any(k.endswith(".u") for k in moved)
    assert any(k.endswith(".mean") for k in moved)


@pytest.mark.parametrize("sn_backend", ["xla", "pallas"])
def test_two_forwards_before_one_backward(sn_backend):
    """D twice before one backward (``fuse_d_batches: False``): each
    recompute takes its own forward's W̄, and u moves twice, as without
    remat."""
    kw = {"model": "resnet", "use_pallas_sn": sn_backend == "pallas"}
    runs = {remat: _run(*_nets(remat, **kw), forwards=2)
            for remat in (False, True)}
    _assert_same(runs[True], runs[False])


def test_remat_with_bn_accumulation_adds_the_moments_once():
    runs = {}
    for remat in (False, True):
        gen, disc = _nets(remat, model="resnet", use_label=True,
                          use_cond_bn=True)
        bns = layers.bn_moment_paths(gen)
        saved = layers.bn_accum_begin(bns)
        _run(gen, disc)
        z, labels = _inputs()
        torch.autograd.grad((gen(z, labels) ** 2).sum(),
                            list(gen.parameters()))
        sums = {k: v.clone() for k, v in gen.named_buffers()}
        layers.bn_accum_finalize(bns, saved, 2)
        runs[remat] = (sums, {k: v.clone() for k, v in gen.named_buffers()})
    for i in range(2):
        for k, v in runs[False][i].items():
            assert torch.equal(runs[True][i][k], v), k


def test_remat_recomputes_the_stages_and_keeps_fewer_bytes(monkeypatch):
    """The attention stage runs again in the backward (module hooks do not
    fire in a checkpoint's recompute, so its forward is counted), and the
    forward keeps a fraction of the activation bytes (the JAX test's
    saved-residuals probe, here through saved-tensor hooks)."""
    forward = SelfAttention.forward
    counted = []

    def counting(self, x):
        counted.append(1)
        return forward(self, x)

    monkeypatch.setattr(SelfAttention, "forward", counting)
    kept, calls = {}, {}
    for remat in (False, True):
        gen, disc = _nets(remat, img_size=64, gf_dim=16, attn_dim_G=[32])
        calls[remat] = counted = []
        z = torch.randn(8, 16, generator=torch.Generator().manual_seed(3))
        total = []

        def pack(t):
            total.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            img = gen(z)
        torch.autograd.grad((img ** 2).sum(), list(gen.parameters()))
        kept[remat] = sum(total)
    assert (len(calls[False]), len(calls[True])) == (1, 2)
    assert kept[True] < 0.7 * kept[False], kept


def test_a_layer_missing_from_the_forward_raises_in_the_recompute():
    conv = layers.Conv(4, 4, kernel=1, sn=True,
                       rng=torch.Generator().manual_seed(0))
    other = copy.deepcopy(conv)
    calls = []

    def stage(x):
        calls.append(1)
        return (conv if len(calls) == 1 else other)(x)

    y = layers.remat(stage, torch.randn(1, 4, 2, 2, requires_grad=True))
    with pytest.raises(RuntimeError, match="recompute of a checkpointed"):
        y.sum().backward()


@pytest.mark.parametrize("update_ratio,calls,options", [
    (1, 2, {"remat": True}),
    # D twice a step (u moves twice), flips, BCE
    (1, 2, {"remat": True, "fuse_d_batches": False, "random_flip": True,
            "loss": "cross_entropy"}),
    # with accumulation, exact BN, the TTUR ratio, and K7 grouped (JAX:
    # interpret mode)
    (2, 1, {**RESNET8, "remat": True, "use_pallas_sn": True,
            "pallas_interpret": True}),
])
def test_remat_steps_match_jax_remat_steps(update_ratio, calls, options):
    jstate, state, results, _ = _run_both(update_ratio, 1, calls, **options)
    assert state.gen.remat and state.disc.remat
    atol = 3 * options.get("lr_d", CONFIG["lr_d"])
    for jm, pm in results:
        for key in SCALARS:
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=RTOL, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(pm["G_grad_norms"].numpy(),
                                   jm["G_grad_norms"], rtol=RTOL, atol=1e-6)
    _assert_close_state(flat_from_jax_tree(jstate.vars_g),
                        jax_flat_from_module(state.gen), "G", atol)
    _assert_close_state(flat_from_jax_tree(jstate.vars_d),
                        jax_flat_from_module(state.disc), "D", atol)
