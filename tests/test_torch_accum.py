"""Gradient accumulation (``grad_accum_steps``) in the port against the JAX
package, mirroring tests/test_grad_accum.py and tests/test_bn_accum.py:
BN's accumulation mode gives the full batch's running statistics, and
accumulated training steps match JAX's ``build_train_step`` from the same
init, images and latents (test_torch_train_step's harness).

Tolerances: losses, health and gradient norms rtol 1e-4, the state after
the steps within 3 · lr_d (test_torch_train_step gives the reasons), and
the BN running statistics within 1e-5: they move by (1 − 0.99) of batch
moments that agree to ~1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from sagan_tpu.nn.layers import BatchNorm as JaxBN
from sagan_tpu.nn.layers import ConditionalBatchNorm as JaxCondBN
from sagan_tpu.nn.layers import bn_accum_begin as jax_begin
from sagan_tpu.nn.layers import bn_accum_finalize as jax_finalize
from sagan_tpu.nn.layers import bn_moment_paths as jax_paths
from sagan_tpu_torch.convert import flat_from_jax_tree, jax_flat_from_module
from sagan_tpu_torch.models import get_discriminator, get_generator
from sagan_tpu_torch.nn.layers import (BatchNorm, ConditionalBatchNorm,
                                       bn_accum_begin, bn_accum_finalize,
                                       bn_moment_paths)
from sagan_tpu_torch.train.optim import make_gan_optimizers
from sagan_tpu_torch.train.trainer import TrainState, build_train_step
from sagan_tpu_torch.utils.config import resolve_config

from test_torch_train_step import (CONFIG, RESNET, RTOL, SCALARS,
                                   _assert_close_state, _run_both)

BN_ATOL = 1e-5


def _x(seed=1):
    """Seeded NHWC input [16, 4, 4, 8] (JAX's layout) with mean 1, std 2."""
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((16, 4, 4, 8)) * 2.0 + 1.0).astype(np.float32)


@pytest.mark.parametrize("cond", [False, True])
def test_bn_accumulation_gives_the_full_batch_stats_as_jax(cond):
    x = _x()
    labels = np.arange(16) % 4
    bn = ConditionalBatchNorm(8, 4) if cond else BatchNorm(8)
    bn.train()
    with torch.no_grad():
        bn.mean.fill_(0.3)
        bn.var.fill_(2.0)
    start = {k: v.clone() for k, v in bn.state_dict().items()}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    lt = torch.from_numpy(labels)

    bn(xt, lt) if cond else bn(xt)
    full = (bn.mean.clone(), bn.var.clone())
    bn.load_state_dict(start)
    bns = bn_moment_paths(bn)
    assert bns == [bn]
    saved = bn_accum_begin(bns)
    assert bn.accumulating
    for i in range(4):
        sl = slice(4 * i, 4 * (i + 1))
        bn(xt[sl], lt[sl]) if cond else bn(xt[sl])
    bn_accum_finalize(bns, saved, 4)
    assert not bn.accumulating
    np.testing.assert_allclose(bn.mean, full[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.var, full[1], rtol=0, atol=1e-6)

    jbn = JaxCondBN(8, num_classes=4) if cond else JaxBN(8)
    v = jbn.init(jax.random.PRNGKey(0))
    aux = {"mean": np.full(8, 0.3, np.float32),
           "var": np.full(8, 2.0, np.float32)}
    paths = jax_paths(jbn)
    aux, jsaved = jax_begin(paths, aux)
    for i in range(4):
        sl = slice(4 * i, 4 * (i + 1))
        args = (x[sl], labels[sl]) if cond else (x[sl],)
        _, aux = jbn({"params": v["params"], "aux": aux}, *args, train=True,
                     bn_accum=True)
    aux = jax_finalize(paths, aux, jsaved, 4)
    np.testing.assert_allclose(bn.mean, aux["mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.var, aux["var"], rtol=0, atol=1e-6)


def _bn_buffers(flat):
    return {k: v for k, v in flat.items()
            if k.startswith("aux/") and k.rsplit("/", 1)[-1] in ("mean",
                                                                  "var")}


# the conditional resnet at batch 8 (micro-batches of 4): at micro-batches
# of 2 its G gradient is ill-conditioned at this init, a 1e-7 relative
# perturbation of G's parameters moving per-variable gradient norms by
# up to 3e-2 and the port's two SN backends (the same arithmetic in
# another order) 4e-3 apart, as far as either is from JAX
RESNET8 = {**RESNET, "grad_accum_steps": 2, "batch_size": 8}


@pytest.mark.parametrize("update_ratio,steps_per_call,calls,options", [
    # two calls of one step, two D updates each
    (2, 1, 2, {"grad_accum_steps": 2}),
    # composes with steps_per_call: one call of two steps
    (1, 2, 1, {"grad_accum_steps": 2}),
    # the per-micro momentum updates, and the BCE loss
    (1, 1, 2, {"grad_accum_steps": 2, "exact_accum_bn": False,
               "loss": "cross_entropy"}),
    # the conditional resnet with the plain SN, and with K7 grouped over
    # each micro forward (JAX: interpret mode; the port: K7's plain
    # version)
    (1, 1, 2, RESNET8),
    (1, 1, 2, {**RESNET8, "use_pallas_sn": True, "pallas_interpret": True}),
])
def test_accumulated_steps_match_jax_build_train_step(update_ratio,
                                                      steps_per_call, calls,
                                                      options):
    jstate, state, results, _ = _run_both(update_ratio, steps_per_call,
                                          calls, **options)
    atol = 3 * options.get("lr_d", CONFIG["lr_d"])
    for jm, pm in results:
        for key in SCALARS:
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=RTOL, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(pm["G_grad_norms"].numpy(),
                                   jm["G_grad_norms"], rtol=RTOL, atol=1e-6)
    assert state.step == calls * steps_per_call
    want_g = flat_from_jax_tree(jstate.vars_g)
    got_g = jax_flat_from_module(state.gen)
    _assert_close_state(want_g, got_g, "G", atol)
    _assert_close_state(flat_from_jax_tree(jstate.vars_d),
                        jax_flat_from_module(state.disc), "D", atol)
    bn = _bn_buffers(want_g)
    assert bn, "G has BN layers"
    for name in bn:
        np.testing.assert_allclose(got_g[name], np.asarray(bn[name]),
                                   rtol=0, atol=BN_ATOL, err_msg=name)


SMALL = {**CONFIG, "update_ratio": 2, "batch_size": 16,
         "global_batch_size": 16}


def _port_step(accum, **options):
    """One port step of SMALL at ``grad_accum_steps`` ``accum`` from a
    seeded init on one seeded batch; returns (metrics, G)."""
    cfg = resolve_config({**SMALL, "grad_accum_steps": accum, **options},
                         num_local_devices=1)
    gen = get_generator(cfg, rng=torch.Generator().manual_seed(0))
    disc = get_discriminator(cfg, rng=torch.Generator().manual_seed(1))
    (opt_g, sg), (opt_d, sd) = make_gan_optimizers(
        cfg, gen.parameters(), disc.parameters(), 10)
    state = TrainState(gen, disc, opt_g, opt_d, 0, None)
    step = build_train_step(cfg, sg, sd, gen, disc)
    rs = np.random.RandomState(0)
    images = torch.from_numpy(rs.randint(0, 256, (1, 16, 32, 32, 3))
                              .astype(np.uint8))
    metrics = step(state, images, torch.zeros(1, 16, dtype=torch.int32))
    return metrics, gen


def test_the_first_bn_is_exact_against_the_unaccumulated_step():
    """A=4 against A=1 from the same state and latents: G's first BN sees
    only (z, params), so its running stats are the full batch's; later
    BNs normalize per micro-batch and land only nearby
    (tests/test_bn_accum.py)."""
    (m1, g1), (m4, g4) = _port_step(1), _port_step(4)
    assert np.isfinite(float(m4["G_loss"]))
    bns1, bns4 = bn_moment_paths(g1), bn_moment_paths(g4)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bns4[0], name),
                                   getattr(bns1[0], name), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    for a, b in zip(bns4[1:], bns1[1:]):
        assert float((a.mean - b.mean).abs().max()) < 0.1
    assert abs(float(m4["D_loss"]) - float(m1["D_loss"])) < 0.5


def test_inexact_mode_moves_the_running_stats_once_per_micro_batch():
    _, exact = _port_step(4)
    _, inexact = _port_step(4, exact_accum_bn=False)
    first = bn_moment_paths(exact)[0], bn_moment_paths(inexact)[0]
    assert not torch.allclose(first[0].mean, first[1].mean, atol=1e-6)


def test_an_accumulation_that_does_not_divide_the_batch_raises():
    with pytest.raises(ValueError, match="grad_accum_steps=3 must divide"):
        _port_step(3)
