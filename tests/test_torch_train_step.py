"""Two full training steps of the port (``sagan_tpu_torch/train/trainer.py``)
against the JAX package's ``build_train_step`` on a 1-device mesh, from
the same init (JAX's, converted), the same uint8 images and the same
latents (JAX's, rebuilt from its key path and passed to the port, since
torch cannot draw threefry's numbers).  The example_configs/test.py widths
at 32 px in fp32, batch 4, attention ``sigma`` set to 0.5 so every
attention gradient is nonzero, ``g_ema_start`` 1 so both EMA branches run,
``steps_per_epoch`` 1 so both LR schedules decay between the steps.

Tolerances:
* losses, the D-health fractions and the gradient norms (global and per
  G variable) are held tightly (rtol 1e-4): the same fp32 arithmetic with
  other summation orders, through two Adam steps;
* parameters, SN ``u``, BN running stats, the EMA and the per-variable
  means of G within 3 · lr_d: Adam with β1 = 0 moves a
  parameter by ≈ lr · sign(g) on its first step, so an element whose
  gradient is ~0 can move by ±lr in the two frameworks, a difference of
  2 · lr (in the conditional case one such element of a BN table moves
  its variable's mean by a few 1e-6); everything else agrees to ~1e-6.
  The share of elements off by more than 1e-5 is held below 1 %.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagan_tpu.models import get_discriminator as jax_discriminator
from sagan_tpu.models import get_generator as jax_generator
from sagan_tpu.parallel.mesh import (make_mesh, put_with_sharding, replicate,
                                     shard_batch, stacked_batch_sharding)
from sagan_tpu.train.optim import make_gan_optimizers as jax_optimizers
from sagan_tpu.train.trainer import TrainState as JaxState
from sagan_tpu.train.trainer import build_train_step as jax_train_step
from sagan_tpu.utils.config import resolve_config as jax_resolve
from sagan_tpu_torch.convert import (flat_from_jax_tree, jax_flat_from_module,
                                     state_from_jax)
from sagan_tpu_torch.models import get_discriminator, get_generator
from sagan_tpu_torch.ops import cuda_attention
from sagan_tpu_torch.train.optim import make_gan_optimizers
from sagan_tpu_torch.train.trainer import TrainState, build_train_step
from sagan_tpu_torch.utils.config import resolve_config

CONFIG = {
    "dataset": "synthetic", "data_path": "unused", "model": "vanilla",
    "z_dim": 32, "gf_dim": 8, "df_dim": 8, "img_size": 32,
    "num_classes": 1, "use_attention": True, "attn_dim_G": [16],
    "attn_dim_D": [8], "use_label": False, "batch_size": 4,
    "num_devices": 1, "loss": "hinge_loss", "lr_g": 2e-4, "lr_d": 7e-4,
    "decay_rate": 0.99, "compute_dtype": "float32", "g_ema_decay": 0.9,
    "g_ema_start": 1, "seed": 0,
}
STEPS_PER_EPOCH = 1
RTOL = 1e-4
# the conditional resnet at imagenet128_cond's TTUR ratio (lr_d = 4 lr_g),
# at rates 1/40 of its own: at CONFIG's rates two D updates move the
# resnet D so far that the first update's rounding (a ±lr move of each
# element whose gradient is ~0) flips ReLU gates under the second, and
# G_loss then differs by ~1 % between any two implementations, the JAX
# package's own two SN backends included (_run_both(2, 1, 2, **RESNET)
# with CONFIG's rates, on the CPU)
RESNET = {"model": "resnet", "use_label": True, "num_classes": 4,
          "use_cond_bn": True, "lr_g": 2.5e-6, "lr_d": 1e-5}
SCALARS = ("G_loss", "D_loss", "G_grad_norm", "D_grad_norm", "D_real_mean",
           "D_fake_mean", "D_real_in_margin", "D_fake_in_margin")


def _with_sigma(variables, value=0.5):
    """``variables`` with every attention gate ``sigma`` set to ``value``
    (0 at init, which would leave theta/phi/g without a gradient)."""
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.full_like(a, value)
                         if getattr(path[-1], "key", None) == "sigma" else a),
        variables["params"])
    return {"params": params, "aux": variables["aux"]}


def _jax_latents(rng, step, batch, cfg):
    """The train step's latents, from its key path: fold_in(rng, step),
    fold_in(., axis_index 0), split 3 -> (flip, d, g); D update i samples
    from fold_in(d, i); the flip mask is bernoulli(flip, 0.5)."""
    key = jax.random.fold_in(jax.random.fold_in(rng, step), 0)
    flip_key, d_key, g_key = jax.random.split(key, 3)
    flip = None
    if cfg.get("random_flip"):
        flip = torch.from_numpy(np.array(jax.random.bernoulli(
            flip_key, 0.5, (batch, 1, 1, 1)))).reshape(batch)

    def sample(k):
        kz, kl = jax.random.split(k)
        z = jax.random.normal(kz, (batch, cfg["z_dim"]), jnp.float32)
        labels = jax.random.randint(kl, (batch,), 0, cfg["num_classes"])
        return (torch.from_numpy(np.array(z)),
                torch.from_numpy(np.array(labels)).long())

    return {"flip": flip, "g": sample(g_key),
            "d": [sample(jax.random.fold_in(d_key, i))
                  for i in range(cfg["update_ratio"])]}


def _run_both(update_ratio, steps_per_call, calls, **options):
    cfg = dict(CONFIG, update_ratio=update_ratio,
               steps_per_call=steps_per_call, **options)
    jcfg = jax_resolve(cfg, num_local_devices=1)
    mesh = make_mesh(1)
    jgen, jdisc = jax_generator(jcfg), jax_discriminator(jcfg)
    (opt_g, _), (opt_d, _) = jax_optimizers(jcfg, STEPS_PER_EPOCH)
    key = jax.random.PRNGKey(0)
    kg, kd, krest = jax.random.split(key, 3)
    rng = np.asarray(krest)   # the state (and its key) is donated per call
    vars_g = _with_sigma(jgen.init(kg))
    vars_d = _with_sigma(jdisc.init(kd))
    jstate = replicate(mesh, JaxState(
        vars_g=vars_g, vars_d=vars_d, opt_g=opt_g.init(vars_g["params"]),
        opt_d=opt_d.init(vars_d["params"]), step=jnp.int32(0), rng=krest,
        ema_g=jax.tree.map(jnp.copy, vars_g["params"])))
    jstep = jax_train_step(jgen, jdisc, opt_g, opt_d, jcfg, mesh)

    pcfg = resolve_config(cfg, num_local_devices=1)
    gen, disc = get_generator(pcfg), get_discriminator(pcfg)
    gen.load_state_dict(state_from_jax(flat_from_jax_tree(vars_g), gen))
    disc.load_state_dict(state_from_jax(flat_from_jax_tree(vars_d), disc))
    (popt_g, sched_g), (popt_d, sched_d) = make_gan_optimizers(
        pcfg, gen.parameters(), disc.parameters(), STEPS_PER_EPOCH)
    state = TrainState(gen, disc, popt_g, popt_d, 0,
                       {n: p.detach().clone()
                        for n, p in gen.named_parameters()})
    pstep = build_train_step(pcfg, sched_g, sched_d, gen, disc)

    rs = np.random.RandomState(7)
    b, k = cfg["batch_size"], steps_per_call
    results = []
    for call in range(calls):
        images = rs.randint(0, 256, (k, b, 32, 32, 3)).astype(np.uint8)
        labels = rs.randint(0, cfg["num_classes"], (k, b)).astype(np.int32)
        if k > 1:
            sh = stacked_batch_sharding(mesh)
            jstate, jm = jstep(jstate, put_with_sharding(images, sh),
                               put_with_sharding(labels, sh))
        else:
            jstate, jm = jstep(jstate, *shard_batch(mesh, images[0],
                                                    labels[0]))
        latents = [_jax_latents(jnp.asarray(rng), call * k + i, b, cfg)
                   for i in range(k)]
        pm = pstep(state, torch.from_numpy(images), torch.from_numpy(labels),
                   latents)
        results.append((jax.device_get(jm), pm))
    return jstate, state, results, pstep.g_names


def _assert_close_state(jax_flat, port_flat, what, atol):
    assert jax_flat.keys() == port_flat.keys(), what
    off, total = 0, 0
    for name, want in jax_flat.items():
        got = port_flat[name]
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=f"{what} {name}")
        off += int((np.abs(got - want) > 1e-5).sum())
        total += want.size
    assert off <= 0.01 * total, f"{what}: {off} of {total} elements off"


@pytest.mark.parametrize("update_ratio,steps_per_call,calls,options", [
    # one call of two steps: metrics averaged over the call
    (1, 2, 1, {}),
    # two calls of one step, two D updates each
    (2, 1, 2, {}),
    # real and fake through D in two forwards (u moves twice), per-sample
    # flips, the BCE loss
    (1, 1, 2, {"fuse_d_batches": False, "random_flip": True,
               "loss": "cross_entropy"}),
    # conditional: class-conditional BN in G, the projection head in D
    (1, 1, 2, {"use_label": True, "num_classes": 4, "use_cond_bn": True}),
    # the conditional resnet family at the TTUR update ratio 2, with every
    # spectral norm through the fused kernel (JAX: interpret mode; the
    # port: K7's plain version, its closed-form backward) and without
    (2, 1, 2, RESNET),
    (2, 1, 2, {**RESNET, "use_pallas_sn": True, "pallas_interpret": True}),
])
def test_two_port_steps_match_jax_build_train_step(update_ratio,
                                                   steps_per_call, calls,
                                                   options):
    before = (cuda_attention.LAUNCHES, cuda_attention.BWD_LAUNCHES)
    jstate, state, results, g_names = _run_both(update_ratio,
                                                steps_per_call, calls,
                                                **options)
    atol = 3 * options.get("lr_d", CONFIG["lr_d"])
    # CPU tensors take the plain versions: no kernel launches
    assert (cuda_attention.LAUNCHES, cuda_attention.BWD_LAUNCHES) == before
    for jm, pm in results:
        for key in SCALARS:
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=RTOL, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(pm["G_grad_norms"].numpy(),
                                   jm["G_grad_norms"], rtol=RTOL, atol=1e-6,
                                   err_msg="G_grad_norms")
        # means of the parameters, held like the parameters
        np.testing.assert_allclose(pm["G_var_means"].numpy(),
                                   jm["G_var_means"], rtol=0,
                                   atol=atol, err_msg="G_var_means")
        # every attention weight (theta/phi/g) of G has a real gradient
        norms = dict(zip(g_names, pm["G_grad_norms"].numpy()))
        for part in ("theta", "phi", "g"):
            assert norms[f"attn16.{part}.w"] > 1e-6, part

    assert state.step == jax.device_get(jstate.step) == calls * \
        steps_per_call
    _assert_close_state(flat_from_jax_tree(jstate.vars_g),
                        jax_flat_from_module(state.gen), "G", atol)
    _assert_close_state(flat_from_jax_tree(jstate.vars_d),
                        jax_flat_from_module(state.disc), "D", atol)
    # the EMA, moved into a generator's parameters for the layout
    ema_gen = copy.deepcopy(state.gen)
    ema_gen.load_state_dict({**state.gen.state_dict(), **state.ema})
    want = flat_from_jax_tree({"params": jstate.ema_g})
    got = {k: v for k, v in jax_flat_from_module(ema_gen).items()
           if k.startswith("params/")}
    _assert_close_state(want, got, "EMA", atol)


def test_the_g_update_leaves_no_gradient_on_either_net():
    _, state, _, _ = _run_both(1, 1, 1)
    for net in (state.gen, state.disc):
        assert all(p.grad is None for p in net.parameters())
