"""GAN trainer, one card a process, port of ``sagan_tpu/train/trainer.py``.

:func:`build_train_step` gives the step of the JAX package's
``build_train_step`` (``steps_per_call`` K sequential steps per call,
metrics averaged over them).  One step:

* the uint8 batch [B, S, S, 3] is normalized to [-1, 1] on the device
  (and flipped left-right per sample when ``random_flip``);
* ``update_ratio`` D updates, each a G forward for the fakes in training
  mode under ``torch.no_grad()`` (it moves G's BN running stats and SN
  ``u``), ONE D forward over the real and fake batches together at batch
  2B (two forwards when ``fuse_d_batches`` is off), and an Adam update;
* one G update, whose D forward is in training mode too, so D's SN ``u``
  moves again;
* the EMA of G's parameters, ``decay · ema + (1 − decay) · param``, with
  decay 0 (a copy) before step ``g_ema_start``;
* with ``grad_accum_steps`` A > 1, each D update and the G update run
  their B latents (drawn whole, as at A = 1) and images in A micro-batches
  of B/A, each through its own G and D forwards (so SN's u moves once per
  micro forward), and take the mean of the micro-batches' fp32 gradients,
  losses and health; with ``exact_accum_bn`` (default) BN adds each
  micro-batch's moments and applies its momentum once per update
  (``nn.layers.bn_accum_begin`` / ``bn_accum_finalize``);
* metrics: G/D loss, global gradient norms, the D-health fractions, and
  per-variable G means and gradient norms (and D's gradient norms).

Data parallelism (``parallel/mesh.py``): under a ``torch.distributed``
group each rank runs the step on its own rows of the global batch; each D
update's gradients, loss and health and the G update's gradients and loss
are mean-all-reduced before the optimizer (after the micro-batch mean),
as JAX pmeans them, and BN's moments are the ranks' mean (cross-replica
BN).  No ``DistributedDataParallel``: its reducer hooks never fire under
``torch.autograd.grad``.

Model parallelism (``model_parallel`` m > 1, JAX's GSPMD step on a
(data, model) mesh): the W ranks form a W/m x m grid (``parallel/mesh.py``
``make_grid``); each rank holds its model index's column shards of the
wide weights and of their Adam moments and EMA (``parallel/sharding.py``,
JAX's ``param_shardings`` rule), and runs its data index's rows, as its
model peers do.  Every reduction above is over the data group; a sharded
layer gathers its output channels over the model group, and its SN is the
whole weight's (``nn/layers.py``, ``ops/spectral.py``), so the step is the
one-process step at the global batch.  The gradients of the parameters
every peer holds whole are averaged over the model group first, which
keeps the peers' replicas bit-identical where a kernel sums in no fixed
order.  The gradient norms and variable
means in the metrics are of whole variables.  As in the JAX trainer,
``use_pallas_sn`` is dropped (SN keeps the weight sharded); each rank's
attention runs K1/K2 (or the flash kernels) on its own rows, with every
channel gathered, as JAX's ``pallas_partitioned`` kernels do.

The port keeps the state in its modules and optimizers and updates them in
place (:class:`TrainState`); gradients are taken with
``torch.autograd.grad`` of each net's loss with respect to that net's
parameters only.  Each step draws its randomness from device
``torch.Generator``s seeded by (seed, step, purpose), so a resumed run
draws what an unbroken one would, with no generator state to save; the
numbers differ from JAX's threefry streams, so a caller that needs JAX's
latents passes them in (``latents_k``).  The draws are the global batch's,
of which a rank takes its rows, so W ranks at batch B draw what one
process draws at batch W·B.

:class:`Trainer` is the epoch loop: uint8 batches fed from the host, or
gathered on the device from the whole dataset uploaded there once
(``device_cache``, JAX's rule for "auto"), TensorBoard
scalars (and, with ``summary_histograms``, weight histograms), PNG
sample grids of the EMA generator, checkpoints in the port's own format,
FID (and IS) epochs every ``fid_epoch_freq`` epochs (``train/fid.py``,
``train/iscore.py``), a profiler trace of calls 10-20 of the first epoch
(``profile_dir``), save-and-exit on SIGTERM/SIGINT and an exact
mid-epoch resume, at the JAX trainer's cadences.  Under a group each rank
trains on its own card (the CLI's ``cuda:<LOCAL_RANK>``, ``main.py``),
feeds its own shard of the data (the device cache holds the rank's shard,
padded to the largest; under model parallelism the shard of its data
index), and only process 0 writes summaries, sample grids, checkpoints,
the profiler trace and the epoch and FID lines; its model peers join the
gathers of its sample grids, histograms and checkpoints, which leave the
run whole, in the format of m = 1, and restore at any m.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import os
import signal
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..data.loader import get_dataset_and_info
from ..models import get_discriminator, get_generator
from ..nn.layers import bn_accum_begin, bn_accum_finalize, bn_moment_paths
from ..ops.losses import get_loss
from ..parallel import mesh, sharding
from ..utils.device import resolve_device
from ..utils.images import make_grid, save_image_grid
from ..utils.profiling import TraceWindow, span
from ..utils.tb_writer import SummaryWriter
from ..utils.timing import StepTimer
from .checkpoint import CheckpointManager
from .fid import compute_fid_for_trainer, get_extractor
from .iscore import get_classifier, inception_score_for_trainer
from .optim import make_gan_optimizers, set_lr

# purposes of the seeded random streams: per step (flip, G latents, D
# update i's latents at _D + i) and at init (the nets, the grids' fixed
# latents, and the latents of FID and IS samples)
_FLIP, _G, _D = 0, 1, 2
_INIT_G, _INIT_D, _FIXED, _EVAL = 0, 1, 2, 3

HEALTH_KEYS = ("D_real_mean", "D_fake_mean", "D_real_in_margin",
               "D_fake_in_margin")
META_KEYS = ("img_size", "num_classes", "z_dim")


def seeded(device, *words) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the non-negative
    integers ``words`` (through numpy's SeedSequence, so nearby words give
    unrelated streams)."""
    seed = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(seed[0]))


def jax_order(names) -> list:
    """Parameter names in the order of ``jax.tree.leaves`` of the JAX
    variable tree (keys sorted at every level), which orders the
    per-variable metrics."""
    return sorted(names, key=lambda name: name.split("."))


@dataclass
class TrainState:
    """What one training run carries from step to step: the nets (with
    their SN and BN buffers), both optimizers, the number of steps taken,
    and the EMA of G's parameters by name (None when not tracked)."""
    gen: torch.nn.Module
    disc: torch.nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0
    ema: dict | None = None


def _whole(values: torch.Tensor, sharded, square: bool) -> torch.Tensor:
    """Per-variable ``values`` [n] of the shards this rank holds made the
    whole variables': at the indices ``sharded`` (a tensor, or None when
    nothing is sharded) the norms' squares summed (``square``), or the
    means averaged, over the model group."""
    if sharded is None:
        return values
    part = values[sharded.to(values.device)]
    part = part.square() if square else part / mesh.model_size()
    part = mesh.all_reduce_(part, group=mesh.model_group())
    return values.index_copy(0, sharded.to(values.device),
                             part.sqrt() if square else part)


def _mean_over_peers(grads, replicated) -> list:
    """Under model parallelism, the gradients at the indices
    ``replicated`` (the parameters every model peer holds whole) averaged
    over the model group: the peers compute them redundantly, equal but
    for the rounding of kernels that sum in no fixed order (cuDNN's fp32
    weight gradients), and the mean keeps their replicas equal bit for
    bit.  As given when ``replicated`` is None."""
    if replicated is None:
        return grads
    grads = list(grads)
    means = mesh.all_reduce_mean([grads[i] for i in replicated],
                                 mesh.model_group())
    for i, g in zip(replicated, means):
        grads[i] = g
    return grads


def _mean_over_ranks(grads, loss, health: dict) -> tuple:
    """``lax.pmean`` over the data group of an update's fp32 gradients,
    loss and health, in one all-reduce; as given without a group."""
    if not mesh.distributed():
        return grads, loss, health
    keys = list(health)
    out = mesh.all_reduce_mean([*grads, loss.float(),
                                *(health[k].float() for k in keys)],
                               mesh.data_group())
    n = len(grads)
    return out[:n], out[n], dict(zip(keys, out[n + 1:]))


def _apply(opt, params, grads, lr: float) -> None:
    """One optimizer update with ``grads``; no ``.grad`` outlives it."""
    set_lr(opt, lr)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


class TrainStep:
    """The port of the JAX ``build_train_step``: ``step(state, images_k,
    labels_k, latents_k=None)`` runs K = ``images_k.shape[0]`` steps and
    returns their metrics averaged over the K steps, as device tensors."""

    # the phases of one step, in order, each a span (``sagan.<phase>``,
    # inside ``sagan.step``, inside the call's ``sagan.train_step``);
    # ``mark``, when set, is called with each phase's name as its span
    # ends ("start" as the step begins), so a caller can time them with a
    # CUDA event there
    SPANS = ("fakes", "d_fwd_bwd", "d_adam", "g_fwd_bwd", "g_adam", "ema",
             "metrics")

    def __init__(self, config, sched_g, sched_d, g_names, d_names,
                 sharded=()):
        """``g_names`` / ``d_names``: the nets' parameter names in
        ``named_parameters`` order; ``sharded``: the names (of either
        net) this rank holds as model-parallel shards."""
        self.mark = None
        self.z_dim = config["z_dim"]
        self.num_classes = max(1, config.get("num_classes", 1))
        self.update_ratio = config.get("update_ratio", 1)
        loss = config.get("loss", "hinge_loss")
        self.gloss_fn, self.dloss_fn = get_loss(loss)
        self.is_hinge = loss == "hinge_loss"
        self.ema_decay = config.get("g_ema_decay", 0.0)
        self.ema_start = int(config.get("g_ema_start", 0))
        self.fuse_d = config.get("fuse_d_batches", True)
        self.summary_var = config.get("summary_var", True)
        self.random_flip = config.get("random_flip", False)
        self.accum = config.get("grad_accum_steps", 1)
        self.exact_accum_bn = self.accum > 1 and config.get("exact_accum_bn",
                                                            True)
        self.seed = config.get("seed", 0)
        # this rank's rows of each step's global draws: its data index's
        # (model peers draw the same)
        self.rank = config.get("data_index", config.get("process_index", 0))
        self.ranks = config.get("data_count", config.get("process_count", 1))
        # JAX's step under model parallelism is one GSPMD program, whose
        # micro-batches are the global batch's
        self.gspmd = config.get("model_parallel", 1) > 1
        self.sched_g, self.sched_d = sched_g, sched_d
        # per-variable metrics in the JAX order, and where each sits
        self.g_names, self.d_names = jax_order(g_names), jax_order(d_names)
        self._g_perm = [list(g_names).index(n) for n in self.g_names]
        self._d_perm = [list(d_names).index(n) for n in self.d_names]
        # where the shards sit among each net's parameters, and (under
        # model parallelism) the parameters every model peer holds whole
        self._g_sharded, self._d_sharded = (
            torch.tensor([i for i, n in enumerate(names) if n in sharded])
            if any(n in sharded for n in names) else None
            for names in (g_names, d_names))
        self._g_replicated, self._d_replicated = (
            [i for i, n in enumerate(names) if n not in sharded]
            if self.gspmd else None for names in (g_names, d_names))

    def rows(self, batch: int):
        """This rank's rows of a global batch whose ranks take ``batch``
        rows each: [r·B, (r+1)·B), r its data index, whose micro-batches
        are the rank's own (JAX's ``shard_map`` step); under model
        parallelism with accumulation, its share of each of the global
        batch's micro-batches, so the accumulated step is the one process
        step at the global batch, as JAX's GSPMD step is."""
        r, a = self.rank, self.accum
        if not (self.gspmd and a > 1):
            return slice(r * batch, (r + 1) * batch)
        total, micro = batch * self.ranks, batch // a
        return torch.cat([torch.arange(k * total // a + r * micro,
                                       k * total // a + (r + 1) * micro)
                          for k in range(a)])

    def latents(self, step: int, batch: int, device) -> dict:
        """The randomness of step ``step`` for a rank's batch ``batch``:
        ``{"flip": bool [B] or None, "d": [(z, labels)] per D update,
        "g": (z, labels)}``, this rank's :meth:`rows` of the draws of the
        global batch."""
        total = batch * self.ranks
        rows = self.rows(batch)
        if torch.is_tensor(rows):
            rows = rows.to(device)

        def draw(purpose):
            rng = seeded(device, self.seed, 1, step, purpose)
            z = torch.randn(total, self.z_dim, device=device, generator=rng)
            labels = torch.randint(0, self.num_classes, (total,),
                                   device=device, generator=rng)
            return z[rows], labels[rows]

        flip = None
        if self.random_flip:
            rng = seeded(device, self.seed, 1, step, _FLIP)
            flip = (torch.rand(total, device=device, generator=rng)
                    < 0.5)[rows]
        return {"flip": flip, "g": draw(_G),
                "d": [draw(_D + i) for i in range(self.update_ratio)]}

    def _d_health(self, out_real, out_fake) -> dict:
        """Mean D scores and the fractions of examples still giving D a
        gradient: inside the hinge margin, or, for BCE, with
        |sigmoid(logit) − target| above 1e-2."""
        r, f = out_real.detach().float(), out_fake.detach().float()
        if self.is_hinge:
            in_r, in_f = r < 1.0, f > -1.0
        else:
            in_r = torch.sigmoid(r) < 1.0 - 1e-2
            in_f = torch.sigmoid(f) > 1e-2
        return dict(zip(HEALTH_KEYS, (r.mean(), f.mean(),
                                      in_r.float().mean(),
                                      in_f.float().mean())))

    def _d_loss(self, disc, images, labels, fake, fake_labels):
        b = images.shape[0]
        if self.fuse_d:
            # real and fake share one forward: D has no batch-coupled
            # layer, so the math is that of two forwards
            out = disc(torch.cat([images.to(fake.dtype), fake]),
                       torch.cat([labels, fake_labels]))
            out_real, out_fake = out[:b], out[b:]
        else:
            out_real = disc(images, labels)
            out_fake = disc(fake, fake_labels)
        return (self.dloss_fn(out_real, out_fake),
                self._d_health(out_real, out_fake))

    def _mark(self, name: str) -> None:
        if self.mark is not None:
            self.mark(name)

    @contextlib.contextmanager
    def _phase(self, name: str):
        """One phase of the step: its span, then ``mark(name)``."""
        with span(name):
            yield
        self._mark(name)

    def _accumulated(self, nets, micro_step, micro: int):
        """``micro_step(sl)`` -> (loss, grads, health) on the batch slice
        ``sl``: at ``grad_accum_steps`` 1 once on the whole batch, else on
        each micro-batch of ``micro`` examples in turn, giving the means of
        the losses, the fp32 gradients and the health, with the BN layers
        of ``nets`` in accumulation mode when ``exact_accum_bn``."""
        if self.accum == 1:
            loss, grads, health = micro_step(slice(None))
            return loss.detach(), grads, health
        bns = [bn for net in nets for bn in bn_moment_paths(net)] \
            if self.exact_accum_bn else []
        saved = bn_accum_begin(bns)
        for a in range(self.accum):
            loss_a, grads_a, health_a = micro_step(
                slice(a * micro, (a + 1) * micro))
            if a == 0:
                loss, grads, health = loss_a.detach(), list(grads_a), health_a
            else:
                loss = loss + loss_a.detach()
                torch._foreach_add_(grads, grads_a)
                health = {k: health[k] + health_a[k] for k in health}
        bn_accum_finalize(bns, saved, self.accum)
        return (loss / self.accum, torch._foreach_div(grads, self.accum),
                {k: v / self.accum for k, v in health.items()})

    def one_step(self, state: TrainState, images_u8, labels, lat) -> dict:
        batch = images_u8.shape[0]
        if batch % self.accum:
            raise ValueError(f"grad_accum_steps={self.accum} must divide "
                             f"the global batch {batch}")
        micro = batch // self.accum
        self._mark("start")
        gen, disc = state.gen, state.disc
        g_params = [p for _, p in gen.named_parameters()]
        d_params = [p for _, p in disc.named_parameters()]
        images = images_u8.permute(0, 3, 1, 2).float() * (2.0 / 255.0) - 1.0
        if lat["flip"] is not None:
            images = torch.where(lat["flip"][:, None, None, None],
                                 images.flip(3), images)
        labels = labels.long()
        gen.train()
        disc.train()

        d_loss_acc = 0.0
        health_acc = dict.fromkeys(HEALTH_KEYS, 0.0)
        for i, (z, fake_labels) in enumerate(lat["d"]):
            def d_micro(sl, z=z, fake_labels=fake_labels):
                with self._phase("fakes"), torch.no_grad():
                    fake = gen(z[sl], fake_labels[sl])
                with self._phase("d_fwd_bwd"):
                    loss, health = self._d_loss(disc, images[sl], labels[sl],
                                                fake, fake_labels[sl])
                    grads = torch.autograd.grad(loss, d_params)
                return loss, grads, health

            loss_d, grads_d, health = self._accumulated((gen, disc), d_micro,
                                                        micro)
            with self._phase("d_adam"):
                grads_d = _mean_over_peers(grads_d, self._d_replicated)
                grads_d, loss_d, health = _mean_over_ranks(grads_d, loss_d,
                                                           health)
                _apply(state.opt_d, d_params, grads_d,
                       self.sched_d(state.step * self.update_ratio + i))
            d_loss_acc = d_loss_acc + loss_d
            health_acc = {k: health_acc[k] + health[k] for k in HEALTH_KEYS}

        z, fake_labels = lat["g"]

        def g_micro(sl):
            loss = self.gloss_fn(disc(gen(z[sl], fake_labels[sl]),
                                      fake_labels[sl]))
            return loss, torch.autograd.grad(loss, g_params), {}

        with self._phase("g_fwd_bwd"):
            loss_g, grads_g, _ = self._accumulated((gen, disc), g_micro,
                                                   micro)
            grads_g = _mean_over_peers(grads_g, self._g_replicated)
            grads_g, loss_g, _ = _mean_over_ranks(grads_g, loss_g, {})
        with self._phase("g_adam"):
            _apply(state.opt_g, g_params, grads_g, self.sched_g(state.step))

        with self._phase("ema"):
            if state.ema is not None:
                # fp32 decay and 1 − decay, as the JAX step computes them
                decay32 = torch.tensor(self.ema_decay if state.step >=
                                       self.ema_start else 0.0)
                decay, rest = float(decay32), float(1.0 - decay32)
                ema = [state.ema[name] for name, _ in gen.named_parameters()]
                with torch.no_grad():
                    torch._foreach_mul_(ema, decay)
                    torch._foreach_add_(ema, g_params, alpha=rest)

        with self._phase("metrics"):
            ratio = self.update_ratio
            # per-variable norms of the whole variables
            g_norms = _whole(torch.stack(torch._foreach_norm(grads_g)),
                             self._g_sharded, True)
            d_norms = _whole(torch.stack(torch._foreach_norm(grads_d)),
                             self._d_sharded, True)
            metrics = {"G_loss": loss_g, "D_loss": d_loss_acc / ratio,
                       "G_grad_norm": torch.linalg.vector_norm(g_norms),
                       "D_grad_norm": torch.linalg.vector_norm(d_norms)}
            metrics.update({k: v / ratio for k, v in health_acc.items()})
            if self.summary_var:
                means = _whole(torch.stack([p.detach().mean()
                                            for p in g_params]),
                               self._g_sharded, False)
                metrics["G_var_means"] = means[self._g_perm]
                metrics["G_grad_norms"] = g_norms[self._g_perm]
                metrics["D_grad_norms"] = d_norms[self._d_perm]
        state.step += 1
        return metrics

    def __call__(self, state: TrainState, images_k, labels_k,
                 latents_k=None) -> dict:
        """K steps on uint8 images [K, B, S, S, 3] and labels [K, B];
        ``latents_k`` (one :meth:`latents`-shaped dict per step) replaces
        the seeded draws."""
        with span("train_step"):
            per_step = []
            for k in range(images_k.shape[0]):
                with span("step", state.step):
                    lat = (latents_k[k] if latents_k is not None else
                           self.latents(state.step, images_k.shape[1],
                                        images_k.device))
                    per_step.append(self.one_step(state, images_k[k],
                                                  labels_k[k], lat))
            return {key: torch.stack([m[key] for m in per_step]).mean(0)
                    for key in per_step[0]}


def build_train_step(config, sched_g, sched_d, gen, disc) -> TrainStep:
    """The train step of ``config`` for these nets (whole, or sharded by
    ``parallel.sharding.shard_module``) and LR schedules."""
    return TrainStep(config, sched_g, sched_d,
                     [n for n, _ in gen.named_parameters()],
                     [n for n, _ in disc.named_parameters()],
                     {*sharding.sharded_axes(gen),
                      *sharding.sharded_axes(disc)})


def build_device_cache(ds, device, rows: int | None = None) -> tuple:
    """The dataset's decoded uint8 images [n, S, S, 3] and int32 labels
    [n] (``ds.materialized()``, this rank's shard) uploaded to ``device``
    once, zero-padded to ``rows`` records (JAX's per-host rule: every
    rank holds the largest shard's size; the index batches never reach
    the padding).  Under model parallelism across hosts it raises, as the
    JAX package's does."""
    if mesh.host_count() > 1 and mesh.model_size() > 1:
        raise ValueError("device_cache: multi-process + model_parallel"
                         " is not supported (use the host feed)")
    imgs, labels = ds.materialized()
    pad = (rows or len(labels)) - len(labels)
    if pad:
        imgs = np.concatenate([imgs, np.zeros((pad, *imgs.shape[1:]),
                                              imgs.dtype)])
        labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)])
    return (torch.from_numpy(imgs).to(device),
            torch.from_numpy(labels).to(device))


def model_parallel_routing(config: dict, announce: bool = True) -> None:
    """The JAX trainer's routing under model_parallel > 1 (its GSPMD
    step), in ``config`` in place: ``use_pallas_sn`` dropped, with JAX's
    message when it was on (and ``announce``): the weight is model-sharded,
    and the plain SN keeps it so.  JAX's ``pallas_partitioned`` needs
    nothing here (each rank's attention takes its own rows), and the key
    is accepted as every config key is."""
    if config.get("model_parallel", 1) > 1:
        if config.get("use_pallas_sn") and announce:
            print("model_parallel > 1: SN stays on the XLA backend "
                  "(the weight operand is model-sharded; a fused "
                  "single-shard kernel would gather it)", flush=True)
        config.pop("use_pallas_sn", None)


class Trainer:
    """Config-driven trainer, the JAX ``Trainer``'s config contract, on
    ``device`` (``cuda`` by default; raises without a card)."""

    def __init__(self, config: dict, device: str | torch.device = "cuda"):
        self.primary = mesh.process_index() == 0
        self.device = resolve_device(device)
        # fp32 products stay fp32, as the JAX layers ask for HIGHEST
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh.make_grid(config.get("model_parallel", 1))   # every rank
        # the grid decides the shard and the rows a rank takes
        self.ds_train, self.config = get_dataset_and_info(
            {**config, "data_index": mesh.data_index(),
             "data_count": mesh.data_count()})
        config = self.config
        # the ranks of rank 0's model group join its sample grids' gathers
        self.grid_rank = mesh.data_index() == 0
        model_parallel_routing(config, announce=self.primary)
        n = mesh.data_count()
        if config["global_batch_size"] % n:
            raise ValueError(
                f"global_batch_size {config['global_batch_size']} not "
                f"divisible by the {n}-wide data axis")
        self.steps_per_call = max(1, config.get("steps_per_call", 1))
        self.steps_per_epoch = (self.ds_train.steps_per_epoch //
                                self.steps_per_call) * self.steps_per_call
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"no full training call per epoch: dataset provides "
                f"{self.ds_train.steps_per_epoch} steps/epoch (batch "
                f"{self.ds_train.batch_size}) but steps_per_call="
                f"{self.steps_per_call}; lower steps_per_call/batch_size "
                f"or add data")
        print("total steps:", self.steps_per_epoch * config["epoch"])

        seed = config.get("seed", 0)
        gen = get_generator(config, rng=seeded("cpu", seed, 0, _INIT_G))
        disc = get_discriminator(config, rng=seeded("cpu", seed, 0, _INIT_D))
        gen.to(self.device).train()
        disc.to(self.device).train()
        # this rank's shards of the wide weights (none at m = 1)
        self.g_axes = sharding.shard_module(gen)
        self.d_axes = sharding.shard_module(disc)
        (opt_g, self.sched_g), (opt_d, self.sched_d) = make_gan_optimizers(
            config, gen.parameters(), disc.parameters(),
            self.steps_per_epoch)
        ema = None
        if config.get("g_ema_decay", 0.0) > 0:
            ema = {n: p.detach().clone() for n, p in gen.named_parameters()}
        self.state = TrainState(gen, disc, opt_g, opt_d, 0, ema)
        self.train_step = build_train_step(config, self.sched_g,
                                           self.sched_d, gen, disc)
        if config.get("print_variables", True):
            for tag, names in (("G", self.train_step.g_names),
                               ("D", self.train_step.d_names)):
                print(f"{tag} trainable variables ({len(names)}):")
                for n in names:
                    print(f"  {tag}/{n.replace('.', '/')}")

        # fixed latents of the sample grids
        rng = seeded("cpu", seed, 0, _FIXED)
        num_sample = config.get("num_sample", 16)
        self.fixed_z = torch.randn(num_sample, config["z_dim"],
                                   generator=rng).to(self.device)
        self.fixed_labels = torch.randint(
            0, max(1, config.get("num_classes", 1)), (num_sample,),
            generator=rng).to(self.device)
        self._gen_eval = None

        self.writer = (SummaryWriter(config["log_dir"])
                       if config.get("log_dir") and self.primary else None)
        self.ckpt_mgr = None
        if config.get("ckpt_dir"):
            self.ckpt_mgr = CheckpointManager(config["ckpt_dir"],
                                              max_to_keep=10)
            restored = self.ckpt_mgr.restore_latest()
            if restored is not None:
                self._load(restored)
                print(f"Restored from checkpoint at step {self.state.step}")
            else:
                print("Initializing from scratch.")
        self._preempted = False
        self._device_data = None
        self._device_cache_checked = False

    # -- state ---------------------------------------------------------------
    def global_step(self) -> int:
        return self.state.step

    def _names(self) -> tuple:
        return tuple([n for n, _ in net.named_parameters()]
                     for net in (self.state.gen, self.state.disc))

    def checkpoint_payload(self) -> dict:
        """The whole training state (shards gathered over the model group:
        every model peer calls it), in the format of m = 1."""
        s = self.state
        ga, da = self.g_axes, self.d_axes
        g_names, d_names = self._names()
        return {"step": s.step, "gen": sharding.whole(s.gen.state_dict(), ga),
                "disc": sharding.whole(s.disc.state_dict(), da),
                "opt_g": sharding.whole_optimizer(s.opt_g.state_dict(),
                                                  g_names, ga),
                "opt_d": sharding.whole_optimizer(s.opt_d.state_dict(),
                                                  d_names, da),
                "ema": None if s.ema is None else sharding.whole(s.ema, ga),
                "meta": {k: self.config[k] for k in META_KEYS}}

    def _load(self, ckpt: dict) -> None:
        """Restore a whole checkpoint (written at any m), each rank taking
        its slices."""
        s = self.state
        ga, da = self.g_axes, self.d_axes
        g_names, d_names = self._names()
        s.gen.load_state_dict(sharding.local(ckpt["gen"], ga))
        s.disc.load_state_dict(sharding.local(ckpt["disc"], da))
        s.opt_g.load_state_dict(sharding.local_optimizer(ckpt["opt_g"],
                                                         g_names, ga))
        s.opt_d.load_state_dict(sharding.local_optimizer(ckpt["opt_d"],
                                                         d_names, da))
        s.step = int(ckpt["step"])
        if s.ema is not None:
            s.ema = {n: t.to(self.device)
                     for n, t in sharding.local(ckpt["ema"], ga).items()}

    def eval_generator(self):
        """G for evaluation, in eval mode: the EMA parameters when tracked
        (else the live ones) with the live SN and BN buffers."""
        if self._gen_eval is None:
            self._gen_eval = copy.deepcopy(self.state.gen).eval()
        source = dict(self.state.gen.state_dict())
        if self.state.ema is not None:
            source.update(self.state.ema)
        with torch.no_grad():
            for name, t in self._gen_eval.state_dict().items():
                t.copy_(source[name])
        return self._gen_eval

    def sample_images(self) -> np.ndarray:
        """The fixed-latent sample grid's images, float [n, S, S, 3] in
        [-1, 1] (under model parallelism every model peer calls it)."""
        gen = self.eval_generator()
        with torch.inference_mode():
            x = gen(self.fixed_z, self.fixed_labels).float()
        return x.permute(0, 2, 3, 1).cpu().numpy()

    def _histograms(self) -> dict:
        """Each variable's values, whole, for the histograms (every model
        peer calls it)."""
        out = {}
        for tag, net, axes in (("G", self.state.gen, self.g_axes),
                               ("D", self.state.disc, self.d_axes)):
            params = sharding.whole({n: p.detach()
                                     for n, p in net.named_parameters()},
                                    axes)
            out.update({f"hist/{tag}/{n.replace('.', '/')}":
                        p.float().cpu().numpy().ravel()
                        for n, p in params.items()})
        return out

    def _var_summaries(self, prefix: str, values) -> dict:
        return {f"{prefix}/G/{n.replace('.', '/')}": float(v)
                for n, v in zip(self.train_step.g_names, values)}

    # -- feed ------------------------------------------------------------------
    def _maybe_build_device_cache(self) -> None:
        """Upload the whole uint8 dataset to the device once and feed index
        batches (``device_cache``): True, False, or "auto" (the default),
        which takes it when the dataset has ``epoch_index_batches`` (the
        TFRecord loader), caches in RAM (the index schedule is the cached
        feed's; the streaming one shuffles otherwise) and fits
        ``device_cache_budget_mb`` (2048); True raises where "auto"
        declines.  The gathered batches are the host feed's, byte for
        byte."""
        if self._device_cache_checked:
            return
        self._device_cache_checked = True
        config = self.config
        mode = config.get("device_cache", "auto")
        if not mode:
            return
        ds = self.ds_train
        if not hasattr(ds, "epoch_index_batches"):
            if mode is True:
                raise ValueError(
                    "device_cache=True needs the TFRecord dataset path "
                    "(the augmenting image-folder loader re-draws images "
                    "every epoch and cannot be frozen into a cache)")
            return
        if not getattr(ds, "cache_in_memory", False):
            if mode is True:
                raise ValueError(
                    "device_cache=True conflicts with cache_dataset="
                    "False: the index schedule reproduces the CACHED "
                    "host feed (Fisher-Yates per epoch); the uncached "
                    "host feed uses the streaming-buffer shuffle, a "
                    "different schedule, so enabling both would break "
                    "exact resume against it")
            return
        if mesh.host_count() > 1 and mesh.model_size() > 1:
            if mode is True:
                raise ValueError("device_cache with model_parallel is "
                                 "single-process only (use the host feed "
                                 "for multi-host GSPMD runs)")
            return
        budget = config.get("device_cache_budget_mb", 2048) * (1 << 20)
        # every rank holds the largest shard's size (agreed by all)
        rows = mesh.all_reduce_max(len(ds.materialized()[1]))
        est = rows * ds.img_size * ds.img_size * 3
        if est > budget:
            if mode is True:
                raise ValueError(
                    f"device_cache=True but the (padded) local shard is "
                    f"~{est >> 20} MB"
                    f" > device_cache_budget_mb={budget >> 20}")
            return
        self._device_data = build_device_cache(ds, self.device, rows)
        imgs, labels = ds.materialized()
        shard = (f" (this rank's shard, padded to {rows})"
                 if mesh.distributed() else "")
        print(f"device cache: {imgs.nbytes >> 20} MB uploaded to "
              f"{self.device} ({len(labels)} records{shard}); feeding index "
              f"batches", flush=True)

    def feed(self) -> str:
        """Where the batches come from: "device-cache" or "host", and the
        reader that decoded them."""
        where = "host" if self._device_data is None else "device-cache"
        return f"{where}/{self.ds_train.reader}"

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _gathered(self, arrays: tuple) -> tuple:
        """A call's (images [K, B, S, S, 3], labels [K, B]): as sent, or,
        from the device cache, gathered by its index batch [K, B]."""
        if self._device_data is None:
            return arrays
        (idx,) = arrays
        imgs, labels = self._device_data
        flat = idx.reshape(-1)
        return (imgs.index_select(0, flat).view(*idx.shape, *imgs.shape[1:]),
                labels.index_select(0, flat).view(idx.shape))

    def _device_batches(self, epoch: int, skip_calls: int = 0):
        """(uint8 images [K, B, S, S, 3], int32 labels [K, B]) on the
        device, sent one call ahead of the consumer (with the device cache,
        only the int32 indices are sent, and a call's batch is gathered as
        it is taken); the first ``skip_calls`` calls of the epoch are
        skipped on the host (mid-epoch resume)."""
        K = self.steps_per_call
        cached = self._device_data is not None

        def packed():
            source = (self.ds_train.epoch_index_batches(epoch) if cached
                      else self.ds_train.epoch(epoch))
            pack = []
            for item in source:
                pack.append(item)
                if len(pack) == K:
                    yield ((np.stack(pack),) if cached else
                           tuple(np.stack(a) for a in zip(*pack)))
                    pack = []

        host = itertools.islice(packed(), skip_calls, None)

        def sent():
            # the next call's host batch on its way to the device (None
            # past the epoch's end)
            item = next(host, None)
            return (None if item is None else
                    tuple(self._to_device(a) for a in item))

        pending = None
        for call in itertools.count():
            # one span a call, closed before its yield
            with span("feed"):
                ready = pending if call else sent()
                if ready is None:
                    return
                pending = sent()
                batch = self._gathered(ready)
            yield batch
            if pending is None:
                return

    # -- loop ------------------------------------------------------------------
    def _install_preemption_handler(self) -> dict:
        """Save-and-exit on SIGTERM/SIGINT: the flag is read after each
        call; a second signal reaches the previous handler."""
        previous = {}

        def handler(signum, _frame):
            print(f"received signal {signum}: will checkpoint and stop "
                  f"after the current step (signal again to force-quit)",
                  flush=True)
            self._preempted = True
            _restore_handlers(previous)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                pass
        return previous

    def train(self, num_epochs: int | None = None):
        num_epochs = num_epochs or self.config["epoch"]
        start_epoch = self.global_step() // self.steps_per_epoch
        if start_epoch >= num_epochs:
            print(f"training already complete (step {self.global_step()}, "
                  f"epoch {start_epoch}/{num_epochs})", flush=True)
            return
        self._maybe_build_device_cache()
        self._preempted = False
        previous = self._install_preemption_handler()
        try:
            self._train_epochs(start_epoch, num_epochs)
        finally:
            _restore_handlers(previous)

    def _fetch(self, metrics: dict) -> dict:
        """Metrics on the host (a synchronisation point)."""
        return {k: v.detach().cpu().numpy() for k, v in metrics.items()}

    def _train_epochs(self, start_epoch: int, num_epochs: int) -> None:
        config = self.config
        K = self.steps_per_call
        summary_freq = max(1, config.get("summary_step_freq", 100) // K)
        img_dir = config.get("img_dir")
        fid_freq = config.get("fid_epoch_freq", 0)
        tracer = (TraceWindow(config["profile_dir"], start=10, stop=20,
                              device=self.device)
                  if config.get("profile_dir") and self.primary else None)
        resume_skip = (self.global_step() % self.steps_per_epoch) // K
        if resume_skip:
            print(f"resuming mid-epoch: skipping {resume_skip} consumed "
                  f"calls of epoch {start_epoch}", flush=True)
        for epoch in range(start_epoch, num_epochs):
            t0 = time.perf_counter()
            count, acc, acc_n, acc_last = 0, {}, 0, -1
            timer = StepTimer()
            timer.start()
            timer_last = 0
            skip = resume_skip if epoch == start_epoch else 0
            metrics = None
            for images, labels in self._device_batches(epoch, skip):
                if tracer and epoch == start_epoch:
                    tracer.step(count)   # calls [10, 20) of the first epoch
                metrics = self.train_step(self.state, images, labels)
                count += 1
                if self._stop_requested():
                    if tracer:
                        tracer.close()
                    self._save_on_preemption()
                    return
                if count % summary_freq == 0:
                    fetched = self._fetch(metrics)
                    timer.tick((count - timer_last) * K)
                    timer_last = count
                    self._summarize_step(fetched, acc)
                    acc_n += 1
                    acc_last = count
            if tracer:
                tracer.close()
            if count == 0:
                raise RuntimeError("epoch produced no batches: data_size/"
                                   "global_batch too small for one call")
            fetched = self._fetch(metrics)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            epoch_time = time.perf_counter() - t0
            timer.tick((count - timer_last) * K)
            grad_norms = fetched.pop("G_grad_norms", None)
            fetched.pop("D_grad_norms", None)
            fetched.pop("G_var_means", None)
            if acc_last != count:   # the last call was not summarized yet
                for k, v in fetched.items():
                    acc[k] = acc.get(k, 0.0) + float(v)
                acc_n += 1
            mean = {k: v / acc_n for k, v in acc.items()}
            step = self.global_step()
            step_ms = 1000.0 * epoch_time / (count * K)
            imgs_per_sec = count * K * config["global_batch_size"] / \
                epoch_time
            histograms = (self._histograms() if self.grid_rank
                          and config.get("log_dir")
                          and config.get("summary_histograms") else None)
            if self.writer:
                scalars = {
                    "generator_loss": mean["G_loss"],
                    "discriminator_loss": mean["D_loss"],
                    "G_grad_norm": mean["G_grad_norm"],
                    "D_grad_norm": mean["D_grad_norm"],
                    "epoch_time_sec": epoch_time,
                    "step_time_ms": step_ms,
                    "step_time_exec_ms": timer.mean_ms(),
                    "lr_g": self.sched_g(step),
                    "lr_d": self.sched_d(step * config.get("update_ratio",
                                                           1)),
                }
                if grad_norms is not None:
                    scalars.update(self._var_summaries("grads_norm",
                                                       grad_norms))
                self.writer.scalars(scalars, epoch)
                if histograms:
                    # each variable's distribution of values
                    self.writer.histograms(histograms, epoch)
                self.writer.flush()
            if self.primary:
                print(f"epoch {epoch}: G_loss={mean['G_loss']:.4f} "
                      f"D_loss={mean['D_loss']:.4f} "
                      f"D(real)={mean['D_real_mean']:+.2f} "
                      f"D(fake)={mean['D_fake_mean']:+.2f} "
                      f"in_margin={mean['D_real_in_margin']:.2f}/"
                      f"{mean['D_fake_in_margin']:.2f} feed={self.feed()} "
                      f"time={epoch_time:.1f}s "
                      f"({imgs_per_sec:.1f} imgs/s, {step_ms:.2f} ms/step)",
                      flush=True)
            # checkpoints at epoch 5, then every 10th, and the last
            if self.ckpt_mgr and (epoch == 5 or (epoch and epoch % 10 == 0)
                                  or epoch == num_epochs - 1):
                self.ckpt_mgr.save(step, self.checkpoint_payload())
            # sample grids in the first 5 epochs, every 5th, and the last
            if img_dir and self.grid_rank and (epoch < 5 or epoch % 5 == 0
                                               or epoch == num_epochs - 1):
                grid = self.sample_images()
                if self.primary:
                    save_image_grid(grid, os.path.join(
                        img_dir, f"epoch_{epoch:04d}.png"))
                if self.writer:
                    self.writer.image("sample", make_grid(grid), step)
                    self.writer.flush()
            if fid_freq and (epoch + 1) % fid_freq == 0:
                self._evaluate(epoch, step)

    def _evaluate(self, epoch: int, step: int) -> None:
        """The FID epoch: FID of the evaluation G against the training
        data and, with ``inception_score``, its IS, printed and written
        at ``step`` under tags that name the backend actually used (the
        proxy's are "proxy_FID" and "proxy_IS": its scale is not that of
        published FIDs).  Under a group every process computes its own
        shard's FID (JAX's rule) and process 0 reports its own."""
        config = self.config
        extractor = get_extractor(config, self.device)
        fid_tag = "FID" if extractor.backend == "inception" else "proxy_FID"
        fid = compute_fid_for_trainer(self, extractor=extractor)
        if self.primary:
            print(f"epoch {epoch}: {fid_tag} = {fid:.2f}", flush=True)
        if self.writer:
            self.writer.scalar(fid_tag, fid, step)
            self.writer.flush()
        if config.get("inception_score"):
            classifier = get_classifier(config, self.device)
            is_tag = "IS" if classifier.backend == "inception" else "proxy_IS"
            is_mean, is_std = inception_score_for_trainer(
                self, classifier=classifier)
            if self.primary:
                print(f"epoch {epoch}: {is_tag} = {is_mean:.2f} ± "
                      f"{is_std:.2f}", flush=True)
            if self.writer:
                self.writer.scalar(is_tag, is_mean, step)
                self.writer.flush()

    def _summarize_step(self, fetched: dict, acc: dict) -> None:
        """Accumulate a summary point's scalars for the epoch mean and
        write them, the variable means and a sample grid to TensorBoard."""
        var_means = fetched.get("G_var_means")
        scalars = {k: float(v) for k, v in fetched.items() if v.ndim == 0}
        for k, v in scalars.items():
            acc[k] = acc.get(k, 0.0) + v
        grid = (self.sample_images() if self.grid_rank
                and self.config.get("log_dir") else None)
        if self.writer:
            step = self.global_step()
            self.writer.scalars({f"step/{k}": v for k, v in scalars.items()},
                                step)
            if var_means is not None:
                self.writer.scalars(self._var_summaries("vars", var_means),
                                    step)
            self.writer.image("sample", make_grid(grid), step)
            self.writer.flush()

    def _stop_requested(self) -> bool:
        """Whether a signal asked this process, or under a group any rank,
        to stop: the ranks agree on it after every call, so all stop after
        the same call."""
        if mesh.distributed():
            self._preempted = bool(mesh.all_reduce_max(int(self._preempted)))
        return self._preempted

    def _save_on_preemption(self) -> None:
        step = self.global_step()
        if self.ckpt_mgr:
            mesh.barrier()
            self.ckpt_mgr.save(step, self.checkpoint_payload())
            print(f"preempted at step {step}: checkpoint saved, exiting",
                  flush=True)
        else:
            print(f"preempted at step {step}: no ckpt_dir configured, "
                  f"exiting without saving", flush=True)


def _restore_handlers(previous: dict) -> None:
    for sig, h in previous.items():
        signal.signal(sig, h)
