"""Data parallelism in the port (``sagan_tpu_torch/parallel/mesh.py`` and
what uses it) on the CPU, with real gloo ranks:

* cross-replica BN (plain, conditional, accumulation mode) against JAX's
  BN under ``shard_map`` on a 2-device mesh (``_batch_moments`` pmeans the
  moments), and against one process at the global batch;
* two ranks at batch B against one process at 2B (the rank takes its rows
  of the global draws), and against JAX's ``build_train_step`` on
  ``make_mesh(2)`` from the same init with each replica fed JAX's latents;
* the loader's per-host shards against JAX's for both sharding rules and
  the image folder, in process;
* JAX's uneven 3-files-over-2-hosts epoch: both ranks take
  ``steps_per_epoch`` steps, and the device cache and the host feed give
  the same state bit for bit; a rank-0 checkpoint, restored on both
  ranks, resumes as an unbroken run;
* FID's per-process cache key, and ``GeneratorService`` on two devices
  against one device and JAX's server at ``num_devices`` 2.

The rank worker is this file run as a script (``python
tests/test_torch_parallel.py <jobs> <rank> <world> <port>``), so no JAX
import reaches a rank: JAX is imported inside the tests only.  A group of
ranks starts once per module fixture and runs every job of it.

Tolerances: against one process at the global batch, the first call's
losses and gradient norms within 1e-5 relative and the state after every
call within 3 · lr_d (Adam with β1 = 0 moves an element whose gradient is
~0 by ±lr, and a later step's metrics follow such moves;
test_torch_train_step gives the reasons); against JAX,
test_torch_train_step's limits; BN 1e-5; the two ranks' states are equal
bit for bit.
"""

import contextlib
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sagan_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from sagan_tpu_torch.models import (get_discriminator,  # noqa: E402
                                    get_generator)
from sagan_tpu_torch.nn.layers import (BatchNorm,  # noqa: E402
                                       ConditionalBatchNorm, bn_accum_begin,
                                       bn_accum_finalize)
from sagan_tpu_torch.parallel import mesh  # noqa: E402
from sagan_tpu_torch.train.optim import make_gan_optimizers  # noqa: E402
from sagan_tpu_torch.train.trainer import (TrainState,  # noqa: E402
                                           Trainer, build_train_step)
from sagan_tpu_torch.utils.config import resolve_config  # noqa: E402

RANK_TIMEOUT = 180   # seconds a group of ranks may take
BN_TOL = 1e-5
STEP_RTOL = 1e-5
BN_C, BN_CLASSES = 6, 5
STEP_CONFIG = {
    "dataset": "synthetic", "data_path": "unused", "model": "vanilla",
    "z_dim": 32, "gf_dim": 8, "df_dim": 8, "img_size": 32,
    "num_classes": 1, "use_attention": True, "attn_dim_G": [16],
    "attn_dim_D": [8], "use_label": False, "batch_size": 4,
    "num_devices": None, "loss": "hinge_loss", "lr_g": 2e-4, "lr_d": 7e-4,
    "decay_rate": 0.99, "compute_dtype": "float32", "g_ema_decay": 0.9,
    "g_ema_start": 1, "seed": 0,
}
RESNET = {"model": "resnet", "use_label": True, "num_classes": 4,
          "use_cond_bn": True, "lr_g": 2.5e-6, "lr_d": 1e-5}
COND = {"use_label": True, "num_classes": 4, "use_cond_bn": True}
SCALARS = ("G_loss", "D_loss", "G_grad_norm", "D_grad_norm", "D_real_mean",
           "D_fake_mean", "D_real_in_margin", "D_fake_in_margin")


# -- the rank worker ---------------------------------------------------------
def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def run_bn(job, rank=0, world=1) -> dict:
    """A (conditional) BN in training mode on this rank's rows of the
    job's x: the output, the gradients of sum(y · w) in x, gamma and beta
    (the rank's own terms), and the running stats after; in accumulation
    mode over two micro-batches, finalized."""
    b = len(job["x"]) // world
    rows = slice(rank * b, (rank + 1) * b)
    bn = (ConditionalBatchNorm(BN_C, BN_CLASSES) if job["cond"]
          else BatchNorm(BN_C)).train()
    with torch.no_grad():
        for name in ("gamma", "beta", "mean", "var"):
            getattr(bn, name).copy_(torch.from_numpy(job[name]))
    x, w = _nchw(job["x"][rows]), _nchw(job["w"][rows])
    labels = torch.from_numpy(job["labels"][rows])
    micro = 2 if job["accum"] else 1
    saved = bn_accum_begin([bn]) if job["accum"] else None
    out = {"y": [], "gx": [], "gamma": 0.0, "beta": 0.0}
    size = b // micro
    for sl in (slice(i * size, (i + 1) * size) for i in range(micro)):
        xm = x[sl].clone().requires_grad_()
        y = bn(xm, labels[sl]) if job["cond"] else bn(xm)
        gx, gg, gb = torch.autograd.grad((y * w[sl]).sum(),
                                         (xm, bn.gamma, bn.beta))
        out["y"].append(_nhwc(y))
        out["gx"].append(_nhwc(gx))
        out["gamma"] = out["gamma"] + gg.numpy()
        out["beta"] = out["beta"] + gb.numpy()
    if job["accum"]:
        bn_accum_finalize([bn], saved, micro)
    out["y"], out["gx"] = np.concatenate(out["y"]), np.concatenate(out["gx"])
    out["mean"], out["var"] = bn.mean.numpy(), bn.var.numpy()
    return out


def _torch_latents(lat: dict) -> dict:
    def pair(p):
        return torch.from_numpy(p[0]), torch.from_numpy(p[1]).long()

    return {"flip": (None if lat["flip"] is None
                     else torch.from_numpy(lat["flip"])),
            "g": pair(lat["g"]), "d": [pair(p) for p in lat["d"]]}


def run_steps(job, rank=0, world=1) -> dict:
    """``job["calls"]`` calls of the port's train step on this rank's rows
    of the global batches from the job's init; the latents are the
    seeded draws, or this rank's ``job["latents"]``.  Returns each call's
    metrics and the state after."""
    config = dict(job["config"])
    config["batch_size"] = config["batch_size"] * job["ranks"] // world
    cfg = resolve_config(config)
    gen, disc = get_generator(cfg), get_discriminator(cfg)
    gen.load_state_dict({k: torch.from_numpy(v)
                         for k, v in job["gen"].items()})
    disc.load_state_dict({k: torch.from_numpy(v)
                          for k, v in job["disc"].items()})
    (opt_g, sched_g), (opt_d, sched_d) = make_gan_optimizers(
        cfg, gen.parameters(), disc.parameters(), 1)
    state = TrainState(gen, disc, opt_g, opt_d, 0,
                       {n: p.detach().clone()
                        for n, p in gen.named_parameters()})
    step = build_train_step(cfg, sched_g, sched_d, gen, disc)
    b = cfg["batch_size"]
    rows = slice(rank * b, (rank + 1) * b)
    metrics = []
    for call, (images, labels) in enumerate(zip(job["images"],
                                                job["labels"])):
        latents = None
        if job.get("latents") is not None:
            latents = [_torch_latents(lat)
                       for lat in job["latents"][rank][call]]
        m = step(state, torch.from_numpy(images[:, rows]),
                 torch.from_numpy(labels[:, rows]), latents)
        metrics.append({k: v.numpy() for k, v in m.items()})
    return {"metrics": metrics, "step": state.step,
            "gen": {k: v.numpy().copy()
                    for k, v in gen.state_dict().items()},
            "disc": {k: v.numpy().copy()
                     for k, v in disc.state_dict().items()},
            "ema": {k: v.numpy().copy() for k, v in state.ema.items()}}


def _digest(trainer) -> dict:
    s = trainer.state
    return {"step": s.step,
            **{f"gen.{k}": v.numpy().copy()
               for k, v in s.gen.state_dict().items()},
            **{f"disc.{k}": v.numpy().copy()
               for k, v in s.disc.state_dict().items()}}


def _trainer(job, **overrides) -> Trainer:
    return Trainer(resolve_config({**job["config"], **overrides}), "cpu")


def run_trainer(job, rank=0, world=1) -> dict:
    """The uneven epoch on the host feed and on the device cache, with
    the calls each rank took; then 2 epochs with a checkpoint (written by
    rank 0), a restart that restores it on every rank and trains a 3rd,
    and an unbroken 3-epoch run."""
    out = {}
    for feed, cache in (("host", False), ("cache", True)):
        trainer = _trainer(job, device_cache=cache, epoch=1)
        step_fn, calls = trainer.train_step, []

        def counted(*args, step_fn=step_fn, calls=calls):
            calls.append(1)
            return step_fn(*args)

        trainer.train_step = counted
        trainer.train()
        out[feed] = _digest(trainer)
        out[f"{feed}_calls"] = len(calls)
        out[f"{feed}_steps_per_epoch"] = trainer.steps_per_epoch
        out[f"{feed}_feed"] = trainer.feed()
    ckpt = job["ckpt_dir"]
    _trainer(job, ckpt_dir=ckpt, epoch=2).train()
    mesh.barrier()
    out["saved"] = sorted(os.listdir(ckpt))
    resumed = _trainer(job, ckpt_dir=ckpt, epoch=3)
    out["restored_step"] = resumed.global_step()
    resumed.train()
    out["resumed"] = _digest(resumed)
    unbroken = _trainer(job, epoch=3)
    unbroken.train()
    out["unbroken"] = _digest(unbroken)
    return out


RUNNERS = {"bn": run_bn, "steps": run_steps, "trainer": run_trainer}


def _worker(jobs_path: str, rank: int, world: int, port: int) -> None:
    torch.set_num_threads(1)
    mesh.initialize_distributed("gloo", f"tcp://127.0.0.1:{port}", world,
                                rank)
    try:
        with open(jobs_path, "rb") as f:
            jobs = pickle.load(f)   # written by the test that started us
        results = [RUNNERS[job["kind"]](job, rank, world) for job in jobs]
        with open(f"{jobs_path}.{rank}", "wb") as f:
            pickle.dump(results, f)
    finally:
        mesh.shutdown_distributed()


# -- the parent --------------------------------------------------------------
@contextlib.contextmanager
def _one_thread():
    """Torch on one thread, as in the ranks: the reference runs are tiny,
    and the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(jobs: list, workdir, world: int = 2) -> list:
    """Run ``jobs`` on ``world`` gloo ranks; each rank's list of results."""
    path = os.path.join(str(workdir), "jobs.pkl")
    with open(path, "wb") as f:
        pickle.dump(jobs, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), path, str(rank),
         str(world), str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    results = []
    for rank in range(world):
        with open(f"{path}.{rank}", "rb") as f:
            results.append(pickle.load(f))   # written by our own ranks
    return results


def _bn_job(cond: bool, accum: bool) -> dict:
    rs = np.random.RandomState(11)
    n = 8
    return {"kind": "bn", "cond": cond, "accum": accum,
            "x": (2.0 * rs.randn(n, 3, 3, BN_C) + 0.5).astype(np.float32),
            "w": rs.randn(n, 3, 3, BN_C).astype(np.float32),
            "labels": rs.randint(0, BN_CLASSES, n),
            "gamma": (1.0 + 0.2 * rs.randn(*((BN_CLASSES, BN_C) if cond
                                            else (BN_C,)))).astype(
                np.float32),
            "beta": (0.1 * rs.randn(*((BN_CLASSES, BN_C) if cond
                                      else (BN_C,)))).astype(np.float32),
            "mean": np.full(BN_C, 0.3, np.float32),
            "var": np.full(BN_C, 2.0, np.float32)}


BN_CASES = {"plain": (False, False), "cond": (True, False),
            "accum": (False, True), "accum_cond": (True, True)}
# (update_ratio, steps_per_call, calls, options) of the port-only cases
STEP_CASES = {
    "vanilla": (1, 1, 2, {}),
    "vanilla_ratio2_call2": (2, 2, 1, {}),
    "flip_bce_unfused": (1, 1, 2, {"fuse_d_batches": False,
                                   "random_flip": True,
                                   "loss": "cross_entropy"}),
    "cond": (1, 1, 2, COND),
    "resnet": (2, 1, 2, RESNET),
    "resnet_pallas_sn": (2, 1, 2, {**RESNET, "use_pallas_sn": True}),
}
# the case held against JAX's 2-device step: conditional BN, two D updates
# and accumulation (a rank's micro-batches are its own rows, as a JAX
# replica's are, which one process at the global batch would cut
# otherwise; plain BN is held against JAX above).  One step: after it the
# states agree within 3e-6, but a second step's Adam update (β1 = 0) turns
# noise-level first gradients into lr-scale moves (on the vanilla config
# JAX's 2-device step and the two ranks then read attn16.sigma's gradient
# norm, 1.6e-3, 1.2e-6 apart, past test_torch_train_step's limit)
JAX_CASES = {"cond_ratio2_accum2": (2, 1, 1, {**COND,
                                              "grad_accum_steps": 2})}


def _with_sigma(sd: dict) -> dict:
    """The state dict with every attention gate ``sigma`` at 0.5 (0 at
    init leaves theta/phi/g without a gradient)."""
    return {k: (np.full_like(v, 0.5) if k.endswith(".sigma") else v)
            for k, v in sd.items()}


def _step_job(update_ratio, steps_per_call, calls, options, ranks=2,
              init=None, latents=None) -> dict:
    cfg = dict(STEP_CONFIG, update_ratio=update_ratio,
               steps_per_call=steps_per_call, **options)
    if init is None:
        pcfg = resolve_config(cfg)
        init = tuple(_with_sigma({k: v.numpy() for k, v in net(
            pcfg, rng=torch.Generator().manual_seed(seed)).state_dict()
            .items()}) for net, seed in ((get_generator, 1),
                                         (get_discriminator, 2)))
    rs = np.random.RandomState(7)
    batch = cfg["batch_size"] * ranks
    shape = (calls, steps_per_call, batch)
    return {"kind": "steps", "config": cfg, "ranks": ranks,
            "gen": init[0], "disc": init[1], "latents": latents,
            "images": rs.randint(0, 256, shape + (32, 32, 3)).astype(
                np.uint8),
            "labels": rs.randint(0, cfg["num_classes"], shape).astype(
                np.int32)}


def _jax_replica_latents(key, step, batch, cfg, replica) -> dict:
    """JAX's train-step draws of replica ``replica`` (its key path:
    fold_in(rng, step), fold_in(., axis_index), split 3 -> flip, d, g;
    D update i from fold_in(d, i)), as numpy."""
    import jax
    import jax.numpy as jnp

    key = jax.random.fold_in(jax.random.fold_in(key, step), replica)
    flip_key, d_key, g_key = jax.random.split(key, 3)
    flip = None
    if cfg.get("random_flip"):
        flip = np.array(jax.random.bernoulli(
            flip_key, 0.5, (batch, 1, 1, 1))).reshape(batch)

    def sample(k):
        kz, kl = jax.random.split(k)
        return (np.array(jax.random.normal(kz, (batch, cfg["z_dim"]),
                                           jnp.float32)),
                np.array(jax.random.randint(kl, (batch,), 0,
                                            cfg["num_classes"])))

    return {"flip": flip, "g": sample(g_key),
            "d": [sample(jax.random.fold_in(d_key, i))
                  for i in range(cfg["update_ratio"])]}


def _jax_setup(update_ratio, steps_per_call, calls, options):
    """JAX's init (attention sigma 0.5), converted for the port, and the
    step job whose ranks take JAX's per-replica latents."""
    import jax

    from sagan_tpu.models import get_discriminator as jax_discriminator
    from sagan_tpu.models import get_generator as jax_generator
    from sagan_tpu.utils.config import resolve_config as jax_resolve
    from sagan_tpu_torch.convert import flat_from_jax_tree, state_from_jax

    from test_torch_train_step import _with_sigma as jax_with_sigma

    cfg = dict(STEP_CONFIG, update_ratio=update_ratio,
               steps_per_call=steps_per_call, **options)
    jcfg = jax_resolve(dict(cfg, num_devices=2), num_local_devices=2)
    jgen, jdisc = jax_generator(jcfg), jax_discriminator(jcfg)
    kg, kd, krest = jax.random.split(jax.random.PRNGKey(0), 3)
    vars_g = jax_with_sigma(jgen.init(kg))
    vars_d = jax_with_sigma(jdisc.init(kd))
    pcfg = resolve_config(cfg)
    init = tuple({k: v.numpy() for k, v in state_from_jax(
        flat_from_jax_tree(variables), net(pcfg)).items()}
        for variables, net in ((vars_g, get_generator),
                               (vars_d, get_discriminator)))
    b = cfg["batch_size"]
    latents = [[[_jax_replica_latents(krest, call * steps_per_call + i, b,
                                      cfg, replica)
                 for i in range(steps_per_call)] for call in range(calls)]
               for replica in range(2)]
    job = _step_job(update_ratio, steps_per_call, calls, options,
                    init=init, latents=latents)
    return job, (jcfg, jgen, jdisc, vars_g, vars_d, krest)


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Every BN and step job on one group of 2 gloo ranks: (jobs by name,
    each rank's results by name, the JAX setups by name)."""
    jobs, setups = {}, {}
    for name, (cond, accum) in BN_CASES.items():
        jobs[f"bn/{name}"] = _bn_job(cond, accum)
    for name, case in STEP_CASES.items():
        jobs[f"steps/{name}"] = _step_job(*case)
    for name, case in JAX_CASES.items():
        jobs[f"jax/{name}"], setups[name] = _jax_setup(*case)
    names = list(jobs)
    per_rank = _launch([jobs[n] for n in names],
                       tmp_path_factory.mktemp("ranks"))
    return jobs, [dict(zip(names, r)) for r in per_rank], setups


@pytest.mark.parametrize("case", list(BN_CASES))
def test_cross_replica_bn_matches_jax_shard_map(rank_results, case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from sagan_tpu.nn.layers import BatchNorm as JaxBN
    from sagan_tpu.nn.layers import ConditionalBatchNorm as JaxCondBN
    from sagan_tpu.nn.layers import bn_accum_begin as jax_begin
    from sagan_tpu.nn.layers import bn_accum_finalize as jax_finalize
    from sagan_tpu.nn.layers import bn_moment_paths as jax_paths
    from sagan_tpu.parallel.mesh import make_mesh

    jobs, ranks, _ = rank_results
    job = jobs[f"bn/{case}"]
    cond, accum = job["cond"], job["accum"]
    jbn = (JaxCondBN(BN_C, num_classes=BN_CLASSES) if cond
           else JaxBN(BN_C))
    params = {"gamma": jnp.asarray(job["gamma"]),
              "beta": jnp.asarray(job["beta"])}
    aux0 = {"mean": jnp.asarray(job["mean"]), "var": jnp.asarray(job["var"])}
    paths = jax_paths(jbn)

    def replica(x, w, labels):
        aux = aux0
        if accum:
            aux, saved = jax_begin(paths, aux)
        micro = 2 if accum else 1
        ys, gxs, gg, gb = [], [], 0.0, 0.0
        size = x.shape[0] // micro
        for i in range(micro):
            sl = slice(i * size, (i + 1) * size)
            extra = (labels[sl],) if cond else ()

            def loss(xm, p, aux=aux, sl=sl, extra=extra):
                y, new_aux = jbn({"params": p, "aux": aux}, xm, *extra,
                                 train=True, axis="data", bn_accum=accum)
                return jnp.sum(y * w[sl]), (y, new_aux)

            (_, (y, aux)), (gx, gp) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(x[sl], params)
            ys.append(y)
            gxs.append(gx)
            gg, gb = gg + gp["gamma"], gb + gp["beta"]
        if accum:
            aux = jax_finalize(paths, aux, saved, micro)
        return (jnp.concatenate(ys), jnp.concatenate(gxs), gg[None],
                gb[None], aux["mean"][None], aux["var"][None])

    sharded = jax.jit(jax.shard_map(
        replica, mesh=make_mesh(2), in_specs=(P("data"),) * 3,
        out_specs=(P("data"),) * 6, check_vma=False))
    y, gx, gg, gb, mean, var = (np.asarray(a) for a in sharded(
        job["x"], job["w"], job["labels"]))
    got = {k: [r[f"bn/{case}"][k] for r in ranks]
           for k in ("y", "gx", "gamma", "beta", "mean", "var")}
    for key, want in (("y", y), ("gx", gx)):
        np.testing.assert_allclose(np.concatenate(got[key]), want,
                                   rtol=BN_TOL, atol=BN_TOL, err_msg=key)
    for key, want in (("gamma", gg), ("beta", gb), ("mean", mean),
                      ("var", var)):
        np.testing.assert_allclose(np.stack(got[key]), want, rtol=BN_TOL,
                                   atol=BN_TOL, err_msg=key)
    # the replicas' running stats are equal bit for bit
    for key in ("mean", "var"):
        np.testing.assert_array_equal(got[key][0], got[key][1])
    if not accum:
        # one process at the global batch: the same y and x gradient, and
        # the ranks' own gamma/beta terms add up to its gradients
        with _one_thread():
            one = run_bn(job)
        for key in ("y", "gx"):
            np.testing.assert_allclose(np.concatenate(got[key]), one[key],
                                       rtol=BN_TOL, atol=BN_TOL,
                                       err_msg=key)
        for key in ("gamma", "beta"):
            np.testing.assert_allclose(got[key][0] + got[key][1], one[key],
                                       rtol=BN_TOL, atol=BN_TOL,
                                       err_msg=key)
        for key in ("mean", "var"):
            np.testing.assert_allclose(got[key][0], one[key], rtol=BN_TOL,
                                       atol=BN_TOL, err_msg=key)


def _assert_ranks_equal(a: dict, b: dict) -> None:
    assert a["step"] == b["step"]
    for part in ("gen", "disc", "ema"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k],
                                          err_msg=f"{part} {k}")
    for ma, mb in zip(a["metrics"], b["metrics"]):
        for k in ma:
            np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_ranks_step_as_one_process_at_the_global_batch(rank_results,
                                                           case):
    jobs, ranks, _ = rank_results
    job = jobs[f"steps/{case}"]
    r0, r1 = (r[f"steps/{case}"] for r in ranks)
    _assert_ranks_equal(r0, r1)
    with _one_thread():
        one = run_steps(job)
    atol = 3 * job["config"]["lr_d"]
    assert r0["step"] == one["step"] > 0
    # the first call's metrics; a later call's follow an Adam update that
    # turns noise-level gradients into lr-scale moves (its G gradient norm
    # read 5.6e-7 or 2.3e-3 apart in the "cond" case with the one process
    # on 8 threads or 1), so from there the state is held, within 3 lr
    for key in (*SCALARS, "G_grad_norms", "D_grad_norms"):
        np.testing.assert_allclose(r0["metrics"][0][key],
                                   one["metrics"][0][key], rtol=STEP_RTOL,
                                   atol=1e-7, err_msg=key)
    for got, want in zip(r0["metrics"], one["metrics"]):
        np.testing.assert_allclose(got["G_var_means"], want["G_var_means"],
                                   rtol=0, atol=atol)
    for part in ("gen", "disc", "ema"):
        for k, want in one[part].items():
            np.testing.assert_allclose(r0[part][k], want, rtol=0, atol=atol,
                                       err_msg=f"{part} {k}")


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_two_ranks_match_the_jax_two_device_step(rank_results, case):
    import jax
    import jax.numpy as jnp

    from sagan_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from sagan_tpu.train.optim import make_gan_optimizers as jax_optimizers
    from sagan_tpu.train.trainer import TrainState as JaxState
    from sagan_tpu.train.trainer import build_train_step as jax_train_step
    from sagan_tpu_torch.convert import flat_from_jax_tree
    from sagan_tpu_torch.convert import jax_flat_from_module

    from test_torch_train_step import RTOL, _assert_close_state

    jobs, ranks, setups = rank_results
    job = jobs[f"jax/{case}"]
    jcfg, jgen, jdisc, vars_g, vars_d, krest = setups[case]
    r0, r1 = (r[f"jax/{case}"] for r in ranks)
    _assert_ranks_equal(r0, r1)

    mesh = make_mesh(2)
    (opt_g, _), (opt_d, _) = jax_optimizers(jcfg, 1)
    jstate = replicate(mesh, JaxState(
        vars_g=vars_g, vars_d=vars_d, opt_g=opt_g.init(vars_g["params"]),
        opt_d=opt_d.init(vars_d["params"]), step=jnp.int32(0), rng=krest,
        ema_g=jax.tree.map(jnp.copy, vars_g["params"])))
    jstep = jax_train_step(jgen, jdisc, opt_g, opt_d, jcfg, mesh)
    atol = 3 * job["config"]["lr_d"]
    for call, (images, labels) in enumerate(zip(job["images"],
                                                job["labels"])):
        jstate, jm = jstep(jstate, *shard_batch(mesh, images[0], labels[0]))
        jm = jax.device_get(jm)
        got = r0["metrics"][call]
        for key in SCALARS:
            np.testing.assert_allclose(got[key], jm[key], rtol=RTOL,
                                       atol=1e-6, err_msg=key)
        np.testing.assert_allclose(got["G_grad_norms"], jm["G_grad_norms"],
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(got["G_var_means"], jm["G_var_means"],
                                   rtol=0, atol=atol)
    pcfg = resolve_config(job["config"])
    for part, net, jvars in (("gen", get_generator, jstate.vars_g),
                             ("disc", get_discriminator, jstate.vars_d)):
        module = net(pcfg)
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in r0[part].items()})
        _assert_close_state(flat_from_jax_tree(jvars),
                            jax_flat_from_module(module), part, atol)


@pytest.fixture(scope="module")
def uneven(tmp_path_factory):
    """JAX's deliberately uneven layout (tests/test_multihost.py): 60
    records in 3 shard files over 2 ranks (rank 0 owns 2 files, rank 1
    one), at batch 2 a rank: 15 steps an epoch, rank 1's 20 records
    wrapping."""
    root = tmp_path_factory.mktemp("uneven")
    data = make_synthetic_dataset(str(root / "ds"), num=60, img_size=16,
                                  num_classes=4, num_shards=3, seed=3)
    config = {
        "data_path": data, "model": "vanilla", "z_dim": 8, "gf_dim": 8,
        "df_dim": 8, "lr_g": 2e-4, "lr_d": 7e-4, "decay_rate": 0.99,
        "use_attention": True, "attn_dim_G": [8], "attn_dim_D": [8],
        "use_label": True, "use_cond_bn": True, "batch_size": 2,
        "loss": "hinge_loss", "compute_dtype": "float32",
        "steps_per_call": 1, "summary_step_freq": 1000, "g_ema_decay": 0.9,
        "print_variables": False, "data_workers": 1,
    }
    job = {"kind": "trainer", "config": config,
           "ckpt_dir": str(root / "ckpt")}
    return _launch([job], root)


def _assert_same_digest(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def test_uneven_shards_keep_the_ranks_in_lockstep(uneven):
    (r0,), (r1,) = uneven
    for r in (r0, r1):
        assert r["host_steps_per_epoch"] == r["cache_steps_per_epoch"] == 15
        assert r["host_calls"] == r["cache_calls"] == 15
        assert r["host_feed"].startswith("host/")
        assert r["cache_feed"].startswith("device-cache/")
        _assert_same_digest(r["cache"], r["host"], "device cache vs host")
    _assert_same_digest(r0["host"], r1["host"], "rank 0 vs rank 1")


def test_rank0_checkpoint_is_restored_on_both_ranks_and_resumes(uneven):
    (r0,), (r1,) = uneven
    assert r0["saved"] == r1["saved"] == ["ckpt-00000030.pt"]
    assert r0["restored_step"] == r1["restored_step"] == 30
    _assert_same_digest(r0["resumed"], r1["resumed"], "rank 0 vs rank 1")
    _assert_same_digest(r0["resumed"], r0["unbroken"], "resumed")


def test_mesh_without_a_group_is_one_process():
    assert not mesh.distributed()
    assert (mesh.process_count(), mesh.process_index()) == (1, 0)
    t = [torch.ones(3), torch.zeros(2, 2)]
    assert mesh.all_reduce_mean(t)[0] is t[0]
    assert mesh.all_reduce_mean_grad(t[1]) is t[1]
    assert mesh.all_reduce_max(7) == 7
    mesh.barrier()
    mesh.initialize_distributed("gloo")   # no launcher: no group
    assert not mesh.distributed()


def test_num_devices_must_be_the_world_size():
    with pytest.raises(ValueError, match="num_devices=2 but the process "
                                         "group has 1 process"):
        resolve_config(dict(STEP_CONFIG, num_devices=2))
    cfg = resolve_config(dict(STEP_CONFIG, num_devices=2),
                         num_local_devices=2)
    assert cfg["global_batch_size"] == 8
    assert (cfg["process_count"], cfg["process_index"]) == (1, 0)


@pytest.mark.parametrize("device,local_world,cards,match", [
    ("cuda:0", 2, 1, "NCCL refuses two ranks on one card"),
    ("cuda", 2, 1, "no card of its own"),
])
def test_nccl_ranks_need_a_card_each(monkeypatch, device, local_world,
                                     cards, match):
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError, match=match) as err:
        mesh.rank_device(device, "nccl")
    assert "--dist_backend gloo" in str(err.value)
    # gloo lets both ranks share the card
    assert mesh.rank_device("cuda:0", "gloo") == torch.device("cuda", 0)


def test_the_cli_trains_each_nccl_rank_on_its_own_card(monkeypatch):
    """Under a launcher, ``main`` turns ``--device cuda`` into this rank's
    card before the group starts, and the trainer takes that card as it
    is: local rank 1 of 2 on two cards trains on ``cuda:1`` under NCCL
    (the group and the card are stubbed; the trainer stops after its
    device)."""
    from sagan_tpu_torch import main as train_cli
    from sagan_tpu_torch.train import trainer as trainer_module

    for key, value in (("WORLD_SIZE", "2"), ("RANK", "1"),
                       ("LOCAL_RANK", "1"), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cards, started, devices = [], [], []
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(mesh, "initialize_distributed",
                        lambda backend, **kw: started.append(backend))
    # the stubbed group reports its backend, as a started one would
    monkeypatch.setattr(mesh, "backend", lambda: started[-1] if started
                        else None)
    resolve = trainer_module.resolve_device
    monkeypatch.setattr(trainer_module, "resolve_device",
                        lambda d: devices.append(resolve(d)) or devices[-1])

    class Reached(Exception):
        pass

    def stop(config):
        raise Reached

    monkeypatch.setattr(trainer_module, "get_dataset_and_info", stop)
    with pytest.raises(Reached):
        train_cli.main(["--config_path",
                        os.path.join(ROOT, "example_configs", "test.py"),
                        "--device", "cuda"])
    assert started == ["nccl"]
    assert cards == devices == [torch.device("cuda", 1)]


def test_only_process_0_writes_checkpoints(tmp_path, monkeypatch):
    from sagan_tpu_torch.train.checkpoint import CheckpointManager

    monkeypatch.setattr(mesh, "process_index", lambda: 1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(3, {"step": 3}) is None
    assert not (tmp_path / "ckpt").exists() and mgr.all_steps() == []


@pytest.mark.parametrize("rule,pid", [
    (rule, pid) for rule in ("by_file", "by_stride", "by_stride_streaming",
                             "image_folder") for pid in (0, 1)])
def test_loader_shards_are_the_jax_shards(tmp_path, rule, pid):
    from sagan_tpu.data.image_folder import ImageFolderDataset as JaxFolder
    from sagan_tpu.data.loader import ImageDataset as JaxDataset
    from sagan_tpu_torch.data.image_folder import ImageFolderDataset
    from sagan_tpu_torch.data.loader import ImageDataset, get_dataset_and_info

    from test_torch_feeds import _assert_same_batches, _png_folder

    shard = {"process_index": pid, "process_count": 2}
    if rule == "image_folder":
        root = _png_folder(tmp_path / "imgs", ["cat", "dog"], 9)
        args = dict(batch_size=3, img_size=8, seed=3, **shard)
        port, ref = ImageFolderDataset(root, **args), JaxFolder(root, **args)
        assert port.meta == ref.meta
    else:
        data = make_synthetic_dataset(
            str(tmp_path / "ds"), num=45, img_size=8, num_classes=3, seed=2,
            num_shards=3 if rule == "by_file" else 1)
        args = dict(batch_size=4, data_size=41, seed=5, num_workers=2,
                    cache_in_memory=False if "streaming" in rule else None,
                    shuffle_buffer=16, **shard)
        port, ref = ImageDataset(data, **args), JaxDataset(data, **args)
        ds, cfg = get_dataset_and_info({"data_path": data, "batch_size": 4,
                                        "global_batch_size": 8, **shard})
        assert (ds.batch_size, ds.process_index) == (4, pid)
    assert port.steps_per_epoch == ref.steps_per_epoch > 0
    for epoch in (0, 1):
        _assert_same_batches(list(port.epoch(epoch)), list(ref.epoch(epoch)),
                             port.steps_per_epoch)


def test_fid_cache_key_names_the_process_as_jax(monkeypatch):
    import jax

    import sagan_tpu.train.fid as jax_fid
    from sagan_tpu_torch.train.fid import cache_path

    config = {"dataset": "church", "img_size": 64, "data_size": -1,
              "data_seed": 0}
    keys = []

    def capture(dataset, extractor, num_images, cache_file):
        keys.append(cache_file)
        raise StopIteration

    monkeypatch.setattr(jax_fid, "real_stats", capture)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    extractor = type("Extractor", (), {"cache_tag": "tag"})()
    with pytest.raises(StopIteration):
        jax_fid.compute_fid(None, None, config, num_images=16,
                            extractor=extractor)
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    monkeypatch.setattr(mesh, "process_index", lambda: 1)
    assert cache_path(config, 16, "tag") == keys[0]
    assert keys[0].endswith("church_64_16_d-1s0_p1_tag.pkl")


def test_two_device_serving_serves_jax_num_devices_2(tmp_path, monkeypatch):
    """JAX's export served by the port on two CPU devices: the ladder of
    JAX's server at ``num_devices`` 2, and, fed JAX's latents, its images
    within 1 LSB, for seeded requests across the rungs; one device serving
    the same chunks gives the same images bit for bit."""
    import jax

    from sagan_tpu.generate import export_generator_npz as jax_export
    from sagan_tpu.models import get_generator as jax_generator
    from sagan_tpu.serve import GeneratorService as JaxService
    from sagan_tpu.utils.config import resolve_config as jax_resolve
    from sagan_tpu_torch import serve
    from sagan_tpu_torch.generate import load_generator_npz

    from test_torch_serve import TINY

    cfg = jax_resolve(TINY, num_local_devices=1)
    jgen = jax_generator(cfg)
    variables = jgen.init(jax.random.PRNGKey(3))
    params = dict(variables["params"])
    params["attn8"] = {**params["attn8"], "sigma": np.float32(0.9)}
    variables = {"params": params, "aux": variables["aux"]}
    path = jax_export(jgen, variables, str(tmp_path / "g"), config=cfg)
    jsvc = JaxService(jgen, variables, z_dim=8, num_classes=4, batch=8,
                      num_devices=2, ladder=(1, 4))

    def jax_draws(seed):
        """JAX's server's latents of a seeded request, chunk by chunk."""
        key = jax.random.PRNGKey(seed)
        while True:
            key, kz, kl = jax.random.split(key, 3)
            yield kz, kl

    draws = {}

    def draw_latents(rng, size, z_dim, num_classes, truncation, class_id):
        kz, kl = next(draws["it"])
        z = np.array(jax.random.normal(kz, (size, z_dim)))
        labels = np.array(jax.random.randint(kl, (size,), 0,
                                               num_classes))
        return torch.from_numpy(z), torch.from_numpy(labels).long()

    monkeypatch.setattr(serve, "draw_latents", draw_latents)
    gen = load_generator_npz(resolve_config(TINY), path, "cpu")
    two = serve.GeneratorService(gen, z_dim=8, num_classes=4, batch=8,
                                 num_devices=2, ladder=(1, 4),
                                 devices=["cpu", "cpu"])
    one = serve.GeneratorService(gen, z_dim=8, num_classes=4, batch=8,
                                 ladder=(2, 4))
    try:
        assert two.ladder == one.ladder == jsvc.ladder == [2, 4, 8]
        for n, seed in ((1, 0), (3, 1), (9, 2), (13, 3)):
            assert list(two._chunks(n)) == list(jsvc._chunks(n))
            draws["it"] = jax_draws(seed)
            got = two.sample(n, seed, -1, 0.0)
            draws["it"] = jax_draws(seed)
            np.testing.assert_array_equal(one.sample(n, seed, -1, 0.0), got)
            want = jsvc.sample(n, seed, -1, 0.0)
            assert got.shape == want.shape == (n, 16, 16, 3)
            assert np.abs(got.astype(np.int16) -
                          want.astype(np.int16)).max() <= 1
    finally:
        two.close()
        one.close()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]))
