"""Model parallelism in the port (``model_parallel`` m: the (data, model)
grid of ``parallel/mesh.py``, JAX's sharding rule in
``parallel/sharding.py``, the column-parallel layers and SN, the trainer)
on the CPU, with real gloo ranks, on a 1 x 2 grid (2 ranks) and a 2 x 2
grid (4 ranks):

* the sharded set against JAX's ``param_shardings``, name for name, over
  the parameters, the Adam moments and the EMA (in process), and the
  shapes the ranks hold;
* sharded SN against ``spectral_normalize_xla``: W̄, u, sigma and dW;
* each column-parallel layer (Conv, ConvTranspose, Dense, Embedding,
  conditional BN) against the unsharded layer, forward and backward;
* one step on each grid against JAX's GSPMD ``build_train_step`` on
  ``make_mesh(2 or 4, model_parallel=2)`` from the same init, at
  test_torch_train_step's limits;
* two calls against the port's one process at the global batch (the first
  call's metrics within 1e-5, the state within 3 lr), with
  ``grad_accum_steps``, ``steps_per_call``, the EMA's delayed start and
  ``remat``;
* the trainer: model peers read the same batches, a checkpoint written at
  m = 2 is whole and restores at m = 1, and one written at m = 1 restores
  at m = 2 (each rank its slices, gathered back bit for bit);
* JAX's config validation cases.

The rank worker is this file run as a script (``python
tests/test_torch_model_parallel.py <jobs> <rank> <world> <port>``), so no
JAX import reaches a rank.  A group of ranks starts once per grid and runs
every job of it.
"""

import contextlib
import functools
import hashlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
for path in (ROOT, TESTS):
    if path not in sys.path:
        sys.path.insert(0, path)

from sagan_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: E402
from sagan_tpu_torch.models import (get_discriminator,  # noqa: E402
                                    get_generator)
from sagan_tpu_torch.nn.layers import (ConditionalBatchNorm,  # noqa: E402
                                       Conv, ConvTranspose, Dense, Embedding)
from sagan_tpu_torch.ops.spectral import (_sharded_power_iterate,  # noqa: E402
                                          power_iterate, spectral_normalize)
from sagan_tpu_torch.parallel import mesh, sharding  # noqa: E402
from sagan_tpu_torch.train.fid import cache_path  # noqa: E402
from sagan_tpu_torch.train.optim import make_gan_optimizers  # noqa: E402
from sagan_tpu_torch.train.trainer import (TrainState,  # noqa: E402
                                           Trainer, build_train_step)
from sagan_tpu_torch.utils.config import resolve_config  # noqa: E402
from test_torch_parallel import (RANK_TIMEOUT, SCALARS,  # noqa: E402
                                 STEP_CONFIG, _free_port, _one_thread,
                                 _torch_latents, _with_sigma)

M = 2                       # the model axis of both grids
GRIDS = {"1x2": 2, "2x2": 4}
TOL = 1e-5                  # SN and the layers against the unsharded
STEP_RTOL = 1e-5
# small resnet, conditional: 128 classes make the cBN tables [128, C] and
# the projection embedding wide enough to shard
RESNET = {"model": "resnet", "use_label": True, "num_classes": 128,
          "use_cond_bn": True, "lr_g": 2.5e-6, "lr_d": 1e-5,
          "gf_dim": 16, "df_dim": 16, "img_size": 16, "attn_dim_G": [8],
          "attn_dim_D": [8]}


# -- the rank worker ---------------------------------------------------------
def _data_rows(n: int) -> slice:
    """This rank's rows of a global batch of ``n``: its data index's."""
    b = n // mesh.data_count()
    return slice(mesh.data_index() * b, (mesh.data_index() + 1) * b)


def _data_sum(tensors: dict) -> dict:
    """The sums over the data group (the global batch's gradients from
    each data index's own)."""
    names = list(tensors)
    out = mesh.all_reduce_mean([tensors[n] for n in names],
                               mesh.data_group())
    return {n: (t * mesh.data_count()).numpy() for n, t in zip(names, out)}


def run_sn(job, rank=0, world=1) -> dict:
    """Sharded SN of the job's whole weight, this rank holding its model
    index's output channels: W̄ (the shard), u, sigma, and dW of
    sum(W̄ · r)."""
    mesh.make_grid(M if world > 1 else 1)
    w, r = torch.from_numpy(job["w"]), torch.from_numpy(job["r"])
    out_dim, u = job["out_dim"], torch.from_numpy(job["u"])
    c = w.shape[out_dim] // mesh.model_size()
    begin = mesh.model_index() * c
    w_s = w.narrow(out_dim, begin, c).clone().requires_grad_()
    sharded = mesh.model_size() > 1
    w_bar, u_new = spectral_normalize(w_s, u, job["n_iter"], out_dim=out_dim,
                                      sharded=sharded)
    dw, = torch.autograd.grad((w_bar * r.narrow(out_dim, begin, c)).sum(),
                              w_s)
    w_mat = w_s.detach().movedim(out_dim, -1).reshape(-1, c)
    sigma = (_sharded_power_iterate(w_mat, u, job["n_iter"])[0] if sharded
             else power_iterate(w_mat, u, job["n_iter"])[0])
    return {"w_bar": w_bar.detach().numpy(), "u": u_new.numpy(),
            "sigma": float(sigma), "dw": dw.numpy()}


LAYERS = {
    # kind: (constructor, x shape [N, ...] or None for labels, SN)
    "conv": (lambda rng: Conv(32, 32, kernel=3, sn=True, rng=rng),
             (8, 32, 6, 6)),
    "conv1x1": (lambda rng: Conv(256, 32, kernel=1, sn=True, rng=rng),
                (8, 256, 4, 4)),
    "conv_transpose": (lambda rng: ConvTranspose(32, 32, kernel=3, stride=2,
                                                 sn=True, rng=rng),
                       (8, 32, 4, 4)),
    "dense": (lambda rng: Dense(64, 128, sn=True, rng=rng), (8, 64)),
    "embedding": (lambda rng: Embedding(128, 64, sn=True, rng=rng), None),
    "cond_bn": (lambda rng: ConditionalBatchNorm(32, 128), (8, 32, 5, 5)),
}


class _Holder(nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer


def run_layer(job, rank=0, world=1) -> dict:
    """The job's layer (whole init, then sharded by the rule) in training
    mode on this rank's rows: the output, the input's gradient and the
    global batch's parameter gradients of sum(y · r), and the buffers
    after."""
    mesh.make_grid(M if world > 1 else 1)
    kind = job["layer"]
    make, _ = LAYERS[kind]
    holder = _Holder(make(torch.Generator().manual_seed(job["seed"])))
    layer = holder.layer.train()
    if kind == "cond_bn":
        with torch.no_grad():
            layer.gamma.copy_(torch.from_numpy(job["gamma"]))
            layer.beta.copy_(torch.from_numpy(job["beta"]))
    axes = sharding.shard_module(holder)
    rows = _data_rows(len(job["labels"]))
    labels = torch.from_numpy(job["labels"][rows])
    x = None
    if job["x"] is not None:
        x = torch.from_numpy(job["x"][rows]).requires_grad_()
    if kind == "embedding":
        y = layer(labels)
    elif kind == "cond_bn":
        y = layer(x, labels)
    else:
        y = layer(x)
    params = dict(layer.named_parameters())
    wrt = list(params.values()) + ([x] if x is not None else [])
    grads = torch.autograd.grad(
        (y * torch.from_numpy(job["r"][rows])).sum(), wrt)
    out = {"axes": axes, "y": y.detach().numpy(),
           "grads": _data_sum(dict(zip(params, grads))),
           "buffers": {k: v.numpy().copy()
                       for k, v in layer.named_buffers()}}
    if x is not None:
        out["dx"] = grads[-1].numpy()
    return out


def run_steps(job, rank=0, world=1) -> dict:
    """``job["calls"]`` calls of the port's train step from the job's
    whole init, sharded on a grid of ``world`` ranks (model axis M), on
    this rank's data index's rows of the global batches; the latents are
    the seeded draws or ``job["latents"][data index]``.  Returns each
    call's metrics, the whole state after (shards gathered) and the shapes
    this rank holds."""
    m = M if world > 1 else 1
    config = dict(job["config"], model_parallel=m,
                  batch_size=job["global"] * m // world)
    cfg = resolve_config(config)
    mesh.make_grid(m)
    gen, disc = get_generator(cfg), get_discriminator(cfg)
    gen.load_state_dict({k: torch.from_numpy(v)
                         for k, v in job["gen"].items()})
    disc.load_state_dict({k: torch.from_numpy(v)
                          for k, v in job["disc"].items()})
    ga, da = sharding.shard_module(gen), sharding.shard_module(disc)
    (opt_g, sched_g), (opt_d, sched_d) = make_gan_optimizers(
        cfg, gen.parameters(), disc.parameters(), 1)
    state = TrainState(gen, disc, opt_g, opt_d, 0,
                       {n: p.detach().clone()
                        for n, p in gen.named_parameters()})
    step = build_train_step(cfg, sched_g, sched_d, gen, disc)
    rows = step.rows(cfg["batch_size"])
    metrics = []
    for call, (images, labels) in enumerate(zip(job["images"],
                                                job["labels"])):
        latents = None
        if job.get("latents") is not None:
            latents = [_torch_latents(lat) for lat in
                       job["latents"][mesh.data_index()][call]]
        m_ = step(state, torch.from_numpy(images[:, rows]),
                  torch.from_numpy(labels[:, rows]), latents)
        metrics.append({k: v.numpy() for k, v in m_.items()})
    held = {f"{tag}.{n}": tuple(p.shape)
            for tag, net in (("gen", gen), ("disc", disc))
            for n, p in net.named_parameters()}
    moments = {f"{tag}.{n}": tuple(opt.state[p]["exp_avg"].shape)
               for tag, net, opt in (("gen", gen, opt_g),
                                     ("disc", disc, opt_d))
               for n, p in net.named_parameters()}

    def whole(tensors, axes):
        return {k: v.numpy().copy()
                for k, v in sharding.whole(tensors, axes).items()}

    return {"metrics": metrics, "step": state.step, "held": held,
            "moments": moments,
            "ema_held": {n: tuple(t.shape) for n, t in state.ema.items()},
            "axes": {**{f"gen.{k}": v for k, v in ga.items()},
                     **{f"disc.{k}": v for k, v in da.items()}},
            "gen": whole(gen.state_dict(), ga),
            "disc": whole(disc.state_dict(), da),
            "ema": whole(state.ema, ga)}


def _batch_digest(images, labels) -> str:
    h = hashlib.sha1(images.numpy().tobytes())
    h.update(labels.numpy().tobytes())
    return h.hexdigest()


def _payload_numpy(payload: dict) -> dict:
    def conv(v):
        if torch.is_tensor(v):
            return v.numpy().copy()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v
    return conv(payload)


def run_trainer(job, rank=0, world=1) -> dict:
    """The trainer at model_parallel M: restore the m = 1 checkpoint (the
    payload, gathered, and the shapes held), then train an epoch from
    scratch writing a checkpoint, recording each call's batch."""
    out = {}
    restored = Trainer(resolve_config({**job["config"], "model_parallel": M,
                                       "ckpt_dir": job["ckpt_m1"]}), "cpu")
    out["restored_step"] = restored.global_step()
    out["restored"] = _payload_numpy(restored.checkpoint_payload())
    out["restored_held"] = {n: tuple(p.shape) for n, p in
                            restored.state.gen.named_parameters()}
    trainer = Trainer(resolve_config({**job["config"], "model_parallel": M,
                                      "ckpt_dir": job["ckpt_m2"]}), "cpu")
    step_fn, batches = trainer.train_step, []

    def recorded(state, images, labels, *rest):
        batches.append(_batch_digest(images, labels))
        return step_fn(state, images, labels, *rest)

    trainer.train_step = recorded
    trainer.train()
    out["batches"] = batches
    out["payload"] = _payload_numpy(trainer.checkpoint_payload())
    out["data"] = (mesh.data_index(), mesh.data_count(), mesh.model_index())
    out["fid_key"] = cache_path({"dataset": "synthetic", "img_size": 16,
                                 "data_size": -1, "data_seed": 0}, 16, "tag")
    return out


RUNNERS = {"sn": run_sn, "layer": run_layer, "steps": run_steps,
           "trainer": run_trainer}


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
def _launch(jobs: list, workdir, world: int) -> list:
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


# (out_dim, JAX-layout shape, permutation from JAX's layout to the port's)
SN_CASES = {
    "conv_oihw": (0, (3, 3, 16, 32), (3, 2, 0, 1)),
    "conv_transpose_iohw": (1, (3, 3, 32, 16), (2, 3, 0, 1)),
    "dense_2iter": (1, (48, 64), (0, 1)),
}


def _sn_job(name) -> dict:
    out_dim, shape, perm = SN_CASES[name]
    rs = np.random.RandomState(5)
    w = rs.randn(*shape).astype(np.float32)
    u = rs.randn(shape[-1]).astype(np.float32)
    u /= np.linalg.norm(u)
    r = rs.randn(*shape).astype(np.float32)
    return {"kind": "sn", "out_dim": out_dim, "perm": perm,
            "n_iter": 2 if name.endswith("2iter") else 1, "jax_w": w,
            "jax_r": r, "w": np.ascontiguousarray(w.transpose(perm)),
            "r": np.ascontiguousarray(r.transpose(perm)), "u": u}


def _layer_job(kind) -> dict:
    _, shape = LAYERS[kind]
    rs = np.random.RandomState(9)
    labels = rs.randint(0, 128, 8)
    x = None if shape is None else (rs.randn(*shape) + 0.3).astype(
        np.float32)
    with torch.no_grad():
        probe = _Holder(LAYERS[kind][0](torch.Generator().manual_seed(3)))
        if x is None:
            y = probe.layer(torch.from_numpy(labels))
        elif kind == "cond_bn":
            y = probe.layer(torch.from_numpy(x), torch.from_numpy(labels))
        else:
            y = probe.layer(torch.from_numpy(x))
    job = {"kind": "layer", "layer": kind, "seed": 3, "x": x,
           "labels": labels, "r": rs.randn(*y.shape).astype(np.float32)}
    if kind == "cond_bn":
        job["gamma"] = (1 + 0.2 * rs.randn(128, 32)).astype(np.float32)
        job["beta"] = (0.1 * rs.randn(128, 32)).astype(np.float32)
    return job


# (update_ratio, steps_per_call, calls, options) of the cases held against
# one process at the global batch
STEP_CASES = {
    "vanilla": (1, 1, 2, {}),
    "resnet_cond": (2, 1, 2, RESNET),
    # one call of two steps, each in two micro-batches, the EMA starting
    # at the second, the stages recomputed, real and fake in two D
    # forwards, per-sample flips
    "accum2_call2_remat": (1, 2, 1, {"grad_accum_steps": 2, "g_ema_start": 1,
                                     "remat": True, "random_flip": True,
                                     "fuse_d_batches": False}),
}


def _init(cfg) -> tuple:
    pcfg = resolve_config(dict(cfg, model_parallel=1))
    return tuple(_with_sigma({k: v.numpy() for k, v in net(
        pcfg, rng=torch.Generator().manual_seed(seed)).state_dict().items()})
        for net, seed in ((get_generator, 1), (get_discriminator, 2)))


def _step_job(world, update_ratio, steps_per_call, calls, options, init=None,
              latents=None, base=STEP_CONFIG) -> dict:
    cfg = dict(base, update_ratio=update_ratio,
               steps_per_call=steps_per_call, **options)
    init = init or _init(cfg)
    rs = np.random.RandomState(7)
    total = cfg["batch_size"] * world // M
    shape = (calls, steps_per_call, total)
    size = cfg["img_size"]
    return {"kind": "steps", "config": cfg, "global": total,
            "gen": init[0], "disc": init[1], "latents": latents,
            "images": rs.randint(0, 256, shape + (size, size, 3)).astype(
                np.uint8),
            "labels": rs.randint(0, cfg["num_classes"], shape).astype(
                np.int32)}


def _jax_global_latents(key, step, batch, cfg) -> dict:
    """The GSPMD step's draws: one stream over the global batch (no
    replica fold): fold_in(rng, step), split 3 -> flip, d, g; D update i
    from fold_in(d, i)."""
    import jax
    import jax.numpy as jnp

    flip_key, d_key, g_key = jax.random.split(jax.random.fold_in(key, step),
                                              3)
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


def _split_latents(lat: dict, parts: int) -> list:
    """A global draw's rows cut into ``parts`` data indices' rows."""
    def cut(a, i):
        if a is None:
            return None
        b = len(a) // parts
        return a[i * b:(i + 1) * b]

    return [{"flip": cut(lat["flip"], i),
             "g": tuple(cut(a, i) for a in lat["g"]),
             "d": [tuple(cut(a, i) for a in p) for p in lat["d"]]}
            for i in range(parts)]


# the step held against JAX's GSPMD step: vanilla at 16 px with attention
# in G and D (a short compile), wide enough that both nets shard
JAX_CONFIG = dict(STEP_CONFIG, img_size=16, df_dim=16, attn_dim_G=[8],
                  attn_dim_D=[8], update_ratio=1, steps_per_call=1)


def _jax_setup(world):
    """The port's seeded init (attention sigma 0.5) as JAX variables, and
    the one-step job whose ranks take their rows of JAX's global draws."""
    import jax
    import jax.numpy as jnp

    from sagan_tpu.models import get_discriminator as jax_discriminator
    from sagan_tpu.models import get_generator as jax_generator
    from sagan_tpu.utils.config import resolve_config as jax_resolve
    from sagan_tpu_torch.convert import jax_flat_from_module

    cfg = JAX_CONFIG
    jcfg = jax_resolve(dict(cfg, num_devices=world, model_parallel=M),
                       num_local_devices=world)
    jgen, jdisc = jax_generator(jcfg), jax_discriminator(jcfg)
    init = _init(cfg)
    pcfg = resolve_config(dict(cfg, model_parallel=1))
    trees = []
    for net, sd, jnet in ((get_generator, init[0], jgen),
                          (get_discriminator, init[1], jdisc)):
        module = net(pcfg)
        module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        flat = jax_flat_from_module(module)
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))

        def fill(path, leaf, flat=flat):
            a = flat["/".join(str(k.key) for k in path)]
            assert a.shape == leaf.shape
            return jnp.asarray(a)

        trees.append(jax.tree_util.tree_map_with_path(fill, shapes))
    vars_g, vars_d = trees
    krest = jax.random.PRNGKey(2)
    total = jcfg["global_batch_size"]
    lat = _jax_global_latents(krest, 0, total, cfg)
    latents = [[[part]] for part in _split_latents(lat, world // M)]
    job = _step_job(world, 1, 1, 1, {}, init=init, latents=latents,
                    base=cfg)
    assert job["global"] == total
    return job, (jcfg, jgen, jdisc, vars_g, vars_d, krest)


TRAINER_CONFIG = {
    "model": "vanilla", "z_dim": 8, "gf_dim": 8, "df_dim": 8,
    "lr_g": 2e-4, "lr_d": 7e-4, "decay_rate": 0.99, "use_attention": True,
    "attn_dim_G": [8], "attn_dim_D": [8], "use_label": True,
    "use_cond_bn": True, "batch_size": 2, "loss": "hinge_loss",
    "compute_dtype": "float32", "steps_per_call": 1, "epoch": 1,
    "summary_step_freq": 1000, "g_ema_decay": 0.9, "print_variables": False,
    "data_workers": 1, "num_devices": None,
}


@contextlib.contextmanager
def _cwd(path):
    before = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(before)


@pytest.fixture(scope="module")
def trainer_job(tmp_path_factory) -> dict:
    """The trainer job's data (24 records in 2 files, 16 px, 4 classes)
    and the m = 1 checkpoint of one epoch, written here; each grid writes
    its own m = M checkpoint."""
    root = tmp_path_factory.mktemp("trainer")
    data = make_synthetic_dataset(str(root / "ds"), num=24, img_size=16,
                                  num_classes=4, num_shards=2, seed=3)
    config = {**TRAINER_CONFIG, "data_path": data}
    ckpt_m1 = str(root / "ckpt_m1")
    with _one_thread():
        Trainer(resolve_config({**config, "ckpt_dir": ckpt_m1}),
                "cpu").train()
    return {"kind": "trainer", "config": config, "ckpt_m1": ckpt_m1}


@pytest.fixture(scope="module", params=list(GRIDS))
def grid(request, tmp_path_factory, trainer_job):
    """Every job on one group of gloo ranks of ``request.param``'s grid:
    (the grid's name, its world, jobs by name, each rank's results by
    name, the JAX setup)."""
    name = request.param
    world = GRIDS[name]
    root = tmp_path_factory.mktemp(f"grid{name}")
    jobs = {}
    for case in SN_CASES:
        jobs[f"sn/{case}"] = _sn_job(case)
    for kind in LAYERS:
        jobs[f"layer/{kind}"] = _layer_job(kind)
    for case, spec in STEP_CASES.items():
        jobs[f"steps/{case}"] = _step_job(world, *spec)
    jobs["jax"], setup = _jax_setup(world)
    jobs["trainer"] = {**trainer_job, "ckpt_m2": str(root / "ckpt_m2")}
    names = list(jobs)
    per_rank = _launch([jobs[n] for n in names], root, world)
    return name, world, jobs, [dict(zip(names, r)) for r in per_rank], setup


def _peers(world) -> list:
    """The ranks of each model group."""
    return [list(range(d * M, (d + 1) * M)) for d in range(world // M)]


# -- the sharded set, in process ---------------------------------------------
SHARD_CONFIGS = {
    # test_gspmd's config (cBN tables and the embedding too narrow)
    "gspmd": {"model": "resnet", "z_dim": 16, "gf_dim": 16, "df_dim": 16,
              "img_size": 16, "use_attention": True, "attn_dim_G": [8],
              "attn_dim_D": [8], "use_label": True, "use_cond_bn": True,
              "num_classes": 4},
    # 128 classes: cBN's tables and the projection embedding shard; gf 64:
    # the attention's g and out_proj 1x1 convs shard
    "wide": {"model": "resnet", "z_dim": 16, "gf_dim": 64, "df_dim": 16,
             "img_size": 16, "use_attention": True, "attn_dim_G": [8],
             "attn_dim_D": [8], "use_label": True, "use_cond_bn": True,
             "num_classes": 128},
    "vanilla": {"model": "vanilla", "z_dim": 32, "gf_dim": 8, "df_dim": 8,
                "img_size": 32, "use_attention": True, "attn_dim_G": [16],
                "attn_dim_D": [8]},
}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("config", list(SHARD_CONFIGS))
def test_the_sharded_set_is_jax_param_shardings(config, m):
    """The port's rule picks, for G and D, the very parameters that JAX's
    ``param_shardings`` shards on a model axis of m, and JAX's rule maps
    the same set over the Adam moments and the EMA."""
    import jax
    import jax.numpy as jnp

    from sagan_tpu.models import get_discriminator as jax_discriminator
    from sagan_tpu.models import get_generator as jax_generator
    from sagan_tpu.parallel.mesh import make_mesh, param_shardings
    from sagan_tpu.train.optim import make_gan_optimizers as jax_optimizers
    from sagan_tpu.train.trainer import TrainState as JaxState
    from sagan_tpu.utils.config import resolve_config as jax_resolve

    base = {"data_path": "x", "batch_size": 2, "lr_g": 1e-4, "lr_d": 4e-4,
            "compute_dtype": "float32", **SHARD_CONFIGS[config]}
    jcfg = jax_resolve(base, num_local_devices=1)
    jgen, jdisc = jax_generator(jcfg), jax_discriminator(jcfg)
    # the rule reads shapes only
    vars_g = jax.eval_shape(jgen.init, jax.random.PRNGKey(0))
    vars_d = jax.eval_shape(jdisc.init, jax.random.PRNGKey(1))
    (opt_g, _), (opt_d, _) = jax_optimizers(jcfg, 1)
    state = JaxState(vars_g=vars_g, vars_d=vars_d,
                     opt_g=jax.eval_shape(opt_g.init, vars_g["params"]),
                     opt_d=jax.eval_shape(opt_d.init, vars_d["params"]),
                     step=jnp.int32(0), rng=jax.random.PRNGKey(2),
                     ema_g=vars_g["params"])
    specs = param_shardings(make_mesh(m, model_parallel=m), state)

    def sharded(tree) -> set:
        return {".".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in path)
                for path, sh in jax.tree_util.tree_leaves_with_path(tree)
                if "model" in str(sh.spec)}

    want_g = sharded(specs.vars_g["params"])
    want_d = sharded(specs.vars_d["params"])
    assert not sharded(specs.vars_g["aux"]) | sharded(specs.vars_d["aux"])
    assert sharded(specs.ema_g) == want_g
    # each Adam moment shards as its parameter does (optax's mu, nu)
    for opt_spec, want in ((specs.opt_g, want_g), (specs.opt_d, want_d)):
        moments = [s for s in jax.tree_util.tree_leaves(
            opt_spec, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
        assert moments
        for s in moments:
            assert sharded(s.mu) == sharded(s.nu) == want
    pcfg = resolve_config({**base, "num_devices": None})
    got_g = set(sharding.shard_axes(get_generator(pcfg), m))
    got_d = set(sharding.shard_axes(get_discriminator(pcfg), m))
    assert want_g and want_d
    assert got_g == want_g and got_d == want_d
    if config == "wide":
        assert {"up8.bn1.gamma", "attn8.g.w", "attn8.out_proj.w"} <= got_g
        assert "embed.w" in got_d


# -- sharded SN and the column-parallel layers, on the grids ------------------
@functools.lru_cache(maxsize=None)
def _jax_sn(case) -> tuple:
    """JAX's (W̄, u, sigma, dW of sum(W̄ · r)) of the SN case, once for
    both grids."""
    import jax
    import jax.numpy as jnp

    from sagan_tpu.ops.spectral import power_iterate as jax_power_iterate
    from sagan_tpu.ops.spectral import spectral_normalize_xla

    job = _sn_job(case)
    n = job["n_iter"]

    @jax.jit
    def reference(w, u, r):
        (w_bar, u_new), vjp = jax.vjp(
            lambda w: spectral_normalize_xla(w, u, n_iter=n), w)
        dw, = vjp((r, jnp.zeros_like(u_new)))
        sigma = jax_power_iterate(w.reshape(-1, w.shape[-1]), u, n)[0]
        return w_bar, u_new, sigma, dw

    return tuple(np.asarray(a) for a in reference(
        job["jax_w"], job["u"], job["jax_r"]))


@pytest.mark.parametrize("case", list(SN_CASES))
def test_sharded_sn_is_jax_spectral_normalize_xla(grid, case):
    _, world, jobs, ranks, _ = grid
    job = jobs[f"sn/{case}"]
    w_bar, u_new, sigma, dw = _jax_sn(case)
    perm = job["perm"]
    for group in _peers(world):
        got = [ranks[r][f"sn/{case}"] for r in group]
        for key, want in (("w_bar", w_bar), ("dw", dw)):
            whole = np.concatenate([g[key] for g in got], job["out_dim"])
            np.testing.assert_allclose(
                whole, np.asarray(want).transpose(perm), rtol=TOL,
                atol=TOL * float(np.abs(want).max()), err_msg=key)
        for g in got:
            np.testing.assert_allclose(g["u"], np.asarray(u_new), rtol=TOL,
                                       atol=TOL)
            np.testing.assert_allclose(g["sigma"], float(sigma), rtol=TOL)
        # the model peers store the same whole u, bit for bit
        np.testing.assert_array_equal(got[0]["u"], got[1]["u"])


@pytest.mark.parametrize("kind", list(LAYERS))
def test_column_parallel_layers_are_the_unsharded_layer(grid, kind):
    _, world, jobs, ranks, _ = grid
    job = jobs[f"layer/{kind}"]
    with _one_thread():
        one = run_layer(job)
    parts = world // M
    axes = ranks[0][f"layer/{kind}"]["axes"]
    assert axes, f"{kind}: nothing sharded"
    for group in _peers(world):
        got = [ranks[r][f"layer/{kind}"] for r in group]
        d = group[0] // M
        b = len(job["labels"]) // parts
        rows = slice(d * b, (d + 1) * b)
        for g in got:
            np.testing.assert_allclose(g["y"], one["y"][rows], rtol=TOL,
                                       atol=TOL, err_msg="y")
            if "dx" in one:
                np.testing.assert_allclose(g["dx"], one["dx"][rows],
                                           rtol=TOL, atol=TOL, err_msg="dx")
            for k, v in one["buffers"].items():
                np.testing.assert_allclose(g["buffers"][k], v, rtol=TOL,
                                           atol=TOL, err_msg=k)
        for name, want in one["grads"].items():
            pname = f"layer.{name}"
            if pname in axes:
                have = np.concatenate([g["grads"][name] for g in got],
                                      axes[pname])
            else:
                have = got[0]["grads"][name]
                np.testing.assert_array_equal(have, got[1]["grads"][name])
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(have, want, rtol=TOL,
                                       atol=TOL * scale, err_msg=name)


# -- the train step ----------------------------------------------------------
def _assert_peers_equal(ranks, key, world) -> None:
    """The model peers' (and data peers') whole states and metrics are
    equal bit for bit."""
    first = ranks[0][key]
    for r in range(1, world):
        other = ranks[r][key]
        assert other["step"] == first["step"]
        for part in ("gen", "disc", "ema"):
            for k in first[part]:
                np.testing.assert_array_equal(other[part][k], first[part][k],
                                              err_msg=f"rank {r} {part} {k}")
        for ma, mb in zip(first["metrics"], other["metrics"]):
            for k in ma:
                np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def _assert_held_shards(result: dict) -> None:
    """Each rank holds 1/M of every sharded parameter, moment and EMA
    entry along its axis, and the whole of every other."""
    assert result["axes"]
    for name, shape in result["held"].items():
        tag, _, pname = name.partition(".")
        whole = result[tag][pname].shape
        want = list(whole)
        if name in result["axes"]:
            want[result["axes"][name]] //= M
        assert shape == tuple(want) == result["moments"][name], name
        if tag == "gen":
            assert result["ema_held"][pname] == shape, name


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_grid_steps_as_one_process_at_the_global_batch(grid, case):
    _, world, jobs, ranks, _ = grid
    key = f"steps/{case}"
    job = jobs[key]
    _assert_peers_equal(ranks, key, world)
    r0 = ranks[0][key]
    _assert_held_shards(r0)
    with _one_thread():
        one = run_steps(job)
    atol = 3 * job["config"]["lr_d"]
    assert r0["step"] == one["step"] > 0
    for k in (*SCALARS, "G_grad_norms", "D_grad_norms"):
        np.testing.assert_allclose(r0["metrics"][0][k], one["metrics"][0][k],
                                   rtol=STEP_RTOL, atol=1e-7, err_msg=k)
    for got, want in zip(r0["metrics"], one["metrics"]):
        np.testing.assert_allclose(got["G_var_means"], want["G_var_means"],
                                   rtol=0, atol=atol)
    for part in ("gen", "disc", "ema"):
        assert r0[part].keys() == one[part].keys()
        for k, want in one[part].items():
            np.testing.assert_allclose(r0[part][k], want, rtol=0, atol=atol,
                                       err_msg=f"{part} {k}")


def test_grid_step_matches_the_jax_gspmd_step(grid):
    import jax
    import jax.numpy as jnp

    from sagan_tpu.parallel.mesh import make_mesh, param_shardings, shard_batch
    from sagan_tpu.train.optim import make_gan_optimizers as jax_optimizers
    from sagan_tpu.train.trainer import TrainState as JaxState
    from sagan_tpu.train.trainer import build_train_step as jax_train_step
    from sagan_tpu_torch.convert import flat_from_jax_tree
    from sagan_tpu_torch.convert import jax_flat_from_module

    from test_torch_train_step import RTOL, _assert_close_state

    _, world, jobs, ranks, setup = grid
    job = jobs["jax"]
    jcfg, jgen, jdisc, vars_g, vars_d, krest = setup
    _assert_peers_equal(ranks, "jax", world)
    r0 = ranks[0]["jax"]
    jmesh = make_mesh(world, model_parallel=M)
    (opt_g, _), (opt_d, _) = jax_optimizers(jcfg, 1)
    jstate = JaxState(
        vars_g=vars_g, vars_d=vars_d, opt_g=opt_g.init(vars_g["params"]),
        opt_d=opt_d.init(vars_d["params"]), step=jnp.int32(0), rng=krest,
        ema_g=jax.tree.map(jnp.copy, vars_g["params"]))
    shs = param_shardings(jmesh, jstate)
    jstate = jax.device_put(jstate, shs)
    jstep = jax_train_step(jgen, jdisc, opt_g, opt_d, jcfg, jmesh,
                           state_shardings=shs)
    jstate, jm = jstep(jstate, *shard_batch(jmesh, job["images"][0, 0],
                                            job["labels"][0, 0]))
    jm = jax.device_get(jm)
    got = r0["metrics"][0]
    atol = 3 * job["config"]["lr_d"]
    for key in SCALARS:
        np.testing.assert_allclose(got[key], jm[key], rtol=RTOL, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(got["G_grad_norms"], jm["G_grad_norms"],
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got["G_var_means"], jm["G_var_means"], rtol=0,
                               atol=atol)
    pcfg = resolve_config(dict(job["config"], model_parallel=1))
    for part, net, jvars in (("gen", get_generator, jstate.vars_g),
                             ("disc", get_discriminator, jstate.vars_d)):
        module = net(pcfg)
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in r0[part].items()})
        _assert_close_state(flat_from_jax_tree(jax.device_get(jvars)),
                            jax_flat_from_module(module), part, atol)


# -- the trainer -------------------------------------------------------------
def _assert_same(a, b, what) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def test_model_peers_read_the_same_batches(grid):
    """Model peers read the same batches and share FID's real-statistics
    key, which names the data index (the process index of JAX's key) when
    there are several."""
    _, world, _, ranks, _ = grid
    got = [r["trainer"] for r in ranks]
    for group in _peers(world):
        first = got[group[0]]
        d = group[0] // M
        assert first["batches"]
        view = "d-1s0" + (f"_p{d}" if world > M else "")
        assert first["fid_key"].endswith(f"synthetic_16_16_{view}_tag.pkl")
        for r in group:
            assert got[r]["batches"] == first["batches"], r
            assert got[r]["data"] == (d, world // M, r % M)
            assert got[r]["fid_key"] == first["fid_key"]
    if world > M:   # the data indices read their own shards
        assert got[0]["batches"] != got[M]["batches"]


def test_checkpoints_restore_across_model_parallel_widths(grid, tmp_path):
    """The m = 1 checkpoint restored at m = M: each rank holds its slices,
    and gathered they are the file, bit for bit.  The m = M checkpoint is
    whole (written by rank 0 in the format of m = 1), equals what every
    rank gathers, and restores at m = 1."""
    _, world, jobs, ranks, _ = grid
    job = jobs["trainer"]
    mgr_dir = job["ckpt_m1"]
    (name,) = os.listdir(mgr_dir)
    saved = torch.load(os.path.join(mgr_dir, name), map_location="cpu",
                       weights_only=True)
    want = _payload_numpy(saved)
    for r in range(world):
        got = ranks[r]["trainer"]
        assert got["restored_step"] == saved["step"] > 0
        _assert_same(got["restored"], want, f"rank {r} restored")
        assert any(shape != tuple(saved["gen"][n].shape)
                   for n, shape in got["restored_held"].items())
    (name,) = os.listdir(job["ckpt_m2"])
    written = torch.load(os.path.join(job["ckpt_m2"], name),
                         map_location="cpu", weights_only=True)
    for r in range(world):
        _assert_same(ranks[r]["trainer"]["payload"], _payload_numpy(written),
                     f"rank {r} payload")
    with _one_thread(), _cwd(tmp_path):
        one = Trainer(resolve_config({**job["config"],
                                      "ckpt_dir": job["ckpt_m2"]}), "cpu")
        assert one.global_step() == written["step"] > 0
        _assert_same(_payload_numpy(one.checkpoint_payload()),
                     _payload_numpy(written), "restored at m = 1")


# -- configuration, in process -----------------------------------------------
def test_model_parallel_config_validation():
    """JAX's cases (tests/test_gspmd.py): m must divide the devices; the
    global batch is the per-device batch times the data width."""
    base = dict(data_path="x", batch_size=2, z_dim=8, gf_dim=8, df_dim=8,
                lr_g=1e-4, lr_d=4e-4)
    with pytest.raises(ValueError, match="model_parallel"):
        resolve_config(dict(base, num_devices=8, model_parallel=3),
                       num_local_devices=8)
    cfg = resolve_config(dict(base, num_devices=8, model_parallel=2),
                         num_local_devices=8)
    assert cfg["global_batch_size"] == 2 * 4


def test_one_process_cannot_shard(tmp_path):
    """Without a group of ranks there is no model axis: the trainer
    raises naming the launcher, and a grid of 1 shards nothing."""
    data = make_synthetic_dataset(str(tmp_path / "ds"), num=8, img_size=16,
                                  num_classes=4, seed=1)
    config = resolve_config({**TRAINER_CONFIG, "data_path": data,
                             "model_parallel": 2}, num_local_devices=2)
    with pytest.raises(ValueError, match="needs a group of ranks"):
        Trainer(config, "cpu")
    mesh.make_grid(1)
    assert (mesh.model_size(), mesh.data_count(), mesh.data_group(),
            mesh.model_group()) == (1, 1, None, None)
    gen = get_generator(resolve_config({**TRAINER_CONFIG, "data_path": data,
                                        "img_size": 16, "num_classes": 4}))
    before = {n: p.shape for n, p in gen.named_parameters()}
    assert sharding.shard_module(gen) == {} == sharding.sharded_axes(gen)
    assert {n: p.shape for n, p in gen.named_parameters()} == before


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]))
