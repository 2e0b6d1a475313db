"""The general driver of a training cell: the program's ``Trainer`` over
the seed's records through its device-cache feed, ``steps_per_call`` steps
a call of its ``TrainStep``, as ``Trainer._train_epochs`` calls it.

``Trainer.train`` runs whole epochs and cannot be bounded by time, so
the driver takes the calls from ``Trainer._device_batches`` itself; what
that leaves out of the window (summaries, sample grids, checkpoints, FID
epochs) is listed in PERF.md.

Set-up: the records (``data.py``), the trainer, the benchmark's weights
(``weights.py``) copied into G, D and the EMA, then the first call's four
steps one at a time (K = 1 calls of the same ``TrainStep`` on the same
feed, with latents the benchmark draws), which the reference follows for
three steps; then one call at the window's K to warm up.  The window:
calls until ``seconds`` have passed, then a synchronization.  With
``trace``, a few calls in it record a CUDA event at each of the step's
spans (``TrainStep.mark``) and the next few run under the profiler.

Correctness, after the window and with the program freed: the feed's
first three batches are checked record by record against the seed's
copy, the reference (``reference/train.py``, fp32) takes the same three
steps, and the numbers of ``numbers`` are worked out; each cell's limits
file names those it holds.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from . import common, data, flops, trace, weights
from .reference import train as ref_train

D_SPANS = ("fakes", "d_fwd_bwd", "d_adam")
G_SPANS = ("g_fwd_bwd", "g_adam", "ema")
COMPARED_STEPS = 3


def run_config(cell: dict, data_path, seed: int) -> dict:
    from sagan_tpu_torch.utils.config import resolve_config

    cfg = dict(cell["config"]["config"])
    cfg.update(batch_size=cell["traffic"]["batch_size"],
               data_path=str(data_path), seed=common.sub_seed(seed, 1),
               data_seed=common.sub_seed(seed, 2))
    return resolve_config(cfg)


def draw_latents(cfg: dict, seed: int, step: int, device) -> dict:
    """One step's latents, as ``TrainStep.latents`` lays them out."""
    rng = torch.Generator(device=device).manual_seed(
        common.sub_seed(seed, 10, step))
    b, zd = cfg["global_batch_size"], cfg["z_dim"]
    ncls = max(1, cfg.get("num_classes", 1))

    def draw():
        z = torch.randn(b, zd, generator=rng, device=device)
        return z, torch.randint(0, ncls, (b,), generator=rng, device=device)

    return {"flip": None, "d": [draw() for _ in
                                range(cfg.get("update_ratio", 1))],
            "g": draw()}


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _grad_norms(opt, named) -> dict:
    """A step's gradient norms from Adam's second moment after its first
    update: v = (1 - beta2) g^2."""
    beta2 = opt.param_groups[0]["betas"][1]
    return {n: math.sqrt(float(opt.state[p]["exp_avg_sq"].double().sum())
                         / (1.0 - beta2)) for n, p in named}


def _change_norms(now: dict, start: dict) -> dict:
    return {k: float((now[k].detach().double().cpu()
                      - start[k].double()).norm()) for k in start}


def bn_changes(bufs: dict, start: dict) -> dict:
    """{BN statistic: norm of its change from ``start``} of G's running
    means and variances."""
    return _change_norms({k: v for k, v in bufs.items()
                          if k.endswith((".mean", ".var"))},
                         {k: v for k, v in start.items()
                          if k.endswith((".mean", ".var"))})


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: |norm(program) - norm(reference)| over the larger of the
    reference's norm of the leaf and its median leaf's}."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if keep is None or k in keep}


def rel_errors(prog: dict, ref: dict, keep) -> dict:
    """{leaf: norm(program - reference) over the larger of the
    reference's norm of the leaf and its median leaf's}, of whole
    tensors."""
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    med = statistics.median(norms.values())
    return {k: float((prog[k].double() - ref[k].double()).norm())
            / max(norms[k], med, 1e-30) for k in ref if k in keep}


def moved_leaves(grad1: dict) -> set:
    med = statistics.median(grad1.values())
    return {k for k, v in grad1.items() if v >= 1e-3 * med}


def numbers(prog: dict, ref: dict, worst: int = 0) -> dict:
    """The numbers the comparison reads (each cell's limits file names
    those it holds).  Leaves whose reference first gradient is under a
    thousandth of their net's median leaf's (a key bias under softmax)
    are left out of each leaf's number.

    * ``grad1_rel_D`` and ``grad1_rel_G``: the worst leaf of D's and of
      G's first gradient, norm(program - reference) over the larger of
      the reference's norm of the leaf and of its net's median leaf.
      The program's gradient is Adam's first moment after one update
      (beta1 = 0: the gradient itself).  D's is taken before any update
      (G's fakes, D's forward, the hinge, D's backward); G's after D's
      first update, through D (G's forward and backward, the attention's
      backward kernels);
    * ``grad1_rel_attn``: the same, over G's attention leaves alone;
    * ``grad1_rel_D_median`` and ``grad1_rel_G_median``: the median
      leaf's of each net;
    * ``bn1_gap``: the worst of G's BN running statistics' gap of its
      change over the first step (two training-mode forwards of G's
      initial weights, the fakes' and the G update's);
    * ``change1_gap``: the worst leaf's gap of the norm of the change of
      the parameters (G, D and the EMA) over the first step: Adam's first
      move (about lr a moved element) applied once to each;
    * ``d_loss1_gap``: the first step's D loss against the reference's,
      over the larger of its |loss| and 1;
    * ``grad1_gap``: the worst leaf's gap of the first gradient's norm;
    * ``change3_gap`` and ``change3_median``: the worst and the median
      leaf's gap of the change over the three compared steps.

    ``worst`` > 0 adds the worst leaves and every step's loss gap."""
    keep = {n: moved_leaves(ref["grad1"][n]) for n in "GD"}
    d1 = abs(prog["D_loss"][0] - ref["D_loss"][0]) / max(abs(ref["D_loss"][0]),
                                                        1.0)
    grad = {f"{n}/{k}": v for n in "GD"
            for k, v in leaf_gaps(prog["grad1"][n], ref["grad1"][n]).items()}
    rel = {n: rel_errors(prog["grad1_full"][n], ref["grad1_full"][n],
                         keep[n]) for n in "GD"}
    attn = [v for k, v in rel["G"].items() if k.startswith("attn")]

    def changes(key):
        return {f"{n}/{k}": v for n in ("G", "D", "EMA")
                for k, v in leaf_gaps(prog[key][n], ref[key][n],
                                      keep["G" if n == "EMA" else n]).items()}

    change1, change3 = changes("change1"), changes("change")
    bn1 = leaf_gaps(prog["bn1"], ref["bn1"])
    out = {"grad1_rel_D": max(rel["D"].values()),
           "grad1_rel_G": max(rel["G"].values()),
           "grad1_rel_attn": max(attn) if attn else None,
           "grad1_rel_D_median": statistics.median(rel["D"].values()),
           "grad1_rel_G_median": statistics.median(rel["G"].values()),
           "bn1_gap": max(bn1.values()),
           "change1_gap": max(change1.values()),
           "d_loss1_gap": d1, "grad1_gap": max(grad.values()),
           "change3_gap": max(change3.values()),
           "change3_median": statistics.median(change3.values())}
    if worst:
        named = {"grad1_rel_D": rel["D"], "grad1_rel_G": rel["G"],
                 "grad1": grad, "change1": change1, "change3": change3,
                 "bn1": bn1}
        for name, gaps in named.items():
            out[f"{name}_worst"] = sorted(gaps.items(),
                                          key=lambda kv: -kv[1])[:worst]
        out["loss_gaps"] = {k: [abs(a - b) / max(abs(b), 1.0)
                                for a, b in zip(prog[k], ref[k])]
                            for k in ("G_loss", "D_loss")}
    return out


class _Marks:
    """``TrainStep.mark``: a CUDA event as each span ends."""

    def __init__(self):
        self.events = []

    def __call__(self, span: str) -> None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append((span, event))

    def steps(self) -> list:
        """[{span: ms}] a step, after a synchronization."""
        out = []
        for (_, a), (span, b) in zip(self.events, self.events[1:]):
            if span == "start":
                out.append({})
            elif out:
                out[-1][span] = out[-1].get(span, 0.0) + a.elapsed_time(b)
        return out


def _epochs(trainer):
    epoch = 0
    while True:
        yield from trainer._device_batches(epoch)
        epoch += 1


def setup(cell: dict, seed: int, device, workdir) -> dict:
    """Everything before the window; returns the run's state."""
    from sagan_tpu_torch.train.trainer import Trainer

    traffic = cell["traffic"]
    cfg0 = cell["config"]["config"]
    imgs, labels = data.make_records(traffic["records"], cfg0["img_size"],
                                     cfg0.get("num_classes", 1),
                                     common.sub_seed(seed, 0), device)
    data.write_records(workdir, imgs, labels, cfg0.get("num_classes", 1))
    cfg = run_config(cell, workdir, seed)
    trainer = Trainer(cfg, device=device)
    gp, gb = weights.make_net(cfg, "G", common.sub_seed(seed, 3), device)
    dp, db = weights.make_net(cfg, "D", common.sub_seed(seed, 4), device)
    state = trainer.state
    weights.load_into(state.gen, gp, gb)
    weights.load_into(state.disc, dp, db)
    with torch.no_grad():
        for n, p in state.gen.named_parameters():
            state.ema[n].copy_(p)
    start = _cpu({"g": gp, "gb": gb, "d": dp, "db": db})
    del gp, gb, dp, db
    trainer._maybe_build_device_cache()
    if trainer._device_data is None:
        raise RuntimeError("the records did not take the device-cache feed")
    feed = _epochs(trainer)
    step = trainer.train_step
    prog = {"G_loss": [], "D_loss": []}
    lat, fed, i = [], [], 0
    while i < COMPARED_STEPS:   # whole calls, one step at a time
        images, labels_k = next(feed)
        k = images.shape[0]
        for j in range(k):
            lat.append(draw_latents(cfg, seed, i, device))
            m = step(state, images[j:j + 1], labels_k[j:j + 1], [lat[i]])
            if i < COMPARED_STEPS:
                fed.append((images[j].cpu().numpy(),
                            labels_k[j].cpu().numpy()))
                prog["G_loss"].append(float(m["G_loss"]))
                prog["D_loss"].append(float(m["D_loss"]))
            if i == 0:
                prog["bn1"] = bn_changes(state.gen.state_dict(), start["gb"])
                prog["grad1"] = {
                    "G": _grad_norms(state.opt_g,
                                     state.gen.named_parameters()),
                    "D": _grad_norms(state.opt_d,
                                     state.disc.named_parameters())}
                # Adam's first moment after one update, beta1 = 0
                prog["grad1_full"] = {
                    w: {n: opt.state[p]["exp_avg"].detach().to(
                        "cpu", copy=True)
                        for n, p in net.named_parameters()}
                    for w, opt, net in (("G", state.opt_g, state.gen),
                                        ("D", state.opt_d, state.disc))}
            if i in (0, COMPARED_STEPS - 1):
                prog["change1" if i == 0 else "change"] = {
                    "G": _change_norms(dict(state.gen.named_parameters()),
                                       start["g"]),
                    "D": _change_norms(dict(state.disc.named_parameters()),
                                       start["d"]),
                    "EMA": _change_norms(state.ema, start["g"])}
            i += 1
    fed = (np.stack([f[0] for f in fed]), np.stack([f[1] for f in fed]))
    step(state, *next(feed))   # the window's K: warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"trainer": trainer, "feed": feed, "cfg": cfg, "start": start,
            "lat": _cpu(lat[:COMPARED_STEPS]), "fed": fed,
            "records": (imgs, labels), "prog": prog, "k": k,
            "steps_per_epoch": trainer.steps_per_epoch}


def window(run: dict, traffic: dict, seconds: float, traced: bool,
           device) -> dict:
    """The measured window.  With ``traced``, once ``profile_after_s``
    have passed, ``profile_calls`` calls record ``TrainStep.mark``'s
    events (out of the profiler, so the spans time steps as an untraced
    window runs them), then as many run under the profiler; the
    profiled calls' steps and wall time are recorded apart, so that the
    rest of the window gives the untraced time a step."""
    trainer, feed = run["trainer"], run["feed"]
    state, step = trainer.state, trainer.train_step
    losses = []
    out = {"trace": None, "tries": 0, "spans": [], "calls": 0,
           "profiled_steps": 0, "profiled_s": 0.0}
    profile_at = traffic["profile_after_s"] if traced else math.inf
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)

    def call():
        m = step(state, *next(feed))
        losses.append((m["G_loss"], m["D_loss"]))
        out["calls"] += 1

    def calls(n):
        for _ in range(n):
            call()

    sync()
    t0 = time.perf_counter()
    while True:
        if time.perf_counter() - t0 >= profile_at:
            profile_at = math.inf
            p_calls = traffic["profile_calls"]
            marks = _Marks()
            step.mark = marks
            calls(p_calls)
            step.mark = None
            t_p = time.perf_counter()
            out["trace"], out["tries"] = trace.profiled(
                lambda: calls(p_calls), device)
            out["profiled_s"] = time.perf_counter() - t_p
            out["profiled_steps"] = out["tries"] * p_calls * run["k"]
            out["spans"] = marks.steps()
        call()
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    out["window_s"] = time.perf_counter() - t0
    out["steps"] = out["calls"] * run["k"]
    out["finite"] = [bool(torch.isfinite(torch.stack(x)).all())
                     for x in losses]
    return out


def reference(run: dict, device, prec=None, fault=None) -> tuple:
    """(feed checked, reference readings) of the compared steps; ``prec``
    and ``fault`` make the control and the planted faults of
    ``control.py``."""
    imgs, labels = run["records"]
    fed_imgs, fed_labels = run["fed"]
    idx = data.record_indices(fed_imgs)
    ok = (len(set(idx.ravel().tolist())) == idx.size
          and int(idx.max()) < len(labels) and int(idx.min()) >= 0)
    if ok:
        ok = (np.array_equal(imgs[idx], fed_imgs)
              and np.array_equal(labels[idx], fed_labels))
    if not ok:
        return False, None
    start = run["start"]
    state = {k: {n: v.to(device).clone() for n, v in start[k].items()}
             for k in ("g", "gb", "d", "db")}
    state["ema"] = {k: v.clone() for k, v in state["g"].items()}
    batches = [(torch.from_numpy(imgs[i]).to(device),
                torch.from_numpy(labels[i]).to(device)) for i in idx]
    out = ref_train.train_steps(run["cfg"], state, batches,
                                _to(run["lat"], device),
                                run["steps_per_epoch"], prec=prec,
                                fault=fault)
    out["bn1"] = bn_changes(out["bn1"], start["gb"])
    after1 = out.pop("after1")
    out["change1"] = {"G": _change_norms(after1["g"], start["g"]),
                      "D": _change_norms(after1["d"], start["d"]),
                      "EMA": _change_norms(after1["ema"], start["g"])}
    out["change"] = {"G": _change_norms(state["g"], start["g"]),
                     "D": _change_norms(state["d"], start["d"]),
                     "EMA": _change_norms(state["ema"], start["g"])}
    return True, out


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    workdir = common.WORK / "data" / cell["workload"]["name"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = setup(cell, seed, device, workdir)
    setup_s = time.perf_counter() - t_start
    traffic = cell["traffic"]
    win = window(state, traffic, seconds, traced, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    batch = state["cfg"]["global_batch_size"]
    trainer_cfg = state["cfg"]
    del state["trainer"], state["feed"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    fed_ok, ref = reference(state, device)
    nums = numbers(state["prog"], ref) if ref is not None else {}
    ok, compared = common.judge(nums, cell["limits"])
    compared["feed_records_match"] = {"value": int(fed_ok), "limit": 1}
    failed = state["k"] * sum(1 for f in win["finite"] if not f)
    result = {"correct": bool(ok and fed_ok and failed == 0),
              "attempted": win["steps"], "failed": failed,
              "compared": compared, "device": common.device_info(device, peak)}
    if traced:
        p_steps = traffic["profile_calls"] * state["k"]
        ctx = {"kind": "train", "trace": win["trace"],
               "spans": win["spans"], "steps": p_steps,
               "untraced_s": win["window_s"] - win["profiled_s"],
               "untraced_steps": win["steps"] - win["profiled_steps"],
               "flops": flops.train_step(trainer_cfg, batch),
               "peaks": common.PEAKS}
        result["metrics"] = common.read_metrics(cell, ctx)
        result["profiler_tries"] = win["tries"]
        if win["trace"] is not None:
            result["device"]["busy_s"] = win["trace"].busy_s()
            result["device"]["window_s"] = win["trace"].window_s
            result["breakdown"] = win["trace"].breakdown()
    else:
        result["metrics"] = {
            "train_imgs_per_s": {"value": win["steps"] * batch
                                 / win["window_s"], "unit": "imgs/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    return result
