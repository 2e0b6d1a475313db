"""Offline sampling CLI: a training checkpoint or exported generator
weights -> images, on the card.

Port of ``sagan_tpu/generate.py``:

    python -m sagan_tpu_torch.generate --config_path example_configs/foo.py \\
        [--weights g.npz] [--num 64] [--batch 64] [--seed 0] \\
        [--truncation 0.5] [--class_id 207] [--out samples/foo] \\
        [--format png|npz|both] [--export copy.npz] [--step N] \\
        [--device cuda|cpu]

Without ``--weights`` the generator comes from the newest readable port
checkpoint in the config's ``ckpt_dir`` (``python -m sagan_tpu_torch.main``
writes them), or the one of step ``--step``: its EMA parameters when the
run tracked them, with the live SN and BN buffers.  ``--weights`` is the JAX package's export (``python -m
sagan_tpu.generate --export g.npz``) or the port's own
(:func:`convert.export_generator_npz`).

``--truncation t`` draws z from a standard normal truncated to [-t, t];
``--class_id`` pins the class of a conditional model (default: random
classes).  Latents come from a ``torch.Generator`` seeded by ``--seed``, so
a seed gives the same images as itself, not the JAX package's.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .convert import export_generator_npz, state_from_jax
from .models import get_generator
from .train.checkpoint import CheckpointManager
from .utils.config import load_config_file, resolve_config
from .utils.device import resolve_device
from .utils.images import save_image_grid


def load_metadata(data_path: str) -> dict:
    """The dataset's ``metadata.pickle`` (image size, class count), as the
    data converter writes it."""
    import pickle

    with open(os.path.join(data_path, "metadata.pickle"), "rb") as f:
        return pickle.load(f, encoding="latin1")


def fill_geometry(config: dict, weights: str | None) -> None:
    """Fill ``img_size`` / ``num_classes`` missing from ``config``: first
    from the weights' ``meta/*`` entries, then from the dataset metadata.
    Both keys must resolve before the metadata read is skipped, so a
    conditional model never serves num_classes=1 by accident."""
    if "img_size" in config and "num_classes" in config:
        return
    if weights and os.path.exists(weights):
        with np.load(weights) as data:
            for k in ("img_size", "num_classes"):
                if f"meta/{k}" in data:
                    config.setdefault(k, int(data[f"meta/{k}"]))
        if "img_size" in config and "num_classes" in config:
            return
    try:
        config.update(load_metadata(config["data_path"]))
    except FileNotFoundError:
        raise SystemExit(
            f"config lacks img_size/num_classes and no metadata.pickle "
            f"under {config['data_path']!r}")


def load_generator_npz(config: dict, path: str, device="cuda"):
    """The generator of ``config`` with the weights of an exported npz,
    in eval mode on ``device``."""
    gen = get_generator(config)
    with np.load(path) as data:
        gen.load_state_dict(state_from_jax(data, gen))
    return gen.to(resolve_device(device))


def restore_generator(config: dict, device="cuda", step: int | None = None):
    """The generator of the newest readable checkpoint in
    ``config['ckpt_dir']`` (of step ``step`` when given: a missing step
    raises ``KeyError`` naming the saved ones), in eval mode on
    ``device``: the EMA parameters when the run tracked them (else the live
    ones) with the live SN and BN buffers.  Fills ``img_size`` /
    ``num_classes`` missing from ``config`` from the checkpoint."""
    ckpt_dir = config.get("ckpt_dir")
    ckpt = None
    if ckpt_dir and os.path.isdir(ckpt_dir):
        mgr = CheckpointManager(ckpt_dir)
        ckpt = (mgr.restore_latest() if step is None
                else mgr.restore_step(step))
    if ckpt is None:
        raise FileNotFoundError(
            f"no checkpoint under ckpt_dir={ckpt_dir!r}: train first "
            f"(python -m sagan_tpu_torch.main --config_path ...) or pass "
            f"--weights g.npz")
    for k, v in ckpt["meta"].items():
        config.setdefault(k, v)
    gen = get_generator(config)
    state = dict(ckpt["gen"])
    if ckpt["ema"] is not None:
        state.update(ckpt["ema"])
    gen.load_state_dict(state)
    print(f"restored step {ckpt['step']} from {ckpt_dir}"
          + (" (EMA generator)" if ckpt["ema"] is not None else ""))
    return gen.to(resolve_device(device))


def load_generator(config: dict, weights: str | None, device="cuda",
                   step: int | None = None):
    """The eval generator of ``weights`` (an exported npz) or, without
    them, of the config's newest checkpoint (of ``step`` when given), on
    ``device``."""
    if weights:
        fill_geometry(config, weights)
        return load_generator_npz(config, weights, device)
    return restore_generator(config, device, step)


def build_serve_fn(gen):
    """(z, labels) -> uint8 [B, H, W, 3] images, de-normalized on the
    device as ``clamp(x*127.5 + 127.5, 0, 255)`` truncated to uint8, so
    the host fetch moves a quarter of the float32 bytes."""

    @torch.inference_mode()
    def serve(z, labels):
        x = gen(z, labels).float() * 127.5 + 127.5
        return x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1) \
            .contiguous()

    return serve


def draw_latents(rng: torch.Generator, size: int, z_dim: int,
                 num_classes: int, truncation: float = 0.0,
                 class_id: int = -1):
    """(z [size, z_dim] fp32, labels [size] int64) on ``rng``'s device:
    z standard normal, or truncated to [-t, t] when ``truncation`` t > 0;
    labels ``class_id``, or uniform over the classes when it is < 0."""
    device = rng.device
    if truncation and truncation > 0:
        z = torch.nn.init.trunc_normal_(
            torch.empty(size, z_dim, device=device), a=-truncation,
            b=truncation, generator=rng)
    else:
        z = torch.randn(size, z_dim, device=device, generator=rng)
    if class_id >= 0:
        labels = torch.full((size,), class_id, dtype=torch.long,
                            device=device)
    else:
        labels = torch.randint(0, num_classes, (size,), device=device,
                               generator=rng)
    return z, labels


def sample_images(gen, num: int, batch: int, z_dim: int, num_classes: int,
                  seed: int = 0, truncation: float = 0.0,
                  class_id: int = -1) -> np.ndarray:
    """``num`` uint8 images [num, H, W, 3], in whole batches of ``batch``
    (the last one sliced)."""
    serve = build_serve_fn(gen)
    device = next(gen.parameters()).device
    rng = torch.Generator(device=device).manual_seed(seed)
    out = []
    for begin in range(0, num, batch):
        z, labels = draw_latents(rng, batch, z_dim, num_classes, truncation,
                                 class_id)
        out.append(serve(z, labels).cpu().numpy()[:num - begin])
    return np.concatenate(out)[:num]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="sample images from exported sagan generator weights "
                    "on the card")
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--num", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--truncation", type=float, default=0.0,
                    help="truncation-trick threshold (0 = off)")
    ap.add_argument("--class_id", type=int, default=-1,
                    help="fix the class for conditional models")
    ap.add_argument("--out", default=None,
                    help="output dir (default samples/<config name>)")
    ap.add_argument("--format", choices=("png", "npz", "both"),
                    default="png")
    ap.add_argument("--step", type=int, default=None,
                    help="restore this checkpointed step (default latest)")
    ap.add_argument("--weights", default=None,
                    help="exported generator .npz (default: the newest "
                         "checkpoint in the config's ckpt_dir)")
    ap.add_argument("--export", default=None, metavar="G_NPZ",
                    help="write the loaded generator to a standalone .npz "
                         "and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run there)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # fp32 convolutions stay fp32, as the JAX layers ask for HIGHEST
    torch.backends.cudnn.allow_tf32 = False
    config = resolve_config(load_config_file(args.config_path))
    gen = load_generator(config, args.weights, device, args.step)
    num_classes = max(1, config.get("num_classes", 1))
    if args.class_id >= num_classes:
        raise SystemExit(
            f"--class_id {args.class_id} out of range for "
            f"num_classes={num_classes}")
    if args.export:
        path = export_generator_npz(gen, args.export, config=config)
        print(f"exported generator weights: {path}")
        return [path]
    imgs = sample_images(
        gen, num=args.num, batch=args.batch, z_dim=config["z_dim"],
        num_classes=num_classes, seed=args.seed, truncation=args.truncation,
        class_id=args.class_id)

    out_dir = args.out or os.path.join(
        "samples", os.path.splitext(os.path.basename(args.config_path))[0])
    os.makedirs(out_dir, exist_ok=True)
    written = []
    if args.format in ("png", "both"):
        path = os.path.join(out_dir, f"samples_seed{args.seed}.png")
        save_image_grid(imgs, path)
        written.append(path)
    if args.format in ("npz", "both"):
        path = os.path.join(out_dir, f"samples_seed{args.seed}.npz")
        np.savez_compressed(path, images=imgs)
        written.append(path)
    print(f"wrote {args.num} samples: " + ", ".join(written))
    return written


if __name__ == "__main__":
    main()
