"""Legacy flat-flag CLI, port of ``sagan_tpu/legacy_main.py``: the
hard-coded ImageNet-128 conditional ResNet SAGAN, configured by argparse
flags instead of a config file.

    python -m sagan_tpu_torch.legacy_main --data_path <tfrecord dir> \\
        -b 64 -e 5 -u 1 --path_root myrun [--device cuda|cpu]

The legacy choices: ResNet G and D at 128 px, always class-conditional
(the class count from the dataset), attention at the 32x32 maps, Adam
learning rates 1e-4 / 4e-4, decay 0.99, gf = df = 16, ``--z_dim`` (default
128).  ``--device`` defaults to the card.
"""

from __future__ import annotations

import argparse
from pprint import pprint


def build_config(args) -> dict:
    root = args.path_root
    return {
        "dataset": "imagenet",
        "data_path": args.data_path,
        "data_size": args.data_size,
        "model": "resnet",
        "img_size": 128,
        "z_dim": args.z_dim,
        "gf_dim": 16,
        "df_dim": 16,
        "lr_g": 1e-4,
        "lr_d": 4e-4,
        "decay_rate": 0.99,
        "use_attention": True,
        "attn_dim_G": [32],
        "attn_dim_D": [32],
        "use_label": True,
        "batch_size": args.batch_size,
        "loss": args.loss,
        "epoch": args.epoch,
        "update_ratio": args.update_ratio,
        "num_sample": args.num_sample,
        "summary_step_freq": 100,
        "log_dir": f"{root}/logs",
        "ckpt_dir": None if args.debug else f"{root}/checkpoints",
        "img_dir": f"{root}/images",
        "debug": args.debug,
    }


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Experiment parameters")
    parser.add_argument("--debug", action="store_true", default=False,
                        help="whether to use debug mode")
    parser.add_argument("--path_root", default="test",
                        help="path root of images, checkpoints, and logs")
    parser.add_argument("--data_path", required=True,
                        help="path to the dataset (TFRecords + metadata)")
    parser.add_argument("--z_dim", type=int, default=128,
                        help="dimension of noise")
    parser.add_argument("-b", "--batch_size", type=int, default=64)
    parser.add_argument("-l", "--loss", default="hinge_loss")
    parser.add_argument("-e", "--epoch", type=int, default=5)
    parser.add_argument("-u", "--update_ratio", type=int, default=1,
                        help="D updates per G update")
    parser.add_argument("-d", "--data_size", type=int, default=-1)
    parser.add_argument("-n", "--num_sample", type=int, default=64)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu to run there)")
    args, _unknown = parser.parse_known_args(argv)
    return args


def main(argv=None):
    from .train.trainer import Trainer
    from .utils.config import resolve_config

    args = parse_args(argv)
    config = build_config(args)
    pprint(config)
    trainer = Trainer(resolve_config(config), device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
