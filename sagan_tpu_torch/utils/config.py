"""Config loading: the ``--config_path example_configs/foo.py`` API, where
the file defines a module-level dict named ``config``.

Own copy of ``sagan_tpu/utils/config.py``; the device count is the
number of processes of the ``torch.distributed`` group (one card a
process), 1 without a group, and the data-parallel width that over
``model_parallel``.
"""

from __future__ import annotations

import argparse
import runpy

from ..parallel import mesh


def get_parameters(argv=None):
    """The training CLI's flags: ``--config_path`` (required),
    ``--debug``, ``--device`` and ``--dist_backend``; unknown flags are
    tolerated, as the JAX CLI tolerates them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_path", type=str, required=True,
                    help="python file defining a `config` dict")
    ap.add_argument("--debug", action="store_true",
                    help="at most 2000 records and 2 epochs, no checkpoints")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run there)")
    ap.add_argument("--dist_backend", default=None,
                    choices=("nccl", "gloo"),
                    help="torch.distributed backend under a launcher "
                         "(default nccl on the card, gloo with --device "
                         "cpu)")
    args, _unknown = ap.parse_known_args(argv)
    return args


def load_config_file(path: str) -> dict:
    module = runpy.run_path(path)
    config = module.get("config")
    if config is None:
        raise ValueError(f"{path} must define a module-level `config` dict")
    return dict(config)


DEFAULTS = {
    "model": "vanilla",
    "loss": "hinge_loss",
    "update_ratio": 1,
    "decay_rate": 1.0,
    "use_attention": False,
    "attn_dim_G": [],
    "attn_dim_D": [],
    "use_label": False,
    "use_cond_bn": False,
    "num_sample": 16,
    "summary_step_freq": 100,
    "data_size": -1,
    "epoch": 100,
    "seed": 0,
    "compute_dtype": "bfloat16",
    "fid_epoch_freq": 0,
}


REQUIRED_KEYS = ("data_path", "batch_size", "z_dim", "gf_dim", "df_dim",
                 "lr_g", "lr_d")


def resolve_config(config: dict, num_local_devices: int | None = None) -> dict:
    """Fill defaults and derive global_batch_size / num_devices.

    The data-parallel width defaults to the group's world size (one card
    a process; ``num_local_devices`` overrides the count, for tests), as
    JAX's defaults to the global ``jax.device_count()``; a
    ``num_devices`` that differs from it raises.  ``process_count`` and
    ``process_index`` are the group's; ``data_count`` and ``data_index``
    the (data, model) grid's (``parallel/mesh.py``): the batches a step
    runs and which of them (and which data shard) this process takes, the
    same for the ``model_parallel`` ranks of one data index.
    """
    cfg = dict(DEFAULTS)
    cfg.update(config)
    missing = [k for k in REQUIRED_KEYS if k not in cfg]
    if missing:
        raise ValueError(
            f"config is missing required keys: {missing} "
            f"(see example_configs/church64_attn.py for the full set)")
    if cfg.get("sn_iters", 1) < 1:
        raise ValueError(
            f"sn_iters must be >= 1 (got {cfg['sn_iters']}): 0 iterations "
            f"would leave sigma=0 and blow up every SN kernel")
    world = (num_local_devices if num_local_devices is not None
             else mesh.process_count())
    width = cfg.get("num_devices") or world
    if width != world:
        raise ValueError(
            f"num_devices={width} but the process group has {world} "
            f"process(es): the port runs one card a process, so start "
            f"{width} ranks (python -m torch.distributed.run "
            f"--nproc_per_node {width} -m sagan_tpu_torch.main ...) "
            f"or leave num_devices unset")
    cfg["num_devices"] = width
    cfg["process_count"] = mesh.process_count()
    cfg["process_index"] = mesh.process_index()
    mp = cfg.setdefault("model_parallel", 1)
    if mp < 1 or width % mp:
        raise ValueError(
            f"model_parallel={mp} must divide num_devices={width}")
    # per-device batch x data-parallel width; the model axis replicates
    # the batch, it doesn't multiply it
    cfg.setdefault("global_batch_size", cfg["batch_size"] * (width // mp))
    cfg["data_count"] = max(1, cfg["process_count"] // mp)
    cfg["data_index"] = cfg["process_index"] // mp
    return cfg

