"""Training CLI, port of ``sagan_tpu/main.py``:

    python -m sagan_tpu_torch.main --config_path example_configs/church64_attn.py \\
        [--debug] [--device cuda|cpu]

``--debug`` truncates the run (at most 2000 records and 2 epochs) and
writes no checkpoints, so a smoke run never writes into, or resumes from,
the real run's checkpoint directory.

Data-parallel over W cards, one process a card:

    python -m torch.distributed.run --nproc_per_node W \\
        -m sagan_tpu_torch.main --config_path ... [--dist_backend nccl|gloo]

Under the launcher (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` in the environment) each process joins
the group (``--dist_backend``: nccl on the card, gloo with ``--device
cpu``), trains on ``cuda:<LOCAL_RANK>`` and prints its step and a digest
of the whole state at the end (equal on every rank), each line written
whole (``parallel/mesh.py`` ``whole_lines``: the ranks share the
launcher's stdout); the group is left at exit.  Without those variables
nothing changes.

With ``model_parallel`` m in the config the W ranks run a (W/m) x m grid
of tensor parallelism (``train/trainer.py``); two ranks may share one card
under gloo:

    python -m torch.distributed.run --nproc_per_node 2 \
        -m sagan_tpu_torch.main --config_path ... --dist_backend gloo \
        --device cuda:0
"""

from __future__ import annotations

import hashlib
import os
from pprint import pprint

import torch


def state_digest(trainer) -> str:
    """sha1 of every parameter and buffer of G and D and the EMA, whole
    (model-parallel shards gathered: every rank calls it), in state-dict
    order: equal on every rank while the replicas agree bit for bit."""
    from .parallel.sharding import whole

    digest = hashlib.sha1()
    s = trainer.state
    for tensors, axes in ((s.gen.state_dict(), trainer.g_axes),
                          (s.disc.state_dict(), trainer.d_axes),
                          (s.ema or {}, trainer.g_axes)):
        for name, t in whole(tensors, axes).items():
            digest.update(name.encode())
            digest.update(t.detach().cpu().contiguous().view(-1)
                          .view(torch.uint8).numpy())
    return digest.hexdigest()


def main(argv=None):
    from .parallel import mesh
    from .train.trainer import Trainer
    from .utils.config import get_parameters, load_config_file, resolve_config

    args = get_parameters(argv)
    launched = "WORLD_SIZE" in os.environ
    device = args.device
    if launched:
        mesh.whole_lines()     # the ranks share the launcher's stdout
        backend = args.dist_backend or (
            "gloo" if args.device.startswith("cpu") else "nccl")
        device = mesh.rank_device(args.device, backend)
        if device.type == "cuda":
            torch.cuda.set_device(device)   # NCCL's card, before its start
        mesh.initialize_distributed(
            backend, num_processes=int(os.environ["WORLD_SIZE"]),
            process_id=int(os.environ["RANK"]))
    try:
        config = load_config_file(args.config_path)
        if args.debug:
            size = config.get("data_size", -1)
            config["data_size"] = min(size if size > 0 else 10**9, 2000)
            config["epoch"] = min(config.get("epoch", 1), 2)
            config["ckpt_dir"] = None
        config = resolve_config(config)
        if mesh.process_index() == 0:
            pprint(config)
        trainer = Trainer(config, device=device)
        trainer.train()
        if launched:
            print(f"rank {mesh.process_index()} of {mesh.process_count()}: "
                  f"step {trainer.global_step()} state "
                  f"{state_digest(trainer)}", flush=True)
    finally:
        if launched:
            mesh.shutdown_distributed()
    return trainer


if __name__ == "__main__":
    main()
