"""Training CLI, port of ``sagan_tpu/main.py``:

    python -m sagan_tpu_torch.main --config_path example_configs/church64_attn.py \\
        [--debug] [--device cuda|cpu]

``--debug`` truncates the run (at most 2000 records and 2 epochs) and
writes no checkpoints, so a smoke run never writes into, or resumes from,
the real run's checkpoint directory.
"""

from __future__ import annotations

from pprint import pprint


def main(argv=None):
    from .train.trainer import Trainer
    from .utils.config import get_parameters, load_config_file, resolve_config

    args = get_parameters(argv)
    config = load_config_file(args.config_path)
    if args.debug:
        size = config.get("data_size", -1)
        config["data_size"] = min(size if size > 0 else 10**9, 2000)
        config["epoch"] = min(config.get("epoch", 1), 2)
        config["ckpt_dir"] = None
    config = resolve_config(config)
    pprint(config)
    trainer = Trainer(config, device=args.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
