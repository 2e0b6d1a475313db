"""Offline evaluation CLI, the port of ``sagan_tpu/evaluate.py``: restore
a run's newest checkpoint (its EMA generator when the run tracked one),
compute FID against the config's dataset and, unless ``--no_is``, the
Inception Score, and print one JSON line with the JAX CLI's keys.

    python -m sagan_tpu_torch.evaluate --config_path example_configs/foo.py \\
        [--num_images 5000] [--no_is] [--raw_g] [--device cuda]

The backends are the training loop's (``train/fid.py``,
``train/iscore.py``): InceptionV3 when ``inception_weights`` points at an
exported npz, else the port's random-feature proxy, whose keys say so
("proxy_fid", "proxy_inception_score"): its scale is not that of
published numbers.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

from .train.fid import compute_fid_for_trainer, get_extractor
from .train.iscore import get_classifier, inception_score_for_trainer
from .train.trainer import Trainer
from .utils.config import load_config_file, resolve_config


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="evaluate FID / Inception Score for a trained run")
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--num_images", type=int, default=None,
                    help="sample count (default: config fid_num_images)")
    ap.add_argument("--no_is", action="store_true",
                    help="skip the Inception Score")
    ap.add_argument("--raw_g", action="store_true",
                    help="evaluate the raw (non-EMA) generator even when "
                         "the run tracked an EMA")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a "
                         "card unless cpu)")
    args = ap.parse_args(argv)

    config = resolve_config(load_config_file(args.config_path))
    # evaluation never trains: keep construction quiet
    config["print_variables"] = False
    # the Trainer restores the checkpoint, turns TF32 off, and merges the
    # dataset's metadata (img_size, num_classes) into its copy
    trainer = Trainer(config, device=args.device)
    config = trainer.config
    step = trainer.global_step()
    if step == 0:
        raise SystemExit(
            f"no trained checkpoint under {config.get('ckpt_dir')!r} — "
            f"train first (python -m sagan_tpu_torch.main --config_path "
            f"...)")
    if args.raw_g:
        trainer.state.ema = None   # eval_generator() then takes G's own

    fid_n = args.num_images or config.get("fid_num_images", 5000)
    extractor = get_extractor(config, trainer.device)
    real_fid = extractor.backend == "inception"
    result = {
        "step": step,
        "ema": trainer.state.ema is not None,
        "num_images": fid_n,
        "extractor": extractor.backend,
    }
    fid_key = "fid" if real_fid else "proxy_fid"
    result[fid_key] = float(compute_fid_for_trainer(
        trainer, num_images=fid_n, extractor=extractor))
    if not real_fid:
        result["proxy_fid_note"] = ("random-feature proxy: stable "
                                    "regression signal, NOT comparable "
                                    "to published FID numbers")
    if not args.no_is:
        is_n = args.num_images or config.get("is_num_images", fid_n)
        classifier = get_classifier(config, trainer.device)
        is_mean, is_std = inception_score_for_trainer(
            trainer, num_images=is_n, classifier=classifier)
        result["is_num_images"] = is_n
        result["is_classifier"] = classifier.backend
        is_key = ("inception_score" if classifier.backend == "inception"
                  else "proxy_inception_score")
        result[is_key] = round(float(is_mean), 4)
        result[is_key + "_std"] = round(float(is_std), 4)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
