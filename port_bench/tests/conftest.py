"""Tiny cells for the benchmark's CPU tests: the cells' own drivers and
reference at sizes a CPU runs in seconds."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

VANILLA = dict(model="vanilla", z_dim=16, gf_dim=4, df_dim=4, img_size=32,
               num_classes=1, use_attention=True, attn_dim_G=[8, 16],
               attn_dim_D=[8], use_label=False, compute_dtype="float32",
               lr_g=2e-4, lr_d=7e-4, decay_rate=0.99, loss="hinge_loss",
               update_ratio=1, g_ema_decay=0.999, g_ema_start=1000,
               steps_per_call=2, data_size=-1, epoch=1, use_pallas=True,
               fid_epoch_freq=0, log_dir=None, ckpt_dir=None, img_dir=None,
               print_variables=False, device_cache=True, data_workers=1,
               batch_size=4,
               data_path="unused")
RESNET = dict(VANILLA, model="resnet", gf_dim=8, df_dim=8, num_classes=5,
              attn_dim_G=[16], attn_dim_D=[8], use_label=True,
              use_cond_bn=True, lr_g=1e-4, lr_d=1e-4, use_pallas_sn=True)


def tiny_cell(config: dict, **traffic) -> dict:
    base = {"kind": "train", "batch_size": 4, "records": 16,
            "profile_after_s": 1e9, "profile_calls": 1}
    base.update(traffic)
    limits = {"grad1_rel_D": 1e-3, "grad1_rel_G": 1e-3, "bn1_gap": 1e-3,
              "change1_gap": 1e-3}
    return {"workload": {"name": f"tiny_train_{config['model']}",
                         "chips": 1},
            "config": {"config": copy.deepcopy(config)},
            "traffic": base, "limits": limits,
            "end_to_end": [], "per_layer": []}


@pytest.fixture(autouse=True)
def own_workdir(monkeypatch, tmp_path):
    """Each test writes its records into a folder of its own, so tests
    in parallel workers do not overwrite each other's."""
    from port_bench import common

    monkeypatch.setattr(common, "WORK", tmp_path / "port_bench")
