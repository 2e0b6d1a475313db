"""The reference against the program at tiny sizes on the CPU: one
training run (three compared steps, then a short window) through the
cell's own driver, in fp32."""

import time

import pytest
import torch

from conftest import RESNET, VANILLA, tiny_cell
from port_bench.run import run_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("config", [VANILLA, RESNET],
                         ids=["vanilla", "resnet"])
def test_training_call_matches_reference(config):
    r = run_cell(tiny_cell(config), 2 ** 33 + 5, 0.5, False, CPU,
                 time.perf_counter())
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for name in ("grad1_rel_D", "grad1_rel_G", "bn1_gap", "change1_gap"):
        assert r["compared"][name]["value"] <= r["compared"][name]["limit"]


def test_reference_nets_match_the_port_forward():
    from port_bench import weights
    from port_bench.reference import nets
    from sagan_tpu_torch.models import get_discriminator, get_generator

    for cfg in (VANILLA, RESNET):
        gp, gb = weights.make_net(cfg, "G", 1, CPU)
        dp, db = weights.make_net(cfg, "D", 2, CPU)
        gen, disc = get_generator(cfg), get_discriminator(cfg)
        weights.load_into(gen, gp, gb)
        weights.load_into(disc, dp, db)
        gen.train()
        z = torch.randn(3, cfg["z_dim"])
        labels = torch.randint(0, cfg["num_classes"], (3,))
        ref_bufs = dict(gb)
        want = nets.generator(cfg, nets.Net(gp, ref_bufs), z, labels)
        got = gen(z, labels)
        assert (got - want).abs().max() < 1e-5
        state = gen.state_dict()
        for k, v in ref_bufs.items():   # new u and BN statistics
            assert (state[k] - v).abs().max() < 1e-6, k
        want_d = nets.discriminator(cfg, nets.Net(dp, dict(db)),
                                    want.detach(), labels)
        assert (disc(got.detach(), labels) - want_d).abs().max() < 1e-5
