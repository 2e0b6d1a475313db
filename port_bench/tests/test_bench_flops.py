"""The analytic counts of ``port_bench/flops.py`` against the shapes that
forward hooks see on the program's models at a small size: every
convolution, transposed convolution and dense layer, and every attention
site's (B, N, M, d, c)."""

import pytest
import torch

from conftest import RESNET, VANILLA
from port_bench import flops
from sagan_tpu_torch.models import get_discriminator, get_generator
from sagan_tpu_torch.nn.attention import SelfAttention
from sagan_tpu_torch.nn.layers import Conv, ConvTranspose, Dense


def _hooked(net, *args):
    count = {"conv": 0, "dense": 0, "attn": 0, "sites": []}

    def hook(mod, inputs, out):
        x = inputs[0]
        w = getattr(mod, "w", None)
        if isinstance(mod, ConvTranspose):
            count["conv"] += 2 * x.numel() * w.shape[1] * w.shape[2] \
                * w.shape[3]
        elif isinstance(mod, Conv):
            count["conv"] += 2 * out.numel() * w.shape[1] * w.shape[2] \
                * w.shape[3]
        elif isinstance(mod, Dense):
            count["dense"] += 2 * x.shape[0] * w.shape[0] * w.shape[1]
        elif isinstance(mod, SelfAttention):
            b, _, h, wd = x.shape
            site = (b, h * wd, (h // 2) * (wd // 2), mod.qk_dim, mod.v_dim)
            count["sites"].append(site)
            count["attn"] += flops.attn_fwd(site)

    for m in net.modules():
        if isinstance(m, (Conv, ConvTranspose, Dense, SelfAttention)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(*args)
    return count


@pytest.mark.parametrize("config", [VANILLA, RESNET],
                         ids=["vanilla", "resnet"])
@pytest.mark.parametrize("batch", [1, 3])
def test_forward_counts_match_hooks(config, batch):
    labels = torch.zeros(batch, dtype=torch.long)
    z = torch.randn(batch, config["z_dim"])
    gen = get_generator(config)
    got = _hooked(gen, z, labels)
    want = flops.forward(config, "G", batch)
    assert (want["conv"], want["dense"], want["attn"]) == \
        (got["conv"], got["dense"], got["attn"])
    assert want["attn_sites"] == got["sites"]
    s = config["img_size"]
    disc = get_discriminator(config)
    got = _hooked(disc, torch.zeros(batch, 3, s, s), labels)
    want = flops.forward(config, "D", batch)
    assert (want["conv"], want["dense"], want["attn"]) == \
        (got["conv"], got["dense"], got["attn"])
    assert want["attn_sites"] == got["sites"]


def test_step_counts():
    step = flops.train_step(VANILLA, 4)
    g, d2, d1 = (flops.forward(VANILLA, "G", 4), flops.forward(VANILLA, "D", 8),
                 flops.forward(VANILLA, "D", 4))
    dense = lambda f: f["conv"] + f["dense"]  # noqa: E731
    attn = sum(flops.attn_fwd(s) if k == "fwd" else flops.attn_bwd(s)
               for s, k in step["attn_calls"])
    assert step["flops"] == 4 * dense(g) + 3 * dense(d2) + 2 * dense(d1) \
        + attn
    kinds = [k for _, k in step["attn_calls"]]
    # G's two sites: forward twice, backward once; D's one: forward at 2B
    # and B, backward at 2B and B
    assert kinds.count("fwd") == 2 * 2 + 2 and kinds.count("bwd") == 2 + 2
