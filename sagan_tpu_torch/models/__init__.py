"""Model registry: ``config['model']`` selects the family, 'vanilla' or
'resnet'; ``use_pallas_sn`` routes every spectral norm through the fused
kernel K7 (``sagan_tpu/models/__init__.py``)."""

from torch import nn

from ..nn.layers import set_sn_backend
from .resnet import ResDiscriminator, ResGenerator
from .vanilla import Discriminator, Generator

_FAMILIES = {"vanilla": (Generator, Discriminator),
             "resnet": (ResGenerator, ResDiscriminator)}


def _build(config, rng, which: int) -> nn.Module:
    model = config.get("model", "vanilla")
    if model not in _FAMILIES:
        raise ValueError(f"Unsupported model type: {model!r}")
    net = _FAMILIES[model][which](config, rng=rng)
    if config.get("use_pallas_sn"):
        set_sn_backend(net, "pallas")
    return net


def get_generator(config, rng=None) -> nn.Module:
    """The generator of ``config`` with weights drawn from ``rng`` (a CPU
    ``torch.Generator``), on the CPU in eval mode; move it with
    ``.to(device)``."""
    return _build(config, rng, 0)


def get_discriminator(config, rng=None) -> nn.Module:
    """The discriminator of ``config``, like :func:`get_generator` but in
    training mode."""
    return _build(config, rng, 1)
