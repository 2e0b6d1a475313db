"""Model registry: ``config['model']`` selects the family."""

from .vanilla import Discriminator, Generator


def _check_family(config) -> None:
    model = config.get("model", "vanilla")
    if model == "resnet":
        raise NotImplementedError(
            "the resnet family is not ported yet: ROADMAP.md Queue 1 item 10")
    if model != "vanilla":
        raise ValueError(f"Unsupported model type: {model!r}")
    if config.get("use_pallas_sn"):
        raise NotImplementedError(
            "use_pallas_sn: the fused spectral-norm kernel (K7) is not "
            "ported yet, ROADMAP.md Queue 1 item 12")


def get_generator(config, rng=None) -> Generator:
    """The generator of ``config`` with weights drawn from ``rng`` (a CPU
    ``torch.Generator``), on the CPU in eval mode; move it with
    ``.to(device)``."""
    _check_family(config)
    return Generator(config, rng=rng)


def get_discriminator(config, rng=None) -> Discriminator:
    """The discriminator of ``config``, like :func:`get_generator` but in
    training mode."""
    _check_family(config)
    return Discriminator(config, rng=rng)
