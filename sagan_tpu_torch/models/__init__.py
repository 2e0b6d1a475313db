"""Model registry: ``config['model']`` selects the family."""

from .vanilla import Generator


def get_generator(config, rng=None) -> Generator:
    """The generator of ``config`` with weights drawn from ``rng`` (a CPU
    ``torch.Generator``), on the CPU; move it with ``.to(device)``."""
    model = config.get("model", "vanilla")
    if model == "resnet":
        raise NotImplementedError(
            "the resnet family is not ported yet: ROADMAP.md Queue 1 item 7")
    if model != "vanilla":
        raise ValueError(f"Unsupported model type: {model!r}")
    if config.get("use_pallas_sn"):
        raise NotImplementedError(
            "use_pallas_sn: the fused spectral-norm kernel (K7) is not "
            "ported yet, ROADMAP.md Queue 2")
    return Generator(config, rng=rng)
