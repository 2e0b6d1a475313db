"""The device's idle time a training step put down to the models and
layers: the traced sub-window's idle pieces under ``sagan.G``,
``sagan.D``, ``sagan.sn`` (a layer's W̄, or a net's grouped K7 call),
``sagan.attention`` and ``sagan.attention.bwd`` (the attention's backward,
on autograd's thread), ms a step (``port_bench/spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.wait_ms(ctx, spans.LAYERS)
