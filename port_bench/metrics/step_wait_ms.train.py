"""The device's idle time a training step put down to the train step
itself: the traced sub-window's idle pieces under ``sagan.train_step``,
``sagan.step`` and the step's seven phases (``TrainStep.SPANS``) with no
layer's span inside them (the optimizers, autograd's glue, the losses,
the call's means), ms a step (``port_bench/spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.wait_ms(ctx, spans.STEP)
