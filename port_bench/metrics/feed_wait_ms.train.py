"""The device's idle time a training step put down to the feed: the
traced sub-window's idle pieces under ``sagan.feed``
(``Trainer._device_batches`` producing a call's batch: the index batch,
its copy to the card, the gather), ms a step (``port_bench/spans.py``)."""

from port_bench import spans


def read(ctx):
    return spans.wait_ms(ctx, spans.FEED)
