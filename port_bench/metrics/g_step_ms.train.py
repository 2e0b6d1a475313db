"""G's update in a training step (G and D forward, both backward, G's
Adam, the EMA), device ms between ``TrainStep.mark``'s CUDA events, mean
over the marked steps (untraced calls just before the profiled ones)."""

from port_bench.train_cell import G_SPANS


def read(ctx):
    steps = [s for s in ctx.get("spans", []) if all(k in s for k in G_SPANS)]
    if not steps:
        return None
    return sum(sum(s[k] for k in G_SPANS) for s in steps) / len(steps)
