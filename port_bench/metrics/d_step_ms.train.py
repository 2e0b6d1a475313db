"""D's update in a training step (fakes, D forward and backward, D's
Adam), device ms between ``TrainStep.mark``'s CUDA events, mean over the
marked steps (untraced calls just before the profiled ones)."""

from port_bench.train_cell import D_SPANS


def read(ctx):
    steps = [s for s in ctx.get("spans", []) if all(k in s for k in D_SPANS)]
    if not steps:
        return None
    return sum(sum(s[k] for k in D_SPANS) for s in steps) / len(steps)
