"""The share of an untraced training step in which no kernel or copy ran
on the device, in %: 1 - the device's busy time a step in the traced
sub-window (the union of its kernels' and copies' intervals over its
steps) over the wall time a step in the rest of the window, which the
profiler does not slow."""


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps", 0)
    if tr is None or not steps or not ctx.get("untraced_steps"):
        return None
    step_s = ctx["untraced_s"] / ctx["untraced_steps"]
    return 100.0 * (1.0 - tr.busy_s() / steps / step_s)
