"""The attention's share of its roofline in a training step: the least
time of the step's attention calls (``flops.attn_bound_s``: FLOPs over
989 TFLOP/s or bytes over 3.35 TB/s, per call) over the device time of
all the port's attention kernels (K1-K6) in a step, in %."""

from port_bench import flops, trace


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps", 0)
    if tr is None or not steps:
        return None
    measured = sum(tr.table_s(trace.ATTENTION_KERNELS).values()) / steps
    if measured <= 0:
        return None
    f = ctx["flops"]
    bound = flops.attn_bound_s(f["attn_calls"], f["itemsize"], ctx["peaks"])
    return 100.0 * bound / measured
