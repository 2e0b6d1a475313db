"""The whole training step's share of the chip's bf16 peak: the analytic
FLOPs (``flops.train_step``: convolutions, dense layers, attention,
backward by shape, no recompute) of the window's untraced steps over
their seconds and 989 TFLOP/s, in %."""


def read(ctx):
    if not ctx.get("untraced_steps") or not ctx.get("untraced_s"):
        return None
    rate = ctx["flops"]["flops"] * ctx["untraced_steps"] / ctx["untraced_s"]
    return 100.0 * rate / ctx["peaks"]["bf16_flops"]
