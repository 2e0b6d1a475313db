"""Device ms a step of the kernels that are not the port's own (cuDNN's
convolutions, PyTorch's elementwise, reduction and copy kernels), from
the trace; the port's are named in ``port_bench/trace.py``."""

from port_bench import trace


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("steps", 0)
    if tr is None or not steps:
        return None
    total = sum(d for n, _, d in tr.kernels
                if not n.startswith(("Memcpy", "Memset"))) / 1e9
    port = sum(tr.table_s(trace.PORT_KERNELS).values())
    return (total - port) * 1e3 / steps
