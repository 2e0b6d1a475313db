"""What the breakdown tools share: the card's name and power limit, and
the device time and launches of each kernel in a ``torch.profiler``
trace, with the port's kernels (attention K1-K6 on either engine, the
grouped spectral norm K7 and its backward) picked out by name."""

from __future__ import annotations

import subprocess

import torch

# (label, the CUDA kernels' names as a profile shows them); a launch of
# a wrapper is one launch of its first kernel (K2 runs two, or three)
ATTENTION_KERNELS = (
    ("K1 attention_fwd", ("attention_fwd_kernel<",)),
    ("K1 attention_fwd_mma", ("attention_fwd_mma_kernel<",)),
    ("K2 attention_bwd", ("attention_bwd_dq_kernel<",
                          "attention_bwd_dkv_kernel<")),
    # three kernels a launch: the stats, the gradients, the dq sum
    ("K2 attention_bwd_mma", ("attention_bwd_stats_mma_kernel<",
                              "attention_bwd_grads_mma_kernel<",
                              "attention_bwd_dq_sum_kernel(")),
    ("K3 attention_flash_fwd", ("attention_flash_fwd_kernel<",)),
    ("K3 attention_flash_fwd_mma", ("attention_flash_fwd_mma_kernel<",)),
    ("K4 attention_flash_dq", ("attention_flash_dq_kernel<",)),
    # the delta pass that K4 and K5 both read counts with K4
    ("K4 attention_flash_dq_mma", ("attention_flash_dq_mma_kernel<",
                                   "attention_flash_dq_delta_kernel<")),
    ("K5 attention_flash_dkv", ("attention_flash_dkv_kernel<",)),
    ("K5 attention_flash_dkv_mma", ("attention_flash_dkv_mma_kernel<",)),
    ("K6 attention_flash_dqkv", ("attention_flash_dqkv_kernel<",)),
    # its launch writes (-lse log2e, delta) first, in a kernel of its own
    ("K6 attention_flash_dqkv_mma", ("attention_flash_dqkv_mma_kernel<",
                                     "attention_flash_delta_kernel<")),
)
# K7, grouped: a forward call runs its finish kernel once (at the configs'
# sn_iters 1) after the rows and colsum kernels, a backward call its grad
# kernel once after the dot kernel
SN_KERNELS = (
    ("K7 spectral_norm", ("sn_group_finish_kernel(", "sn_group_rows_kernel(",
                          "sn_group_colsum_kernel(")),
    ("K7 spectral_norm_bwd", ("sn_group_grad_kernel(",
                              "sn_group_dot_kernel(")),
)
PORT_KERNELS = ATTENTION_KERNELS + SN_KERNELS


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def device_kernels(prof) -> dict:
    """{kernel name: (device ms, launches)} of a finished profile.
    Device-side records of host annotations (the optimizer's
    "Optimizer.step#Adam.step") span kernels counted on their own and
    are left out."""
    out = {}
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.key.startswith("Optimizer.")):
            out[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    return out


def kernel_ms_per_call(fn, *args, calls: int = 20, warmup: int = 3,
                       tries: int = 3) -> float | None:
    """Device time of the kernels ``fn(*args)`` launches, per call: their
    summed time in a ``torch.profiler`` trace of ``calls`` calls, after
    ``warmup``.  Unlike CUDA events around back-to-back calls, it leaves
    out the gaps in which the card waits for the host, which set the
    events' reading of a call whose kernels take less time than its
    launch.

    A trace now and then comes back without some or all of its kernel
    records; one whose kernel count is not a whole multiple of ``calls``
    is taken again, up to ``tries`` traces, and None (not measured) is
    returned when none is whole."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        kernels = device_kernels(prof).values()
        launches = sum(n for _, n in kernels)
        if launches and launches % calls == 0:
            return sum(ms for ms, _ in kernels) / calls
    return None


def ms_or_not_measured(ms: float | None) -> str:
    """``kernel_ms_per_call``'s reading as printed."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def ratio_or_not_measured(a: float | None, b: float | None) -> str:
    """a/b as printed, where either reading may be missing or zero."""
    return f"{a / b:.2f}x" if a and b else "not measured"


def attention_kernels(kernels: dict, per: int = 1,
                      table=ATTENTION_KERNELS) -> dict:
    """{label: {"ms", "launches"}} of the port's kernels in ``table``
    (the attention kernels by default, ``PORT_KERNELS`` for all) in
    ``device_kernels``' result, divided by ``per`` (steps or calls)."""
    rows = {}
    for label, names in table:
        ms = sum(t for key, (t, _) in kernels.items()
                 if any(name in key for name in names))
        launches = sum(n for key, (_, n) in kernels.items()
                       if names[0] in key)
        rows[label] = {"ms": ms / per, "launches": launches / per}
    return rows
