"""What the breakdown tools share: the card's name and power limit, and
the device time and launches of each kernel in a ``torch.profiler``
trace, with the port's kernels (attention K1-K6, K1, K2, K3 and K6 on
either engine, the fused spectral norm K7) picked out by name."""

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
    ("K5 attention_flash_dkv", ("attention_flash_dkv_kernel<",)),
    ("K6 attention_flash_dqkv", ("attention_flash_dqkv_kernel<",)),
    # its launch writes (-lse log2e, delta) first, in a kernel of its own
    ("K6 attention_flash_dqkv_mma", ("attention_flash_dqkv_mma_kernel<",
                                     "attention_flash_delta_kernel<")),
)
# K7 runs its finish kernel once a call (at the configs' sn_iters 1)
SN_KERNELS = (
    ("K7 spectral_norm", ("sn_finish_kernel<", "sn_rows_kernel<",
                          "sn_colsum_kernel(")),
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


def kernel_ms_per_call(fn, *args, calls: int = 20, warmup: int = 3) -> float:
    """Device time of the kernels ``fn(*args)`` launches, per call: their
    summed time in a ``torch.profiler`` trace of ``calls`` calls, after
    ``warmup``.  Unlike CUDA events around back-to-back calls, it leaves
    out the gaps in which the card waits for the host, which set the
    events' reading of a call whose kernels take less time than its
    launch."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    return sum(ms for ms, _ in device_kernels(prof).values()) / calls


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
