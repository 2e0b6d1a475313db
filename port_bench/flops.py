"""Analytic operations and bytes of each cell's step and forward, worked
out from the configuration's layer shapes (the reference nets in spec
mode on the meta device), never from the program.

* Convolutions and dense layers: 2 x MACs of the forward; a backward is
  the input gradient plus the weight gradient, each the forward's count,
  except in D's backward inside G's update, which needs the input
  gradient alone.  BN, activations and elementwise passes are not
  counted.
* Attention, per call over (B, N queries, M keys, d, c): forward
  2 B N M (d + c) (q k^T and P v); backward 2 B N M (3d + 2c) (q k^T
  again, dP = g v^T, dv = P^T g, dq = dS k, dk = dS^T q), whichever kernels
  run it.  Bytes: q, k, v read and o written once (forward); q, k, v, o
  and g read and dq, dk, dv written once (backward), in the compute dtype.
* Spectral norm (the grouped K7 over a net's SN weights): each weight read
  once (fp32) and W-bar written once (compute dtype) a forward call; a
  backward call reads dW-bar and W and writes dW.

A training step (update_ratio r): r x (G forward at B for the fakes, D
forward and backward at 2B), then G forward, D forward, D backward
(input only) and G backward at B.
"""

from __future__ import annotations

import math

from .reference.nets import spec


def _itemsize(cfg) -> int:
    return 2 if cfg.get("compute_dtype", "float32") in ("bfloat16",
                                                          "float16") else 4


def forward(cfg: dict, which: str, batch: int) -> dict:
    """{"conv", "dense", "attn"} forward FLOPs of net ``which`` at
    ``batch``, and its ``attn_sites`` [(B, N, M, d, c)] and ``sn``
    weight sizes (elements)."""
    net = spec(cfg, which, batch)
    sn = [math.prod(net.roles[name[:-len(".u")] + ".w"][0])
          for name, (_, role) in net.roles.items() if role == "u"]
    return {**net.flops, "attn_sites": net.attn_sites, "sn": sn}


def attn_fwd(site) -> int:
    b, n, m, d, c = site
    return 2 * b * n * m * (d + c)


def attn_bwd(site) -> int:
    b, n, m, d, c = site
    return 2 * b * n * m * (3 * d + 2 * c)


def attn_bytes(site, itemsize: int, backward: bool) -> int:
    b, n, m, d, c = site
    fwd = b * (n * d + m * d + m * c + n * c)
    return itemsize * (fwd + b * (n * c + n * d + m * d + m * c)
                       if backward else fwd)


def _dense(f: dict) -> int:
    return f["conv"] + f["dense"]


def train_step(cfg: dict, batch: int) -> dict:
    """Per training step: ``flops`` (all counted operations), and the
    attention's ``attn_calls`` [(site, "fwd" | "bwd")], and the SN
    calls' ``sn_bytes``."""
    r = cfg.get("update_ratio", 1)
    g1, d2, d1 = (forward(cfg, "G", batch), forward(cfg, "D", 2 * batch),
                  forward(cfg, "D", batch))
    flops = r * (_dense(g1) + 3 * _dense(d2)) \
        + _dense(g1) + 2 * _dense(d1) + 2 * _dense(g1)
    calls = [(s, "fwd") for s in g1["attn_sites"]] * (r + 1)
    calls += [(s, "fwd") for s in d2["attn_sites"]] * r
    calls += [(s, "bwd") for s in d2["attn_sites"]] * r
    calls += [(s, "fwd") for s in d1["attn_sites"]]
    calls += [(s, "bwd") for s in d1["attn_sites"] + g1["attn_sites"]]
    flops += sum(attn_fwd(s) if k == "fwd" else attn_bwd(s)
                 for s, k in calls)
    size = _itemsize(cfg)
    fwd_bytes = {w: sum(n * (4 + size) for n in f["sn"])
                 for w, f in (("G", g1), ("D", d1))}
    bwd_bytes = {w: sum(n * (size + 8) for n in f["sn"])
                 for w, f in (("G", g1), ("D", d1))}
    sn_bytes = ((r + 1) * (fwd_bytes["G"] + fwd_bytes["D"])
                + r * bwd_bytes["D"] + bwd_bytes["G"])
    return {"flops": flops, "attn_calls": calls, "sn_bytes": sn_bytes,
            "itemsize": size}


def attn_bound_s(calls, itemsize: int, peaks: dict) -> float:
    """The least time the chip could take for the attention calls: each
    call's larger of FLOPs over the bf16 (or fp32) peak and bytes over
    the HBM bandwidth, summed."""
    peak = peaks["bf16_flops"] if itemsize == 2 else peaks["fp32_flops"]
    total = 0.0
    for site, kind in calls:
        ops = attn_fwd(site) if kind == "fwd" else attn_bwd(site)
        byte = attn_bytes(site, itemsize, kind == "bwd")
        total += max(ops / peak, byte / peaks["hbm_bytes"])
    return total
