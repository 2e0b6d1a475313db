"""softmax(q k^T) v, unscaled, in blocks of query rows, fp32.

The dense logits of church512's 512-map site are 262,144 x 65,536 a
sample, far past any card's memory, so the forward keeps only (o, lse)
and the backward recomputes each block's probabilities from them:
P = exp(q k^T - lse), dv += P^T g, dP = g v^T, dS = P (dP - sum(g o)),
dq = dS k, dk += dS^T q.  With ``fp8`` the probabilities are rounded to
fp8 e4m3 before P v (the control's precision for that product).
"""

from __future__ import annotations

import torch


def _rows(n: int, b: int, m: int, block_bytes: int):
    step = max(1, block_bytes // (4 * b * m))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _fp8(p: torch.Tensor) -> torch.Tensor:
    # probabilities lie in [0, 1]: scale 448 maps 1 to e4m3's largest
    return (p * 448.0).to(torch.float8_e4m3fn).float() / 448.0


class _Blocked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_bytes, fp8):
        b, n, _ = q.shape
        m = k.shape[1]
        kt = k.transpose(1, 2)
        o = q.new_empty((b, n, v.shape[2]))
        lse = q.new_empty((b, n, 1))
        for rows in _rows(n, b, m, block_bytes):
            s = torch.matmul(q[:, rows], kt)
            mx = s.amax(dim=-1, keepdim=True)
            s.sub_(mx).exp_()
            total = s.sum(dim=-1, keepdim=True)
            p = _fp8(s / total) if fp8 else s.div_(total)
            o[:, rows] = torch.matmul(p, v)
            lse[:, rows] = mx + torch.log(total)
            del s, p
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.block_bytes = block_bytes
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        b, n, _ = q.shape
        m = k.shape[1]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        dq = torch.empty_like(q)
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(v)
        for rows in _rows(n, b, m, ctx.block_bytes):
            gr = g[:, rows]
            p = torch.matmul(q[:, rows], kt).sub_(lse[:, rows]).exp_()
            dv += torch.matmul(p.transpose(1, 2), gr)
            delta = (gr * o[:, rows]).sum(dim=-1, keepdim=True)
            ds = torch.matmul(gr, vt).sub_(delta).mul_(p)
            del p
            dq[:, rows] = torch.matmul(ds, k)
            dk += torch.matmul(ds.transpose(1, 2), q[:, rows])
            del ds
        return dq, dk, dv, None, None


def blocked_attention(q, k, v, block_bytes: int = 2 << 30,
                      fp8: bool = False) -> torch.Tensor:
    """o [B, N, C] of q [B, N, d], k [B, M, d], v [B, M, C], fp32, with
    at most ``block_bytes`` of fp32 logits alive per block."""
    return _Blocked.apply(q.float(), k.float(), v.float(), block_bytes, fp8)
