"""Plain reference of the GAN training step, in fp32.

One step on uint8 images [B, S, S, 3] scaled to [-1, 1]: ``update_ratio``
D updates (the fakes from G in training mode without gradient, then one D
forward over the real and fake images together, the hinge loss
mean(relu(1 - D(x))) + mean(relu(1 + D(G(z)))), Adam), then one G update
(-mean(D(G(z))) through D in training mode, Adam), then the EMA of G's
parameters (decay 0 before ``g_ema_start``: a copy).  Adam as published
(Kingma & Ba) with the configs' beta1 = 0, beta2 = 0.999, eps = 1e-7
added to the bias-corrected sqrt(v), at the learning rate
lr0 * decay_rate ** (t // steps_per_epoch) of update t.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nets import Net, Precision, discriminator, generator

BETAS = (0.0, 0.999)
EPS = 1e-7


class Adam:
    def __init__(self, params: dict, betas=BETAS, eps=EPS):
        self.betas, self.eps = betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / c2 ** 0.5 + self.eps
            p.sub_(lr / c1 * self.m[k] / denom)


def to_images(u8: torch.Tensor) -> torch.Tensor:
    return u8.permute(0, 3, 1, 2).float() * (2.0 / 255.0) - 1.0


def lr_at(lr0: float, decay: float, period: int, t: int) -> float:
    return lr0 * decay ** (t // max(1, period))


def _grad(loss, params: dict) -> dict:
    names = list(params)
    return dict(zip(names, torch.autograd.grad(loss, [params[n]
                                                      for n in names])))


def train_steps(cfg: dict, state: dict, batches, latents, steps_per_epoch,
                prec: Precision | None = None, fault: str | None = None,
                attn_block_bytes: int = 2 << 30) -> dict:
    """Runs ``len(batches)`` steps from ``state`` ({"g", "gb", "d", "db",
    "ema"}: G's and D's parameters and buffers, the EMA; all fp32,
    updated in place).  ``batches``: [(uint8 images [B, S, S, 3], labels
    [B])]; ``latents``: per step {"d": [(z, labels)] per D update,
    "g": (z, labels)}.  Returns {"G_loss": [...], "D_loss": [...],
    "grad1": {"G": {name: norm}, "D": {name: norm}}, "grad1_full": the
    same gradients whole, on the CPU, "bn1": G's BN running statistics
    after the first step, "after1": {"g", "d", "ema"} after the first
    step}.  ``fault`` plants a fault for the control's readings:
    "half_batch" (every step on the first half of its batch and latents,
    its means over them), "d_half_batch" (D's updates alone so),
    "attn_kv_x2" (the attention's gradient into k and v doubled)."""
    prec = prec or Precision()
    ratio = cfg.get("update_ratio", 1)
    decay = cfg.get("decay_rate", 1.0)
    ema_decay = cfg.get("g_ema_decay", 0.0)
    ema_start = int(cfg.get("g_ema_start", 0))
    g, gb, d, db, ema = (state[k] for k in ("g", "gb", "d", "db", "ema"))
    for t in (g, d):
        for p in t.values():
            p.requires_grad_(True)
    opt_g, opt_d = state.setdefault("opt_g", Adam(g)), state.setdefault(
        "opt_d", Adam(d))
    out = {"G_loss": [], "D_loss": [], "grad1": {}, "grad1_full": {}}
    kv_grad = 2.0 if fault == "attn_kv_x2" else 1.0

    def net(params, bufs):
        return Net(params, bufs, True, prec,
                   attn_block_bytes=attn_block_bytes, attn_kv_grad=kv_grad)

    def half(lat_d):
        return [tuple(t[:t.shape[0] // 2] for t in zl) for zl in lat_d]

    for i, ((u8, labels), lat) in enumerate(zip(batches, latents)):
        step = state.setdefault("step", 0)
        if fault == "half_batch":
            h = u8.shape[0] // 2
            u8, labels = u8[:h], labels[:h]
            lat = {"d": [(z[:h], fl[:h]) for z, fl in lat["d"]],
                   "g": tuple(t[:h] for t in lat["g"])}
        images = to_images(u8)
        labels = labels.long()
        lat_d = lat["d"]
        if fault == "d_half_batch":
            images, labels = images[:images.shape[0] // 2], labels[
                :labels.shape[0] // 2]
            lat_d = half(lat_d)
        b = images.shape[0]
        d_losses = []
        for j, (z, fl) in enumerate(lat_d):
            with torch.no_grad():
                fake = generator(cfg, net(g, gb), z, fl)
            logits = discriminator(cfg, net(d, db),
                                   torch.cat([images, fake]),
                                   torch.cat([labels, fl.long()]))
            real, fk = logits[:b], logits[b:]
            loss_d = F.relu(1.0 - real).mean() + F.relu(1.0 + fk).mean()
            grads = _grad(loss_d, d)
            if step == 0 and j == 0:
                out["grad1"]["D"] = {k: float(v.norm())
                                     for k, v in grads.items()}
                out["grad1_full"]["D"] = {k: v.detach().cpu()
                                          for k, v in grads.items()}
            opt_d.step(d, grads, lr_at(cfg["lr_d"], decay,
                                       steps_per_epoch * ratio,
                                       step * ratio + j))
            d_losses.append(float(loss_d.detach()))
        z, fl = lat["g"]
        gen_out = generator(cfg, net(g, gb), z, fl)
        if step == 0:
            out["bn1"] = {k: v.detach().clone() for k, v in gb.items()
                          if k.endswith((".mean", ".var"))}
        logits = discriminator(cfg, net(d, db), gen_out, fl)
        loss_g = -logits.mean()
        grads = _grad(loss_g, g)
        if step == 0:
            out["grad1"]["G"] = {k: float(v.norm()) for k, v in grads.items()}
            out["grad1_full"]["G"] = {k: v.detach().cpu()
                                      for k, v in grads.items()}
        opt_g.step(g, grads, lr_at(cfg["lr_g"], decay, steps_per_epoch,
                                   step))
        with torch.no_grad():
            rate = ema_decay if step >= ema_start else 0.0
            for k in ema:
                ema[k].mul_(rate).add_(g[k], alpha=1.0 - rate)
        if step == 0:
            out["after1"] = {k: {n: v.detach().clone()
                                 for n, v in state[k].items()}
                             for k in ("g", "d", "ema")}
        out["G_loss"].append(float(loss_g.detach()))
        out["D_loss"].append(sum(d_losses) / len(d_losses))
        state["step"] = step + 1
    return out
