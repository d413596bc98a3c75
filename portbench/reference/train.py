"""Plain float32 training steps: gradient accumulation and AdamW, from the seed's weights.

A step splits the batch's rows into ``microbatches`` equal runs, sums the
gradients of their losses and scales the sum by ``1 / microbatches``; the
step's loss is the mean of theirs.  AdamW (Loshchilov & Hutter) with the
gradients first scaled to a global norm of at most ``clip``, bias-corrected
moments, and decoupled weight decay on every leaf; the learning rate is a
linear warm-up then a cosine decay to a tenth.  Nothing here imports the
program.
"""
from __future__ import annotations

import math

import torch

from .. import spec, weights
from .common import Prec

B1, B2, EPS, WEIGHT_DECAY, CLIP = 0.9, 0.95, 1e-8, 0.1, 1.0


def lr_at(lr: dict, step: int) -> float:
    peak, warm, total = lr["peak"], lr["warmup_steps"], lr["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.1 * peak + 0.9 * peak * 0.5 * (1 + math.cos(math.pi * frac))


def leaves(conf: dict, seed: int, device) -> dict:
    """``{(group, path): float32 leaf that requires grad}`` of the seed's weights."""
    return {(g, p): t.float().requires_grad_()
            for g in weights.groups(conf) for p, t in weights.draw(conf, seed, g, device).items()}


def steps(conf: dict, mix: dict, seed: int, batches: list, prec: Prec, device) -> dict:
    """Run ``len(batches)`` steps from the seed's weights.  Returns each
    step's ``loss``; ``grad_norm``, each leaf's norm of the first step's
    gradient after clipping (what the optimizer takes); ``change``, each
    leaf's norm of its change over all the steps."""
    m = spec.dims(conf)
    family = spec.family(m.family)
    params = leaves(conf, seed, device)
    tree: dict = {}
    for (g, p), t in params.items():
        tree.setdefault(g, {})[p] = t
    mom = {k: (torch.zeros_like(t), torch.zeros_like(t)) for k, t in params.items()}
    n = mix["microbatches"]
    out = {"loss": []}
    for step, batch in enumerate(batches, start=1):
        total = 0.0
        rows = batch["tokens"].shape[0] // n
        for i in range(n):
            part = slice(i * rows, (i + 1) * rows)
            loss = family.loss(tree, batch["tokens"][part], batch["labels"][part], m, prec)
            loss.backward()
            total += float(loss.detach())
        out["loss"].append(total / n)
        with torch.no_grad():
            for t in params.values():
                if t.grad is None:  # a leaf the loss does not read
                    t.grad = torch.zeros_like(t)
                t.grad.div_(n)
            norms = {k: float(torch.linalg.vector_norm(t.grad)) for k, t in params.items()}
            scale = min(CLIP / max(math.sqrt(sum(v * v for v in norms.values())), 1e-9), 1.0)
            if step == 1:
                out["grad_norm"] = {k: v * scale for k, v in norms.items()}
            lr = lr_at(mix["lr"], step)
            bc1, bc2 = 1 - B1 ** step, 1 - B2 ** step
            for k, t in params.items():
                g = t.grad.mul_(scale)
                mk, vk = mom[k]
                mk.mul_(B1).add_(g, alpha=1 - B1)
                vk.mul_(B2).add_(g * g, alpha=1 - B2)
                upd = (mk / bc1).div_((vk / bc2).sqrt_().add_(EPS)).add_(t, alpha=WEIGHT_DECAY)
                t.sub_(upd.mul_(lr))
                t.grad = None
    with torch.no_grad():
        out["change"] = {}
        for g in weights.groups(conf):
            for p, t0 in weights.draw(conf, seed, g, device).items():
                out["change"][g, p] = float(torch.linalg.vector_norm(params[g, p] - t0.float()))
    return out
