"""Plain float32 training steps spread over several devices, a group of leaves to a device.

The steps of :func:`portbench.reference.train.steps` for a state too large
for one device: each leaf, its gradient and its two moments live on the
device :func:`place` gives its group (the embedding and the first layers on
the first device, the next layers on the next, the final norm and the head
on the last), and the residual moves to the next device at a layer boundary.
The layers are the family's own ``layer`` and the loss's chunks its
``_ce_chunk``; with ``shards`` dispatch shards each MoE layer keeps an
expert's capacity in per-shard slices, as the program does on a mesh whose
data axis has that many ranks.  On one device it does what
``reference.train.steps`` does, operation for operation.  Nothing here
imports the program.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .. import counts, spec, weights
from .common import Prec, rms_norm
from .train import B1, B2, CLIP, EPS, WEIGHT_DECAY, lr_at


def place(m, group, path: tuple, devices: list):
    """The device of leaf ``path`` of ``group``: layer ``i`` of ``L`` on
    ``devices[i * n // L]``, the embedding on the first, the rest of the
    top group on the last."""
    if group == "top":
        return devices[0] if path == ("embed",) else devices[-1]
    return devices[group * len(devices) // m.layers]


def leaves(conf: dict, seed: int, devices: list) -> dict:
    """``{(group, path): float32 leaf that requires grad}`` of the seed's
    weights, each drawn on its group's first device and kept where
    :func:`place` puts it."""
    m = spec.dims(conf)
    out = {}
    for g in weights.groups(conf):
        first = devices[0] if g == "top" else place(m, g, (), devices)
        for p, t in weights.draw(conf, seed, g, first).items():
            out[g, p] = t.float().to(place(m, g, p, devices)).requires_grad_()
    return out


def loss(tree: dict, tokens, labels, m, prec: Prec, shards: int, chunk: int = 512):
    """The family's training loss of one microbatch (the mean token
    cross-entropy plus the weighted aux loss), each layer on its device."""
    family = spec.family(m.family)
    b, s = tokens.shape
    cap = counts.capacity(m, b * s)
    top = tree["top"]
    embed = top["embed",]
    h = embed[tokens.to(embed.device)]
    aux = h.new_zeros(())
    for i in range(m.layers):
        w = tree[i]
        h = h.to(next(iter(w.values())).device)
        h, a = checkpoint(lambda h, w: family.layer(h, w, m, cap, prec, shards), h, w,
                          use_reentrant=False)
        aux = aux + a.to(aux.device)
    norm = top["final_norm",]
    h = rms_norm(h.to(norm.device), norm, m.eps)
    head = embed.T.to(norm.device) if m.tied else top["lm_head",]
    labels = labels.to(norm.device)
    ce = sum(checkpoint(family._ce_chunk, h[:, i:i + chunk], head, labels[:, i:i + chunk], prec,
                        use_reentrant=False) for i in range(0, s, chunk)) / (b * s)
    return ce + m.aux_weight * aux.to(ce.device)


def steps(conf: dict, mix: dict, seed: int, batches: list, prec: Prec, devices: list,
          shards: int = 1) -> dict:
    """Run ``len(batches)`` steps from the seed's weights, as
    ``reference.train.steps`` does: each step's ``loss``; ``grad_norm``,
    each leaf's norm of the first step's gradient after clipping;
    ``change``, each leaf's norm of its change over all the steps."""
    m = spec.dims(conf)
    params = leaves(conf, seed, devices)
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
            mb = loss(tree, batch["tokens"][part], batch["labels"][part], m, prec, shards)
            mb.backward()
            total += float(mb.detach())
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
    del mom
    with torch.no_grad():
        out["change"] = {}
        for g in weights.groups(conf):
            first = devices[0] if g == "top" else place(m, g, (), devices)
            for p, t0 in weights.draw(conf, seed, g, first).items():
                t = params[g, p]
                out["change"][g, p] = float(torch.linalg.vector_norm(t - t0.float().to(t.device)))
    return out
