"""AdamW (port of ``repro.optim.adamw``), updating the weights in place.

The optimizer state mirrors the parameter tree: ``m`` and ``v`` have the
params' structure (a :class:`~repro_torch.models.params.Params` for a
``Params``, a nested dict for a dict), beside an int32 ``count``.
``state_dtype`` holds the moments in bf16 (``"bfloat16"``) or float32; None
keeps each parameter's type.  The update is the reference's float32 update
per leaf, with clipping by the global norm of the gradients, taken leaf by
leaf in place, so that no temporary is larger than the largest leaf (a second
copy of the weights would not fit beside them at full width).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..models.params import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: Optional[str] = None  # None = param dtype; 'bfloat16'|'float32'

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return torch.as_tensor(self.lr(step), dtype=torch.float32)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)


def _state_dtype(cfg: AdamWConfig, p: torch.Tensor):
    if cfg.state_dtype is None:
        return p.dtype
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def adamw_init(cfg: AdamWConfig, params: Any) -> dict:
    """Zero moments beside ``params``; ``count`` on the first leaf's device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=_state_dtype(cfg, p), device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, state: dict, params: Any):
    """Returns ``(params, new_state, stats)``; ``params`` and the moments of
    ``state`` are updated in place (the same objects come back), ``count``
    is a new tensor."""
    count = state["count"] + 1
    lr = cfg.lr_at(count)
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    cf = count.float()
    bc1 = 1.0 - torch.pow(cfg.b1, cf)
    bc2 = 1.0 - torch.pow(cfg.b2, cf)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"])):
        gf = g.float() * scale
        mf, vf = m.float(), v.float()  # the moments themselves when float32
        mf.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
        vf.mul_(cfg.b2).add_(gf.mul_(gf), alpha=1 - cfg.b2)
        step = torch.div(mf, bc1, out=gf).div_((vf / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()  # the master itself when float32
        step.add_(pf, alpha=cfg.weight_decay)
        pf.sub_(step.mul_(lr))
        for dst, src in ((p, pf), (m, mf), (v, vf)):
            if dst.dtype != torch.float32:
                dst.copy_(src)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
