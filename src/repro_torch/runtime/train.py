"""Train step (port of ``repro.runtime.train``): gradient accumulation, remat, AdamW.

``make_train_step`` returns ``train_step(state, batch) -> (state, metrics)``:

  * the batch is split into ``num_microbatches`` along its batch axis and
    each microbatch's loss is differentiated in turn, so activation memory
    is one microbatch's working set (with per-block remat, one block's);
  * gradients accumulate in ``accum_dtype`` (float32 by default) and are
    scaled by ``1/n`` after the last microbatch.  When the masters already
    are of ``accum_dtype`` they accumulate in the masters' own ``.grad``
    (autograd adds each microbatch's into it): a second tree of float32
    gradients would cost another 4 bytes a parameter;
  * an optional ``grad_transform`` (e.g. int8 compression with error
    feedback) runs before the optimizer;
  * AdamW updates the masters and moments in place.

The step returns the state it was given, advanced: the same weight and
moment tensors, a new ``step``.  The last step's gradients stay in the
masters' ``.grad`` until the next step begins (on the ``.grad`` route).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..models.params import Params, tree_map
from ..optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "make_train_step", "init_train_state", "split_microbatches"]


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Trainable master weights, AdamW's ``{"m", "v", "count"}`` and the step
    (an int32 0-d tensor)."""

    params: Params
    opt_state: Any
    step: torch.Tensor


def init_train_state(model, opt_cfg: AdamWConfig, seed: int = 0) -> TrainState:
    """Masters from ``model.init(seed)`` made trainable, zero moments, step 0."""
    params = model.init(seed).requires_grad_()
    return TrainState(params=params, opt_state=adamw_init(opt_cfg, params),
                      step=torch.zeros((), dtype=torch.int32, device=model.device))


def split_microbatches(batch: dict, n: int) -> dict:
    """(B, ...) -> (n, B/n, ...); positions3 (3, B, S) -> (n, 3, B/n, S)."""

    def split(k, x):
        axis = 1 if k == "positions3" else 0
        b = x.shape[axis]
        if b % n:
            raise ValueError(f"{k} of shape {tuple(x.shape)} does not split into {n} microbatches")
        y = x.reshape(*x.shape[:axis], n, b // n, *x.shape[axis + 1:])
        return y.movedim(axis, 0)

    return {k: split(k, v) for k, v in batch.items()}


def make_train_step(
    model,
    opt_cfg: AdamWConfig,
    num_microbatches: int = 1,
    accum_dtype: Optional[torch.dtype] = torch.float32,
    grad_transform: Optional[Callable[[Any], Any]] = None,
):
    """Returns train_step(state, batch) -> (state, metrics).

    ``metrics`` holds float32 0-d tensors: ``loss`` (the mean over
    microbatches), ``grad_norm`` and ``lr``, plus ``ce`` and ``aux`` at one
    microbatch, as the reference's."""

    def train_step(state: TrainState, batch: dict):
        params = state.params
        masters = list(params.parameters())
        for p in masters:
            p.grad = None
        in_grad = accum_dtype is None or all(p.dtype == accum_dtype for p in masters)
        acc = None

        def add(loss):
            nonlocal acc
            loss.backward()
            if in_grad:
                return
            g = {p: torch.zeros_like(p, dtype=accum_dtype) if p.grad is None
                 else p.grad.to(accum_dtype) for p in masters}
            acc = g if acc is None else {p: acc[p].add_(g[p]) for p in masters}
            for p in masters:
                p.grad = None

        if num_microbatches == 1:
            loss, metrics = model.loss_fn(params, batch)
            add(loss)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            mbs = split_microbatches(batch, num_microbatches)
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(num_microbatches):
                mb_loss, _ = model.loss_fn(params, {k: v[i] for k, v in mbs.items()})
                add(mb_loss)
                loss = loss + mb_loss.detach()
            inv = 1.0 / num_microbatches
            loss = loss * inv
            metrics = {}

        if in_grad:
            for p in masters:
                if p.grad is None:  # a leaf the loss does not read: a zero gradient
                    p.grad = torch.zeros_like(p)
            acc = {p: p.grad for p in masters}
        if num_microbatches > 1:
            for g in acc.values():
                g.mul_(torch.tensor(inv, dtype=g.dtype))
        grads = tree_map(acc.__getitem__, params.graph_tree())
        if grad_transform is not None:
            grads = grad_transform(grads)

        _, new_opt, stats = adamw_update(opt_cfg, grads, state.opt_state, params)
        new_state = TrainState(params=params, opt_state=new_opt, step=state.step + 1)
        out = {"loss": loss, **stats}
        out.update({k: v for k, v in metrics.items() if k != "loss"})
        return new_state, out

    return train_step
