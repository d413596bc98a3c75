"""Faults planted in the program under the timed path, for the checks' own tests.

Each is a context manager that replaces one function of the program while it
is active; a run driven inside it must come out not ``correct``.  A training
cell can have two: a step whose optimizer leaves the state unchanged
(``state_unchanged``), and a step that leaves half the batch out and takes
its loss and gradients as the mean over the rest (``half_batch``).  A
one-chip cell has no exchange between chips to leave out, and a training
step answers nothing one by one that could be altered.
"""
from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch")


def _broken_train(make):
    def make_train_step(model, opt_cfg, **kw):
        step = make(model, opt_cfg, **kw)

        def broken(state, batch):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half)

        return broken

    return make_train_step


@contextlib.contextmanager
def planted(fault: str):
    """Run the block with ``fault`` planted in the program's train step."""
    import repro_torch.runtime.train as train

    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}")
    saved = (train.make_train_step, train.adamw_update)
    try:
        if fault == "half_batch":
            train.make_train_step = _broken_train(saved[0])
        else:
            from repro_torch.optim import global_norm

            def unchanged(cfg, grads, state, params):
                return params, state, {"grad_norm": global_norm(grads),
                                       "lr": cfg.lr_at(state["count"] + 1)}

            train.adamw_update = unchanged
        yield
    finally:
        train.make_train_step, train.adamw_update = saved
