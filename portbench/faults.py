"""Faults planted in the program under the timed path, for the checks' own tests.

Each is a context manager that replaces one function of the program while it
is active; a run driven inside it must come out not ``correct``.  A training
cell can have two: a step whose optimizer leaves the state unchanged
(``state_unchanged``), and a step that leaves half the batch out and takes
its loss and gradients as the mean over the rest (``half_batch``).  A cell
on a mesh can have a third: the exchange between chips left out, here the
MoE combine's all-reduce over 'model' (``combine_unreduced``: each rank
goes on with the partial sum of its own experts, as though it were the
whole).  A one-chip cell has no exchange between chips to leave out, and a
training step answers nothing one by one that could be altered.
"""
from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch")
MESH_FAULTS = FAULTS + ("combine_unreduced",)

#: The fault planted in this process, which the ranks an entry starts plant
#: in theirs.
ACTIVE: str | None = None


def of(mix: dict) -> tuple:
    """The faults a cell of ``mix`` can have."""
    return MESH_FAULTS if "mesh" in mix else FAULTS


def _broken_train(make):
    def make_train_step(model, opt_cfg, **kw):
        step = make(model, opt_cfg, **kw)

        def broken(state, batch):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half)

        return broken

    return make_train_step


def _unreduced(reduce_rows):
    def broken(y):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        kept = [Replicate() if isinstance(p, Partial) else p for p in y.placements]
        y = DTensor.from_local(y.to_local(), y.device_mesh, kept, run_check=False,
                               shape=y.shape, stride=y.stride())
        return reduce_rows(y)

    return broken


@contextlib.contextmanager
def planted(fault: str | None):
    """Run the block with ``fault`` planted in the program (none: as it is)."""
    global ACTIVE
    import repro_torch.models.moe as moe
    import repro_torch.runtime.train as train

    if fault is not None and fault not in MESH_FAULTS:
        raise ValueError(f"no fault {fault!r}")
    saved = (train.make_train_step, train.adamw_update, moe.reduce_rows, ACTIVE)
    try:
        ACTIVE = fault
        if fault == "half_batch":
            train.make_train_step = _broken_train(saved[0])
        elif fault == "combine_unreduced":
            moe.reduce_rows = _unreduced(saved[2])
        elif fault == "state_unchanged":
            from repro_torch.optim import global_norm

            def unchanged(cfg, grads, state, params):
                return params, state, {"grad_norm": global_norm(grads),
                                       "lr": cfg.lr_at(state["count"] + 1)}

            train.adamw_update = unchanged
        yield
    finally:
        train.make_train_step, train.adamw_update, moe.reduce_rows, ACTIVE = saved
