"""The yardstick: the chip's peaks and the least time of the work, from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W (dense, no
sparsity).  The counts of a whole model live with its family under
``reference/`` (copied from ``chip_smoke.py``'s ``_product_params`` and
``_train_bound``); here are the expert capacity and the least time of a
train step.  Each counts what the configuration needs, whatever implements
it.
"""
from __future__ import annotations

from . import spec

BF16_FLOPS = 989e12  # tensor cores, bf16, dense
HBM_BYTES_PER_S = 3.35e12


def capacity(m, n_tokens: int) -> int:
    """Slots an expert holds for ``n_tokens`` tokens (the port's rounding)."""
    cap = int(n_tokens * m.top_k / m.experts * m.capacity_factor)
    cap = max(cap, m.top_k, 8)
    return ((cap + 127) // 128) * 128 if cap > 128 else ((cap + 7) // 8) * 8


def dispatch_shards(m, n_tokens: int, rows: int, ways: int) -> int:
    """Runs a microbatch's routed pairs fall into (the port's rule): the
    data-parallel degree ``ways`` where the ``rows`` and the ``n_tokens``
    split into it and each run keeps at least ``top_k`` slots of an
    expert's capacity, else one."""
    cap = capacity(m, n_tokens)
    if ways < 1 or rows % ways or n_tokens % ways or cap % ways or cap // ways < m.top_k:
        return 1
    return ways


def train_least_s(m, batch: int, seq: int, chips: int = 1) -> float:
    """A train step's least time on ``chips`` chips that share its work
    evenly: its products (the family's ``train_flops``) over the bf16 rate,
    plus AdamW's 28 bytes a parameter (read master, gradient, m, v; write
    master, m, v) over the memory rate, each over the chips."""
    fam = spec.family(m.family)
    return (fam.train_flops(m, batch, seq) / BF16_FLOPS
            + 28 * fam.n_params(m) / HBM_BYTES_PER_S) / chips
