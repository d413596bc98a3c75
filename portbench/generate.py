"""The general traffic generator: every mix file under ``traffic/`` is read here.

A ``train`` mix gives packed rows of Zipf token streams, a frozen copy of
the port's ``SyntheticPipeline`` (``src/repro_torch/data/pipeline.py``), one
batch a step.  It is a function of the seed alone: the same seed gives the
same batches in the same order.
"""
from __future__ import annotations

import numpy as np

EOS = 1


def _token_row(r: np.random.Generator, seq_len: int, vocab: int, mean_doc_len: int):
    """One packed row of ``seq_len + 1`` tokens: documents of geometric
    length, Zipf ids in ``[2, vocab)``, each ended by EOS.  A row with one
    slot left ends in EOS (the port's copy indexes past the row there)."""
    toks = np.empty(seq_len + 1, dtype=np.int32)
    filled = 0
    while filled < seq_len + 1:
        ln = int(r.geometric(1.0 / mean_doc_len))
        if seq_len + 1 - filled == 1:
            toks[filled] = EOS
            break
        ln = max(2, min(ln, seq_len + 1 - filled))
        body = r.zipf(1.3, size=ln - 1)
        toks[filled:filled + ln - 1] = 2 + (body % (vocab - 2))
        toks[filled + ln - 1] = EOS
        filled += ln
    return toks


def train_batch(mix: dict, seed: int, vocab: int, step: int) -> dict:
    """The batch of ``step``: ``tokens`` and ``labels`` ``(batch, seq_len)``
    int32 (the port's ``SyntheticPipeline(...).batch(step)`` to the bit
    wherever that one does not raise)."""
    r = np.random.default_rng(np.random.SeedSequence(entropy=seed, spawn_key=(step, 0)))
    rows = np.stack([_token_row(r, mix["seq_len"], vocab, mix["mean_doc_len"])
                     for _ in range(mix["batch"])])
    return {"tokens": rows[:, :mix["seq_len"]], "labels": rows[:, 1:mix["seq_len"] + 1]}
