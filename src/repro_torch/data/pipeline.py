# Copied verbatim from src/repro/data/pipeline.py; keep the two in step.
"""Deterministic, stateless-resumable synthetic data pipeline.

Every batch is a pure function of (seed, step) — after a restart at step s
the pipeline regenerates batch s bit-exactly with no iterator state to
checkpoint (the standard large-run recipe: data order is derived, not
stored).  Per-host sharding takes (host_index, host_count) and yields only
that host's slice of the global batch.

Documents are synthetic Zipf token streams *packed* into fixed-length rows
(sequence packing: multiple short docs per row, separated by EOS, no pad
waste) — irregular document lengths are what make the packing non-trivial,
matching production text pipelines.

Frontend-stub archs (audio/vision) get deterministic embedding tensors +
M-RoPE position streams instead of token ids, per the task spec.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["PipelineConfig", "SyntheticPipeline", "pack_documents"]

EOS = 1


def pack_documents(doc_lengths: np.ndarray, seq_len: int) -> list[list[int]]:
    """First-fit packing of docs into rows of seq_len; returns doc ids/row."""
    rows: list[list[int]] = []
    space: list[int] = []
    for i, ln in enumerate(doc_lengths):
        ln = int(min(ln, seq_len))
        placed = False
        for r, s in enumerate(space):
            if s >= ln:
                rows[r].append(i)
                space[r] -= ln
                placed = True
                break
        if not placed:
            rows.append([i])
            space.append(seq_len - ln)
    return rows


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    frontend: Optional[str] = None  # 'audio' | 'vision'
    d_model: int = 0                # for frontend embeds
    host_index: int = 0
    host_count: int = 1


class SyntheticPipeline:
    """batch(step) -> dict of numpy arrays (this host's shard)."""

    def __init__(self, cfg: PipelineConfig):
        if cfg.global_batch % cfg.host_count:
            raise ValueError("global_batch must divide by host_count")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count

    def _rng(self, step: int) -> np.random.Generator:
        # Philox keyed on (seed, step, host): stateless resume + host shard.
        return np.random.default_rng(
            np.random.SeedSequence(
                entropy=self.cfg.seed, spawn_key=(step, self.cfg.host_index)
            )
        )

    def _token_row(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        # Draw doc lengths until the row is full, Zipf-ish token ids.
        toks = np.empty(cfg.seq_len + 1, dtype=np.int32)
        filled = 0
        while filled < cfg.seq_len + 1:
            ln = int(rng.geometric(1.0 / cfg.mean_doc_len))
            ln = max(2, min(ln, cfg.seq_len + 1 - filled))
            # Zipf body in [2, vocab): 0 reserved pad, 1 = EOS.
            body = rng.zipf(1.3, size=ln - 1)
            body = 2 + (body % (cfg.vocab_size - 2))
            toks[filled : filled + ln - 1] = body
            toks[filled + ln - 1] = EOS
            filled += ln
        return toks

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = self._rng(step)
        out: dict[str, np.ndarray] = {}
        rows = np.stack([self._token_row(rng) for _ in range(self.local_batch)])
        tokens = rows[:, : cfg.seq_len]
        labels = rows[:, 1 : cfg.seq_len + 1]
        if cfg.frontend:
            # Stub frontend: precomputed frame/patch embeddings.
            out["embeds"] = rng.standard_normal(
                (self.local_batch, cfg.seq_len, cfg.d_model), dtype=np.float32
            )
            if cfg.frontend == "vision":
                # M-RoPE (t, h, w) streams: a synthetic grid raster.
                side = max(1, int(np.sqrt(cfg.seq_len)))
                idx = np.arange(cfg.seq_len)
                pos3 = np.stack(
                    [idx, (idx // side) % side, idx % side]
                ).astype(np.int32)  # (3, S)
                out["positions3"] = np.broadcast_to(
                    pos3[:, None, :], (3, self.local_batch, cfg.seq_len)
                ).copy()
        else:
            out["tokens"] = tokens
        out["labels"] = labels
        return out

    def enc_dec_batch(self, step: int) -> dict:
        """encdec variant: encoder embeds + decoder tokens."""
        cfg = self.cfg
        base = self.batch(step)
        rng = self._rng(step)
        base["enc_embeds"] = rng.standard_normal(
            (self.local_batch, cfg.seq_len, cfg.d_model), dtype=np.float32
        )
        if "tokens" not in base:
            base["tokens"] = base.pop("embeds") * 0  # pragma: no cover
        return base
