# Copied verbatim from src/repro/configs/minitron_8b.py; keep the two in step.
"""minitron-8b [dense] — pruned Nemotron.  [arXiv:2407.14679; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=16384,
        vocab_size=256000,
        rope_theta=10_000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="minitron-8b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        rope_theta=10_000.0,
        attn_chunk_q=16,
        attn_chunk_kv=16,
        loss_chunk=16,
    )


register("minitron-8b", full, reduced)
