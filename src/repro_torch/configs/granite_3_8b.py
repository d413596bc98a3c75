# Copied verbatim from src/repro/configs/granite_3_8b.py; keep the two in step.
"""granite-3-8b [dense] — GQA.  [hf:ibm-granite/granite-3.0 family; hf]

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=12800,
        vocab_size=49155,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        rope_theta=10_000.0,
        tie_embeddings=True,
        attn_chunk_q=16,
        attn_chunk_kv=16,
        loss_chunk=16,
    )


register("granite-3-8b", full, reduced)
