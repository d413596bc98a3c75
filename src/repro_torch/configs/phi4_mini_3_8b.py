# Copied verbatim from src/repro/configs/phi4_mini_3_8b.py; keep the two in step.
"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab_size=200064,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b",
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


register("phi4-mini-3.8b", full, reduced)
