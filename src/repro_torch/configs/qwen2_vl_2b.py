# Copied verbatim from src/repro/configs/qwen2_vl_2b.py; keep the two in step.
"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  The vision
frontend is a STUB per the task spec: input_specs() supplies precomputed
patch embeddings (B, S, D) plus the 3-stream (t, h, w) M-RoPE position ids.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_head=128,
        d_ff=8960,
        vocab_size=151936,
        mrope=True,
        mrope_sections=(16, 24, 24),
        frontend="vision",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        mrope=True,
        mrope_sections=(2, 3, 3),
        frontend="vision",
        tie_embeddings=True,
        attn_chunk_q=16,
        attn_chunk_kv=16,
        loss_chunk=16,
    )


register("qwen2-vl-2b", full, reduced)
