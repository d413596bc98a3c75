# Copied verbatim from src/repro/configs/qwen3_32b.py; keep the two in step.
"""qwen3-32b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936; head_dim=128
(attention width 8192 > d_model, faithful to the HF config), per-head
RMSNorm on q/k.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,  # attention width 128 > d_model 64, like the full config
        d_ff=128,
        vocab_size=512,
        qk_norm=True,
        attn_chunk_q=16,
        attn_chunk_kv=16,
        loss_chunk=16,
    )


register("qwen3-32b", full, reduced)
