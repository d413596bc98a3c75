# Copied verbatim from src/repro/configs/qwen2_moe_a2_7b.py; keep the two in step.
"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

24L d_model=2048 16H (GQA kv=16 = MHA) vocab=151936, MoE 60e top-4 with
expert d_ff=1408 plus 4 shared experts (implemented as one fused dense
SwiGLU of width 4x1408 with a sigmoid gate — mathematically identical to
the sum of 4 independent experts).
"""
from .base import ArchConfig, MoESettings, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=0,
        vocab_size=151936,
        moe=MoESettings(
            n_experts=60, top_k=4, d_ff_expert=1408, n_shared_experts=4, every=1
        ),
        rope_theta=1_000_000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=0,
        vocab_size=512,
        moe=MoESettings(n_experts=6, top_k=2, d_ff_expert=64, n_shared_experts=2, every=1),
        attn_chunk_q=16,
        attn_chunk_kv=16,
        loss_chunk=16,
    )


register("qwen2-moe-a2.7b", full, reduced)
