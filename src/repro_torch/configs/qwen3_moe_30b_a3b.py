# Copied verbatim from src/repro/configs/qwen3_moe_30b_a3b.py; keep the two in step.
"""qwen3-moe-30b-a3b [moe] — 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]

48L d_model=2048 32H (GQA kv=4) vocab=151936, MoE 128e top-8 with expert
d_ff=768; every layer is MoE (no dense FFN).  head_dim=128, qk_norm (qwen3).
This is the PRIMARY attachment point of the paper's technique: EP-scheduled
expert placement + dispatch (core/moe_schedule.py) minimizes the biggest
all-to-all in the fleet.
"""
from .base import ArchConfig, MoESettings, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=0,  # pure MoE FFN
        vocab_size=151936,
        qk_norm=True,
        moe=MoESettings(n_experts=128, top_k=8, d_ff_expert=768, every=1),
        rope_theta=1_000_000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=0,
        vocab_size=512,
        qk_norm=True,
        moe=MoESettings(n_experts=8, top_k=2, d_ff_expert=64, every=1),
        attn_chunk_q=16,
        attn_chunk_kv=16,
        loss_chunk=16,
    )


register("qwen3-moe-30b-a3b", full, reduced)
