# Copied verbatim from src/repro/configs/jamba_1_5_large_398b.py; keep the two in step.
"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536  [arXiv:2403.19887; hf]
Period of 8 layers: 1 attention (position 4) + 7 Mamba2; MoE FFN every other
layer.  bf16 params (398B at fp32 master + fp32 Adam states would not fit
256 chips; see DESIGN.md §6).
"""
from .base import ArchConfig, MoESettings, SSMSettings, register


def full() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=24576,
        vocab_size=65536,
        moe=MoESettings(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
        ssm=SSMSettings(d_state=128, expand=2, d_conv=4, head_dim=64, n_groups=1, chunk=256),
        attn_every=8,
        attn_offset=4,
        param_dtype="bfloat16",
        notes="hybrid 1:7 attn:mamba interleave; MoE every other layer",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        moe=MoESettings(n_experts=4, top_k=2, d_ff_expert=128, every=2),
        ssm=SSMSettings(d_state=16, expand=2, d_conv=4, head_dim=32, n_groups=1, chunk=16),
        attn_every=4,
        attn_offset=2,
        attn_chunk_q=16,
        attn_chunk_kv=16,
        loss_chunk=16,
    )


register("jamba-1.5-large-398b", full, reduced)
