# Copied verbatim from src/repro/configs/seamless_m4t_medium.py; keep the two in step.
"""seamless-m4t-medium [audio] — encoder-decoder multimodal backbone.

12L d_model=1024 16H (GQA kv=16 = MHA) d_ff=4096 vocab=256206
[arXiv:2308.11596; hf].  12 encoder + 12 decoder layers (the spec's "12L"
names the per-stack depth of the medium text model).  The audio frontend is
a STUB per the task spec: input_specs() supplies precomputed frame
embeddings (B, S, D) to the encoder; the decoder consumes token ids.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-medium",
        family="encdec",
        n_layers=12,
        n_encoder_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_head=64,
        d_ff=4096,
        vocab_size=256206,
        frontend="audio",
        rope_theta=10_000.0,
        notes="enc-dec; audio frontend stubbed with precomputed frame embeddings",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-medium",
        family="encdec",
        n_layers=2,
        n_encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        frontend="audio",
        rope_theta=10_000.0,
        attn_chunk_q=16,
        attn_chunk_kv=16,
        loss_chunk=16,
    )


register("seamless-m4t-medium", full, reduced)
