# Copied verbatim from src/repro/configs/mamba2_2_7b.py; keep the two in step.
"""mamba2-2.7b [ssm] — SSD (state-space duality).  [arXiv:2405.21060; unverified]

64L d_model=2560 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads, 1 state group.
Attention-free: no KV cache; decode carries (conv_state, ssm_state) only,
which is why this arch runs the long_500k cell.
"""
from .base import ArchConfig, SSMSettings, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_head=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMSettings(d_state=128, expand=2, d_conv=4, head_dim=64, n_groups=1, chunk=256),
        tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_head=0,
        d_ff=0,
        vocab_size=512,
        ssm=SSMSettings(d_state=16, expand=2, d_conv=4, head_dim=32, n_groups=1, chunk=16),
        tie_embeddings=True,
        loss_chunk=16,
    )


register("mamba2-2.7b", full, reduced)
