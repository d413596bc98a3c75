# Copied verbatim from src/repro/configs/_register_all.py; keep the two in step.
"""Importing this module registers every assigned architecture."""
from . import (  # noqa: F401
    granite_3_8b,
    jamba_1_5_large_398b,
    mamba2_2_7b,
    minitron_8b,
    phi4_mini_3_8b,
    qwen2_moe_a2_7b,
    qwen2_vl_2b,
    qwen3_32b,
    qwen3_moe_30b_a3b,
    seamless_m4t_medium,
)
