"""Optimizer substrate of the port: AdamW, schedules, gradient compression."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .compress import compress_grads, compressed_psum, dequantize_int8, quantize_int8
from .schedule import constant, warmup_cosine

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "compress_grads",
    "compressed_psum",
    "constant",
    "dequantize_int8",
    "global_norm",
    "quantize_int8",
    "warmup_cosine",
]
