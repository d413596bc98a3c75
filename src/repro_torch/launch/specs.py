"""Abstract input specs for every (arch x shape) cell (port of ``repro.launch.specs``).

Each function returns meta-device tensors, the counterpart of the
reference's ``jax.ShapeDtypeStruct`` stand-ins: the shape and dtype of every
model input, with no storage.  The dry-run places them on its mesh; the
real launchers build tensors of the same shapes and dtypes.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs import ArchConfig, ShapeConfig
from ..models import Model

__all__ = ["train_input_specs", "prefill_input_specs", "decode_input_specs", "activation_dtype"]


def activation_dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch: dict[str, Any] = {"labels": _meta((b, s), torch.int32)}
    if cfg.frontend:
        batch["embeds"] = _meta((b, s, cfg.d_model), activation_dtype(cfg))
        if cfg.mrope:
            batch["positions3"] = _meta((3, b, s), torch.int32)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
    if cfg.family == "encdec":
        batch["enc_embeds"] = _meta((b, s, cfg.d_model), activation_dtype(cfg))
        batch["tokens"] = _meta((b, s), torch.int32)
    return batch


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    batch = train_input_specs(cfg, shape)
    batch.pop("labels")
    return batch


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Decode = ONE new token against a cache of seq_len."""
    b, s = shape.global_batch, shape.seq_len
    enc_len = s if cfg.family == "encdec" else 0
    cache = Model(cfg, "meta").init_cache(b, s, enc_len)
    return {
        "cache": cache,
        "tokens": _meta((b, 1), torch.int32),
        "pos": _meta((), torch.int32),
    }
