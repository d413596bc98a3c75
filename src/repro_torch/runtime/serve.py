"""Serving steps: batched prefill and one-token decode (port of ``repro.runtime.serve``).

Greedy sampling (argmax) stays on the device, so the served token path
does not leave it.  The reference's deprecated ``make_graph_serve_fn``
shim stays JAX-only; the port serves EP-SpMV through ``GraphServer``.
"""
from __future__ import annotations

import torch

__all__ = ["make_decode_step", "make_prefill_step"]


def make_prefill_step(model, max_len: int):
    def prefill_step(params, batch: dict):
        logits, cache = model.prefill(params, batch, max_len)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache: dict, tokens: torch.Tensor, pos: int):
        """tokens: (B, 1) int; pos: the write position."""
        logits, cache = model.decode_step(params, cache, {"tokens": tokens}, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return decode_step
