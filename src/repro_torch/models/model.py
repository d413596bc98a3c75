"""Public model facade: init, training loss, prefill and decode (port of ``repro.models.model``).

``Model(cfg, device)`` initialises weights, allocates the decode cache (K/V;
the conv and SSD states of the ``ssm`` family; both for ``hybrid``; K/V and
the cross-attention's for ``encdec``), and runs prefill and one-token decode
for every family.  A prefill batch holds ``tokens`` or a front end's
``embeds`` (with M-RoPE's ``positions3``), and for ``encdec`` the encoder's
``enc_embeds``; it is passed through as it is.  A
server casts the compute-type copies of the master weights once, with
:meth:`Model.compute_params`, and passes the copies to every step; a step
casts what it is given, which leaves copies already of the compute type as
they are, so passing the masters gives the same numbers, as the reference
does.  The training loss, :meth:`Model.loss_fn`, casts the masters inside
autograd's graph (:func:`~repro_torch.models.transformer.cast_params_for_train`),
runs :func:`~repro_torch.models.transformer.forward_train` and the chunked
cross-entropy :func:`chunked_ce_loss`, whose ``(B, S, vocab)`` logits are
never built whole.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import transformer as tf
from .layers import dot_f32
from .params import Params
from .transformer import cast_params_for_compute, cast_params_for_train

__all__ = ["Model", "chunked_ce_loss"]


def _ce_chunk(hc, w_head, yc):
    """Summed token cross-entropy of one chunk: its ``(B, c, V)`` float32 logits
    live only inside this call."""
    logits = dot_f32(hc, w_head)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_ce_loss(h, w_head, labels, chunk: int) -> torch.Tensor:
    """Mean token cross-entropy of ``h (B, S, D)`` under the head ``w_head
    (D, V)`` against ``labels (B, S)``, computed ``chunk`` positions at a time.

    Each chunk's head product, logsumexp and gold logit run under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` on its scan
    body): the backward pass recomputes a chunk's logits, so at most one
    chunk's logits are alive in either pass.
    """
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the loss chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, chunk):
        total = total + checkpoint(_ce_chunk, h[:, i:i + chunk], w_head,
                                   labels[:, i:i + chunk], use_reentrant=False)
    return total / (b * s)


class Model:
    """Family-dispatched model API (training loss, prefill, decode) over an
    ArchConfig, on one device."""

    def __init__(self, cfg, device=None):
        tf.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- parameters -------------------------------------------------------

    def init(self, seed: int = 0) -> Params:
        """Master weights (``cfg.param_dtype``) drawn on this model's device."""
        return tf.init_params(self.cfg, seed, self.device)

    def compute_params(self, params: Params) -> Params:
        """Compute-type copies of ``params`` (leaves kept f32 are shared)."""
        return cast_params_for_compute(params, self.cfg)

    # -- training ---------------------------------------------------------

    def loss_fn(self, params: Params, batch: dict):
        """``(loss, {"ce", "aux"})`` of a batch of ``tokens`` or ``embeds``
        (with ``enc_embeds``, ``positions3`` where the family takes them) and
        ``labels``; the loss adds ``aux_loss_weight * aux`` for MoE.  The
        gradients of ``loss`` reach ``params`` when they are trainable."""
        cfg = self.cfg
        p = cast_params_for_train(params, cfg)
        h, aux = tf.forward_train(p, cfg, batch)
        ce = chunked_ce_loss(h, tf.lm_head(p, cfg), batch["labels"], cfg.loss_chunk)
        loss = ce
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_weight * aux
        return loss, {"ce": ce, "aux": aux}

    # -- serving ----------------------------------------------------------

    def init_cache(self, batch_size: int, max_len: int, enc_len: int = 0) -> dict:
        return tf.init_cache(self.cfg, batch_size, max_len, self.device, enc_len)

    def prefill(self, params: Params, batch: dict, max_len: int):
        """Full-context forward; returns (last-token logits (B, V) f32, cache).

        ``params`` are the master weights or their :meth:`compute_params`."""
        p = self.compute_params(params)
        h_last, cache = tf.forward_prefill(p, self.cfg, batch, max_len)
        return dot_f32(h_last, tf.lm_head(p, self.cfg)), cache

    def decode_step(self, params: Params, cache: dict, batch: dict, pos):
        """One-token step; returns (logits (B, V) f32, the cache updated in place)."""
        return tf.forward_decode(self.compute_params(params), self.cfg, cache, batch, pos)
