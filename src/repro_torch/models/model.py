"""Public model facade for serving (port of ``repro.models.model``).

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
does.  The training loss (``loss_fn``, ``chunked_ce_loss``) waits for the
training slice.
"""
from __future__ import annotations

from ..device import resolve_device
from . import transformer as tf
from .layers import dot_f32
from .params import Params
from .transformer import cast_params_for_compute

__all__ = ["Model"]


class Model:
    """Family-dispatched serving API over an ArchConfig, on one device."""

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
