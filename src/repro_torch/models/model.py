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
from ..runtime import spans
from ..runtime.axes import hint
from . import transformer as tf
from .layers import dot_f32
from .params import Params
from .spmd import col, col_linear, is_dtensor, local_index, place, placements, shard_map, splits
from .transformer import cast_params_for_compute, cast_params_for_train

__all__ = ["Model", "chunked_ce_loss"]


def _ce_chunk(hc, w_head, yc):
    """Summed token cross-entropy of one chunk: its ``(B, c, V)`` float32 logits
    live only inside this call."""
    logits = hint(dot_f32(hc, w_head), "batch", None, "model")
    if not is_dtensor(logits):
        return torch.sum(_token_ce(logits, yc))
    if splits(logits.shape, ("batch", None, "model"), 2):
        return _ce_sharded(logits, yc)
    y_pl = placements(yc.shape, ("batch", None))  # the vocabulary is whole: per rank's tokens
    return torch.sum(shard_map(_token_ce, (logits, yc),
                               (placements(logits.shape, ("batch", None, None)), y_pl), y_pl))


def _token_ce(logits, yc):
    """Each token's cross-entropy ``(B, c)``: logsumexp minus the gold logit."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, yc.long()[..., None])[..., 0]


def _ce_sharded(logits, yc):
    """:func:`_ce_chunk`'s sum over DTensor logits whose vocabulary is
    sharded over 'model': each rank takes the max, the sum of exponentials
    and the gold logit over its vocabulary slice, and the three reduce over
    'model' (a max, then two sums) to the logsumexp and the gold logit."""
    l_pl = placements(logits.shape, ("batch", None, "model"))
    y_pl = placements(yc.shape, ("batch", None))
    part = ("model",)
    m = shard_map(lambda x: x.detach().amax(dim=-1), (logits,), (l_pl,),
                  placements(yc.shape, ("batch", None), part, "max"))
    m = m.redistribute(m.device_mesh, y_pl)

    def local(x, m, y):
        v = x.shape[-1]
        rel = y.long() - local_index("model", True) * v
        ok = (rel >= 0) & (rel < v)
        gold = torch.gather(x, -1, rel.clamp(0, v - 1)[..., None])[..., 0]
        return torch.exp(x - m[..., None]).sum(dim=-1), torch.where(ok, gold, 0.0)

    sum_exp, gold = shard_map(local, (logits, m, yc), (l_pl, y_pl, y_pl),
                              (placements(yc.shape, ("batch", None), part),) * 2)
    # Reduced before the log: a nonlinear op given a Partial input saves it
    # for backward, and PyTorch 2.11 then divides by one rank's share.
    sum_exp, gold = (t.redistribute(t.device_mesh, y_pl) for t in (sum_exp, gold))
    return torch.sum(m + torch.log(sum_exp) - gold)


@spans.traced("repro_torch.loss")
def chunked_ce_loss(h, w_head, labels, chunk: int) -> torch.Tensor:
    """Mean token cross-entropy of ``h (B, S, D)`` under the head ``w_head
    (D, V)`` against ``labels (B, S)``, computed ``chunk`` positions at a time.

    Each chunk's head product, logsumexp and gold logit run under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` on its scan
    body): the backward pass recomputes a chunk's logits, so at most one
    chunk's logits are alive in either pass.  Runs under the span
    ``repro_torch.loss``.
    """
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the loss chunk {chunk}")
    if is_dtensor(h):
        labels = place(labels, "batch", None)
        w_head = col(w_head)
    total = None
    for i in range(0, s, chunk):
        part = checkpoint(_ce_chunk, h[:, i:i + chunk], w_head, labels[:, i:i + chunk],
                          use_reentrant=False)
        total = part if total is None else total + part
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

    def abstract_params(self) -> Params:
        """The master weights' tree on the meta device: shapes and dtypes,
        no storage, nothing drawn (the dry-run's parameters)."""
        return tf.init_params(self.cfg, 0, "meta")

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
        return col_linear(h_last, tf.lm_head(p, self.cfg), dot_f32), cache

    def decode_step(self, params: Params, cache: dict, batch: dict, pos):
        """One-token step; returns (logits (B, V) f32, the cache updated in place)."""
        return tf.forward_decode(self.compute_params(params), self.cfg, cache, batch, pos)
