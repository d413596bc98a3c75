"""Architectures the port has beyond the reference's configs: their settings and registration.

``configs/`` is a verbatim copy of the reference's, so a setting the
reference has no field for lives here, in subclasses of its settings:

  * :class:`MLASettings`: multi-head latent attention (DeepSeek-V2/V3): the
    keys and values come out of one shared latent, and the query/key head
    (``qk_nope_head_dim + qk_rope_head_dim``) is wider than the value head;
  * :class:`RoutedMoESettings`: the router's scoring (``softmax`` or
    ``sigmoid``), a correction bias on the scores that only picks the
    experts (``noaux_tc``), the scale of the routed weights, shared experts
    with or without a gate, and the balance loss (the Switch loss over the
    whole microbatch, or DeepSeek-V3's sequence-wise one);
  * :class:`LatentArchConfig`: an ``ArchConfig`` with ``mla`` and
    ``first_k_dense`` leading dense layers (of width ``d_ff``) before the
    MoE layers.

Importing :mod:`repro_torch` imports this module, which registers
``moonlight-16b-a3b`` and its reduced twin in the same registry as the
copied configs, so ``get_config`` finds them.  :data:`PORT_ONLY` names
them: the reference has no cells of theirs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .configs.base import ArchConfig, MoESettings, register

__all__ = ["LatentArchConfig", "MLASettings", "PORT_ONLY", "RoutedMoESettings"]

#: The archs registered here and not in the reference.
PORT_ONLY: tuple[str, ...] = ("moonlight-16b-a3b",)


@dataclasses.dataclass(frozen=True)
class MLASettings:
    kv_lora_rank: int       # the latent's width
    qk_nope_head_dim: int   # a query/key head's part without RoPE
    qk_rope_head_dim: int   # its RoPE part; keys share one such head
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class RoutedMoESettings(MoESettings):
    scoring: str = "softmax"        # 'softmax' | 'sigmoid' (float32 scores)
    correction_bias: bool = False   # a bias added to the scores to pick the experts only
    routed_scale: float = 1.0       # the routed weights' scale after renormalising
    shared_gate: bool = True        # shared experts under a sigmoid gate, else added as they are
    balance: str = "switch"         # 'switch' (the microbatch) | 'sequence' (each row)


@dataclasses.dataclass(frozen=True)
class LatentArchConfig(ArchConfig):
    mla: Optional[MLASettings] = None
    first_k_dense: int = 0  # leading layers with a dense SwiGLU of width d_ff

    def ffn_kinds(self) -> list[str]:
        return ["mlp" if i < self.first_k_dense else k for i, k in enumerate(super().ffn_kinds())]


def _moonlight_moe(**kw) -> RoutedMoESettings:
    return RoutedMoESettings(every=1, aux_loss_weight=0.001, scoring="sigmoid",
                             correction_bias=True, routed_scale=2.446, shared_gate=False,
                             balance="sequence", **kw)


def moonlight_full() -> LatentArchConfig:
    """moonlight-16b-a3b [moe, MLA] — hf:moonshotai/Moonlight-16B-A3B (deepseek_v3).

    27L d_model=2048 16H, MLA (no q-LoRA, latent 512, q/k heads 128 + 64,
    v heads 128), vocab 163840, rope_theta 50000, rms eps 1e-5; layer 0 a
    dense SwiGLU of 11264, layers 1-26 MoE of 64 experts top-6 of 1408 with
    2 ungated shared experts, sigmoid scores with a correction bias,
    weights renormalised and scaled by 2.446.  ``d_head`` is the query/key
    head (192).  aux_loss_weight 0.001 is assumed (DeepSeek-V3's
    ``aux_loss_alpha``); capacity 1.25 is the port's."""
    return LatentArchConfig(
        name="moonlight-16b-a3b", family="moe", n_layers=27, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=192, d_ff=11264, vocab_size=163840, rope_theta=50_000.0,
        norm_eps=1e-5,
        moe=_moonlight_moe(n_experts=64, top_k=6, d_ff_expert=1408, n_shared_experts=2),
        mla=MLASettings(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                        v_head_dim=128),
        first_k_dense=1,
    )


def moonlight_reduced() -> LatentArchConfig:
    return LatentArchConfig(
        name="moonlight-16b-a3b", family="moe", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_head=24, d_ff=96, vocab_size=512, rope_theta=50_000.0, norm_eps=1e-5,
        moe=_moonlight_moe(n_experts=8, top_k=3, d_ff_expert=32, n_shared_experts=2),
        mla=MLASettings(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        first_k_dense=1, attn_chunk_q=16, attn_chunk_kv=16, loss_chunk=16,
    )


register("moonlight-16b-a3b", moonlight_full, moonlight_reduced)
