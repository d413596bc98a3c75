"""Architectures the port has beyond the reference's configs: their settings and registration.

``configs/`` is a verbatim copy of the reference's, so a setting the
reference has no field for lives here, in subclasses of its settings:

  * :class:`MLASettings`: multi-head latent attention (DeepSeek-V2/V3): the
    keys and values come out of one shared latent, and the query/key head
    (``qk_nope_head_dim + qk_rope_head_dim``) is wider than the value head;
  * :class:`RoutedMoESettings`: the router's scoring (``softmax`` or
    ``sigmoid``), a correction bias on the scores that only picks the
    experts (``noaux_tc``), the scale of the routed weights, shared experts
    with or without a gate and of their own width, the balance loss (the
    Switch loss over the whole microbatch, or DeepSeek-V3's sequence-wise
    one), the experts' activation (SwiGLU, or Nemotron-H's non-gated
    squared ReLU) and the experts held here (the first ``held`` of the
    router's, the rest lying on other chips);
  * :class:`MambaSettings`: a Mamba2 mixer sized by its head count, with
    its gated norm taken per group of channels, as published Mamba2 takes
    it, at its own epsilon (the reference's ``SSMSettings`` keep one norm
    over the width at 1e-6, as the reference's mixer does);
  * :class:`LatentArchConfig`: an ``ArchConfig`` with ``mla`` and
    ``first_k_dense`` leading dense layers (of width ``d_ff``) before the
    MoE layers;
  * :class:`PatternArchConfig`: the ``pattern`` family, one mixer a layer
    (Mamba2, MoE or attention) as a pattern string lists them, attention
    without RoPE.

Importing :mod:`repro_torch` imports this module, which registers
``moonlight-16b-a3b``, ``nemotron-3-nano-30b-a3b`` and their reduced twins
in the same registry as the copied configs, so ``get_config`` finds them.
:data:`PORT_ONLY` names them: the reference has no cells of theirs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

from .configs.base import ArchConfig, MoESettings, SSMSettings, register

__all__ = ["LatentArchConfig", "MLASettings", "MambaSettings", "PORT_ONLY", "PatternArchConfig",
           "RoutedMoESettings", "mamba_width", "routed_settings"]

#: The archs registered here and not in the reference.
PORT_ONLY: tuple[str, ...] = ("moonlight-16b-a3b", "nemotron-3-nano-30b-a3b")


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
    activation: str = "swiglu"      # 'swiglu' | 'relu2' (down(relu(up(x))^2), no gate)
    d_ff_shared: int = 0            # the shared experts' width (0: n_shared_experts * d_ff_expert)
    held: int = 0                   # experts held here, from expert 0 (0: all n_experts)

    @property
    def n_held(self) -> int:
        return self.held or self.n_experts

    @property
    def shared_width(self) -> int:
        return self.d_ff_shared or self.n_shared_experts * self.d_ff_expert


@functools.lru_cache(maxsize=None)
def routed_settings(moe: MoESettings) -> RoutedMoESettings:
    """``moe`` as :class:`RoutedMoESettings` (the reference's settings take
    its defaults: softmax routing, gated SwiGLU experts, all of them held);
    converted once for each settings value, as each layer asks each step."""
    if isinstance(moe, RoutedMoESettings):
        return moe
    return RoutedMoESettings(**dataclasses.asdict(moe))


@dataclasses.dataclass(frozen=True)
class MambaSettings(SSMSettings):
    """Published Mamba2's mixer: ``n_heads`` heads of ``head_dim`` wide, its
    gated RMSNorm taken per group of ``d_inner / n_groups`` channels at
    ``norm_eps``."""

    n_heads: int = 0            # heads of head_dim; d_inner = n_heads * head_dim (0: expand * d)
    norm_eps: float = 1e-6      # the gated RMSNorm's epsilon

    def d_inner(self, d_model: int) -> int:
        return self.n_heads * self.head_dim if self.n_heads else self.expand * d_model


def mamba_width(ssm: SSMSettings, d_model: int) -> int:
    """The mixer's ``d_inner``: heads times ``head_dim`` for
    :class:`MambaSettings` with ``n_heads``, else ``expand * d`` as the
    reference sizes it."""
    return ssm.d_inner(d_model) if isinstance(ssm, MambaSettings) else ssm.expand * d_model


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


@dataclasses.dataclass(frozen=True)
class PatternArchConfig(ArchConfig):
    """The ``pattern`` family: layer ``i`` is ``h + mixer(RMSNorm(h))`` with
    the mixer that ``pattern[i]`` names, ``M`` Mamba2 (``ssm``), ``E`` MoE
    (``moe``), ``*`` attention; no layer has a second half.  The attention
    layers take no positions (NoPE), as Nemotron-H's modeling code runs them."""

    pattern: str = ""

    def layer_kinds(self) -> list[str]:
        kinds = {"M": "mamba", "E": "moe", "*": "attn"}
        return [kinds[c] for c in self.pattern[: self.n_layers]]

    def ffn_kinds(self) -> list[str]:
        return ["none"] * self.n_layers


NEMOTRON_PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"


def nemotron_full() -> PatternArchConfig:
    """nemotron-3-nano-30b-a3b [hybrid Mamba2 + MoE] —
    hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 (nemotron_h).

    52L d_model=2688 (23 Mamba2, 23 MoE, 6 attention by
    ``hybrid_override_pattern``), vocab 131072 untied, eps 1e-5.  Mamba2: 64
    heads of 64 (d_inner 4096, not expand * d), 8 groups, state 128, conv 4
    with a bias, chunk 128, the gated norm per group of 512.  Attention: 32
    q / 2 kv heads of 128, no RoPE (the modeling code passes no positions).
    MoE: 128 experts top-6 of 1856, non-gated squared ReLU, sigmoid scores
    with a correction bias, weights renormalised and scaled by 2.5, one
    ungated shared expert of 3712.  aux_loss_weight 0.001 (the sequence-wise
    loss) is assumed; capacity 1.25 is the port's."""
    return PatternArchConfig(
        name="nemotron-3-nano-30b-a3b", family="pattern", n_layers=52, d_model=2688,
        n_heads=32, n_kv_heads=2, d_head=128, d_ff=0, vocab_size=131072, norm_eps=1e-5,
        pattern=NEMOTRON_PATTERN,
        ssm=MambaSettings(d_state=128, d_conv=4, head_dim=64, n_groups=8, chunk=128, n_heads=64,
                          norm_eps=1e-5),
        moe=RoutedMoESettings(n_experts=128, top_k=6, d_ff_expert=1856, n_shared_experts=1,
                              aux_loss_weight=0.001, scoring="sigmoid", correction_bias=True,
                              routed_scale=2.5, shared_gate=False, balance="sequence",
                              activation="relu2", d_ff_shared=3712),
    )


def nemotron_reduced() -> PatternArchConfig:
    """Every mechanism at small widths: Mamba2, MoE and attention layers, 2
    groups, 4 of 8 experts held, a shared expert of its own width."""
    return PatternArchConfig(
        name="nemotron-3-nano-30b-a3b", family="pattern", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=0, vocab_size=512, norm_eps=1e-5, pattern="MEM*EM",
        ssm=MambaSettings(d_state=16, d_conv=4, head_dim=16, n_groups=2, chunk=8, n_heads=4,
                          norm_eps=1e-5),
        moe=RoutedMoESettings(n_experts=8, top_k=3, d_ff_expert=32, n_shared_experts=1,
                              aux_loss_weight=0.001, scoring="sigmoid", correction_bias=True,
                              routed_scale=2.5, shared_gate=False, balance="sequence",
                              activation="relu2", d_ff_shared=48, held=4),
        attn_chunk_q=16, attn_chunk_kv=16, loss_chunk=16,
    )


register("nemotron-3-nano-30b-a3b", nemotron_full, nemotron_reduced)
