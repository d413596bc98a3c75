# Copied verbatim from src/repro/configs/base.py; keep the two in step.
"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; ``reduced()`` yields
the CPU-smoke-test variant of the same family (small widths/few layers/tiny
vocab — the family-defining structure is preserved: GQA ratios, MoE top-k,
SSD grouping, hybrid interleave, enc-dec split).

``REGISTRY`` maps ``--arch <id>`` names to configs; ``SHAPES`` maps shape
names to ``ShapeConfig``.  ``cells()`` enumerates the assigned (arch × shape)
grid, honouring the spec'd skips (long_500k only for sub-quadratic archs).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = [
    "MoESettings",
    "SSMSettings",
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "REGISTRY",
    "register",
    "get_config",
    "cells",
    "param_count",
]


@dataclasses.dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    every: int = 1          # MoE FFN at layers where (layer_idx % every == every - 1)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMSettings:
    d_state: int = 128
    expand: int = 2
    d_conv: int = 4
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int               # decoder layers
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int                   # dense-MLP width (0 for pure-MoE / pure-SSM archs)
    vocab_size: int
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    mrope: bool = False                       # qwen2-vl 3-section M-RoPE
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    frontend: Optional[str] = None            # 'audio' | 'vision' -> embeds-in stub
    moe: Optional[MoESettings] = None
    ssm: Optional[SSMSettings] = None
    attn_every: int = 0         # hybrid: 1 attn layer per this many layers (0 = all attn)
    attn_offset: int = 4        # position of the attn layer inside the hybrid period
    n_encoder_layers: int = 0   # encdec only
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "float32"      # master weights ('bfloat16' for the 398B config)
    compute_dtype: str = "bfloat16"   # activations/matmul dtype (mixed precision)
    # runtime knobs (shape-independent defaults; launchers may override)
    remat: bool = True
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    loss_chunk: int = 512
    notes: str = ""

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid — decode state is O(1) or
        attention layers are 1-in-8)."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> list[str]:
        """Mixer kind per decoder layer: 'attn' or 'mamba'."""
        if self.family == "ssm":
            return ["mamba"] * self.n_layers
        if self.attn_every:
            return [
                "attn" if (i % self.attn_every) == self.attn_offset else "mamba"
                for i in range(self.n_layers)
            ]
        return ["attn"] * self.n_layers

    def ffn_kinds(self) -> list[str]:
        """FFN kind per decoder layer: 'moe', 'mlp' or 'none'."""
        if self.family == "ssm":
            return ["none"] * self.n_layers
        out = []
        for i in range(self.n_layers):
            if self.moe is not None and (i % self.moe.every) == (self.moe.every - 1):
                out.append("moe")
            else:
                out.append("mlp" if self.d_ff else "none")
        return out


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


REGISTRY: dict[str, Callable[[], ArchConfig]] = {}
_REDUCED: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str, full: Callable[[], ArchConfig], reduced: Callable[[], ArchConfig]):
    REGISTRY[name] = full
    _REDUCED[name] = reduced


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    # Import side-effect registration of all arch modules.
    from . import _register_all  # noqa: F401

    table = _REDUCED if reduced else REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    cfg = table[name]()
    if reduced:
        # Smoke tests assert exact numerics: full-precision compute on CPU.
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    return cfg


def list_archs() -> list[str]:
    from . import _register_all  # noqa: F401

    return sorted(REGISTRY)


def cells(include_skips: bool = False) -> list[tuple[str, str, str]]:
    """The assigned (arch, shape, status) grid.

    status: 'run' or 'skip:<reason>'.  long_500k is skipped for pure
    full-attention archs per spec (recorded in DESIGN.md); no encoder-only
    archs are assigned, so decode shapes run everywhere.
    """
    from . import _register_all  # noqa: F401

    out = []
    for arch in sorted(REGISTRY):
        cfg = REGISTRY[arch]()
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.is_subquadratic:
                if include_skips:
                    out.append((arch, shape.name, "skip:full-attention at 524k"))
                continue
            out.append((arch, shape.name, "run"))
    return out


# ---------------------------------------------------------------------------
# Parameter counting (used for MODEL_FLOPS = 6·N·D in the roofline)
# ---------------------------------------------------------------------------


def param_count(cfg: ArchConfig) -> dict:
    """Analytic parameter counts: total and active-per-token (MoE-aware)."""
    d, dh = cfg.d_model, cfg.d_head
    attn = d * (cfg.n_heads * dh) + 2 * d * (cfg.n_kv_heads * dh) + (cfg.n_heads * dh) * d
    if cfg.qk_norm:
        attn += 2 * dh
    mlp = 3 * d * cfg.d_ff if cfg.d_ff else 0

    moe_total = moe_active = router = shared = 0
    if cfg.moe:
        e = cfg.moe
        per_expert = 3 * d * e.d_ff_expert
        moe_total = e.n_experts * per_expert
        moe_active = e.top_k * per_expert
        router = d * e.n_experts
        if e.n_shared_experts:
            shared = 3 * d * (e.n_shared_experts * e.d_ff_expert) + d
        moe_total += router + shared
        moe_active += router + shared

    mamba = 0
    if cfg.ssm:
        s = cfg.ssm
        d_inner = s.expand * d
        h = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.n_groups * s.d_state
        d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + h
        mamba = (
            d * d_in_proj + s.d_conv * conv_dim + conv_dim
            + 3 * h + d_inner + d_inner * d
        )

    layer_kinds = cfg.layer_kinds()
    ffn_kinds = cfg.ffn_kinds()
    total = active = 0
    for lk, fk in zip(layer_kinds, ffn_kinds):
        mixer = attn if lk == "attn" else mamba
        norms = 2 * d
        if fk == "moe":
            total += mixer + moe_total + norms
            active += mixer + moe_active + norms
        elif fk == "mlp":
            total += mixer + mlp + norms
            active += mixer + mlp + norms
        else:
            total += mixer + d
            active += mixer + d

    # Encoder stack (dense attn + MLP, bidirectional) + decoder cross-attn.
    if cfg.n_encoder_layers:
        enc_layer = attn + mlp + 2 * d
        cross = attn + d
        total += cfg.n_encoder_layers * enc_layer + cfg.n_layers * cross
        active += cfg.n_encoder_layers * enc_layer + cfg.n_layers * cross

    embed = cfg.vocab_size * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    total += embed + head + d
    active += embed + head + d
    return {"total": total, "active": active}
