"""Collective traffic and roofline terms (port of ``repro.launch.hlo``).

The per-op link-traffic model of the reference, ring algorithms over a
group of ``N`` ranks, ``S`` the bytes named below:

    all-reduce         2·S·(N−1)/N      (reduce-scatter + all-gather phases)
    all-gather         S·(N−1)/N        (S = output bytes, already gathered)
    reduce-scatter     S·(N−1)          (S = output bytes; input = N·S)
    all-to-all         S·(N−1)/N
    collective-permute S                (point-to-point)

Roofline terms, per device:

    compute    = FLOPs / (chips · peak bf16 FLOP/s)
    memory     = bytes / (chips · device-memory rate)
    collective = per-device collective bytes / link rate

:class:`HW` holds one NVIDIA H100 SXM's published figures (NVIDIA's data
sheet, dense rates, at the full 700 W power limit): 989e12 bf16 FLOP/s on
the tensor cores, 3.35e12 B/s of HBM3, 80 GB of it, and NVLink 4 at 450e9
B/s a direction.  They are datasheet constants, not measurements.

The reference's ``parse_collectives`` reads the text of an XLA HLO module;
PyTorch has no such module to read, so it has no counterpart here.  The
dry-run (:mod:`repro_torch.launch.dryrun`) counts each collective as it is
dispatched instead and prices it with :func:`ring_traffic`.  Likewise
``repro.launch.hlo_analysis`` (per-device FLOPs, fusion-boundary bytes and
collective bytes of a partitioned module, loop-aware) has no file here:
the dry-run's counters take its role.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "HW",
    "CollectiveStats",
    "RooflineTerms",
    "ring_traffic",
    "roofline_terms",
    "shape_bytes",
]


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM data-sheet constants (dense, 700 W)."""

    peak_flops: float = 989e12       # bf16 FLOP/s per card, tensor cores
    hbm_bw: float = 3.35e12          # B/s per card
    link_bw: float = 450e9           # B/s per direction, NVLink 4
    hbm_bytes: float = 80e9


def shape_bytes(dtype: torch.dtype, shape) -> int:
    """Bytes of a dense tensor of ``shape`` and ``dtype``."""
    return torch.empty((), dtype=dtype).element_size() * math.prod(int(d) for d in shape)


def ring_traffic(op: str, nbytes: float, n: int) -> float:
    """Bytes one rank sends over its links for ``op`` in a group of ``n``
    (``nbytes`` as the module docstring names it); 0 for a group of one."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * nbytes * (n - 1) / n
    if op in ("all-gather", "all-to-all"):
        return nbytes * (n - 1) / n
    if op == "reduce-scatter":
        return float(nbytes) * (n - 1)
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class CollectiveStats:
    per_chip_bytes: float = 0.0
    op_bytes: dict = dataclasses.field(default_factory=dict)
    op_counts: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, traffic: float):
        self.per_chip_bytes += traffic
        self.op_bytes[op] = self.op_bytes.get(op, 0.0) + traffic
        self.op_counts[op] = self.op_counts.get(op, 0) + 1


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: float  # per chip

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self, model_flops: float, chips: int, hw: HW = HW()) -> float:
        """Useful-FLOPs throughput / peak, at the roofline step time."""
        if self.step_time_s == 0:
            return 0.0
        return model_flops / chips / self.step_time_s / hw.peak_flops


def roofline_terms(
    flops: float,
    bytes_accessed: float,
    collective_per_chip_bytes: float,
    chips: int,
    hw: HW = HW(),
) -> RooflineTerms:
    """``flops``/``bytes_accessed`` over ``chips`` devices; collectives per
    device.  The dry-run counts per device and passes ``chips=1``."""
    return RooflineTerms(
        compute_s=flops / (chips * hw.peak_flops),
        memory_s=bytes_accessed / (chips * hw.hbm_bw),
        collective_s=collective_per_chip_bytes / hw.link_bw,
        flops=flops,
        bytes_accessed=bytes_accessed,
        collective_bytes=collective_per_chip_bytes,
    )
