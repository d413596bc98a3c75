# Copied verbatim from src/repro/configs/__init__.py; keep the two in step.
"""Architecture & shape configs for the assigned (arch x shape) grid."""
from .base import (
    REGISTRY,
    SHAPES,
    ArchConfig,
    MoESettings,
    ShapeConfig,
    SSMSettings,
    cells,
    get_config,
    list_archs,
    param_count,
)

__all__ = [
    "REGISTRY",
    "SHAPES",
    "ArchConfig",
    "MoESettings",
    "ShapeConfig",
    "SSMSettings",
    "cells",
    "get_config",
    "list_archs",
    "param_count",
]
