"""Deterministic synthetic data pipeline of the port (numpy only; a copy of ``repro.data``)."""
from .pipeline import EOS, PipelineConfig, SyntheticPipeline, pack_documents

__all__ = ["EOS", "PipelineConfig", "SyntheticPipeline", "pack_documents"]
