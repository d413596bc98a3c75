"""Hand-written Hopper kernels of the port and their entry points.

``ep_spmv`` holds the CUDA kernels' wrappers and plain PyTorch twins; ``ops``
the pack -> kernel -> combine entry points; ``ref`` the COO oracle.
"""
from .ep_spmv import (
    ep_combine,
    launch_counts,
    reset_launch_counts,
    spmv_software_cache,
    spmv_streaming,
    spmv_streaming_batched,
)
from .ops import (
    BucketSpec,
    PaddedOperands,
    ep_spmv,
    make_bucketed_spmv_fn,
    make_ep_spmv_fn,
    pad_plan_operands,
    spmv_hbm_traffic_model,
)

__all__ = [
    "BucketSpec",
    "PaddedOperands",
    "ep_combine",
    "ep_spmv",
    "launch_counts",
    "make_bucketed_spmv_fn",
    "make_ep_spmv_fn",
    "pad_plan_operands",
    "reset_launch_counts",
    "spmv_hbm_traffic_model",
    "spmv_software_cache",
    "spmv_streaming",
    "spmv_streaming_batched",
]
