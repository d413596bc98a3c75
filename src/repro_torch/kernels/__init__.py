"""Hand-written Hopper kernels of the port and their entry points.

``ep_spmv`` holds the SpMV kernels' wrappers and plain PyTorch twins; ``ops``
the pack -> kernel -> combine entry points; ``flash_attention`` and
``moe_mlp`` the serving path's attention and expert-FFN kernels, and
``flash_attention_train`` / ``flash_attention_backward`` the training path's
attention; ``ref`` the plain oracles (the attention and expert-FFN twins).  :func:`launch_counts` reads every
wrapper's launch count.
"""
from .ep_spmv import (
    ep_combine,
    spmv_software_cache,
    spmv_streaming,
    spmv_streaming_batched,
)
from .flash_attention import flash_attention, flash_attention_backward, flash_attention_train
from .moe_mlp import moe_mlp
from .ops import (
    BucketSpec,
    PaddedOperands,
    ep_spmv,
    make_bucketed_spmv_fn,
    make_ep_spmv_fn,
    pad_plan_operands,
    resolve_plan,
    spmv_hbm_traffic_model,
)

__all__ = [
    "BucketSpec",
    "PaddedOperands",
    "ep_combine",
    "ep_spmv",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_train",
    "launch_counts",
    "make_bucketed_spmv_fn",
    "make_ep_spmv_fn",
    "moe_mlp",
    "pad_plan_operands",
    "reset_launch_counts",
    "resolve_plan",
    "spmv_hbm_traffic_model",
    "spmv_software_cache",
    "spmv_streaming",
    "spmv_streaming_batched",
]

_KERNELS = (spmv_software_cache, spmv_streaming, spmv_streaming_batched, ep_combine,
            moe_mlp, flash_attention, flash_attention_train, flash_attention_backward)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by wrapper name."""
    return {fn.__name__: fn.launches for fn in _KERNELS}
