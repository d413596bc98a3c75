"""The serving model zoo of the port: dense and MoE transformers and Mamba2 (SSM)."""
from .model import Model
from .params import Params, params_from_reference
from .transformer import forward_decode, forward_prefill, init_cache, init_params

__all__ = [
    "Model",
    "Params",
    "forward_decode",
    "forward_prefill",
    "init_cache",
    "init_params",
    "params_from_reference",
]
