"""The serving model zoo of the port: dense and MoE transformers, Mamba2 (SSM), the
attention/Mamba hybrid and the encoder-decoder."""
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
