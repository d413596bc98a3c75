"""The serving model zoo of the port: dense and MoE transformers, Mamba2 (SSM), the
attention/Mamba hybrid and the encoder-decoder."""
from .model import Model, chunked_ce_loss
from .params import Params, params_from_reference
from .transformer import forward_decode, forward_prefill, forward_train, init_cache, init_params

__all__ = [
    "Model",
    "Params",
    "chunked_ce_loss",
    "forward_decode",
    "forward_prefill",
    "forward_train",
    "init_cache",
    "init_params",
    "params_from_reference",
]
