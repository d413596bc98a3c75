"""The serving model zoo of the port: dense and MoE transformers."""
from .model import Model
from .params import Params, params_from_reference

__all__ = ["Model", "Params", "params_from_reference"]
