"""Request layer of the port: typed EP-SpMV requests and LM serving steps on the device."""
from .request import (
    BucketKey,
    BucketPolicy,
    CompileCache,
    GraphRequest,
    GraphServer,
    ServeInfo,
    ServeResult,
    resolve_plan,
)
from .serve import make_decode_step, make_prefill_step

__all__ = [
    "BucketKey",
    "BucketPolicy",
    "CompileCache",
    "GraphRequest",
    "GraphServer",
    "ServeInfo",
    "ServeResult",
    "make_decode_step",
    "make_prefill_step",
    "resolve_plan",
]
