"""Request layer of the port: typed EP-SpMV requests served on the device."""
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

__all__ = [
    "BucketKey",
    "BucketPolicy",
    "CompileCache",
    "GraphRequest",
    "GraphServer",
    "ServeInfo",
    "ServeResult",
    "resolve_plan",
]
