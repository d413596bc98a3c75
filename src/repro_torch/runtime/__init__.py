"""Runtime of the port: typed EP-SpMV requests, LM serving steps, the train
step and its spans (``spans``), the sharding rules and activation hints of a
mesh, and the fault-tolerance pieces replicated serving and training stand on.

``fault`` is imported eagerly (standard library only); the request, serving
and training names load their modules on first use (PEP 562), so that
``core/replica.py``'s ``from ..runtime.fault import ...`` does not pull in
torch and the kernels: a replica worker process imports ``repro_torch.core``
and must create no CUDA context.
"""
from .fault import (
    CircuitBreaker,
    FaultTolerantLoop,
    HeartbeatRegistry,
    OverloadSchedule,
    StragglerMonitor,
)

_LAZY = {
    "BucketKey": "request",
    "BucketPolicy": "request",
    "CompileCache": "request",
    "GraphRequest": "request",
    "GraphServer": "request",
    "ServeInfo": "request",
    "ServeResult": "request",
    "resolve_plan": "request",
    "ShardingRules": "sharding",
    "batch_specs": "sharding",
    "cache_spec_tree": "sharding",
    "make_sharding_rules": "sharding",
    "named": "sharding",
    "param_specs": "sharding",
    "tree_named": "sharding",
    "make_decode_step": "serve",
    "make_prefill_step": "serve",
    "TrainState": "train",
    "init_train_state": "train",
    "make_train_step": "train",
    "split_microbatches": "train",
}

__all__ = sorted([*_LAZY, "CircuitBreaker", "FaultTolerantLoop", "HeartbeatRegistry",
                  "OverloadSchedule", "StragglerMonitor"])


def __getattr__(name):
    if name in _LAZY:
        import importlib

        value = getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
