"""Entry points of the port (``python -m repro_torch.launch.serve``, ``.train``,
``.dryrun``) and the meshes, input specs and roofline model they use.

``make_host_mesh`` and ``make_production_mesh`` (``launch/mesh.py``) are
loaded on first use: importing this package starts no process group and
imports no ``torch.distributed`` state.
"""

__all__ = ["make_host_mesh", "make_production_mesh"]


def __getattr__(name):
    if name in __all__:
        from . import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
