"""The port's copies of the host core and configs give the reference's exactly.

``src/repro_torch/core`` and ``src/repro_torch/configs`` hold verbatim copies
of ``src/repro/core`` and ``src/repro/configs`` modules,
``src/repro_torch/runtime/fault.py`` copies of the five classes of
``src/repro/runtime/fault.py`` (verbatim but for ``FaultTolerantLoop``'s
structure template), ``src/repro_torch/data/pipeline.py`` a verbatim copy of
``src/repro/data/pipeline.py``, and ``src/repro_torch/launch/replica_worker.py``
a copy of ``src/repro/launch/replica_worker.py`` that names the port's
package; these tests catch the two drifting apart.
"""
import ast
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.partition_service import graph_fingerprint as ref_fingerprint
from repro_torch.core.partition_service import graph_fingerprint as port_fingerprint

CONFIG_COPIES = ["__init__", "_register_all", "base", "granite_3_8b", "jamba_1_5_large_398b",
                 "mamba2_2_7b", "minitron_8b", "phi4_mini_3_8b", "qwen2_moe_a2_7b", "qwen2_vl_2b",
                 "qwen3_32b", "qwen3_moe_30b_a3b", "seamless_m4t_medium"]
COPIES = ["graph", "refine", "coarsen", "partition", "transform", "baselines", "metrics",
          "edge_partition", "reorder", "admission", "plan_cache", "plan_scheduler",
          "partition_service", "replica", "transport", "hierarchy", "moe_schedule", "overhead"]
FAULT_CLASSES = ["CircuitBreaker", "OverloadSchedule", "HeartbeatRegistry", "StragglerMonitor",
                 "FaultTolerantLoop"]
# The one line of FaultTolerantLoop the port adapts: its structure template.
FAULT_SUBS = [("abstract = jax.tree.map(lambda x: x, state)  # structure template",
               "abstract = state  # structure template")]
# The only edits the port's replica worker makes to its source: the package
# name in imports, the -m module and _src_root, and the comments that named
# the JAX package's layout.
WORKER_SUBS = [
    ("repro.", "repro_torch."),
    ("import repro\n", "import repro_torch\n"),
    ("# repro is a namespace package (no __init__.py): locate it via __path__.",
     "# repro_torch is a regular package: its __path__ names src/repro_torch."),
    ("# Deferred: the parent only pays the jax import inside the child.",
     "# Deferred: only the child pays for importing the plan service."),
]
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_plan_and_fingerprint_identical(seed):
    n_rows, n_cols, npr, k = 160, 128, 4, 6
    ref_edges, rows, cols = ref_core.synthetic_bipartite_graph(n_rows, n_cols, npr, seed=seed)
    port_edges, rows2, cols2 = port_core.synthetic_bipartite_graph(n_rows, n_cols, npr,
                                                                   seed=seed)
    assert np.array_equal(rows, rows2) and np.array_equal(cols, cols2)

    ref_res = ref_core.edge_partition(ref_edges, k, method="ep", seed=seed)
    port_res = port_core.edge_partition(port_edges, k, method="ep", seed=seed)
    assert np.array_equal(ref_res.labels, port_res.labels)

    ref_plan = ref_core.build_pack_plan(n_rows, n_cols, rows, cols, ref_res.labels, k, pad=8)
    port_plan = port_core.build_pack_plan(n_rows, n_cols, rows, cols, port_res.labels, k,
                                          pad=8)
    for f in dataclasses.fields(ref_plan):
        a, b = getattr(ref_plan, f.name), getattr(port_plan, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name

    carried = port_core.PackPlan.from_arrays(ref_plan)
    for f in dataclasses.fields(ref_plan):
        assert np.array_equal(getattr(carried, f.name), getattr(port_plan, f.name)), f.name

    assert (ref_fingerprint(ref_edges, k, 8, None, "ep", 0, (n_rows, n_cols))
            == port_fingerprint(port_edges, k, 8, None, "ep", 0, (n_rows, n_cols)))


def test_core_exports_the_reference_surface():
    assert port_core.__all__ == ref_core.__all__
    for name in port_core.__all__:
        obj = getattr(port_core, name)
        assert obj.__module__.startswith("repro_torch.core"), name


def test_every_core_module_is_copied():
    ref = {p.stem for p in (SRC / "repro" / "core").glob("*.py")} - {"__init__"}
    port = {p.stem for p in (SRC / "repro_torch" / "core").glob("*.py")} - {"__init__"}
    assert port == ref == set(COPIES)


@pytest.mark.parametrize("name", COPIES)
def test_copy_is_verbatim_below_its_header(name):
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    ref = (src / "repro" / "core" / f"{name}.py").read_text()
    port = (src / "repro_torch" / "core" / f"{name}.py").read_text()
    header, body = port.split("\n", 1)
    assert header.startswith("# Copied") and f"src/repro/core/{name}.py" in header
    if name == "reorder":  # the port adds PackPlan.from_arrays and nothing else
        extra = body.index("    @classmethod\n    def from_arrays")
        end = body.index("    @property\n    def m(self)")
        body = body[:extra] + body[end:]
    assert body == ref


@pytest.mark.parametrize("name", CONFIG_COPIES)
def test_config_copy_is_verbatim_below_its_header(name):
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    ref = (src / "repro" / "configs" / f"{name}.py").read_text()
    header, body = (src / "repro_torch" / "configs" / f"{name}.py").read_text().split("\n", 1)
    assert header.startswith("# Copied") and f"src/repro/configs/{name}.py" in header
    assert body == ref


def test_every_config_is_copied():
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    assert sorted(p.stem for p in (src / "repro" / "configs").glob("*.py")) == sorted(CONFIG_COPIES)


def _classes(path: Path) -> dict:
    text = path.read_text()
    return {node.name: ast.get_source_segment(text, node)
            for node in ast.parse(text).body if isinstance(node, ast.ClassDef)}


@pytest.mark.parametrize("name", FAULT_CLASSES)
def test_fault_class_is_verbatim(name):
    ref = _classes(SRC / "repro" / "runtime" / "fault.py")
    port_path = SRC / "repro_torch" / "runtime" / "fault.py"
    header = port_path.read_text().split("\n", 1)[0]
    assert header.startswith("# Copied") and "src/repro/runtime/fault.py" in header
    port = _classes(port_path)
    assert sorted(port) == sorted(FAULT_CLASSES)
    want = ref[name]
    for old, new in FAULT_SUBS:
        want = want.replace(old, new)
    assert port[name] == want


def test_data_pipeline_is_verbatim():
    for name in ("pipeline", "__init__"):
        ref = (SRC / "repro" / "data" / f"{name}.py").read_text()
        port = (SRC / "repro_torch" / "data" / f"{name}.py").read_text()
        if name == "__init__":  # the same names, under the port's own docstring
            assert port.split('"""', 2)[2] == ref.split('"""', 2)[2]
            continue
        header, body = port.split("\n", 1)
        assert header.startswith("# Copied") and "src/repro/data/pipeline.py" in header
        assert body == ref


def test_replica_worker_differs_only_by_package_name():
    ref = (SRC / "repro" / "launch" / "replica_worker.py").read_text()
    header, body = (SRC / "repro_torch" / "launch" / "replica_worker.py").read_text().split(
        "\n", 1)
    assert header.startswith("# Copied") and "src/repro/launch/replica_worker.py" in header
    for old, new in WORKER_SUBS:
        assert old in ref, old
        ref = ref.replace(old, new)
    assert body == ref


def _reference_surfaces() -> dict:
    """``{module: __all__}`` of every module and package of ``src/repro``
    that lists one (read from the source: nothing of JAX is imported)."""
    out = {}
    for path in sorted((SRC / "repro").rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                    for t in node.targets):
                parts = path.relative_to(SRC / "repro").with_suffix("").parts
                out[".".join(p for p in parts if p != "__init__")] = ast.literal_eval(node.value)
    return out


REFERENCE_SURFACES = _reference_surfaces()
# What the reference exports and the port does not, each with its reason.
SURFACE_EXCEPTIONS = {
    ("launch.hlo_analysis", None): "reads XLA HLO text; the port's dry-run counts with Counters",
    ("launch.hlo", "parse_collectives"): "reads XLA HLO text; the dry-run counts with Counters",
    ("runtime.serve", "make_graph_serve_fn"): "a deprecated shim of the graph serving path",
    ("runtime", "make_graph_serve_fn"): "the same deprecated shim, re-exported",
}
# Modules whose surface the port keeps exactly (no names of its own).
EXACT_SURFACES = ("launch", "kernels.ops")


@pytest.mark.parametrize("name", sorted(REFERENCE_SURFACES, key=lambda n: (n not in EXACT_SURFACES,
                                                                            n)))
def test_package_surface_equals_the_reference(name):
    """Every module and package of the reference with an ``__all__`` has its
    counterpart in the port, exporting every one of its names (each
    resolving) but the exceptions named in ``SURFACE_EXCEPTIONS``; ``launch``
    and ``kernels.ops`` export exactly the reference's, each a callable."""
    if (name, None) in SURFACE_EXCEPTIONS:
        assert not (SRC / "repro_torch" / (name.replace(".", "/") + ".py")).exists()
        return
    port = importlib.import_module(f"repro_torch.{name}" if name else "repro_torch")
    want = [n for n in REFERENCE_SURFACES[name] if (name, n) not in SURFACE_EXCEPTIONS]
    assert not set(want) - set(port.__all__), sorted(set(want) - set(port.__all__))
    for attr in want:
        getattr(port, attr)
    if name in EXACT_SURFACES:
        assert port.__all__ == REFERENCE_SURFACES[name]
        for attr in port.__all__:
            assert callable(getattr(port, attr)), attr


def test_surface_exceptions_are_still_missing():
    """Each named exception is a name the port really lacks (none stale)."""
    for (name, attr) in SURFACE_EXCEPTIONS:
        assert name in REFERENCE_SURFACES, name
        if attr is not None:
            assert attr in REFERENCE_SURFACES[name]
            assert attr not in importlib.import_module(f"repro_torch.{name}").__all__


def _reference_params(qualname: str) -> list:
    module, *names = qualname.split(".")
    node = ast.parse((SRC / "repro" / "ckpt" / f"{module}.py").read_text())
    for name in names:
        node = next(n for n in node.body if getattr(n, "name", None) == name)
    return [a.arg for a in node.args.args + node.args.kwonlyargs]


@pytest.mark.parametrize("qualname", ["checkpoint.restore_pytree",
                                      "checkpoint.CheckpointManager.restore",
                                      "checkpoint.CheckpointManager.save",
                                      "checkpoint.save_pytree"])
def test_checkpoint_signatures_take_the_references_parameters(qualname):
    """The port's checkpoint entry points take every parameter the
    reference's take, ``shardings`` of the elastic re-mesh restore among them."""
    import inspect

    from repro_torch.ckpt import checkpoint

    fn = checkpoint
    for name in qualname.split(".")[1:]:
        fn = getattr(fn, name)
    ours = list(inspect.signature(fn).parameters)
    assert not set(_reference_params(qualname)) - set(ours), (ours, _reference_params(qualname))


def test_launch_reexports_are_lazy():
    """Importing ``repro_torch.launch`` loads no mesh module and starts no
    process group; reading a re-export loads it and still starts none."""
    code = ("import sys, torch.distributed as dist, repro_torch.launch as launch\n"
            "before = 'repro_torch.launch.mesh' in sys.modules\n"
            "fn = launch.make_production_mesh\n"
            "print(before, 'repro_torch.launch.mesh' in sys.modules, dist.is_initialized(),\n"
            "      fn.__module__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(SRC)}, check=True).stdout
    assert out.split() == ["False", "True", "False", "repro_torch.launch.mesh"]


def test_ops_moe_mlp_is_the_kernel_wrapper():
    """``kernels.ops.moe_mlp`` is the wrapper that counts the kernel's
    launches, not a copy of it."""
    import repro_torch.kernels as kernels
    from repro_torch.kernels import ops

    assert ops.moe_mlp is kernels.moe_mlp
    assert hasattr(ops.moe_mlp, "launches")
