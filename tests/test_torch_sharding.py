"""The port's sharding rules, input specs and roofline model against the JAX package's.

``param_specs`` walks the port's tree in the reference's stacked layout, so
its spec tree must equal the reference's key for key, each reference
``PartitionSpec`` read as a tuple: for every registered arch at its FULL
config (real divisibility decisions; the trees live on the meta device and
in ``jax.eval_shape``), in both modes, on both production meshes (spec-only
stand-ins: no devices), for the master weights and for serving's
compute-type copies (the "big expert" rule reads the leaf's bytes).  The
batch and cache specs, the abstract input specs of every cell, the roofline
terms, the ring-traffic model (against ``parse_collectives`` on HLO lines
of each collective) and the dry-run's ``--all`` work list must equal the
reference's too.
"""
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (before repro.kernels: import cycle)
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import cells as jax_cells  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402  (the archs the reference has to compare with)
from repro.launch import hlo as jax_hlo  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.transformer import cast_params_for_compute as jax_cast  # noqa: E402
from repro.runtime import sharding as jax_sharding  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import hlo, specs  # noqa: E402
from repro_torch.launch.dryrun import work_list  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.transformer import cast_params_for_compute  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    batch_specs,
    cache_spec_tree,
    make_sharding_rules,
    param_specs,
)
from repro_torch.runtime.axes import to_placements  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    """Mesh-shaped stand-in for spec generation (no devices), as the
    reference's tests use one; both packages' rules read only its shape."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.mesh_dim_names = axes


def _mesh(name):
    return FakeMesh(*MESHES[name])


def _as_tuples(tree):
    """The reference's spec pytree with every PartitionSpec as a tuple."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    assert isinstance(tree, P), tree
    return tuple(tree)


@lru_cache(maxsize=None)
def _abstract(arch, compute):
    """(port meta tree, reference eval_shape tree) of masters or compute copies."""
    cfg = get_config(arch)
    port = Model(cfg, "meta").abstract_params()
    jm = JaxModel(jax_get_config(arch))
    if compute:
        port = cast_params_for_compute(port, cfg)
        ref = jax.eval_shape(lambda k: jax_cast(jm.init(k), jm.cfg), jax.random.PRNGKey(0))
    else:
        ref = jm.abstract_params()
    return port, ref


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_reference(arch):
    for compute in (False, True):
        port, ref = _abstract(arch, compute)
        for mesh_name in MESHES:
            for mode in ("train", "serve"):
                got = param_specs(port, make_sharding_rules(_mesh(mesh_name), mode))
                want = _as_tuples(jax_sharding.param_specs(
                    ref, jax_sharding.make_sharding_rules(_mesh(mesh_name), mode)))
                assert got == want, (arch, compute, mesh_name, mode)


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_match_reference_shapes_and_dtypes(arch):
    port, ref = _abstract(arch, False)
    flat = jax.tree_util.tree_leaves_with_path(ref)
    tree = port.reference_tree()
    for path, leaf in flat:
        t = tree
        for p in path:
            t = t[p.key]
        assert t.device.type == "meta"
        assert tuple(t.shape) == leaf.shape and _dtype_name(t.dtype) == str(leaf.dtype), path


def test_batch_and_cache_specs_equal_reference_on_its_inputs():
    """The reference's own case (tests/test_sharding_rules.py)."""
    for name in MESHES:
        rules = make_sharding_rules(_mesh(name), "serve")
        jrules = jax_sharding.make_sharding_rules(_mesh(name), "serve")
        batch = {"tokens": (128, 1), "positions3": (3, 128, 1)}
        assert batch_specs(batch, rules) == _as_tuples(jax_sharding.batch_specs(batch, jrules))
        cache = {"k": (40, 128, 32768, 8, 128), "ssm": (64, 1, 80, 64, 128),
                 "conv": (64, 1, 3, 5376)}
        assert cache_spec_tree(cache, rules) == _as_tuples(
            jax_sharding.cache_spec_tree(cache, jrules))
    cs = cache_spec_tree(cache, make_sharding_rules(_mesh("2x16x16"), "serve"))
    assert cs["k"][2] == "model" and cs["k"][3] is None and cs["ssm"][1] is None


@pytest.mark.parametrize("arch", list_archs())
def test_input_and_cache_specs_equal_reference(arch):
    """Every cell's abstract inputs (meta tensors against eval_shape structs)
    and their batch / cache specs under both meshes and modes."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for a, shape_name, status in jax_cells():
        if a != arch or status != "run":
            continue
        shape, jshape = SHAPES[shape_name], JAX_SHAPES[shape_name]
        got = {"train": specs.train_input_specs, "prefill": specs.prefill_input_specs,
               "decode": specs.decode_input_specs}
        want = {"train": jax_specs.train_input_specs, "prefill": jax_specs.prefill_input_specs,
                "decode": jax_specs.decode_input_specs}
        for kind in ("train", "prefill", "decode"):
            g, w = got[kind](cfg, shape), want[kind](jcfg, jshape)
            g_flat = {**g.get("cache", {}), **{k: v for k, v in g.items() if k != "cache"}}
            w_flat = {**w.get("cache", {}), **{k: v for k, v in w.items() if k != "cache"}}
            assert sorted(g_flat) == sorted(w_flat), (arch, shape_name, kind)
            for k in g_flat:
                assert g_flat[k].device.type == "meta"
                assert tuple(g_flat[k].shape) == w_flat[k].shape, (arch, shape_name, kind, k)
                assert _dtype_name(g_flat[k].dtype) == str(w_flat[k].dtype), (arch, kind, k)
            for name in MESHES:
                for mode in ("train", "serve"):
                    rules = make_sharding_rules(_mesh(name), mode)
                    jrules = jax_sharding.make_sharding_rules(_mesh(name), mode)
                    batch = {k: v for k, v in g.items() if k != "cache"}
                    jbatch = {k: v for k, v in w.items() if k != "cache"}
                    assert batch_specs(batch, rules) == _as_tuples(
                        jax_sharding.batch_specs(jbatch, jrules))
                    if kind == "decode":
                        assert cache_spec_tree(g["cache"], rules) == _as_tuples(
                            jax_sharding.cache_spec_tree(w["cache"], jrules))


def test_init_cache_matches_reference_cache_shapes():
    for arch in list_archs():
        cfg = get_config(arch)
        enc = 64 if cfg.family == "encdec" else 0
        got = Model(cfg, "meta").init_cache(2, 128, enc)
        want = jax.eval_shape(lambda: JaxModel(jax_get_config(arch)).init_cache(2, 128, enc))
        assert {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in got.items()} == {
            k: (v.shape, str(v.dtype)) for k, v in want.items()}, arch


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert to_placements((None, "model"), mesh) == [Replicate(), Replicate(), Shard(1)]
    assert to_placements((("pod", "data"), None), mesh) == [Shard(0), Shard(0), Replicate()]
    assert to_placements((None, ("model", "data")), mesh) == [Replicate(), Shard(1), Shard(1)]


def test_hw_holds_h100_datasheet_constants():
    hw = hlo.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (989e12, 3.35e12, 450e9, 80e9)


@pytest.mark.parametrize("inputs", [(1e15, 3e12, 4e9, 1), (7.5e13, 2.2e10, 0.0, 256),
                                    (1e9, 9e12, 1e12, 16)])
def test_roofline_terms_equal_reference(inputs):
    hw = hlo.HW()
    jhw = jax_hlo.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, link_bw=hw.link_bw,
                     hbm_bytes=hw.hbm_bytes)
    got, want = hlo.roofline_terms(*inputs, hw=hw), jax_hlo.roofline_terms(*inputs, hw=jhw)
    for f in ("compute_s", "memory_s", "collective_s", "flops", "bytes_accessed",
              "collective_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.dominant == want.dominant and got.step_time_s == want.step_time_s
    assert got.roofline_fraction(3e14, 8, hw) == want.roofline_fraction(3e14, 8, jhw)


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                "collective-permute"])
@pytest.mark.parametrize("n", [1, 2, 16])
def test_ring_traffic_equals_the_reference_hlo_model(op, n):
    """The reference prices an HLO collective line; the port prices the
    same op, bytes and group size directly."""
    groups = "{" + ",".join(str(i) for i in range(n)) + "}"
    line = f"  %x = bf16[64,1024]{{1,0}} {op}(bf16[64,1024]{{1,0}} %y), replica_groups={{{groups}}}"
    want = jax_hlo.parse_collectives(line, 256).per_chip_bytes
    assert hlo.ring_traffic(op, hlo.shape_bytes(torch.bfloat16, (64, 1024)), n) == want
    stats = hlo.CollectiveStats()
    stats.add(op, 5.0)
    assert stats.op_counts == {op: 1} and stats.per_chip_bytes == 5.0


def test_dryrun_work_list_equals_reference():
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--all"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "JAX_PLATFORMS": "cpu"})
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert work_list() == ref.stdout.splitlines()
    assert sum(not line.startswith("#") for line in work_list()) == 64  # 32 cells x 2 meshes


def test_runtime_exports_the_rules_lazily():
    import repro_torch.runtime as rt

    for name in ("ShardingRules", "batch_specs", "cache_spec_tree", "make_sharding_rules",
                 "named", "param_specs", "tree_named"):
        assert name in rt.__all__ and getattr(rt, name) is not None
