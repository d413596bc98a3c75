"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake group of 512 ranks.

The dry-run's own work runs in a child process (``python
tests/test_torch_dryrun.py --child``: the fake process group is global
state, kept out of the test worker).  It builds the cells that
``chip_smoke.py``'s ``dryrun`` phase runs — qwen3-moe-30b-a3b ``train_4k``
and ``decode_32k`` on 16x16 and 2x16x16, jamba-1.5-large-398b
``decode_32k`` and mamba2-2.7b ``long_500k`` on 16x16 — and reports each
one's per-device argument bytes, which must equal EXACTLY the byte sum of
the local shards that the reference's specs imply for the reference's own
abstract arguments (train state with AdamW moments, serving's bf16 weights,
the batch, the decode cache, tokens and position).  It also runs three
cells end to end, and checks that the counters count one rank's shards:
the FLOPs of a product of DTensors on a 16x16 mesh are the local shards'
(FlopCounterMode over DTensors would report the global product), and a
gather is priced by the ring model.

The serve decode cells are held against the reference's own dry-run, run
in a second child process (``python tests/test_torch_dryrun.py
--reference``: it sets 512 placeholder devices before JAX starts), beside
the first: per device, the port moves at most twice the reference's
collective bytes, none of them parameter bytes, and its roofline is
dominated by memory, as the reference's is.  The prefill cells with Mamba
layers (mamba2-2.7b and jamba-1.5-large-398b ``prefill_32k``) are held
against the reference's too, at most its collective bytes; their train
cells and qwen2-moe-a2.7b's, run by two more children (``--train=0``,
``--train=1``) beside the other two, against the bytes they moved before
the mixer split its projection by parts and the experts' byte rule
decided in training.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("qwen3-moe-30b-a3b", "train_4k", False), ("qwen3-moe-30b-a3b", "train_4k", True),
         ("qwen3-moe-30b-a3b", "decode_32k", False), ("qwen3-moe-30b-a3b", "decode_32k", True),
         ("jamba-1.5-large-398b", "decode_32k", False), ("mamba2-2.7b", "long_500k", False)]
RUN = [("mamba2-2.7b", "long_500k", False), ("qwen3-moe-30b-a3b", "decode_32k", False),
       ("granite-3-8b", "prefill_32k", False)]
# Serve decode cells held against the reference's dry-run: dense, MoE on
# both meshes, hybrid, ssm at 32k and 500k.
DECODE = [("granite-3-8b", "decode_32k", False), ("qwen3-32b", "decode_32k", False),
          ("qwen3-moe-30b-a3b", "decode_32k", False), ("qwen3-moe-30b-a3b", "decode_32k", True),
          ("jamba-1.5-large-398b", "decode_32k", False), ("mamba2-2.7b", "decode_32k", False),
          ("mamba2-2.7b", "long_500k", False)]
MOE = ("qwen3-moe-30b-a3b", "jamba-1.5-large-398b")
# granite-3-8b prefill_32k's collective bytes per device before the decode
# products kept the weights in place (weights gathered at every use)
GRANITE_PREFILL_BYTES = 103_130_726_400.0
# Prefill cells with Mamba layers, held against the reference's dry-run.
PREFILL = [("mamba2-2.7b", "prefill_32k", False), ("jamba-1.5-large-398b", "prefill_32k", False)]
# Train cells run by two more children, in two groups: (collective bytes,
# parameter bytes) per device before the Mamba mixer moved its projection
# by parts (each slice of the projection gathered all of it) and before the
# experts' byte rule decided in training: the Mamba cells must move fewer,
# qwen2-moe (F-split experts) no more.
TRAIN = {("mamba2-2.7b", "train_4k", False): (1_197_459_737_782.5, 17_366_937_600.0),
         ("qwen2-moe-a2.7b", "train_4k", False): (1_621_018_110_345.0, 753_575_854_080.0),
         ("jamba-1.5-large-398b", "train_4k", False): (8_013_734_995_207.5, 1_489_954_391_040.0)}
TRAIN_GROUPS = (list(TRAIN)[:2], list(TRAIN)[2:])
# The same cells' parameter bytes at prefill before that change: no more now.
PREFILL_PARAM_BYTES = {"mamba2-2.7b": 1_675_900_800.0, "jamba-1.5-large-398b": 135_162_402_570.0}


def _child() -> None:
    """Everything that needs the fake group, printed as one JSON line."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_mesh, make_production_mesh

    dryrun.init_fake_world()
    out = {"arg_bytes": {}, "runs": {}}
    host, pods = make_host_mesh("cpu"), make_production_mesh(multi_pod=True)
    out["meshes"] = [[host.device_type, list(host.shape), list(host.mesh_dim_names)],
                     [list(pods.shape), list(pods.mesh_dim_names)]]
    try:
        make_mesh((2, 32, 16), ("pod", "data", "model"))
    except RuntimeError as e:
        out["too_small"] = str(e)
    builders = {"train": dryrun.build_train, "prefill": dryrun.build_prefill}
    for arch, shape, mp in CELLS:
        mesh = make_production_mesh(multi_pod=mp)
        kind = SHAPES[shape].kind
        _, args, _ = builders.get(kind, dryrun.build_decode)(get_config(arch), SHAPES[shape], mesh)
        out["arg_bytes"][f"{arch}/{shape}/{mp}"] = dryrun.local_bytes(args)
    for arch, shape, mp in dict.fromkeys(RUN + DECODE + PREFILL):
        out["runs"][f"{arch}/{shape}/{mp}"] = _run(dryrun, arch, shape, mp)

    mesh = make_production_mesh()
    x = distribute_tensor(torch.empty(4096, 2048, device="meta"), mesh, [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(2048, 8192, device="meta"), mesh, [Replicate(), Shard(1)])
    xs = distribute_tensor(torch.empty(4096, 2048, device="meta"), mesh, [Replicate(), Shard(1)])
    ws = distribute_tensor(torch.empty(2048, 8192, device="meta"), mesh, [Replicate(), Shard(0)])
    with dryrun.Counters() as c:
        x @ w
    with dryrun.Counters() as p:
        xs @ ws  # contraction over 'model': each rank a partial product
    with dryrun.Counters() as g:
        x.redistribute(mesh, [Replicate(), Replicate()])
    out["counters"] = {"mm": c.flops, "partial_mm": p.flops, "gather": g.collectives.op_bytes,
                       "gather_counts": g.collectives.op_counts}

    # Parameter bytes: a wide weight gathered over both axes (two gathers, the
    # second of the first's output), a copy of one gathered, and an
    # activation gathered (not a parameter).
    import torch.distributed._functional_collectives as funcol

    wide = distribute_tensor(torch.empty(2048, 8192, device="meta"), mesh, [Shard(1), Shard(1)])
    params = [wide.to_local()]
    with dryrun.Counters(params=params) as whole:
        wide.redistribute(mesh, [Replicate(), Replicate()])
    with dryrun.Counters(params=params) as copied:
        funcol.wait_tensor(funcol.all_gather_tensor(wide.to_local().t().contiguous(), 0,
                                                    (mesh, 0)))
    with dryrun.Counters(params=params) as selected:
        cols = torch.arange(8, device=wide.to_local().device)
        funcol.wait_tensor(funcol.all_gather_tensor(wide.to_local().index_select(1, cols), 0,
                                                    (mesh, 0)))
    with dryrun.Counters(params=params) as rows:
        x.redistribute(mesh, [Replicate(), Replicate()])
    out["param_bytes"] = {name: [c.param_gather_bytes, c.collectives.per_chip_bytes,
                                 c.collectives.op_counts]
                          for name, c in (("whole", whole), ("copied", copied),
                                          ("selected", selected), ("rows", rows))}
    print(json.dumps(out))


def _run(dryrun, arch, shape, mp) -> dict:
    rec = dryrun.run_cell(arch, shape, mp, out_dir=None, verbose=False)
    return {k: rec.get(k) for k in ("status", "error", "memory", "cost_model", "roofline",
                                    "chips", "mode")}


def _train_child(group: int) -> None:
    """The port's dry-run of the TRAIN cells of TRAIN_GROUPS[group], printed
    as one JSON line."""
    from repro_torch.launch import dryrun

    dryrun.init_fake_world()
    print(json.dumps({f"{arch}/{shape}/{mp}": _run(dryrun, arch, shape, mp)
                      for arch, shape, mp in TRAIN_GROUPS[group]}))


def _reference_child() -> None:
    """The reference's dry-run of the DECODE and PREFILL cells, printed as
    one JSON line: each cell's status, collective bytes and FLOPs per
    device, and dominant roofline term."""
    from repro.launch import dryrun  # sets 512 placeholder devices before JAX starts

    out = {}
    for arch, shape, mp in DECODE + PREFILL:
        rec = dryrun.run_cell(arch, shape, mp, out_dir=None, verbose=False)
        out[f"{arch}/{shape}/{mp}"] = {
            "status": rec["status"], "error": rec.get("error"),
            **{k: rec.get("cost_model", {}).get(k) for k in ("collective_bytes_per_chip",
                                                             "flops_per_chip")},
            "dominant": rec.get("roofline", {}).get("dominant")}
    print(json.dumps(out))


def _start(flag: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, __file__, flag], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def _result(proc: subprocess.Popen) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def children():
    """The port's three children and the reference's, run side by side."""
    procs = [_start("--child"), _start("--reference"), _start("--train=0"), _start("--train=1")]
    try:
        return [_result(p) for p in procs]
    finally:
        for p in procs:
            p.kill()


@pytest.fixture(scope="module")
def child(children):
    return children[0]


@pytest.fixture(scope="module")
def reference(children):
    return children[1]


@pytest.fixture(scope="module")
def train_runs(children):
    return {**children[2], **children[3]}


def _reference_arg_bytes(arch, shape_name, multi_pod) -> int:
    """Bytes of one device's shards of the reference dry-run's arguments,
    from the reference's abstract arguments and specs (a spec-only mesh)."""
    import jax
    import numpy as np

    import repro.core  # noqa: F401  (before repro.kernels: import cycle)
    from repro.configs import SHAPES, get_config
    from repro.launch.specs import decode_input_specs, prefill_input_specs, train_input_specs
    from repro.models import Model
    from repro.models.transformer import cast_params_for_compute
    from repro.optim import AdamWConfig
    from repro.runtime import init_train_state
    from repro.runtime.sharding import (batch_specs, cache_spec_tree, make_sharding_rules,
                                        param_specs)

    class FakeMesh:
        def __init__(self, shape, axes):
            self.shape = dict(zip(axes, shape))
            self.axis_names = axes

    mesh = (FakeMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else FakeMesh((16, 16), ("data", "model")))
    cfg, shape = get_config(arch), SHAPES[shape_name]
    model = Model(cfg)

    def local(leaf, spec) -> int:
        n = 1
        for d, entry in zip(leaf.shape, tuple(spec) + (None,) * (len(leaf.shape) - len(spec))):
            names = entry if isinstance(entry, tuple) else (entry,)
            n *= d // math.prod(mesh.shape[a] for a in names if a is not None)
        return n * np.dtype(leaf.dtype).itemsize

    def total(tree, specs) -> int:
        leaves = jax.tree_util.tree_leaves(tree)
        spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda s: isinstance(
            s, jax.sharding.PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        return sum(local(a, s) for a, s in zip(leaves, spec_leaves))

    P = jax.sharding.PartitionSpec
    if shape.kind == "train":
        rules = make_sharding_rules(mesh, "train")
        state = jax.eval_shape(lambda k: init_train_state(
            model, AdamWConfig(lr=1e-4, state_dtype=None), k), jax.random.PRNGKey(0))
        ps = param_specs(state.params, rules)
        batch = train_input_specs(cfg, shape)
        return (3 * total(state.params, ps) + 8  # params, m, v; count and step int32
                + total(batch, batch_specs(batch, rules)))
    rules = make_sharding_rules(mesh, "serve")
    params = jax.eval_shape(lambda k: cast_params_for_compute(model.init(k), cfg),
                            jax.random.PRNGKey(0))
    n = total(params, param_specs(params, rules))
    if shape.kind == "prefill":
        batch = prefill_input_specs(cfg, shape)
        return n + total(batch, batch_specs(batch, rules))
    ins = decode_input_specs(cfg, shape)
    return (n + total(ins["cache"], cache_spec_tree(ins["cache"], rules))
            + total(ins["tokens"], P(None, None)) + total(ins["pos"], P()))


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_argument_bytes_equal_reference_spec_sums(child, arch, shape, multi_pod):
    got = child["arg_bytes"][f"{arch}/{shape}/{multi_pod}"]
    assert got == _reference_arg_bytes(arch, shape, multi_pod)


@pytest.mark.parametrize("arch,shape,multi_pod", RUN)
def test_dryrun_cell_writes_the_reference_schema(child, arch, shape, multi_pod):
    rec = child["runs"][f"{arch}/{shape}/{multi_pod}"]
    assert rec["status"] == "ok", rec["error"]
    mem, cost, roof = rec["memory"], rec["cost_model"], rec["roofline"]
    assert rec["chips"] == 256
    assert mem["argument_size_in_bytes"] == child["arg_bytes"].get(
        f"{arch}/{shape}/{multi_pod}", mem["argument_size_in_bytes"])
    assert mem["per_device_total_bytes"] == (mem["argument_size_in_bytes"]
                                             + mem["output_size_in_bytes"]
                                             + mem["temp_size_in_bytes"])
    for key in ("compute_s", "memory_s", "collective_s", "dominant", "step_time_s",
                "model_flops", "hlo_flops_total", "useful_flops_ratio", "roofline_fraction"):
        assert key in roof
    assert roof["step_time_s"] == max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    assert cost["flops_per_chip"] > 0 and cost["eager_op_bytes_per_chip"] > 0
    if arch == "qwen3-moe-30b-a3b":  # 48 MoE layers, each through the expert-FFN kernel
        assert cost["kernel_calls"] == {"moe_mlp": 48}
        assert cost["collective_bytes_per_chip"] > 0
    if arch == "granite-3-8b":  # prefill: flash once a layer, no expert FFN
        assert cost["kernel_calls"] == {"flash_attention": 40}
    if arch == "mamba2-2.7b":
        assert cost["kernel_calls"] == {}


def test_meshes(child):
    """The host mesh is 1x1 over the asked device; the production meshes have
    the reference's shapes and axes; a mesh larger than the world raises."""
    assert child["meshes"] == [["cpu", [1, 1], ["data", "model"]],
                               [[2, 16, 16], ["pod", "data", "model"]]]
    assert "need 1024 ranks" in child["too_small"]


def test_counters_count_parameter_gathers(child):
    """A gather whose input is parameter storage counts as parameter bytes,
    also when it gathers the output of an earlier gather of it, a
    ``.contiguous()`` copy of it or a selection of its columns; an
    activation's gather does not."""
    pb = child["param_bytes"]
    local = 2048 * 8192 * 4 / 256
    assert pb["whole"][2] == {"all-gather": 2}
    assert pb["whole"][0] == pb["whole"][1] == local * 15 + local * 16 * 15
    assert pb["copied"][0] == pb["copied"][1] == local * 16 * 15 / 16
    assert pb["selected"][0] == pb["selected"][1] == 2048 * 8 * 4 * 15
    assert pb["rows"][0] == 0 and pb["rows"][1] > 0


def test_counters_count_local_shards(child):
    c = child["counters"]
    assert c["mm"] == 2 * (4096 // 16) * 2048 * (8192 // 16)  # not 2 * 4096 * 2048 * 8192
    assert c["partial_mm"] == 2 * 4096 * (2048 // 16) * 8192
    # all-gather over 'data' (16): each rank sends 15/16 of the gathered bytes
    assert c["gather"] == {"all-gather": 4096 * 2048 * 4 * 15 / 16}
    assert c["gather_counts"] == {"all-gather": 1}


@pytest.mark.parametrize("arch,shape,multi_pod", DECODE)
def test_decode_cell_leaves_the_weights_in_place(child, reference, arch, shape, multi_pod):
    """Against the reference's dry-run of the same cell: collective bytes per
    device at most twice the reference's, no parameter bytes among them
    (the serve rules' weights are never gathered at decode), the roofline
    dominated by memory as the reference's is, and for MoE the expert FLOPs
    of one rank's F slice (within 1.25x of the reference's, not 4-9x)."""
    key = f"{arch}/{shape}/{multi_pod}"
    rec, ref = child["runs"][key], reference[key]
    assert rec["status"] == "ok", rec["error"]
    assert ref["status"] == "ok", ref["error"]
    cost = rec["cost_model"]
    assert cost["collective_bytes_per_chip"] <= 2 * ref["collective_bytes_per_chip"], (cost, ref)
    assert cost["param_gather_bytes"] == 0, cost
    assert ref["dominant"] == "memory" and rec["roofline"]["dominant"] == "memory", (rec, ref)
    if arch in MOE:
        assert cost["flops_per_chip"] <= 1.25 * ref["flops_per_chip"], (cost, ref)


def test_prefill_gathers_weights_no_more_than_before(child):
    """At prefill the rows are the larger thing to move, so the products still
    gather the weights: granite-3-8b prefill_32k moves no more than it did
    when every product gathered its weight (103.1 GB a device)."""
    cost = child["runs"]["granite-3-8b/prefill_32k/False"]["cost_model"]
    assert cost["collective_bytes_per_chip"] <= GRANITE_PREFILL_BYTES
    assert cost["param_gather_bytes"] > 0


@pytest.mark.parametrize("arch,shape,multi_pod", PREFILL)
def test_mamba_prefill_moves_no_more_than_the_reference(child, reference, arch, shape,
                                                        multi_pod):
    """The Mamba mixer moves ``in_proj``'s output once (an all-to-all to z,
    xBC and dt each on its own width) where each of its six slices used to
    gather all of it: per device, collective bytes at most the reference's
    dry-run's of the same cell, and parameter bytes no more than before."""
    key = f"{arch}/{shape}/{multi_pod}"
    rec, ref = child["runs"][key], reference[key]
    assert rec["status"] == "ok", rec["error"]
    assert ref["status"] == "ok", ref["error"]
    cost = rec["cost_model"]
    assert cost["collective_bytes_per_chip"] <= ref["collective_bytes_per_chip"], (cost, ref)
    assert cost["param_gather_bytes"] <= PREFILL_PARAM_BYTES[arch], cost
    assert cost["collective_op_bytes"]["all-to-all"] > 0, cost


@pytest.mark.parametrize("arch,shape,multi_pod", list(TRAIN))
def test_train_moves_no_more_than_before(train_runs, arch, shape, multi_pod):
    """The train cells with Mamba layers move fewer collective bytes than
    when the mixer's slices gathered the whole projection; qwen2-moe's,
    whose expert leaves the rules split over 'data', no more than when
    every train step gathered them (the byte rule counts the backward pass
    too, where moving the tokens costs more); none more parameter bytes."""
    rec = train_runs[f"{arch}/{shape}/{multi_pod}"]
    assert rec["status"] == "ok", rec["error"]
    cost = rec["cost_model"]
    before, param_before = TRAIN[(arch, shape, multi_pod)]
    if arch.startswith(("mamba2", "jamba")):
        assert cost["collective_bytes_per_chip"] < before, cost
    assert cost["collective_bytes_per_chip"] <= before, cost
    assert cost["param_gather_bytes"] <= param_before, cost


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    _child()
elif __name__ == "__main__" and sys.argv[1:] == ["--reference"]:
    _reference_child()
elif __name__ == "__main__" and sys.argv[1:2] in (["--train=0"], ["--train=1"]):
    _train_child(int(sys.argv[1][-1]))
