"""The port's copies of the host core give the reference's arrays exactly.

``src/repro_torch/core`` holds verbatim copies of ``src/repro/core`` modules;
these tests catch the two drifting apart.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.partition_service import graph_fingerprint as ref_fingerprint
from repro_torch.core.partition_service import graph_fingerprint as port_fingerprint

COPIES = ["graph", "refine", "coarsen", "partition", "transform", "baselines", "metrics",
          "edge_partition", "reorder", "admission", "plan_cache", "plan_scheduler",
          "partition_service"]


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
