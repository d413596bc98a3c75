"""The port's serving drivers, its device rule and its import boundary.

The drivers run at tiny sizes on the CPU twins (``device="cpu"``) and their
first answers are held against the JAX package's driver pieces; without a
CUDA device, an entry point given no device raises instead of carrying on on
the CPU.  The port must never import JAX or the JAX package: a subprocess
import and an AST scan of every port file check that.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
from repro.kernels.ref import spmv_coo_ref as jax_coo_ref  # noqa: E402
from repro_torch.core import (  # noqa: E402
    PartitionService,
    build_pack_plan,
    edge_partition,
    synthetic_bipartite_graph,
)
from repro_torch.kernels.ops import BucketSpec, make_bucketed_spmv_fn, make_ep_spmv_fn  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.runtime import GraphRequest, GraphServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


class TestDrivers:
    @pytest.mark.parametrize("mode", ["software", "streaming"])
    def test_run_graph_serving(self, mode):
        stats = port_serve.run_graph_serving(n_rows=256, n_cols=256, nnz_per_row=4, k=8,
                                             requests=4, churn=0.02, pad=8, mode=mode,
                                             device="cpu")
        assert stats["device"] == "cpu" and stats["mode"] == mode
        assert stats["incremental_source"] in ("incremental", "local", "full")
        assert stats["cold_s"] > 0 and stats["warm_s"] > 0 and stats["post_swap_s"] > 0
        cc = stats["compile_cache"]
        assert cc["misses"] == 1 and len(cc["buckets"]) == 1  # one bucket build
        assert stats["service"]["hits"] >= 3

    @pytest.mark.parametrize("mode", ["software", "streaming"])
    def test_run_graph_serving_samples_match_coo(self, mode):
        stats = port_serve.run_graph_serving(n_rows=256, n_cols=256, nnz_per_row=4, k=8,
                                             requests=4, churn=0.02, pad=8, mode=mode,
                                             device="cpu", keep_samples=True)
        samples = stats.pop("samples")
        assert {"warm", "post_swap"} <= set(samples)
        assert ("during_repartition" in samples) == (
            stats["requests_overlapped_with_repartition"] > 0)
        for name, s in samples.items():
            want = np.bincount(s["rows"], weights=s["vals"].astype(np.float64)
                               * s["x"].astype(np.float64)[s["cols"]], minlength=256)
            np.testing.assert_allclose(s["y"], want, rtol=1e-5, atol=1e-5, err_msg=name)
        assert samples["post_swap"]["rows"].shape[0] == samples["warm"]["rows"].shape[0]

    def test_run_batched_graph_serving(self):
        stats = port_serve.run_batched_graph_serving(
            clients=3, graphs=6, requests_per_client=4, max_batch=4, max_wait_ms=20.0,
            n_rows=96, n_cols=96, nnz_per_row=3, k=4, pad=8, device="cpu")
        assert stats["requests"] == 12 and stats["device"] == "cpu"
        assert stats["kernel_compiles"] == len(stats["buckets"]) == 1
        assert sum(n * c for n, c in stats["batch_hist"].items()) == 12 + 6  # + warm-up

    def test_served_y_matches_jax_oracle(self):
        _, rows, cols = ref_core.synthetic_bipartite_graph(200, 180, 4, seed=3)
        rng = np.random.default_rng(3)
        vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
        x = rng.standard_normal(180).astype(np.float32)
        with PartitionService() as svc:
            server = GraphServer(svc, k=8, pad=8, device="cpu", start_batcher=False)
            y = server.serve(GraphRequest(200, 180, rows, cols, vals, x)).y
        want = jax_coo_ref(200, jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                           jnp.asarray(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("flag", ["--tenants 3", "--replicas 2", "--overload",
                                      "--arch mamba2-2.7b"])
    def test_unported_modes_are_named(self, flag, capsys):
        with pytest.raises(SystemExit) as exc:
            port_serve.main(["--graph", *flag.split()])
        assert exc.value.code == 2
        assert "not ported yet" in capsys.readouterr().err


class TestDeviceRule:
    @pytest.mark.parametrize("entry", ["graph_serving", "batched", "ep_fn", "bucket_fn",
                                       "lm_serving"])
    def test_default_device_without_cuda_raises(self, entry, monkeypatch):
        edges, rows, cols = synthetic_bipartite_graph(32, 32, 2, seed=0)
        labels = edge_partition(edges, 2, method="ep", seed=0).labels
        plan = build_pack_plan(32, 32, rows, cols, labels, 2, pad=8)
        spec = BucketSpec(k=2, n_rows=256, n_cols=256, e_max=64, x_max=64, y_max=64, batch=1)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            if entry == "graph_serving":
                port_serve.run_graph_serving(n_rows=64, n_cols=64, k=2)
            elif entry == "batched":
                port_serve.run_batched_graph_serving(graphs=1)
            elif entry == "lm_serving":
                port_serve.run_serving("granite-3-8b", batch=1, prompt_len=4, gen=2)
            elif entry == "ep_fn":
                make_ep_spmv_fn(plan, np.ones(rows.shape[0], np.float32))
            else:
                make_bucketed_spmv_fn(spec)


class TestImportBoundary:
    def test_import_leaves_jax_and_repro_out(self):
        code = ("import sys, repro_torch.launch.serve, repro_torch.kernels; "
                "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
                "or m == 'repro' or m.startswith('repro.')); print(bad)")
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"

    @pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
    def test_no_file_imports_jax_or_repro(self, path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
