"""The harness finds a new configuration, model family, traffic mix and
per-layer metric by name, from new files and new entries alone."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import spec

ROOT = spec.ROOT


def test_new_files_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    conf = json.loads((pb / "configs" / "qwen3-moe-30b-a3b.l4.json").read_text())
    conf.update(name="new-model", num_hidden_layers=2)
    (pb / "configs" / "new-model.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "train_16k.json").read_text())
    mix.update(seq_len=8192, batch=2)
    (pb / "traffic" / "long_only.json").write_text(json.dumps(mix))
    (pb / "cells" / "new.long.json").write_text('{"limits": {"loss_err": 1}}')
    (pb / "reference" / "tiny.py").write_text(  # a new family: its reference, sizes, counts
        "from types import SimpleNamespace\n"
        "def dims(conf):\n    return SimpleNamespace(family='tiny', layers=conf['n'])\n")
    (pb / "configs" / "tiny-model.json").write_text('{"family": "tiny", "n": 3}')
    (pb / "metrics" / "batches.counted.py").write_text(
        "def read(ctx):\n    return float(len(ctx.records)) or None\n")
    bench["configs"].append({"name": "new-model", "source": "https://example.org",
                             "file": "portbench/configs/new-model.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new.long", "config": "new-model", "traffic": "long_only",
                               "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tok_s":
            m["workloads"].append("new.long")
    bench["per_layer"].append({"name": "batches.counted", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "runtime step",
                               "moves": "train_tok_s", "workloads": ["new.long"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = """
import json
from types import SimpleNamespace
from portbench import spec
cell = spec.workload("new.long")
conf, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
names = [m["name"] for m in spec.per_layer(cell)]
value = spec.reader("batches.counted")(SimpleNamespace(records=[1, 2, 3]))
tiny = spec.dims(spec.config("tiny-model")).layers
print(json.dumps([spec.dims(conf).layers, mix["seq_len"], spec.limits("new.long"), names,
                  [m["name"] for m in spec.end_to_end(cell)], value, str(spec.ROOT), tiny]))
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, env={"PYTHONPATH": str(tmp_path)}, timeout=120)
    assert out.returncode == 0, out.stderr
    layers, seq_len, limits, names, e2e, value, root, tiny = json.loads(out.stdout)
    assert (layers, seq_len, value, Path(root), tiny) == (2, 8192, 3.0, tmp_path, 3)
    assert limits == {"limits": {"loss_err": 1}}
    assert names == ["batches.counted"]  # the metrics of other cells are not read here
    assert e2e == ["train_tok_s", "setup_s"]


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = spec.bench()
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and spec.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        spec.traffic(w["traffic"])
        assert set(spec.limits(w["name"])["limits"])
        assert spec.per_layer(w) and [m for m in spec.end_to_end(w) if m["name"] != "setup_s"]


def test_every_cell_of_a_metric_reports_the_metric_it_moves():
    bench = spec.bench()
    for m in bench["per_layer"]:
        for name in m.get("workloads", ()):
            assert m["moves"] in [e["name"] for e in spec.end_to_end(spec.workload(name))], (m, name)

