"""The benchmark's data files, found by name, and the sizes a configuration states.

``BENCHMARK.json`` at the root of the checkout names every cell; a cell names
a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``), and its limits sit in ``cells/<cell>.json``.  A
per-layer metric is read by ``metrics/<name>.py``.  Nothing here imports the
program: the plain reference reads its sizes through :func:`dims` too.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _load("configs", name)


def traffic(name: str) -> dict:
    return _load("traffic", name)


def limits(cell: str) -> dict:
    return _load("cells", cell)


def workload(name: str) -> dict:
    """The cell's entry of ``BENCHMARK.json``."""
    for w in bench()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def per_layer(cell: dict) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those with no list whose end-to-end metric the cell reports."""
    b = bench()
    e2e = {m["name"] for m in end_to_end(cell)}
    out = []
    for m in b["per_layer"]:
        if cell["name"] in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e):
            out.append(m)
    return out


def end_to_end(cell: dict) -> list[dict]:
    return [m for m in bench()["end_to_end"]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read`` function."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(name: str):
    """``reference/<name>.py``: a model family's plain reference, with the
    sizes, weight layout, counts and program fields of its configurations."""
    return importlib.import_module(f"portbench.reference.{name}")


def dims(conf: dict) -> SimpleNamespace:
    """The sizes of a configuration file under one set of names, whichever
    keys its source uses (its family's ``dims``)."""
    return family(conf["family"]).dims(conf)
