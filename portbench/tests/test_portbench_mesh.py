"""A four-chip cell at reduced widths on the CPU: the entry's four ranks on a
2x2 gloo mesh against the spread reference, sound and with each fault a
cell on a mesh can have; the spread reference against ``reference.train``;
the dispatch shards it counts the capacity in.

The cell, ``qwen3-moe-30b-a3b.l12`` under ``train_32k``, is listed here as a
``BENCHMARK.json`` that names it would list it (reporting ``train_tok_s``),
and held to the one-chip cell's limits.  Each run of the entry is held to
one deadline: the process group's timeout, after which rank 0 raises and
ends the other ranks."""
import copy
import os
import time

import pytest
import torch

from portbench import counts, faults, harness, spec
from portbench.entries import train as tr
from portbench.entries import train_mesh as tm
from portbench.reference import spread
from portbench.reference import train as ref_train
from portbench.reference.common import REF
from portbench.tests import small

CELL = {"name": "qwen3moe.train-2x2", "config": "qwen3-moe-30b-a3b.l12", "traffic": "train_32k",
        "chips": 4}
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
DEADLINE_S = 240


def _conf():
    conf = small.train_conf()
    conf["num_hidden_layers"] = 4  # a layer on each of the four ranks' places
    conf["port"] = dict(conf["port"], **F32)  # float32 reads far under the cell's limits when sound
    return conf


def _mix():
    return dict(spec.traffic("train_32k"), batch=8, seq_len=32, mean_doc_len=8)


def _listed(bench=spec.bench) -> dict:
    bench = copy.deepcopy(bench())
    bench["workloads"].append(CELL)
    for m in bench["end_to_end"]:
        if m["name"] == "train_tok_s":
            m["workloads"].append(CELL["name"])
    return bench


@pytest.fixture
def deadline(monkeypatch):
    monkeypatch.setattr(tm, "TIMEOUT_S", DEADLINE_S)
    monkeypatch.setattr(spec, "bench", _listed)


def _run(seed):
    return harness.run_cell(spec.workload(CELL["name"]), seed, 0.5, False, "cpu",
                            time.perf_counter(), conf=_conf(), mix=_mix(),
                            limits=spec.limits("qwen3moe.train"))


def test_mesh_run_is_correct_against_the_spread_reference(deadline, capsys):
    out = _run(2**35 + 3)
    host = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("window's host by rank")]
    assert len(host) == 1 and len(host[0].split(": ", 1)[1].split("; ")) == 4
    assert out["correct"], out["checks"]
    assert all(v["value"] < 1e-4 for v in out["checks"].values()), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["count"] == 4 and list(out)[-1] == "checks"
    assert out["metrics"]["train_tok_s"]["value"] > 0 and out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault", faults.MESH_FAULTS)
def test_planted_fault_fails_the_mesh_check(deadline, fault):
    with faults.planted(fault):
        out = _run(2**35 + 4)
    assert not out["correct"], out["checks"]


def test_each_rank_keeps_its_share_of_the_host():
    assert tm.threads("cpu", 4) == 1
    assert tm.threads("cuda", 4) == max(1, (os.cpu_count() or 1) // 4)
    assert tm.threads("cuda", 10**6) == 1


def test_mesh_cell_can_leave_out_the_exchange():
    assert faults.of(_mix()) == faults.MESH_FAULTS
    assert faults.of(spec.traffic("train_16k")) == faults.FAULTS


def _batches(conf, mix, seed):
    m = spec.dims(conf)
    from portbench import generate

    return [{k: torch.from_numpy(v) for k, v in generate.train_batch(mix, seed, m.vocab, i).items()}
            for i in range(mix["checked_steps"])]


def test_spread_reference_is_train_steps_bit_for_bit_on_one_device():
    conf, mix = small.train_conf(), small.train_mix()
    seed = 2**36 + 7
    want = ref_train.steps(conf, mix, seed, _batches(conf, mix, seed), REF, "cpu")
    for devs in (["cpu"], ["cpu"] * 4):
        got = spread.steps(conf, mix, seed, _batches(conf, mix, seed), REF, devs)
        assert got == want


def test_spread_places_each_group():
    m = spec.dims(spec.config("qwen3-moe-30b-a3b.l12"))
    devs = [f"cuda:{r}" for r in range(4)]
    assert [spread.place(m, i, ("attn", "wq"), devs) for i in range(12)] == [
        d for d in devs for _ in range(3)]
    assert spread.place(m, "top", ("embed",), devs) == "cuda:0"
    assert spread.place(m, "top", ("lm_head",), devs) == "cuda:3"
    assert spread.place(m, "top", ("final_norm",), devs) == "cuda:3"


def test_dispatch_shards_count_the_capacity_per_shard():
    conf, mix = _conf(), _mix()
    m = spec.dims(conf)
    assert counts.dispatch_shards(m, 4 * 32, 4, 2) == 2
    assert counts.dispatch_shards(m, 3 * 32, 3, 2) == 1  # rows that do not split
    full = spec.dims(spec.config("qwen3-moe-30b-a3b.l12"))
    assert counts.dispatch_shards(full, 8 * 2048, 8, 2) == 2  # 1,280 slots, 640 a shard
    assert counts.dispatch_shards(full, 1, 1, 1) == 1
    seed = 2**35 + 5
    one, two = (spread.steps(conf, mix, seed, _batches(conf, mix, seed), REF, ["cpu"], shards)
                for shards in (1, 2))
    assert one["loss"] != two["loss"]  # at this size the shards' slices drop other pairs


def test_mesh_reference_takes_the_programs_shards():
    conf, mix = _conf(), _mix()
    seed = 2**35 + 6
    got = tm.reference(conf, mix, seed, tm.devices("cpu", 4))
    want = spread.steps(conf, mix, seed, _batches(conf, mix, seed), REF, ["cpu"], 2)
    assert got == want
    assert tr.compare(got, want)["loss_err"] == 0.0


@pytest.mark.gpu
def test_two_cards_draw_the_same_bits(card):
    from portbench import weights

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    conf = spec.config("qwen3-moe-30b-a3b.l12")
    for group in ("top", 0):
        a = weights.draw(conf, 2**33 + 1, group, torch.device("cuda", 0))
        b = weights.draw(conf, 2**33 + 1, group, torch.device("cuda", 1))
        assert all(torch.equal(a[k], b[k].to(a[k].device)) for k in a)
