"""A whole run at reduced widths, past the harness's look for a chip: sound it
comes out correct under the cell's limits; with each fault a training cell
can have planted in the program under the timed path, it comes out not
correct."""
import time

import pytest

from portbench import faults, harness, spec
from portbench.tests import small

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


def _run(seed):
    # float32 at reduced widths reads far under the cell's limits when sound
    conf = small.train_conf()
    conf["port"] = dict(conf["port"], **F32)
    return harness.run_cell(spec.workload("qwen3moe.train"), seed, 0.3, False, "cpu",
                            time.perf_counter(), conf=conf, mix=small.train_mix())


def test_sound_run_is_correct():
    out = _run(2**33 + 17)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_planted_fault_is_not_correct(fault):
    with faults.planted(fault):
        out = _run(2**33 + 18)
    assert not out["correct"], out["checks"]
