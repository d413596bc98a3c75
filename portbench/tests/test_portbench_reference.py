"""The plain reference against the port's CPU twin at reduced widths in
float32: three training steps."""
import math

from portbench.entries import train
from portbench.tests import small

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


def test_three_train_steps_agree_with_the_reference():
    conf, mix = small.train_conf(), small.train_mix()
    conf["port"] = dict(conf["port"], **F32)
    job = train.Job(conf, mix, "cpu")
    job.load(2**36 + 5)
    got = job.checked(2**36 + 5)
    want = train.reference(conf, mix, 2**36 + 5, "cpu")
    readings = train.compare(got, want)
    assert readings["loss_err"] < 1e-5
    assert readings["grad_err"] < 1e-4
    assert readings["grad_median"] < 1e-5
    assert readings["change_err"] < 1e-3
    assert len(got["grad_norm"]) == len(want["grad_norm"]) == 2 * 12 + 3
    assert all(math.isfinite(v) and v > 0 for v in want["change"].values())
