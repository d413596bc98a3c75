"""The port's three examples (``examples/torch_*.py``) run on the CPU twins.

Each runs through its ``main(argv)`` with ``--device cpu`` and must print
its reference's ``OK`` line after meeting its reference's assertion: the
quickstart's EP-SpMV within 1e-4 of the COO oracle, CG's residual under
1e-3 within 60 iterations, and the served tokens' shape (the default
granite-3-8b, mamba2-2.7b, and the hybrid jamba-1.5-large-398b).  Without a CUDA device, an example given no
``--device`` raises instead of carrying on on the CPU.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_cpu(capsys):
    before = launch_counts()
    err = _example("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert err < 1e-4 and out.rstrip().endswith("quickstart OK")
    for method in ("default", "random", "greedy", "ep"):
        assert f"  {method:8s} vertex-cut=" in out
    assert launch_counts() == before  # CPU tensors: the twins, no kernel


def test_spmv_cg_on_cpu(capsys):
    report = _example("spmv_cg").main(["--device", "cpu"])
    assert report["residual"] < 1e-3 and report["iterations"] <= 60
    assert report["state"] in ("baseline", "optimized", "fallback")
    assert report["calls"] == report["iterations"] + 1  # r0, then one SpMV per iteration
    assert capsys.readouterr().out.rstrip().endswith("spmv_cg OK")


def test_spmv_cg_problem_is_the_references():
    import numpy as np

    import repro.core  # noqa: F401  (the reference example imports it)

    spec = importlib.util.spec_from_file_location("ref_spmv_cg", EXAMPLES / "spmv_cg.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for got, want in zip(_example("spmv_cg").make_spd_problem(), ref.make_spd_problem()):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("arch", [None, "mamba2-2.7b", "jamba-1.5-large-398b"],
                         ids=["default", "mamba2", "jamba"])
def test_serve_lm_on_cpu(arch, capsys):
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "19", "--gen", "5"]
    if arch:
        argv += ["--arch", arch]
    tokens, stats = _example("serve_lm").main(argv)
    assert tuple(tokens.shape) == (2, 5) and stats["device"] == "cpu"
    out = capsys.readouterr().out
    assert out.startswith(f"{arch or 'granite-3-8b'}: generated 5 tokens x 2 seqs")
    assert out.rstrip().endswith("serve_lm OK")


@pytest.mark.parametrize("name", ["quickstart", "spmv_cg", "serve_lm"])
def test_default_device_without_cuda_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main([])
