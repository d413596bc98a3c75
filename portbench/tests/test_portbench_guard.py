"""The import guard compares whole top-level names; no process of the
benchmark loads JAX or the JAX package, and the reference nothing of the port."""
import subprocess
import sys

from portbench import spec
from portbench.harness import banned_modules

ROOT = spec.ROOT


def test_guard_compares_whole_top_level_names():
    assert banned_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert banned_modules(["repro.core.partition", "repro_torch.models"]) == ["repro"]
    assert banned_modules(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]
    assert banned_modules(["repro_torch", "repro_torch.kernels", "reproduce", "jaxtyping"]) == []


def _probe(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"}, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_harness_and_entries_load_no_banned_module():
    code = ("import sys; import portbench.harness, portbench.entries.train, "
            "portbench.calibrate, portbench.trace; import repro_torch.models; "
            "from portbench.harness import banned_modules; print(banned_modules())")
    assert _probe(code) == "[]"


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import portbench.reference.moe, "
            "portbench.reference.train, portbench.check, portbench.counts; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'repro', 'repro_torch', 'jax'}))")
    assert _probe(code) == "[]"


def test_run_without_the_program_exits_nonzero_and_prints_nothing(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "qwen3moe.train",
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
