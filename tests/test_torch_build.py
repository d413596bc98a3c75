"""The kernels' build keys: a library is rebuilt when its source, a shared
header or the flags change, and only then.  No compiler is needed: these
check the target paths ``_build`` derives, in a copy of ``csrc/``."""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

NAMES = ("ep_spmv", "flash_attention", "moe_mlp")


@pytest.fixture()
def csrc_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def _targets():
    return {name: _build._target(name) for name in NAMES}


def test_targets_are_stable_and_in_the_build_dir(csrc_copy):
    before = _targets()
    assert before == _targets()
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith(n) for n, p in before.items())


def test_header_edit_changes_every_target(csrc_copy):
    before = _targets()
    header = csrc_copy / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _targets()
    assert all(after[n] != before[n] for n in NAMES)


def test_source_edit_changes_only_its_target(csrc_copy):
    before = _targets()
    src = csrc_copy / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _targets()
    assert after["flash_attention"] != before["flash_attention"]
    assert {n: after[n] for n in NAMES if n != "flash_attention"} == {
        n: before[n] for n in NAMES if n != "flash_attention"}


def test_flag_change_changes_every_target(csrc_copy, monkeypatch):
    before = _targets()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    after = _targets()
    assert all(after[n] != before[n] for n in NAMES)
