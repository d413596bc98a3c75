"""The operation and byte counts, against hand-worked shapes and the
records' bounds."""
import copy
from types import SimpleNamespace

import pytest

from portbench import counts, spec
from portbench.reference import moe

STAGE = spec.dims(spec.config("qwen3-moe-30b-a3b.l4"))


def _whole():
    conf = copy.deepcopy(spec.config("qwen3-moe-30b-a3b.l4"))
    conf["num_hidden_layers"] = 48
    return spec.dims(conf)


def test_capacity_of_a_microbatch():
    assert counts.capacity(STAGE, 4 * 2048) == 640  # 8192 * 8 / 128 * 1.25, a multiple of 128
    assert counts.capacity(STAGE, 4) == 8
    assert counts.capacity(STAGE, 100) == 8  # 7.8 -> at least top_k and 8


def test_train_flops_hand_worked():
    m = SimpleNamespace(d=4, heads=2, kv_heads=1, head_dim=2, experts=3, top_k=2, ffe=5,
                        layers=2, rows=7)
    attn = 2 * 4 * 2 * 2 + 2 * 4 * 1 * 2  # q and o, k and v
    ffn = 4 * 3 + 2 * 3 * 4 * 5  # router, two experts' SwiGLU
    assert moe.product_params(m) == 2 * (attn + ffn) + 4 * 7
    assert moe.train_flops(m, 1, 3) == 6 * moe.product_params(m) * 3 + 3 * 2 * 2 * 3 * 3 * 2 * 2


def test_train_counts_match_the_records():
    assert moe.n_params(STAGE) == 3_114_814_464  # PR 18's count of layers 0-3
    # PR 18's bound for 8 x 2,048 tokens: 82.92 ms
    assert counts.train_least_s(STAGE, 8, 2048) * 1e3 == pytest.approx(82.92, abs=0.01)
    assert moe.n_params(_whole()) == 30_532_122_624  # 48 layers, PR 18's count


def test_train_least_s_is_the_same_at_one_chip_and_a_quarter_at_four():
    one = moe.train_flops(STAGE, 8, 2048) / counts.BF16_FLOPS + 28 * moe.n_params(STAGE) / (
        counts.HBM_BYTES_PER_S)
    assert counts.train_least_s(STAGE, 8, 2048) == one
    assert counts.train_least_s(STAGE, 8, 2048, 1) == one
    mesh = spec.dims(spec.config("qwen3-moe-30b-a3b.l12"))
    assert counts.train_least_s(mesh, 16, 2048, 4) == pytest.approx(
        counts.train_least_s(mesh, 16, 2048) / 4, rel=1e-15)


def test_mfu_reader_shares_the_least_time_over_the_mesh():
    from types import SimpleNamespace

    rec = SimpleNamespace(traced=False, start=0.0, done=2.0)
    one = SimpleNamespace(m=STAGE, mix={"batch": 8, "seq_len": 2048}, records=[rec])
    assert spec.reader("mfu.train")(one) == 100.0 * counts.train_least_s(STAGE, 8, 2048) / 2.0
    mesh = spec.dims(spec.config("qwen3-moe-30b-a3b.l12"))
    four = SimpleNamespace(m=mesh, mix={"batch": 16, "seq_len": 2048, "mesh": [2, 2]},
                           records=[rec])
    assert spec.reader("mfu.train")(four) == pytest.approx(
        100.0 * counts.train_least_s(mesh, 16, 2048) / 4 / 2.0)


def test_twelve_layer_stage_counts():
    mesh = spec.dims(spec.config("qwen3-moe-30b-a3b.l12"))
    assert moe.n_params(mesh) == 8_099_779_584  # 129.6 GB of masters, gradients and moments
