"""The traffic generator: deterministic by seed, the train batches against
the port's pipeline."""
import numpy as np
import pytest

from portbench import generate, spec

BIG_SEED = 2**40 + 12345


def test_train_batches_deterministic_by_seed():
    mix = spec.traffic("train_16k")
    a = generate.train_batch(mix, BIG_SEED, 151936, 3)
    b = generate.train_batch(mix, BIG_SEED, 151936, 3)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["tokens"].shape == (mix["batch"], mix["seq_len"])
    assert not np.array_equal(a["tokens"], generate.train_batch(mix, BIG_SEED + 1, 151936, 3)["tokens"])
    assert not np.array_equal(a["tokens"], generate.train_batch(mix, BIG_SEED, 151936, 4)["tokens"])


@pytest.mark.parametrize("seed", [0, BIG_SEED])
def test_train_batches_match_the_ports_pipeline(seed):
    from repro_torch.data import PipelineConfig, SyntheticPipeline

    mix = dict(spec.traffic("train_16k"), batch=4, seq_len=256, mean_doc_len=64)
    pipe = SyntheticPipeline(PipelineConfig(vocab_size=5000, seq_len=256, global_batch=4,
                                            seed=seed, mean_doc_len=64))
    compared = 0
    for step in range(12):
        mine = generate.train_batch(mix, seed, 5000, step)
        again = generate.train_batch(mix, seed, 5000, step)
        assert all(np.array_equal(mine[k], again[k]) for k in mine)
        try:
            theirs = pipe.batch(step)
        except IndexError:  # the port's copy indexes past a row with one slot left
            continue
        compared += 1
        assert all(np.array_equal(mine[k], theirs[k]) for k in ("tokens", "labels"))
    assert compared >= 6


def test_train_batch_with_one_slot_left_ends_in_eos():
    """Rows that leave one slot end with EOS where the port's copy raises."""
    mix = dict(spec.traffic("train_16k"), batch=4, seq_len=32, mean_doc_len=8)
    for step in range(100):
        b = generate.train_batch(mix, 8589934593, 512, step)
        assert b["tokens"].shape == (4, 32) and b["labels"].shape == (4, 32)
        assert b["tokens"].min() >= 1 and b["tokens"].max() < 512
