"""The port's checkpoints and fault-tolerant loop on the CPU.

The reference's checkpoint tests (``tests/test_checkpoint.py``) on the port,
the elastic re-mesh one in a one-rank gloo group; the on-disk format
across the two packages in both directions (the same tree written by each
gives the same manifest and the same bytes, and each restores the other's
bit for bit); a reduced qwen3-moe ``TrainState`` written by the reference's
``CheckpointManager`` restored by the port, whose next step gives the
reference's loss, and restored by a 2x2 gloo group whose sharded save the
reference reads back; and the reference's restart tests
(``tests/test_fault.py``) on the port's ``run_training`` and
``FaultTolerantLoop``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (before repro.kernels: import cycle)
from repro.ckpt import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.ckpt import restore_pytree as jax_restore_pytree  # noqa: E402
from repro.ckpt import save_pytree as jax_save_pytree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.runtime import init_train_state as jax_init_train_state  # noqa: E402
from repro.runtime import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.ckpt import (  # noqa: E402
    CheckpointManager,
    latest_step,
    restore_pytree,
    save_pytree,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import FaultTolerantLoop  # noqa: E402
from repro_torch.runtime.train import TrainState, init_train_state, make_train_step  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the reduced models' ops are small, so more threads
    do not speed them up alone, and under parallel test workers they
    oversubscribe the cores (a 6 s test took 157 s)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tree(seed=0):
    """The reference's test tree: f32, bf16 and int32 leaves, nested."""
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)),
        "nested": {
            "b": torch.from_numpy(rng.standard_normal((3,)).astype(np.float32)).bfloat16(),
            "c": torch.tensor([1, 2, 3], dtype=torch.int32),
        },
    }


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


class TestSaveRestore:
    def test_roundtrip_with_bf16(self, tmp_path):
        t = _tree()
        d = str(tmp_path / "ck")
        save_pytree(t, d)
        _assert_trees_equal(t, restore_pytree(d, t))

    def test_atomic_no_partial_visible(self, tmp_path):
        root = str(tmp_path)
        # A stale tmp dir (simulated crash) must be invisible to discovery.
        os.makedirs(os.path.join(root, "step_00000005.tmp.deadbeef"))
        assert latest_step(root) is None
        save_pytree(_tree(), os.path.join(root, "step_00000005"))
        assert latest_step(root) == 5


    def test_restore_that_cannot_place_a_leaf_raises(self, tmp_path):
        """A meta template's plain leaf needs ``device=``, and a template of
        another shape is refused: nothing comes back placed otherwise."""
        t = _tree()
        d = str(tmp_path / "ck")
        save_pytree(t, d)
        meta = {"a": torch.zeros(4, 8, device="meta"), "nested": dict(t["nested"])}
        with pytest.raises(ValueError, match="device="):
            restore_pytree(d, meta)
        got = restore_pytree(d, meta, device="cpu")
        assert got["a"].device.type == "cpu" and torch.equal(got["a"], t["a"])
        with pytest.raises(ValueError, match="stored"):
            restore_pytree(d, {"a": torch.zeros(8, 4), "nested": dict(t["nested"])})


class TestManager:
    def test_async_save_and_restore_latest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        t1, t2 = _tree(1), _tree(2)
        mgr.save(10, t1)
        mgr.save(20, t2)
        mgr.wait()
        step, restored = mgr.restore(t2)
        assert step == 20
        _assert_trees_equal(t2, restored)

    def test_save_snapshots_before_returning(self, tmp_path):
        """The next step updates the weights in place: what was saved is the
        tree as it stood when ``save`` returned."""
        mgr = CheckpointManager(str(tmp_path))
        t = _tree(3)
        want = {"a": t["a"].clone(), "nested": dict(t["nested"])}
        mgr.save(1, t)
        t["a"].mul_(2.0)
        _assert_trees_equal(want, mgr.restore(want)[1])

    def test_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree(s), blocking=True)
        steps = sorted(int(n[5:]) for n in os.listdir(str(tmp_path)) if n.startswith("step_"))
        assert steps == [3, 4]

    def test_gc_of_stale_tmp(self, tmp_path):
        os.makedirs(str(tmp_path / "step_00000001.tmp.junk"))
        CheckpointManager(str(tmp_path))
        assert not any(".tmp." in n for n in os.listdir(str(tmp_path)))

    def test_restore_missing_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            mgr.restore(_tree())


class TestRestoreOntoDevice:
    def test_restore_onto_a_given_device(self, tmp_path):
        """The storage is device-free: each plain leaf lands on the device
        asked for (``device=``; re-sharding onto a mesh is
        :class:`TestElasticRemesh`)."""
        t = _tree()
        d = str(tmp_path / "ck")
        save_pytree(t, d)
        r = restore_pytree(d, t, device=torch.device("cpu"))
        _assert_trees_equal(t, r)
        assert all(leaf.device == torch.device("cpu") for leaf in _leaves(r))


class TestShardRegions:
    def test_regions_write_and_read_back(self, tmp_path):
        """A rank's region of a leaf file (any box of a C-ordered array, the
        empty one included) is written in place and read back as numpy
        slices it, in 300 seeded boxes of up to 4 dims."""
        from repro_torch.ckpt.checkpoint import _read_box, _write_box

        rng = np.random.default_rng(11)
        path = str(tmp_path / "leaf.bin")
        for _ in range(300):
            shape = [int(n) for n in rng.integers(1, 6, rng.integers(1, 5))]
            off = [int(rng.integers(0, n)) for n in shape]
            size = [int(rng.integers(0, n - o + 1)) for n, o in zip(shape, off)]
            whole = rng.standard_normal(shape).astype(np.float32)
            box = tuple(slice(o, o + z) for o, z in zip(off, size))
            fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
            os.ftruncate(fd, whole.nbytes)
            os.close(fd)
            _write_box(path, shape, whole.dtype, off, size, whole[box])
            want = np.zeros_like(whole)
            want[box] = whole[box]
            assert np.array_equal(np.fromfile(path, np.float32).reshape(shape), want)
            whole.tofile(path)
            assert np.array_equal(_read_box(path, shape, off, size, whole.dtype), whole[box])


class TestElasticRemesh:
    def test_restore_with_new_sharding(self, tmp_path):
        """The reference's elastic restart test: the tree saved by one
        process, restored onto a 1x1 mesh through ``shardings`` (a meta
        template, every leaf replicated) in a one-rank gloo group (the mesh
        harness's, in a process of its own: this one keeps no group).  Every
        leaf comes back a DTensor with those placements and the saved values."""
        from test_torch_mesh import run_ranks

        t = _tree()
        d = str(tmp_path / "ck")
        save_pytree(t, d)
        results, hung = run_ranks([("tree", "elastic_tree", None, True, {}, d)], shape=(1, 1),
                                  timeout=120)
        assert not hung and "error" not in results[0], results
        got = results[0]["tree"]
        for key, want in (("a", t["a"]), ("b", t["nested"]["b"]), ("c", t["nested"]["c"])):
            assert got[key]["dtensor"], key
            assert got[key]["placements"] == ["Replicate", "Replicate"], got[key]
            assert got[key]["dtype"] == str(want.dtype), got[key]
            np.testing.assert_array_equal(got[key]["values"], want.float().numpy()
                                          if want.dtype == torch.bfloat16 else want.numpy())


def test_reference_train_state_on_a_2x2_group(tmp_path):
    """A reduced qwen3-moe ``TrainState`` after one step, written by the
    reference's ``CheckpointManager``, restored by a 2x2 gloo group onto the
    train rules' placements: its next step gives the reference's loss.  The
    group's own (sharded) save of that state, read by the reference's
    ``restore_pytree`` onto a 1x1 JAX mesh through ``shardings``, is bit for
    bit the port's unsharded state."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from test_torch_mesh import run_ranks

    arch = "qwen3-moe-30b-a3b"
    cfg = get_config(arch, reduced=True)
    jm = JaxModel(jax_get_config(arch, reduced=True))
    jopt = JaxAdamWConfig(lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jm, jopt, num_microbatches=2))
    jstate, _ = jstep(jax_init_train_state(jm, jopt, jax.random.PRNGKey(0)),
                      jax.tree.map(jnp.asarray, _batch(cfg, 0)))
    root, out = str(tmp_path / "ref"), str(tmp_path / "group")
    JaxCheckpointManager(root).save(1, jstate, blocking=True)
    batch = _batch(cfg, 1)
    _, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))

    results, hung = run_ranks([("ref", "from_reference", arch, True, {},
                                {"root": root, "out": out, "batch": batch})])
    assert not hung and len(results) == 4, (hung, sorted(results))
    for r, res in results.items():
        assert "error" not in res, res["error"]
        got = res["ref"]
        assert got["step"] == 1 and "Shard" in got["placements"], got
        np.testing.assert_allclose(got["loss"], float(jmet["loss"]), rtol=1e-5)

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    abstract = jax.eval_shape(lambda: jstate)
    shardings = jax.tree.map(lambda _: NamedSharding(mesh, P()), abstract)
    sharded = jax_restore_pytree(out, abstract, shardings=shardings)
    plain = CheckpointManager(root).restore(
        init_train_state(Model(cfg, "cpu"), AdamWConfig(lr=1e-3), 5))[1]
    save_pytree(plain, str(tmp_path / "plain"))
    want = jax_restore_pytree(str(tmp_path / "plain"), abstract)
    got_leaves, want_leaves = jax.tree.leaves(sharded), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(jax.tree.leaves(jstate))
    for x, y in zip(got_leaves, want_leaves):
        assert isinstance(x.sharding, NamedSharding)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(np.asarray(x), np.asarray(y))


def _interop_np():
    """A tree of f32, bf16, int32 and scalar leaves in nested dicts and lists, as numpy."""
    rng = np.random.default_rng(7)
    return {
        "w": rng.standard_normal((5, 3)).astype(np.float32),
        "blocks": [{"k": rng.standard_normal((2, 4)).astype(np.float32),
                    "ids": rng.integers(-9, 9, (6,)).astype(np.int32)} for _ in range(2)],
        "half": rng.standard_normal((4, 2)).astype(np.float32),  # stored bf16
        "step": np.int32(12),
        "scale": np.float32(0.25),
    }


def _as_jax(t):
    out = jax.tree.map(jnp.asarray, t)
    out["half"] = out["half"].astype(jnp.bfloat16)
    return out


def _as_torch(t):
    if isinstance(t, dict):
        out = {k: _as_torch(v) for k, v in t.items()}
        if "half" in out:
            out["half"] = out["half"].bfloat16()
        return out
    if isinstance(t, list):
        return [_as_torch(v) for v in t]
    return torch.from_numpy(np.array(t))


def _jax_as_torch(t):
    return [torch.from_numpy(np.asarray(x, np.float32)).bfloat16() if x.dtype == jnp.bfloat16
            else torch.from_numpy(np.array(x)) for x in jax.tree.leaves(t)]


class TestFormatInterop:
    def test_same_tree_same_bytes(self, tmp_path):
        ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
        save_pytree(_as_torch(_interop_np()), ours)
        jax_save_pytree(_as_jax(_interop_np()), theirs)
        assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
        for name in os.listdir(theirs):
            with open(os.path.join(ours, name), "rb") as a, open(os.path.join(theirs, name),
                                                                 "rb") as b:
                assert a.read() == b.read(), name
        with open(os.path.join(ours, "manifest.json")) as f:
            paths = [e["path"] for e in json.load(f)["leaves"]]
        assert paths == ["blocks/[0]/ids", "blocks/[0]/k", "blocks/[1]/ids", "blocks/[1]/k",
                         "half", "scale", "step", "w"]

    def test_port_restores_reference_checkpoint(self, tmp_path):
        d = str(tmp_path / "ck")
        ref = _as_jax(_interop_np())
        jax_save_pytree(ref, d)
        got = restore_pytree(d, _as_torch(_interop_np()))
        want = _jax_as_torch(ref)
        assert len(_leaves(got)) == len(want)
        for x, y in zip(_leaves(got), want):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)

    def test_reference_restores_port_checkpoint(self, tmp_path):
        d = str(tmp_path / "ck")
        ours = _as_torch(_interop_np())
        save_pytree(ours, d)
        got = jax_restore_pytree(d, jax.eval_shape(lambda: _as_jax(_interop_np())))
        for x, y in zip(_jax_as_torch(got), _leaves(ours)):
            assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(2, cfg.vocab_size, (4, 32)).astype(np.int32)
            for k in ("tokens", "labels")}


def test_train_state_crosses_between_packages(tmp_path):
    """A reduced qwen3-moe TrainState after one step, written by the
    reference's CheckpointManager, is restored by the port into its per-layer
    modules; the next step gives the reference's loss.  The port's own
    checkpoint of that state has the reference's paths and bytes."""
    arch = "qwen3-moe-30b-a3b"
    cfg = get_config(arch, reduced=True)
    jm = JaxModel(jax_get_config(arch, reduced=True))
    jopt, opt = JaxAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    jstep = jax.jit(jax_make_train_step(jm, jopt, num_microbatches=2))
    jstate, _ = jstep(jax_init_train_state(jm, jopt, jax.random.PRNGKey(0)),
                      jax.tree.map(jnp.asarray, _batch(cfg, 0)))
    mgr = JaxCheckpointManager(str(tmp_path / "ref"))
    mgr.save(1, jstate, blocking=True)

    model = Model(cfg, "cpu")
    like = init_train_state(model, opt, 5)
    step, state = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert step == 1 and isinstance(state, TrainState)
    assert int(state.step) == 1 and int(state.opt_state["count"]) == 1
    assert all(p.requires_grad for p in state.params.parameters())
    carried = params_from_reference(jax.tree.map(np.asarray, jstate.params), cfg, "cpu")
    want = dict(carried.named_parameters())
    for name, p in state.params.named_parameters():
        assert torch.equal(p.detach(), want[name]), name

    save_pytree(state, str(tmp_path / "port"))
    ref_dir = mgr.directory(1)
    with open(os.path.join(ref_dir, "manifest.json")) as f:
        want = json.load(f)
    with open(tmp_path / "port" / "manifest.json") as f:
        assert json.load(f) == want
    for e in want["leaves"]:
        with open(os.path.join(ref_dir, e["file"]), "rb") as a, \
                open(tmp_path / "port" / e["file"], "rb") as b:
            assert a.read() == b.read(), e["path"]

    batch = _batch(cfg, 1)
    _, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    _, met = make_train_step(model, opt, num_microbatches=2)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)


def test_bf16_train_state_roundtrip(tmp_path):
    """bf16 masters and moments (jamba's setting) go through the stacked
    layout as uint16 payloads named ``bfloat16`` and come back bit for bit."""
    import dataclasses

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b", reduced=True),
                              param_dtype="bfloat16")
    model = Model(cfg, "cpu")
    opt = AdamWConfig(state_dtype="bfloat16")
    state = init_train_state(model, opt, 0)
    state.opt_state["m"].periods[0].mamba[1].mamba.in_proj.fill_(0.5)
    save_pytree(state, str(tmp_path / "ck"))
    got = restore_pytree(str(tmp_path / "ck"), init_train_state(model, opt, 1))
    for tree, want in ((got.params, state.params), (got.opt_state["m"], state.opt_state["m"]),
                       (got.opt_state["v"], state.opt_state["v"])):
        want = dict(want.named_parameters())
        for name, p in tree.named_parameters():
            assert p.dtype == want[name].dtype and torch.equal(p.detach(), want[name].detach())
    with open(tmp_path / "ck" / "manifest.json") as f:
        dtypes = {e["path"]: e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes["0/periods/mamba/mamba/in_proj"] == "bfloat16"
    assert dtypes["0/periods/mamba/mamba/A_log"] == "float32"  # kept float32 by init
    assert dtypes["1/count"] == dtypes["2"] == "int32"


class TestRestartExactness:
    def test_injected_failure_resumes_bit_exact(self, tmp_path):
        """A crash at step 12 restores from the step-10 checkpoint and ends
        where the uninterrupted run ends, bit for bit (the reference's test)."""
        kw = dict(arch="granite-3-8b", steps=16, batch=4, seq=32, reduced=True,
                  ckpt_every=5, num_microbatches=2, device="cpu")
        state_ok, hist_ok = run_training(ckpt_dir=str(tmp_path / "a"), **kw)
        state_ft, hist_ft = run_training(ckpt_dir=str(tmp_path / "b"), fail_at=12, **kw)
        for x, y in zip(state_ok.params.parameters(), state_ft.params.parameters()):
            assert torch.equal(x, y)
        assert int(state_ft.step) == 16
        assert [h["loss"] for h in hist_ft[-4:]] == [h["loss"] for h in hist_ok[-4:]]

    def test_too_many_restarts_raises(self, tmp_path):
        def bad_step(state, batch):
            raise RuntimeError("boom")

        loop = FaultTolerantLoop(step_fn=bad_step, batch_fn=lambda s: {},
                                 ckpt=CheckpointManager(str(tmp_path)), max_restarts=2)
        with pytest.raises(RuntimeError, match="boom"):
            loop.run({"w": torch.zeros(2)}, 0, 4)
