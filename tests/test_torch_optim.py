"""The port's optimizer substrate on the CPU against the JAX package's.

AdamW (clipping, weight decay, bf16 moments) at 1e-6, the global norm and
both schedules against ``repro.optim``; int8 quantization, dequantization
and error-feedback compression bit for bit (both round half to even); and
``compressed_psum`` in a two-process gloo group against the numpy formula.
AdamW's path by input: CPU and meta leaves, and a DTensor tree on the CPU,
take the plain loop (the card's kernels' twin) and count it.
"""
import socket

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import compress_grads as jax_compress_grads  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import dequantize_int8 as jax_dequantize_int8  # noqa: E402
from repro.optim import global_norm as jax_global_norm  # noqa: E402
from repro.optim import quantize_int8 as jax_quantize_int8  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.models import Params  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.models.spmd import is_dtensor  # noqa: E402
from repro_torch.optim import adamw as adamw_module  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_update,
    compress_grads,
    compressed_psum,
    constant,
    dequantize_int8,
    global_norm,
    quantize_int8,
    warmup_cosine,
)
from repro_torch.runtime import spans  # noqa: E402


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((8, 16)) * scale).astype(np.float32),
            "layers": [{"b": (rng.standard_normal(16) * scale).astype(np.float32)}
                       for _ in range(2)],
            "norm": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)}


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_torch_tree(v) for v in t]
    return torch.from_numpy(t.copy())


def _tree_to(t, device):
    if isinstance(t, dict):
        return {k: _tree_to(v, device) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_to(v, device) for v in t]
    return t.to(device)


def _jax_tree(t):
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_jax_tree(v) for v in t]
    return jnp.asarray(t)


def _pairs(port, ref):
    if isinstance(ref, dict):
        return [x for k in ref for x in _pairs(port[k], ref[k])]
    if isinstance(ref, list):
        return [x for a, b in zip(port, ref) for x in _pairs(a, b)]
    return [(port, ref)]


@pytest.mark.parametrize("clip,wd,state_dtype", [(None, 0.0, None), (1.0, 0.1, None),
                                                 (0.05, 0.1, "bfloat16"), (1.0, 0.5, "float32")],
                         ids=["plain", "clip_decay", "tight_clip_bf16_moments", "f32_moments"])
def test_adamw_matches_reference(clip, wd, state_dtype):
    """Three steps of AdamW over a nested tree, weights and moments at 1e-6."""
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd, clip_norm=clip, state_dtype=state_dtype)
    jcfg = JaxAdamWConfig(lr=jax_warmup_cosine(1e-2, 2, 6), **kw)
    cfg = AdamWConfig(lr=warmup_cosine(1e-2, 2, 6), **kw)
    jp, p = _jax_tree(_tree(0)), _torch_tree(_tree(0))
    jstate, state = jax_adamw_init(jcfg, jp), adamw_init(cfg, p)
    for step in range(3):
        g = _tree(10 + step, scale=0.3)
        jp, jstate, jstats = jax_adamw_update(jcfg, _jax_tree(g), jstate, jp)
        p, state, stats = adamw_update(cfg, _torch_tree(g), state, p)
        np.testing.assert_allclose(float(stats["grad_norm"]), float(jstats["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(stats["lr"]), float(jstats["lr"]), rtol=1e-6)
        assert int(state["count"]) == int(jstate["count"]) == step + 1
        for got, want in _pairs(p, jp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        for name in ("m", "v"):
            for got, want in _pairs(state[name], jstate[name]):
                assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
                np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=1e-6,
                                           atol=1e-7 if want.dtype == jnp.float32 else 1e-2)


def test_adamw_updates_params_in_place():
    cfg = AdamWConfig(lr=0.1, clip_norm=None)
    params = Params({"w": torch.ones(4), "inner": {"b": torch.ones(2)}})
    state = adamw_init(cfg, params)
    assert isinstance(state["m"], Params) and state["m"].inner.b.shape == (2,)
    w = params.w
    out, state, _ = adamw_update(cfg, {"w": torch.ones(4), "inner": {"b": -torch.ones(2)}},
                                 state, params)
    assert out is params and params.w is w
    assert bool((w < 1).all()) and bool((state["m"].inner.b < 0).all())


def test_adamw_matches_hand_rolled_adam():
    """One fp32 step against the hand-rolled formula (the reference's test)."""
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads = {"w": torch.tensor([0.5, 0.5, -1.0])}
    state = adamw_init(cfg, params)
    want = params["w"].numpy() - 0.1 * (0.1 * grads["w"].numpy() / 0.1) / (
        np.sqrt(0.01 * grads["w"].numpy() ** 2 / 0.01) + 1e-8)
    new_params, new_state, _ = adamw_update(cfg, grads, state, params)
    np.testing.assert_allclose(new_params["w"].numpy(), want, rtol=1e-6)
    assert int(new_state["count"]) == 1


def test_global_norm():
    t = _tree(3)
    np.testing.assert_allclose(float(global_norm(_torch_tree(t))),
                               float(jax_global_norm(_jax_tree(t))), rtol=1e-6)
    assert float(global_norm({"a": torch.tensor([3.0]), "b": torch.tensor([4.0])})) == 5.0


def test_schedules_match_reference():
    sched, jsched = warmup_cosine(3e-4, 10, 100), jax_warmup_cosine(3e-4, 10, 100)
    for step in range(0, 121):
        got = sched(step)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jsched(step)), rtol=1e-6, atol=1e-12)
    assert float(sched(torch.tensor(55, dtype=torch.int32))) == float(sched(55))
    assert float(constant(0.5)(123)) == float(jax_constant(0.5)(123)) == 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_quantization_bit_equal(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(1000) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    x[:4] = [127.0, -63.5, 0.5, 0.0] / np.float32(127.0) * np.abs(x).max()  # ties to even
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jax_quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    assert np.array_equal(dequantize_int8(q, s).numpy(), np.asarray(jax_dequantize_int8(jq, js)))
    zero_q, _ = quantize_int8(torch.zeros(8))
    assert not zero_q.any()


def test_compress_grads_bit_equal_with_error_feedback():
    rng = np.random.default_rng(4)
    err, jerr = {"w": torch.zeros(64)}, {"w": jnp.zeros(64)}
    for _ in range(5):
        g = {"w": (rng.standard_normal(64) * 0.01).astype(np.float32)}
        deq, err = compress_grads({"w": torch.from_numpy(g["w"])}, err)
        jdeq, jerr = jax_compress_grads({"w": jnp.asarray(g["w"])}, jerr)
        assert np.array_equal(deq["w"].numpy(), np.asarray(jdeq["w"]))
        assert np.array_equal(err["w"].numpy(), np.asarray(jerr["w"]))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _psum_worker(rank, world, port, xs, out):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        out[rank] = compressed_psum(torch.from_numpy(xs[rank])).numpy()
    finally:
        dist.destroy_process_group()


def test_compressed_psum_in_a_gloo_group():
    """Two ranks: the MAX of the amax sets one scale, the int8 payloads sum as
    int32, then the rescale, as the numpy formula of the reference's
    ``pmax`` + ``psum``."""
    import torch.multiprocessing as mp

    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(257).astype(np.float32) * s for s in (1.0, 3.0)]
    scale = np.float32(max(np.abs(x).max() for x in xs)) / np.float32(127.0)
    want = sum(np.clip(np.round(x / scale), -127, 127).astype(np.int32) for x in xs)
    want = want.astype(np.float32) * scale
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        out = manager.dict()
        port = _free_port()
        procs = [ctx.Process(target=_psum_worker, args=(r, 2, port, xs, out)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
        for r in range(2):
            np.testing.assert_array_equal(out[r], want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_leaves_take_the_plain_loop_and_count_it(device):
    """A traced step on CPU (or meta) leaves counts every leaf as
    ``adamw.plain`` and none as ``adamw.fused``, and launches no kernel."""
    cfg = AdamWConfig(lr=warmup_cosine(1e-2, 2, 6))
    params = _torch_tree(_tree(0))
    grads = _torch_tree(_tree(1, scale=0.3))
    if device == "meta":
        params, grads = (_tree_to(t, "meta") for t in (params, grads))
    state = adamw_init(cfg, params)
    leaves = len(_pairs(params, params))
    before = kernels.launch_counts()
    spans.clear()
    spans.enable()
    try:
        with spans.step(device):
            adamw_update(cfg, grads, state, params)
        (st,) = spans.steps()
    finally:
        spans.disable()
        spans.clear()
    assert st["counters"] == {"adamw.fused": 0, "adamw.plain": leaves}
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("wrapper", ["adamw_norm", "adamw_update"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """The kernels' wrappers take CUDA tensors only: a CPU leaf raises before
    any launch (the optimizer sends CPU leaves to the loop)."""
    x, s = torch.ones(4), torch.ones(())
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="optim/adamw.py's loop"):
        if wrapper == "adamw_norm":
            kernels.adamw_norm([x], 1.0)
        else:
            kernels.adamw_update(x, x, x.clone(), x.clone(), s, s, s, s, b1=0.9, b2=0.95,
                                 eps=1e-8, weight_decay=0.1)
    assert kernels.launch_counts() == before


def _dtensor_worker(port, out):
    """One rank over a CPU mesh: AdamW on a DTensor tree against the same
    tree of plain tensors, with ``global_norm`` watched."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), "cpu")
        calls = []
        plain_norm = adamw_module.global_norm

        def watched(tree):
            calls.append(sum(map(is_dtensor, tree_leaves(tree))))  # DTensor leaves seen
            return plain_norm(tree)

        adamw_module.global_norm = watched
        cfg = AdamWConfig(lr=warmup_cosine(1e-2, 2, 6), weight_decay=0.1, clip_norm=0.05)
        flat = lambda t: {"w": t["w"], "b0": t["layers"][0]["b"], "norm": t["norm"]}
        params = flat(_torch_tree(_tree(0)))
        place = lambda k, x: distribute_tensor(x.clone(), mesh,
                                               [Shard(0) if k == "w" else Replicate()])
        dparams = {k: place(k, x) for k, x in params.items()}
        state, dstate = adamw_init(cfg, params), adamw_init(cfg, dparams)
        counters = []
        for step in range(3):
            grads = flat(_torch_tree(_tree(10 + step, scale=0.3)))
            dgrads = {k: place(k, x) for k, x in grads.items()}
            spans.enable()
            with spans.step("cpu"):
                _, dstate, dstats = adamw_update(cfg, dgrads, dstate, dparams)
            spans.disable()
            counters.append(spans.steps()[-1]["counters"])
            spans.clear()
            _, state, stats = adamw_update(cfg, grads, state, params)
            out["norms"] = out.get("norms", []) + [(float(dstats["grad_norm"]),
                                                   float(stats["grad_norm"]))]
        out["equal"] = all(torch.equal(dparams[k].full_tensor(), params[k])
                           and torch.equal(dstate[n][k].full_tensor(), state[n][k])
                           for k in params for n in ("m", "v"))
        out["calls"], out["counters"] = calls, counters
    finally:
        adamw_module.global_norm = plain_norm
        dist.destroy_process_group()


def test_dtensor_tree_on_cpu_takes_global_norm():
    """A DTensor tree on a one-rank CPU mesh: the norm is ``global_norm``'s
    (once a step, over every leaf), each leaf's shard takes the loop, and
    three steps give the plain tree's weights and moments bit for bit."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        out = manager.dict()
        proc = ctx.Process(target=_dtensor_worker, args=(_free_port(), out))
        proc.start()
        proc.join(timeout=120)
        assert proc.exitcode == 0, proc.exitcode
        out = dict(out)
    assert out["calls"] == [3, 0] * 3  # the DTensor tree's step, then the plain tree's
    assert out["counters"] == [{"adamw.fused": 0, "adamw.plain": 3}] * 3
    assert all(d == p for d, p in out["norms"]), out["norms"]
    assert out["equal"]


def test_kernel_wrappers_count_only_what_they_launch(monkeypatch):
    """The wrappers' plumbing, with each launch recorded in place of the
    card's: an empty leaf launches no update and counts none; the norm
    launches a partial for each non-empty leaf, then (on a mesh) the rank's
    sum, ``reduce`` and the finish over its total, and counts the call once."""
    from repro_torch.kernels import adamw as kernel_module

    launched = []
    monkeypatch.setattr(kernel_module, "_check", lambda *args, **kwargs: None)
    monkeypatch.setattr(kernel_module._build, "build_train", lambda: None)
    monkeypatch.setattr(kernel_module._build, "launch",
                        lambda lib, symbol, argtypes, device, *args: launched.append(symbol))
    s, hyper = torch.ones(()), {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}
    empty, leaf = torch.ones(0), torch.ones(5)
    before = kernels.launch_counts()
    kernels.adamw_update(empty, empty, empty.clone(), empty.clone(), s, s, s, s, **hyper)
    assert launched == [] and kernels.launch_counts() == before
    kernels.adamw_update(leaf, leaf, leaf.clone(), leaf.clone(), s, s, s, s, **hyper)
    assert launched == ["adamw_update"]
    assert kernels.launch_counts() == before | {"adamw_update": before["adamw_update"] + 1}

    launched.clear()
    reduced = []
    kernels.adamw_norm([leaf, empty, leaf], 1.0,
                       reduce=lambda x: reduced.append(tuple(x.shape)) or torch.ones(1))
    assert launched == ["adamw_norm_partial", "adamw_norm_partial", "adamw_norm_sum",
                        "adamw_norm_finish"]
    assert reduced == [(1,)]
    launched.clear()
    kernels.adamw_norm([], None, device=torch.device("cpu"), reduce=lambda x: torch.ones(1))
    assert launched == ["adamw_norm_sum", "adamw_norm_finish"]
    with pytest.raises(ValueError, match="no gradients"):
        kernels.adamw_norm([], None)
    assert kernels.launch_counts() == before | {"adamw_update": before["adamw_update"] + 1,
                                                "adamw_norm": before["adamw_norm"] + 2}


def _mesh_norm_worker(rank, world, port, out):
    """One rank of a 2x2 CPU mesh: the shards ``_norm_shards`` picks, their
    sum of squares added over the mesh by ``_mesh_sum``, against the norm
    of the whole tensors."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        i, _ = mesh.get_coordinate()
        gen = torch.Generator().manual_seed(7)  # the same tree on every rank
        x = lambda *shape: torch.randn(*shape, generator=gen)
        R, S0, S1 = Replicate(), Shard(0), Shard(1)
        grads = {
            "replicated": distribute_tensor(x(5, 3), mesh, [R, R]),
            "rows": distribute_tensor(x(6, 4), mesh, [S0, R]),
            "cols": distribute_tensor(x(6, 4), mesh, [R, S1]),
            "both": distribute_tensor(x(6, 4), mesh, [S0, S1]),
            "uneven": distribute_tensor(x(1, 3), mesh, [S0, R]),  # mesh row 1's shard is empty
            "partial": DTensor.from_local(x(4, 2) * (i + 1), mesh, [Partial(), R]),
            "plain": x(3),
        }
        whole = [g.full_tensor() if is_dtensor(g) else g for g in grads.values()]
        shards, _ = adamw_module._norm_shards(list(grads.values()))
        local = sum((s.square().sum() for s in shards), torch.zeros(()))
        total = adamw_module._mesh_sum(mesh)(local.reshape(1))
        want = sum(float(w.double().square().sum()) for w in whole)
        out[rank] = (tuple(mesh.get_coordinate()), len(shards), [s.numel() for s in shards],
                     float(total), want)
    finally:
        dist.destroy_process_group()


def test_mesh_norm_counts_each_element_once():
    """Four ranks of a 2x2 gloo mesh: each DTensor leaf's shard counts on
    the ranks first along every mesh dim that replicates it (a replicated
    leaf, a plain leaf and a ``Partial`` one, once summed, on rank (0, 0)
    alone), an empty shard counts nothing, and the ranks' sums of squares
    added over the mesh give the tree's, on every rank."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        out = manager.dict()
        port = _free_port()
        procs = [ctx.Process(target=_mesh_norm_worker, args=(r, 4, port, out)) for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
        out = dict(out)
    # replicated, rows, cols, both, uneven, partial, plain
    want = {(0, 0): [15, 12, 12, 6, 3, 8, 3], (0, 1): [12, 6], (1, 0): [12, 6, 0], (1, 1): [6]}
    assert {c: sizes for c, _, sizes, _, _ in out.values()} == want
    for _, n, sizes, total, whole in out.values():
        assert n == len(sizes)
        assert total == pytest.approx(whole, rel=1e-6)
