"""The port's optimizer substrate on the CPU against the JAX package's.

AdamW (clipping, weight decay, bf16 moments) at 1e-6, the global norm and
both schedules against ``repro.optim``; int8 quantization, dequantization
and error-feedback compression bit for bit (both round half to even); and
``compressed_psum`` in a two-process gloo group against the numpy formula.
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
from repro_torch.models import Params  # noqa: E402
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
