"""The port's flash attention on the CPU (its plain twin) against the JAX package.

The JAX side runs as its own tests run it: ``flash_attention`` in Pallas
``interpret=True`` mode, and ``chunked_attention`` (what prefill calls) for
ragged lengths, which the Pallas kernel does not take.  Tolerances are the
reference's own (``tests/test_kernels.py``): 2e-5 in float32, 5e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (before repro.kernels: import cycle)
from repro.kernels import flash_attention as jax_flash_attention  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402
from repro_torch.kernels import flash_attention, launch_counts  # noqa: E402


def _qkv(b, h, s, t, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, s, d), (b, h, t, d), (b, h, t, d)))


def _port(q, k, v, causal, dtype=torch.float32):
    return flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal=causal)


@pytest.mark.parametrize("b,h,s,d,qb,kc", [
    (1, 2, 128, 32, 64, 64),
    (2, 4, 256, 64, 128, 128),
    (1, 1, 128, 128, 128, 128),
    (2, 2, 192, 32, 64, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_jax_flash_attention(b, h, s, d, qb, kc, causal):
    q, k, v = _qkv(b, h, s, s, d, seed=1)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               q_block=qb, kv_chunk=kc)
    got = _port(q, k, v, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_cross_attention_shape():
    q, k, v = _qkv(1, 2, 64, 128, 32, seed=2)  # T != S
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                               q_block=64, kv_chunk=64)
    np.testing.assert_allclose(_port(q, k, v, False).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_bf16():
    q, k, v = _qkv(1, 2, 128, 128, 64, seed=3)
    want = jax_flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True)
    got = _port(q, k, v, True, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("s,t,causal", [(100, 100, True), (50, 70, True), (70, 50, False),
                                        (37, 37, True)])
def test_ragged_lengths_match_chunked_attention(s, t, causal):
    q, k, v = _qkv(2, 2, s, t, 16, seed=4)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             kv_chunk=16)
    np.testing.assert_allclose(_port(q, k, v, causal).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_cpu_tensors_run_the_twin_and_launch_nothing():
    q, k, v = _qkv(1, 2, 32, 32, 16, seed=5)
    before = launch_counts()["flash_attention"]
    _port(q, k, v, True)
    assert launch_counts()["flash_attention"] == before


@pytest.mark.parametrize("shapes", [
    ((1, 2, 8, 16), (1, 2, 8, 32), (1, 2, 8, 32)),   # head sizes differ
    ((1, 2, 8, 16), (1, 4, 8, 16), (1, 4, 8, 16)),   # head counts differ
    ((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 9, 16)),   # k and v differ
    ((2, 8, 16), (2, 8, 16), (2, 8, 16)),            # not 4-d
])
def test_shape_mismatch_raises(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("s,t,causal", [(100, 100, True), (50, 70, True), (70, 50, False)])
def test_gqa_equals_head_repeated_and_matches_jax(hkv, s, t, causal):
    """Un-repeated K/V (B, Hkv, T, Dh), q head h reading kv head h // (H // Hkv):
    bit for bit the twin on head-repeated K/V, and the JAX kernel's result on
    those (it takes only head-repeated K/V)."""
    h, g = 8, 8 // hkv
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, h, s, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, hkv, t, 32)).astype(np.float32) for _ in range(2))
    kr, vr = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)  # head h <- kv head h // g
    got = _port(q, k, v, causal)
    assert torch.equal(got, _port(q, kr, vr, causal))
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
