"""The port's expert SwiGLU on the CPU (its plain twin) against the JAX package.

The JAX side runs as its own tests run it (Pallas ``interpret=True``); the
reference's tolerance in float32 is 2e-5 (``tests/test_kernels.py``).  In
bf16 the port rounds the hidden ``h`` to bf16 before the down product, as
the reference's ``moe_ffn`` does (``src/repro/models/moe.py:269-272``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (before repro.kernels: import cycle)
from repro.kernels import moe_mlp as jax_moe_mlp  # noqa: E402
from repro.kernels.ref import moe_mlp_ref as jax_moe_mlp_ref  # noqa: E402
from repro_torch.kernels import launch_counts, moe_mlp  # noqa: E402


def _problem(e, c, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, d)).astype(np.float32),
            (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
            (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
            (rng.standard_normal((e, f, d)) * 0.1).astype(np.float32))


def _port(arrays, dtype=torch.float32):
    return moe_mlp(*(torch.from_numpy(a).to(dtype) for a in arrays))


@pytest.mark.parametrize("e,c,d,f,tm", [
    (4, 128, 64, 128, 128),
    (2, 256, 128, 256, 128),
    (8, 128, 32, 64, 64),
])
def test_matches_jax_moe_mlp(e, c, d, f, tm):
    arrays = _problem(e, c, d, f)
    want = jax_moe_mlp(*(jnp.asarray(a) for a in arrays), tm=tm)
    np.testing.assert_allclose(_port(arrays).numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_ragged_capacity_matches_jax_ref():
    # The Pallas kernel needs capacity % tm == 0; the port takes any capacity.
    arrays = _problem(3, 100, 32, 64, seed=1)
    want = jax_moe_mlp_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(_port(arrays).numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_bf16_rounds_h_as_moe_ffn_does():
    x, wg, wu, wd = (jnp.asarray(a, jnp.bfloat16) for a in _problem(4, 64, 64, 128, seed=2))
    # The expert SwiGLU lines of the reference's moe_ffn (moe.py:269-272).
    gate = jnp.einsum("ecd,edf->ecf", x, wg, preferred_element_type=jnp.float32)
    up = jnp.einsum("ecd,edf->ecf", x, wu, preferred_element_type=jnp.float32)
    h = (jax.nn.silu(gate) * up).astype(jnp.bfloat16)
    want = jnp.einsum("ecf,efd->ecd", h, wd, preferred_element_type=jnp.bfloat16)
    got = moe_mlp(*(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                    for a in (x, wg, wu, wd)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_cpu_tensors_run_the_twin_and_launch_nothing():
    before = launch_counts()["moe_mlp"]
    _port(_problem(2, 8, 16, 32))
    assert launch_counts()["moe_mlp"] == before


@pytest.mark.parametrize("which", ["w_gate", "w_up", "w_down"])
def test_weight_shape_mismatch_raises(which):
    x, wg, wu, wd = (torch.from_numpy(a) for a in _problem(2, 8, 16, 32))
    bad = {"w_gate": wg, "w_up": wu, "w_down": wd}
    bad[which] = bad[which][:, :-1]
    with pytest.raises(ValueError):
        moe_mlp(x, bad["w_gate"], bad["w_up"], bad["w_down"])


def test_empty_experts_give_exact_zeros_and_match_jax_elsewhere():
    # moe_ffn's slabs: an expert no token chose is all zeros, and its output
    # is +0 exactly (the CUDA kernel writes it without reading the weights).
    x, wg, wu, wd = _problem(6, 128, 64, 128, seed=3)
    x[[1, 4]] = 0.0
    x[2, 100:] = 0.0  # a partly filled expert
    want = np.asarray(jax_moe_mlp(*(jnp.asarray(a) for a in (x, wg, wu, wd)), tm=128))
    got = _port((x, wg, wu, wd))
    for e in (1, 4):
        assert torch.equal(got[e], torch.zeros_like(got[e]))
        assert not bool(torch.signbit(got[e]).any())
    assert torch.equal(got[2, 100:], torch.zeros_like(got[2, 100:]))
    keep = [0, 2, 3, 5]
    np.testing.assert_allclose(got.numpy()[keep], want[keep], rtol=2e-5, atol=2e-5)
