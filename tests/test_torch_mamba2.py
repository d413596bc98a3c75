"""The port's Mamba2 mixer (``repro_torch.models.mamba2``) against the JAX package's.

Every function gets the same seeded numpy inputs on both sides, in float32,
and must agree within 1e-5: the two sides take the same products in other
orders (XLA's contraction order against the port's two-operand steps), which
moves float32 results by a few 1e-7 at these sizes; a wrong decay, mask,
padding or state hand-off moves them by 1e-2 or more.  The chunked scan is
checked at S not divisible by the chunk (padding), with an initial state and
with two state groups.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SSMSettings as JaxSSMSettings  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro_torch.configs.base import SSMSettings  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, P, N = 2, 4, 8, 6


def _rng(seed):
    return np.random.default_rng(seed)


def _ssd_inputs(s, g, seed=0):
    rng = _rng(seed)
    x = rng.standard_normal((B, s, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, H)))).astype(np.float32)  # softplus > 0
    a = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    bm = rng.standard_normal((B, s, g, N)).astype(np.float32)
    cm = rng.standard_normal((B, s, g, N)).astype(np.float32)
    return x, dt, a, bm, cm


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL, err_msg=what)


def _pt(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jx(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("s", [16, 37, 64])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "initial_state"])
def test_ssd_chunked_matches_reference(s, g, with_state):
    x, dt, a, bm, cm = _ssd_inputs(s, g, seed=s + g)
    s0 = _rng(7).standard_normal((B, H, P, N)).astype(np.float32) if with_state else None
    want_y, want_state = jm2.ssd_chunked(*_jx(x, dt, a, bm, cm), chunk=16,
                                         initial_state=None if s0 is None else jnp.asarray(s0))
    y, state = m2.ssd_chunked(*_pt(x, dt, a, bm, cm), chunk=16,
                              initial_state=None if s0 is None else torch.from_numpy(s0))
    assert y.shape == (B, s, H, P) and state.shape == (B, H, P, N)
    assert state.dtype == torch.float32
    _close(y, want_y, "y")
    _close(state, want_state, "final state")


def test_segsum_matches_reference():
    a = _rng(1).standard_normal((3, 5, 9)).astype(np.float32)
    want = np.asarray(jm2._segsum(jnp.asarray(a)))
    got = m2._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], **TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    rng = _rng(3 + g)
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, H))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    bt, ct = (rng.standard_normal((B, g, N)).astype(np.float32) for _ in range(2))
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    want_y, want_state = jm2.ssd_decode_step(*_jx(x, dt, a, bt, ct, state))
    y, new_state = m2.ssd_decode_step(*_pt(x, dt, a, bt, ct, state))
    _close(y, want_y, "y")
    _close(new_state, want_state, "state")


@pytest.mark.parametrize("s", [1, 2, 11])
def test_causal_conv1d_matches_reference(s):
    rng = _rng(s)
    x = rng.standard_normal((B, s, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    _close(m2.causal_conv1d(*_pt(x, w, b)), jm2.causal_conv1d(*_jx(x, w, b)))


def test_conv_decode_step_matches_reference():
    rng = _rng(5)
    x = rng.standard_normal((B, 10)).astype(np.float32)
    state = rng.standard_normal((B, 3, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    want_y, want_state = jm2.conv_decode_step(*_jx(x, state, w, b))
    y, new_state = m2.conv_decode_step(*_pt(x, state, w, b))
    _close(y, want_y, "y")
    _close(new_state, want_state, "state")


def test_conv_decode_step_promotes_as_the_reference():
    """A float32 state (what prefill returns under mixed precision) and a
    bf16 input give a float32 window and a bf16 output, as jnp promotes."""
    x = torch.ones((B, 10), dtype=torch.bfloat16)
    y, state = m2.conv_decode_step(x, torch.zeros((B, 3, 10)), torch.ones((4, 10)),
                                   torch.zeros(10))
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    jy, jstate = jm2.conv_decode_step(jnp.ones((B, 10), jnp.bfloat16), jnp.zeros((B, 3, 10)),
                                      jnp.ones((4, 10)), jnp.zeros(10))
    assert str(jy.dtype) == "bfloat16" and str(jstate.dtype) == "float32"


SSM = dict(d_state=8, expand=2, d_conv=4, head_dim=8, n_groups=2, chunk=16)
D_MODEL = 16


def _mixer_params(seed=0):
    """The JAX package's initialised mixer weights, perturbed so that the
    biases, decays and skip weights are not their init constants."""
    p = jm2.init_mamba_params(jax.random.PRNGKey(seed), D_MODEL, JaxSSMSettings(**SSM),
                              jnp.float32)
    rng = _rng(seed)
    p = {k: np.array(v) for k, v in p.items()}
    for name in ("conv_b", "dt_bias", "A_log", "D", "norm_w"):
        p[name] = (p[name] + 0.3 * rng.standard_normal(p[name].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("s", [2, 37])
def test_mamba_mixer_matches_reference(s):
    p = _mixer_params()
    x = _rng(11).standard_normal((B, s, D_MODEL)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want, (want_conv, want_ssm) = jm2.mamba_mixer(jp, jnp.asarray(x), JaxSSMSettings(**SSM),
                                                  return_state=True)
    got, (conv, ssm) = m2.mamba_mixer(tp, torch.from_numpy(x), SSMSettings(**SSM),
                                      return_state=True)
    assert conv.shape == (B, SSM["d_conv"] - 1, 2 * D_MODEL + 2 * 2 * 8)
    _close(got, want, "out")
    _close(conv, want_conv, "conv state")
    _close(ssm, want_ssm, "ssm state")
    plain = m2.mamba_mixer(tp, torch.from_numpy(x), SSMSettings(**SSM))
    assert torch.equal(plain, got)


def test_mamba_mixer_initial_state_matches_reference():
    p = _mixer_params(1)
    x = _rng(12).standard_normal((B, 20, D_MODEL)).astype(np.float32)
    h = 2 * D_MODEL // SSM["head_dim"]
    s0 = _rng(13).standard_normal((B, h, SSM["head_dim"], SSM["d_state"])).astype(np.float32)
    want = jm2.mamba_mixer({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                           JaxSSMSettings(**SSM), initial_state=jnp.asarray(s0))
    got = m2.mamba_mixer({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                         SSMSettings(**SSM), initial_state=torch.from_numpy(s0))
    _close(got, want)


def test_mamba_decode_step_matches_reference():
    p = _mixer_params(2)
    rng = _rng(14)
    h = 2 * D_MODEL // SSM["head_dim"]
    x = rng.standard_normal((B, D_MODEL)).astype(np.float32)
    conv = rng.standard_normal((B, 3, 2 * D_MODEL + 2 * 2 * 8)).astype(np.float32)
    ssm = rng.standard_normal((B, h, SSM["head_dim"], SSM["d_state"])).astype(np.float32)
    want = jm2.mamba_decode_step({k: jnp.asarray(v) for k, v in p.items()},
                                 *_jx(x, conv, ssm), JaxSSMSettings(**SSM))
    got = m2.mamba_decode_step({k: torch.from_numpy(v) for k, v in p.items()},
                               *_pt(x, conv, ssm), SSMSettings(**SSM))
    for g, w, what in zip(got, want, ("out", "conv state", "ssm state")):
        _close(g, w, what)


def test_prefill_then_decode_matches_the_longer_prefill():
    """A chunked prefill of 37 tokens (3 chunks, padded) handed to 5 decode
    steps gives what the chunked form gives over all 42 tokens, on both
    sides."""
    p = _mixer_params(3)
    s, steps = 37, 5
    x = _rng(15).standard_normal((B, s + steps, D_MODEL)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    cfg = SSMSettings(**SSM)
    whole = m2.mamba_mixer(tp, torch.from_numpy(x), cfg)
    want_whole = jm2.mamba_mixer({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                 JaxSSMSettings(**SSM))
    _close(whole, want_whole, "whole")
    out, (conv, ssm) = m2.mamba_mixer(tp, torch.from_numpy(x[:, :s]), cfg, return_state=True)
    torch.testing.assert_close(out, whole[:, :s], **TOL)
    for t in range(s, s + steps):
        y, conv, ssm = m2.mamba_decode_step(tp, torch.from_numpy(x[:, t]), conv, ssm, cfg)
        torch.testing.assert_close(y, whole[:, t], **TOL, msg=lambda m: f"step {t}: {m}")


def test_init_mamba_params_shapes_and_types():
    cfg = SSMSettings(**SSM)
    gen = torch.Generator().manual_seed(0)
    p = m2.init_mamba_params(gen, D_MODEL, cfg, torch.bfloat16)
    want = jm2.init_mamba_params(jax.random.PRNGKey(0), D_MODEL, JaxSSMSettings(**SSM),
                                 jnp.bfloat16)
    assert sorted(p) == sorted(want)
    for name, w in want.items():
        assert tuple(p[name].shape) == w.shape, name
        assert str(p[name].dtype).removeprefix("torch.") == str(w.dtype), name
    for name in ("conv_b", "dt_bias", "A_log", "D", "norm_w"):  # the constants
        np.testing.assert_array_equal(p[name].float().numpy(),
                                      np.asarray(want[name]).astype(np.float32))
