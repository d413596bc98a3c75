"""The port's training path on the CPU against the JAX package's.

Every registered architecture's reduced config (float32 compute) runs the
port's ``Model.loss_fn`` and backward pass with the JAX package's own
initialised weights, carried across by ``params_from_reference``, against
``jax.value_and_grad(model.loss_fn)``; one ``make_train_step`` step at one
and two microbatches against the reference's; ``chunked_attention`` and
``chunked_ce_loss`` values and gradients against the reference's functions.
Tolerances: the loss within 1e-5 relative, each gradient leaf (one layer's
weight) within 1e-4 of that leaf's largest magnitude (float32 sums taken in
other orders by XLA and PyTorch over two layers of width 64 move them by a
few 1e-6 of it; a dropped term, a detached cast or a wrong mask moves them
by 1e-2 or more), and the updated weights within the reference's own
2e-4 / 2e-5 (``tests/test_runtime.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (before repro.kernels: import cycle)
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.layers import chunked_attention as jax_chunked_attention  # noqa: E402
from repro.models.layers import repeat_kv as jax_repeat_kv  # noqa: E402
from repro.models.model import chunked_ce_loss as jax_chunked_ce_loss  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.runtime import init_train_state as jax_init_train_state  # noqa: E402
from repro.runtime import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention, moe_mlp  # noqa: E402
from repro_torch.models import Model, Params, params_from_reference  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.models.layers import chunked_attention  # noqa: E402
from repro_torch.models.model import chunked_ce_loss  # noqa: E402
from repro_torch.optim import AdamWConfig, warmup_cosine  # noqa: E402
from repro_torch.runtime.train import (  # noqa: E402
    TrainState,
    init_train_state,
    make_train_step,
    split_microbatches,
)

ARCHS = list_archs()
STEP_TOL = dict(rtol=2e-4, atol=2e-5)  # the reference's (tests/test_runtime.py:100-103)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the reduced models' ops are small, so more threads
    do not speed them up alone, and under parallel test workers they
    oversubscribe the cores (a 6 s test took 157 s)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batch(cfg, b, s, seed=0):
    """numpy inputs as the reference's tests build them, plus ``labels``: a
    front end's ``embeds`` (and M-RoPE's ``positions3``) in place of tokens;
    ``encdec`` adds ``enc_embeds`` and the decoder's tokens."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend:
        batch = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
        if cfg.mrope:
            idx = np.arange(s, dtype=np.int32)
            batch["positions3"] = np.broadcast_to(
                np.stack([idx, idx // 4, idx % 4]).astype(np.int32)[:, None], (3, b, s)).copy()
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal((b, s + 3, cfg.d_model)).astype(np.float32)
        batch["tokens"] = rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32)
    batch["labels"] = rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32)
    return batch


def _pt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _reference(arch, seed=0):
    cfg = get_config(arch, reduced=True)
    jm = JaxModel(jax_get_config(arch, reduced=True))
    jp = jm.init(jax.random.PRNGKey(seed))
    return cfg, jm, jp


def _grads(params: Params) -> dict:
    """Each master's gradient; zeros for a master the loss does not read."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in params.named_parameters()}


def _assert_leaves_close(got: dict, want: Params, tol: float, what: str):
    """Each port leaf (one layer's weight) within ``tol`` of its largest magnitude."""
    want = dict(want.named_parameters())
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        w = w.detach().numpy()
        g = got[name].detach().numpy()
        bound = tol * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{what} {name}: max |diff| {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg, jm, jp = _reference(arch)
    batch = _batch(cfg, 2, 32)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, _jx(batch))
    params = params_from_reference(_np_tree(jp), cfg, "cpu").requires_grad_()
    loss, met = Model(cfg, "cpu").loss_fn(params, _pt(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"].detach()), float(jmet["aux"]), rtol=1e-5,
                               atol=1e-7)
    want = params_from_reference(_np_tree(jgrads), cfg, "cpu")
    got = _grads(params)
    # The same leaves have nonzero gradients in both (the seamless decoder's
    # embedding reads no token: its embeds win, in both packages).
    nonzero = {n for n, g in got.items() if bool(g.abs().max() > 0)}
    assert nonzero == {n for n, w in want.named_parameters() if bool(w.abs().max() > 0)}
    _assert_leaves_close(got, want, 1e-4, arch)


def test_bf16_compute_gradients_reach_the_float32_masters():
    """The compute cast stays in autograd's graph: the masters' gradients are
    float32 and nonzero, where serving's frozen copies cut them off."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", reduced=True),
                              compute_dtype="bfloat16")
    model = Model(cfg, "cpu")
    params = model.init(0).requires_grad_()
    loss, _ = model.loss_fn(params, _pt(_batch(cfg, 2, 32)))
    loss.backward()
    for name, p in params.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert bool(p.grad.abs().max() > 0), name
    frozen = model.compute_params(params)
    assert not any(w.requires_grad for w in frozen.parameters())


@pytest.mark.parametrize("causal,s,t,hkv", [(True, 40, 40, 2), (False, 24, 40, 4),
                                            (True, 37, 37, 1), (False, 16, 23, 2)],
                         ids=["causal_gqa", "cross", "ragged_mqa", "ragged_cross_gqa"])
def test_chunked_attention_matches_reference(causal, s, t, hkv):
    rng = np.random.default_rng(s + t)
    b, h, dh, kc = 2, 4, 16, 16
    q = rng.standard_normal((b, h, s, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, t, dh)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((b, h, s, dh)).astype(np.float32)

    def jax_loss(q, k, v):
        rep = lambda x: jax_repeat_kv(x.transpose(0, 2, 1, 3), h)  # (B, Hkv, T, Dh) -> (B, H, T, Dh)
        out = jax_chunked_attention(q, rep(k), rep(v), causal=causal, kv_chunk=kc)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = chunked_attention(tq, tk, tv, causal=causal, kv_chunk=kc)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name}")


def test_chunked_ce_loss_matches_reference():
    rng = np.random.default_rng(5)
    b, s, d, vocab, chunk = 2, 48, 32, 300, 16
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, vocab)) * 0.2).astype(np.float32)
    y = rng.integers(0, vocab, (b, s)).astype(np.int32)
    jv, (jgh, jgw) = jax.value_and_grad(
        lambda h, w: jax_chunked_ce_loss(h, w, jnp.asarray(y), chunk), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    loss = chunked_ce_loss(th, tw, torch.from_numpy(y), chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="multiple"):
        chunked_ce_loss(th[:, :40], tw, torch.from_numpy(y[:, :40]), chunk)


def _port_state(jstate, cfg) -> TrainState:
    """The reference's TrainState on the port: masters, m and v carried across."""
    opt = jstate.opt_state
    return TrainState(
        params=params_from_reference(_np_tree(jstate.params), cfg, "cpu").requires_grad_(),
        opt_state={"m": params_from_reference(_np_tree(opt["m"]), cfg, "cpu"),
                   "v": params_from_reference(_np_tree(opt["v"]), cfg, "cpu"),
                   "count": torch.tensor(int(opt["count"]), dtype=torch.int32)},
        step=torch.tensor(int(jstate.step), dtype=torch.int32))


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("nmb", [1, 2])
def test_train_step_matches_reference(arch, nmb):
    cfg, jm, _ = _reference(arch)
    jopt = JaxAdamWConfig(lr=jax_warmup_cosine(1e-3, 2, 10))
    opt = AdamWConfig(lr=warmup_cosine(1e-3, 2, 10))
    jstate = jax_init_train_state(jm, jopt, jax.random.PRNGKey(0))
    state = _port_state(jstate, cfg)
    batch = _batch(cfg, 4, 32, seed=1)
    jstate, jmet = jax.jit(jax_make_train_step(jm, jopt, num_microbatches=nmb))(jstate, _jx(batch))
    state, met = make_train_step(Model(cfg, "cpu"), opt, num_microbatches=nmb)(state, _pt(batch))
    assert sorted(met) == sorted(jmet)  # loss, grad_norm, lr (+ ce, aux at one microbatch)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert int(state.step) == 1 and int(state.opt_state["count"]) == 1
    for tree, jtree in ((state.params, jstate.params), (state.opt_state["m"], jstate.opt_state["m"]),
                        (state.opt_state["v"], jstate.opt_state["v"])):
        want = params_from_reference(_np_tree(jtree), cfg, "cpu")
        for (name, got), (_, w) in zip(tree.named_parameters(), want.named_parameters()):
            np.testing.assert_allclose(got.detach().numpy(), w.numpy(), **STEP_TOL,
                                       err_msg=name)


def test_grad_accumulation_equals_full_batch():
    """nmb=4 gives nmb=1's step (linearity of gradients), as the reference's test."""
    cfg = get_config("granite-3-8b", reduced=True)
    model = Model(cfg, "cpu")
    opt = AdamWConfig(lr=1e-3, clip_norm=None)
    batch = _pt(_batch(cfg, 8, 32, seed=2))
    s1, m1 = make_train_step(model, opt, num_microbatches=1)(init_train_state(model, opt, 0), batch)
    s4, m4 = make_train_step(model, opt, num_microbatches=4)(init_train_state(model, opt, 0), batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for a, b in zip(s1.params.parameters(), s4.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), **STEP_TOL)


def test_bf16_masters_accumulate_in_float32():
    """Masters not of ``accum_dtype`` accumulate in a float32 tree: the step
    equals a float32 sum of the microbatches' bf16 gradients."""
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True), param_dtype="bfloat16")
    model = Model(cfg, "cpu")
    opt = AdamWConfig(lr=1e-3, clip_norm=None, state_dtype="float32")
    batch = _pt(_batch(cfg, 4, 32, seed=3))
    seen = []
    step = make_train_step(model, opt, num_microbatches=2,
                           grad_transform=lambda g: seen.append(g) or g)
    state, met = step(init_train_state(model, opt, 0), batch)
    leaves = list(state.params.parameters())
    assert all(p.dtype == torch.bfloat16 for p in leaves)
    assert state.opt_state["m"].embed.dtype == torch.float32
    grads = {n: g.data for n, g in Params(seen[0]).named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    ref = init_train_state(model, opt, 0).params
    want = {n: torch.zeros(p.shape) for n, p in ref.named_parameters()}
    for mb in range(2):
        for p in ref.parameters():
            p.grad = None
        loss, _ = model.loss_fn(ref, {k: v[mb] for k, v in split_microbatches(batch, 2).items()})
        loss.backward()
        for n, p in ref.named_parameters():
            want[n] += p.grad.float()
    for n in want:
        torch.testing.assert_close(grads[n], want[n] * 0.5, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen3-moe-30b-a3b", "mamba2-2.7b"])
def test_loss_decreases(arch):
    """A few hundred tokens memorised: the loss must drop substantially
    (the reference's test, tests/test_runtime.py:107-123)."""
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, "cpu")
    opt = AdamWConfig(lr=3e-3)
    state = init_train_state(model, opt, 0)
    step = make_train_step(model, opt, num_microbatches=2)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(2, cfg.vocab_size, (4, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    losses = []
    for _ in range(15):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8, (arch, losses[0], losses[-1])


def test_split_microbatches_shapes():
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int32),
             "positions3": torch.arange(3 * 8 * 16).reshape(3, 8, 16)}
    mbs = split_microbatches(batch, 4)
    assert mbs["tokens"].shape == (4, 2, 16)
    assert mbs["positions3"].shape == (4, 3, 2, 16)
    assert torch.equal(mbs["positions3"][1], batch["positions3"][:, 2:4])
    with pytest.raises(ValueError, match="microbatches"):
        split_microbatches(batch, 3)


def test_train_path_runs_no_kernel(monkeypatch):
    """The train path never reaches the forward-only kernels or the expert
    twin: each raises if called."""
    def refuse(*args, **kwargs):
        raise AssertionError("a serving kernel ran on the train path")

    monkeypatch.setattr(port_tf, "flash_attention", refuse)
    monkeypatch.setattr(port_moe, "moe_mlp", refuse)
    monkeypatch.setattr("repro_torch.kernels.ref.moe_mlp_ref", refuse)
    for arch in ("qwen3-moe-30b-a3b", "jamba-1.5-large-398b", "seamless-m4t-medium"):
        cfg = get_config(arch, reduced=True)
        model = Model(cfg, "cpu")
        loss, _ = model.loss_fn(model.init(0).requires_grad_(), _pt(_batch(cfg, 2, 16)))
        loss.backward()


def test_kernel_wrappers_refuse_gradients():
    """The forward-only wrappers raise when autograd would record through
    them, on the CPU as on the card; under no_grad they run."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 8, 16), generator=g) for _ in range(3))
    x = torch.randn((2, 4, 16), generator=g)
    wg, wu = (torch.randn((2, 16, 8), generator=g) for _ in range(2))
    wd = torch.randn((2, 8, 16), generator=g)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="forward only"):
        moe_mlp(x, wg, wu, wd.requires_grad_())
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape
        assert moe_mlp(x, wg, wu, wd).shape == x.shape
