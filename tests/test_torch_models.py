"""The port's serving models on the CPU against the JAX package's.

Reduced ``qwen3-moe-30b-a3b`` (MoE, qk_norm, GQA), ``qwen2-moe-a2.7b``
(shared experts) and ``granite-3-8b`` (dense, tied embeddings) run with the
JAX package's own initialised weights, carried across by
``params_from_reference``; the JAX side runs on the CPU as its own tests run
it.  Reduced configs compute in float32.  Tolerances: 1e-4 on logits (and
1e-5 on MoE outputs, 1e-6 on the aux loss): float32 sums taken in another
order by XLA and by PyTorch over at most two layers of width 64 differ by a
few 1e-6; a real fault (a wrong mask, norm order, RoPE half or dropped pair)
moves them by 1e-2 or more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (before repro.kernels: import cycle)
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.layers import apply_rope as jax_apply_rope  # noqa: E402
from repro.models.layers import decode_attention as jax_decode_attention  # noqa: E402
from repro.models.moe import moe_ffn as jax_moe_ffn  # noqa: E402
from repro.models.transformer import moe_capacity as jax_moe_capacity  # noqa: E402
from repro_torch.configs import get_config, param_count  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.launch.serve import run_serving  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.models.layers import apply_rope, decode_attention  # noqa: E402
from repro_torch.models.moe import expert_positions, moe_ffn, route  # noqa: E402
from repro_torch.models.transformer import cast_params_for_compute, moe_capacity  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "granite-3-8b"]
MOE_ARCHS = ARCHS[:2]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
_CACHE: dict = {}


def _pair(arch):
    """(port cfg, JAX model, JAX params, port params) for a reduced arch, built once."""
    if arch not in _CACHE:
        cfg = get_config(arch, reduced=True)
        jm = JaxModel(jax_get_config(arch, reduced=True))
        jp = jm.init(jax.random.PRNGKey(0))
        port = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
        _CACHE[arch] = (cfg, jm, jp, port)
    return _CACHE[arch]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, (b, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a)).long()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_carries_every_weight(arch):
    cfg, _, jp, port = _pair(arch)
    assert sum(p.numel() for p in port.parameters()) == param_count(cfg)["total"]
    want = np.asarray(jp["blocks"]["attn"]["wq"][1])
    assert np.array_equal(port.blocks[1].attn.wq.numpy(), want)


def test_cast_params_for_compute_keeps_routing_f32():
    cfg, _, _, port = _pair("qwen2-moe-a2.7b")
    cast = cast_params_for_compute(port, dataclasses.replace(cfg, compute_dtype="bfloat16"))
    moe = cast.blocks[0].ffn.moe
    assert moe.w_gate.dtype == torch.bfloat16 and cast.embed.dtype == torch.bfloat16
    assert moe.router.dtype == torch.float32 and moe.shared.gate.dtype == torch.float32
    assert moe.router.data_ptr() == port.blocks[0].ffn.moe.router.data_ptr()  # shared


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacity_matches_reference(arch):
    cfg = get_config(arch)
    for n_tokens in (1, 4, 24, 1000, 8192, 65536):
        assert moe_capacity(cfg, n_tokens) == jax_moe_capacity(cfg, n_tokens)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity", [None, 4], ids=["no_drop", "drops"])
def test_moe_ffn_matches_reference(arch, capacity):
    cfg, _, jp, port = _pair(arch)
    e = cfg.moe
    t = 24
    cap = capacity or t  # t: every pair fits, since a token's k experts differ
    x = np.random.default_rng(1).standard_normal((t, cfg.d_model)).astype(np.float32)
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"]["ffn"]["moe"])
    pparams = port.blocks[0].ffn.moe
    # Routing ids first, so that a near-tie shows as a tie, not a numeric fault.
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jparams["router"], axis=-1)
    _, jids = jax.lax.top_k(jprobs, e.top_k)
    _, _, ids = route(torch.from_numpy(x), pparams["router"], e.top_k)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    per_expert = np.bincount(ids.numpy().reshape(-1), minlength=e.n_experts)
    assert (per_expert.max() > cap) == (capacity is not None)  # pairs dropped iff asked
    want_y, want_aux = jax_moe_ffn(jnp.asarray(x), jparams, e.n_experts, e.top_k, cap)
    y, aux = moe_ffn(torch.from_numpy(x), pparams, e.n_experts, e.top_k, cap)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_experts,n_pairs", [(8, 48), (128, 4096), (3, 1)])
def test_expert_positions_equal_the_one_hot_running_count(n_experts, n_pairs):
    ids = np.random.default_rng(n_pairs).integers(0, n_experts, n_pairs)
    onehot = jax.nn.one_hot(jnp.asarray(ids), n_experts, dtype=jnp.int32)
    want = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1  # moe.py:257-258, ns = 1
    got = expert_positions(torch.from_numpy(ids), n_experts)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_expert_perm_moves_weights_with_ids():
    cfg, _, _, port = _pair("qwen3-moe-30b-a3b")
    e = cfg.moe
    p = port.blocks[0].ffn.moe
    perm = torch.randperm(e.n_experts, generator=torch.Generator().manual_seed(0))
    inv = torch.argsort(perm)
    # Slot perm[i] holds logical expert i's weights.
    moved = {"router": p.router, "w_gate": p.w_gate[inv], "w_up": p.w_up[inv],
             "w_down": p.w_down[inv]}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((16, cfg.d_model)))
    x = x.float()
    want, _ = moe_ffn(x, p, e.n_experts, e.top_k, 64)
    got, _ = moe_ffn(x, moved, e.n_experts, e.top_k, 64, expert_perm=perm)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), rtol=1e-5, atol=1e-5)
    q = rng.standard_normal((2, 4, 1, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32) for _ in range(2))
    for p in (7, np.array([3, 12], np.int32)):
        want = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(p))
        got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                               p if isinstance(p, int) else torch.from_numpy(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    cfg, jm, jp, port = _pair(arch)
    b, s, gen = 2, 24, 3
    toks = _tokens(cfg, b, s)
    jlogits, jcache = jax.jit(lambda p, x: jm.prefill(p, x, s + gen))(
        jp, {"tokens": jnp.asarray(toks)})
    model = Model(cfg, device="cpu")
    logits, cache = model.prefill(port, {"tokens": _t(toks)}, s + gen)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=1e-5, atol=1e-5)
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, {"tokens": t}, pos))
    for i in range(gen):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None]  # the JAX run's tokens, both sides
        jlogits, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(s + i))
        logits, cache = model.decode_step(port, cache, {"tokens": _t(tok)}, s + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Prefill(s) then decode token s equals prefill(s+1)'s last logits (the
    reference's own check, tests/test_models.py, with its tolerance; MoE gets
    a no-drop capacity factor there too)."""
    cfg = get_config(arch, reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    model = Model(cfg, device="cpu")
    params = model.init(2)
    b, s = 2, 16
    toks = _t(_tokens(cfg, b, s + 1, seed=2))
    full, _ = model.prefill(params, {"tokens": toks}, s + 1)
    _, cache = model.prefill(params, {"tokens": toks[:, :s]}, s + 1)
    step, _ = model.decode_step(params, cache, {"tokens": toks[:, s:]}, s)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serving_on_cpu(arch):
    cfg = get_config(arch, reduced=True)
    before = launch_counts()
    tokens, stats = run_serving(arch, batch=2, prompt_len=8, gen=4, device="cpu")
    assert tokens.shape == (2, 4) and tokens.dtype == torch.int32
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size
    assert stats["device"] == "cpu" and stats["prefill_s"] > 0 and stats["tok_per_s"] > 0
    assert stats["cast_s"] > 0  # the compute copies, cast before the prompts arrive
    assert launch_counts() == before  # CPU tensors: the twins, no kernel


@pytest.mark.parametrize("arch", ARCHS)
def test_compute_copies_are_cast_once_and_never_stale(arch):
    """Steps given the compute copies cast nothing more; steps given the
    masters cast what the masters hold now, and both give the same logits."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), compute_dtype="bfloat16")
    model = Model(cfg, device="cpu")
    masters = model.init(3)
    compute = model.compute_params(masters)
    again = model.compute_params(compute)
    assert [w.data_ptr() for w in again.parameters()] == [
        w.data_ptr() for w in compute.parameters()]
    toks = {"tokens": _t(_tokens(cfg, 2, 8, seed=3))}
    got = model.prefill(compute, toks, 9)[0]
    assert torch.equal(got, model.prefill(masters, toks, 9)[0])
    masters.embed.mul_(2.0)  # weights updated in place: no copy of the old ones is served
    moved = model.prefill(masters, toks, 9)[0]
    assert not torch.equal(moved, got)
    assert torch.equal(moved, model.prefill(model.compute_params(masters), toks, 9)[0])


@pytest.mark.parametrize("arch,what", [
    ("mamba2-2.7b", "ssm"), ("jamba-1.5-large-398b", "hybrid"),
    ("seamless-m4t-medium", "encdec"), ("qwen2-vl-2b", "M-RoPE"),
])
def test_unported_configs_raise_naming_them(arch, what):
    with pytest.raises(NotImplementedError, match=what):
        Model(get_config(arch, reduced=True), device="cpu")
