"""The hybrid, M-RoPE and encoder-decoder pieces of the port against the JAX package's.

``apply_mrope`` with three different position streams and uneven sections
(with equal streams M-RoPE is plain RoPE, and a wrong section split would
not show); the served jamba cut (layers 0-4 of the published stack as one
period of five) at reduced widths; the encoder-decoder with an encoder input
longer and shorter than the prompt, through prefill and three decode steps; the
cross-attention's read-only decode; the caches' layouts; every registered
architecture building on the CPU; the prefill batches' stubs; and the
record of the experts each MoE layer routed to.  The JAX side runs on the CPU
as its own tests run it.  Reduced configs compute in float32: 1e-4 on
logits, as ``tests/test_torch_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (before repro.kernels: import cycle)
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import list_archs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import apply_mrope as jax_apply_mrope  # noqa: E402
from repro_torch.configs import get_config, param_count  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.launch.serve import prefill_inputs, serve_config  # noqa: E402
from repro_torch.models import Model, params_from_reference  # noqa: E402
from repro_torch.models.moe import init_moe_params, moe_ffn, recorded_routing, route  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import apply_mrope  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# Layers 0-4 of jamba's published stack as one period of five: four Mamba
# layers, then attention at its published offset 4.
JAMBA_CUT = dict(n_layers=5, attn_every=5, attn_offset=4)


def _both(cfg, jcfg, seed=0):
    """(JAX model, JAX params, the port's model, the same weights on the port)."""
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    port = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, Model(cfg, device="cpu"), port


def _run_both(cfg, jm, jp, model, port, batch, gen=3):
    """Prefill ``batch`` (numpy) and ``gen`` decode steps fed the JAX run's
    tokens on both sides; the logits must agree at every step.  Returns both
    final caches."""
    s = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[1]
    jlogits, jcache = jax.jit(lambda p, x: jm.prefill(p, x, s + gen))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, cache = model.prefill(
        port, {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
               for k, v in batch.items()}, s + gen)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
    step = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, {"tokens": t}, pos))
    for i in range(gen):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None]
        jlogits, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(s + i))
        logits, cache = model.decode_step(port, cache, {"tokens": torch.tensor(tok).long()},
                                          s + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL,
                                   err_msg=f"decode step {i}")
    return cache, jcache


def _streams(b, s):
    """Three different position streams: t constant, h = i // 8, w = i % 8."""
    i = np.arange(s, dtype=np.int32)
    return np.broadcast_to(np.stack([np.zeros_like(i), i // 8, i % 8])[:, None, :],
                           (3, b, s)).copy()


@pytest.mark.parametrize("sections,dh", [((2, 3, 3), 16), ((16, 24, 24), 128), ((5, 1, 2), 16)])
def test_apply_mrope_matches_reference(sections, dh):
    """Positions below 128, the range of a vision grid's h and w streams:
    both packages round the float32 rotary table by a few ulp of the angle,
    so far positions differ by |pos| * 1e-8 whatever the section split (a
    wrong split moves outputs by O(1))."""
    rng = np.random.default_rng(dh + sections[0])
    x = rng.standard_normal((2, 3, 20, dh)).astype(np.float32)
    p3 = rng.integers(0, 128, (3, 2, 20)).astype(np.int32)  # every stream its own
    want = jax_apply_mrope(jnp.asarray(x), jnp.asarray(p3), sections, 1e6)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), sections, 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), (1, 1, 1), 1e6)


def test_qwen2_vl_three_streams_match_reference():
    """Reduced qwen2-vl behind the vision stub, with three different position
    streams: prefill and decode (whose streams all sit at ``pos``)."""
    arch = "qwen2-vl-2b"
    cfg = get_config(arch, reduced=True)
    jm, jp, model, port = _both(cfg, jax_get_config(arch, reduced=True))
    b, s = 2, 24
    embeds = np.random.default_rng(4).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    _run_both(cfg, jm, jp, model, port, {"embeds": embeds, "positions3": _streams(b, s)})


def test_jamba_served_cut_matches_reference():
    """Layers 0-4 of the published stack as one period of five, at reduced
    widths: Mamba x4 then attention, FFNs MLP, MoE, MLP, MoE, MLP."""
    arch = "jamba-1.5-large-398b"
    cfg = dataclasses.replace(get_config(arch, reduced=True), **JAMBA_CUT)
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **JAMBA_CUT)
    assert cfg.layer_kinds() == ["mamba"] * 4 + ["attn"]
    assert cfg.ffn_kinds() == ["mlp", "moe", "mlp", "moe", "mlp"]
    assert tf.period_layers(cfg) == [("mamba", 0, "mlp", 0), ("mamba", 1, "moe", 0),
                                     ("mamba", 2, "mlp", 1), ("mamba", 3, "moe", 1),
                                     ("attn", 0, "mlp", 2)]
    jm, jp, model, port = _both(cfg, jcfg, seed=1)
    (period,) = port.periods
    assert (len(period.mamba), len(period.moe), len(period.mlp)) == (4, 2, 3)
    assert sum(p.numel() for p in port.parameters()) == param_count(cfg)["total"]
    b, s = 2, 40  # crosses the reduced SSD chunk of 16
    toks = np.random.default_rng(5).integers(2, cfg.vocab_size, (b, s)).astype(np.int32)
    cache, jcache = _run_both(cfg, jm, jp, model, port, {"tokens": toks})
    for name in ("k", "v", "conv", "ssm"):  # the in-place updates equal the reference's
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("enc_len", [37, 9])
def test_encdec_encoder_length_differs_from_prompt(enc_len):
    """Reduced seamless with an encoder input of ``enc_len`` frames against a
    decoder prompt of 24 tokens: the cross-attention is non-causal over
    ``T != S`` keys; prefill and three decode steps."""
    arch = "seamless-m4t-medium"
    cfg = get_config(arch, reduced=True)
    jm, jp, model, port = _both(cfg, jax_get_config(arch, reduced=True), seed=2)
    rng = np.random.default_rng(enc_len)
    b, s = 2, 24
    batch = {"tokens": rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32),
             "enc_embeds": rng.standard_normal((b, enc_len, cfg.d_model)).astype(np.float32)}
    cache, jcache = _run_both(cfg, jm, jp, model, port, batch)
    assert cache["cross_k"].shape == (cfg.n_layers, b, enc_len, cfg.n_kv_heads, cfg.d_head)
    for name in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_cross_attention_decode_reads_the_cache_only():
    """``attn_block_decode(update_cache=False)`` attends every cached key,
    writes nothing, and equals the reference's output."""
    arch = "seamless-m4t-medium"
    cfg = get_config(arch, reduced=True)
    _, jp, _, port = _both(cfg, jax_get_config(arch, reduced=True), seed=3)
    rng = np.random.default_rng(6)
    b, t = 2, 11
    h = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, t, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
              for _ in range(2))
    jcross = jax.tree.map(lambda a: a[0], jp["blocks"]["cross"])
    want, _, _ = jtf.attn_block_decode(jcross, cfg, jnp.asarray(h), jnp.asarray(kc),
                                       jnp.asarray(vc), 5, update_cache=False)
    k_cache, v_cache = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, k_out, v_out = tf.attn_block_decode(port.blocks[0].cross, cfg, torch.from_numpy(h),
                                             k_cache, v_cache, 5, update_cache=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.array_equal(k_out.numpy(), kc) and np.array_equal(v_out.numpy(), vc)
    # With update_cache the same call writes position 5 and attends keys 0..5.
    got, k_out, _ = tf.attn_block_decode(port.blocks[0].cross, cfg, torch.from_numpy(h),
                                         k_cache, v_cache, 5)
    assert not np.array_equal(k_out[:, 5].numpy(), kc[:, 5])
    assert np.array_equal(k_out[:, 6:].numpy(), kc[:, 6:])


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "seamless-m4t-medium"])
def test_init_cache_matches_reference_layout(arch):
    cfg = get_config(arch, reduced=True)
    want = jtf.init_cache(jax_get_config(arch, reduced=True), 3, 20, enc_len=7)
    got = Model(cfg, device="cpu").init_cache(3, 20, enc_len=7)
    assert sorted(got) == sorted(want)
    for name, a in got.items():
        assert a.shape == want[name].shape, name
        assert str(a.dtype).removeprefix("torch.") == str(want[name].dtype), name
        assert not a.any()


@pytest.mark.parametrize("arch", list_archs())
def test_every_registered_arch_builds_on_the_cpu(arch):
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    jshapes = jax.eval_shape(JaxModel(jax_get_config(arch, reduced=True)).init,
                             jax.random.PRNGKey(0))
    assert sum(p.numel() for p in params.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jshapes))


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium"])
def test_serve_config_front_end_stubs(arch):
    """The reference's stubs: seeded normal ``embeds`` in place of the
    prompt's tokens; M-RoPE's ``positions3 = arange(S)`` in all three
    streams; seamless's ``enc_embeds`` equal to its ``embeds`` (one key in
    the reference), beside the tokens."""
    cfg = get_config(arch, reduced=True)
    before = launch_counts()
    tokens, _, state = serve_config(cfg, 2, 6, 3, seed=4, device="cpu")
    inputs = state["inputs"]
    assert tuple(tokens.shape) == (2, 3) and launch_counts() == before
    assert inputs["embeds"].shape == (2, 6, cfg.d_model)
    assert inputs["embeds"].dtype == torch.float32
    if cfg.mrope:
        assert sorted(inputs) == ["embeds", "positions3"]
        assert torch.equal(inputs["positions3"], torch.arange(6).expand(3, 2, 6).int())
    else:
        assert sorted(inputs) == ["embeds", "enc_embeds", "tokens"]
        assert inputs["enc_embeds"] is inputs["embeds"]
        assert torch.equal(inputs["tokens"], state["prompt"])
    again = serve_config(cfg, 2, 6, 3, seed=4, device="cpu")[2]["inputs"]
    assert torch.equal(again["embeds"], inputs["embeds"])  # drawn from the seed


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium", "granite-3-8b"])
def test_prefill_inputs_take_streams_and_an_encoder_length(arch):
    """``prefill_inputs`` given M-RoPE streams and an encoder length, as the
    card checks build their batches: qwen2-vl's ``(3, S)`` streams broadcast
    over the batch in int32; seamless's encoder input of its own length
    beside the decoder's tokens (no ``embeds``, so the decoder reads the
    tokens); a config with neither ignores both."""
    cfg = get_config(arch, reduced=True)
    prompt = torch.arange(12).view(2, 6) + 2
    i = torch.arange(6)
    streams = torch.stack([0 * i, i // 2, i % 2])
    inputs = prefill_inputs(cfg, prompt, np.random.default_rng(0), positions3=streams,
                            enc_len=9)
    if cfg.mrope:
        assert sorted(inputs) == ["embeds", "positions3"]
        assert inputs["embeds"].shape == (2, 6, cfg.d_model)
        assert inputs["positions3"].dtype == torch.int32
        assert torch.equal(inputs["positions3"], streams[:, None, :].expand(3, 2, 6).int())
    elif cfg.family == "encdec":
        assert sorted(inputs) == ["enc_embeds", "tokens"]
        assert inputs["enc_embeds"].shape == (2, 9, cfg.d_model)
        assert inputs["tokens"] is prompt
    else:
        assert list(inputs) == ["tokens"] and inputs["tokens"] is prompt


def test_recorded_routing_holds_each_moe_ffn_routing():
    """While ``recorded_routing`` is active each ``moe_ffn`` call appends the
    expert ids it routed to (``route``'s, through ``expert_perm``); outside
    it nothing is kept.  Reduced jamba's prefill and one decode step record
    one routing per MoE layer each."""
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 8)))
    with recorded_routing() as routed:
        logits, cache = model.prefill(params, {"tokens": prompt}, 9)
        model.decode_step(params, cache, {"tokens": torch.argmax(logits, -1)[:, None]}, 8)
    n_moe, k = cfg.ffn_kinds().count("moe"), cfg.moe.top_k
    assert n_moe and [tuple(ids.shape) for ids in routed] == [(16, k)] * n_moe + [(2, k)] * n_moe

    e, d = cfg.moe.n_experts, cfg.d_model
    gen = torch.Generator().manual_seed(3)
    weights = init_moe_params(gen, d, cfg.moe, torch.float32)
    x = torch.randn((5, d), generator=gen)
    perm = torch.randperm(e, generator=gen)
    with recorded_routing() as routed:
        moe_ffn(x, weights, e, k, 8, expert_perm=perm)
    moe_ffn(x, weights, e, k, 8)
    assert len(routed) == 1
    assert torch.equal(routed[0], perm[route(x, weights["router"], k)[2]])
