"""The port's serving models on the CPU against the JAX package's.

Reduced ``qwen3-moe-30b-a3b`` (MoE, qk_norm, GQA), ``qwen2-moe-a2.7b``
(shared experts), ``granite-3-8b`` (dense, tied embeddings), ``mamba2-2.7b``
(attention-free SSM, conv and SSD states for a cache),
``jamba-1.5-large-398b`` (hybrid: attention, Mamba, MoE and MLP layers in
periods), ``qwen2-vl-2b`` (M-RoPE behind the vision stub's embeddings) and
``seamless-m4t-medium`` (encoder-decoder behind the audio stub) run with the
JAX package's own initialised weights, carried across by
``params_from_reference``, on batches built as the reference's
``tests/test_models.py`` builds them; the JAX side runs on the CPU as its
own tests run it.  Reduced configs compute in float32.  Tolerances: 1e-4 on logits (and
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

ARCHS = ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "granite-3-8b", "mamba2-2.7b",
         "jamba-1.5-large-398b", "qwen2-vl-2b", "seamless-m4t-medium"]
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


def _batch(cfg, b, s, seed=0):
    """numpy inputs as the reference's tests build them: a front end's
    ``embeds`` (and M-RoPE's ``positions3``, equal streams) in place of
    tokens; ``encdec`` adds ``enc_embeds`` and the decoder's tokens."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": _tokens(cfg, b, s, seed)}
    if cfg.frontend:
        batch = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
        if cfg.mrope:
            batch["positions3"] = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        batch["tokens"] = _tokens(cfg, b, s, seed)
    return batch


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pt(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_carries_every_weight(arch):
    cfg, _, jp, port = _pair(arch)
    n_ref = sum(a.size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in port.parameters()) == n_ref
    if cfg.family != "encdec":  # param_count leaves out enc_final_norm
        assert n_ref == param_count(cfg)["total"]
    # A leaf of a layer past the first, in each stacked subtree of the family.
    if cfg.family == "ssm":
        pairs = [(jp["blocks"]["mamba"]["in_proj"][1], port.blocks[1].mamba.in_proj)]
    elif cfg.family == "hybrid":
        pp = jp["periods"]
        pairs = [(pp["mamba"]["mamba"]["in_proj"][1, 2], port.periods[1].mamba[2].mamba.in_proj),
                 (pp["moe"]["moe"]["w_down"][1, 1], port.periods[1].moe[1].moe.w_down),
                 (pp["mlp"]["w_up"][1, 1], port.periods[1].mlp[1].w_up),
                 (pp["attn"]["wq"][1], port.periods[1].attn.wq)]
    elif cfg.family == "encdec":
        pairs = [(jp["encoder"]["ffn"]["w_up"][1], port.encoder[1].ffn.w_up),
                 (jp["blocks"]["cross"]["wk"][1], port.blocks[1].cross.wk),
                 (jp["enc_final_norm"], port.enc_final_norm)]
    else:
        pairs = [(jp["blocks"]["attn"]["wq"][1], port.blocks[1].attn.wq)]
    for want, got in pairs:
        assert np.array_equal(got.numpy(), np.asarray(want))


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


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("n_shards", [2, 4])
def test_moe_ffn_dispatch_shards_match_reference(arch, n_shards):
    """``n_dispatch_shards``: each shard's pairs fill their own slice of
    capacity / ns, so an expert that overflows one shard's slice drops pairs
    a single slab would keep.  The capacity here makes that happen (checked),
    so the output differs from ns = 1 (the control) and must equal the
    reference's at the same ns."""
    cfg, _, jp, port = _pair(arch)
    e = cfg.moe
    t, cap = 48, 16
    x = np.random.default_rng(3).standard_normal((t, cfg.d_model)).astype(np.float32)
    jparams = jax.tree.map(lambda a: a[0], jp["blocks"]["ffn"]["moe"])
    pparams = port.blocks[0].ffn.moe
    _, _, ids = route(torch.from_numpy(x), pparams["router"], e.top_k)
    per_shard = ids.reshape(n_shards, -1)
    worst = max(int(np.bincount(r.numpy(), minlength=e.n_experts).max()) for r in per_shard)
    assert worst > cap // n_shards  # a shard's slice overflows
    want, want_aux = jax_moe_ffn(jnp.asarray(x), jparams, e.n_experts, e.top_k, cap,
                                 n_dispatch_shards=n_shards)
    y, aux = moe_ffn(torch.from_numpy(x), pparams, e.n_experts, e.top_k, cap,
                     n_dispatch_shards=n_shards)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6, atol=1e-6)
    flat, _ = moe_ffn(torch.from_numpy(x), pparams, e.n_experts, e.top_k, cap)
    assert (flat - y).abs().max() > 1e-3  # the control: one slab keeps what a slice drops


@pytest.mark.parametrize("n_shards", [3, 5, 64])
def test_moe_ffn_dispatch_shards_fall_back_to_one(n_shards):
    """Shards that do not divide the tokens or capacity, or slices thinner
    than top_k, fall back to one slab, as the reference's."""
    cfg, _, jp, port = _pair("qwen3-moe-30b-a3b")
    e = cfg.moe
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((32, cfg.d_model))).float()
    p = port.blocks[0].ffn.moe
    flat, _ = moe_ffn(x, p, e.n_experts, e.top_k, 8)
    got, _ = moe_ffn(x, p, e.n_experts, e.top_k, 8, n_dispatch_shards=n_shards)
    torch.testing.assert_close(got, flat, rtol=0, atol=0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_abstract_params_are_storage_free(arch):
    cfg = get_config(arch)  # full width: nothing is drawn or allocated
    meta = Model(cfg, "meta").abstract_params()
    assert all(p.device.type == "meta" for p in meta.parameters())
    assert sum(p.numel() for p in meta.parameters()) == param_count(cfg)["total"]


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
    batch = _batch(cfg, b, s)
    jlogits, jcache = jax.jit(lambda p, x: jm.prefill(p, x, s + gen))(jp, _jx(batch))
    model = Model(cfg, device="cpu")
    logits, cache = model.prefill(port, _pt(batch), s + gen)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
    assert sorted(cache) == sorted(jcache)  # k/v, conv/ssm, or both; cross_k/cross_v
    for name in cache:
        assert cache[name].shape == jcache[name].shape
        assert str(cache[name].dtype).removeprefix("torch.") == str(jcache[name].dtype)
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
    a no-drop capacity factor there too).  A front end's step reads its
    embedding, and the encoder's input is the whole ``enc_embeds``."""
    cfg = get_config(arch, reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    model = Model(cfg, device="cpu")
    params = model.init(2)
    b, s = 2, 16
    whole = _pt(_batch(cfg, b, s + 1, seed=2))
    prefix = {k: v if k == "enc_embeds" else v[..., :s, :] if k == "embeds" else v[..., :s]
              for k, v in whole.items()}
    nxt = ({"embeds": whole["embeds"][:, s:]} if "embeds" in whole
           else {"tokens": whole["tokens"][:, s:]})
    full, _ = model.prefill(params, whole, s + 1)
    _, cache = model.prefill(params, prefix, s + 1)
    step, _ = model.decode_step(params, cache, nxt, s)
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
    toks = {"tokens": _t(_tokens(cfg, 2, 8, seed=3))}  # tokens read the embedding table
    if cfg.family == "encdec":
        toks["enc_embeds"] = _pt(_batch(cfg, 2, 8, seed=3))["enc_embeds"]
    got = model.prefill(compute, toks, 9)[0]
    assert torch.equal(got, model.prefill(masters, toks, 9)[0])
    masters.embed.mul_(2.0)  # weights updated in place: no copy of the old ones is served
    moved = model.prefill(masters, toks, 9)[0]
    assert not torch.equal(moved, got)
    assert torch.equal(moved, model.prefill(model.compute_params(masters), toks, 9)[0])


def test_unknown_family_raises():
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True), family="retnet")
    with pytest.raises(NotImplementedError, match="retnet"):
        Model(cfg, device="cpu")
