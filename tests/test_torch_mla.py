"""Moonlight-16B-A3B (DeepSeek-V3) in the port, on the CPU: latent attention,
sigmoid routing with a correction bias, ungated shared experts and a dense
first layer, against the plain reference ``portbench/reference/deepseek_v3.py``.

At reduced widths in float32, three training steps of the benchmark's
``train.Job`` (the program's ``Model`` and ``make_train_step``) agree with
the reference within the tolerances of the qwen3-moe cell's own test; each
piece of the architecture, dropped from the program, makes them disagree.
``chunked_attention`` takes values of another width than q and k, and
keeps its bits where the widths are equal.
"""
import ast
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's package, beside src/
    sys.path.insert(0, str(ROOT))

from portbench.entries import train  # noqa: E402
from portbench.reference import deepseek_v3  # noqa: E402
from portbench.tests.test_portbench_deepseek_v3 import (  # noqa: E402
    moonlight_conf,
    moonlight_mix,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model, mla  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import _kv_step, chunked_attention  # noqa: E402
from repro_torch.runtime import make_sharding_rules, param_specs, spans  # noqa: E402

ARCH = "moonlight-16b-a3b"
SEED = 2**35 + 11
TOLERANCES = {"loss_err": 1e-5, "grad_err": 1e-4, "grad_median": 1e-5, "change_err": 1e-3}


def _steps(conf=None):
    conf = conf or moonlight_conf()
    mix = moonlight_mix()
    job = train.Job(conf, mix, "cpu")
    job.load(SEED)
    got = job.checked(SEED)
    return train.compare(got, train.reference(conf, mix, SEED, "cpu"))


def test_three_train_steps_agree_with_the_reference():
    readings = _steps()
    for name, tol in TOLERANCES.items():
        assert readings[name] < tol, readings


def _moe_override(**kw) -> dict:
    conf = moonlight_conf()
    fields = deepseek_v3.port_fields(conf)["moe"]
    conf["port"] = dict(conf["port"], moe=dict(fields, **kw))
    return conf


def _plant(monkeypatch, piece: str):
    """Drop ``piece`` from the program (or, for the shared experts' missing
    gate, put one in); returns the configuration to run."""
    if piece == "routed_scale":
        return _moe_override(routed_scale=1.0)
    if piece == "sigmoid":
        return _moe_override(scoring="softmax")
    if piece == "bias":
        choice = moe_mod._sigmoid_choice
        monkeypatch.setattr(moe_mod, "_sigmoid_choice", lambda s, b, k: choice(s, None, k))
    elif piece == "shared_gate":
        shared = moe_mod._shared_experts
        monkeypatch.setattr(moe_mod, "_shared_experts",
                            lambda x, *ws: shared(x, *ws) * torch.sigmoid(torch.zeros(())))
    elif piece == "dense_layer":
        monkeypatch.setattr(tf, "mlp_block", lambda p, cfg, h: h)
    elif piece == "rope_order":
        monkeypatch.setattr(mla, "deinterleave", lambda x: x)
    return moonlight_conf()


@pytest.mark.parametrize("piece", ["bias", "routed_scale", "sigmoid", "shared_gate", "dense_layer",
                                   "rope_order"])
def test_each_piece_dropped_fails_against_the_reference(monkeypatch, piece):
    readings = _steps(_plant(monkeypatch, piece))
    failed = [name for name, tol in TOLERANCES.items() if readings[name] >= 10 * tol]
    assert failed, readings


def _naive(q, k, v, causal):
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool).tril().logical_not(),
                          float("-inf"))
    return torch.softmax(s, dim=-1) @ v


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_takes_narrower_values(causal):
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(2, 4, 37, 24, generator=g) for _ in range(2))
    v = torch.randn(2, 4, 37, 16, generator=g)
    got = chunked_attention(q, k, v, causal=causal, kv_chunk=16)
    assert got.shape == (2, 4, 37, 16)
    torch.testing.assert_close(got, _naive(q, k, v, causal), rtol=0, atol=1e-5)


def _before(q, k, v, causal, kv_chunk):
    """``chunked_attention`` as it was before values could be narrower."""
    b, h, s, dh = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kv_chunk = min(kv_chunk, t)
    pad = (-t) % kv_chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qf = q.float().reshape(b, hkv, h // hkv, s, dh)
    m = torch.full(qf.shape[:-1], float("-inf"))
    l = torch.zeros(qf.shape[:-1])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, t + pad, kv_chunk):
        m, l, acc = _kv_step(qf, k[:, :, k0:k0 + kv_chunk], v[:, :, k0:k0 + kv_chunk], m, l, acc,
                             k0, t, causal, bool(pad))
    return (acc / l.clamp(min=1e-20)[..., None]).reshape(b, h, s, dh).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_attention_keeps_its_bits_at_equal_widths(dtype):
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 8, 40, 16, generator=g).to(dtype)
    k, v = (torch.randn(2, 2, 40, 16, generator=g).to(dtype) for _ in range(2))
    assert torch.equal(chunked_attention(q, k, v, causal=True, kv_chunk=16),
                       _before(q, k, v, True, 16))


def test_the_stacked_tree_round_trips_and_every_leaf_has_a_spec():
    params = Model(get_config(ARCH, reduced=True), "cpu").init(0)
    back = params.map_stacked(lambda path, index, w: w)
    assert [n for n, _ in back.named_parameters()] == [n for n, _ in params.named_parameters()]
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(), params.parameters()))
    ref = params.reference_tree()
    assert ref["blocks"]["ffn"]["w_gate"].shape == (1, 64, 96)  # the dense layer 0
    assert ref["blocks"]["ffn"]["moe"]["w_gate"].shape == (3, 8, 64, 32)  # layers 1, 2 in place
    assert torch.equal(ref["blocks"]["ffn"]["moe"]["w_gate"][2], params.blocks[2].ffn.moe.w_gate)

    class Mesh:
        shape = {"data": 2, "model": 2}
        axis_names = ("data", "model")

    paths = {path for path, _, _ in params.stacked_parts()}
    for mode in ("train", "serve"):
        specs = param_specs(params, make_sharding_rules(Mesh(), mode))
        for path in paths:
            spec, leaf = specs, ref
            for k in path:
                spec, leaf = spec[k], leaf[k]
            assert isinstance(spec, tuple) and len(spec) == leaf.dim(), path
        assert len(_spec_leaves(specs)) == len(paths)
        attn = specs["blocks"]["attn"]
        assert attn["wkv_b"][2] == "model" and attn["wkv_a"][2] is None


def _spec_leaves(t) -> list:
    return [x for v in t.values() for x in _spec_leaves(v)] if isinstance(t, dict) else [t]


def test_registration_loads_with_the_package_alone():
    code = ("from repro_torch.configs import get_config\n"
            "c = get_config('moonlight-16b-a3b')\n"
            "r = get_config('moonlight-16b-a3b', reduced=True)\n"
            "print(c.mla.kv_lora_rank, c.moe.routed_scale, c.ffn_kinds()[:2], r.n_layers)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["512", "2.446", "['mlp',", "'moe']", "3"]


def test_serving_mla_raises_naming_the_latent_cache():
    model = Model(get_config(ARCH, reduced=True), "cpu")
    params = model.init(0)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    for call in (lambda: model.prefill(params, {"tokens": tokens}, 8),
                 lambda: model.init_cache(1, 8),
                 lambda: model.decode_step(params, {}, {"tokens": tokens[:, :1]}, 0)):
        with pytest.raises(NotImplementedError, match="latent cache"):
            call()


def test_the_bias_stays_float32_and_gets_no_gradient():
    cfg = get_config(ARCH, reduced=True)
    import dataclasses

    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model = Model(cfg, "cpu")
    params = model.init(0).requires_grad_()
    with torch.no_grad():
        for blk in params.blocks[1:]:
            blk.ffn.moe.router_bias.normal_()
    copies = model.compute_params(params)
    assert copies.blocks[1].ffn.moe.router_bias.dtype == torch.float32
    assert copies.blocks[1].attn.wq.dtype == torch.bfloat16
    tokens = torch.randint(2, 512, (2, 16), generator=torch.Generator().manual_seed(1))
    loss, _ = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
    loss.backward()
    assert params.blocks[1].ffn.moe.router_bias.grad is None
    assert params.blocks[1].ffn.moe.router.grad.abs().sum() > 0


def test_sequence_balance_loss_by_its_formula():
    g = torch.Generator().manual_seed(2)
    scores = torch.rand(2 * 6, 4, generator=g)
    ids = torch.topk(scores, 2, dim=-1).indices
    got = moe_mod.sequence_balance_loss(scores, ids, 4, rows=2)
    want = 0.0
    for r in range(2):
        s, i = scores[r * 6:(r + 1) * 6], ids[r * 6:(r + 1) * 6]
        f = torch.bincount(i.reshape(-1), minlength=4).float() * 4 / (2 * 6)
        want += float((f * (s / s.sum(-1, keepdim=True)).mean(0)).sum()) / 2
    assert abs(float(got) - want) < 1e-6
    flat = torch.ones(8, 4)
    uniform = torch.tensor([[0, 1], [2, 3]] * 4)
    assert abs(float(moe_mod.sequence_balance_loss(flat, uniform, 4, rows=1)) - 1.0) < 1e-6


def test_spans_and_the_bias_counter(monkeypatch):
    """The step's latent-attention and shared-expert spans in every phase,
    and the correction bias changing the experts of some tokens in each
    routing call: ``_sigmoid_choice`` with the bias against without it."""
    cfg = get_config(ARCH, reduced=True)
    model = Model(cfg, "cpu")
    params = model.init(0).requires_grad_()
    with torch.no_grad():
        for blk in params.blocks[1:]:
            blk.ffn.moe.router_bias.normal_(std=0.5)
    tokens = torch.randint(2, 512, (2, 16), generator=torch.Generator().manual_seed(4))
    moved = []
    choice = moe_mod._sigmoid_choice

    def recording(scores, bias, top_k):
        ids = choice(scores, bias, top_k)
        plain = choice(scores, None, top_k)
        moved.append(int((ids.sort(-1).values != plain.sort(-1).values).any(-1).sum()))
        return ids

    monkeypatch.setattr(moe_mod, "_sigmoid_choice", recording)
    spans.clear()
    spans.enable()
    try:
        with spans.step("cpu"):
            loss, _ = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
            loss.backward()
    finally:
        spans.disable()
    st = spans.steps()[-1]
    names = {(s["name"], s["phase"]) for s in st["spans"]}
    for name in ("repro_torch.mla.project", "repro_torch.moe.shared"):
        assert {(name, "forward"), (name, "recompute"), (name, "backward")} <= names
    assert len(moved) == 2 * 2  # two MoE layers, each in the forward pass and its recompute
    assert all(0 < m <= 2 * 16 for m in moved), moved


def test_the_reference_imports_neither_jax_nor_the_program():
    tree = ast.parse((ROOT / "portbench" / "reference" / "deepseek_v3.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    assert not names & {"jax", "jaxlib", "repro", "repro_torch"}, names
