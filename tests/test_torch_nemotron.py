"""Nemotron-H (NVIDIA-Nemotron-3-Nano-30B-A3B) in the port, on the CPU: one
mixer a layer by the pattern, Mamba2 sized by its heads with the gated norm
per group, NoPE attention, and an MoE layer told which of the router's
experts it holds, against the plain reference ``portbench/reference/nemotron_h.py``.

The share test ties the expert share to the model: the parts of an MoE
layer's result that four disjoint shares of its experts give, with the
shared expert counted once, add up to the uncut reference's layer.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the benchmark's package, beside src/
    sys.path.insert(0, str(ROOT))

from portbench.reference import nemotron_h  # noqa: E402
from portbench.reference.common import REF  # noqa: E402
from portbench.tests.test_portbench_nemotron_h import nemotron_conf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models.layers import rms_norm, rms_norm_grouped  # noqa: E402
from repro_torch.models.moe import init_moe_params, moe_ffn  # noqa: E402
from repro_torch.models.transformer import moe_capacity  # noqa: E402
from repro_torch.runtime import spans  # noqa: E402

ARCH = "nemotron-3-nano-30b-a3b"


def test_registration_loads_with_the_package_alone():
    code = ("from repro_torch.configs import get_config\n"
            "c = get_config('nemotron-3-nano-30b-a3b')\n"
            "r = get_config('nemotron-3-nano-30b-a3b', reduced=True)\n"
            "print(c.ssm.d_inner(c.d_model), c.moe.n_held, c.layer_kinds().count('mamba'),\n"
            "      c.layer_kinds().count('moe'), c.layer_kinds().count('attn'), r.moe.n_held)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4096", "128", "23", "23", "6", "4"]


def test_the_mixer_is_sized_by_its_heads():
    cfg = get_config(ARCH)
    params = Model(cfg, "meta").abstract_params()
    mixer = params.blocks[0].mamba
    assert mixer.in_proj.shape == (2688, 2 * 4096 + 2 * 8 * 128 + 64)
    assert mixer.out_proj.shape == (4096, 2688) and mixer.norm_w.shape == (4096,)
    assert params.blocks[5].attn.wk.shape == (2688, 2 * 128)
    assert params.blocks[1].moe.w_up.shape == (128, 2688, 1856)
    assert "w_gate" not in params.blocks[1].moe and "gate" not in params.blocks[1].moe.shared
    assert params.blocks[1].moe.shared.w_up.shape == (2688, 3712)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_the_grouped_norm_differs_from_the_whole_width_norm_but_at_one_group(groups):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 16, generator=g) * torch.linspace(0.1, 4.0, 16)
    w = 1 + 0.1 * torch.randn(16, generator=g)
    got = rms_norm_grouped(x, w, groups, 1e-5)
    whole = rms_norm(x, w, 1e-5)
    if groups == 1:
        torch.testing.assert_close(got, whole, rtol=0, atol=1e-6)
    else:
        assert float((got - whole).abs().max()) > 0.1
        parts = x.reshape(3, 5, groups, 16 // groups)
        want = torch.cat([rms_norm(parts[..., i, :], w.reshape(groups, -1)[i], 1e-5)
                          for i in range(groups)], dim=-1)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_the_mixer_takes_the_grouped_norm_at_its_epsilon(monkeypatch):
    cfg = get_config(ARCH, reduced=True)
    seen = []
    grouped = mamba2.rms_norm_grouped
    monkeypatch.setattr(mamba2, "rms_norm_grouped",
                        lambda y, w, groups, eps: seen.append((groups, eps)) or grouped(y, w, groups, eps))
    params = Model(cfg, "cpu").init(0).blocks[0].mamba
    mamba2.mamba_mixer(params, torch.randn(2, 16, cfg.d_model), cfg.ssm)
    assert seen == [(2, 1e-5)]


def test_the_port_ssd_keeps_long_memory_across_chunks_as_the_reference():
    """Published Mamba2 draws ``dt`` in [0.001, 0.1] and ``A = -exp(A_log)``
    near -1: decays ``dt A`` of -0.001 to -0.1 a token, which carry a head's
    state over many chunks.  The benchmark cell's draws give about one token
    of memory, so this holds the port's ``ssd_chunked`` to the reference's
    ``ssd`` where the cross-chunk pass carries most of the output."""
    g = torch.Generator().manual_seed(11)
    bsz, s, heads, groups, p, n, chunk = 2, 96, 4, 2, 8, 16, 16
    x = torch.randn(bsz, s, heads, p, generator=g)
    dt = torch.exp(torch.empty(bsz, s, heads).uniform_(-6.9, -2.3, generator=g))
    a = -torch.empty(heads).uniform_(1.0, 1.2, generator=g)
    bm, cm = (torch.randn(bsz, s, groups, n, generator=g) for _ in range(2))
    got, _ = mamba2.ssd_chunked(x, dt, a, bm, cm, chunk=chunk)

    def reference(chunk_len):
        per_head = lambda t: t.double().repeat_interleave(heads // groups, dim=2)
        return nemotron_h.ssd(x.double() * dt.double()[..., None], dt.double() * a.double(),
                              per_head(bm), per_head(cm), chunk_len)

    want = reference(chunk)
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    # each chunk on its own (no state entering) is far off: the carried state matters
    alone = torch.cat([nemotron_h.ssd(*(t[:, i:i + chunk] for t in (
        x.double() * dt.double()[..., None], dt.double() * a.double(),
        bm.double().repeat_interleave(2, dim=2), cm.double().repeat_interleave(2, dim=2))), chunk)
        for i in range(0, s, chunk)], dim=1)
    assert float((want - alone).abs().max()) > 0.3 * float(want.abs().max())


def _reference_moe_case(e=8, top_k=3, d=16, f=12, fs=20, t=40, rows=2, capacity=12):
    """An MoE layer with every expert held, its weights, and the inputs."""
    conf = nemotron_conf(hidden_size=d, router_experts=e, n_routed_experts=e,
                         num_experts_per_tok=top_k, moe_intermediate_size=f,
                         moe_shared_expert_intermediate_size=fs)
    m = nemotron_h.dims(conf)
    settings = get_config(ARCH, reduced=True).moe
    settings = dataclasses.replace(settings, n_experts=e, top_k=top_k, d_ff_expert=f,
                                   d_ff_shared=fs, held=0)
    gen = torch.Generator().manual_seed(4)
    p = init_moe_params(gen, d, settings, torch.float32)
    p["router_bias"] = torch.randn(e, generator=gen) * 0.1
    h = torch.randn(rows, t // rows, d, generator=gen)
    norm = 1 + 0.1 * torch.randn(d, generator=gen)
    return m, settings, p, h, norm, capacity


def test_the_shares_of_the_experts_add_up_to_the_uncut_reference_layer():
    m, settings, p, h, norm, cap = _reference_moe_case()
    e, q = settings.n_experts, settings.n_experts // 4
    w = {("norm",): norm, ("moe", "router"): p["router"], ("moe", "router_bias"): p["router_bias"],
         ("moe", "w_up"): p["w_up"], ("moe", "w_down"): p["w_down"],
         ("moe", "shared", "w_up"): p["shared"]["w_up"],
         ("moe", "shared", "w_down"): p["shared"]["w_down"]}
    want, want_aux = nemotron_h.moe(h, w, m, cap, REF)
    x = rms_norm(h, norm, m.eps).reshape(-1, m.d)
    held = dataclasses.replace(settings, held=q)
    total = torch.zeros_like(x)
    for j in range(4):  # share j: experts j*q .. j*q + q - 1, in slots 0 .. q - 1
        share = {k: p[k] for k in ("router", "router_bias")}
        share.update(w_up=p["w_up"][j * q:(j + 1) * q], w_down=p["w_down"][j * q:(j + 1) * q])
        if j == 0:  # the shared expert, which every chip computes alike, counted once
            share["shared"] = p["shared"]
        perm = (torch.arange(e) - j * q) % e
        y, aux = moe_ffn(x, share, e, settings.top_k, cap, train=True, routing=held,
                         rows=h.shape[0], expert_perm=perm)
        torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=1e-7)
        total += y
    torch.testing.assert_close(h + total.view_as(h), want, rtol=1e-5, atol=1e-5)
    # and what one share alone gives is not the whole layer
    y0, _ = moe_ffn(x, dict(share, shared=p["shared"]), e, settings.top_k, cap, train=True,
                    routing=held, rows=h.shape[0])
    assert float((h + y0.view_as(h) - want).abs().max()) > 1e-2


def test_serving_raises_naming_the_mamba_state():
    model = Model(get_config(ARCH, reduced=True), "cpu")
    params = model.init(0)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    for call in (lambda: model.prefill(params, {"tokens": tokens}, 8),
                 lambda: model.init_cache(1, 8),
                 lambda: model.decode_step(params, {}, {"tokens": tokens[:, :1]}, 0)):
        with pytest.raises(NotImplementedError, match="SSD state for each M layer"):
            call()


def test_a_traced_step_records_the_mamba_spans_and_counters():
    cfg = get_config(ARCH, reduced=True)
    model = Model(cfg, "cpu")
    params = model.init(0).requires_grad_()
    tokens = torch.randint(2, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(3))
    spans.clear()
    spans.enable()
    try:
        with spans.step("cpu"):
            loss, _ = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
            loss.backward()
    finally:
        spans.disable()
    st = spans.steps()[-1]
    spans.clear()
    got = {}
    for s in st["spans"]:
        got.setdefault(s["name"], set()).add((s["parent"], s["phase"]))
    n_mamba = cfg.layer_kinds().count("mamba")
    for name, parent in (("repro_torch.mamba", "repro_torch.block"),
                         ("repro_torch.mamba.ssd", "repro_torch.mamba")):
        assert {ph for _, ph in got[name]} == {"forward", "recompute", "backward"}
        assert (parent, "forward") in got[name]
        assert sum(s["name"] == name and s["phase"] == "forward" for s in st["spans"]) == n_mamba
    c = st["counters"]
    assert c["mamba.chunks"] == n_mamba * 2 * (32 // cfg.ssm.chunk)  # rows x chunks, forward only
    n_moe = cfg.layer_kinds().count("moe")
    pairs = n_moe * 2 * 32 * cfg.moe.top_k
    assert 0 < c["moe.foreign_pairs"] < pairs
    assert 0 < c["moe.kept_pairs"] <= pairs - c["moe.foreign_pairs"]
    assert c["moe.slots"] == n_moe * cfg.moe.n_held * moe_capacity(cfg, 64)  # the held experts'

