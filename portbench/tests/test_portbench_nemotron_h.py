"""The Nemotron-H reference (``reference/nemotron_h.py``) against the port's
CPU twin at reduced widths in float32: three training steps of the
Nemotron cell's files through ``run_cell``, cut to six layers (Mamba2, MoE
and attention) holding 4 of the router's 8 experts; and the reference's
chunked SSD against the recurrence it stands for."""
import copy
import time

import torch

from portbench import harness, spec
from portbench.reference import nemotron_h

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
SEED = 2**36 + 13
CELL = "nemotron3nano.train-16k"
#: float32 against float32 at reduced widths: rounding alone
LIMITS = {"limits": {"loss_err": 1e-5, "grad_err": 1e-4, "grad_median": 1e-5, "change_err": 1e-3}}


def nemotron_conf(**over) -> dict:
    """The cell's configuration at the reduced twin's widths: layers
    ``MEMEM*`` and 4 of 8 experts held."""
    conf = copy.deepcopy(spec.config("nemotron-3-nano-30b-a3b.l13"))
    conf.update(dict(hidden_size=64, num_hidden_layers=6, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=16, mamba_num_heads=4, mamba_head_dim=16,
                     n_groups=2, ssm_state_size=16, chunk_size=8, router_experts=8,
                     n_routed_experts=4, num_experts_per_tok=3, moe_intermediate_size=32,
                     moe_shared_expert_intermediate_size=48, vocab_size=512), **over)
    conf["port"] = dict(conf["port"], loss_chunk=16, attn_chunk_q=16, attn_chunk_kv=16, **F32)
    return conf


def nemotron_mix(**over) -> dict:
    mix = dict(spec.traffic("train_2x16k"), batch=4, seq_len=32, mean_doc_len=8)
    mix.update(over)
    return mix


def test_three_train_steps_through_run_cell_agree_with_the_reference():
    out = harness.run_cell(spec.workload(CELL), SEED, 0.01, False, "cpu", time.perf_counter(),
                           conf=nemotron_conf(), mix=nemotron_mix(), limits=LIMITS)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_the_leaves_and_their_counts():
    conf = nemotron_conf()
    m = spec.dims(conf)
    assert m.pattern == "MEMEM*"
    n = {"M": 9, "E": 7, "*": 5}
    leaves = sum(len(nemotron_h.layout(conf, g)) for g in range(m.layers))
    assert leaves == sum(n[c] for c in m.pattern)
    drawn = sum(torch.Size(s).numel() for g in ["top", *range(m.layers)]
                for _, s, _ in nemotron_h.layout(conf, g))
    assert drawn == nemotron_h.n_params(m)


def test_the_cell_holds_the_parameters_its_file_states():
    """The full cell: 6 Mamba2, 5 MoE (32 experts held) and 2 attention
    layers with the embedding, head and final norm."""
    m = spec.dims(spec.config("nemotron-3-nano-30b-a3b.l13"))
    assert m.pattern == "MEMEM*EMEMEM*" and (m.experts, m.held, m.d_inner) == (128, 32, 4096)
    assert nemotron_h.n_params(m) == 2_681_883_136


def _recurrence(x, a, b, c):
    """``s_t = exp(a_t) s_{t-1} + x_t b_t^T``, ``y_t = s_t c_t``, token by token."""
    bsz, s, h, p = x.shape
    state = torch.zeros(bsz, h, p, b.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(s):
        state = state * torch.exp(a[:, t])[..., None, None] + x[:, t, ..., None] * b[:, t, :, None]
        ys.append((state * c[:, t, :, None]).sum(-1))
    return torch.stack(ys, dim=1)


def test_the_chunked_ssd_equals_the_token_by_token_recurrence():
    g = torch.Generator().manual_seed(7)
    bsz, s, h, p, n = 2, 24, 3, 4, 5
    x = torch.randn(bsz, s, h, p, generator=g, dtype=torch.float64)
    a = -torch.rand(bsz, s, h, generator=g, dtype=torch.float64)
    b, c = (torch.randn(bsz, s, h, n, generator=g, dtype=torch.float64) for _ in range(2))
    want = _recurrence(x, a, b, c)
    for chunk in (4, 8, 24):
        torch.testing.assert_close(nemotron_h.ssd(x, a, b, c, chunk), want, rtol=1e-10,
                                   atol=1e-10)
