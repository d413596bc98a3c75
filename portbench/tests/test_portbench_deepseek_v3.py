"""The DeepSeek-V3 reference (``reference/deepseek_v3.py``) against the
port's CPU twin at reduced widths in float32: three training steps of the
Moonlight cell's files, cut to a dense layer and two MoE layers."""
import copy
import math

from portbench import spec
from portbench.entries import train

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
SEED = 2**36 + 7


def moonlight_conf(**over) -> dict:
    """The cell's configuration at the reduced twin's widths."""
    conf = copy.deepcopy(spec.config("moonlight-16b-a3b.l5"))
    conf.update(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
                n_routed_experts=8, num_experts_per_tok=3, moe_intermediate_size=32,
                intermediate_size=96, vocab_size=512, **over)
    conf["port"] = dict(conf["port"], loss_chunk=16, attn_chunk_q=16, attn_chunk_kv=16, **F32)
    return conf


def moonlight_mix(**over) -> dict:
    mix = dict(spec.traffic("train_8k"), batch=4, seq_len=32, mean_doc_len=8)
    mix.update(over)
    return mix


def test_three_train_steps_agree_with_the_deepseek_v3_reference():
    conf, mix = moonlight_conf(), moonlight_mix()
    job = train.Job(conf, mix, "cpu")
    job.load(SEED)
    got = job.checked(SEED)
    want = train.reference(conf, mix, SEED, "cpu")
    readings = train.compare(got, want)
    assert readings["loss_err"] < 1e-5
    assert readings["grad_err"] < 1e-4
    assert readings["grad_median"] < 1e-5
    assert readings["change_err"] < 1e-3
    # 3 top leaves; 6 attention leaves a layer; the dense layer's 4; each MoE layer's 9
    assert len(got["grad_norm"]) == len(want["grad_norm"]) == 3 + 3 * 6 + 4 + 2 * 9
    biases = [k for k in want["grad_norm"] if k[1][-1] == "router_bias"]
    assert len(biases) == 2 and all(want["grad_norm"][k] == 0.0 for k in biases)
    moved = [v for k, v in want["change"].items() if k not in biases]
    assert all(math.isfinite(v) and v > 0 for v in moved)
