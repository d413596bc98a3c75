"""The training cell's configuration and mix at reduced widths for the CPU
tests: the same keys as the cell's files."""
import copy

from portbench import spec


def train_conf(**over) -> dict:
    conf = copy.deepcopy(spec.config("qwen3-moe-30b-a3b.l4"))
    conf.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                head_dim=16, num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
                vocab_size=512, **over)
    conf["port"] = dict(conf["port"], loss_chunk=16, attn_chunk_q=16, attn_chunk_kv=16)
    return conf


def train_mix(**over) -> dict:
    mix = dict(spec.traffic("train_16k"), batch=4, seq_len=32, mean_doc_len=8)
    mix.update(over)
    return mix
