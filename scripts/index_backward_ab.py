#!/usr/bin/env python3
"""Time, on the card, two ways of writing each of the train step's two
index backwards at its ``training`` shapes (``chip_smoke.py``).

    python3 scripts/index_backward_ab.py

  embedding   the token lookup of 4 x 2,048 SyntheticPipeline tokens (Zipf
              ids: the commonest is about a quarter of them) into a 151,936 x
              2,048 bf16 table: ``w[tokens]`` (its backward an index-put that
              walks each id's rows in turn) against ``F.embedding`` (a segment
              sum over the sorted ids);
  combine     the expert combine's gather of 65,536 routed pairs (top-8 of
              8,192 tokens) from 128 x 640 slab rows of 2,048, 20% of pairs
              dropped: dropped pairs all reading the last row (``clamped``)
              against each reading a row of its own (``spread``).

Each backward is timed with CUDA events over 5 runs after a warm-up; prints
one JSON line.  Needs a CUDA device.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data import PipelineConfig, SyntheticPipeline  # noqa: E402


def _ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        print("index_backward_ab: needs a CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    vocab, d = 151_936, 2_048
    pipe = SyntheticPipeline(PipelineConfig(vocab_size=vocab, seq_len=2_048, global_batch=4))
    tok = torch.from_numpy(pipe.batch(0)["tokens"]).to(dev)
    w = torch.randn(vocab, d, device=dev, dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn(4, 2_048, d, device=dev, dtype=torch.bfloat16)

    def lookup(fn):
        def run():
            w.grad = None
            fn().backward(g)
        return run

    out = {"unique_tokens": int(torch.unique(tok).numel()),
           "top_token_share": float((tok == torch.mode(tok.flatten()).values).float().mean()),
           "embedding_index_ms": _ms(lookup(lambda: w[tok])),
           "embedding_F_ms": _ms(lookup(lambda: F.embedding(tok, w)))}

    e, c, t, k = 128, 640, 8_192, 8
    rng = np.random.default_rng(0)
    keep = torch.from_numpy(rng.random(t * k) < 0.8).to(dev)
    rows = torch.from_numpy(rng.integers(0, e * c, t * k)).to(dev)
    slab = torch.randn(e * c, d, device=dev, dtype=torch.bfloat16, requires_grad=True)
    gy = torch.randn(t * k, d, device=dev, dtype=torch.bfloat16)

    def gather(idx):
        def run():
            slab.grad = None
            slab[idx].backward(gy)
        return run

    spread = torch.arange(t * k, device=dev) % (e * c)
    out["combine_clamped_ms"] = _ms(gather(torch.where(keep, rows, e * c - 1)))
    out["combine_spread_ms"] = _ms(gather(torch.where(keep, rows, spread)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
