"""Training example on the PyTorch/CUDA port: train a reduced LM for a few
hundred steps with the full substrate (synthetic pipeline, AdamW +
warmup-cosine, gradient accumulation, async checkpointing, the
fault-tolerant loop).

    PYTHONPATH=src python examples/torch_train_lm.py [--arch qwen3-moe-30b-a3b] \
        [--steps 300] [--device cuda|cpu]

Any registered architecture id works (its reduced config).  The same example
as ``examples/train_lm.py``, on ``repro_torch``.
"""
import argparse
import tempfile

from repro_torch.launch.train import run_training


def main(argv=None):
    """Trains; returns the history (one dict of metrics a step)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        state, history = run_training(
            args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
            reduced=True, ckpt_dir=ckpt_dir, ckpt_every=50, num_microbatches=2,
            device=args.device,
        )
    losses = [h["loss"] for h in history]
    print(f"{args.arch}: {len(history)} steps, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(min {min(losses):.3f})")
    assert losses[-1] < losses[0], "training must reduce loss"
    print("train_lm OK")
    return history


if __name__ == "__main__":
    main()
