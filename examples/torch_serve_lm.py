"""Serving example on the PyTorch/CUDA port: batched prefill + greedy decode
with a decode cache, for any ported architecture (reduced config).

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch granite-3-8b] [--device cuda|cpu]
    PYTHONPATH=src python examples/torch_serve_lm.py --arch mamba2-2.7b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch jamba-1.5-large-398b

``--arch`` takes every registered architecture.  Attention architectures
keep a K/V cache and run prefill attention through the flash-attention
kernel (and the expert FFN through its kernel where the architecture has
experts); the attention-free ``mamba2-2.7b`` carries the conv and SSD states
instead, and the hybrid ``jamba-1.5-large-398b`` both.  ``qwen2-vl-2b`` and
``seamless-m4t-medium`` take the reference's front-end stubs (seeded
embeddings; M-RoPE positions; the encoder's frames).  The same example as
``examples/serve_lm.py``, on ``repro_torch``.
"""
import argparse

from repro_torch.launch.serve import run_serving


def main(argv=None):
    """Serves one batch; returns (tokens (B, gen), timing dict)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    tokens, stats = run_serving(
        args.arch, batch=args.batch, prompt_len=args.prompt_len,
        gen=args.gen, reduced=True, device=args.device,
    )
    assert tuple(tokens.shape) == (args.batch, args.gen)
    print(f"{args.arch}: generated {tokens.shape[1]} tokens x {tokens.shape[0]} seqs")
    print(f"prefill {stats['prefill_s']:.2f}s, decode {stats['decode_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s on {stats['device']})")
    print("serve_lm OK")
    return tokens, stats


if __name__ == "__main__":
    main()
