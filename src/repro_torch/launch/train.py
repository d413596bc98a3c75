"""End-to-end training driver of the port (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \
        --reduced --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

A real training loop: the synthetic pipeline -> the train step (gradient
accumulation + remat + AdamW) -> the fault-tolerant loop with async
checkpointing when a checkpoint directory is given.  It runs on the CUDA
device; ``run_training(..., device="cpu")`` (``--device cpu``) runs on the
CPU.  ``examples/torch_train_lm.py`` wraps it.  The train path launches
none of the port's kernels, as the reference's runs none of its Pallas
kernels: its attention and experts are differentiable PyTorch.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..ckpt import CheckpointManager
from ..configs import get_config
from ..data import PipelineConfig, SyntheticPipeline
from ..device import resolve_device
from ..models import Model
from ..optim import AdamWConfig, warmup_cosine
from ..runtime import FaultTolerantLoop, StragglerMonitor
from ..runtime.train import init_train_state, make_train_step

__all__ = ["run_training", "main"]


def run_training(
    arch: str,
    steps: int = 20,
    batch: int = 8,
    seq: int = 64,
    reduced: bool = True,
    ckpt_dir: str | None = None,
    ckpt_every: int = 10,
    num_microbatches: int = 2,
    seed: int = 0,
    log_every: int = 5,
    fail_at: int | None = None,
    device=None,
    n_layers: int | None = None,
):
    """Train; returns (final_state, history).  ``fail_at`` injects one step
    failure to exercise the checkpoint/restart path (tests use it);
    ``n_layers`` cuts the config to its first layers (``None`` keeps them
    all).  Without a checkpoint directory each history entry also holds the
    step's ``grad_norm``, ``lr`` and wall ``seconds`` (up to its loss on the
    host)."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg, dev)
    opt_cfg = AdamWConfig(lr=warmup_cosine(3e-4, max(2, steps // 10), steps))
    step_fn = make_train_step(model, opt_cfg, num_microbatches=num_microbatches)
    state = init_train_state(model, opt_cfg, seed)

    pipe = SyntheticPipeline(
        PipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
            seed=seed, frontend=cfg.frontend, d_model=cfg.d_model,
        )
    )

    failed = {"done": False}

    def batch_fn(step: int) -> dict:
        if fail_at is not None and step == fail_at and not failed["done"]:
            failed["done"] = True
            raise RuntimeError(f"injected failure at step {step}")
        b = pipe.enc_dec_batch(step) if cfg.family == "encdec" else pipe.batch(step)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    history = []
    if ckpt_dir is not None:
        loop = FaultTolerantLoop(
            step_fn=step_fn,
            batch_fn=batch_fn,
            ckpt=CheckpointManager(ckpt_dir, keep=2),
            ckpt_every=ckpt_every,
            straggler=StragglerMonitor(),
        )
        state, history = loop.run(state, 0, steps)
    else:
        for step in range(steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_fn(step))
            rec = {"step": step, **{k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")}}
            rec["seconds"] = time.perf_counter() - t0
            if step % log_every == 0:
                print(
                    f"step {step:5d} loss={rec['loss']:.4f} "
                    f"gnorm={rec['grad_norm']:.3f} "
                    f"dt={rec['seconds']:.3f}s"
                )
            history.append(rec)
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    _, history = run_training(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        reduced=args.reduced, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, num_microbatches=args.microbatches,
        device=args.device,
    )
    losses = [h["loss"] for h in history if "loss" in h]
    print(f"trained {len(history)} steps; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
