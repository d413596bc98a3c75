#!/usr/bin/env python3
"""Planted control for chip_smoke.py's bf16 check of the flash-attention kernel.

    python3 scripts/flash_planted_control.py

Builds a copy of ``src/repro_torch/kernels/csrc`` (the flash-attention source
and the header it includes) in a temporary directory, in which every CTA
whose q tile starts at row 1,792 or later leaves out key tile 1 (keys
128-255: its scores are masked like keys past the diagonal, so the barrier
ring runs as before), and runs the kernel and that copy at the
``lm_serving`` shape (4 x 32 x 2,048 x 128, bf16, causal) on the inputs of
chip_smoke.py's ``lm_kernels`` phase.  Each output is held against the plain
twin with chip_smoke.py's two bf16 checks: the reference's 5e-2 and the
elementwise ``BF16_RTOL * |want| + BF16_ROW * rms(want's row)``.  Prints one JSON line with both
readings and exits 0 only if the kernel passes the scaled check and the copy
fails it.  Needs one CUDA device; the repository's sources are not changed.
"""
from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Where the bf16 kernel's softmax (softmax_tile) stores a masked score of the
# key tile at k0 for this thread's row row0: rows from 1,792 on are exactly
# the CTAs whose 128-row q tile starts there, and k0 == BN is key tile 1.
ANCHOR = "    sc[i] = x;\n"
SKIP = "    if (k0 == BN && row0 >= 1792) x = -CUDART_INF_F;  // planted fault\n" + ANCHOR


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_planted_control: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    cfg = get_config(smoke.LM_ARCH)
    b, s, _ = smoke.LM_TRAFFIC
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)  # as lm_kernels draws them
    q, k, v = (torch.randn((b, cfg.n_heads, s, cfg.d_head), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    want = flash_attention_ref(q, k, v, True)

    def reading(got):
        return {"max_abs_err": (got.double() - want.double()).abs().max().item(),
                "scaled_err": smoke.bf16_scaled_err(got, want),
                "within_reference_tol": bool(torch.allclose(
                    got.float(), want.float(), rtol=smoke.BF16_TOL, atol=smoke.BF16_TOL))}

    kernel = reading(flash_attention(q, k, v, causal=True))
    source = (_build.CSRC / "flash_attention.cu").read_text()
    if source.count(ANCHOR) != 1:
        raise RuntimeError("flash_attention.cu no longer stores each score once as `sc[i] = x;`")
    saved = _build.CSRC, _build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        csrc = Path(tmp) / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        (csrc / "flash_attention.cu").write_text(source.replace(ANCHOR, SKIP))
        _build.CSRC, _build.BUILD_DIR = csrc, Path(tmp) / "build"
        _build._loaded.pop("flash_attention", None)
        _build._entry_points.clear()
        try:
            planted = reading(flash_attention(q, k, v, causal=True))
            torch.cuda.synchronize()
        finally:
            _build.CSRC, _build.BUILD_DIR = saved
            _build._loaded.pop("flash_attention", None)
            _build._entry_points.clear()
    ok = kernel["scaled_err"] <= 1 < planted["scaled_err"]
    print(json.dumps({"shape": [b, cfg.n_heads, s, cfg.d_head], "fault": SKIP.strip(),
                      "tol": {"reference": smoke.BF16_TOL, "rtol": smoke.BF16_RTOL,
                              "row": smoke.BF16_ROW},
                      "kernel": kernel, "planted": planted, "ok": ok,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smoke._nvidia_smi()}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
