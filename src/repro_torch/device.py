"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; a CUDA device must exist to be used.

    There is no silent fallback to the CPU: a caller that wants the plain
    PyTorch twins asks for ``device="cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (host timings end here)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
