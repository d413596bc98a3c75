"""PyTorch/CUDA port of the EP-SpMV and LM serving system (NVIDIA Hopper).

Beside ``repro`` (JAX + Pallas, the reference) and imports nothing of it.
The host partitioner and plan service are numpy copies under ``core``, the
model configs copies under ``configs``; the serving models live in
``models``; the kernels (per-cluster SpMV, flash attention, the grouped
expert SwiGLU) are CUDA C++ under ``kernels/csrc``, built with ``nvcc`` at
first use.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``, where every kernel runs its plain PyTorch
twin.
"""
