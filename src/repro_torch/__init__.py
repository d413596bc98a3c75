"""PyTorch/CUDA port of the EP-SpMV serving system (NVIDIA Hopper).

Beside ``repro`` (JAX + Pallas, the reference) and imports nothing of it.
The host partitioner and plan service are numpy copies under ``core``; the
per-cluster SpMV kernels are CUDA C++ under ``kernels/csrc``, built with
``nvcc`` at first use.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``, where every kernel runs its plain PyTorch
twin.
"""
