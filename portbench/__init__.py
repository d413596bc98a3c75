"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once.  The cells' data files
(``configs/``, ``traffic/``, ``cells/``) and the per-layer readers
(``metrics/``) are found by name; ``reference/`` is the plain float32
reference that decides ``correct``; ``counts.py`` the peaks and the
operation and byte counts.  Only ``entries/`` imports the port.
"""
