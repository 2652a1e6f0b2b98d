"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: ``run.py`` runs one cell of ``BENCHMARK.json``.  Nothing here
imports JAX or the JAX package ``repro``; ``reference/`` imports nothing of
the program either."""
