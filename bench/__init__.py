"""Benchmark of the PyTorch/CUDA port (``repro_torch``) of HOLMES.

``bench/run.py`` runs one cell of ``BENCHMARK.json``.  Nothing here
imports JAX or the JAX package; ``bench/reference`` imports nothing of
the port either.
"""
