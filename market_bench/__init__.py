"""The benchmark of the market's PyTorch and CUDA program (``repro_torch``).

``run.py`` runs one cell; ``BENCHMARK.json`` at the repository's root
lists the cells, the deployments and the metrics.  See ``README.md``.
"""
