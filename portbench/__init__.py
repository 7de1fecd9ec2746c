"""portbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

Every cell of ``BENCHMARK.json`` is one model configuration
(``configs/<config>.json``) under one traffic mix (``traffic/<mix>.json``),
driven through ``repro_torch``'s serving engine by ``run.py``; each metric
is read by ``metrics/<metric>.py`` and each cell's correctness limits sit in
``limits/<cell>.json``. Nothing here imports ``jax`` or the JAX package,
and ``reference/`` imports nothing of ``repro_torch``.
"""
