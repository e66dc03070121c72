"""PyTorch/CUDA port of the ``repro`` package (FP8 LNS arithmetic and the
paged FP8 serving engine), held bit for bit or within stated tolerances
against the JAX package by ``tests/test_torch_*.py``.

Layout mirrors ``src/repro/``: ``core/`` (formats, codec, PRNG twin),
``kernels/`` (hand-written CUDA kernels and their plain versions),
``numerics/`` (the policy tree), ``configs/``, ``models/``, ``serving/``
(page pool, scheduler, telemetry) and ``launch/`` (the serving Engine and
CLI).  Imports ``torch`` and numpy only — never ``jax`` or ``repro``.
"""
