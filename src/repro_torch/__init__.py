"""PyTorch + CUDA port of the R-FAST reproduction (``src/repro/`` is the
JAX reference).  It imports ``torch`` and ``numpy``, never ``jax`` or
``repro``.  See README.md for the layout and how to run it."""
