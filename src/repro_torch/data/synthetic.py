"""Synthetic data generators (offline container — no real MNIST/ImageNet).

* ``logistic_dataset`` — a two-class "handwritten digit"-like dataset for
  the paper's §VI-A experiment (regularized logistic regression, smooth and
  strongly convex).  Samples are drawn from two anisotropic Gaussian
  prototypes in 784-D, mimicking the MNIST 0-vs-1 task.
* ``partition`` — splits a dataset over ``n`` nodes either IID or fully
  heterogeneous (label-sorted), controlling the ς of Definition 2.
* ``token_stream`` — deterministic synthetic token batches for LM training.

A verbatim copy of ``src/repro/data/synthetic.py`` (the port imports
nothing of the JAX package); tests/test_torch_logistic.py pins equal
arrays.
"""
from __future__ import annotations

import numpy as np

__all__ = ["logistic_dataset", "partition", "token_stream"]


def logistic_dataset(
    m: int = 12_000, d: int = 784, *, seed: int = 0, margin: float = 2.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Two-class Gaussian-prototype dataset: returns (X, y), y ∈ {0, 1}."""
    rng = np.random.default_rng(seed)
    proto0 = rng.normal(0.0, 1.0, d)
    proto1 = rng.normal(0.0, 1.0, d)
    proto0 *= margin / np.linalg.norm(proto0) * np.sqrt(d)
    proto1 *= margin / np.linalg.norm(proto1) * np.sqrt(d)
    y = (rng.uniform(size=m) < 0.5).astype(np.int32)
    scales = rng.uniform(0.5, 1.5, d)
    X = np.where(y[:, None] == 1, proto1[None], proto0[None])
    X = X + rng.normal(0.0, 1.0, (m, d)) * scales[None, :] * margin
    X = X / np.sqrt(d)
    return X.astype(np.float32), y


def partition(
    X: np.ndarray, y: np.ndarray, n: int, *, heterogeneous: bool = False,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Split (X, y) into n equal shards: returns (n, m_i, d), (n, m_i).

    ``heterogeneous=True`` sorts by label first, giving each node a highly
    non-IID shard (large ς in Definition 2) — the regime where gradient
    tracking separates from D-PSGD/AD-PSGD.
    """
    rng = np.random.default_rng(seed)
    m = X.shape[0]
    order = np.argsort(y, kind="stable") if heterogeneous else rng.permutation(m)
    m_i = m // n
    order = order[: m_i * n]
    Xs = X[order].reshape(n, m_i, -1)
    ys = y[order].reshape(n, m_i)
    return Xs, ys


def token_stream(
    vocab: int, batch: int, seq: int, *, n_batches: int, seed: int = 0,
):
    """Deterministic synthetic LM batches: (tokens, labels) pairs."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
        yield toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
