# Copy of src/repro/data/pipeline.py, kept verbatim so the port imports nothing of the
# JAX package.
"""Per-node sharded data pipeline for LM training.

Each R-FAST node owns a disjoint shard of the (synthetic) corpus — problem
(1)'s local distributions D_i.  The iterator yields host numpy batches;
``device_put_sharded``-style placement is handled by the launcher.

Tokens are drawn from a Zipfian marginal (``zipf`` exponent; 0 = the old
uniform stream): a learnable unigram structure, so training losses have
real headroom below the ``log(vocab)`` uniform floor and "loss goes
down" is a meaningful end-to-end assertion.  The async engines sample
the same marginal device-side (``objectives.LMProblem``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["LMShardConfig", "lm_batch_iterator", "node_batch", "zipf_probs"]


@dataclasses.dataclass(frozen=True)
class LMShardConfig:
    vocab: int
    batch_per_node: int
    seq_len: int
    n_nodes: int
    seed: int = 0
    zipf: float = 1.2     # token marginal ∝ (rank+1)^-zipf; 0 = uniform


def zipf_probs(vocab: int, s: float) -> np.ndarray:
    """Zipfian unigram marginal p(t) ∝ (t+1)^-s over token ids."""
    w = np.arange(1, vocab + 1, dtype=np.float64) ** (-s)
    return w / w.sum()


def node_batch(cfg: LMShardConfig, node: int, step: int):
    """Deterministic batch for (node, step): tokens, labels (next-token)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, node, step]))
    shape = (cfg.batch_per_node, cfg.seq_len + 1)
    if cfg.zipf > 0:
        toks = rng.choice(cfg.vocab, size=shape,
                          p=zipf_probs(cfg.vocab, cfg.zipf))
    else:
        toks = rng.integers(0, cfg.vocab, shape, dtype=np.int64)
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def lm_batch_iterator(cfg: LMShardConfig, node: int,
                      start_step: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    step = start_step
    while True:
        yield node_batch(cfg, node, step)
        step += 1
