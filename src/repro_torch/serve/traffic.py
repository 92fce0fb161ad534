# Copy of src/repro/serve/traffic.py, kept verbatim (over the port's own
# data/pipeline.zipf_probs) so the port imports nothing of the JAX package.
"""Zipfian open-loop traffic generator.

Reuses ``data/pipeline.zipf_probs`` — the same unigram law the training
corpus is drawn from — for every marginal of the workload: token
content, prompt length, and generation length are all Zipf(s), so the
serving benchmark sees the heavy-tailed mix (many short prompts, a fat
tail of long ones) that makes length bucketing earn its keep.  Arrivals
are open-loop Poisson: inter-arrival gaps are Exponential(rate) drawn up
front, so load does NOT back off when the server falls behind — queueing
delay shows up in the latency percentiles instead of being hidden by a
closed loop.  ``rate_rps=0`` degenerates to a closed backlog (everything
arrives at t=0), which is what the deterministic tests use.
"""
from __future__ import annotations

import numpy as np

from ..data.pipeline import zipf_probs
from .scheduler import Request

__all__ = ["make_workload"]


def make_workload(n_requests: int, *, vocab: int, max_prompt: int,
                  max_gen: int, rate_rps: float = 0.0, s: float = 1.2,
                  seed: int = 0) -> list[Request]:
    if n_requests <= 0:
        return []
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, 0x5E12, n_requests]))
    plen = 1 + rng.choice(max_prompt, size=n_requests,
                          p=zipf_probs(max_prompt, s))
    glen = 1 + rng.choice(max_gen, size=n_requests,
                          p=zipf_probs(max_gen, s))
    tok_p = zipf_probs(vocab, s)
    if rate_rps > 0:
        arrive = np.cumsum(rng.exponential(1.0 / rate_rps,
                                           size=n_requests))
    else:
        arrive = np.zeros(n_requests)
    return [Request(rid=i,
                    prompt=rng.choice(vocab, size=int(plen[i]),
                                      p=tok_p).astype(np.int32),
                    gen=int(glen[i]),
                    arrive_s=float(arrive[i]))
            for i in range(n_requests)]
