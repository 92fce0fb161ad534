"""Everything a run feeds both sides, made from ``--seed``.

The weights, every node's token batches, the sync rounds' delivery masks
and the async runs' event schedule are the benchmark's own inputs: the
program under test and the plain reference get the same ones.  Each draw
has a generator of its own, seeded from ``(seed, what, step, node)``, so
any input can be made again, on either side, in any order.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from reference.rfast import edges

__all__ = ["subseed", "generator", "binary_tree", "zipf_cdf",
           "token_batch", "round_masks", "realize_schedule", "Schedule",
           "check_schedule"]

_TAGS = {"weights": 1, "tokens": 2, "masks": 3, "schedule": 4}


def subseed(seed: int, what: str, *ints: int) -> int:
    """A 63-bit seed for one draw (any ``seed`` up to 2**64)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, _TAGS[what],
                                 *(int(i) + 1 for i in ints)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, what: str, *ints: int, device="cpu"):
    return torch.Generator(device=device).manual_seed(
        subseed(seed, what, *ints))


def binary_tree(n: int) -> tuple[np.ndarray, np.ndarray]:
    """``(W, A)`` of the binary tree rooted at node 0 (node i's parent is
    (i − 1) // 2): in W every node pulls from its parent, in A it pushes
    to it; uniform weights, W row- and A column-stochastic."""
    W, A = np.zeros((n, n)), np.zeros((n, n))
    for i in range(n):
        if i == 0:
            W[0, 0] = 1.0
        else:
            W[i, i] = W[i, (i - 1) // 2] = 0.5
        A[i, i] = 1.0 if i == 0 else 0.5
        if i:
            A[(i - 1) // 2, i] = 0.5
    return W, A


def zipf_cdf(vocab: int, s: float, device) -> torch.Tensor:
    """Cumulative Zipf law p(t) ∝ (t + 1)^−s over the vocabulary (fp64)."""
    w = torch.arange(1, vocab + 1, dtype=torch.float64, device=device) ** -s
    c = torch.cumsum(w / w.sum(), 0)
    c[-1] = 1.0
    return c


def token_batch(seed: int, step: int, node: int, batch: int, seq: int,
                cdf: torch.Tensor):
    """Node ``node``'s batch at ``step``: ``(tokens, labels)`` (B, S)
    int64 on ``cdf``'s device, the labels the tokens shifted by one."""
    gen = generator(seed, "tokens", step, node, device=cdf.device)
    u = torch.rand(batch, seq + 1, generator=gen, dtype=torch.float64,
                   device=cdf.device)
    t = torch.searchsorted(cdf, u).clamp_(max=cdf.shape[0] - 1)
    return t[:, :-1].contiguous(), t[:, 1:].contiguous()


def round_masks(seed: int, step: int, n_edges: int, width: int,
                loss_prob: float) -> np.ndarray:
    """The 0/1 deliveries of round ``step`` (1, 2, ...): edge position e
    delivers W-edge e and A-edge e with probability 1 − ``loss_prob``;
    positions past ``n_edges`` (padding) read 1."""
    rng = np.random.default_rng(subseed(seed, "masks", step))
    m = np.ones(width, np.float32)
    m[:n_edges] = (rng.random(n_edges) >= loss_prob).astype(np.float32)
    return m


class Schedule:
    """A realized asynchronous trace: ``agent`` (K,), payload stamps
    ``stamp_v`` (K, E_W) and ``stamp_rho`` (K, E_A), virtual ``times``,
    and ``D``, the staleness bound every stamp keeps (k − stamp ≤ D)."""

    def __init__(self, agent, stamp_v, stamp_rho, times, D):
        self.agent, self.stamp_v, self.stamp_rho = agent, stamp_v, stamp_rho
        self.times, self.D = times, int(D)

    @property
    def K(self) -> int:
        return int(self.agent.shape[0])

    def activation_gap(self, n: int) -> int:
        """Smallest T such that every window of T events runs every
        node."""
        last = -np.ones(n, np.int64)
        gap = 0
        for k, a in enumerate(self.agent):
            last[a] = k
            if (last >= 0).all():
                gap = max(gap, k - int(last.min()))
        return gap + 1


def realize_schedule(W: np.ndarray, A: np.ndarray, K: int, *, seed: int,
                     compute_time, jitter: float, latency: float,
                     loss: float, D_max: int) -> Schedule:
    """An event clock over the two graphs.  Node i wakes every
    ``compute_time[i]``·(1 ± ``jitter``) virtual seconds (the first wake
    uniform in its first interval); the earliest wake is the next event.
    At its event a node consumes, on each in-edge, the largest stamp that
    has arrived, then sends stamp k + 1 on each out-edge, lost with
    probability ``loss``, else arriving after an exponential latency of
    mean ``latency``.  A stamp older than ``D_max`` events is forced
    forward to k − ``D_max`` (bounded staleness), so ``D`` is ``D_max``."""
    rng = np.random.default_rng(subseed(seed, "schedule"))
    n = len(W)
    ew, ea = edges(W), edges(A)
    base = np.asarray(compute_time, np.float64) * np.ones(n)
    clocks = rng.uniform(0.0, 1.0, n) * base
    agent = np.zeros(K, np.int32)
    times = np.zeros(K)
    stamps = []
    for es in (ew, ea):
        stamps.append(np.zeros((K, max(1, len(es))), np.int32))
    best = [np.zeros(max(1, len(es)), np.int64) for es in (ew, ea)]
    queues = [[[] for _ in es] for es in (ew, ea)]
    for k in range(K):
        a = int(np.argmin(clocks))
        now = float(clocks[a])
        agent[k], times[k] = a, now
        for g, es in enumerate((ew, ea)):
            for e, (j, i) in enumerate(es):
                if i != a:
                    continue
                q = queues[g][e]
                while q and q[0][0] <= now:
                    best[g][e] = max(best[g][e], heapq.heappop(q)[1])
                best[g][e] = max(best[g][e], k - D_max)
            stamps[g][k] = best[g]
        for g, es in enumerate((ew, ea)):
            for e, (j, i) in enumerate(es):
                if j == a and rng.random() >= loss:
                    heapq.heappush(queues[g][e],
                                   (now + rng.exponential(latency), k + 1))
        clocks[a] = now + base[a] * (1.0 + rng.uniform(-jitter, jitter))
    return Schedule(agent, stamps[0], stamps[1], times, D_max)


def check_schedule(s: Schedule, W: np.ndarray, A: np.ndarray) -> None:
    """Raise unless every stamp an event reads lies in [k − D, k] and
    each edge's stamps never go back."""
    for st, es in ((s.stamp_v, edges(W)), (s.stamp_rho, edges(A))):
        if (np.diff(st, axis=0) < 0).any():
            raise ValueError("schedule stamps go back")
        for k, a in enumerate(s.agent):
            for e, (_, i) in enumerate(es):
                if i == a and not k - s.D <= st[k, e] <= k:
                    raise ValueError(f"event {k} reads stamp {st[k, e]}")
