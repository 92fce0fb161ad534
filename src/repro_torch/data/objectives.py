"""Objectives on the flat substrate.

Counterpart of ``src/repro/data/objectives.py``.  Every objective here
is a :class:`~repro_torch.core.paramvec.GradProvider`: ``n`` nodes, flat
dimension ``p`` and ``grad_fn()`` returning the ``(i, x_flat, gen) ->
g_flat`` the engines consume, where ``gen`` is the CPU
``torch.Generator`` of one (event, node).

* :class:`LogisticProblem` — the paper's §VI-A regularized logistic
  regression (smooth and strongly convex thanks to the L2 term), its
  node shards on one device.
* :class:`LMProblem` — a transformer LM: each node owns a Zipfian
  synthetic shard; ``grad_fn`` views the flat lane as the parameter
  tree, draws the node's batch from the generator, runs
  :func:`repro_torch.models.transformer.loss_fn` and differentiates back
  to the lane.  ``evaluate`` / ``mean_loss`` score a fixed held-out
  batch made with numpy exactly as the JAX package makes it, so both
  packages evaluate on the same tokens.

Both constructors place their data on ``cuda`` unless the caller passes
another ``device`` (they raise without a GPU, as every entry point of
the port does).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.paramvec import (ModelGradProvider, RavelSpec, make_ravel_spec,
                             ravel, unravel)
from ..kernels.rfast_update.dispatch import resolve_device
from .pipeline import LMShardConfig, zipf_probs

__all__ = ["LogisticProblem", "make_logistic_problem",
           "LMProblem", "make_lm_problem"]


@dataclasses.dataclass(frozen=True)
class LogisticProblem:
    """Regularized logistic regression over n node-local shards.

    Parameter layout: x = [w (d,), b ()] -> p = d + 1.
    Local objective:  f_i(x) = Σ_{s∈shard_i} log(1+exp(-ŷ s)) + (λ/2)|x|²
    (sum, not mean — problem (1)'s Σ_i f_i structure; the λ term is split
    evenly so F keeps a single global λ).  ``X`` and ``y`` lie on one
    device; every method computes there.
    """

    X: torch.Tensor         # (n, m_i, d) float32
    y: torch.Tensor         # (n, m_i) int32 in {0, 1}
    lam: float
    batch: int              # minibatch size per gradient sample (0 = full)

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def p(self) -> int:
        return self.X.shape[2] + 1

    @property
    def device(self) -> torch.device:
        return self.X.device

    # -- losses --------------------------------------------------------- #
    def _margins(self, Xb, yb, x):
        """ŷ·(Xb w + b) for rows ``Xb`` (..., d) with labels ``yb``."""
        s = 2.0 * yb.to(torch.float32) - 1.0
        return (Xb @ x[:-1] + x[-1]) * s

    def local_loss(self, i: int, x: torch.Tensor) -> torch.Tensor:
        m = self._margins(self.X[i], self.y[i], x)
        # softplus(-m) = logaddexp(-m, 0) everywhere (F.softplus turns
        # into the identity above its threshold)
        return (torch.logaddexp(-m, torch.zeros((), device=m.device)).sum()
                + 0.5 * self.lam * torch.sum(x * x))

    def global_loss(self, x: torch.Tensor) -> torch.Tensor:
        """F(x) = Σ_i f_i(x), evaluated on the full data."""
        m = self._margins(self.X, self.y, x)                  # (n, m_i)
        data = torch.logaddexp(-m, torch.zeros((), device=m.device))
        return data.sum() + self.n * 0.5 * self.lam * torch.sum(x * x)

    def mean_loss(self, x: torch.Tensor) -> torch.Tensor:
        return self.global_loss(x) / (self.X.shape[0] * self.X.shape[1])

    def accuracy(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.X.reshape(-1, self.X.shape[-1]) @ x[:-1] + x[-1]
        pred = (logits > 0).to(torch.int32)
        return (pred == self.y.reshape(-1)).to(torch.float32).mean()

    # -- gradients ------------------------------------------------------ #
    def _data_grad(self, Xb, yb, x, scale: float = 1.0) -> torch.Tensor:
        """∇_x of ``scale · Σ softplus(−m)`` over the rows ``Xb`` (r, d)
        with labels ``yb``, in closed form: d/d logit = −ŷ σ(−m)."""
        r = -(2.0 * yb.to(torch.float32) - 1.0) * torch.sigmoid(
            -self._margins(Xb, yb, x))
        if scale != 1.0:
            r = r * scale
        return torch.cat([Xb.T @ r, r.sum()[None]])

    def grad_at(self, i: int, x: torch.Tensor,
                idx: torch.Tensor | None = None) -> torch.Tensor:
        """∇f_i(x) on all of shard ``i`` (``idx=None``) or on its rows
        ``idx``, the data term then rescaled by ``m_i / len(idx)`` so the
        sample is unbiased."""
        if idx is None:
            return self._data_grad(self.X[i], self.y[i], x) + self.lam * x
        return (self._data_grad(self.X[i][idx], self.y[i][idx], x,
                                self.X.shape[1] / idx.shape[0])
                + self.lam * x)

    def grad_fn(self):
        """``(i, x, gen) -> ∇f_i``: the full gradient when ``batch <= 0``
        (or covers the shard; ``gen`` unused), else a minibatch of
        ``batch`` rows drawn uniformly with replacement from ``gen``.
        The draw runs on the CPU generator and its indices are copied to
        the data's device once per gradient, so a run draws the same rows
        on any device."""
        m_i = self.X.shape[1]
        if self.batch <= 0 or self.batch >= m_i:
            return lambda i, x, gen: self.grad_at(i, x)

        def gfn(i, x, gen):
            idx = torch.randint(0, m_i, (self.batch,), generator=gen)
            return self.grad_at(i, x, idx.to(self.device))
        return gfn

    def optimum(self, iters: int = 2000, lr: float = 0.5) -> torch.Tensor:
        """Reference x* by full-batch gradient descent on the mean loss
        (for gap plots)."""
        Xf = self.X.reshape(-1, self.X.shape[-1])
        yf = self.y.reshape(-1)
        x = torch.zeros(self.p, dtype=torch.float32, device=self.device)
        for _ in range(iters):
            g = self._data_grad(Xf, yf, x) + self.n * self.lam * x
            x = x - lr * g / Xf.shape[0]
        return x


def make_logistic_problem(
    n: int, *, m: int = 12_000, d: int = 784, lam: float = 1e-3,
    batch: int = 32, heterogeneous: bool = False, seed: int = 0,
    device=None,
) -> LogisticProblem:
    """The reference's dataset and split (``data/synthetic.py``, numpy),
    moved to ``device`` (``cuda`` unless the caller asks for another)."""
    from .synthetic import logistic_dataset, partition

    dev = resolve_device(device)
    X, y = logistic_dataset(m, d, seed=seed)
    Xs, ys = partition(X, y, n, heterogeneous=heterogeneous, seed=seed)
    # λ split evenly across nodes so Σ_i f_i carries a single global λ
    return LogisticProblem(
        X=torch.from_numpy(np.ascontiguousarray(Xs)).to(dev),
        y=torch.from_numpy(np.ascontiguousarray(ys)).to(dev),
        lam=lam / n, batch=batch)


@dataclasses.dataclass(frozen=True)
class LMProblem:
    """A transformer LM as a flat-substrate GradProvider on ``device``."""

    cfg: Any                    # models.config.ModelConfig
    shard: LMShardConfig
    spec: RavelSpec
    params0: dict               # init tree (CPU), the x0 every node gets
    eval_tokens: np.ndarray     # (Be, S) int32 held-out batch
    eval_labels: np.ndarray     # (Be, S) int32
    device: torch.device

    @property
    def n(self) -> int:
        return self.shard.n_nodes

    @property
    def p(self) -> int:
        return self.spec.p

    @property
    def x0_flat(self) -> torch.Tensor:
        return ravel(self.spec, self.params0).to(self.device)

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        """One node batch of ``(B, S+1)`` tokens from ``gen`` (drawn on
        the CPU, so every device sees the same tokens)."""
        sh = self.shard
        shape = (sh.batch_per_node, sh.seq_len + 1)
        if sh.zipf <= 0:
            toks = torch.randint(0, sh.vocab, shape, generator=gen)
        else:
            cdf = torch.from_numpy(np.cumsum(
                zipf_probs(sh.vocab, sh.zipf)).astype(np.float32))
            u = torch.rand(shape, generator=gen)
            toks = torch.searchsorted(cdf, u).clamp_(0, sh.vocab - 1)
        return toks.to(self.device)

    def grad_fn(self):
        from ..models.transformer import loss_fn
        cfg = self.cfg
        return ModelGradProvider(
            spec=self.spec, n_nodes=self.n,
            loss_fn=lambda prms, toks, _g: loss_fn(cfg, prms, toks[:, :-1],
                                                   toks[:, 1:]),
            batch_fn=lambda _i, gen: self.sample(gen),
        ).grad_fn()

    @torch.no_grad()
    def evaluate(self, x_flat: torch.Tensor) -> tuple[float, float]:
        """(loss, next-token accuracy) of ``x_flat`` on the eval batch."""
        from ..models.transformer import forward
        x = x_flat.to(self.device, torch.float32)
        toks = torch.from_numpy(self.eval_tokens).to(self.device)
        labels = torch.from_numpy(self.eval_labels).to(self.device).long()
        logits, aux = forward(self.cfg, unravel(self.spec, x), toks)
        lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
        tgt = torch.gather(logits, -1, labels[..., None])[..., 0]
        loss = (lse - tgt.to(torch.float32)).mean() + aux
        acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        return float(loss), float(acc)

    def mean_loss(self, x_flat: torch.Tensor) -> float:
        return self.evaluate(x_flat)[0]


def make_lm_problem(
    cfg: Any, n_nodes: int, *, batch_per_node: int = 4, seq_len: int = 32,
    eval_batch: int = 16, zipf: float = 1.2, seed: int = 0,
    pad_to: int = 128, device=None,
) -> LMProblem:
    """Build an :class:`LMProblem` on ``device`` (``cuda`` unless the
    caller asks for another); the initial weights come from a
    ``torch.Generator`` seeded with ``seed``."""
    from ..models.transformer import init_params
    dev = resolve_device(device)
    shard = LMShardConfig(vocab=cfg.vocab, batch_per_node=batch_per_node,
                          seq_len=seq_len, n_nodes=n_nodes, seed=seed,
                          zipf=zipf)
    params0 = init_params(cfg, torch.Generator().manual_seed(seed))
    spec = make_ravel_spec(params0, pad_to=pad_to)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x0E7A1]))
    shape = (eval_batch, seq_len + 1)
    if zipf > 0:
        toks = rng.choice(cfg.vocab, size=shape,
                          p=zipf_probs(cfg.vocab, zipf))
    else:
        toks = rng.integers(0, cfg.vocab, shape)
    return LMProblem(
        cfg=cfg, shard=shard, spec=spec, params0=params0,
        eval_tokens=np.asarray(toks[:, :-1], np.int32),
        eval_labels=np.asarray(toks[:, 1:], np.int32),
        device=dev)
