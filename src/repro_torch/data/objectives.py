"""The LM objective on the flat substrate.

Counterpart of ``LMProblem`` / ``make_lm_problem`` in
``src/repro/data/objectives.py``.  Each node owns a Zipfian synthetic
shard; ``grad_fn`` views the flat lane as the parameter tree, draws the
node's batch from the per-(event, node) generator, runs
:func:`repro_torch.models.transformer.loss_fn` and differentiates back
to the lane.  ``evaluate`` / ``mean_loss`` score a fixed held-out batch
made with numpy exactly as the JAX package makes it, so both packages
evaluate on the same tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.paramvec import (ModelGradProvider, RavelSpec, make_ravel_spec,
                             ravel, unravel)
from .pipeline import LMShardConfig, zipf_probs

__all__ = ["LMProblem", "make_lm_problem"]


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
    pad_to: int = 128, device="cpu",
) -> LMProblem:
    """Build an :class:`LMProblem`; the initial weights come from a
    ``torch.Generator`` seeded with ``seed``."""
    from ..models.transformer import init_params
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
        device=torch.device(device))
