"""The comparison that decides ``correct``.

Three numbers, each a worst case over nodes (and over leaves: a leaf is
one weight tensor of the model):

* ``loss_gap`` — every loss the checked steps computed (the paper init's
  and each step's, every node), ``|program − reference| / |reference|``;
* ``grad_gap`` — the norm of each leaf of the gradient a node holds after
  the first checked step, ``|‖program‖ − ‖reference‖|`` over the larger of
  the reference leaf's norm and the node's median leaf norm;
* ``change_gap`` — the same of each leaf of the parameters' change from
  the start to the end of the checked steps.

Leaves whose reference gradient is under a thousandth of the node's
median leaf are left out of both leaf numbers (their change is round-off,
not training).  A side that gave no number, or numbers of another shape,
reads infinity.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["gaps", "judge", "NAMES"]

NAMES = ("loss_gap", "grad_gap", "change_gap")


def _leaf_gap(p, r, rg) -> float:
    if p is None or r is None or np.shape(p) != np.shape(r):
        return math.inf
    p, r, rg = (np.asarray(a, np.float64) for a in (p, r, rg))
    worst = 0.0
    for i in range(r.shape[0]):
        keep = rg[i] >= 1e-3 * np.median(rg[i])
        med = np.median(r[i][keep])
        gap = np.abs(p[i][keep] - r[i][keep]) / np.maximum(r[i][keep], med)
        worst = max(worst, float(np.max(gap)))
    return worst if math.isfinite(worst) else math.inf


def gaps(prog, ref) -> dict[str, float]:
    """The three numbers of ``prog`` against ``ref`` (``Observed``)."""
    lp, lr = np.asarray(prog.losses), np.asarray(ref.losses)
    if lp.shape != lr.shape or lp.size == 0:
        loss = math.inf
    else:
        loss = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    out = {"loss_gap": loss,
           "grad_gap": _leaf_gap(prog.grad, ref.grad, ref.grad),
           "change_gap": _leaf_gap(prog.change, ref.change, ref.grad)}
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def judge(values: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every number at or under its limit, and
    ``{name: {"value", "limit"}}``."""
    checks = {k: {"value": values[k], "limit": limits[k]["limit"]}
              for k in NAMES}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
