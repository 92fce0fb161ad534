"""Baseline algorithms the paper compares against (Table II / Fig. 5-6).

Counterpart of ``src/repro/core/baselines.py``.

Synchronous: Ring-AllReduce SGD [12], D-PSGD [14], S-AB [17] (two-matrix
synchronous gradient tracking — the synchronous push-pull recursion (2)),
plus ``push_pull_sync`` itself (eq. (2), the deterministic ancestor of
R-FAST).

Asynchronous: AD-PSGD [22] (atomic pairwise averaging + stale gradients)
and OSGP [23] (overlap stochastic gradient push: push-sum with mailbox
accumulation and non-blocking sends).

All baselines share the engines' ``grad_fn(node, x, gen)`` interface
and the :class:`~repro_torch.core.scenario.NetworkScenario` virtual
clock, so time-to-loss comparisons against R-FAST are apples-to-apples:
synchronous rounds pay the barrier (slowest node + retransmitted edges),
asynchronous events follow the same per-node clocks, and every packet
crosses the same lossy, delayed channels (DESIGN.md §7).  The host
passes — AD-PSGD's partner draws from ``default_rng(seed + 7)``, its
channel draws, mix gate and ring slots, OSGP's edge tables and stamp
slots — are the reference's, line for line, so both packages build the
same tables; the device steps are PyTorch loops over rounds or events.

Generators, not keys: the gradient of synchronous round ``t`` at node
``i`` draws from ``event_generator(seed, t, i)``, that of asynchronous
event ``k`` at agent ``a`` from ``event_generator(seed, k, a)``, and
push-pull's initial gradients from ``event_generator(seed, -1, i)``.
The reference's ``jax.random`` keys cannot be reproduced, so parity
with it holds on key-free objectives.  No baseline runs a kernel (the
reference's run jnp only).

``eval_fn`` contract (uniform across baselines): ``eval_fn(x, t)`` where
``x`` is the algorithm's iterate — ``(n, p)`` per-node models, or ``(p,)``
for the single-model Ring-AllReduce — and ``t`` the virtual time.
Every runner places its state on ``device`` (``cuda`` unless the caller
asks for another).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.rfast_update import dispatch
from .protocol import descent_step, tracking_step
from .scenario import NetworkScenario
from .simulator import event_generator
from .topology import Topology

__all__ = [
    "run_push_pull_sync",
    "run_ring_allreduce",
    "run_dpsgd",
    "run_sab",
    "run_adpsgd",
    "run_osgp",
    "metropolis_weights",
]


def metropolis_weights(topo: Topology) -> np.ndarray:
    """Doubly-stochastic weights for an undirected graph (D-PSGD)."""
    n = topo.n
    adj = ((topo.W > 0) | (topo.W.T > 0)) & ~np.eye(n, dtype=bool)
    deg = adj.sum(axis=1)
    Wm = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if adj[i, j]:
                Wm[i, j] = 1.0 / (1 + max(deg[i], deg[j]))
        Wm[i, i] = 1.0 - Wm[i].sum()
    return Wm


def _nodes_x0(x0, n: int, device) -> torch.Tensor:
    """``x0`` as an ``(n, p)`` float32 stack on ``device``."""
    x0 = torch.as_tensor(x0).to(device=device, dtype=torch.float32)
    return x0.expand(n, -1).clone() if x0.dim() == 1 else x0.clone()


def _vgrads(grad_fn, x: torch.Tensor, seed: int, t: int) -> torch.Tensor:
    """Every node's gradient at its row of ``x``, node ``i`` drawing
    from ``event_generator(seed, t, i)``."""
    return torch.stack([grad_fn(i, x[i], event_generator(seed, t, i))
                        for i in range(x.shape[0])])


# --------------------------------------------------------------------- #
# synchronous baselines
# --------------------------------------------------------------------- #
def _sync_times(scenario, topo_or_n, rounds: int, seed: int,
                times: np.ndarray | None) -> np.ndarray:
    if times is not None:
        return np.asarray(times, np.float64)
    sc = scenario if scenario is not None else NetworkScenario()
    return sc.sync_round_times(topo_or_n, rounds, seed=seed)


def _run_rounds(round_fn, carry, rounds: int, eval_every: int, eval_fn,
                times: np.ndarray, extract=lambda c: c):
    """Drive ``rounds`` rounds, ``round_fn(carry, t)``; ``eval_fn``
    always receives the *iterate* (``extract(carry)``), never the raw
    carry."""
    metrics: list[dict] = []
    for t in range(rounds):
        carry = round_fn(carry, t)
        if eval_fn is not None and (t + 1) % eval_every == 0:
            m = eval_fn(extract(carry), float(times[t]))
            m["round"] = t + 1
            metrics.append(m)
    return carry, metrics


def run_push_pull_sync(
    topo: Topology, grad_fn, x0: torch.Tensor, gamma: float,
    rounds: int, *, scenario: NetworkScenario | None = None, seed: int = 0,
    eval_every: int = 10, eval_fn=None, times: np.ndarray | None = None,
    device=None,
):
    """Synchronous push-pull (eq. 2): the paper's S-AB-style ancestor.

    x^{t+1} = W (x^t − γ z^t);  z^{t+1} = A z^t + ∇F(x^{t+1}) − ∇F(x^t).

    The per-round formulas are the protocol core's S.1/S.2b steps in
    matrix form (``recv = 0``: mixing happens through A z, not running
    sums) — eq. (2) is the all-delivered, zero-delay limit of R-FAST.
    """
    device = dispatch.resolve_device(device)
    n = topo.n
    W = torch.as_tensor(topo.W, dtype=torch.float32, device=device)
    A = torch.as_tensor(topo.A, dtype=torch.float32, device=device)
    x0 = _nodes_x0(x0, n, device)
    g0 = _vgrads(grad_fn, x0, seed, -1)
    times = _sync_times(scenario, topo, rounds, seed, times)

    def round_fn(carry, t):
        x, z, g = carry
        x_new = W @ descent_step(x, z, gamma)                  # S.1 + S.2a
        g_new = _vgrads(grad_fn, x_new, seed, t)
        z_new = tracking_step(A @ z, 0.0, g_new, g)            # S.2b
        return (x_new, z_new, g_new)

    carry, metrics = _run_rounds(round_fn, (x0, g0, g0), rounds, eval_every,
                                 eval_fn, times, extract=lambda c: c[0])
    return carry[0], metrics


def run_sab(topo: Topology, grad_fn, x0, gamma, rounds, **kw):
    """S-AB [17]: synchronous stochastic gradient tracking with a
    row-stochastic and a column-stochastic matrix — identical recursion to
    synchronous push-pull over a strongly-connected digraph."""
    return run_push_pull_sync(topo, grad_fn, x0, gamma, rounds, **kw)


def run_ring_allreduce(
    n: int, grad_fn, x0: torch.Tensor, gamma: float, rounds: int,
    *, scenario: NetworkScenario | None = None, seed: int = 0,
    eval_every: int = 10, eval_fn=None, times: np.ndarray | None = None,
    device=None,
):
    """Ring-AllReduce SGD: exact gradient average per round (single model).

    The barrier clock runs over the n-edge directed ring (the reduce/
    broadcast path), so stragglers, losses and crashes stall every round.
    """
    device = dispatch.resolve_device(device)
    x0 = torch.as_tensor(x0).to(device=device, dtype=torch.float32)
    if x0.dim() == 2:
        x0 = x0[0]
    times = _sync_times(scenario, n, rounds, seed, times)

    def round_fn(x, t):
        g = _vgrads(grad_fn, x.expand(n, -1), seed, t)
        return x - gamma * g.mean(dim=0)

    return _run_rounds(round_fn, x0.clone(), rounds, eval_every, eval_fn,
                       times)


def run_dpsgd(
    topo: Topology, grad_fn, x0: torch.Tensor, gamma: float,
    rounds: int, *, scenario: NetworkScenario | None = None, seed: int = 0,
    eval_every: int = 10, eval_fn=None, times: np.ndarray | None = None,
    device=None,
):
    """D-PSGD [14]: x^{t+1} = W̄ x^t − γ ∇F(x^t), W̄ doubly stochastic."""
    device = dispatch.resolve_device(device)
    Wm = torch.as_tensor(metropolis_weights(topo), dtype=torch.float32,
                         device=device)
    x0 = _nodes_x0(x0, topo.n, device)
    times = _sync_times(scenario, topo, rounds, seed, times)

    def round_fn(x, t):
        g = _vgrads(grad_fn, x, seed, t)
        return Wm @ x - gamma * g

    return _run_rounds(round_fn, x0, rounds, eval_every, eval_fn, times)


# --------------------------------------------------------------------- #
# asynchronous baselines (event loops on the scenario clock)
# --------------------------------------------------------------------- #
def run_adpsgd(
    topo: Topology, grad_fn, x0: torch.Tensor, gamma: float, K: int,
    *, scenario: NetworkScenario | None = None, staleness: int = 2,
    seed: int = 0, eval_every: int = 0, eval_fn=None, device=None,
):
    """AD-PSGD [22]: event-driven atomic pairwise averaging + stale grads.

    On the scenario clock: active node a picks a random (undirected)
    neighbour b and atomically averages with the *freshest delivered*
    copy of b's model (the schedule's per-edge payload stamps — latency
    makes the mixed value stale, exactly like R-FAST's consensus reads);
    b symmetrically averages with its delivered copy of a.  The exchange
    is dropped whole when either direction's packet is lost or the
    partner is inside a crash window.  The descent then applies a
    gradient evaluated at a's model of ``staleness`` events ago.
    """
    device = dispatch.resolve_device(device)
    n = topo.n
    rng = np.random.default_rng(seed + 7)
    scenario = scenario if scenario is not None else NetworkScenario()
    trace = scenario.realize(topo, K, seed=seed)
    sched = trace.schedule
    agent, times = sched.agent, sched.times

    edges_w = topo.edges_W()
    eidx = {ji: e for e, ji in enumerate(edges_w)}
    nbrs = {i: sorted(set(topo.in_neighbors_W(i) + topo.out_neighbors_W(i)))
            for i in range(n)}
    # the ring must cover the partner-view reads too: the a->b stamp is
    # only refreshed when b wakes, so between b's wakes its staleness is
    # NOT bounded by sched.D (which measures active-agent reads only).
    # Clamp those stamps to the scenario's Assumption-3(ii) bound D_max —
    # the same forced delivery realize() applies at consumption — and
    # size the ring to match.
    d_max = scenario.resolved_D_max(n)
    H = max(staleness + 1, d_max + 2)
    ch = scenario.channels(len(edges_w), rng)

    # host pass: partner choice, mixing gate (both channel directions +
    # partner liveness), and the hist slots of the delivered payloads
    partner = np.zeros(K, np.int32)
    mixed = np.zeros(K, bool)
    slot_ba = np.zeros(K, np.int32)     # b's state as delivered to a
    slot_ab = np.zeros(K, np.int32)     # a's state as delivered to b
    for k in range(K):
        a = int(agent[k])
        if not nbrs[a]:
            partner[k] = a
            continue
        b = nbrs[a][rng.integers(len(nbrs[a]))]
        partner[k] = b
        e_ba, e_ab = eidx.get((b, a)), eidx.get((a, b))
        ok = not scenario.in_failure(b, float(times[k]))
        for e in (e_ba, e_ab):
            if e is not None:
                ok = ch.ok(e) and ok       # draw both; burst state advances
        mixed[k] = ok
        # stamp s = state after global event s-1, written at hist slot s%H;
        # a missing direction falls back to the current snapshot (slot k%H)
        s_ba = sched.stamp_v[k, e_ba] if e_ba is not None else k
        s_ab = sched.stamp_v[k, e_ab] if e_ab is not None else k
        s_ba = max(int(s_ba), k - d_max)
        s_ab = max(int(s_ab), k - d_max)
        if k - min(s_ba, s_ab) > H - 2:
            raise RuntimeError("AD-PSGD ring slots would alias")
        slot_ba[k] = s_ba % H
        slot_ab[k] = s_ab % H

    x = _nodes_x0(x0, n, device)
    x_hist = x[None].repeat(H, 1, 1)
    metrics: list[dict] = []
    ee = eval_every if eval_every > 0 else K
    for s in range(0, K, ee):
        e = min(K, s + ee)
        for k in range(s, e):
            a, b = int(agent[k]), int(partner[k])
            if mixed[k]:
                x_a = 0.5 * (x[a] + x_hist[int(slot_ba[k]), b])  # b as a saw it
                x_b = 0.5 * (x[b] + x_hist[int(slot_ab[k]), a])  # a as b saw it
            else:
                x_a, x_b = x[a].clone(), x[b].clone()
            # the state after m events lives at hist slot m % H, so
            # `staleness` events ago = slot (k - staleness) % H
            g = grad_fn(a, x_hist[(k - staleness) % H, a],
                        event_generator(seed, k, a))
            x[b] = x_b
            x[a] = x_a - gamma * g
            x_hist[(k + 1) % H] = x
        if eval_fn is not None:
            m = eval_fn(x, float(times[e - 1]))
            m["k"] = e
            metrics.append(m)
    return x, metrics


def run_osgp(
    topo: Topology, grad_fn, x0: torch.Tensor, gamma: float, K: int,
    *, scenario: NetworkScenario | None = None, seed: int = 0,
    eval_every: int = 0, eval_fn=None, device=None,
):
    """OSGP [23]: overlap stochastic gradient push (async push-sum).

    Node state (x_i, w_i).  On wake: consume the arrived mailbox mass,
    de-bias ẑ = x/w, descend, then push column-stochastic shares to
    out-neighbour mailboxes (non-blocking).  On the scenario clock the
    mailboxes are per-edge *cumulative* streams read at the schedule's
    payload stamps — latency delays mass, and a lost packet's share is
    excluded from the stream forever (push-sum has no retransmission:
    the mass is gone — exactly the robustness gap R-FAST's running sums
    close; R-FAST's ρ streams are cumulative at the *algorithm* level,
    so a later arrival re-delivers everything).
    """
    device = dispatch.resolve_device(device)
    n = topo.n
    scenario = scenario if scenario is not None else NetworkScenario()
    trace = scenario.realize(topo, K, seed=seed)
    sched = trace.schedule
    agent, times = sched.agent, sched.times

    edges_a = topo.edges_A()
    E1 = max(1, len(edges_a))
    H = sched.D + 2
    src = np.zeros(E1, np.int32)
    dst = np.full(E1, -1, np.int32)      # -1 on pads: matches no agent
    wt = np.zeros(E1, np.float32)
    for e, (j, i) in enumerate(edges_a):
        src[e], dst[e], wt[e] = j, i, topo.A[i, j]
    src[len(edges_a):] = -1
    a_diag = np.diag(topo.A).astype(np.float32)
    rslot = (sched.stamp_rho % H).astype(np.int32)            # (K, E1)
    send_ok = trace.send_ok_a                                  # (K, E1)
    # each agent's in- and out-edges (the reference masks all E1 rows)
    dev_i64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    e_in = [dev_i64(np.nonzero(dst == a)[0]) for a in range(n)]
    e_out = [np.nonzero(src == a)[0].tolist() for a in range(n)]
    rslot = dev_i64(rslot)

    x = _nodes_x0(x0, n, device)
    p = x.shape[1]
    f32 = dict(dtype=torch.float32, device=device)
    w = torch.ones(n, **f32)
    cum_x, cum_w = torch.zeros(E1, p, **f32), torch.zeros(E1, **f32)
    cons_x, cons_w = torch.zeros(E1, p, **f32), torch.zeros(E1, **f32)
    hist_x, hist_w = torch.zeros(H, E1, p, **f32), torch.zeros(H, E1, **f32)
    debias = lambda: x / torch.clamp_min(w[:, None], 1e-8)
    metrics: list[dict] = []
    ee = eval_every if eval_every > 0 else K
    for s in range(0, K, ee):
        e = min(K, s + ee)
        for k in range(s, e):
            a = int(agent[k])
            # consume: cumulative stream at the delivered stamp, minus
            # what this receiver already took (the receiver-side ρ̃ idiom)
            ei = e_in[a]
            rs = rslot[k, ei]
            vals_x, vals_w = hist_x[rs, ei], hist_w[rs, ei]
            mx = torch.sum(vals_x - cons_x[ei], dim=0)
            mw = torch.sum(vals_w - cons_w[ei])
            cons_x[ei] = vals_x
            cons_w[ei] = vals_w
            x_a = x[a] + mx
            w_a = w[a] + mw
            # de-biased gradient step
            g = grad_fn(a, x_a / torch.clamp_min(w_a, 1e-8),
                        event_generator(seed, k, a))
            x_a = x_a - gamma * w_a * g
            # push shares: delivered packets extend the stream, lost ones
            # never enter it (their mass is gone)
            for eo in e_out[a]:
                if send_ok[k, eo]:
                    cum_x[eo] += float(wt[eo]) * x_a
                    cum_w[eo] += float(wt[eo]) * w_a
            x[a] = float(a_diag[a]) * x_a
            w[a] = float(a_diag[a]) * w_a
            hist_x[(k + 1) % H] = cum_x
            hist_w[(k + 1) % H] = cum_w
        if eval_fn is not None:
            m = eval_fn(debias(), float(times[e - 1]))
            m["k"] = e
            metrics.append(m)
    return debias(), metrics
