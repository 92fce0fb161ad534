"""Plain PyTorch reference of R-FAST (the paper's Algorithm 2).

Written from the paper, independent of the program under test.  Every
node i holds its parameters x_i, its descent point v_i, its tracked
direction z_i and its last gradient g_i as flat rows; every edge
e = (j → i) of the push graph G(A) holds the sender's running sum ρ_e and
the receiver's buffer ρ̃_e; in the synchronous robust round every edge of
the pull graph G(W) holds the receiver's mailbox of v_j.  One update of
node i with step γ:

  S.1   v_i  = x_i − γ z_i
  S.2a  x_i' = W_ii v_i + Σ_j W_ij v_j              (the v_j it received)
  S.2b  g'   = ∇f_i(x_i');  z½ = z_i + Σ_e (ρ_e − ρ̃_e) + g' − g_i
  S.2c  z_i' = A_ii z½;  ρ_e += A_ji z½ on each out-edge e = (i → j)
  S.4   ρ̃_e ← the ρ_e it received

:func:`sync_rounds` runs all nodes at once, each edge delivering or not
by a 0/1 mask per round (a lost v keeps the mailbox, a lost ρ keeps the
buffer).  :func:`async_events` runs one node per event, reading what its
in-neighbours had sent at the event's payload stamps: stamp s is the
state after event s − 1, stamp 0 the initial state (v = 0, ρ = 0).

Both take ``grad(node, x, step) -> (loss, g)`` and return what the
benchmark compares: every loss, and the per-node rows it asks for.
"""
from __future__ import annotations

import torch

__all__ = ["edges", "sync_rounds", "async_events"]


def edges(M) -> list[tuple[int, int]]:
    """Off-diagonal edges (j, i) of a weight matrix, j sending to i, in
    row-major order of the receiver."""
    n = len(M)
    return [(j, i) for i in range(n) for j in range(n)
            if i != j and M[i][j] > 0]


def sync_rounds(W, A, x0: torch.Tensor, grad, gamma: float, masks,
                rounds: int, *, observe):
    """``rounds`` synchronous robust rounds from the paper init (x_i = x0,
    z_i = g_i = ∇f_i(x0) at step 0).  ``masks[r][e]`` (0/1) delivers
    W-edge e and A-edge e in round r + 1 (edges in :func:`edges`
    order).  ``observe(r, state)`` sees the state ``{x, z, g}`` (lists of
    rows) after the init (r = 0) and after each round; returns the list
    of losses, init first, each a list over nodes."""
    n = len(W)
    ew, ea = edges(W), edges(A)
    first = [grad(i, x0, 0) for i in range(n)]
    losses = [[float(l) for l, _ in first]]
    x = [x0.clone() for _ in range(n)]
    z = [g for _, g in first]
    g = [t.clone() for t in z]
    del first
    rho = [torch.zeros_like(x0) for _ in ea]
    buf = [torch.zeros_like(x0) for _ in ea]
    mail = [torch.zeros_like(x0) for _ in ew]
    observe(0, {"x": x, "z": z, "g": g})
    for r in range(1, rounds + 1):
        m = [float(v) for v in masks[r - 1]]
        v = [x[i] - gamma * z[i] for i in range(n)]
        for e, (j, i) in enumerate(ew):
            if m[e]:
                mail[e] = v[j].clone()
        new_x = []
        for i in range(n):
            xi = W[i][i] * v[i]
            for e, (j, dst) in enumerate(ew):
                if dst == i:
                    xi = xi + W[i][j] * mail[e]
            new_x.append(xi)
        del v
        x = new_x
        new_g, step_losses = [], []
        for i in range(n):
            loss, gi = grad(i, x[i], r)
            new_g.append(gi)
            step_losses.append(float(loss))
        losses.append(step_losses)
        half = []
        for i in range(n):
            recv = torch.zeros_like(x0)
            for e, (j, dst) in enumerate(ea):
                if dst == i and m[e]:
                    recv += rho[e] - buf[e]
            half.append(z[i] + recv + new_g[i] - g[i])
        for e in range(len(ea)):
            if m[e]:
                buf[e] = rho[e].clone()
        for e, (j, i) in enumerate(ea):
            rho[e] = rho[e] + A[i][j] * half[j]
        z = [A[i][i] * half[i] for i in range(n)]
        g = new_g
        del half
        observe(r, {"x": x, "z": z, "g": g})
    return losses


def async_events(W, A, x0: torch.Tensor, grad, gamma: float, agent,
                 stamp_v, stamp_rho, events: int, *, observe):
    """The first ``events`` events of an asynchronous schedule from the
    paper init: event k runs ``agent[k]``, whose in-edge e reads the
    sender's v (G(W)) or running sum ρ_e (G(A)) as they were after event
    ``stamp[k][e] − 1``.  ``observe(k, state)`` sees ``{x, z, g}`` after
    the init (k = 0) and after event k − 1 (k = 1..events).  Returns the
    losses: the init's (one a node), then one an event."""
    n = len(W)
    ew, ea = edges(W), edges(A)
    # the payloads these events read, kept as they were written
    want_v = {(int(stamp_v[k][e]), j) for k in range(events)
              for e, (j, i) in enumerate(ew) if i == agent[k]}
    want_r = {(int(stamp_rho[k][e]), e) for k in range(events)
              for e, (j, i) in enumerate(ea) if i == agent[k]}
    first = [grad(i, x0, -1) for i in range(n)]
    losses = [float(l) for l, _ in first]
    x = [x0.clone() for _ in range(n)]
    v = [torch.zeros_like(x0) for _ in range(n)]
    z = [g for _, g in first]
    g = [t.clone() for t in z]
    del first
    rho = [torch.zeros_like(x0) for _ in ea]
    buf = [torch.zeros_like(x0) for _ in ea]
    sent_v, sent_r = {}, {}

    def keep(s: int) -> None:
        for j in range(n):
            if (s, j) in want_v:
                sent_v[s, j] = v[j].clone()
        for e in range(len(ea)):
            if (s, e) in want_r:
                sent_r[s, e] = rho[e].clone()

    keep(0)
    observe(0, {"x": x, "z": z, "g": g})
    for k in range(events):
        a = int(agent[k])
        v_new = x[a] - gamma * z[a]
        xa = W[a][a] * v_new
        for e, (j, i) in enumerate(ew):
            if i == a:
                xa = xa + W[a][j] * sent_v[int(stamp_v[k][e]), j]
        loss, gn = grad(a, xa, k)
        losses.append(float(loss))
        half = z[a] + gn - g[a]
        for e, (j, i) in enumerate(ea):
            if i == a:
                got = sent_r[int(stamp_rho[k][e]), e]
                half = half + got - buf[e]
                buf[e] = got.clone()
        for e, (j, i) in enumerate(ea):
            if j == a:
                rho[e] = rho[e] + A[i][a] * half
        x[a], v[a], z[a], g[a] = xa, v_new, A[a][a] * half, gn
        del half
        keep(k + 1)
        observe(k + 1, {"x": x, "z": z, "g": g})
    return losses
