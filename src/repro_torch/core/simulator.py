"""Global-view (Algorithm 2) R-FAST engine, wavefront mode.

Counterpart of ``src/repro/core/simulator.py`` (``mode="wavefront"``).
The schedule is compiled on the host
(:func:`repro_torch.core.schedule.build_wavefront_plan`) into waves of
events with distinct agents whose payload stamps predate the wave; each
wave runs the per-agent update for all its lanes at once and commits
O(p) delta rows into the history rings.  The formulas live in
:mod:`repro_torch.core.protocol`.

What differs from the JAX engine, and why:

* **No scan, no padding to a chunk shape.** PyTorch runs eagerly, so a
  chunk is a Python loop over its waves, each wave only as wide as its
  real lanes.  Pad lanes (agent ``n``) are dropped on the host: they
  compute no gradient and commit nothing.
* **Commits are row copies.** JAX scatters with ``mode="drop"`` to skip
  sentinel rows; torch indexing would fault on them.  The commit writes
  each valid row with its own in-place copy, chosen from the host-side
  numpy tables, so a sentinel never reaches the device and no device
  mask is built (which would synchronise every wave).  The wave's new
  values are computed out of place first, so the order of the copies
  does not matter.
* **Generators, not keys.** The gradient of event ``k`` at node ``i``
  draws from a ``torch.Generator`` seeded from ``(seed, k, i)``
  (``k = -1`` for the initial gradients); ``wf.kidx`` carries ``k``.
* **In-place state.** The packed state is updated in place (the JAX
  engine donates it); :func:`unpack_state` returns views into it.

Two commit backends, selected with ``impl``:

* ``"kernel"`` (default) — ONE :func:`~repro_torch.kernels.rfast_update.
  grid.commit_grid` launch per wave, gathering z, g_prev, the ρ-history
  payloads, ρ̃ and ρ-out rows from the flat packed state itself;
* ``"plain"`` — the scatter/gather path in PyTorch ops.

State layout (flat parameter vectors, ``p`` = dimension):

* ``nodes``    — (n, 4, p): rows x, v, z, g_prev per node;
* ``rho2``     — (2·E_A, p): ρ rows then ρ̃ rows;
* ``v_hist``   — (H, n, p) delta rows (writer count mod H, node);
* ``rho_hist`` — (H, E_A, p) delta rows (sender count mod H, edge).

Mass-conservation invariant (Lemma 3)::

    Σ_i z_i + Σ_e (ρ_e − ρ̃_e)  ==  Σ_i ∇f_i(x_i^k; ζ_i^k)
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.rfast_update import dispatch
from ..kernels.rfast_update.grid import commit_grid
from .paramvec import as_grad_fn
from .plan import CommPlan, as_comm_plan
from .protocol import consensus_mix, descent_step, tracking_step
from .schedule import Schedule, build_wavefront_plan, grid_gather_tables
from .topology import Topology

__all__ = ["RFASTState", "PackedState", "init_state", "init_packed",
           "zeros_state", "pack_state", "unpack_state", "wave_inputs",
           "event_generator", "run_rfast", "tracked_mass", "IMPLS"]

IMPLS = ("kernel", "plain")


class RFASTState(NamedTuple):
    k: int
    x: torch.Tensor        # (n, p)
    v: torch.Tensor        # (n, p)
    z: torch.Tensor        # (n, p)
    g_prev: torch.Tensor   # (n, p)
    rho: torch.Tensor      # (E_A, p)
    rho_buf: torch.Tensor  # (E_A, p)
    v_hist: torch.Tensor   # (H, n, p)
    rho_hist: torch.Tensor # (H, E_A, p)


class PackedState(NamedTuple):
    """Device layout of the wavefront engine (see the module docstring)."""

    nodes: torch.Tensor
    rho2: torch.Tensor
    v_hist: torch.Tensor
    rho_hist: torch.Tensor


def event_generator(seed: int, k: int, node: int) -> torch.Generator:
    """The CPU generator of event ``k`` at ``node`` (``k = -1``: the
    initial gradient).  CPU, so a run draws the same numbers on any
    device."""
    s = np.random.SeedSequence([int(seed), int(k) + 1, int(node)])
    return torch.Generator().manual_seed(
        int(s.generate_state(1, np.uint64)[0]) >> 1)


def _zeros_packed(n: int, e_a: int, p: int, H: int,
                  device) -> PackedState:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return PackedState(nodes=z(n, 4, p), rho2=z(2 * e_a, p),
                       v_hist=z(H, n, p), rho_hist=z(H, e_a, p))


def init_packed(topo: Topology | CommPlan, x0: torch.Tensor, grad_fn,
                H: int, *, seed: int = 0) -> PackedState:
    """Paper init in the packed layout, on ``x0``'s device:
    x = x0, z = g_prev = ∇f_i(x_i^0; ζ_i^0), everything else zero.
    ``x0`` is ``(p,)`` (broadcast to every node) or ``(n, p)``."""
    grad_fn = as_grad_fn(grad_fn)
    plan = as_comm_plan(topo)
    n = plan.n
    p = int(x0.shape[-1])
    st = _zeros_packed(n, max(1, plan.n_edges_a), p, H, x0.device)
    x = st.nodes[:, 0]
    x.copy_(x0.to(torch.float32).expand(n, p))
    for i in range(n):
        g = grad_fn(i, x[i], event_generator(seed, -1, i))
        st.nodes[i, 2].copy_(g)
        st.nodes[i, 3].copy_(g)
    return st


def init_state(topo: Topology | CommPlan, x0: torch.Tensor, grad_fn,
               H: int, *, seed: int = 0) -> RFASTState:
    """:func:`init_packed` seen as an :class:`RFASTState` (views)."""
    return unpack_state(init_packed(topo, x0, grad_fn, H, seed=seed), 0)


def zeros_state(topo: Topology | CommPlan, p: int, H: int, *,
                device="cpu") -> RFASTState:
    """All-zeros state of a run over ``topo`` at dimension ``p``."""
    plan = as_comm_plan(topo)
    return unpack_state(
        _zeros_packed(plan.n, max(1, plan.n_edges_a), p, H, device), 0)


def pack_state(state: RFASTState) -> PackedState:
    """Copy an :class:`RFASTState` into a new packed layout."""
    return PackedState(
        nodes=torch.stack([state.x, state.v, state.z, state.g_prev], dim=1),
        rho2=torch.cat([state.rho, state.rho_buf], dim=0),
        v_hist=state.v_hist.clone(), rho_hist=state.rho_hist.clone())


def unpack_state(packed: PackedState, k: int) -> RFASTState:
    """The packed state as an :class:`RFASTState` of views (no copies:
    the next wave overwrites them, so keep copies of what you need)."""
    e_a = packed.rho_hist.shape[1]
    return RFASTState(
        k=int(k), x=packed.nodes[:, 0], v=packed.nodes[:, 1],
        z=packed.nodes[:, 2], g_prev=packed.nodes[:, 3],
        rho=packed.rho2[:e_a], rho_buf=packed.rho2[e_a:],
        v_hist=packed.v_hist, rho_hist=packed.rho_hist)


def tracked_mass(state: RFASTState) -> torch.Tensor:
    """LHS of the Lemma-3 invariant: Σ_i z_i + Σ_e (ρ_e − ρ̃_e)."""
    return state.z.sum(dim=0) + (state.rho - state.rho_buf).sum(dim=0)


class _WaveInputs(NamedTuple):
    """One wave's lane tables, cut to its real lanes: device tensors for
    the gathers and the kernel, host arrays for the row commits."""

    agent: torch.Tensor      # (s,)
    w_self: torch.Tensor     # (s,)
    a_self: torch.Tensor     # (s,)
    rslot_v: torch.Tensor    # (s, kw)
    src_v: torch.Tensor      # (s, kw)
    w_in: torch.Tensor       # (s, kw)
    rslot_rho: torch.Tensor  # (s, ka)
    hist_epos: torch.Tensor  # (s, ka)
    a_val: torch.Tensor      # (s, ka)
    rho_read: torch.Tensor   # (s, ko+ka) rho_gidx clamped into range
    out_wt: torch.Tensor     # (s, ko)
    grid: tuple              # commit_grid's five row tables
    agent_h: np.ndarray      # (s,)
    wslot_h: np.ndarray      # (s,)
    rho_gidx_h: np.ndarray   # (s, ko+ka) with sentinel 2·e_a
    kidx_h: np.ndarray       # (s,) event index of each lane


def wave_inputs(wf, plan: CommPlan, device) -> list[_WaveInputs]:
    """Per-wave lane tables of a WavefrontPlan.  Every device table is
    moved once for the whole plan; a wave's tables are views of it."""
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    i64 = lambda a: dev(np.asarray(a, np.int64))
    f32 = lambda a: dev(np.asarray(a, np.float32))
    grid = [dev(np.asarray(t, np.int32)) for t in grid_gather_tables(
        wf.agent, wf.rslot_rho, wf.hist_epos, wf.rho_gidx,
        e_a_flat=wf.e_a, ko=plan.ko)]
    t = dict(agent=i64(wf.agent), w_self=f32(wf.w_self),
             a_self=f32(wf.a_self), rslot_v=i64(wf.rslot_v),
             src_v=i64(wf.src_v), w_in=f32(wf.w_in),
             rslot_rho=i64(wf.rslot_rho), hist_epos=i64(wf.hist_epos),
             a_val=f32(wf.a_val),
             rho_read=i64(np.minimum(wf.rho_gidx, 2 * wf.e_a - 1)),
             out_wt=f32(wf.out_wt))
    waves = []
    for w in range(wf.n_waves):
        s = int(wf.sizes[w])
        waves.append(_WaveInputs(
            **{k: v[w, :s] for k, v in t.items()},
            grid=tuple(g[w, :s] for g in grid),
            agent_h=wf.agent[w, :s], wslot_h=wf.wslot[w, :s],
            rho_gidx_h=wf.rho_gidx[w, :s], kidx_h=wf.kidx[w, :s]))
    return waves


def _wave_step(state: PackedState, w: _WaveInputs, *, grad_fn, gamma: float,
               ko: int, impl: str, seed: int) -> None:
    """One wave, in place: ``s`` independent per-agent updates (distinct
    agents, pre-wave reads only), committed as disjoint row copies."""
    nodes, rho2, v_hist, rho_hist = state
    p = nodes.shape[-1]
    s = w.agent.shape[0]

    # (S.1) local descent ----------------------------------------------
    v_new = descent_step(nodes[w.agent, 0], nodes[w.agent, 2],
                         gamma)                            # (s, p)

    # (S.2a) consensus pull, reads resolved to delta-history rows -------
    vals_v = v_hist[w.rslot_v, w.src_v]                    # (s, kw, p)
    x_a = consensus_mix(w.w_self[:, None], v_new,
                        w.w_in.T[..., None], vals_v.transpose(0, 1))
    del vals_v

    # (S.2b) gradient at the mixed point, one lane at a time ------------
    g_new = torch.empty_like(x_a)
    for b in range(s):
        g_new[b] = grad_fn(int(w.agent_h[b]), x_a[b],
                           event_generator(seed, int(w.kidx_h[b]),
                                           int(w.agent_h[b])))

    if impl == "kernel":
        # one fused launch for the whole wave over the flat state rows
        z_a, rho_new, buf_new = commit_grid(
            *w.grid, w.a_self, w.a_val, w.out_wt,
            nodes.view(-1, p), g_new, nodes.view(-1, p),
            rho_hist.view(-1, p), rho2, rho2)
    else:
        vals_rho = rho_hist[w.rslot_rho, w.hist_epos]      # (s, ka, p)
        rho_rows = rho2[w.rho_read]                        # (s, ko+ka, p)
        recv = torch.sum(w.a_val[..., None]
                         * (vals_rho - rho_rows[:, ko:]), dim=1)
        z_half = tracking_step(nodes[w.agent, 2], recv, g_new,
                               nodes[w.agent, 3])
        # (S.2c) keep own share; push mass onto out-edges
        z_a = w.a_self[:, None] * z_half
        rho_new = rho_rows[:, :ko] + w.out_wt[..., None] * z_half[:, None]
        buf_new = vals_rho        # (S.4) ρ̃ takes the consumed values
        del rho_rows, recv, z_half

    # commit: disjoint row copies; sentinel rows (2·e_a) are skipped
    e2 = rho2.shape[0]
    for b in range(s):
        a, ws = int(w.agent_h[b]), int(w.wslot_h[b])
        for r, val in enumerate((x_a[b], v_new[b], z_a[b], g_new[b])):
            nodes[a, r].copy_(val)
        v_hist[ws, a].copy_(v_new[b])
        for j, row in enumerate(w.rho_gidx_h[b].tolist()):
            if row >= e2:
                continue
            if j < ko:
                rho2[row].copy_(rho_new[b, j])
                rho_hist[ws, row].copy_(rho_new[b, j])
            else:
                rho2[row].copy_(buf_new[b, j - ko])


def run_rfast(
    topo: Topology | CommPlan,
    schedule: Schedule,
    grad_fn,
    x0: torch.Tensor,
    gamma: float,
    *,
    seed: int = 0,
    eval_every: int = 0,
    eval_fn: Callable[[RFASTState, float], dict] | None = None,
    mode: str = "wavefront",
    impl: str = "kernel",
    chunk_cb: Callable[[RFASTState, int], None] | None = None,
    device=None,
) -> tuple[RFASTState, list[dict]]:
    """Run the full schedule; evaluate every ``eval_every`` events.

    ``grad_fn`` is a ``(i, x_flat, gen) -> g_flat`` callable or a
    :class:`~repro_torch.core.paramvec.GradProvider`.  ``device``
    defaults to ``cuda`` (raises without a GPU; pass ``"cpu"`` to run on
    the CPU).  ``eval_fn(state, t)`` and ``chunk_cb(state, k)`` fire
    after every chunk with the state as views into the live buffers.
    Each metrics entry carries ``k`` and the chunk's wave count
    ``waves``.  Returns the final state (views) and the metrics.
    """
    if mode != "wavefront":
        raise NotImplementedError(
            f"mode={mode!r}: the event engine is not ported yet "
            "(repro_torch runs mode='wavefront')")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    device = dispatch.resolve_device(device)
    grad_fn = as_grad_fn(grad_fn)
    plan = as_comm_plan(topo)
    H = int(schedule.D) + 2
    K = schedule.K
    if eval_every <= 0:
        eval_every = K

    x0 = torch.as_tensor(x0).to(device=device, dtype=torch.float32)
    packed = init_packed(plan, x0, grad_fn, H, seed=seed)
    wf = build_wavefront_plan(schedule, plan, H, break_every=eval_every)
    waves = wave_inputs(wf, plan, device)

    # chunk boundaries in wave space (waves never cross eval boundaries)
    bounds = [int(np.searchsorted(wf.event_start, s))
              for s in range(0, K, eval_every)] + [wf.n_waves]
    metrics: list[dict] = []
    for ci, (w0, w1) in enumerate(zip(bounds, bounds[1:])):
        for w in waves[w0:w1]:
            _wave_step(packed, w, grad_fn=grad_fn, gamma=gamma, ko=plan.ko,
                       impl=impl, seed=seed)
        e = min(K, (ci + 1) * eval_every)
        if eval_fn is not None:
            m = eval_fn(unpack_state(packed, e), float(schedule.times[e - 1]))
            m["k"] = e
            m["waves"] = w1 - w0
            metrics.append(m)
        if chunk_cb is not None:
            chunk_cb(unpack_state(packed, e), e)
    return unpack_state(packed, K), metrics
