"""Global-view (Algorithm 2) R-FAST engines: wavefront, event-serial,
and the fleet sweep.

Counterpart of ``src/repro/core/simulator.py``.  Three entry points run
one realized schedule (or a fleet of them) over a flat parameter state;
the formulas live in :mod:`repro_torch.core.protocol`.

* ``run_rfast(mode="wavefront")`` (default) — the schedule is compiled
  on the host (:func:`repro_torch.core.schedule.build_wavefront_plan`)
  into waves of events with distinct agents whose payload stamps
  predate the wave; each wave runs the per-agent update for all its
  lanes at once and commits O(p) delta rows into the history rings.
* ``run_rfast(mode="event")`` — one event at a time with full snapshot
  commits of ``v`` and ``ρ`` after every event: the oracle the
  wavefront engine is held to.  It runs no kernel.
* :func:`run_sweep` — a fleet of S independent (topology, schedule,
  seed) experiments as ONE wavefront run: the lanes' plans are padded
  to shared maxima and flattened (``schedule.flatten_plans``) into
  index-disjoint blocks of one width-S·B plan over the block-stacked
  state ``(S·n, 4, p)``, so each fleet wave commits every lane in one
  kernel launch.  Lane s reproduces ``run_rfast(seed=seeds[s])``.
* :func:`run_epochs` — a dynamic-membership trace
  (``NetworkScenario.realize_epochs``): every epoch's plan is padded to
  the trace-wide shapes and run through the same chunk loop, and the
  packed state is migrated in place at each epoch boundary
  (:func:`migrate_state`'s arithmetic).  :func:`run_sweep_epochs` runs
  a fleet of such traces one lane after another.
* ``mesh=`` on :func:`run_sweep` and :func:`run_sweep_epochs` — the
  same engines over ranks: lane groups on one mesh axis, slices of the
  flat parameter axis on the other, one gather of the wave's mixed
  iterates a wave (:mod:`repro_torch.core.runtime_sharded`); a rank
  keeps and returns its slice (:func:`gather_lane_state` rebuilds the
  full width).

``verify_plans=True`` on any of the four entry points runs the
:mod:`repro_torch.analysis.planlint` passes (RF101–RF106) over the
tables the engine is about to consume — each lane's padded CommPlan,
its chunked and rechunked WavefrontPlan against its schedule, the
stacked and flattened fleet, the ``commit_grid`` gather tables as
:func:`wave_inputs` builds them, and an epoch trace with every epoch's
plans — and raises :class:`~repro_torch.analysis.PlanInvariantError`
before anything is moved to the device.  It changes nothing else: a
verified run is the unverified one, bit for bit.

``run_rfast`` and ``run_sweep`` resume from a saved state (``state0`` /
``states0``, e.g. from :mod:`repro_torch.checkpoint`) at an eval-chunk
boundary; the generators are counter-based, so a resumed run is the
uninterrupted one, bit for bit, on the same device.

What differs from the JAX engines, and why:

* **No scan, no padding to a chunk shape.** PyTorch runs eagerly, so a
  chunk is a Python loop over its waves, each wave only as wide as its
  real lanes.  Pad lanes (the sentinel agent) are dropped on the host:
  they compute no gradient and commit nothing.
* **Commits are row copies.** JAX scatters with ``mode="drop"`` to skip
  sentinel rows; torch indexing would fault on them.  The commit writes
  each valid row with its own in-place copy, chosen from the host-side
  numpy tables, so a sentinel never reaches the device and no device
  mask is built (which would synchronise every wave).  The wave's new
  values are computed out of place first, so the order of the copies
  does not matter.
* **Generators, not keys.** The gradient of event ``k`` at node ``i``
  draws from a CPU ``torch.Generator`` seeded from ``(seed, k, i)``
  (:func:`event_generator`; ``k = -1`` for the initial gradients) in
  every engine, so the event and wavefront engines draw identical
  gradients even for a stochastic objective, and fleet lane s draws
  what ``run_rfast(seed=seeds[s])`` draws.
* **In-place state.** The state is updated in place (the JAX engines
  donate it); :func:`unpack_state` returns views into it.

Two commit backends for the wavefront engines, selected with ``impl``:

* ``"kernel"`` (default) — ONE :func:`~repro_torch.kernels.rfast_update.
  grid.commit_grid` launch per wave, gathering z, g_prev, the ρ-history
  payloads, ρ̃ and ρ-out rows from the flat packed state itself;
* ``"plain"`` — the scatter/gather path in PyTorch ops (the event
  engine's only backend).

State layout (flat parameter vectors, ``p`` = dimension):

* ``nodes``    — (n, 4, p): rows x, v, z, g_prev per node;
* ``rho2``     — (2·E_A, p): ρ rows then ρ̃ rows;
* ``v_hist``   — (H, n, p): delta rows (writer count mod H, node) in
  wavefront mode, snapshots of ``v`` after every event in event mode;
* ``rho_hist`` — (H, E_A, p): likewise for ``ρ``.

Mass-conservation invariant (Lemma 3)::

    Σ_i z_i + Σ_e (ρ_e − ρ̃_e)  ==  Σ_i ∇f_i(x_i^k; ζ_i^k)
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.rfast_update import dispatch
from ..kernels.rfast_update.grid import commit_grid
from ..spans import span
from .paramvec import as_grad_fn
from .plan import CommPlan, as_comm_plan, pad_comm_plan
from .protocol import IMPLS, consensus_mix, descent_step, tracking_step
from .runtime_sharded import all_gather_flat, packed_sweep_specs
from .schedule import (Schedule, WavefrontPlan, build_wavefront_plan,
                       concat_plans, flatten_plans, grid_gather_tables,
                       pad_plan, slice_plan, stack_plans)
from .topology import Topology

__all__ = ["RFASTState", "PackedState", "init_state", "init_packed",
           "zeros_state", "pack_state", "unpack_state", "wave_inputs",
           "event_generator", "rfast_scan", "run_rfast", "sweep_plan",
           "run_sweep", "gather_lane_state", "migrate_state", "run_epochs", "run_sweep_epochs",
           "tracked_mass", "IMPLS"]


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
    plan = as_comm_plan(topo)
    return _fresh_packed(plan.n, max(1, plan.n_edges_a), H, x0,
                         as_grad_fn(grad_fn), seed)


def _fresh_packed(n: int, e_a: int, H: int, x0: torch.Tensor, grad_fn,
                  seed: int, shard=None) -> PackedState:
    """A packed state with ``e_a`` ρ rows on ``x0``'s device, x = x0
    and the paper init of :func:`_paper_init` (a param ``shard``'s
    slice of them)."""
    p = int(x0.shape[-1])
    x_full = x0.to(torch.float32).expand(n, p)
    lo, hi, width = (0, p, p) if shard is None else (shard.lo, shard.hi,
                                                     shard.p_loc)
    st = _zeros_packed(n, e_a, width, H, x0.device)
    st.nodes[:, 0, :hi - lo].copy_(x_full[:, lo:hi])
    _paper_init(st.nodes, grad_fn, seed, x_full=x_full, shard=shard)
    return st


def _paper_init(nodes: torch.Tensor, grad_fn, seed: int, *,
                x_full: torch.Tensor | None = None, shard=None) -> None:
    """z = g_prev = ∇f_i(x_i; ζ_i^0) for every node of an ``(n, 4, p)``
    block whose x is set, node ``i`` drawing from
    ``event_generator(seed, -1, i)``.  A param shard (``shard``, a
    :class:`~repro_torch.core.runtime_sharded.SweepLayout`) holds the
    columns ``[lo, hi)``: its gradient is taken at the full-width rows
    ``x_full`` ``(n, p)`` and cut to them."""
    for i in range(nodes.shape[0]):
        gen = event_generator(seed, -1, i)
        if shard is None:
            with span("rfast.grad"):
                g = grad_fn(i, nodes[i, 0], gen)
        else:
            g = torch.zeros_like(nodes[i, 0])
            with span("rfast.grad"):
                g[:shard.hi - shard.lo] = grad_fn(i, x_full[i], gen)[
                    shard.lo:shard.hi]
        nodes[i, 2].copy_(g)
        nodes[i, 3].copy_(g)


def init_state(topo: Topology | CommPlan, x0: torch.Tensor, grad_fn,
               H: int, *, seed: int = 0) -> RFASTState:
    """:func:`init_packed` seen as an :class:`RFASTState` (views)."""
    return unpack_state(init_packed(topo, x0, grad_fn, H, seed=seed), 0)


def zeros_state(topo: Topology | CommPlan, p: int, H: int, *,
                device=None) -> RFASTState:
    """All-zeros state of a run over ``topo`` at dimension ``p``, on
    ``device`` (``cuda`` unless the caller asks for another)."""
    plan = as_comm_plan(topo)
    return unpack_state(_zeros_packed(plan.n, max(1, plan.n_edges_a), p, H,
                                      dispatch.resolve_device(device)), 0)


def pack_state(state: RFASTState, *, e_a: int | None = None) -> PackedState:
    """Copy an :class:`RFASTState` into a new packed layout.  ``e_a``
    pads the ρ state with zero rows to a larger layout (the trace-wide
    or fleet-wide A-edge count; no real lane references the extra
    rows, and the WavefrontPlan must be built against the same
    ``e_a``)."""
    rho, rho_buf, rho_hist = state.rho, state.rho_buf, state.rho_hist
    if e_a is not None and e_a != rho.shape[0]:
        if e_a < rho.shape[0]:
            raise ValueError(f"e_a={e_a} < state's A-edge count "
                             f"{rho.shape[0]}")
        pad = e_a - rho.shape[0]
        rho = torch.nn.functional.pad(rho, (0, 0, 0, pad))
        rho_buf = torch.nn.functional.pad(rho_buf, (0, 0, 0, pad))
        rho_hist = torch.nn.functional.pad(rho_hist, (0, 0, 0, pad))
    return PackedState(
        nodes=torch.stack([state.x, state.v, state.z, state.g_prev], dim=1),
        rho2=torch.cat([rho, rho_buf], dim=0),
        v_hist=state.v_hist.clone(), rho_hist=rho_hist.clone())


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


# --------------------------------------------------------------------- #
# event-serial engine (snapshot histories) — the equivalence oracle
# --------------------------------------------------------------------- #
class _EventTables(NamedTuple):
    """One chunk's per-event read/write tables on the device, each row
    holding the active agent's real edges first (``cw``/``ca``/``co`` of
    them, by agent) and zero-weight pads after."""

    rslot_v: torch.Tensor    # (C, kw) v_hist slot of each in-W payload
    src_v: torch.Tensor      # (C, kw) its sender
    w_in: torch.Tensor       # (C, kw) W[a, j]
    rslot_rho: torch.Tensor  # (C, ka) rho_hist slot of each in-A payload
    epos_in: torch.Tensor    # (C, ka) its A-edge
    epos_out: torch.Tensor   # (C, ko) the agent's out-A edges
    wt_out: torch.Tensor     # (C, ko) A[dst, a]


def rfast_scan(topo: Topology | CommPlan, grad_fn, gamma: float, H: int, *,
               seed: int = 0):
    """Event-serial engine: ``run_chunk(state, agent, stamp_v, stamp_rho)
    -> state`` runs one event per entry of ``agent`` in place on an
    :class:`RFASTState` (e.g. :func:`init_state`), numbering the events
    from ``state.k``.  Event ``k`` at agent ``a`` draws its gradient
    from ``event_generator(seed, k, a)``; after it, the whole ``v`` and
    ``ρ`` are written into history slot ``(k+1) % H``, so a payload
    stamped ``s`` (the state after event ``s − 1``) is read at slot
    ``s % H``.  The reference masks every edge of the graph per event;
    this reads only the agent's own edges, which is the same sum."""
    grad_fn = as_grad_fn(grad_fn)
    plan = as_comm_plan(topo)
    n = plan.n
    # real edges per node (the plan's node tables put them first)
    cw = np.bincount(plan.dst_w[:plan.n_edges_w], minlength=n)
    ca = plan.in_a_val.sum(1).astype(np.int64)
    co = plan.out_a_val.sum(1).astype(np.int64)

    def tables(agent, stamp_v, stamp_rho, device) -> _EventTables:
        rows = np.arange(agent.shape[0])[:, None]
        dev = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt),
                                            device=device)
        return _EventTables(
            rslot_v=dev(stamp_v[rows, plan.in_w_epos[agent]] % H, np.int64),
            src_v=dev(plan.in_w_src[agent], np.int64),
            w_in=dev(plan.in_w_wt[agent], np.float32),
            rslot_rho=dev(stamp_rho[rows, plan.in_a_epos[agent]] % H,
                          np.int64),
            epos_in=dev(plan.in_a_epos[agent], np.int64),
            epos_out=dev(plan.out_a_epos[agent], np.int64),
            wt_out=dev(plan.out_a_wt[agent], np.float32))

    def run_chunk(state: RFASTState, agent, stamp_v, stamp_rho) -> RFASTState:
        agent = np.asarray(agent, np.int64)
        t = tables(agent, np.asarray(stamp_v), np.asarray(stamp_rho),
                   state.x.device)
        k0 = int(state.k)
        for j, a in enumerate(agent.tolist()):
            k = k0 + j
            # (S.1) local descent
            v_new = descent_step(state.x[a], state.z[a], gamma)
            # (S.2a) consensus pull over G(W) with stale payloads
            c = int(cw[a])
            vals_v = state.v_hist[t.rslot_v[j, :c], t.src_v[j, :c]]
            x_a = consensus_mix(float(plan.w_diag[a]), v_new,
                                t.w_in[j, :c, None], vals_v)
            # (S.2b) robust gradient tracking
            g_new = grad_fn(a, x_a, event_generator(seed, k, a))
            c = int(ca[a])
            e_in = t.epos_in[j, :c]
            vals_rho = state.rho_hist[t.rslot_rho[j, :c], e_in]
            recv = torch.sum(vals_rho - state.rho_buf[e_in], dim=0)
            z_half = tracking_step(state.z[a], recv, g_new, state.g_prev[a])
            # (S.2c) keep own share; push mass onto out-edges
            c = int(co[a])
            state.rho.index_add_(0, t.epos_out[j, :c],
                                 t.wt_out[j, :c, None] * z_half)
            # (S.4) buffers take the consumed values
            state.rho_buf[e_in] = vals_rho
            # commit, then snapshot v and ρ after event k
            state.x[a].copy_(x_a)
            state.v[a].copy_(v_new)
            state.z[a].copy_(float(plan.a_diag[a]) * z_half)
            state.g_prev[a].copy_(g_new)
            state.v_hist[(k + 1) % H].copy_(state.v)
            state.rho_hist[(k + 1) % H].copy_(state.rho)
        return state._replace(k=k0 + agent.shape[0])

    return run_chunk


# --------------------------------------------------------------------- #
# wavefront engine (delta histories)
# --------------------------------------------------------------------- #
class _WaveInputs(NamedTuple):
    """One wave's real lanes: device tensors for the gathers and the
    kernel, host arrays for the row commits and the gradients."""

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
    agent_h: np.ndarray      # (s,) state row of each lane's node
    wslot_h: np.ndarray      # (s,)
    rho_gidx_h: np.ndarray   # (s, ko+ka) with sentinel 2·e_a
    node_h: np.ndarray       # (s,) the node id the gradient sees
    k_h: np.ndarray          # (s,) the event index within its experiment
    seed_h: np.ndarray       # (s,) the experiment's seed


def _grid_tables(wf: WavefrontPlan, ko: int):
    """``(real, cut, agent, tables)``: the real-lane mask of ``wf``
    (agent not the sentinel ``wf.n``), the function that compacts a
    per-lane table to those lanes, their agents, and ``commit_grid``'s
    five row tables built from the compacted lanes."""
    real = wf.agent != wf.n                                 # (NW, B)
    cut = lambda a: np.ascontiguousarray(np.asarray(a)[real])
    agent = cut(wf.agent).astype(np.int64)
    return real, cut, agent, grid_gather_tables(
        agent, cut(wf.rslot_rho), cut(wf.hist_epos), cut(wf.rho_gidx),
        e_a_flat=wf.e_a, ko=ko)


def wave_inputs(wf: WavefrontPlan, ko: int, device,
                seeds=(0,), k0: int = 0) -> list[_WaveInputs]:
    """Per-wave real-lane tables of a WavefrontPlan: a single run's
    (``seeds = (seed,)``) or a fleet's flattened plan (one seed per
    lane).  A lane is real where its agent is not the sentinel ``wf.n``:
    in a fleet wave lane s's real slots sit at ``[s·B, s·B + size_s)``
    with its pads after them, so a wave is not cut to its first
    ``sizes[w]`` lanes.  The real lanes of all waves are compacted on
    the host and moved once; a wave's device tables are views of them.
    ``ko`` is the (fleet-wide) max A out-degree.  For the gradient each
    lane carries its experiment's view: node ``agent − s·n`` and event
    ``k0 + kidx − s·K`` of experiment ``s = kidx // K`` (``k0``: the
    global index of the plan's event 0, an epoch's offset in its
    trace)."""
    S = len(seeds)
    n_lane, K_lane = wf.n // S, wf.K // S
    real, cut, agent, tables = _grid_tables(wf, ko)
    off = np.concatenate([[0], np.cumsum(real.sum(1))])
    dev = lambda a, dt: torch.as_tensor(cut(a).astype(dt), device=device)
    kidx = cut(wf.kidx)
    lane = kidx // K_lane
    grid = [torch.as_tensor(np.ascontiguousarray(g, np.int32), device=device)
            for g in tables]
    t = dict(agent=dev(wf.agent, np.int64),
             w_self=dev(wf.w_self, np.float32),
             a_self=dev(wf.a_self, np.float32),
             rslot_v=dev(wf.rslot_v, np.int64),
             src_v=dev(wf.src_v, np.int64),
             w_in=dev(wf.w_in, np.float32),
             rslot_rho=dev(wf.rslot_rho, np.int64),
             hist_epos=dev(wf.hist_epos, np.int64),
             a_val=dev(wf.a_val, np.float32),
             rho_read=dev(np.minimum(wf.rho_gidx, 2 * wf.e_a - 1), np.int64),
             out_wt=dev(wf.out_wt, np.float32))
    h = dict(agent_h=agent, wslot_h=cut(wf.wslot),
             rho_gidx_h=cut(wf.rho_gidx), node_h=agent - lane * n_lane,
             k_h=int(k0) + kidx - lane * K_lane,
             seed_h=np.asarray(seeds, np.int64)[lane])
    waves = []
    for w in range(wf.n_waves):
        a, b = int(off[w]), int(off[w + 1])
        waves.append(_WaveInputs(
            **{k: v[a:b] for k, v in t.items()},
            grid=tuple(g[a:b] for g in grid),
            **{k: v[a:b] for k, v in h.items()}))
    return waves


def _wave_step(state: PackedState, w: _WaveInputs, *, grad_fn, gamma: float,
               ko: int, impl: str, shard=None) -> None:
    """One wave, in place: ``s`` independent per-agent updates (distinct
    agents, pre-wave reads only), committed as disjoint row copies.

    ``shard`` (a :class:`~repro_torch.core.runtime_sharded.SweepLayout`
    with M > 1): the state holds one slice of the flat axis.  The
    protocol math is elementwise along it and runs on the slice as is;
    the gradient needs the full iterate, rebuilt by ONE
    :func:`~repro_torch.core.runtime_sharded.all_gather_flat` of the
    wave's mixed iterates over the param group, and the rank keeps its
    slice of each fresh gradient."""
    with span("rfast.wave"):
        _wave(state, w, grad_fn=grad_fn, gamma=gamma, ko=ko, impl=impl,
              shard=shard)


def _wave(state: PackedState, w: _WaveInputs, *, grad_fn, gamma: float,
          ko: int, impl: str, shard) -> None:
    """:func:`_wave_step`'s body."""
    nodes, rho2, v_hist, rho_hist = state
    p = nodes.shape[-1]
    s = w.agent.shape[0]

    with span("rfast.mix"):
        # (S.1) local descent ------------------------------------------
        v_new = descent_step(nodes[w.agent, 0], nodes[w.agent, 2],
                             gamma)                        # (s, p)

        # (S.2a) consensus pull, reads resolved to delta-history rows ---
        vals_v = v_hist[w.rslot_v, w.src_v]                # (s, kw, p)
        x_a = consensus_mix(w.w_self[:, None], v_new,
                            w.w_in.T[..., None], vals_v.transpose(0, 1))
        del vals_v
        # a param shard's gradient needs the full iterates: the wave's
        # one collective; the zero pad tail sits at the end of the flat
        # axis, so the tiled gather is the global order
        x_full = None if shard is None else \
            all_gather_flat(x_a, shard.param)              # (s, p_pad)

    # (S.2b) gradient at the mixed point, one lane at a time ------------
    g_new = torch.empty_like(x_a) if shard is None else torch.zeros_like(x_a)
    for b in range(s):
        node = int(w.node_h[b])
        gen = event_generator(int(w.seed_h[b]), int(w.k_h[b]), node)
        with span("rfast.grad"):
            g = grad_fn(node, x_a[b] if shard is None
                        else x_full[b, :shard.p], gen)
        if shard is None:
            g_new[b] = g
        else:
            g_new[b, :shard.hi - shard.lo] = g[shard.lo:shard.hi]
        del g                       # one lane's gradient alive at a time
    del x_full

    with span("rfast.commit"):
        if impl == "kernel":
            # one fused launch for the whole wave over the flat state rows
            z_a, rho_new, buf_new = commit_grid(
                *w.grid, w.a_self, w.a_val, w.out_wt,
                nodes.view(-1, p), g_new, nodes.view(-1, p),
                rho_hist.view(-1, p), rho2, rho2)
        else:
            vals_rho = rho_hist[w.rslot_rho, w.hist_epos]  # (s, ka, p)
            rho_rows = rho2[w.rho_read]                    # (s, ko+ka, p)
            recv = torch.sum(w.a_val[..., None]
                             * (vals_rho - rho_rows[:, ko:]), dim=1)
            z_half = tracking_step(nodes[w.agent, 2], recv, g_new,
                                   nodes[w.agent, 3])
            # (S.2c) keep own share; push mass onto out-edges
            z_a = w.a_self[:, None] * z_half
            rho_new = rho_rows[:, :ko] + w.out_wt[..., None] \
                * z_half[:, None]
            buf_new = vals_rho    # (S.4) ρ̃ takes the consumed values
            del rho_rows, recv, z_half

    # commit: disjoint row copies; sentinel rows (2·e_a) are skipped
    with span("rfast.scatter"):
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


def _chunk_waves(wf: WavefrontPlan, K: int, eval_every: int) -> list[int]:
    """Wave bounds of the eval chunks (waves never cross a boundary)."""
    return [int(np.searchsorted(wf.event_start, s))
            for s in range(0, K, eval_every)] + [wf.n_waves]


def _chunked_plan(schedule: Schedule, plan: CommPlan, H: int, e_a: int,
                  eval_every: int) -> tuple[WavefrontPlan, list[int]]:
    """A schedule's WavefrontPlan at history depth ``H`` and ρ layout
    ``e_a``, broken at the eval chunks, and its chunk wave bounds."""
    wf = build_wavefront_plan(schedule, plan, H, break_every=eval_every,
                              e_a=e_a)
    return wf, _chunk_waves(wf, schedule.K, eval_every)


def _pad_chunks(wf: WavefrontPlan, bounds: list[int], *, B: int, cmax: int,
                e_a: int) -> WavefrontPlan:
    """Every chunk of ``wf`` padded to ``cmax`` waves of width ``B``, so
    chunk c occupies waves ``[c·cmax, (c+1)·cmax)``."""
    return concat_plans([pad_plan(slice_plan(wf, b0, b1), width=B,
                                  n_waves=cmax, e_a=e_a)
                         for b0, b1 in zip(bounds, bounds[1:])])


def _check_plans(context: str, lint) -> None:
    """Run ``lint(planlint) -> diagnostics`` and raise
    :class:`~repro_torch.analysis.PlanInvariantError` (via
    ``planlint.check_or_raise``) with ``context`` on any diagnostic."""
    from ..analysis import planlint
    planlint.check_or_raise(lint(planlint), context)


def _grid_diags(pl, wf: WavefrontPlan, ko: int, H: int,
                subject: str) -> list:
    """RF103 over ``commit_grid``'s gather tables as :func:`wave_inputs`
    builds them from ``wf``'s real lanes: the tables the kernel reads."""
    _, _, agent, tables = _grid_tables(wf, ko)
    return pl.lint_grid_tables(tables, agent=agent, n=wf.n, e_a=wf.e_a, H=H,
                               subject=subject)


def _shape_maxima(plans: list[CommPlan], schedules: list[Schedule]):
    """``(H, kw, ka, ko, e_a)``: the history depth, in/out degrees and ρ
    layout every plan of a fleet or an epoch trace is padded to."""
    return (max(int(s.D) for s in schedules) + 2,
            max(pl.kw for pl in plans), max(pl.ka for pl in plans),
            max(pl.ko for pl in plans),
            max(max(1, pl.n_edges_a) for pl in plans))


def _run_chunks(packed: PackedState, waves: list[_WaveInputs], cmax: int,
                n_chunks: int, *, skip: int = 0, **step):
    """Run eval chunks ``skip, …, n_chunks − 1`` of ``waves`` (``cmax``
    waves each; a wave with no real lane launches nothing) in place,
    yielding ``(chunk, waves run)`` after each.  ``step`` holds
    :func:`_wave_step`'s keywords."""
    for ci in range(skip, n_chunks):
        chunk = [w for w in waves[ci * cmax:(ci + 1) * cmax]
                 if w.agent.shape[0]]
        for w in chunk:
            _wave_step(packed, w, **step)
        yield ci, len(chunk)


def _resume_k(state0: RFASTState, H: int, K: int, eval_every: int) -> int:
    """The event count a saved state resumes from, checked against the
    run it resumes into: the same history depth, and an eval-chunk
    boundary (or ``K``: a finished run)."""
    if state0.v_hist.shape[0] != H:
        raise ValueError(
            f"state0 has H={state0.v_hist.shape[0]} but this schedule "
            f"needs H={H} — resume only into the same schedule")
    k0 = int(state0.k)
    # k0 == K is a completed run (its K need not be chunk-aligned)
    if k0 < K and k0 % eval_every != 0:
        raise ValueError(f"state0.k={k0} is not an eval-chunk boundary "
                         f"(eval_every={eval_every})")
    return k0


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
    impl: str | None = None,
    state0: RFASTState | None = None,
    chunk_cb: Callable[[RFASTState, int], None] | None = None,
    device=None,
    verify_plans: bool = False,
) -> tuple[RFASTState, list[dict]]:
    """Run the full schedule; evaluate every ``eval_every`` events.

    ``grad_fn`` is a ``(i, x_flat, gen) -> g_flat`` callable or a
    :class:`~repro_torch.core.paramvec.GradProvider`.  ``mode`` is
    ``"wavefront"`` (default) or ``"event"`` (the snapshot oracle; both
    realize the same Algorithm-2 trajectory, their ``v_hist`` /
    ``rho_hist`` *contents* differ by representation).  ``impl`` is the
    wavefront commit backend, ``"kernel"`` (its default) or
    ``"plain"``; the event engine runs ``"plain"`` only and rejects
    ``"kernel"``.  ``device`` defaults to ``cuda`` (raises without a
    GPU; pass ``"cpu"`` to run on the CPU).  ``eval_fn(state, t)`` and
    ``chunk_cb(state, k)`` fire after every chunk with the state as
    views into the live buffers.  Each metrics entry carries ``k`` and,
    in wavefront mode, the chunk's wave count ``waves``.  Returns the
    final state (views) and the metrics.

    ``state0`` resumes from a state that ``chunk_cb`` saw (e.g. saved
    with :func:`repro_torch.checkpoint.save_checkpoint`): ``state0.k``
    must sit on an eval-chunk boundary of the SAME schedule, seed and
    ``mode`` (the two engines' history *representations* differ, their
    shapes do not, so a cross-mode resume is not detected).  The first
    ``state0.k // eval_every`` chunks are skipped; ``x0`` is unused.

    ``verify_plans=True`` lints the plans before the first wave (the
    event engine: its CommPlan) and raises
    :class:`~repro_torch.analysis.PlanInvariantError` on any diagnostic.
    """
    if mode not in ("wavefront", "event"):
        raise ValueError(f"mode must be 'wavefront' or 'event', got {mode!r}")
    if impl is None:
        impl = "kernel" if mode == "wavefront" else "plain"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if mode == "event" and impl != "plain":
        raise ValueError("impl='kernel' requires mode='wavefront' "
                         "(the event engine is the plain oracle)")
    if mode == "wavefront":
        # a fleet of one lane: run_sweep owns the wavefront driver
        def hook(state: RFASTState, t: float) -> dict:
            m = eval_fn(state, t) if eval_fn is not None else {}
            if chunk_cb is not None:
                chunk_cb(state, state.k)
            return m

        states, metrics = run_sweep(
            topo, [schedule], grad_fn, x0, gamma, seeds=[seed],
            eval_every=eval_every,
            eval_fn=None if eval_fn is None and chunk_cb is None else hook,
            impl=impl, device=device,
            states0=None if state0 is None else [state0],
            verify_plans="run_rfast(verify_plans)" if verify_plans else False)
        return states[0], metrics[0] if eval_fn is not None else []

    device = dispatch.resolve_device(device)
    grad_fn = as_grad_fn(grad_fn)
    plan = as_comm_plan(topo)
    if verify_plans:
        _check_plans("run_rfast(verify_plans)", lambda pl: pl.lint_comm_plan(
            plan, topo if isinstance(topo, Topology) else None))
    H = int(schedule.D) + 2
    K = schedule.K
    if eval_every <= 0:
        eval_every = K
    if state0 is None:
        x0 = torch.as_tensor(x0).to(device=device, dtype=torch.float32)
        state = init_state(plan, x0, grad_fn, H, seed=seed)
    else:
        k0 = _resume_k(state0, H, K, eval_every)
        state = RFASTState(k0, *(t.to(device=device, dtype=torch.float32,
                                      copy=True) for t in state0[1:]))
    chunk = rfast_scan(plan, grad_fn, gamma, H, seed=seed)
    metrics: list[dict] = []
    for s in range(state.k, K, eval_every):
        e = min(K, s + eval_every)
        state = chunk(state, schedule.agent[s:e], schedule.stamp_v[s:e],
                      schedule.stamp_rho[s:e])
        if eval_fn is not None:
            m = eval_fn(state, float(schedule.times[e - 1]))
            m["k"] = e
            metrics.append(m)
        if chunk_cb is not None:
            chunk_cb(state, e)
    return state, metrics


# --------------------------------------------------------------------- #
# fleet sweeps: many experiments as one wavefront run
# --------------------------------------------------------------------- #
class SweepPlan(NamedTuple):
    """A fleet's flattened wavefront plan and the shapes it was built
    to (see :func:`sweep_plan`)."""

    fleet: WavefrontPlan     # width S·B over S·n nodes, S·e_a ρ rows
    H: int                   # fleet-wide history depth
    ko: int                  # fleet-wide max A out-degree
    e_a: int                 # per-lane ρ half-size (fleet max A edges)
    cmax: int                # waves per eval chunk, every lane padded to it


def sweep_plan(plans: list[CommPlan], schedules: list[Schedule],
               eval_every: int, *, verify: str = "",
               topos=None, lanes=None, name: str = "fleet") -> SweepPlan:
    """The fleet's one wavefront plan: each lane's CommPlan degree-padded
    to the fleet maxima (``pad_comm_plan``), its WavefrontPlan built at
    the fleet's H and ρ layout and cut into eval chunks, every chunk
    padded to the fleet-wide widest chunk (``pad_plan``) so chunk c
    occupies waves ``[c·cmax, (c+1)·cmax)`` in every lane, then stacked
    and flattened (``stack_plans`` / ``flatten_plans``).

    ``lanes`` (a range of lane indices) stacks and flattens only those
    lanes, at the shape maxima of all of them: a mesh lane group's own
    fleet, its lanes at group-local offsets.  ``verify`` (a context such
    as ``"run_sweep(verify_plans)"``) lints every one of those tables
    and the fleet's ``commit_grid`` gather tables (subjects
    ``lane{s}...`` and ``{name}...``), raising
    :class:`~repro_torch.analysis.PlanInvariantError` on any diagnostic;
    ``topos`` (the lanes' Topologies, where known) lets the CommPlan
    lint check the tables against their graphs."""
    H, kw, ka, ko, e_a = _shape_maxima(plans, schedules)
    padded = [pad_comm_plan(pl, kw=kw, ka=ka, ko=ko) for pl in plans]
    chunked = [_chunked_plan(sc, pc, H, e_a, eval_every)
               for pc, sc in zip(padded, schedules)]
    cmax = max(b1 - b0 for _, b in chunked for b0, b1 in zip(b, b[1:]))
    B = max(wf.width for wf, _ in chunked)
    lanes = range(len(plans)) if lanes is None else lanes
    rechunked = [_pad_chunks(*chunked[s], B=B, cmax=cmax, e_a=e_a)
                 for s in lanes]
    stacked = stack_plans(rechunked)
    fleet = flatten_plans(stacked)
    if verify:
        topos = list(topos) if topos is not None else [None] * len(plans)

        def lint(pl):
            diags = []
            for s, rc in zip(lanes, rechunked):
                pc, (wf, _), sc, topo = (padded[s], chunked[s],
                                         schedules[s], topos[s])
                diags += pl.lint_comm_plan(
                    pc, topo if isinstance(topo, Topology) else None,
                    subject=f"lane{s}/comm")
                diags += pl.lint_wavefront_plan(
                    wf, comm=pc, schedule=sc, H=H, subject=f"lane{s}")
                diags += pl.lint_wavefront_plan(
                    rc, comm=pc, schedule=sc, H=H,
                    subject=f"lane{s}/rechunked")
            diags += pl.lint_wavefront_plan(
                stacked, comm=[padded[s] for s in lanes],
                schedule=[schedules[s] for s in lanes], H=H,
                subject=f"{name}/stacked")
            diags += pl.lint_flatten(stacked, fleet, subject=name)
            diags += pl.lint_wavefront_plan(fleet, H=H, subject=f"{name}/flat")
            return diags + _grid_diags(pl, fleet, ko, H,
                                       f"{name}/grid_tables")

        _check_plans(verify, lint)
    return SweepPlan(fleet=fleet, H=H, ko=ko, e_a=e_a, cmax=cmax)


def _lane_state(packed: PackedState, s: int, k: int, *, S: int, n: int,
                e_a: int, e_a_lane: int) -> RFASTState:
    """Fleet lane ``s`` of the flat fleet state as views (lane blocks:
    nodes ``[s·n, (s+1)·n)``, ρ ``[s·e_a, ·)`` with ρ̃ at offset
    ``S·e_a``), its ρ state cut back to the lane's real A-edge count."""
    nd = packed.nodes[s * n:(s + 1) * n]
    return RFASTState(
        k=int(k), x=nd[:, 0], v=nd[:, 1], z=nd[:, 2], g_prev=nd[:, 3],
        rho=packed.rho2[s * e_a:s * e_a + e_a_lane],
        rho_buf=packed.rho2[(S + s) * e_a:(S + s) * e_a + e_a_lane],
        v_hist=packed.v_hist[:, s * n:(s + 1) * n],
        rho_hist=packed.rho_hist[:, s * e_a:s * e_a + e_a_lane])


def run_sweep(
    topos,
    schedules,
    grad_fn,
    x0: torch.Tensor,
    gamma: float,
    *,
    seeds=None,
    eval_every: int = 0,
    eval_fn: Callable[[RFASTState, float], dict] | None = None,
    impl: str = "kernel",
    device=None,
    states0=None,
    verify_plans: bool | str = False,
    mesh=None,
    lane_axis: str = "data",
    param_axis: str | None = "model",
) -> tuple[list[RFASTState], list[list[dict]]]:
    """Run a fleet of S independent experiments as ONE wavefront run.

    Args:
      topos: one Topology/CommPlan shared by every lane, or S of them.
        All lanes must share the node count ``n``; topologies may
        otherwise differ (plans are degree-normalized and padded to the
        fleet maxima, and padded waves and lanes are inert).
      schedules: S realized Schedules sharing ``K``.
      grad_fn: the shared objective; it sees lane-local node ids, and
        lane s's event k draws from ``event_generator(seeds[s], k, i)``,
        as ``run_rfast(seed=seeds[s])`` would.
      x0: ``(p,)``, ``(n, p)`` or per lane ``(S, n, p)``.
      seeds: per-lane seeds (default 0 for every lane).
      eval_every / eval_fn: as in :func:`run_rfast`, per lane, each
        entry stamped with that lane's own virtual time, its ``k`` and
        the chunk's fleet wave count ``waves``.
      impl: ``"kernel"`` commits every fleet wave — all lanes, all wave
        slots — in ONE ``commit_grid`` launch; ``"plain"`` in PyTorch
        ops.
      device: ``cuda`` unless the caller asks for another.
      states0: S lane states at one common ``k`` to resume from, as
        ``run_rfast``'s ``state0`` (the lane's real ρ layout and the
        fleet's history depth); ``x0`` is then unused.
      verify_plans: lint the fleet's plans (:func:`sweep_plan`) before
        anything moves to the device, raising ``PlanInvariantError``
        with the context ``"run_sweep(verify_plans)"`` (a string is the
        context itself: ``run_rfast`` passes its own).
      mesh: a :class:`~repro_torch.launch.mesh.SweepMesh` — distribute
        the fleet over the ranks that call this together
        (:func:`_fleet`): the lanes, padded to a multiple of
        the ``lane_axis`` size D by repeating the last lane (the repeats
        are dropped), split into D contiguous groups, one a rank row;
        the flat parameter axis splits over ``param_axis`` when that
        axis has size M > 1, so a state that one card cannot hold is
        spread over M: what ``eval_fn`` sees and the run returns are
        then this rank's ``p_loc``-wide slice of each lane state (views,
        the zero pad tail in the last shard), and
        :func:`gather_lane_state` rebuilds the full width where a
        caller needs it.  Gathered, each lane matches the unsharded
        engine to fp32 tolerance.  ``None`` (default) is the trivial
        layout of one process: every lane, full width.  No resume
        (``states0``) with a mesh.
      lane_axis / param_axis: the mesh's axis names (``"data"`` /
        ``"model"``, as :func:`repro_torch.launch.mesh.make_sweep_mesh`
        names them).

    Returns ``(states, metrics)``: the final per-lane :class:`RFASTState`
    views (ρ state cut to each lane's real A-edge count) and the
    per-lane metrics lists.  With a mesh a rank returns its own lane
    group's lanes; the other lanes' entries are None, their metrics
    empty.
    """
    schedules = list(schedules)
    S = len(schedules)
    if S == 0:
        raise ValueError("run_sweep needs at least one lane")
    if not isinstance(topos, (list, tuple)):
        topos = [topos] * S
    plans = [as_comm_plan(t) for t in topos]
    if len(plans) != S:
        raise ValueError(f"{len(plans)} topologies for {S} schedules")
    n = plans[0].n
    if any(pl.n != n for pl in plans):
        raise ValueError("all lanes must share the node count n "
                         f"(got {[pl.n for pl in plans]})")
    K = schedules[0].K
    if any(s.K != K for s in schedules):
        raise ValueError("all lanes must share the event count K "
                         f"(got {[s.K for s in schedules]})")
    seeds = [0] * S if seeds is None else [int(s) for s in seeds]
    if len(seeds) != S:
        raise ValueError(f"{len(seeds)} seeds for {S} lanes")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    device = dispatch.resolve_device(device)
    grad_fn = as_grad_fn(grad_fn)
    if eval_every <= 0:
        eval_every = K
    if verify_plans is True:
        verify_plans = "run_sweep(verify_plans)"
    if mesh is not None:
        if lane_axis not in mesh.axis_names:
            raise ValueError(f"mesh has no lane axis {lane_axis!r} "
                             f"(axes: {mesh.axis_names})")
        if states0 is not None:
            raise ValueError("run_sweep(mesh=...) has no resume: drop "
                             "states0 or the mesh")

    if states0 is None:
        x0 = torch.as_tensor(x0).to(device=device, dtype=torch.float32)
        if x0.dim() == 3 and x0.shape[0] != S:
            raise ValueError(f"per-lane x0 has {x0.shape[0]} lanes, "
                             f"expected {S}")
        p = int(x0.shape[-1])
    else:
        states0 = list(states0)
        if len(states0) != S:
            raise ValueError(f"{len(states0)} resume states for {S} lanes")
        p = int(states0[0].x.shape[-1])
    lay = packed_sweep_specs(mesh, S, p, lane_axis=lane_axis,
                             param_axis=param_axis)
    fl = _fleet(plans, schedules, topos, grad_fn,
                x0 if states0 is None else None, lay, seeds=seeds,
                eval_every=eval_every, device=device,
                verify=verify_plans or "",
                name="fleet" if mesh is None else f"fleet/g{lay.g}")
    n_chunks = -(-K // eval_every)
    skip = 0
    if states0 is not None:
        k0s = {_resume_k(st, fl.sp.H, K, eval_every) for st in states0}
        if len(k0s) != 1:
            raise ValueError(f"resume states at different k: {sorted(k0s)}")
        k0 = k0s.pop()
        for s, st in enumerate(states0):
            for f, t in zip(RFASTState._fields[1:], fl.lane_state(s, k0)[1:]):
                t.copy_(getattr(st, f))
        skip = n_chunks if k0 >= K else k0 // eval_every

    own = [s for s in lay.lanes if s < S]
    metrics: list[list[dict]] = [[] for _ in range(S)]
    for ci, n_run in _run_chunks(fl.packed, fl.waves, fl.sp.cmax, n_chunks,
                                 skip=skip, grad_fn=grad_fn, gamma=gamma,
                                 ko=fl.sp.ko, impl=impl, shard=fl.shard):
        e = min(K, (ci + 1) * eval_every)
        if eval_fn is not None:
            for s in own:
                m = eval_fn(fl.lane_state(s, e),
                            float(schedules[s].times[e - 1]))
                m["k"] = e
                m["waves"] = n_run
                metrics[s].append(m)
    states: list[RFASTState | None] = [None] * S
    for s in own:
        states[s] = fl.lane_state(s, K)
    return states, metrics


def gather_lane_state(state: RFASTState, mesh, p: int, *,
                      param_axis: str = "model") -> RFASTState:
    """A lane state that ``run_sweep(mesh=...)`` or
    ``run_sweep_epochs(mesh=...)`` returned (or showed ``eval_fn``) on a
    param shard, at full width: every field gathered over the mesh's
    param group (one :func:`all_gather_flat` a field, in field order;
    every rank of the group calls this together), the pad tail cut to
    ``p``.  On a mesh without param shards it is ``state`` itself."""
    if mesh.axis_size(param_axis) == 1:
        return state
    group = mesh.group(param_axis)
    return RFASTState(state.k, *(all_gather_flat(t, group)[..., :p]
                                 for t in state[1:]))


class _Fleet(NamedTuple):
    """One rank's share of a fleet sweep, ready to run (:func:`_fleet`);
    with no mesh, the whole fleet."""

    lay: object              # runtime_sharded.SweepLayout
    sp: SweepPlan            # the rank's lane group's fleet plan
    packed: PackedState      # its state, p_loc wide
    waves: list              # wave_inputs of sp.fleet
    shard: object            # lay when the param axis has M > 1, else None
    e_a_lane: list           # real A-edge count of every padded lane
    n: int

    def lane_state(self, s: int, k: int) -> RFASTState:
        """Lane ``s`` (a global lane index in the rank's group) as views."""
        return _lane_state(self.packed, s - self.lay.lanes.start, k,
                           S=self.lay.S_loc, n=self.n, e_a=self.sp.e_a,
                           e_a_lane=self.e_a_lane[s])


def _fleet(plans, schedules, topos, grad_fn, x0, lay, *, seeds, eval_every,
           device, verify, name="fleet") -> _Fleet:
    """The lane group ``lay`` holds (a
    :class:`~repro_torch.core.runtime_sharded.SweepLayout`, the counterpart
    of the reference's ``_mesh_sweep_scan`` setup): the lanes padded to
    the lane axis (the last repeated), the group's flattened plan at the
    shape maxima of all of them, its state (the ``p_loc`` columns this
    rank holds) and its wave tables.  With ``x0`` the state gets the
    paper init per lane, from the lane's own generators (a param shard
    takes the gradients at full width and keeps its columns); with
    ``x0=None`` it stays zero, for a resume to fill."""
    S, n = len(schedules), plans[0].n
    pad = lay.S_pad - S
    plans = list(plans) + [plans[-1]] * pad
    schedules = list(schedules) + [schedules[-1]] * pad
    seeds = list(seeds) + [seeds[-1]] * pad
    topos = list(topos) + [topos[-1]] * pad
    sp = sweep_plan(plans, schedules, eval_every, verify=verify, topos=topos,
                    lanes=lay.lanes, name=name)
    shard = lay if lay.M > 1 else None
    packed = _zeros_packed(lay.S_loc * n, lay.S_loc * sp.e_a, lay.p_loc,
                           sp.H, device)
    if x0 is not None:
        p = int(x0.shape[-1])
        for j, s in enumerate(lay.lanes):
            x_full = (x0[min(s, S - 1)] if x0.dim() == 3 else x0).expand(n, p)
            blk = packed.nodes[j * n:(j + 1) * n]
            blk[:, 0, :lay.hi - lay.lo].copy_(x_full[:, lay.lo:lay.hi])
            _paper_init(blk, grad_fn, seeds[s], x_full=x_full, shard=shard)
    waves = wave_inputs(sp.fleet, sp.ko, device,
                        [seeds[s] for s in lay.lanes])
    return _Fleet(lay=lay, sp=sp, packed=packed, waves=waves, shard=shard,
                  e_a_lane=[max(1, pl.n_edges_a) for pl in plans], n=n)


# --------------------------------------------------------------------- #
# epochized runs: dynamic membership / time-varying topologies
# --------------------------------------------------------------------- #
def _migrate(st: RFASTState, rho: torch.Tensor, rho_buf: torch.Tensor,
             prev_topo, epoch) -> None:
    """:func:`migrate_state`'s arithmetic, in place on ``st``: its x, v,
    z, g_prev hold the state to migrate, ``rho`` / ``rho_buf`` its ρ and
    ρ̃ in ``prev_topo``'s A-edge layout (padded tails are inert zeros;
    they may be ``st``'s own ρ rows, which are read before they are
    zeroed).  Its ρ, ρ̃ and rings are reset, and ``v_hist[0] = v``."""
    prev_plan = as_comm_plan(prev_topo)
    dev = st.x.device
    root = int(epoch.root)
    joined = np.asarray(epoch.joined, bool)
    if joined.any():
        carried = epoch.topology.active_mask() & ~joined
        if not carried.any():
            raise ValueError("epoch has no carried-over member to "
                             "donate an iterate to its joiners")
        donor = root if not joined[root] else int(np.nonzero(carried)[0][0])

    # (1) settle ρ − ρ̃ at each receiver: a scatter-add, several A-edges
    # may share a receiver
    e = prev_plan.n_edges_a
    if e:
        st.z.index_add_(0, torch.as_tensor(prev_plan.dst_a[:e], device=dev,
                                           dtype=torch.int64),
                        rho[:e] - rho_buf[:e])

    # (2) departures: move the tracked surplus to the new root
    departed = np.asarray(epoch.departed, bool)
    if departed.any():
        dep = torch.as_tensor(departed, device=dev)[:, None]
        d_mass = torch.where(dep, st.z - st.g_prev, 0.0).sum(0)
        st.z.masked_fill_(dep, 0.0)
        st.z[root] += d_mass
        st.g_prev.masked_fill_(dep, 0.0)

    # (3) joiners adopt the donor's iterate, zero tracking
    if joined.any():
        j = torch.as_tensor(np.nonzero(joined)[0], device=dev)
        x_d = st.x[donor].clone()
        for row, val in ((st.x, x_d), (st.v, x_d), (st.z, 0.0),
                         (st.g_prev, 0.0)):
            row[j] = val

    # (4) fresh rings; slot 0 carries v
    for t in (st.rho, st.rho_buf, st.v_hist, st.rho_hist):
        t.zero_()
    st.v_hist[0].copy_(st.v)


def migrate_state(state: RFASTState, prev_topo, epoch, *,
                  H: int) -> RFASTState:
    """Carry an :class:`RFASTState` across a membership-epoch boundary.

    The migration preserves the Lemma-3 invariant exactly, by
    construction:

    1. **Settle in-flight mass.**  Every A-edge's undelivered running-sum
       difference ρ_e − ρ̃_e is added to its receiver's z (an instant
       final delivery), then ρ/ρ̃ and both history rings reset to zero.
    2. **Re-absorb departures.**  A departed node's tracked surplus
       ``z_d − g_prev_d`` moves to the new epoch's root and its z/g_prev
       zero out, so Σz − Σg_prev stays 0.
    3. **Adopt joiners.**  A joining node copies the donor's iterate
       into x and v (the donor is the new root, or the first carried-over
       member when the root itself is joining) with ``z = g_prev = 0``.
    4. **v continuity.**  The new epoch's ``v_hist[0]`` holds the carried
       v: slot 0 is the engines' "no write yet" read.

    ``prev_topo`` identifies the A-edge layout of the state's ρ rows.
    Returns a new state in the NEW epoch's ρ layout with ``H``-deep
    rings and ``k = 0`` (epoch-local).  :func:`run_epochs` runs the same
    arithmetic in place on its packed state.
    """
    n, p = state.x.shape
    e_a = max(1, as_comm_plan(epoch.topology).n_edges_a)
    out = unpack_state(_zeros_packed(n, e_a, p, H, state.x.device), 0)
    for f in ("x", "v", "z", "g_prev"):
        getattr(out, f).copy_(getattr(state, f))
    _migrate(out, state.rho, state.rho_buf, prev_topo, epoch)
    return out


def _epoch_lane_plans(epochs, eval_every: int, *, H: int, kw: int, ka: int,
                      ko: int, e_a: int):
    """Per epoch of one lane: its real CommPlan, that plan degree-padded
    to the shared maxima, and the WavefrontPlan built on it at the
    shared H and ρ layout with its chunk wave bounds."""
    out = []
    for ep in epochs:
        plan = as_comm_plan(ep.topology)
        padded = pad_comm_plan(plan, kw=kw, ka=ka, ko=ko)
        out.append((plan, padded, *_chunked_plan(
            ep.trace.schedule, padded, H, e_a, eval_every)))
    return out


def _rechunk_lane(lane, *, B: int, cmax: int, e_a: int) -> list:
    """Every epoch's plan of one lane with each chunk padded to the
    shared ``(cmax, B)`` wave shape (:func:`_pad_chunks`)."""
    return [_pad_chunks(wf, b, B=B, cmax=cmax, e_a=e_a)
            for *_, wf, b in lane]


def _epoch_diags(pl, trace, lane, rechunked, *, H: int, ko: int,
                 prefix: str = "") -> list:
    """RF101–RF106 over one epochized lane: the trace, and per epoch its
    padded CommPlan, its chunked and rechunked WavefrontPlan against the
    epoch's schedule and the rechunked plan's gather tables."""
    diags = pl.lint_epoch_trace(trace, subject=prefix or "epoch_trace")
    for i, (ep, (_, padded, wf, _), rc) in enumerate(zip(
            trace.epochs, lane, rechunked)):
        sub = f"{prefix}/ep{i}" if prefix else f"ep{i}"
        sched = ep.trace.schedule
        diags += pl.lint_comm_plan(padded, subject=f"{sub}/comm")
        diags += pl.lint_wavefront_plan(wf, comm=padded, schedule=sched,
                                        H=H, subject=sub)
        diags += pl.lint_wavefront_plan(rc, comm=padded, schedule=sched,
                                        H=H, subject=f"{sub}/rechunked")
        diags += _grid_diags(pl, rc, ko, H, f"{sub}/grid_tables")
    return diags


def _epoch_shapes(epochs):
    """Shape maxima over epochs (:func:`_shape_maxima`)."""
    return _shape_maxima([as_comm_plan(ep.topology) for ep in epochs],
                         [ep.trace.schedule for ep in epochs])


def _scan_epochs(epochs, lane, rechunked, packed: PackedState, *, seed: int,
                 cmax: int, ko: int, eval_every: int, eval_fn,
                 chunk_cb, **step) -> tuple[RFASTState, list[dict]]:
    """Drive one epochized lane through the chunk loop: each epoch's
    rechunked plan (:func:`_rechunk_lane`), its events drawing from the
    trace's global event index, and the packed state migrated in place
    at every boundary (no copy of a state that may fill most of the
    card; on a param shard the migration runs on the slice, being linear
    along p)."""
    device = packed.nodes.device
    metrics: list[dict] = []
    for i, (ep, (*_, b), rc) in enumerate(zip(epochs, lane, rechunked)):
        if i:
            st = unpack_state(packed, ep.k0)
            _migrate(st, st.rho, st.rho_buf, epochs[i - 1].topology, ep)
        waves = wave_inputs(rc, ko, device, (seed,), k0=ep.k0)
        times = ep.trace.schedule.times
        for ci, n_run in _run_chunks(packed, waves, cmax, len(b) - 1, ko=ko,
                                     **step):
            e_loc = min(ep.K, (ci + 1) * eval_every)
            kg = ep.k0 + e_loc
            if eval_fn is not None:
                m = eval_fn(unpack_state(packed, kg),
                            ep.t0 + float(times[e_loc - 1]))
                m["k"] = kg
                m["waves"] = n_run
                metrics.append(m)
            if chunk_cb is not None:
                chunk_cb(unpack_state(packed, kg), kg)
    final = unpack_state(packed, epochs[-1].k0 + epochs[-1].K)
    # cut the trace-wide ρ padding back to the last epoch's real layout
    e_fin = max(1, lane[-1][0].n_edges_a)
    return final._replace(rho=final.rho[:e_fin],
                          rho_buf=final.rho_buf[:e_fin],
                          rho_hist=final.rho_hist[:, :e_fin]), metrics


def run_epochs(
    epoch_trace,
    grad_fn,
    x0: torch.Tensor,
    gamma: float,
    *,
    seed: int = 0,
    eval_every: int = 0,
    eval_fn: Callable[[RFASTState, float], dict] | None = None,
    impl: str = "kernel",
    chunk_cb: Callable[[RFASTState, int], None] | None = None,
    device=None,
    verify_plans: bool = False,
) -> tuple[RFASTState, list[dict]]:
    """Run an epochized trace (:meth:`NetworkScenario.realize_epochs`)
    through the wavefront engine.

    Every epoch's CommPlan is degree-normalized (``pad_comm_plan``) and
    its WavefrontPlan padded (``pad_plan``) to the trace-wide maxima —
    history depth H, in/out degrees, ρ layout ``e_a``, wave width B and
    chunk wave count — so the packed state keeps one shape for the whole
    trace and ``impl="kernel"`` commits every non-empty wave of every
    epoch in one ``commit_grid`` launch.  At each boundary the packed
    state is migrated (:func:`migrate_state`'s arithmetic, in place).

    Event k of epoch e draws from ``event_generator(seed, e.k0 + k, i)``
    (the trace's global event index), so a single-epoch (static) trace
    reproduces :func:`run_rfast` on the same schedule bit for bit.
    ``eval_every`` counts events; evaluation also lands on every epoch
    boundary, each metrics entry stamped with the global event count
    ``k``, the global virtual time ``t0 + t_local`` and the chunk's wave
    count ``waves``.  ``device`` defaults to ``cuda``.  Returns the final
    state (views, ρ cut to the last epoch's real A-edge count) and the
    metrics.  ``verify_plans=True`` lints the trace and every epoch's
    plans first (``"run_epochs(verify_plans)"``).
    """
    epochs = list(epoch_trace.epochs)
    if not epochs:
        raise ValueError("epoch trace has no epochs")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    device = dispatch.resolve_device(device)
    grad_fn = as_grad_fn(grad_fn)
    K = int(epoch_trace.K)
    if eval_every <= 0:
        eval_every = K
    H, kw, ka, ko, e_a = _epoch_shapes(epochs)
    lane = _epoch_lane_plans(epochs, eval_every, H=H, kw=kw, ka=ka, ko=ko,
                             e_a=e_a)
    cmax = max(b1 - b0 for *_, b in lane for b0, b1 in zip(b, b[1:]))
    rechunked = _rechunk_lane(lane, B=max(wf.width for *_, wf, _ in lane),
                              cmax=cmax, e_a=e_a)
    if verify_plans:
        _check_plans("run_epochs(verify_plans)", lambda pl: _epoch_diags(
            pl, epoch_trace, lane, rechunked, H=H, ko=ko))
    x0 = torch.as_tensor(x0).to(device=device, dtype=torch.float32)
    packed = _fresh_packed(epoch_trace.n, e_a, H, x0, grad_fn, seed)
    return _scan_epochs(
        epochs, lane, rechunked, packed, seed=seed, cmax=cmax, ko=ko,
        eval_every=eval_every, eval_fn=eval_fn, chunk_cb=chunk_cb,
        grad_fn=grad_fn, gamma=gamma, impl=impl)


def run_sweep_epochs(
    epoch_traces,
    grad_fn,
    x0: torch.Tensor,
    gamma: float,
    *,
    seeds=None,
    eval_every: int = 0,
    eval_fn: Callable[[RFASTState, float], dict] | None = None,
    impl: str = "kernel",
    device=None,
    mesh=None,
    verify_plans: bool = False,
    lane_axis: str = "data",
    param_axis: str | None = "model",
) -> tuple[list[RFASTState], list[list[dict]]]:
    """A fleet of epochized lanes (e.g. one scenario × many seeds from
    :func:`repro_torch.core.scenario.realize_epochs_batch`).

    Membership timelines are lane-local (epoch cuts and regional draws
    differ per seed), so lanes run one after another, every epoch of
    every lane padded to the fleet-wide shape maxima.  Lane s equals
    :func:`run_epochs` of its trace and ``seeds[s]``.  ``x0`` is
    ``(p,)``, ``(n, p)`` or per lane ``(S, n, p)``.
    ``verify_plans=True`` lints every lane's trace and plans before the
    first lane runs (``"run_sweep_epochs(verify_plans)"``).

    ``mesh`` shards the flat PARAMETER axis over ``param_axis`` (large-p
    epochized runs), as :func:`run_sweep` does: one gather a wave, the
    migrations on each rank's slice, and the rank's slice of each lane
    state for ``eval_fn`` and the return (:func:`gather_lane_state`
    rebuilds the full width).  The mesh's lane
    axis must have size 1: lanes stay sequential here because their
    membership timelines are host-driven and lane-local (lane-parallel
    meshes go through :func:`run_sweep`).
    """
    traces = list(epoch_traces)
    S = len(traces)
    if S == 0:
        raise ValueError("run_sweep_epochs needs at least one lane")
    seeds = [0] * S if seeds is None else [int(s) for s in seeds]
    if len(seeds) != S:
        raise ValueError(f"{len(seeds)} seeds for {S} lanes")
    n = traces[0].n
    if any(t.n != n for t in traces):
        raise ValueError("all lanes must share the node count n")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if mesh is not None and mesh.axis_size(lane_axis) != 1:
        raise ValueError(
            "run_sweep_epochs shards the parameter axis only; the mesh's "
            f"{lane_axis!r} axis must have size 1 (lane-parallel meshes go "
            "through run_sweep)")
    device = dispatch.resolve_device(device)
    grad_fn = as_grad_fn(grad_fn)
    if eval_every <= 0:
        eval_every = max(int(t.K) for t in traces)

    H, kw, ka, ko, e_a = _epoch_shapes([ep for t in traces
                                        for ep in t.epochs])
    lanes = [_epoch_lane_plans(list(t.epochs), eval_every, H=H, kw=kw,
                               ka=ka, ko=ko, e_a=e_a) for t in traces]
    B = max(wf.width for lane in lanes for *_, wf, _ in lane)
    cmax = max(b1 - b0 for lane in lanes for *_, b in lane
               for b0, b1 in zip(b, b[1:]))
    rechunked = [_rechunk_lane(lane, B=B, cmax=cmax, e_a=e_a)
                 for lane in lanes]
    if verify_plans:
        _check_plans("run_sweep_epochs(verify_plans)", lambda pl: [
            d for s, (trace, lane, rc) in enumerate(zip(traces, lanes,
                                                        rechunked))
            for d in _epoch_diags(pl, trace, lane, rc, H=H, ko=ko,
                                  prefix=f"lane{s}")])
    x0 = torch.as_tensor(x0).to(device=device, dtype=torch.float32)
    if x0.dim() == 3 and x0.shape[0] != S:
        raise ValueError(f"per-lane x0 has {x0.shape[0]} lanes, "
                         f"expected {S}")
    lay = packed_sweep_specs(mesh, S, int(x0.shape[-1]),
                             lane_axis=lane_axis, param_axis=param_axis)
    shard = lay if lay.M > 1 else None
    states: list[RFASTState] = []
    metrics: list[list[dict]] = []
    for s, (trace, lane) in enumerate(zip(traces, lanes)):
        packed = _fresh_packed(n, e_a, H, x0[s] if x0.dim() == 3 else x0,
                               grad_fn, seeds[s], shard=shard)
        st, ms = _scan_epochs(list(trace.epochs), lane, rechunked[s], packed,
                              seed=seeds[s], cmax=cmax, ko=ko,
                              eval_every=eval_every, eval_fn=eval_fn,
                              chunk_cb=None, grad_fn=grad_fn,
                              gamma=gamma, impl=impl, shard=shard)
        states.append(st)
        metrics.append(ms)
    return states, metrics
