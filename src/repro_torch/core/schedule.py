# Copy of src/repro/core/schedule.py, kept verbatim so the port imports nothing of the
# JAX package; tests/test_torch_planners.py pins identical tables.
"""Asynchronous event-schedule generation for the global-view simulator.

The global view (Algorithm 2) consumes, at every global iteration ``k``:

* ``agent[k]``      — the node that wakes up (``i^k``),
* ``stamp_v[k, e]`` — for every W-edge ``e=(j→i)``, the *global stamp* of the
  ``v_j`` payload available to the receiver (``k - d_{v,j}^k`` in the paper),
* ``stamp_rho[k, e]`` — ditto for ρ payloads on A-edges.

Stamps are produced by the repo-wide virtual-time engine
(:mod:`repro.core.scenario`): every node has a compute-time profile
(stragglers = slower clocks, possibly time-varying), every edge a latency
distribution and a loss channel (Bernoulli or bursty Gilbert-Elliott).
Packets carry the sender's post-update stamp; the receiver always consumes
the *largest stamp delivered so far* (the paper's ``τ`` semantics), which
makes per-edge stamps monotone.  A hard bound ``D_max`` enforces
Assumption 3(ii): if loss/latency would push staleness beyond ``D_max``
iterations, delivery is forced (the paper's model also excludes infinitely
persistent loss).  :func:`generate_schedule` here is the compatibility
shim over that engine; the baselines consume the same engine directly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Topology

__all__ = ["Schedule", "WavefrontPlan", "build_wavefront_plan",
           "pad_plan", "stack_plans", "slice_plan", "concat_plans",
           "flatten_plans", "grid_gather_tables", "generate_schedule",
           "round_robin_schedule"]


@dataclasses.dataclass
class Schedule:
    """Realized asynchronous schedule over K global iterations."""

    agent: np.ndarray       # (K,) int32
    stamp_v: np.ndarray     # (K, E_W) int32, payload stamp per W-edge
    stamp_rho: np.ndarray   # (K, E_A) int32, payload stamp per A-edge
    times: np.ndarray       # (K,) float64 — virtual completion time of event k
    D: int                  # realized max delay bound (for history sizing)
    T: int                  # realized activation-gap bound

    @property
    def K(self) -> int:
        return int(self.agent.shape[0])

    def local_counters(self, n: int) -> np.ndarray:
        """t_i^k for bookkeeping: number of updates of each node up to k."""
        counts = np.zeros((self.K, n), dtype=np.int64)
        c = np.zeros(n, dtype=np.int64)
        for k, a in enumerate(self.agent):
            c[a] += 1
            counts[k] = c
        return counts


def _realized_T(agent: np.ndarray, n: int) -> int:
    """Smallest T such that every window of T events touches every node."""
    last_seen = -np.ones(n, dtype=np.int64)
    gap = 0
    for k, a in enumerate(agent):
        last_seen[a] = k
        if np.all(last_seen >= 0):
            gap = max(gap, k - int(last_seen.min()))
    return int(gap + 1)


def generate_schedule(
    topo: Topology,
    K: int,
    *,
    scenario=None,
    compute_time: np.ndarray | list[float] | None = None,
    jitter: float = 0.2,
    latency: float = 0.1,
    loss_prob: float = 0.0,
    D_max: int | None = None,
    seed: int = 0,
    failures: list[tuple[int, float, float]] | None = None,
) -> Schedule:
    """Realize an asynchronous Schedule under a network scenario.

    The event clock itself lives in
    :meth:`repro.core.scenario.NetworkScenario.realize` — the single
    source of virtual time shared with every baseline.  This wrapper is
    a thin compatibility shim: the historical kwargs build an equivalent
    :class:`~repro.core.scenario.NetworkScenario`, and the RNG draw
    order is bit-identical to the pre-refactor implementation (pinned by
    the golden test in ``tests/test_scenario.py``).

    Args:
      scenario: a :class:`~repro.core.scenario.NetworkScenario`; when
        given, all other model kwargs must stay at their defaults.
      compute_time: per-node mean compute time (straggler = large value);
        defaults to all-ones.
      jitter: multiplicative uniform jitter on each compute interval.
      latency: mean network latency per packet, in compute-time units.
      loss_prob: per-packet Bernoulli loss probability.
      D_max: hard staleness bound (Assumption 3ii); defaults to 4 * n + 16.
      failures: (node, t_start, t_end) downtime windows — the node does
        not wake up inside the window (crash + recovery).  Bounded
        downtime keeps Assumption 3 satisfied with a larger realized T;
        the ρ running sums deliver the accumulated mass on recovery.
    """
    from .scenario import NetworkScenario   # import here: scenario.py
    # imports Schedule from this module
    if scenario is None:
        scenario = NetworkScenario(
            compute_time=(1.0 if compute_time is None
                          else tuple(np.asarray(compute_time, np.float64))),
            jitter=jitter,
            latency=latency,
            loss=loss_prob,
            failures=tuple(failures or ()),
            D_max=D_max,
        )
    elif (compute_time is not None or failures is not None
          or (jitter, latency, loss_prob, D_max) != (0.2, 0.1, 0.0, None)):
        raise ValueError("pass either scenario= or the legacy kwargs, "
                         "not both")
    return scenario.realize(topo, K, seed=seed).schedule


# --------------------------------------------------------------------- #
# wavefront batching: host-side compilation of a Schedule into vmappable
# groups of events with pre-resolved delta-history reads
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class WavefrontPlan:
    """A Schedule compiled for the wavefront-batched simulator.

    Consecutive events are grouped into *wavefronts*: runs of DISTINCT
    agents whose payload stamps all predate the wavefront start, so every
    event in the group reads only pre-wavefront state and writes rows no
    other group member touches — the per-agent S.1–S.5 update can then be
    vmapped across the group inside one ``lax.scan`` step.

    Histories are stored as *deltas*: ``v_hist[c_j mod H, j]`` holds node
    ``j``'s v after its ``c_j``-th own update (row commit, O(p) per event
    instead of an O(n·p) full snapshot), and ``rho_hist[c_e mod H, e]``
    edge ``e``'s running sum after its sender's ``c_e``-th update.  Stale
    reads are resolved HERE, host-side: ``rslot_*`` hold, per event and
    per in-edge slot of the active agent, the history ring slot of the
    sender's last write with emitted stamp ≤ the payload stamp.  Validity
    needs the same ``H ≥ D+2`` bound as the snapshot engine: between a
    payload's write and its latest read (≤ D events later) the writer
    commits at most D+1 more rows, so the ring slot is never reused early.

    Every per-event table the device step needs is pre-gathered here by
    lane (the active agent's neighbour rows of the CommPlan), so the scan
    body touches no plan-indexed gathers — only the four state arrays.
    ρ and ρ̃ live in one ``(2·e_a, p)`` array on the device (ρ̃ rows at
    offset ``e_a``); ``rho_gidx``/``rho_tgt`` index that flat layout, and
    invalid/padded entries carry the sentinel ``2·e_a`` which drop-mode
    scatters discard (``e_a`` defaults to the plan's real A-edge count
    but may be padded up for fleet stacking).  Lane padding uses sentinel
    agent ``n`` (reads clamp, commits drop); ``kidx`` maps lanes to event
    indices (sentinel ``K``) for per-event RNG keys.

    Every per-wave array is *fixed-shape and stackable*: :func:`pad_plan`
    pads a plan to shared (width, wave-count, ρ-layout) maxima with
    provably inert waves/lanes, and :func:`stack_plans` stacks padded
    plans into one fleet plan whose arrays carry a leading ``S`` axis
    (same per-field layout, one more axis — the ``n``/``e_a``/``K``
    sentinels are shared fleet-wide).
    """

    width: int                # B = max wavefront size (<= n)
    n: int                    # node count; sentinel agent id for pad lanes
    e_a: int                  # flat ρ/ρ̃ layout half-size (>= real E_A);
                              #   pad slots carry the sentinel 2·e_a
    K: int                    # event count; kidx sentinel for pad lanes
    agent: np.ndarray         # (n_waves, B) i32, pad = n
    wslot: np.ndarray         # (n_waves, B) i32 ring slot for this write
    w_self: np.ndarray        # (n_waves, B) f32 W[a, a]
    a_self: np.ndarray        # (n_waves, B) f32 A[a, a]
    rslot_v: np.ndarray       # (n_waves, B, kw) i32 resolved v_hist slots
    src_v: np.ndarray         # (n_waves, B, kw) i32 sender node ids
    w_in: np.ndarray          # (n_waves, B, kw) f32 W[a, j] (0 = pad)
    rslot_rho: np.ndarray     # (n_waves, B, ka) i32 resolved rho_hist slots
    hist_epos: np.ndarray     # (n_waves, B, ka) i32 in-A edge rows (hist)
    a_val: np.ndarray         # (n_waves, B, ka) f32 1 = real in-A edge
    rho_gidx: np.ndarray      # (n_waves, B, ko+ka) i32 flat ρ/ρ̃ rows
                              #   (gather AND scatter: each row is owned
                              #   by exactly one lane slot)
    out_wt: np.ndarray        # (n_waves, B, ko) f32 A[dst, a] (0 = pad)
    kidx: np.ndarray          # (n_waves, B) i64 event index, pad = K
    event_start: np.ndarray   # (n_waves,) i64 first event of each wave
                              #   (pad waves carry K: they sort last)
    sizes: np.ndarray         # (n_waves,) i32 valid lanes per wave

    @property
    def n_waves(self) -> int:
        # agent is (n_waves, B) for a single plan, (S, n_waves, B) for a
        # fleet-stacked one: the wave axis is always second-to-last
        return int(self.agent.shape[-2])

    @property
    def n_lanes(self) -> int:
        """Fleet size: 1 for a single plan, S for a stacked one."""
        return 1 if self.agent.ndim == 2 else int(self.agent.shape[0])


# per-wave array fields, in declaration order; every padding/stacking
# helper below treats them uniformly (the wave axis is axis 0 of each)
_WAVE_FIELDS = ("agent", "wslot", "w_self", "a_self", "rslot_v", "src_v",
                "w_in", "rslot_rho", "hist_epos", "a_val", "rho_gidx",
                "out_wt", "kidx", "event_start", "sizes")


def _lane_fill(wf: WavefrontPlan, field: str):
    """The inert fill value of a padded *lane* of ``field``: commits drop
    (sentinel agent / ρ row), reads clamp, weights and validity are 0."""
    return {"agent": wf.n, "rho_gidx": 2 * wf.e_a, "kidx": wf.K}.get(field, 0)


def slice_plan(wf: WavefrontPlan, w0: int, w1: int) -> WavefrontPlan:
    """The sub-plan of waves ``[w0, w1)`` (any contiguous wave range of a
    valid plan is a valid plan: the grouping conditions only reference
    events at or before each wave)."""
    return dataclasses.replace(
        wf, **{f: getattr(wf, f)[w0:w1] for f in _WAVE_FIELDS})


def pad_plan(wf: WavefrontPlan, *, width: int | None = None,
             n_waves: int | None = None,
             e_a: int | None = None) -> WavefrontPlan:
    """Pad a plan to shared maxima so plans from different experiments
    stack into one fleet program.

    * ``width`` — append padded lanes to every wave.  A padded lane
      carries sentinel agent ``n`` (node-row scatters drop), sentinel ρ
      rows ``2·e_a`` (flat-ρ and ρ-history scatters drop), zero weights
      and validity (its reads contribute nothing anywhere), and kidx
      ``K`` (the zero RNG key row) — the same inertness argument as the
      engine's own chunk padding and the RavelSpec pad tail.
    * ``n_waves`` — append all-padded waves (every lane inert as above;
      ``event_start = K`` keeps the array sorted, ``sizes = 0``).
    * ``e_a`` — re-target the flat ρ/ρ̃ layout to a larger half-size:
      ρ rows keep their positions, ρ̃ rows shift by the new offset, and
      sentinels become ``2·e_a_new``.  The extra state rows are never
      referenced by any real lane.
    """
    width = wf.width if width is None else int(width)
    n_w = wf.n_waves if n_waves is None else int(n_waves)
    e_a_new = wf.e_a if e_a is None else int(e_a)
    if width < wf.width or n_w < wf.n_waves or e_a_new < wf.e_a:
        raise ValueError(
            f"cannot shrink a plan: have (width={wf.width}, "
            f"n_waves={wf.n_waves}, e_a={wf.e_a}), asked for "
            f"({width}, {n_w}, {e_a_new})")
    out = {f: getattr(wf, f) for f in _WAVE_FIELDS}
    if e_a_new != wf.e_a:
        g = out["rho_gidx"]
        out["rho_gidx"] = np.where(
            g < wf.e_a, g,
            np.where(g < 2 * wf.e_a, g + (e_a_new - wf.e_a),
                     2 * e_a_new)).astype(g.dtype)
    wf2 = dataclasses.replace(wf, e_a=e_a_new)   # fills use the new layout
    if width != wf.width:
        for f in _WAVE_FIELDS:
            a = out[f]
            if a.ndim < 2:          # event_start / sizes have no lane axis
                continue
            pad = np.full((a.shape[0], width - wf.width) + a.shape[2:],
                          _lane_fill(wf2, f), a.dtype)
            out[f] = np.concatenate([a, pad], axis=1)
    if n_w != wf.n_waves:
        extra = n_w - wf.n_waves
        for f in _WAVE_FIELDS:
            a = out[f]
            if f == "event_start":
                fill = wf.K          # padded waves sort after every event
            elif f == "sizes":
                fill = 0
            else:
                fill = _lane_fill(wf2, f)
            pad = np.full((extra,) + a.shape[1:], fill, a.dtype)
            out[f] = np.concatenate([a, pad], axis=0)
    return dataclasses.replace(wf2, width=width, **out)


def concat_plans(plans: "list[WavefrontPlan]") -> WavefrontPlan:
    """Concatenate plans along the wave axis (inverse of chunk-wise
    :func:`slice_plan`; all parts must share width and layout)."""
    first = plans[0]
    for wf in plans[1:]:
        if (wf.width, wf.n, wf.e_a, wf.K) != (first.width, first.n,
                                              first.e_a, first.K):
            raise ValueError("concat_plans needs identical width/n/e_a/K")
    return dataclasses.replace(
        first, **{f: np.concatenate([getattr(w, f) for w in plans], axis=0)
                  for f in _WAVE_FIELDS})


def flatten_plans(stacked: WavefrontPlan) -> WavefrontPlan:
    """Lower a fleet-stacked plan to ONE wider single-experiment plan.

    The S lanes of wave w become S·B lanes of one wave by offsetting
    every index into lane-private blocks: nodes of lane s live at
    ``[s·n, (s+1)·n)`` (so the fleet node state is ``(S·n, 4, p)``),
    ρ rows at ``[s·e_a, (s+1)·e_a)`` with ρ̃ at offset ``S·e_a`` (state
    ``(2·S·e_a, p)``, histories ``(H, S·n, p)``/``(H, S·e_a, p)``), and
    events at ``[s·K, (s+1)·K)`` (per-lane RNG streams concatenate).
    Sentinels map to the fleet-wide sentinels ``S·n``/``2·S·e_a``/``S·K``.

    Correctness is index disjointness: every cross-event interaction in
    a WavefrontPlan happens through these indices, lanes' blocks are
    disjoint, and padded slots still drop — so the flat program is
    exactly the S independent programs, interleaved.  The payoff is the
    compile: the scan body is the *single-experiment* wave step at width
    S·B (no fleet vmap), so the fleet compiles like one run.

    ``event_start``/``sizes`` become fleet aggregates (earliest flat
    event / total lanes per wave) — chunk alignment must be done before
    stacking (as ``run_sweep`` does).
    """
    if stacked.agent.ndim != 3:
        raise ValueError("flatten_plans expects a stack_plans output "
                         "(arrays with a leading S axis)")
    S = stacked.n_lanes
    n, e_a, K, B = stacked.n, stacked.e_a, stacked.K, stacked.width
    NW = stacked.n_waves
    s_off = np.arange(S, dtype=np.int64)[:, None, None]

    def flat(a):
        """(S, NW, B, ...) -> (NW, S*B, ...)"""
        return np.moveaxis(a, 0, 1).reshape((NW, S * a.shape[2])
                                            + a.shape[3:])

    agent = np.where(stacked.agent == n, S * n, stacked.agent + s_off * n)
    src_v = stacked.src_v + s_off[..., None] * n
    hist_epos = stacked.hist_epos + s_off[..., None] * e_a
    g = stacked.rho_gidx
    gidx = np.where(
        g < e_a, g + s_off[..., None] * e_a,
        np.where(g < 2 * e_a, g + (S - 1 + s_off[..., None]) * e_a,
                 2 * S * e_a))
    kidx = np.where(stacked.kidx == K, S * K, stacked.kidx + s_off * K)
    return dataclasses.replace(
        stacked, width=S * B, n=S * n, e_a=S * e_a, K=S * K,
        agent=flat(agent).astype(np.int32),
        wslot=flat(stacked.wslot), w_self=flat(stacked.w_self),
        a_self=flat(stacked.a_self),
        rslot_v=flat(stacked.rslot_v),
        src_v=flat(src_v).astype(np.int32),
        w_in=flat(stacked.w_in), rslot_rho=flat(stacked.rslot_rho),
        hist_epos=flat(hist_epos).astype(np.int32),
        a_val=flat(stacked.a_val),
        rho_gidx=flat(gidx).astype(np.int32),
        out_wt=flat(stacked.out_wt),
        kidx=flat(kidx),
        event_start=(stacked.event_start
                     + np.arange(S, dtype=np.int64)[:, None] * K).min(0),
        sizes=stacked.sizes.sum(0).astype(np.int32),
    )


def grid_gather_tables(agent, rslot_rho, hist_epos, rho_gidx, *,
                       e_a_flat: int, ko: int):
    """Flat-row gather tables for the fleet-grid commit kernel.

    Translates one wave's lane tables (slices of a — possibly
    fleet-flattened — :class:`WavefrontPlan`) into row indices over the
    flat device state the grid kernel reads directly:

    * ``idx_z``/``idx_g`` — rows of ``nodes.reshape(N·4, p)`` (node
      layout x, v, z, g_prev → z at ``4a+2``, g_prev at ``4a+3``),
    * ``idx_ri``          — rows of ``rho_hist.reshape(H·E, p)``
      (``slot·E + epos``),
    * ``idx_ro``/``idx_rb`` — the ρ-out / ρ̃ halves of ``rho_gidx``
      (rows of the flat ``(2E, p)`` ρ state; the split mirrors the
      plan's ko-first row ordering).

    ``e_a_flat`` is the flat ρ half-size E (``S·e_a`` after
    :func:`flatten_plans`).  Sentinel entries pass through untranslated
    (``commit_grid`` clamps reads; commits drop at the caller's
    scatters).  Works on numpy arrays and jax tracers alike.
    """
    agent = agent.astype("int32") * 4
    return (agent + 2, agent + 3,
            rslot_rho.astype("int32") * e_a_flat
            + hist_epos.astype("int32"),
            rho_gidx[..., ko:], rho_gidx[..., :ko])


def stack_plans(plans: "list[WavefrontPlan]") -> WavefrontPlan:
    """Stack per-experiment plans into one fleet plan with a leading
    ``S`` axis on every per-wave array.

    Plans are first padded (:func:`pad_plan`) to the fleet-wide
    (width, wave-count, ρ-layout) maxima; they must already share ``n``,
    ``K``, and the per-node degree maxima (kw, ka, ko) — normalize
    CommPlans from different topologies with
    :func:`repro.core.plan.pad_comm_plan` before building them.
    """
    if not plans:
        raise ValueError("stack_plans needs at least one plan")
    ns = {wf.n for wf in plans}
    Ks = {wf.K for wf in plans}
    if len(ns) != 1 or len(Ks) != 1:
        raise ValueError(f"plans must share n and K, got n={ns}, K={Ks}")
    degs = {(wf.rslot_v.shape[-1], wf.rslot_rho.shape[-1],
             wf.out_wt.shape[-1]) for wf in plans}
    if len(degs) != 1:
        raise ValueError(
            f"plans carry different (kw, ka, ko) degree maxima {degs}; "
            "pad the CommPlans with plan.pad_comm_plan first")
    width = max(wf.width for wf in plans)
    n_waves = max(wf.n_waves for wf in plans)
    e_a = max(wf.e_a for wf in plans)
    padded = [pad_plan(wf, width=width, n_waves=n_waves, e_a=e_a)
              for wf in plans]
    return dataclasses.replace(
        padded[0],
        **{f: np.stack([getattr(w, f) for w in padded]) for f in _WAVE_FIELDS})


def _write_counters(agent: np.ndarray, n: int) -> np.ndarray:
    """c[k] = how many times agent[k] has updated up to and including k."""
    c = np.zeros(agent.shape[0], dtype=np.int64)
    for j in range(n):
        idx = np.nonzero(agent == j)[0]
        c[idx] = np.arange(1, idx.shape[0] + 1)
    return c


def _resolve_read_slots(stamps: np.ndarray, owner: np.ndarray,
                        emit: list[np.ndarray], H: int,
                        n_real: int) -> np.ndarray:
    """Per (event, edge): ring slot of the owner's last write with emitted
    stamp <= stamps[k, e] (slot 0 = the zero-initialized 'no write yet')."""
    out = np.zeros(stamps.shape, dtype=np.int32)
    for e in range(n_real):
        w = np.searchsorted(emit[int(owner[e])], stamps[:, e], side="right")
        out[:, e] = w % H
    return out


def build_wavefront_plan(schedule: Schedule, plan, H: int, *,
                         break_every: int = 0,
                         max_width: int | None = None,
                         e_a: int | None = None) -> WavefrontPlan:
    """Compile ``schedule`` into a :class:`WavefrontPlan` over ``plan``
    (a :class:`repro.core.plan.CommPlan`).

    ``break_every``: force wavefront boundaries at multiples of this event
    index (so evaluation chunks map to whole waves); 0 = no forced breaks.
    ``max_width``: split wavefronts wider than this (any prefix split of a
    valid wavefront is valid — the grouping conditions are monotone in the
    start index).  Padded lanes cost real gradient compute, so the default
    picks the width minimizing modelled cost (scan steps + padded lanes)
    over the realized size distribution.
    ``e_a``: half-size of the flat ρ/ρ̃ state layout the plan indexes
    into; defaults to the plan's real A-edge count, and may be padded up
    front (e.g. to a fleet-wide maximum) instead of remapped later with
    :func:`pad_plan`.
    """
    agent = np.asarray(schedule.agent, dtype=np.int64)
    K, n = agent.shape[0], plan.n
    ev = np.arange(K)

    # per-event gathered in-edge tables of the active agent
    iw_e = plan.in_w_epos[agent]                      # (K, kw)
    ia_e = plan.in_a_epos[agent]                      # (K, ka)
    sv = schedule.stamp_v[ev[:, None], iw_e]          # (K, kw)
    sr = schedule.stamp_rho[ev[:, None], ia_e]        # (K, ka)
    w_ok = plan.in_w_wt[agent] != 0
    a_ok = plan.in_a_val[agent] > 0
    rel = np.maximum(np.where(w_ok, sv, 0).max(axis=1, initial=0),
                     np.where(a_ok, sr, 0).max(axis=1, initial=0))

    # delta-history write slots + host-resolved read slots
    wslot = (_write_counters(agent, n) % H).astype(np.int32)
    emit = [np.nonzero(agent == j)[0] + 1 for j in range(n)]
    slots_v = _resolve_read_slots(schedule.stamp_v, plan.src_w, emit, H,
                                  plan.n_edges_w)
    slots_r = _resolve_read_slots(schedule.stamp_rho, plan.src_a, emit, H,
                                  plan.n_edges_a)
    rslot_v = slots_v[ev[:, None], iw_e]              # (K, kw)
    rslot_rho = slots_r[ev[:, None], ia_e]            # (K, ka)

    # flat ρ/ρ̃ indices: ρ rows at [0, e_a), ρ̃ rows at [e_a, 2·e_a);
    # sentinel 2·e_a marks pad slots (drop-mode scatters discard them)
    if e_a is None:
        e_a = max(1, plan.n_edges_a)
    elif e_a < max(1, plan.n_edges_a):
        raise ValueError(f"e_a={e_a} < the plan's A-edge count "
                         f"{plan.n_edges_a}")
    oa_e, ia_e2 = plan.out_a_epos[agent], plan.in_a_epos[agent]
    o_ok = plan.out_a_val[agent] > 0
    gidx = np.concatenate([np.where(o_ok, oa_e, 2 * e_a),
                           np.where(a_ok, e_a + ia_e2, 2 * e_a)], axis=1)

    # greedy grouping into wavefronts
    starts = [0]
    used = {int(agent[0])}
    for k in range(1, K):
        if ((break_every and k % break_every == 0)
                or int(agent[k]) in used or int(rel[k]) > starts[-1]):
            starts.append(k)
            used = {int(agent[k])}
        else:
            used.add(int(agent[k]))
    starts.append(K)
    sizes = np.diff(np.asarray(starts, dtype=np.int64))

    # split over-wide wavefronts: padded lanes still pay for a vmapped
    # gradient, so a narrower width with a few more scan steps is usually
    # cheaper; the model charges ~1.3 lane-units of fixed per-wave cost
    if max_width is None:
        cands = range(1, int(sizes.max()) + 1)
        cost = lambda B: (1.3 * np.ceil(sizes / B).sum()
                          + (np.ceil(sizes / B) * B).sum())
        max_width = min(cands, key=cost)
    if sizes.max() > max_width:
        split = []
        for s0, sz in zip(starts[:-1], sizes):
            split.extend(range(int(s0), int(s0 + sz), max_width))
        starts = split + [K]
        sizes = np.diff(np.asarray(starts, dtype=np.int64))

    n_waves, B = sizes.shape[0], int(sizes.max())
    event_start = np.asarray(starts[:-1], dtype=np.int64)

    lane = event_start[:, None] + np.arange(B)[None, :]     # (n_waves, B)
    valid = np.arange(B)[None, :] < sizes[:, None]
    kidx = np.where(valid, lane, K)
    pick = lambda arr, pad: np.where(
        valid.reshape(valid.shape + (1,) * (arr.ndim - 1)),
        arr[np.minimum(lane, K - 1)], pad)
    i32 = lambda a: np.asarray(a, np.int32)
    f32 = lambda a: np.asarray(a, np.float32)
    return WavefrontPlan(
        width=B,
        n=n,
        e_a=int(e_a),
        K=K,
        agent=i32(pick(agent, n)),
        wslot=i32(pick(wslot, 0)),
        w_self=f32(pick(plan.w_diag[agent], 0.0)),
        a_self=f32(pick(plan.a_diag[agent], 0.0)),
        rslot_v=i32(pick(rslot_v, 0)),
        src_v=i32(pick(plan.in_w_src[agent], 0)),
        w_in=f32(pick(plan.in_w_wt[agent], 0.0)),
        rslot_rho=i32(pick(rslot_rho, 0)),
        hist_epos=i32(pick(ia_e2, 0)),
        a_val=f32(pick(plan.in_a_val[agent], 0.0)),
        rho_gidx=i32(pick(gidx, 2 * e_a)),
        out_wt=f32(pick(plan.out_a_wt[agent], 0.0)),
        kidx=kidx,
        event_start=event_start,
        sizes=sizes.astype(np.int32),
    )


def round_robin_schedule(topo: Topology, n_rounds: int) -> Schedule:
    """Remark 2: the synchronous counterpart as a global-view schedule.

    ``i^k = k mod n``; at its local iteration ``t`` (global ``k = t·n + i``)
    node ``i`` consumes neighbour ``j``'s payload with local stamp ``t``,
    i.e. global stamp ``(t-1)·n + j + 1`` (0 for t = 0).  Realized delay is
    ``n + i - j - 1 ≤ 2n - 2`` exactly as the paper computes.
    """
    n = topo.n
    K = n_rounds * n
    edges_w = topo.edges_W()
    edges_a = topo.edges_A()
    agent = np.arange(K, dtype=np.int32) % n
    stamp_v = np.zeros((K, max(1, len(edges_w))), dtype=np.int32)
    stamp_rho = np.zeros((K, max(1, len(edges_a))), dtype=np.int32)
    for k in range(K):
        t = k // n
        for e, (j, _i) in enumerate(edges_w):
            stamp_v[k, e] = 0 if t == 0 else (t - 1) * n + j + 1
        for e, (j, _i) in enumerate(edges_a):
            stamp_rho[k, e] = 0 if t == 0 else (t - 1) * n + j + 1
    return Schedule(
        agent=agent,
        stamp_v=stamp_v,
        stamp_rho=stamp_rho,
        times=np.arange(K, dtype=np.float64) / n,
        D=max(1, 2 * n - 2),
        T=n,
    )
