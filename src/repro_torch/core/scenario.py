# Copy of src/repro/core/scenario.py, kept verbatim so the port imports nothing of the
# JAX package; tests/test_torch_planners.py pins identical tables.
"""One virtual-time scenario engine for R-FAST and every baseline.

The paper's headline claim (Fig. 5-6) is a *time-to-loss* claim, so every
cross-algorithm comparison is only meaningful when all algorithms
experience the same delay/failure model (Lian et al. 2018; Assran et al.
2020).  This module owns that model: a declarative
:class:`NetworkScenario` plus the single event-clock core that is the
only source of virtual time in the repo.

Two clocks, one model:

* :meth:`NetworkScenario.realize` — the asynchronous event clock.  Every
  node runs its own virtual clock (per-node compute rates, multiplicative
  jitter, *time-varying* straggler windows, crash/recovery windows);
  every packet traverses a lossy, delayed channel (per-edge latency
  means, Bernoulli or bursty Gilbert-Elliott loss).  The result is a
  :class:`ScenarioTrace`: the realized :class:`~repro.core.schedule.Schedule`
  (activations + per-edge payload stamps, consumed by ``run_rfast`` and
  the async baselines) plus the per-event send outcomes (consumed by
  OSGP's mailboxes, which — unlike R-FAST's running sums — lose the mass
  of dropped packets).
* :meth:`NetworkScenario.sync_round_times` — the synchronous barrier
  clock, built from the *same* primitives: a round ends when the slowest
  node (stragglers, crash stalls included) finishes its compute AND every
  edge has delivered, with lost packets retransmitted.

The default-parameter ``realize`` path consumes its RNG stream in exactly
the order the pre-refactor ``schedule.generate_schedule`` did, so the
compatibility shim reproduces historical schedules bit-for-bit (pinned by
a golden test).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np

from .schedule import Schedule, _realized_T
from .topology import Topology, epoch_topology

__all__ = [
    "GilbertElliott", "EdgeChannels", "NetworkScenario", "ScenarioTrace",
    "Epoch", "EpochTrace",
    "SCENARIOS", "get_scenario", "realize_batch", "realize_epochs_batch",
]


# --------------------------------------------------------------------- #
# loss channels
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GilbertElliott:
    """Bursty two-state loss channel (per packet: state step, then loss).

    ``p_gb``/``p_bg`` are the good->bad / bad->good transition
    probabilities per packet; ``loss_good``/``loss_bad`` the loss
    probability within each state.  Stationary loss rate is
    ``pi_bad * loss_bad + (1 - pi_bad) * loss_good`` with
    ``pi_bad = p_gb / (p_gb + p_bg)``; mean burst length ``1 / p_bg``.
    """

    p_gb: float
    p_bg: float
    loss_good: float = 0.0
    loss_bad: float = 1.0


class EdgeChannels:
    """Per-edge loss processes sharing one RNG stream.

    Bernoulli mode draws exactly one uniform per packet (the pre-refactor
    draw order, needed for the ``generate_schedule`` golden test);
    Gilbert-Elliott mode keeps an independent good/bad state per edge and
    draws two uniforms per packet (state transition, then loss).
    """

    def __init__(self, n_edges: int, loss: float,
                 ge: GilbertElliott | None, rng: np.random.Generator):
        self.loss = float(loss)
        self.ge = ge
        self.rng = rng
        self.bad = np.zeros(n_edges, dtype=bool)   # GE state (start good)

    def ok(self, e: int) -> bool:
        """One packet on edge ``e``: True = delivered, False = lost."""
        if self.ge is None:
            return bool(self.rng.uniform() >= self.loss)
        flip = self.ge.p_bg if self.bad[e] else self.ge.p_gb
        if self.rng.uniform() < flip:
            self.bad[e] = not self.bad[e]
        p = self.ge.loss_bad if self.bad[e] else self.ge.loss_good
        return bool(self.rng.uniform() >= p)


# --------------------------------------------------------------------- #
# the scenario
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ScenarioTrace:
    """One realization of a scenario on a topology: the Schedule all
    algorithms consume, plus per-event send outcomes (True = the active
    agent's packet on that out-edge was delivered; rows of inactive
    agents are False)."""

    schedule: Schedule
    send_ok_w: np.ndarray   # (K, max(1, E_W)) bool
    send_ok_a: np.ndarray   # (K, max(1, E_A)) bool


@dataclasses.dataclass(frozen=True)
class Epoch:
    """One membership epoch of a dynamic scenario: a fixed topology (with
    its ``active`` mask), the trace realized over it, and the membership
    delta against the previous epoch (what :func:`~repro.core.simulator.
    migrate_state` must absorb at the transition into this epoch)."""

    topology: Topology
    trace: ScenarioTrace
    t0: float             # virtual-time offset of this epoch's clock 0
    k0: int               # global event offset of this epoch's event 0
    joined: np.ndarray    # (n,) bool: nodes active now, inactive before
    departed: np.ndarray  # (n,) bool: nodes inactive now, active before
    root: int             # the epoch's elected common root (global id)

    @property
    def K(self) -> int:
        return int(len(self.trace.schedule.agent))


@dataclasses.dataclass(frozen=True)
class EpochTrace:
    """A scenario realization partitioned into membership epochs, each
    with its own validated topology — the input of
    :func:`~repro.core.simulator.run_epochs`.  Static scenarios yield a
    single epoch whose trace is bit-identical to :meth:`NetworkScenario.
    realize`."""

    epochs: tuple[Epoch, ...]
    n: int
    K: int

    @property
    def dynamic(self) -> bool:
        return len(self.epochs) > 1


@dataclasses.dataclass(frozen=True)
class NetworkScenario:
    """Declarative network/compute model shared by every algorithm.

    Args:
      compute_time: per-node mean compute interval — scalar or length-n
        sequence (straggler = large value).
      jitter: multiplicative uniform jitter on each compute interval.
      latency: mean packet latency (exponential), in compute-time units.
      edge_latency: per-edge overrides of ``latency``, keyed ``(src, dst)``.
      loss: per-packet Bernoulli loss probability.
      gilbert_elliott: when set, replaces Bernoulli loss with a bursty
        two-state channel per edge.
      stragglers: *time-varying* slowdowns ``(node, t0, t1, factor)`` —
        inside ``[t0, t1)`` the node's compute interval is multiplied by
        ``factor`` (factors of overlapping windows compose).
      failures: crash/recovery windows ``(node, t0, t1)`` — the node does
        not wake inside the window; bounded downtime keeps Assumption 3
        satisfied with a larger realized T.
      joins: dynamic membership ``(node, t_join)`` — the node is not a
        member before ``t_join`` (a ``t_join`` of 0 means member from the
        start).  Under :meth:`realize_epochs` a join opens a new epoch
        (the node enters with the root's iterate); under the frozen
        :meth:`realize` it degrades to a first-wake delay.
      leaves: dynamic membership ``(node, t_leave)`` — the node departs
        permanently at ``t_leave``.  Under :meth:`realize_epochs` this
        opens a new epoch (with root re-election when the departing node
        was a common root); under the frozen :meth:`realize` it degrades
        to a crash window that never ends — which is exactly how a
        frozen plan *fails* when the sole common root leaves.
      regional_failures: correlated failure groups
        ``(nodes, t0, t1, prob)`` — ONE Bernoulli(prob) draw per group;
        when it fires, every node in the group gets the crash window
        ``[t0, t1)`` together (rack/region outage).
      D_max: hard staleness bound (Assumption 3ii); default ``4n + 16``.
      name: optional label (used by benchmark rows).
    """

    compute_time: float | Sequence[float] = 1.0
    jitter: float = 0.2
    latency: float = 0.1
    edge_latency: Mapping[tuple[int, int], float] | None = None
    loss: float = 0.0
    gilbert_elliott: GilbertElliott | None = None
    stragglers: tuple[tuple[int, float, float, float], ...] = ()
    failures: tuple[tuple[int, float, float], ...] = ()
    joins: tuple[tuple[int, float], ...] = ()
    leaves: tuple[tuple[int, float], ...] = ()
    regional_failures: tuple[
        tuple[tuple[int, ...], float, float, float], ...] = ()
    D_max: int | None = None
    name: str = ""

    @property
    def dynamic(self) -> bool:
        """True when the scenario can change the member set mid-run —
        such scenarios should realize through :meth:`realize_epochs`
        (the frozen :meth:`realize` only *degrades* them)."""
        return bool(self.joins or self.leaves or self.regional_failures)

    # -- per-node / per-edge resolution ------------------------------- #
    def node_compute(self, n: int) -> np.ndarray:
        base = np.asarray(self.compute_time, dtype=np.float64)
        if base.ndim == 0:
            base = np.full(n, float(base))
        if base.shape != (n,):
            raise ValueError(
                f"compute_time must be scalar or length {n}, got "
                f"shape {base.shape}")
        return base

    def edge_latency_of(self, edges: list[tuple[int, int]]) -> np.ndarray:
        lat = np.full(max(1, len(edges)), float(self.latency))
        for e, (j, i) in enumerate(edges):
            if self.edge_latency and (j, i) in self.edge_latency:
                lat[e] = float(self.edge_latency[(j, i)])
        return lat

    def slow_factor(self, node: int, t: float) -> float:
        f = 1.0
        for (i, t0, t1, factor) in self.stragglers:
            if i == node and t0 <= t < t1:
                f *= factor
        return f

    def in_failure(self, node: int, t: float) -> bool:
        return any(i == node and t0 <= t < t1 for (i, t0, t1) in self.failures)

    def channels(self, n_edges: int, rng: np.random.Generator) -> EdgeChannels:
        return EdgeChannels(n_edges, self.loss, self.gilbert_elliott, rng)

    def resolved_D_max(self, n: int) -> int:
        """The Assumption-3(ii) staleness bound actually enforced —
        the single source for every consumer (realize's forced delivery,
        AD-PSGD's partner-read clamp/ring sizing)."""
        return self.D_max if self.D_max is not None else 4 * n + 16

    # -- dynamic membership helpers ----------------------------------- #
    def _effective_failures(self, rng: np.random.Generator) \
            -> list[tuple[int, float, float]]:
        """Crash windows actually in force this realization: the declared
        ``failures`` plus every *fired* regional group (one Bernoulli
        draw per group — drawn only when groups exist, so the default
        RNG stream is untouched and historical schedules stay golden)."""
        eff = [(int(i), float(t0), float(t1)) for (i, t0, t1)
               in self.failures]
        if self.regional_failures:
            draws = rng.uniform(size=len(self.regional_failures))
            for (group, t0, t1, p), u in zip(self.regional_failures,
                                             draws):
                if u < p:
                    eff += [(int(i), float(t0), float(t1))
                            for i in group]
        return eff

    def _membership_windows(self) -> list[tuple[int, float, float]]:
        """joins/leaves degraded to frozen-graph crash windows: a leave
        is a crash that never recovers, a join a crash since forever."""
        wins = [(int(j), float(t), np.inf) for (j, t) in self.leaves]
        wins += [(int(j), -np.inf, float(t)) for (j, t) in self.joins
                 if t > 0.0]
        return wins

    def _epoch_scenario(self, t0: float,
                        eff_failures: list[tuple[int, float, float]]) \
            -> "NetworkScenario":
        """This scenario re-expressed in one epoch's local clock: windows
        shifted by ``-t0`` (expired ones dropped), membership fields
        cleared (the epoch's ``Topology.active`` mask owns membership),
        regional draws already resolved into ``eff_failures``."""
        strag = tuple((i, s0 - t0, s1 - t0, f)
                      for (i, s0, s1, f) in self.stragglers if s1 > t0)
        fails = tuple((i, f0 - t0, f1 - t0)
                      for (i, f0, f1) in eff_failures if f1 > t0)
        return dataclasses.replace(
            self, stragglers=strag, failures=fails,
            joins=(), leaves=(), regional_failures=())

    def _epoch_timeline(self, topo: Topology,
                        eff_failures: list[tuple[int, float, float]],
                        max_epochs: int = 64) \
            -> list[tuple[float, float, np.ndarray, Topology]]:
        """Partition [0, inf) into membership epochs ``(t0, t1, active,
        topology)``.

        Boundaries come from joins/leaves and from the re-election
        trigger: a crash window opening on a node that is currently a
        *common root* converts into a leave-at-``t0`` / rejoin-at-``t1``
        pair (the fleet rewires around the crashed root instead of
        stalling on it).  Each epoch's topology is
        :func:`~repro.core.topology.epoch_topology` of the surviving
        member set — restriction when Assumption 2 survives, tree
        rebuild around a re-elected root otherwise; a ``ValueError``
        propagates when neither is possible.
        """
        n = topo.n
        active = np.ones(n, dtype=bool)
        pending: list[tuple[float, int, bool]] = []
        for (j, tj) in self.joins:
            if tj > 0.0:
                active[int(j)] = False
                pending.append((float(tj), int(j), True))
        for (j, tj) in self.leaves:
            pending.append((float(tj), int(j), False))
        handled: set[tuple[int, float, float]] = set()
        out: list[tuple[float, float, np.ndarray, Topology]] = []
        t = 0.0
        prev_root: int | None = None
        for _ in range(max_epochs):
            if not active.any():
                raise ValueError("membership timeline empties the graph")
            if active.all() and topo.active is None:
                etopo = topo          # static full-membership epoch
            else:
                etopo = epoch_topology(topo, active, prefer=prev_root)
            roots_now = etopo.common_roots
            prev_root = int(roots_now[0])
            tm = min((tt for (tt, _, _) in pending if tt > t),
                     default=np.inf)
            tr, win = np.inf, None
            for w in eff_failures:
                (fn, t0, t1) = w
                if (w not in handled and int(fn) in roots_now
                        and t0 > t and t1 > t0 and t0 < tr):
                    tr, win = t0, w
            b = min(tm, tr)
            if not np.isfinite(b):
                out.append((t, np.inf, active.copy(), etopo))
                return out
            if win is not None and tr <= tm:
                handled.add(win)
                (fn, t0, t1) = win
                pending.append((float(t0), int(fn), False))
                if np.isfinite(t1):
                    pending.append((float(t1), int(fn), True))
            out.append((t, float(b), active.copy(), etopo))
            still = []
            for (tt, node, on) in pending:
                if tt <= b:
                    active[node] = on
                else:
                    still.append((tt, node, on))
            pending = still
            t = float(b)
        raise ValueError(f"membership timeline exceeds {max_epochs} "
                         f"epochs")

    def realize_epochs(self, topo: Topology, K: int, *, seed: int = 0,
                       max_epochs: int = 64) -> EpochTrace:
        """Realize the scenario as an epochized trace: one validated
        (Topology, ScenarioTrace) per membership epoch, K events total.

        Regional-failure draws happen once up front; the membership
        timeline then fixes the epochs, the global event budget ``K`` is
        split across them in proportion to expected wake counts
        (duration × aggregate active wake rate, every epoch keeping at
        least one event), and each epoch realizes independently over its
        own topology in its own local clock (windows shifted, inactive
        nodes never wake).  Static scenarios return one epoch whose
        trace is bit-identical to :meth:`realize` — the oracle the
        epochized engine is pinned against.
        """
        rng = np.random.default_rng(seed)
        eff = self._effective_failures(rng)
        timeline = self._epoch_timeline(topo, eff, max_epochs=max_epochs)
        n = topo.n
        n_ep = len(timeline)
        if K < n_ep:
            raise ValueError(f"K={K} cannot cover {n_ep} epochs")
        base = self.node_compute(n)
        exp = [max(1.0, (t1 - t0) * float(np.sum(1.0 / base[act])))
               for (t0, t1, act, _e) in timeline[:-1]]
        ks = [max(1, int(round(v))) for v in exp]
        if sum(ks) > K - 1:          # budget overrun: rescale, floor 1
            scale = (K - n_ep) / max(1, sum(ks))
            ks = [max(1, int(v * scale)) for v in ks]
        ks.append(K - sum(ks))
        epochs: list[Epoch] = []
        k0 = 0
        prev_act: np.ndarray | None = None
        for e, ((t0, _t1, act, etopo), Ke) in enumerate(zip(timeline,
                                                            ks)):
            sd = seed if e == 0 else int(
                np.random.SeedSequence([seed, e]).generate_state(1)[0])
            trace = self._epoch_scenario(t0, eff).realize(etopo, Ke,
                                                          seed=sd)
            joined = (act & ~prev_act if prev_act is not None
                      else np.zeros(n, dtype=bool))
            departed = (prev_act & ~act if prev_act is not None
                        else np.zeros(n, dtype=bool))
            epochs.append(Epoch(topology=etopo, trace=trace,
                                t0=float(t0), k0=k0, joined=joined,
                                departed=departed,
                                root=int(etopo.common_roots[0])))
            k0 += Ke
            prev_act = act
        return EpochTrace(epochs=tuple(epochs), n=n, K=K)

    # ----------------------------------------------------------------- #
    # the asynchronous event clock (the only one in the repo)
    # ----------------------------------------------------------------- #
    def realize(self, topo: Topology, K: int, *, seed: int = 0) -> ScenarioTrace:
        """Simulate virtual clocks + network over ``topo`` for ``K`` events.

        Packets carry the sender's post-update stamp; a receiver always
        consumes the largest stamp delivered so far (the paper's ``tau``
        semantics), so per-edge stamps are monotone.  ``D_max`` enforces
        Assumption 3(ii): when loss/latency would push staleness past it,
        delivery is forced (the model excludes infinitely persistent
        loss).  With default parameters the RNG draw order is identical
        to the pre-refactor ``generate_schedule`` (golden-tested).
        """
        rng = np.random.default_rng(seed)
        n = topo.n
        base = self.node_compute(n)
        D_max = self.resolved_D_max(n)
        # regional draws (none by default — golden RNG order preserved),
        # then joins/leaves degraded to frozen-graph crash windows: this
        # path keeps the realize()-time graph, so membership can only
        # stall nodes, never rewire around them
        eff_failures = (self._effective_failures(rng)
                        + self._membership_windows())

        edges_w = topo.edges_W()
        edges_a = topo.edges_A()
        out_w: dict[int, list[int]] = {i: [] for i in range(n)}
        out_a: dict[int, list[int]] = {i: [] for i in range(n)}
        in_w: dict[int, list[int]] = {i: [] for i in range(n)}
        in_a: dict[int, list[int]] = {i: [] for i in range(n)}
        for e, (j, i) in enumerate(edges_w):
            out_w[j].append(e)
            in_w[i].append(e)
        for e, (j, i) in enumerate(edges_a):
            out_a[j].append(e)
            in_a[i].append(e)
        lat_w = self.edge_latency_of(edges_w)
        lat_a = self.edge_latency_of(edges_a)

        # per-edge arrival queues: (arrival_time, stamp); consumed in
        # stamp order (non-FIFO arrival allowed — max stamp arrived wins)
        arrivals_w: list[list[tuple[float, int]]] = [[] for _ in edges_w]
        arrivals_a: list[list[tuple[float, int]]] = [[] for _ in edges_a]
        best_w = np.zeros(len(edges_w), dtype=np.int64)
        best_a = np.zeros(len(edges_a), dtype=np.int64)

        clocks = rng.uniform(0.0, 1.0, n) * base
        # crash windows: push a node's first wake-up past the recovery time
        for (fn_, t0_, t1_) in eff_failures:
            if clocks[fn_] >= t0_:
                clocks[fn_] = max(clocks[fn_], t1_)
        # epoch-restricted topologies: inactive members never wake
        clocks[~topo.active_mask()] = np.inf
        ch_w = self.channels(len(edges_w), rng)
        ch_a = self.channels(len(edges_a), rng)

        agent = np.zeros(K, dtype=np.int32)
        stamp_v = np.zeros((K, max(1, len(edges_w))), dtype=np.int32)
        stamp_rho = np.zeros((K, max(1, len(edges_a))), dtype=np.int32)
        times = np.zeros(K, dtype=np.float64)
        send_ok_w = np.zeros((K, max(1, len(edges_w))), dtype=bool)
        send_ok_a = np.zeros((K, max(1, len(edges_a))), dtype=bool)
        max_delay = 0

        for k in range(K):
            a = int(np.argmin(clocks))
            now = float(clocks[a])
            if not np.isfinite(now):
                raise ValueError(
                    "every node left/crashed forever before realizing "
                    f"all {K} events (got {k})")
            agent[k] = a
            times[k] = now

            # consume: advance best stamp per in-edge from arrived packets
            for e in in_w[a]:
                q = arrivals_w[e]
                keep = []
                for (t_arr, s) in q:
                    if t_arr <= now:
                        if s > best_w[e]:
                            best_w[e] = s
                    else:
                        keep.append((t_arr, s))
                arrivals_w[e][:] = keep
                if k - best_w[e] > D_max:         # Assumption 3(ii)
                    best_w[e] = k - D_max
            for e in in_a[a]:
                q = arrivals_a[e]
                keep = []
                for (t_arr, s) in q:
                    if t_arr <= now:
                        if s > best_a[e]:
                            best_a[e] = s
                    else:
                        keep.append((t_arr, s))
                arrivals_a[e][:] = keep
                if k - best_a[e] > D_max:
                    best_a[e] = k - D_max

            stamp_v[k] = best_w if len(edges_w) else 0
            stamp_rho[k] = best_a if len(edges_a) else 0
            for e in in_w[a]:
                max_delay = max(max_delay, k - int(best_w[e]))
            for e in in_a[a]:
                max_delay = max(max_delay, k - int(best_a[e]))

            # send: node a finishes local iteration k, emits stamp k+1
            for e in out_w[a]:
                if ch_w.ok(e):
                    send_ok_w[k, e] = True
                    arrivals_w[e].append(
                        (now + rng.exponential(lat_w[e]), k + 1))
            for e in out_a[a]:
                if ch_a.ok(e):
                    send_ok_a[k, e] = True
                    arrivals_a[e].append(
                        (now + rng.exponential(lat_a[e]), k + 1))

            step = base[a] * self.slow_factor(a, now)
            clocks[a] = now + step * (1.0 + rng.uniform(-self.jitter,
                                                        self.jitter))
            for (fn_, t0_, t1_) in eff_failures:
                if fn_ == a and t0_ <= clocks[a] < t1_:
                    clocks[a] = t1_       # crash: sleep through the window

        schedule = Schedule(
            agent=agent,
            stamp_v=stamp_v,
            stamp_rho=stamp_rho,
            times=times,
            D=int(max(1, max_delay)),
            T=_realized_T(agent, n),
        )
        return ScenarioTrace(schedule=schedule, send_ok_w=send_ok_w,
                             send_ok_a=send_ok_a)

    # ----------------------------------------------------------------- #
    # the synchronous barrier clock (same primitives, same model)
    # ----------------------------------------------------------------- #
    def sync_round_times(self, topo: Topology | int, rounds: int, *,
                         seed: int = 0, max_retries: int = 50) -> np.ndarray:
        """Cumulative virtual completion time of ``rounds`` barrier rounds.

        Round ``r`` starting at barrier time ``t`` ends at::

            max_i compute_i(t)  +  max_e retransmit_latency_e

        where ``compute_i`` draws from node ``i``'s profile (straggler
        windows apply, crash windows stall the barrier until recovery —
        the synchronous cost of a failure) and each edge redraws its
        latency until the loss channel delivers (at most ``max_retries``
        tries; bursty channels cannot stall a barrier forever).

        ``topo`` may be an ``int`` node count (e.g. Ring-AllReduce): the
        communication graph is then taken as the n-edge directed ring.

        Dynamic membership stalls-and-rewires the barrier too, so the
        showdown rows stay fair against the epochized async engines: a
        round's participants are the members at the round's start; a
        node leaving mid-round caps its contribution at its leave time;
        edges with a non-member endpoint are skipped; fired regional
        groups stall like any other crash window.
        """
        rng = np.random.default_rng(seed)
        if isinstance(topo, int):
            n = topo
            edges = [(i, (i + 1) % n) for i in range(n)]
        else:
            n = topo.n
            edges = sorted(set(topo.edges_W()) | set(topo.edges_A()))
        eff_failures = self._effective_failures(rng)
        join_t = {int(j): float(tj) for (j, tj) in self.joins}
        leave_t = {int(j): float(tj) for (j, tj) in self.leaves}

        def member(i: int, at: float) -> bool:
            return join_t.get(i, 0.0) <= at < leave_t.get(i, np.inf)

        base = self.node_compute(n)
        lat = self.edge_latency_of(edges)
        ch = self.channels(len(edges), rng)

        times = np.zeros(rounds, dtype=np.float64)
        t = 0.0
        for r in range(rounds):
            if not any(member(i, t) for i in range(n)):
                nxt = min((tj for tj in join_t.values() if tj > t),
                          default=None)
                if nxt is None:       # empty forever: clock stops
                    times[r:] = t
                    return times
                t = nxt
            finish = t
            for i in range(n):
                if not member(i, t):
                    continue
                step = base[i] * self.slow_factor(i, t)
                f_i = t + step * (1.0 + rng.uniform(-self.jitter, self.jitter))
                # a crash window overlapping the work stalls the barrier
                for (fn_, t0_, t1_) in eff_failures:
                    if fn_ == i and t0_ < f_i and t1_ > t:
                        f_i = max(f_i, t1_)
                # leaving mid-round cuts the contribution off, not the
                # barrier: survivors re-form without the departed node
                if i in leave_t:
                    f_i = min(f_i, max(t, leave_t[i]))
                finish = max(finish, f_i)
            comm = 0.0
            for e, (j, i) in enumerate(edges):
                if not (member(j, t) and member(i, t)):
                    continue
                t_e = rng.exponential(lat[e])
                tries = 1
                while not ch.ok(e) and tries < max_retries:
                    t_e += rng.exponential(lat[e])
                    tries += 1
                comm = max(comm, t_e)
            t = finish + comm
            times[r] = t
        return times


# --------------------------------------------------------------------- #
# named scenarios (the benchmark suite's shared vocabulary)
# --------------------------------------------------------------------- #
def _uniform(n: int) -> NetworkScenario:
    return NetworkScenario(latency=0.3, name="uniform")


def _straggler(n: int) -> NetworkScenario:
    compute = np.ones(n)
    compute[-1] = 4.0
    return NetworkScenario(compute_time=tuple(compute), latency=0.3,
                           name="straggler")


def _flaky_straggler(n: int) -> NetworkScenario:
    """Time-varying: the last node runs 6x slow in two windows."""
    s = n - 1
    return NetworkScenario(
        latency=0.3,
        stragglers=((s, 100.0, 300.0, 6.0), (s, 600.0, 800.0, 6.0)),
        name="flaky_straggler")


def _packet_loss(n: int) -> NetworkScenario:
    return NetworkScenario(latency=0.3, loss=0.2, name="packet_loss")


def _bursty_loss(n: int) -> NetworkScenario:
    # ~20% stationary loss in bursts of mean length 10 packets
    return NetworkScenario(
        latency=0.3,
        gilbert_elliott=GilbertElliott(p_gb=0.025, p_bg=0.1),
        name="bursty_loss")


def _crash_recovery(n: int) -> NetworkScenario:
    """Two nodes crash (disjoint windows) and recover."""
    return NetworkScenario(
        latency=0.3,
        failures=((n - 1, 150.0, 280.0), (max(0, n // 2), 450.0, 560.0)),
        name="crash_recovery")


def _churn(n: int) -> NetworkScenario:
    """Dynamic membership: a late joiner and a permanent departure give
    a 3-epoch timeline (without joiner / full / without leaver)."""
    return NetworkScenario(
        latency=0.3,
        joins=((max(1, n - 2), 40.0),),
        leaves=((n - 1, 90.0),),
        name="churn")


def _regional_failure(n: int) -> NetworkScenario:
    """Correlated failures: one draw crashes a whole 'rack' together —
    a certain back-of-fleet outage plus a coin-flip repeat."""
    rack = tuple(range(max(1, n - max(2, n // 3)), n))
    return NetworkScenario(
        latency=0.3,
        regional_failures=((rack, 60.0, 120.0, 1.0),
                           (rack, 200.0, 230.0, 0.5)),
        name="regional_failure")


def _root_failover(n: int) -> NetworkScenario:
    """The Assumption-2 stress test: node 0 — the SOLE common root of
    the tree topologies — departs permanently mid-run.  Epochized runs
    re-elect a surviving root and keep converging (pair with
    ``robust_tree``, whose sibling rungs keep the skeleton connected);
    frozen-plan runs stall on the dead root.  The departure lands early
    (t=30, mid-descent at benchmark scale) so the post-crash regime
    dominates the trace and the stall is unambiguous."""
    return NetworkScenario(latency=0.3, leaves=((0, 30.0),),
                           name="root_failover")


SCENARIOS: dict[str, Callable[[int], NetworkScenario]] = {
    "uniform": _uniform,
    "straggler": _straggler,
    "flaky_straggler": _flaky_straggler,
    "packet_loss": _packet_loss,
    "bursty_loss": _bursty_loss,
    "crash_recovery": _crash_recovery,
    "churn": _churn,
    "regional_failure": _regional_failure,
    "root_failover": _root_failover,
}


def get_scenario(name: str, n: int) -> NetworkScenario:
    """Named scenario for an ``n``-node deployment (see :data:`SCENARIOS`)."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}")
    return SCENARIOS[name](n)


def realize_batch(
    topo: Topology, K: int, *,
    scenario: NetworkScenario | str | None = None,
    scenarios: Sequence[NetworkScenario | str] | None = None,
    seeds: Sequence[int] = (0,),
) -> list[ScenarioTrace]:
    """Realize a fleet of independent :class:`ScenarioTrace` lanes.

    Exactly one of ``scenario`` (one scenario × many seeds) or
    ``scenarios`` (a sweep — e.g. names from the :data:`SCENARIOS`
    registry — crossed with ``seeds``) must be given; strings resolve
    through :func:`get_scenario` for ``topo.n``.  Lane order is
    scenario-major, seed-minor.  Every lane shares ``topo`` and ``K``,
    so the result feeds :func:`repro.core.simulator.run_sweep` directly
    (lane ``i * len(seeds) + j`` carries scenario ``i``, seed
    ``seeds[j]``); mixed-topology fleets realize per topology and
    concatenate.
    """
    if (scenario is None) == (scenarios is None):
        raise ValueError("pass exactly one of scenario= or scenarios=")
    if scenario is not None:
        scenarios = [scenario]
    resolved = [get_scenario(sc, topo.n) if isinstance(sc, str) else sc
                for sc in scenarios]
    return [sc.realize(topo, K, seed=int(seed))
            for sc in resolved for seed in seeds]


def realize_epochs_batch(
    topo: Topology, K: int, *,
    scenario: NetworkScenario | str | None = None,
    scenarios: Sequence[NetworkScenario | str] | None = None,
    seeds: Sequence[int] = (0,),
) -> list[EpochTrace]:
    """:func:`realize_batch` for epochized traces: one
    :class:`EpochTrace` per (scenario, seed) lane, scenario-major —
    the input of :func:`repro.core.simulator.run_sweep_epochs`.  Note
    the epoch *timelines* of a fleet may differ per lane (regional
    draws are per-seed)."""
    if (scenario is None) == (scenarios is None):
        raise ValueError("pass exactly one of scenario= or scenarios=")
    if scenario is not None:
        scenarios = [scenario]
    resolved = [get_scenario(sc, topo.n) if isinstance(sc, str) else sc
                for sc in scenarios]
    return [sc.realize_epochs(topo, K, seed=int(seed))
            for sc in resolved for seed in seeds]
