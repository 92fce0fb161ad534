# Copy of src/repro/analysis/planlint.py, kept verbatim so the port imports nothing of the
# JAX package; tests/test_torch_planlint.py holds its diagnostics to the reference's.
"""Host-side race/alias/sentinel linting over plan objects (RF101–RF106).

All checks run on numpy arrays before anything is traced or compiled:
the point is to reject a corrupt ``CommPlan`` / ``WavefrontPlan`` /
``EpochTrace`` *before* it becomes a silently-wrong XLA program.  Every
function returns ``list[Diagnostic]`` and never raises on bad plans
(use :func:`check_or_raise` for the engines' assert-on-diagnostic mode).

Code ownership (mutation tests rely on each pass emitting only its own
codes):

* :func:`lint_comm_plan`      — RF105
* :func:`lint_wavefront_plan` — RF101, RF102, RF103
* :func:`lint_flatten`        — RF104
* :func:`lint_epoch_trace`    — RF106
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.schedule import _WAVE_FIELDS, WavefrontPlan
from .diagnostics import Diagnostic, PlanInvariantError

__all__ = [
    "lint_comm_plan", "lint_wavefront_plan", "lint_flatten",
    "lint_epoch_trace", "lint_grid_tables", "unflatten_plans",
    "lane_views", "check_or_raise",
]

_MAX_SITES = 5   # locator entries kept per diagnostic


def _d(code, subject, message, **data):
    return Diagnostic(code=code, subject=subject, message=message,
                      data=data)


def _sites(*idx_arrays):
    """First few offending index tuples, for the diagnostic locator."""
    return [tuple(int(a[i]) for a in idx_arrays)
            for i in range(min(len(idx_arrays[0]), _MAX_SITES))]


# ------------------------------------------------------------------ #
# RF105: CommPlan mass-conservation structure
# ------------------------------------------------------------------ #
def lint_comm_plan(plan, topo=None, *, subject="comm_plan",
                   atol=1e-5) -> list[Diagnostic]:
    """Lemma-3 structural audit of a :class:`~repro.core.plan.CommPlan`.

    Mass conservation (sum z + sum(rho - rho_buf) == sum g_prev) holds
    iff the *tables* the kernels actually gather through carry exactly
    the Assumption-1 weights: each row of W sums to 1 through w_diag +
    incoming w_edge, each column of A sums to 1 through a_diag +
    outgoing a_edge, and every real edge appears in exactly one
    receiver (and, for A, one sender) table slot.
    """
    diags = []
    n = int(plan.n)
    new, nea = int(plan.n_edges_w), int(plan.n_edges_a)

    def rf(message, **data):
        diags.append(_d("RF105", subject, message, **data))

    for name in ("w_diag", "a_diag"):
        bad = np.nonzero(np.asarray(getattr(plan, name)) <= 0)[0]
        if bad.size:
            rf(f"{name} must be strictly positive (Assumption 1), "
               f"found {bad.size} non-positive entries",
               nodes=bad[:_MAX_SITES])

    # dense-edge stochasticity through the edge arrays
    row = np.asarray(plan.w_diag, np.float64).copy()
    np.add.at(row, np.asarray(plan.dst_w[:new]),
              np.asarray(plan.w_edge[:new], np.float64))
    bad = np.nonzero(np.abs(row - 1.0) > atol)[0]
    if bad.size:
        rf("W rows do not sum to 1 through w_diag + incoming w_edge "
           f"mass (max err {np.abs(row - 1.0).max():.3g})",
           nodes=bad[:_MAX_SITES], sums=row[bad[:_MAX_SITES]])
    col = np.asarray(plan.a_diag, np.float64).copy()
    np.add.at(col, np.asarray(plan.src_a[:nea]),
              np.asarray(plan.a_edge[:nea], np.float64))
    bad = np.nonzero(np.abs(col - 1.0) > atol)[0]
    if bad.size:
        rf("A columns do not sum to 1 through a_diag + outgoing a_edge "
           f"mass (max err {np.abs(col - 1.0).max():.3g})",
           nodes=bad[:_MAX_SITES], sums=col[bad[:_MAX_SITES]])

    # pad tails of the edge arrays must be inert
    for arr, k in (("src_w", new), ("dst_w", new), ("w_edge", new),
                   ("src_a", nea), ("dst_a", nea), ("a_edge", nea)):
        tail = np.asarray(getattr(plan, arr))[k:]
        if tail.size and np.any(tail != 0):
            rf(f"{arr} pad tail (rows >= {k}) must be zero",
               entries=np.nonzero(tail != 0)[0][:_MAX_SITES] + k)

    nodes = np.arange(n)[:, None]

    # receiver W table: every used slot points at a real in-edge of the
    # node with the dense edge weight, and the real edges are covered
    # exactly once across all nodes
    use = np.asarray(plan.in_w_wt) != 0
    epos = np.asarray(plan.in_w_epos)
    if np.any(use & (epos >= new)):
        rf("in_w_epos points past the real W-edge range on a weighted "
           "slot", sites=_sites(*np.nonzero(use & (epos >= new))))
        use = use & (epos < new)
    owned = np.broadcast_to(nodes, epos.shape)
    bad = use & (np.asarray(plan.dst_w)[epos] != owned)
    if np.any(bad):
        rf("in_w table slot names an edge whose dst is another node",
           sites=_sites(*np.nonzero(bad)))
    bad = use & (np.asarray(plan.in_w_src)
                 != np.asarray(plan.src_w)[epos])
    if np.any(bad):
        rf("in_w_src disagrees with src_w[in_w_epos]",
           sites=_sites(*np.nonzero(bad)))
    bad = use & ~np.isclose(np.asarray(plan.in_w_wt),
                            np.asarray(plan.w_edge)[epos], atol=atol)
    if np.any(bad):
        rf("in_w_wt disagrees with w_edge[in_w_epos]",
           sites=_sites(*np.nonzero(bad)))
    cover = np.bincount(epos[use].ravel(), minlength=max(new, 1))[:new]
    if np.any(cover != 1):
        rf("every real W edge must be claimed by exactly one receiver "
           "slot (missing edges strand mass; duplicates double it)",
           edges=np.nonzero(cover != 1)[0][:_MAX_SITES],
           counts=cover[cover != 1][:_MAX_SITES])

    # receiver/sender A tables: same shape of argument on the rho ledger
    use = np.asarray(plan.in_a_val) > 0
    epos = np.asarray(plan.in_a_epos)
    if np.any(use & (epos >= nea)):
        rf("in_a_epos points past the real A-edge range on a valid "
           "slot", sites=_sites(*np.nonzero(use & (epos >= nea))))
        use = use & (epos < nea)
    bad = use & (np.asarray(plan.dst_a)[epos]
                 != np.broadcast_to(nodes, epos.shape))
    if np.any(bad):
        rf("in_a table slot names an edge whose dst is another node",
           sites=_sites(*np.nonzero(bad)))
    cover = np.bincount(epos[use].ravel(), minlength=max(nea, 1))[:nea]
    if np.any(cover != 1):
        rf("every real A edge must be claimed by exactly one receiver "
           "slot", edges=np.nonzero(cover != 1)[0][:_MAX_SITES],
           counts=cover[cover != 1][:_MAX_SITES])

    use = np.asarray(plan.out_a_val) > 0
    epos = np.asarray(plan.out_a_epos)
    if np.any(use & (epos >= nea)):
        rf("out_a_epos points past the real A-edge range on a valid "
           "slot", sites=_sites(*np.nonzero(use & (epos >= nea))))
        use = use & (epos < nea)
    bad = use & (np.asarray(plan.src_a)[epos]
                 != np.broadcast_to(nodes, epos.shape))
    if np.any(bad):
        rf("out_a table slot names an edge whose src is another node",
           sites=_sites(*np.nonzero(bad)))
    bad = use & ~np.isclose(np.asarray(plan.out_a_wt),
                            np.asarray(plan.a_edge)[epos], atol=atol)
    if np.any(bad):
        rf("out_a_wt disagrees with a_edge[out_a_epos]",
           sites=_sites(*np.nonzero(bad)))
    cover = np.bincount(epos[use].ravel(), minlength=max(nea, 1))[:nea]
    if np.any(cover != 1):
        rf("every real A edge must be claimed by exactly one sender "
           "slot", edges=np.nonzero(cover != 1)[0][:_MAX_SITES],
           counts=cover[cover != 1][:_MAX_SITES])

    # pad table slots must be fully inert
    bad = (np.asarray(plan.out_a_val) <= 0) \
        & (np.asarray(plan.out_a_wt) != 0)
    if np.any(bad):
        rf("out_a_wt must be zero on slots with out_a_val == 0",
           sites=_sites(*np.nonzero(bad)))

    # against the topology itself (same check validate_weights makes on
    # the dense matrices, here confirmed to survive table extraction)
    if topo is not None:
        W = np.asarray(topo.W, np.float64)
        A = np.asarray(topo.A, np.float64)
        if not np.allclose(np.asarray(plan.w_diag), np.diag(W),
                           atol=atol):
            rf("w_diag disagrees with diag(W) of the source topology")
        if not np.allclose(np.asarray(plan.a_diag), np.diag(A),
                           atol=atol):
            rf("a_diag disagrees with diag(A) of the source topology")
    return diags


# ------------------------------------------------------------------ #
# RF101/RF102/RF103: WavefrontPlan races, ring slots, sentinels
# ------------------------------------------------------------------ #
def lane_views(wf: WavefrontPlan):
    """Per-lane 2D views of a stacked (leading-S-axis) plan."""
    for s in range(wf.n_lanes):
        yield s, dataclasses.replace(
            wf, **{f: getattr(wf, f)[s] for f in _WAVE_FIELDS})


def lint_wavefront_plan(wf: WavefrontPlan, *, comm=None, schedule=None,
                        H=None, subject="wavefront"
                        ) -> list[Diagnostic]:
    """RF101 (in-wave write-write races), RF102 (history-ring slot
    resolution and staleness, needs ``comm`` + ``schedule`` + ``H``),
    RF103 (index ranges and sentinel hygiene).

    Accepts single plans (2D lane axes) and stacked fleet plans (3D);
    stacked plans are linted lane-by-lane, with ``comm``/``schedule``
    given as per-lane sequences (or one shared object).
    """
    if np.asarray(wf.agent).ndim == 3:
        per = lambda o, s: (o[s] if isinstance(o, (list, tuple)) else o)
        out = []
        for s, lane in lane_views(wf):
            out.extend(lint_wavefront_plan(
                lane, comm=per(comm, s), schedule=per(schedule, s),
                H=H, subject=f"{subject}/lane{s}"))
        return out

    diags = []
    diags.extend(_lint_wf_sentinels(wf, H=H, subject=subject))
    diags.extend(_lint_wf_races(wf, subject=subject))
    if comm is not None and schedule is not None and H is not None:
        diags.extend(_lint_wf_ring(wf, comm, schedule, int(H),
                                   subject=subject))
    return diags


def _lint_wf_sentinels(wf, *, H, subject):
    """RF103: every index in-range or exactly its documented sentinel,
    with zero weight/validity on sentinel rows."""
    diags = []
    n, e_a, K = int(wf.n), int(wf.e_a), int(wf.K)
    ko = wf.out_wt.shape[-1]
    ag = np.asarray(wf.agent)
    kidx = np.asarray(wf.kidx)
    pad = ag == n

    def rf(message, **data):
        diags.append(_d("RF103", subject, message, **data))

    bad = (ag < 0) | (ag > n)
    if np.any(bad):
        rf(f"agent entries outside [0, n={n}] and not the sentinel",
           sites=_sites(*np.nonzero(bad)),
           values=ag[bad][:_MAX_SITES])
    bad = pad != (kidx == K)
    if np.any(bad):
        rf(f"kidx sentinel ({K}) must coincide exactly with the agent "
           f"sentinel ({n})", sites=_sites(*np.nonzero(bad)))
    bad = ~pad & ((kidx < 0) | (kidx >= K))
    if np.any(bad):
        rf(f"live-lane kidx outside [0, K={K})",
           sites=_sites(*np.nonzero(bad)))

    # sentinel lanes carry no weight or validity anywhere
    for f in ("w_self", "a_self", "w_in", "a_val", "out_wt"):
        a = np.asarray(getattr(wf, f))
        m = pad if a.ndim == 2 else pad[..., None]
        bad = (a != 0) & m
        if np.any(bad):
            rf(f"sentinel lanes must carry zero {f}",
               sites=_sites(*np.nonzero(bad)))
    g = np.asarray(wf.rho_gidx)
    if np.any(g[pad] != 2 * e_a):
        rf(f"sentinel lanes must carry all-sentinel rho_gidx "
           f"(== {2 * e_a})", sites=_sites(np.nonzero(
               np.any(g[pad] != 2 * e_a, axis=-1))[0]))

    bad = (g < 0) | (g > 2 * e_a)
    if np.any(bad):
        rf(f"rho_gidx outside [0, 2*e_a={2 * e_a}]",
           sites=_sites(*np.nonzero(bad)), values=g[bad][:_MAX_SITES])
    # sentinel rho rows must have zero weight/validity, and live in-A
    # rows must point at exactly e_a + hist_epos (the flat rho-tilde
    # block the history scatters use)
    out_wt = np.asarray(wf.out_wt)
    bad = (g[..., :ko] == 2 * e_a) & (out_wt != 0)
    if np.any(bad):
        rf("sentinel rho-out rows must carry zero out_wt",
           sites=_sites(*np.nonzero(bad)))
    a_val = np.asarray(wf.a_val)
    he = np.asarray(wf.hist_epos)
    gin = g[..., ko:]
    bad = (gin == 2 * e_a) != (a_val <= 0)
    if np.any(bad):
        rf("in-A rho_gidx sentinel must coincide exactly with zero "
           "a_val", sites=_sites(*np.nonzero(bad)))
    live = a_val > 0
    bad = live & (gin != e_a + he)
    if np.any(bad):
        rf("live in-A rho_gidx must equal e_a + hist_epos "
           "(the flat rho-tilde row)", sites=_sites(*np.nonzero(bad)))

    bad = (np.asarray(wf.src_v) < 0) | (np.asarray(wf.src_v) >= n)
    if np.any(bad):
        rf(f"src_v outside [0, n={n})", sites=_sites(*np.nonzero(bad)))
    bad = (he < 0) | (he >= e_a)
    if np.any(bad):
        rf(f"hist_epos outside [0, e_a={e_a})",
           sites=_sites(*np.nonzero(bad)))
    if H is not None:
        for f in ("wslot", "rslot_v", "rslot_rho"):
            a = np.asarray(getattr(wf, f))
            bad = (a < 0) | (a >= int(H))
            if np.any(bad):
                rf(f"{f} outside the history ring [0, H={int(H)})",
                   sites=_sites(*np.nonzero(bad)))

    sizes = np.asarray(wf.sizes)
    live_count = np.sum(~pad, axis=-1)
    bad = np.nonzero(sizes != live_count)[0]
    if bad.size:
        rf("sizes must count exactly the non-sentinel lanes per wave",
           waves=bad[:_MAX_SITES], sizes=sizes[bad][:_MAX_SITES],
           live=live_count[bad][:_MAX_SITES])
    es = np.asarray(wf.event_start)
    bad = np.nonzero((es < 0) | (es > K))[0]
    if bad.size:
        rf(f"event_start outside [0, K={K}]", waves=bad[:_MAX_SITES])
    kmin = np.where(pad, K, kidx).min(axis=-1)
    bad = np.nonzero((live_count > 0) & (es > kmin))[0]
    if bad.size:
        rf("event_start must not exceed the wave's earliest live kidx",
           waves=bad[:_MAX_SITES])
    return diags


def _lint_wf_races(wf, *, subject):
    """RF101: no two lanes of one wave scatter to the same node row or
    the same live rho/rho-tilde row."""
    diags = []
    n, e_a = int(wf.n), int(wf.e_a)
    ag = np.asarray(wf.agent)

    live = np.where((ag >= 0) & (ag < n), ag, n)
    srt = np.sort(live, axis=-1)
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < n)
    if np.any(dup):
        w = np.nonzero(np.any(dup, axis=-1))[0]
        diags.append(_d(
            "RF101", subject,
            "two lanes of one wave write the same node's rows "
            "(write-write race on x/v/z/g_prev and the history ring)",
            waves=w[:_MAX_SITES],
            agents=[int(srt[i][1:][dup[i]][0]) for i in w[:_MAX_SITES]]))

    g = np.asarray(wf.rho_gidx).reshape(ag.shape[0], -1)
    gs = np.sort(g, axis=-1)
    dup = (gs[:, 1:] == gs[:, :-1]) & (gs[:, 1:] < 2 * e_a)
    if np.any(dup):
        w = np.nonzero(np.any(dup, axis=-1))[0]
        diags.append(_d(
            "RF101", subject,
            "two lane slots of one wave commit to the same flat "
            "rho/rho-tilde row (write-write race on the mass ledger)",
            waves=w[:_MAX_SITES],
            rows=[int(gs[i][1:][dup[i]][0]) for i in w[:_MAX_SITES]]))
    return diags


def _lint_wf_ring(wf, comm, schedule, H, *, subject):
    """RF102: re-derive every ring-slot read from the realized schedule
    and reject aliasing/staleness the ring cannot represent.

    The sender's w-th write lands in slot ``w % H`` (write counters
    start at 1; slot 0 doubles as the zero-init "no write yet" row).  A
    read in a wave starting at event ``s0`` sees write ``w`` intact iff
    the payload was emitted before the wave (``w <= c_pre``) and at most
    ``H - 1`` further writes happened before the wave
    (``c_pre - w <= H - 1``) — otherwise an in-flight write has aliased
    the slot (the AD-PSGD ring bug).
    """
    diags = []
    n, K = int(wf.n), int(wf.K)
    ag = np.asarray(wf.agent)
    kidx = np.asarray(wf.kidx)
    sched_agent = np.asarray(schedule.agent)
    if K != sched_agent.shape[0]:
        return [_d("RF102", subject,
                   f"schedule has {sched_agent.shape[0]} events but the "
                   f"plan claims K={K}; ring checks need the realized "
                   "schedule of this exact plan")]
    emit = [np.nonzero(sched_agent == j)[0] + 1 for j in range(n)]

    vw, vl = np.nonzero((ag >= 0) & (ag < n) & (kidx >= 0) & (kidx < K))
    agents = ag[vw, vl]
    ks = kidx[vw, vl]
    s0s = np.asarray(wf.event_start)[vw]

    def rf(message, **data):
        diags.append(_d("RF102", subject, message, **data))

    def check_half(stamp_table, epos_tab, owner_of, rslot, wt, kind):
        kk = np.asarray(getattr(wf, rslot))[vw, vl]     # (V, k)
        ww = np.asarray(getattr(wf, wt))[vw, vl]
        for c in range(kk.shape[-1]):
            use = ww[:, c] > 0 if kind == "rho" else ww[:, c] != 0
            if not np.any(use):
                continue
            epos = np.asarray(epos_tab)[agents[use], c]
            owners = np.asarray(owner_of)[epos]
            stamps = np.asarray(stamp_table)[ks[use], epos]
            slot_have = kk[use, c]
            starts = s0s[use]
            for j in np.unique(owners):
                m = owners == j
                em = emit[int(j)]
                w = np.searchsorted(em, stamps[m], side="right")
                c_pre = np.searchsorted(em, starts[m], side="right")
                bad = slot_have[m] != (w % H)
                if np.any(bad):
                    rf(f"{kind} ring-slot reads disagree with the "
                       f"schedule-resolved write count (sender {int(j)})",
                       column=c, count=int(bad.sum()),
                       events=ks[use][m][bad][:_MAX_SITES])
                bad = w > c_pre
                if np.any(bad):
                    rf(f"{kind} read consumes a payload written at or "
                       f"after its own wave start (sender {int(j)})",
                       column=c, events=ks[use][m][bad][:_MAX_SITES])
                bad = (c_pre - w) > (H - 1)
                if np.any(bad):
                    rf(f"{kind} read outlives the ring: sender "
                       f"{int(j)} rewrote the slot before the read "
                       f"(realized staleness > H-1 = {H - 1})",
                       column=c, events=ks[use][m][bad][:_MAX_SITES],
                       staleness=(c_pre - w)[bad][:_MAX_SITES])

    check_half(schedule.stamp_v, comm.in_w_epos, comm.src_w,
               "rslot_v", "w_in", "v")
    check_half(schedule.stamp_rho, comm.in_a_epos, comm.src_a,
               "rslot_rho", "a_val", "rho")

    # in-wave write vs read aliasing on the ring: for each wave, no
    # lane's (writer, wslot) pair may equal a (sender, rslot) pair some
    # lane in the same wave reads — the write is concurrent with the
    # read inside one launch.
    wsl = np.asarray(wf.wslot)[vw, vl]
    writer_key = agents.astype(np.int64) * H + wsl
    for name, srcf, wtf, kind in (
            ("rslot_v", "src_v", "w_in", "v"),
            ("rslot_rho", None, "a_val", "rho")):
        kk = np.asarray(getattr(wf, name))[vw, vl]
        ww = np.asarray(getattr(wf, wtf))[vw, vl]
        if kind == "v":
            senders = np.asarray(wf.src_v)[vw, vl]
        else:
            epos = np.asarray(comm.in_a_epos)[agents[:, None],
                                              np.arange(kk.shape[-1])]
            senders = np.asarray(comm.src_a)[epos]
        use = ww > 0 if kind == "rho" else ww != 0
        read_key = senders.astype(np.int64) * H + kk
        for wave in np.unique(vw):
            m = vw == wave
            writes = set(writer_key[m].tolist())
            reads = read_key[m][use[m]]
            hit = np.asarray([r in writes for r in reads.tolist()])
            if np.any(hit):
                rf(f"in-flight {kind} write aliases a slot read inside "
                   "the same wave (ring slot written and read in one "
                   "launch)", wave=int(wave),
                   slots=reads[hit][:_MAX_SITES] % H)
    return diags


# ------------------------------------------------------------------ #
# RF103 over the grid gather tables
# ------------------------------------------------------------------ #
def lint_grid_tables(tables, *, agent, n, e_a, H,
                     subject="grid_tables") -> list[Diagnostic]:
    """Range/sentinel audit of :func:`grid_gather_tables` outputs
    (RF103): live lanes must index real flat rows, sentinel lanes must
    carry exactly the untranslated sentinels the kernel clamps."""
    idx_z, idx_g, idx_ri, idx_ro, idx_rb = [np.asarray(t)
                                            for t in tables]
    ag = np.asarray(agent)
    live = ag != n
    diags = []

    def rf(message, **data):
        diags.append(_d("RF103", subject, message, **data))

    if np.any(idx_z[live] != 4 * ag[live] + 2) or \
            np.any(idx_g[live] != 4 * ag[live] + 3):
        rf("idx_z/idx_g must address rows 4*agent+2 / 4*agent+3 of the "
           "flat node state")
    if np.any((idx_z[live] < 0) | (idx_z[live] >= 4 * n)):
        rf(f"live idx_z outside the flat node state [0, 4n={4 * n})")
    bad = (idx_ri < 0) | (idx_ri >= H * e_a)
    if np.any(bad[live]):
        rf(f"live idx_ri outside the flat rho history "
           f"[0, H*e_a={H * e_a})", sites=_sites(*np.nonzero(bad)))
    for name, t in (("idx_ro", idx_ro), ("idx_rb", idx_rb)):
        bad = (t < 0) | (t > 2 * e_a)
        if np.any(bad):
            rf(f"{name} outside [0, 2*e_a={2 * e_a}]",
               sites=_sites(*np.nonzero(bad)))
    pad = ~live
    if np.any(pad):
        if np.any(idx_ro[pad] != 2 * e_a) or \
                np.any(idx_rb[pad] != 2 * e_a):
            rf("sentinel lanes must carry the untranslated rho "
               f"sentinel {2 * e_a} in idx_ro/idx_rb")
    return diags


# ------------------------------------------------------------------ #
# RF104: flatten_plans lane-offset bijection
# ------------------------------------------------------------------ #
def unflatten_plans(flat: WavefrontPlan, S: int) -> WavefrontPlan:
    """Exact inverse of :func:`flatten_plans` for an ``S``-lane fleet:
    splits the lane axis back into blocks and subtracts each block's
    offsets.  Raises ``ValueError`` when any entry falls outside its
    lane's offset block (the bijection is broken)."""
    if S <= 0 or flat.width % S or flat.n % S or flat.e_a % S \
            or flat.K % S:
        raise ValueError(f"flat plan dims not divisible by S={S}")
    B, n = flat.width // S, flat.n // S
    e_a, K = flat.e_a // S, flat.K // S
    NW = flat.n_waves

    def blocks(a):
        """(NW, S*B, ...) -> (S, NW, B, ...)"""
        return np.moveaxis(
            np.asarray(a).reshape((NW, S, B) + a.shape[2:]), 1, 0)

    s_off = np.arange(S, dtype=np.int64)[:, None, None]
    out = {}
    ag = blocks(flat.agent)
    lo = s_off * n
    bad = ~(((ag >= lo) & (ag < lo + n)) | (ag == S * n))
    if np.any(bad):
        raise ValueError(f"agent entries outside their lane block at "
                         f"(lane, wave, slot) {_sites(*np.nonzero(bad))}")
    out["agent"] = np.where(ag == S * n, n, ag - lo).astype(np.int32)
    sv = blocks(flat.src_v)
    lo = s_off[..., None] * n
    if np.any((sv < lo) | (sv >= lo + n)):
        raise ValueError("src_v entries outside their lane block")
    out["src_v"] = (sv - lo).astype(np.int32)
    he = blocks(flat.hist_epos)
    lo = s_off[..., None] * e_a
    if np.any((he < lo) | (he >= lo + e_a)):
        raise ValueError("hist_epos entries outside their lane block")
    out["hist_epos"] = (he - lo).astype(np.int32)
    g = blocks(flat.rho_gidx)
    rho_lo = s_off[..., None] * e_a
    buf_lo = (S + s_off[..., None]) * e_a
    is_rho = (g >= rho_lo) & (g < rho_lo + e_a)
    is_buf = (g >= buf_lo) & (g < buf_lo + e_a)
    is_sen = g == 2 * S * e_a
    if not np.all(is_rho | is_buf | is_sen):
        raise ValueError("rho_gidx entries outside their lane's rho, "
                         "rho-tilde, or sentinel rows")
    out["rho_gidx"] = np.where(
        is_sen, 2 * e_a,
        np.where(is_rho, g - rho_lo, g - buf_lo + e_a)).astype(np.int32)
    ki = blocks(flat.kidx)
    lo = s_off * K
    bad = ~(((ki >= lo) & (ki < lo + K)) | (ki == S * K))
    if np.any(bad):
        raise ValueError("kidx entries outside their lane block")
    out["kidx"] = np.where(ki == S * K, K, ki - lo)
    for f in ("wslot", "w_self", "a_self", "rslot_v", "w_in",
              "rslot_rho", "a_val", "out_wt"):
        out[f] = blocks(getattr(flat, f))
    # per-lane event_start/sizes are NOT recoverable from the flat
    # aggregates; carry the aggregates so lint_flatten can check them.
    out["event_start"] = np.broadcast_to(flat.event_start, (S, NW))
    out["sizes"] = np.broadcast_to(flat.sizes, (S, NW))
    return dataclasses.replace(flat, width=B, n=n, e_a=e_a, K=K, **out)


def lint_flatten(stacked: WavefrontPlan, flat: WavefrontPlan, *,
                 subject="flatten") -> list[Diagnostic]:
    """RF104: the flat plan is the stacked plan under the documented
    lane-offset bijection — block containment, bit-for-bit inverse, and
    the min/sum ``event_start``/``sizes`` aggregates."""
    diags = []

    def rf(message, **data):
        diags.append(_d("RF104", subject, message, **data))

    if np.asarray(stacked.agent).ndim != 3:
        return [_d("RF104", subject,
                   "reference plan is not a stack_plans output")]
    S = stacked.n_lanes
    want = (S * stacked.width, S * stacked.n, S * stacked.e_a,
            S * stacked.K)
    have = (flat.width, flat.n, flat.e_a, flat.K)
    if want != have or flat.n_waves != stacked.n_waves:
        rf(f"flat scalars (width, n, e_a, K) = {have} do not match "
           f"S x stacked = {want}")
        return diags
    try:
        rec = unflatten_plans(flat, S)
    except ValueError as e:
        rf(f"lane-offset bijection broken: {e}")
        return diags
    for f in _WAVE_FIELDS:
        if f in ("event_start", "sizes"):
            continue
        a, b = np.asarray(getattr(stacked, f)), \
            np.asarray(getattr(rec, f))
        if not np.array_equal(a, b):
            bad = np.nonzero(a != b)
            rf(f"{f} does not round-trip bit-for-bit through the lane "
               "offsets", sites=_sites(*bad),
               want=a[bad][:_MAX_SITES], got=b[bad][:_MAX_SITES])
    want_es = (np.asarray(stacked.event_start)
               + np.arange(S)[:, None] * stacked.K).min(0)
    if not np.array_equal(np.asarray(flat.event_start), want_es):
        rf("event_start is not the per-wave minimum of the offset "
           "lane starts")
    want_sz = np.asarray(stacked.sizes).sum(0)
    if not np.array_equal(np.asarray(flat.sizes), want_sz):
        rf("sizes is not the per-wave sum of the lane sizes")
    return diags


# ------------------------------------------------------------------ #
# RF106: epoch-boundary migration coverage
# ------------------------------------------------------------------ #
def lint_epoch_trace(et, *, subject="epoch_trace") -> list[Diagnostic]:
    """RF106: the epochs tile the event range contiguously, membership
    deltas are exactly the active-mask differences, each root is an
    active common root, joiners always have a donor, and every
    prev-epoch edge joins then-active nodes (so ``migrate_state``'s
    settle pass covers all in-flight mass)."""
    diags = []

    def rf(i, message, **data):
        diags.append(_d("RF106", f"{subject}/epoch{i}", message, **data))

    eps = list(et.epochs)
    if not eps:
        return [_d("RF106", subject, "EpochTrace has no epochs")]
    if int(eps[0].k0) != 0:
        rf(0, f"first epoch must start at k0=0, got {eps[0].k0}")
    total = 0
    for i, ep in enumerate(eps):
        if int(ep.k0) != total:
            rf(i, f"epochs must tile events contiguously: k0={ep.k0} "
               f"but the previous epochs cover [0, {total})")
        total = int(ep.k0) + int(ep.K)
    if total != int(et.K):
        rf(len(eps) - 1, f"epochs cover [0, {total}) but the trace "
           f"claims K={et.K} events")

    prev_act = None
    for i, ep in enumerate(eps):
        act = np.asarray(ep.topology.active_mask(), bool)
        joined = np.asarray(ep.joined, bool)
        departed = np.asarray(ep.departed, bool)
        if i == 0:
            if joined.any() or departed.any():
                rf(i, "the first epoch has no previous membership to "
                   "delta against; joined/departed must be all-false")
        else:
            want_j = act & ~prev_act
            want_d = prev_act & ~act
            if not np.array_equal(joined, want_j):
                rf(i, "joined mask is not exactly (active now) & "
                   "(inactive before)",
                   joined=np.nonzero(joined)[0],
                   expected=np.nonzero(want_j)[0])
            if not np.array_equal(departed, want_d):
                rf(i, "departed mask is not exactly (inactive now) & "
                   "(active before)",
                   departed=np.nonzero(departed)[0],
                   expected=np.nonzero(want_d)[0])
            # migrate_state settles in-flight rho at *previous*-epoch
            # receivers: every prev edge must join then-active nodes
            from ..core.plan import as_comm_plan
            prev_plan = as_comm_plan(eps[i - 1].topology)
            ea = int(prev_plan.n_edges_a)
            src = np.asarray(prev_plan.src_a[:ea])
            dst = np.asarray(prev_plan.dst_a[:ea])
            bad = ~(prev_act[src] & prev_act[dst])
            if np.any(bad):
                rf(i, "previous epoch carries A-edges touching "
                   "inactive nodes; migrate_state's settle pass would "
                   "strand their in-flight mass",
                   edges=np.nonzero(bad)[0][:_MAX_SITES])
            if joined.any() and not np.any(act & ~joined):
                rf(i, "every active node just joined — no donor "
                   "carries state across the boundary")
            if float(ep.t0) < float(eps[i - 1].t0):
                rf(i, "epoch t0 offsets must be nondecreasing")
        root = int(ep.root)
        if not (0 <= root < act.shape[0]) or not act[root]:
            rf(i, f"epoch root {root} is not an active node")
        elif root not in ep.topology.roots():
            rf(i, f"epoch root {root} is not a common root of the "
               "epoch topology (Assumption 2)")
        if int(ep.K) <= 0:
            rf(i, "epoch has an empty schedule")
        prev_act = act
    return diags


# ------------------------------------------------------------------ #
# engine hook
# ------------------------------------------------------------------ #
def check_or_raise(diagnostics: list[Diagnostic], context: str = ""):
    """Raise :class:`PlanInvariantError` when any diagnostic fired."""
    if diagnostics:
        raise PlanInvariantError(diagnostics, context)
