"""Registry-wide analysis driver: SCENARIOS x topology builders x the
plan-transform matrix, plus the engine program audits.

Counterpart of ``src/repro/analysis/runner.py``: the machine behind
``python -m repro_torch.analysis``.  :func:`run_plan_matrix` is the
reference's matrix and plumbing over the port's verbatim planners
(shared fleet maxima, ``pad_comm_plan`` -> per-lane
``build_wavefront_plan(e_a=...)`` -> ``pad_plan``/``slice_plan`` ->
``stack_plans`` -> ``flatten_plans``), so its ``stats`` equal the
reference's count for count; :func:`run_all`'s second pass is
:func:`.torchlint.audit_engines` and :func:`.torchlint.audit_serve_cache`
on ``device``.
"""
from __future__ import annotations

from .diagnostics import CODES, Diagnostic
from . import planlint, torchlint

_QUICK_SCENARIOS = ("uniform", "packet_loss", "churn")
_QUICK_TOPOLOGIES = ("binary_tree", "line", "robust_tree")


def run_plan_matrix(*, n=7, K=96, K_epochs=1200, seeds=(0,),
                    scenarios=None, topologies=None,
                    progress=None) -> tuple[list[Diagnostic], dict]:
    """All RF1xx passes over every (scenario, topology, seed) triple and
    every transform composition; returns ``(diagnostics, stats)``."""
    from ..core.plan import build_comm_plan, pad_comm_plan
    from ..core.scenario import SCENARIOS, get_scenario
    from ..core.schedule import (build_wavefront_plan, concat_plans,
                                 flatten_plans, grid_gather_tables,
                                 pad_plan, slice_plan, stack_plans)
    from ..core.topology import TOPOLOGIES, get_topology

    scenarios = list(scenarios or SCENARIOS)
    topologies = list(topologies or TOPOLOGIES)
    say = progress or (lambda msg: None)
    diags: list[Diagnostic] = []
    stats = {"scenarios": len(scenarios), "topologies": len(topologies),
             "seeds": len(seeds), "comm_plans": 0, "wavefront_plans": 0,
             "transform_plans": 0, "fleets": 0, "epoch_traces": 0,
             "skipped": []}

    topos = {t: get_topology(t, n) for t in topologies}
    comms = {t: build_comm_plan(topo) for t, topo in topos.items()}
    kw = max(c.kw for c in comms.values())
    ka = max(c.ka for c in comms.values())
    ko = max(c.ko for c in comms.values())
    padded = {t: pad_comm_plan(c, kw=kw, ka=ka, ko=ko)
              for t, c in comms.items()}
    e_a = max(max(1, c.n_edges_a) for c in padded.values())
    for t in topologies:
        diags += planlint.lint_comm_plan(comms[t], topos[t],
                                         subject=f"comm_plan/{t}")
        diags += planlint.lint_comm_plan(padded[t], topos[t],
                                         subject=f"comm_plan/{t}/padded")
        stats["comm_plans"] += 2

    for sc_name in scenarios:
        sc = get_scenario(sc_name, n)
        for seed in seeds:
            say(f"planlint: {sc_name} seed {seed}")
            scheds, wfs = [], []
            H = 0
            for t in topologies:
                sched = sc.realize(topos[t], K, seed=seed).schedule
                H = max(H, int(sched.D) + 2)
                scheds.append(sched)
            for t, sched in zip(topologies, scheds):
                sub = f"{sc_name}/{t}/seed{seed}"
                wf = build_wavefront_plan(sched, padded[t], H, e_a=e_a)
                wfs.append(wf)
                diags += planlint.lint_wavefront_plan(
                    wf, comm=padded[t], schedule=sched, H=H, subject=sub)
                stats["wavefront_plans"] += 1
                # transform compositions stay clean and schedule-true
                pp = pad_plan(wf, width=wf.width + 2,
                              n_waves=wf.n_waves + 3, e_a=e_a + 4)
                diags += planlint.lint_wavefront_plan(
                    pp, comm=padded[t], schedule=sched, H=H,
                    subject=f"{sub}/padded")
                mid = max(1, pp.n_waves // 2)
                rejoined = concat_plans([slice_plan(pp, 0, mid),
                                         slice_plan(pp, mid, pp.n_waves)])
                diags += planlint.lint_wavefront_plan(
                    rejoined, comm=padded[t], schedule=sched, H=H,
                    subject=f"{sub}/sliced+concat")
                stats["transform_plans"] += 2

            stacked = stack_plans(wfs)
            fleet = flatten_plans(stacked)
            sub = f"{sc_name}/fleet/seed{seed}"
            diags += planlint.lint_wavefront_plan(
                stacked, comm=[padded[t] for t in topologies],
                schedule=scheds, H=H, subject=f"{sub}/stacked")
            diags += planlint.lint_flatten(stacked, fleet, subject=sub)
            diags += planlint.lint_wavefront_plan(fleet, H=H,
                                                  subject=f"{sub}/flat")
            tables = grid_gather_tables(
                fleet.agent, fleet.rslot_rho, fleet.hist_epos,
                fleet.rho_gidx, e_a_flat=fleet.e_a,
                ko=fleet.out_wt.shape[-1])
            diags += planlint.lint_grid_tables(
                tables, agent=fleet.agent, n=fleet.n, e_a=fleet.e_a,
                H=H, subject=f"{sub}/grid_tables")
            stats["fleets"] += 1

        if not getattr(sc, "dynamic", False):
            continue
        for t in topologies:
            for seed in seeds:
                sub = f"{sc_name}/{t}/seed{seed}/epochs"
                say(f"planlint: {sub}")
                try:
                    et = sc.realize_epochs(topos[t], K_epochs, seed=seed)
                except ValueError as e:
                    stats["skipped"].append(
                        {"subject": sub, "reason": str(e)})
                    continue
                diags += planlint.lint_epoch_trace(et, subject=sub)
                stats["epoch_traces"] += 1
                for i, ep in enumerate(et.epochs):
                    eplan = build_comm_plan(ep.topology)
                    esched = ep.trace.schedule
                    eH = int(esched.D) + 2
                    ewf = build_wavefront_plan(esched, eplan, eH)
                    diags += planlint.lint_comm_plan(
                        eplan, ep.topology, subject=f"{sub}/ep{i}/comm")
                    diags += planlint.lint_wavefront_plan(
                        ewf, comm=eplan, schedule=esched, H=eH,
                        subject=f"{sub}/ep{i}")
                    stats["comm_plans"] += 1
                    stats["wavefront_plans"] += 1
    return diags, stats


def run_all(*, n=7, K=96, K_epochs=1200, seeds=(0,), quick=False,
            plans=True, programs=True, device=None, progress=None) -> dict:
    """The full ``--all`` sweep; returns the JSON-ready report dict (the
    schema of DESIGN.md §12, with the second pass named ``torchlint``
    and ``audited_jaxprs`` read as ``audited_programs``, beside which
    ``skipped_programs`` lists the audits ``device`` cannot run).  The
    plan pass runs on the host whatever ``device`` is; the program pass
    runs on ``device`` (``cuda`` unless the caller asks for another)."""
    say = progress or (lambda msg: None)
    scenarios = topologies = None
    if quick:
        scenarios, topologies = _QUICK_SCENARIOS, _QUICK_TOPOLOGIES
        K, K_epochs, seeds = min(K, 64), min(K_epochs, 600), seeds[:1]
    diags: list[Diagnostic] = []
    stats: dict = {}
    audited: list[str] = []
    skipped: list[dict] = []
    if programs:
        from ..kernels.rfast_update.dispatch import resolve_device
        device = resolve_device(device)
    if plans:
        d, stats = run_plan_matrix(
            n=n, K=K, K_epochs=K_epochs, seeds=tuple(seeds),
            scenarios=scenarios, topologies=topologies, progress=say)
        diags += d
    if programs:
        say(f"torchlint: tracing engines on {device}")
        d, audited, skipped = torchlint.audit_engines(
            seed=min(seeds, default=0), device=device)
        diags += d
        say("torchlint: serving callable cache")
        d, a = torchlint.audit_serve_cache(seed=min(seeds, default=0),
                                           device=device)
        diags += d
        audited += a
    return {
        "version": 1,
        "tool": "repro_torch.analysis",
        "config": {"n": n, "K": K, "K_epochs": K_epochs,
                   "seeds": list(seeds), "quick": bool(quick),
                   "device": str(device) if programs else None,
                   "passes": (["planlint"] if plans else [])
                   + (["torchlint"] if programs else [])},
        "summary": {
            "diagnostics": len(diags),
            "by_code": _count_by_code(diags),
            "checked": stats,
            "audited_programs": audited,
            "skipped_programs": skipped,
        },
        "diagnostics": [d.to_json() for d in diags],
    }


def _count_by_code(diags):
    out = {}
    for d in diags:
        out[d.code] = out.get(d.code, 0) + 1
    return out


def catalog() -> list[dict]:
    """The RF code catalog, JSON-ready (mirrors DESIGN.md §12)."""
    return [{"code": c.code, "owner": c.owner, "title": c.title,
             "invariant": c.invariant, "motivation": c.motivation}
            for c in CODES.values()]
