"""Program auditing of the port's engines (RF201–RF205).

Counterpart of ``src/repro/analysis/jaxlint.py``.  The plan linter
rejects bad *inputs*; this pass rejects bad *programs*.  A jaxpr is the
list of primitives a traced engine runs; PyTorch runs eagerly, so the
port's counterpart is the list of aten ops that one call of the engine
runs, read under a ``TorchDispatchMode`` (:func:`trace_ops`, the
``iter_eqns`` counterpart).  Each :class:`OpRecord` holds the op's name,
its outputs' shapes, dtypes and devices, its largest input, and whether
it allocated its output.  :func:`audit_ops` checks them:

* **RF201** — an op that reads a tensor's value on the host
  (``aten._local_scalar_dense``: ``.item()``, ``int()``, ``float()``) or
  copies a CUDA tensor to the host, recorded while the audited callable
  is the engine's wave loop (the reference's scan body);
* **RF202** — any float64 / complex128 output;
* **RF203** — an op that *materializes* (``index``, ``index_select``,
  ``gather``, ``stack``, ``cat``, ``repeat``, or a ``clone`` — which is
  what ``contiguous`` dispatches to — of an expanded view) a rank ≥ 3
  output of at least the threshold's elements that is larger than its
  largest input (an input's size counts its distinct elements, so an
  expanded view counts as what it views).  Views are not
  materializations.

The runtime contracts tracing cannot see:

* **RF204** (:func:`audit_inplace`) — the JAX engines donate their state;
  the port's update it in place, so every state field must keep its
  ``data_ptr()``, shape and dtype across a chunk, and the state returned
  must view those buffers;
* **RF205** — :func:`audit_dispatch` over a cache with the ``stats()`` /
  ``clear()`` contract (the serving cache, :func:`audit_serve_cache`),
  and :func:`audit_launches` over the kernels: a replay with unchanged
  shapes loads no new kernel library (``kernels/_build.py``) and
  launches ``commit_grid`` exactly once per non-empty wave.

* **RF206** (:func:`audit_collectives`) — every collective of the port
  goes through ``core/runtime_sharded.py``, which records each call's
  output bytes; no collective that one run of the mesh sweep's wave loop
  (:func:`wave_loop` with a mesh) issues may reach one lane group's full-width
  node state, ``S_loc·n·4·p_pad`` floats.  The designed per-wave gather
  of the mixed iterates is at most a quarter of that.  In a
  tensor-parallel round (:func:`audit_tensor_parallel_round`) the model
  group's collectives (``MODEL_COLLECTIVES``) carry activations, logit
  statistics, gathered leaves and the replicated leaves' gradients: none
  may reach one of the rank's state rows.

``commit_grid`` itself is a ``ctypes`` launch, not an aten op, so the
mode does not see it — which is what RF203 wants of the fused path.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .diagnostics import Diagnostic

__all__ = ["OpRecord", "WaveLoop", "trace_ops", "audit_ops", "audit_inplace",
           "audit_dispatch", "audit_launches", "audit_serve_cache",
           "audit_collectives", "audit_tensor_parallel_round",
           "MODEL_COLLECTIVES", "wave_loop", "engine_loops", "audit_engines",
           "DEFAULT_BROADCAST_THRESHOLD"]

# host reads of a tensor's value (RF201)
_SCALAR_READS = frozenset({"aten._local_scalar_dense"})
_WIDE_DTYPES = ("float64", "complex128")
# ops whose output is a new buffer built from their inputs' rows (RF203)
_MATERIALIZING = frozenset({
    "aten.index", "aten.index_select", "aten.gather", "aten.stack",
    "aten.cat", "aten.repeat", "aten.clone"})
# default RF203 threshold: a materialized rank>=3 intermediate of 16M
# elements (64 MiB at f32) is never the fused path
DEFAULT_BROADCAST_THRESHOLD = 1 << 24
_KERNEL_SKIP = ("a wrapper follows its tensors: on the CPU commit_grid runs "
                "its plain twin, so the kernel route needs a CUDA device")


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op of a traced call."""

    name: str               # e.g. "aten.index"
    outputs: tuple          # ((shape, dtype, device type), ...)
    in_elems: int           # distinct elements of its largest tensor input
    in_devices: tuple       # device types of its tensor inputs
    allocated: bool         # some output is not a view of an input
    in_loop: bool           # recorded while the wave loop ran


def _distinct(t: torch.Tensor) -> int:
    """Elements ``t`` reads: its size along every axis it does not
    broadcast (stride 0), so an expanded view counts as its source."""
    return int(np.prod([s for s, st in zip(t.shape, t.stride()) if st != 0],
                       dtype=np.int64))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Recorder(TorchDispatchMode):
    def __init__(self, in_loop: bool):
        super().__init__()
        self.in_loop = in_loop
        self.records: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        bufs = {_storage(t) for t in ins}
        self.records.append(OpRecord(
            name=str(func.overloadpacket),
            outputs=tuple((tuple(t.shape), str(t.dtype).removeprefix("torch."),
                           t.device.type) for t in outs),
            in_elems=max((_distinct(t) for t in ins), default=0),
            in_devices=tuple(sorted({t.device.type for t in ins})),
            allocated=any(_storage(t) not in bufs for t in outs),
            in_loop=self.in_loop))
        return out


def trace_ops(fn: Callable, *args, in_loop: bool = False, **kwargs):
    """Call ``fn(*args, **kwargs)`` and record every aten op it runs
    (autograd's backward ops included).  ``in_loop`` marks the call as
    the engine's wave loop (RF201).  Returns ``(result, records)``."""
    rec = _Recorder(in_loop)
    with rec:
        result = fn(*args, **kwargs)
    return result, rec.records


def audit_ops(records: list[OpRecord], *, subject,
              broadcast_elems_threshold=DEFAULT_BROADCAST_THRESHOLD
              ) -> list[Diagnostic]:
    """RF201 (host syncs in the wave loop), RF202 (f64/c128 outputs),
    RF203 (materialized rank>=3 blowups above the element threshold)
    over one traced call."""
    diags = []
    syncs = collections.Counter()
    wide_seen = collections.Counter()
    for r in records:
        d2h = (r.name in ("aten._to_copy", "aten.copy_", "aten.copy")
               and "cuda" in r.in_devices
               and any(dev == "cpu" for *_, dev in r.outputs))
        if r.in_loop and (r.name in _SCALAR_READS or d2h):
            syncs[r.name] += 1
        for _shape, dt, _dev in r.outputs:
            if dt in _WIDE_DTYPES:
                wide_seen[(dt, r.name)] += 1
        if r.name in _MATERIALIZING and r.allocated and r.outputs:
            shape = r.outputs[0][0]
            if len(shape) < 3:
                continue
            out_sz = int(np.prod(shape, dtype=np.int64))
            if out_sz >= broadcast_elems_threshold and out_sz > r.in_elems:
                diags.append(Diagnostic(
                    "RF203", subject,
                    f"{r.name} materializes a rank-{len(shape)} "
                    f"intermediate of {out_sz} elements (shape {shape}) — "
                    "the neighbour-stack pattern the fused commit removed",
                    {"op": r.name, "shape": shape, "elements": out_sz}))
    for name, count in sorted(syncs.items()):
        diags.append(Diagnostic(
            "RF201", subject,
            f"{count} host read(s) of a tensor ({name}) inside the wave "
            "loop: one device-to-host synchronisation per occurrence",
            {"op": name, "count": count}))
    for (dt, name), count in sorted(wide_seen.items()):
        diags.append(Diagnostic(
            "RF202", subject,
            f"{count} {dt} intermediate(s) (first producer: {name}) "
            "under the f32 policy — a float64 constant or np.float64 "
            "leaked into the program",
            {"dtype": dt, "op": name, "count": count}))
    return diags


def audit_inplace(run_chunk: Callable, state, *, subject
                  ) -> list[Diagnostic]:
    """RF204: ``run_chunk(state) -> state`` must update ``state`` (a
    NamedTuple of tensors, e.g. ``PackedState`` or ``RFASTState``) in
    place: every tensor field keeps its ``data_ptr()``, shape and dtype,
    and every tensor field of the returned state views one of those
    buffers (no copy of the state is returned)."""
    fields = [(f, t) for f, t in zip(state._fields, state)
              if isinstance(t, torch.Tensor)]
    before = {f: (t.data_ptr(), tuple(t.shape), t.dtype) for f, t in fields}
    bufs = {_storage(t) for _, t in fields}
    out = run_chunk(state)
    diags = []
    for f, t in fields:
        now = (t.data_ptr(), tuple(t.shape), t.dtype)
        if now != before[f]:
            diags.append(Diagnostic(
                "RF204", subject,
                f"state field {f!r} changed its buffer, shape or dtype "
                f"across the chunk ({before[f][1:]} -> {now[1:]}): the "
                "update is not in place",
                {"field": f, "shape": now[1], "dtype": str(now[2])}))
    for f, t in zip(out._fields, out):
        if isinstance(t, torch.Tensor) and _storage(t) not in bufs:
            diags.append(Diagnostic(
                "RF204", subject,
                f"returned field {f!r} (shape {tuple(t.shape)}) does not "
                "view the state's buffers — the engine returned a copy "
                "instead of updating in place",
                {"field": f, "shape": tuple(t.shape)}))
    return diags


def audit_dispatch(run_once, *, subject, cache, expect_entries=1,
                   repeats=2) -> list[Diagnostic]:
    """RF205: ``run_once()`` must settle ``cache`` (any module/object
    with the ``stats()``/``clear()`` contract of ``serve/cache.py``) at
    ``expect_entries`` entries, and replays must be pure cache hits."""
    cache.clear()
    diags = []
    try:
        run_once()
        first = dict(cache.stats())
        if first["entries"] > expect_entries:
            diags.append(Diagnostic(
                "RF205", subject,
                f"first run created {first['entries']} cache entries "
                f"(expected <= {expect_entries}): the cache key varies "
                "within one fleet shape", dict(first)))
        for _ in range(max(0, repeats - 1)):
            run_once()
        after = dict(cache.stats())
        if after["misses"] > first["misses"]:
            diags.append(Diagnostic(
                "RF205", subject,
                f"replaying with unchanged shapes missed the cache "
                f"{after['misses'] - first['misses']} more time(s) — "
                "recompilation in steady state", dict(after)))
    finally:
        cache.clear()
    return diags


def audit_launches(run_once, *, subject, kernel="commit_grid",
                   expect_launches, repeats=2) -> list[Diagnostic]:
    """RF205 over the kernels: every run of ``run_once()`` launches
    ``kernel`` exactly ``expect_launches`` times, and replays with
    unchanged shapes load no new library (``kernels/_build.py``'s
    loaded table gains no entry after the first run)."""
    from ..kernels import _build
    from ..kernels.rfast_update import dispatch
    diags, loaded = [], None
    for rep in range(max(1, repeats)):
        dispatch.clear()
        run_once()
        got = dispatch.launches(kernel)
        if got != expect_launches:
            diags.append(Diagnostic(
                "RF205", subject,
                f"run {rep} launched {kernel} {got} time(s), expected "
                f"{expect_launches} (one per non-empty wave)",
                {"run": rep, "launches": got, "expected": expect_launches}))
        if loaded is not None and len(_build._loaded) != loaded:
            diags.append(Diagnostic(
                "RF205", subject,
                f"replay {rep} loaded {len(_build._loaded) - loaded} new "
                "kernel librar(ies) with unchanged shapes",
                {"run": rep, "loaded": len(_build._loaded)}))
        loaded = len(_build._loaded)
    dispatch.clear()
    return diags


def audit_collectives(run, state, *, subject, state_bytes_threshold,
                      names=None) -> list[Diagnostic]:
    """RF206: ``run(state)`` (a mesh wave loop) issues no collective whose
    output reaches ``state_bytes_threshold`` — one lane group's node
    state at full width (``S_loc·n·4·p_pad·4`` bytes in fp32).  A rank
    gets data beyond its shard only through a collective, and
    ``core/runtime_sharded.py`` records them all, so this bounds every
    path to an accidental replication.  ``names`` limits the audit to
    those collectives."""
    from ..core.runtime_sharded import record_collectives
    with record_collectives() as record:
        run(state)
    diags = []
    for r in record:
        if names is not None and r["name"] not in names:
            continue
        if r["bytes"] >= state_bytes_threshold:
            diags.append(Diagnostic(
                "RF206", subject,
                f"collective {r['name']!r} materializes {r['bytes']} bytes "
                f"(shape {r['shape']}) inside the mesh wave loop — >= the "
                f"{state_bytes_threshold}-byte full-width state threshold: "
                "the shard layout has degenerated to replication",
                {"name": r["name"], "shape": r["shape"],
                 "bytes": r["bytes"], "threshold": state_bytes_threshold}))
    return diags


# the model group's collectives of a tensor-parallel round
MODEL_COLLECTIVES = ("all_reduce_sum", "all_reduce_max", "all_gather_seq",
                     "reduce_scatter_seq", "all_to_all")


def audit_tensor_parallel_round(run, state, *, subject) -> list[Diagnostic]:
    """RF206 over a tensor-parallel round ``run(state)``: no collective of
    the model group (:data:`MODEL_COLLECTIVES`) reaches one of the
    rank's state rows (``state.x``'s bytes).  The node group's ppermutes
    move whole rows by design and are not audited here."""
    return audit_collectives(
        run, state, subject=subject, names=MODEL_COLLECTIVES,
        state_bytes_threshold=state.x.numel() * state.x.element_size())


def audit_serve_cache(*, seed=0, buckets=(4, 8), device=None
                      ) -> tuple[list[Diagnostic], list[str]]:
    """RF205 over the SERVING callable cache (``serve/cache.py``), with
    the reference's workload: a tiny engine over prompts spanning every
    configured bucket must settle the cache at exactly
    ``1 + len(buckets)`` entries (one decode callable plus one prefill
    callable per bucket) with replays hitting only.  ``buckets=None``
    disables bucketing, so every distinct prompt length builds its own
    prefill callable and the audit fires."""
    from ..kernels.rfast_update.dispatch import resolve_device
    from ..models.config import ModelConfig
    from ..models.transformer import init_params
    from ..serve import Request, ServeEngine, WeightStore
    from ..serve import cache as serve_cache

    device = resolve_device(device)
    cfg = ModelConfig(name="serve-audit", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab=64)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    rng = np.random.default_rng(seed)
    lengths = [1, 2, 3, 5, 7, 8]          # spans both default buckets
    max_b = max(buckets) if buckets else max(lengths)
    lengths = [min(ln, max_b) for ln in lengths]

    def run_once():
        eng = ServeEngine(cfg, WeightStore(params), batch=2, max_len=16,
                          buckets=buckets)
        reqs = [Request(rid=i,
                        prompt=rng.integers(0, cfg.vocab, size=ln,
                                            ).astype(np.int32),
                        gen=2, arrive_s=0.0)
                for i, ln in enumerate(lengths)]
        eng.run(reqs)

    expect = 1 + (len(buckets) if buckets else 0)
    if buckets is None:
        expect = 1 + 1          # the tightest defensible floor: decode
        #                         + ONE prefill; every extra length fires
    diags = audit_dispatch(run_once, subject="serve_engine[cache]",
                           expect_entries=expect, cache=serve_cache)
    return diags, ["serve_engine[cache]"]


# ------------------------------------------------------------------ #
# the engines' wave loops
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class WaveLoop:
    """An engine's wave loop over its packed state, ready to run:
    ``run(state)`` runs every chunk in place (``_run_chunks``) and
    returns the state; ``waves`` is the number of non-empty waves (the
    ``commit_grid`` launches of one run with ``impl="kernel"``)."""

    subject: str
    state: object
    run: Callable
    waves: int
    state_bytes: int = 0     # RF206's threshold (see wave_loop)


def wave_loop(subject, plans, schedules, grad_fn, p, *, impl, device,
              seeds=None, gamma=1e-2, eval_every=0, mesh=None) -> WaveLoop:
    """The wave loop :func:`~repro_torch.core.simulator.run_sweep` drives
    for these lanes (``run_rfast``'s for one lane), built by the engine's
    own setup (``_fleet``: ``sweep_plan`` -> ``wave_inputs``) over a
    packed state with the paper init at x = 0.  With ``mesh`` it is the
    loop ``run_sweep(mesh=...)`` drives on this rank, over its lane
    group's state; every rank of ``mesh`` builds and runs it together.
    ``state_bytes`` is RF206's threshold: the lane group's node state at
    full width, ``S_loc·n·4·p_pad·4`` bytes."""
    from ..core.runtime_sharded import packed_sweep_specs
    from ..core.simulator import _fleet
    S, n, K = len(plans), plans[0].n, schedules[0].K
    seeds = list(range(S)) if seeds is None else list(seeds)
    eval_every = eval_every or K
    lay = packed_sweep_specs(mesh, S, p)
    fl = _fleet(plans, schedules, list(plans), grad_fn,
                torch.zeros(p, device=device), lay, seeds=seeds,
                eval_every=eval_every, device=device, verify="")
    return WaveLoop(
        subject, fl.packed,
        _loop_runner(fl.waves, fl.sp.cmax, -(-K // eval_every),
                     grad_fn=grad_fn, gamma=gamma, ko=fl.sp.ko, impl=impl,
                     shard=fl.shard),
        sum(1 for w in fl.waves if w.agent.shape[0]),
        state_bytes=lay.S_loc * n * 4 * lay.p_pad * 4)


def _loop_runner(waves, cmax, n_chunks, **step):
    from ..core.simulator import _run_chunks

    def run(state):
        for _ in _run_chunks(state, waves, cmax, n_chunks, **step):
            pass
        return state

    return run


def _quad_grad(n, p, seed, device):
    """The reference audit's objective ``g_i(x) = x − C_i``."""
    rng = np.random.default_rng(seed)
    C = torch.as_tensor(rng.normal(0, 1, (n, p)), dtype=torch.float32,
                        device=device)
    return lambda i, x, gen: x - C[i]


def engine_loops(*, n=5, p=8, K=48, seed=0, device=None,
                 impls=("plain", "kernel")) -> list[WaveLoop]:
    """The wave loops :func:`audit_engines` audits: one lane (binary
    tree, uniform) and the two-lane flattened fleet (binary tree +
    line, uniform + straggler) for each of ``impls``, then
    ``run_epochs``' wave body on ``churn`` / ``robust_tree`` epoch 1
    with the last of ``impls``."""
    from ..core.plan import build_comm_plan
    from ..core.scenario import get_scenario
    from ..core.simulator import (_epoch_lane_plans, _epoch_shapes,
                                  _fresh_packed, _rechunk_lane, wave_inputs)
    from ..core.topology import get_topology
    from ..kernels.rfast_update.dispatch import resolve_device

    device = resolve_device(device)
    gfn = _quad_grad(n, p, seed, device)
    topo = get_topology("binary_tree", n)
    sched = get_scenario("uniform", n).realize(topo, K, seed=seed).schedule
    topo_b = get_topology("line", n)
    sched_b = get_scenario("straggler", n).realize(topo_b, K,
                                                   seed=seed).schedule
    plan, plan_b = build_comm_plan(topo), build_comm_plan(topo_b)
    loops = []
    for impl in impls:
        loops.append(wave_loop(f"wave_loop[{impl}]", [plan], [sched], gfn, p,
                               impl=impl, device=device, seeds=[seed]))
        loops.append(wave_loop(f"fleet_wave_loop[{impl}]", [plan, plan_b],
                               [sched, sched_b], gfn, p, impl=impl,
                               device=device, seeds=[seed, seed + 1]))

    # run_epochs' wave body: epoch 1 of churn on a robust tree, padded to
    # the trace-wide shapes by the engine's own planner (isolated nodes
    # exercise the sentinel paths)
    n_e = max(n, 7)
    et = get_scenario("churn", n_e).realize_epochs(
        get_topology("robust_tree", n_e), 40 * n_e, seed=seed)
    if len(et.epochs) > 1:
        H, kw, ka, ko, e_a = _epoch_shapes(et.epochs)
        lane = _epoch_lane_plans(et.epochs, et.K, H=H, kw=kw, ka=ka, ko=ko,
                                 e_a=e_a)
        cmax = max(b1 - b0 for *_, b in lane for b0, b1 in zip(b, b[1:]))
        rc = _rechunk_lane(lane, B=max(wf.width for *_, wf, _ in lane),
                           cmax=cmax, e_a=e_a)[1]
        ep = et.epochs[1]
        g_e = _quad_grad(n_e, p, seed, device)
        waves = wave_inputs(rc, ko, device, (seed,), k0=ep.k0)
        loops.append(WaveLoop(
            "run_epochs[wave body]",
            _fresh_packed(n_e, e_a, H, torch.zeros(n_e, p, device=device),
                          g_e, seed),
            _loop_runner(waves, cmax, len(lane[1][-1]) - 1, grad_fn=g_e,
                         gamma=1e-2, ko=ko, impl=impls[-1]),
            sum(1 for w in waves if w.agent.shape[0])))
    return loops


def _audit_meshes() -> list[tuple[str, object]]:
    """The meshes the engine audit runs the mesh body on: a 1 x 1 mesh of
    this rank always, and where the process group has two ranks or more
    a 1 x 2 mesh of ranks 0 and 1 (every rank of the group must call
    this together; ranks beyond the mesh get only the first)."""
    import torch.distributed as dist

    from ..launch.mesh import make_sweep_mesh
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_available() and dist.is_initialized()
                   else (0, 1))
    meshes = [("1x1", make_sweep_mesh(ranks=[rank]))]
    if world >= 2:
        m2 = make_sweep_mesh(lanes=1, param_shards=2)
        if m2.coords is not None:
            meshes.append(("1x2", m2))
    return meshes


# ------------------------------------------------------------------ #
# the standard engine audit the CLI runs
# ------------------------------------------------------------------ #
def audit_engines(*, n=5, p=8, K=48, seed=0, device=None,
                  broadcast_elems_threshold=DEFAULT_BROADCAST_THRESHOLD
                  ) -> tuple[list[Diagnostic], list[str], list[dict]]:
    """Run every engine at a small size on ``device`` (``cuda`` unless
    the caller asks for another) and apply the RF201–RF205 checks: the
    event engine (``rfast_scan``), the wavefront wave loop with
    ``impl="plain"`` and ``"kernel"``, the two-lane flattened fleet,
    ``run_epochs``' wave body and the ``commit_grid`` call site.

    Then the mesh sweep's wave loop (:func:`wave_loop` with a mesh, the
    two-lane fleet) on each of :func:`_audit_meshes` and route: RF201–RF203
    over its ops and RF206 over its collectives (in a process group,
    every rank calls this together).

    Returns ``(diagnostics, audited_subjects, skipped)``; ``skipped``
    lists ``{"subject", "reason"}`` for the audits ``device`` cannot
    run (on the CPU, the kernel route).  Sizes are tiny on purpose: the
    properties audited are shape-generic.
    """
    from ..core.plan import build_comm_plan
    from ..core.scenario import get_scenario
    from ..core.simulator import init_state, rfast_scan
    from ..core.topology import get_topology
    from ..kernels.rfast_update.dispatch import resolve_device
    from ..kernels.rfast_update.grid import commit_grid

    device = resolve_device(device)
    on_card = device.type == "cuda"
    kw = dict(broadcast_elems_threshold=broadcast_elems_threshold)
    diags, audited, skipped = [], [], []

    # event-serial engine: one call runs every event (its loop body)
    topo = get_topology("binary_tree", n)
    sched = get_scenario("uniform", n).realize(topo, K, seed=seed).schedule
    plan = build_comm_plan(topo)
    H = int(sched.D) + 2
    gfn = _quad_grad(n, p, seed, device)
    chunk = rfast_scan(plan, gfn, 1e-2, H, seed=seed)
    run_event = lambda st: chunk(st, sched.agent, sched.stamp_v,
                                 sched.stamp_rho)
    st = init_state(plan, torch.zeros(n, p, device=device), gfn, H,
                    seed=seed)
    _, records = trace_ops(run_event, st, in_loop=True)
    diags += audit_ops(records, subject="rfast_scan", **kw)
    audited.append("rfast_scan")
    diags += audit_inplace(run_event, st, subject="rfast_scan[inplace]")
    audited.append("rfast_scan[inplace]")

    # the wavefront wave loops, one lane and the two-lane fleet, then
    # run_epochs' wave body
    impls = ("plain", "kernel") if on_card else ("plain",)
    if not on_card:
        skipped += [{"subject": s, "reason": _KERNEL_SKIP}
                    for s in ("wave_loop[kernel]", "fleet_wave_loop[kernel]")]
    loops = engine_loops(n=n, p=p, K=K, seed=seed, device=device,
                         impls=impls)
    for loop in loops:
        _, records = trace_ops(loop.run, loop.state, in_loop=True)
        diags += audit_ops(records, subject=loop.subject, **kw)
        audited.append(loop.subject)
    for loop in loops:
        if not loop.subject.endswith("[plain]"):
            continue
        sub = loop.subject.replace("[plain]", "[inplace]")
        diags += audit_inplace(loop.run, loop.state, subject=sub)
        audited.append(sub)

    # commit_grid call site: the ops around it, and on the card the
    # launch / library-load steady state over the one-lane kernel loop
    B, ka_g, ko_g, rows, Pf = 4, 2, 2, 8, 16
    r2 = np.random.default_rng(seed + 2)
    f = lambda s: torch.as_tensor(r2.normal(0, 1, s), dtype=torch.float32,
                                  device=device)
    i = lambda s, hi: torch.as_tensor(r2.integers(0, hi, s),
                                      dtype=torch.int32, device=device)
    grid_args = (i((B,), rows), i((B,), rows), i((B, ka_g), rows),
                 i((B, ka_g), rows), i((B, ko_g), rows),
                 f((B,)), torch.ones((B, ka_g), device=device),
                 f((B, ko_g)), f((rows, Pf)), f((B, Pf)), f((rows, Pf)),
                 f((rows, Pf)), f((rows, Pf)), f((rows, Pf)))
    sub = f"commit_grid[{device.type}]"
    _, records = trace_ops(commit_grid, *grid_args)
    diags += audit_ops(records, subject=sub, **kw)
    audited.append(sub)
    if on_card:
        loop = next(lp for lp in loops if lp.subject == "wave_loop[kernel]")
        diags += audit_launches(lambda: loop.run(loop.state),
                                subject="commit_grid[dispatch]",
                                expect_launches=loop.waves)
        audited.append("commit_grid[dispatch]")
    else:
        skipped.append({"subject": "commit_grid[dispatch]",
                        "reason": _KERNEL_SKIP})

    # the mesh sweep's wave loop: RF201-RF203 and RF206
    topo_b = get_topology("line", n)
    sched_b = get_scenario("straggler", n).realize(topo_b, K,
                                                   seed=seed).schedule
    for tag, mesh in _audit_meshes():
        if not on_card:
            skipped.append({"subject": f"mesh_wave_loop[{tag},kernel]",
                            "reason": _KERNEL_SKIP})
        for impl in impls:
            sub = f"mesh_wave_loop[{tag},{impl}]"
            loop = wave_loop(sub, [plan, build_comm_plan(topo_b)],
                             [sched, sched_b], gfn, p, mesh=mesh, impl=impl,
                             device=device, seeds=[seed, seed + 1])
            _, records = trace_ops(loop.run, loop.state, in_loop=True)
            diags += audit_ops(records, subject=sub, **kw)
            diags += audit_collectives(
                loop.run, loop.state, subject=sub,
                state_bytes_threshold=loop.state_bytes)
            audited.append(sub)
    return diags, audited, skipped
