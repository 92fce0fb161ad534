"""End-to-end R-FAST training driver of the port.

Counterpart of ``src/repro/launch/train.py``, in its two regimes:

* **synchronous rounds** (default) — the protocol-round runtime
  (:mod:`repro_torch.core.runtime`): every round runs S1–S5 for all
  nodes over the flat parameter state, with optional Bernoulli per-edge
  loss masks (``--loss-prob``) and heavy-ball momentum (``--momentum``).
  Batches are the reference's ``node_batch`` and masks its
  ``default_rng(seed + 1)`` draws, so only the initial weights differ
  from a reference run.
* **fully asynchronous** (``--scenario <name>``) — a
  :class:`~repro_torch.core.scenario.NetworkScenario` (stragglers,
  latency, loss, crash/recovery) is realized into a per-event trace,
  and the LM trains through the wavefront engine on the flat-parameter
  substrate.  ``--steps N`` means N activations per node
  (K = N·nodes events).  A dynamic scenario (joins, leaves, regional
  failures, root failover) is realized into membership epochs and runs
  through ``run_epochs``, which migrates the state at every boundary.

``--ckpt DIR`` saves every ``--ckpt-every`` rounds (sync) or at the
chunk boundaries it falls on and at the end (async) in the JAX
package's checkpoint format, and resumes from the latest checkpoint in
DIR.  ``--publish-dir DIR`` (async) saves the consensus average x̄ as
the model's parameter tree at every chunk boundary.
``--list-scenarios`` prints the scenario registry.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --nodes 4 --steps 20 --loss-prob 0.2 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --nodes 4 --steps 20 --scenario straggler --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --nodes 4 --steps 20 --scenario churn --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when no GPU
is present and the CPU was not asked for.  ``--impl kernel`` (default)
commits through the hand-written ``commit_grid`` kernel (one launch per
round, or per wave); ``--impl plain`` through PyTorch ops.  On the card,
float32 matmuls run in full float32 (TF32 off), as the reference does.

``--arch`` takes every architecture of the reference: the dense
attention decoders ``rfast-100m``, ``llama3-8b``, ``deepseek-7b``,
``olmo-1b`` and ``qwen2.5-3b``, the MoE ``phi3.5-moe-42b-a6.6b`` and
``deepseek-v2-236b`` (MLA; the router loss enters every gradient),
``hymba-1.5b`` (hybrid attention + Mamba heads) and ``falcon-mamba-7b``
(attention-free), whose SSM mixers' scans run the hand-written
``ssm_scan`` kernel on the card, and the frontend archs as the
reference's train CLI runs them: its batches hold tokens only, so
``pixtral-12b`` trains on text (its patch projection gets no gradient)
and ``whisper-large-v3``'s encoder, given no frames, fails at the first
gradient (a ``ValueError`` here, a ``TypeError`` there).  A whisper
round trains through :func:`sync_grad_fn` with batches of ``(toks,
labels, frames)``, as the reference's library API does.

``--verify-plans`` (async) lints every plan the engine is about to
consume with :mod:`repro_torch.analysis.planlint` before the first wave
and raises ``PlanInvariantError`` on any diagnostic; the run is
otherwise the same, bit for bit.

``--param-shards M`` (async, static scenarios) trains the one lane
through ``run_sweep(mesh=make_sweep_mesh(lanes=1, param_shards=M))``:
each of M ranks holds 1/M of the flat state and the wave's mixed
iterates are gathered once a wave for the gradient.  It runs under a
launcher (``torchrun --nproc-per-node M``: NCCL, one card a rank), or,
as the CPU dev loop, with ``--host-devices N --device cpu``: ``main``
spawns N gloo ranks on the CPU itself (one thread each).  Rank 0 alone
prints and writes metrics; the losses are the unsharded run's.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --scenario uniform --param-shards 2 --host-devices 2 --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.paramvec import (make_ravel_spec, ravel, unravel,
                                       value_and_grad)
from repro_torch.core.protocol import IMPLS
from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                      make_rfast_round, runtime_tracked_mass)
from repro_torch.core.runtime_sharded import all_gather_flat
from repro_torch.core.scenario import SCENARIOS, get_scenario
from repro_torch.core.simulator import (run_epochs, run_rfast, run_sweep,
                                        tracked_mass, zeros_state)
from repro_torch.core.topology import get_topology
from repro_torch.data.objectives import make_lm_problem
from repro_torch.data.pipeline import LMShardConfig, node_batch
from repro_torch.kernels.rfast_update import dispatch
from repro_torch.metrics import MetricsLogger, StepTimer
from repro_torch.optim.schedules import warmup_cosine


def parse_args(argv=None) -> argparse.Namespace:
    """The arguments, with the reference's argument errors (and the
    ``--host-devices`` ones) raised (``SystemExit``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rfast-100m", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer smoke variant (CI-scale)")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--topology", default="binary_tree")
    ap.add_argument("--gamma", type=float, default=3e-3)
    ap.add_argument("--momentum", type=float, default=0.0)
    ap.add_argument("--loss-prob", type=float, default=0.0)
    ap.add_argument("--scenario", default="", metavar="NAME",
                    help="train asynchronously under a named "
                         f"NetworkScenario ({', '.join(sorted(SCENARIOS))}); "
                         "default: synchronous rounds")
    ap.add_argument("--list-scenarios", action="store_true",
                    help="print the SCENARIOS registry (dynamic entries "
                         "marked) and exit")
    ap.add_argument("--impl", default="kernel", choices=IMPLS,
                    help="commit backend: kernel (hand-written CUDA "
                         "commit_grid) or plain (PyTorch ops)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--publish-dir", default="",
                    help="publish the consensus average x̄ as the model's "
                         "parameter tree at every chunk boundary (async), "
                         "in checkpoint/ckpt.py's format")
    ap.add_argument("--param-shards", type=int, default=1,
                    help="shard the flat parameter axis over this many "
                         "ranks (async regime only: routes through the "
                         "mesh-mapped run_sweep; on the CPU combine with "
                         "--host-devices)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="with no process group, spawn this many gloo "
                         "ranks on the CPU (the dev loop for "
                         "--param-shards; needs --device cpu)")
    ap.add_argument("--metrics", default="", help="JSONL metrics path")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify-plans", action="store_true",
                    help="run the repro_torch.analysis plan-invariant "
                         "linter over every plan before training "
                         "(raises PlanInvariantError on any diagnostic)")
    args = ap.parse_args(argv)
    if args.list_scenarios:
        return args

    if args.publish_dir:
        if not args.scenario:
            ap.error("--publish-dir publishes the async consensus "
                     "average at chunk boundaries; the synchronous "
                     "rounds have no flat-parameter chunk hook (pass "
                     "--scenario)")
        if args.param_shards > 1:
            ap.error("--publish-dir rides the wavefront chunk callback, "
                     "which the mesh-mapped run_sweep path does not "
                     "expose; drop --param-shards or --publish-dir")
    if args.scenario:
        if args.loss_prob:
            ap.error("--loss-prob models loss in the synchronous rounds; "
                     "with --scenario the NetworkScenario owns the "
                     "loss/delay model")
        if args.momentum:
            ap.error("--momentum applies to the synchronous round engine "
                     "only; the event-level Algorithm 2 recursion has no "
                     "momentum term")
        dynamic = get_scenario(args.scenario, args.nodes).dynamic
        if args.ckpt and dynamic:
            ap.error("--ckpt resume is not supported for dynamic "
                     "(membership) scenarios: the packed state layout "
                     "changes at every epoch boundary, so a mid-schedule "
                     "snapshot is not replayable")
        if args.param_shards > 1:
            if args.ckpt:
                ap.error("--param-shards trains through run_sweep(mesh="
                         "...), which has no mid-schedule resume; drop "
                         "--ckpt or --param-shards")
            if dynamic:
                ap.error("--param-shards is not supported for dynamic "
                         "(membership) scenarios yet")
    elif args.param_shards > 1:
        ap.error("--param-shards shards the wavefront engine's flat "
                 "parameter axis (pass --scenario for the async regime)")
    if args.host_devices:
        if args.param_shards < 2:
            ap.error("--host-devices starts the ranks of a "
                     "--param-shards run (pass --param-shards M > 1)")
        if args.host_devices < args.param_shards:
            ap.error(f"--param-shards {args.param_shards} needs "
                     f"{args.param_shards} devices, --host-devices gives "
                     f"{args.host_devices}")
        if args.device != "cpu":
            ap.error("--host-devices spawns gloo ranks on the CPU (pass "
                     "--device cpu; on cards launch with torchrun)")
    return args


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def main(argv=None, *, timeout_s: float = 300.0,
         join_s: float = 3600.0) -> dict:
    """Run the CLI on ``argv``.  With ``--host-devices`` and no process
    group, the spawned ranks' group bounds every collective by
    ``timeout_s`` and the ranks must finish within ``join_s`` seconds
    (``spawn_local``)."""
    args = parse_args(argv)
    if args.list_scenarios:
        for name in sorted(SCENARIOS):
            tag = ("  [dynamic: joins/leaves/regional failures]"
                   if get_scenario(name, 7).dynamic else "")
            print(f"{name}{tag}")
        return {"mode": "list", "scenarios": sorted(SCENARIOS)}
    if args.host_devices and not _in_group():
        from repro_torch.launch.multihost import spawn_local
        # every rank runs main() again, in the group
        argv = list(sys.argv[1:] if argv is None else argv)
        return spawn_local(main, args.host_devices, argv, backend="gloo",
                           timeout_s=timeout_s, join_s=join_s)[0]
    device = dispatch.resolve_device(args.device)
    if args.param_shards > 1:
        from repro_torch.launch.multihost import initialize_distributed
        initialize_distributed(None if device.type == "cuda" else "gloo")
        if device.type == "cuda" and _in_group():
            device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.scenario:
        return _train_async(args, cfg, device)
    return _train_sync(args, cfg, device)


# --------------------------------------------------------------------- #
# synchronous rounds (protocol-round runtime)
# --------------------------------------------------------------------- #
def sync_grad_fn(cfg, spec):
    """Per-node gradient of the LM on the flat lane: ``(x_flat, (toks,
    labels[, frontend]), key) -> (loss, g_flat)``; the key is unused (the
    reference drops it too)."""
    from repro_torch.models.transformer import loss_fn
    return value_and_grad(
        spec, lambda params, batch, _key: loss_fn(cfg, params, *batch))


def sync_batches(shard_cfg: LMShardConfig, step: int, device):
    """Every node's ``node_batch`` at ``step``, stacked: ``(toks, labels)``
    of shape (N, B, S), int64 on ``device``."""
    toks, labels = zip(*(node_batch(shard_cfg, i, step)
                         for i in range(shard_cfg.n_nodes)))
    put = lambda a: torch.from_numpy(np.stack(a).astype(np.int64)).to(device)
    return put(toks), put(labels)


def sync_setup(cfg, n: int, topology: str, *, batch_per_node: int, seq: int,
               seed: int, device, robust: bool, momentum: float):
    """A synchronous run's plan, initial protocol state (flat, on
    ``device``; weights from a ``torch.Generator`` seeded with ``seed``),
    per-node gradient, batch source ``step -> batches`` and the model's
    :class:`~repro_torch.core.paramvec.RavelSpec`."""
    from repro_torch.models.transformer import init_params
    spec = edge_arrays(get_topology(topology, n))
    shard_cfg = LMShardConfig(vocab=cfg.vocab, batch_per_node=batch_per_node,
                              seq_len=seq, n_nodes=n, seed=seed)
    params0 = init_params(cfg, torch.Generator().manual_seed(seed))
    rspec = make_ravel_spec(params0)
    x0 = ravel(rspec, params0).to(device)
    del params0
    grad_fn = sync_grad_fn(cfg, rspec)
    batches = lambda step: sync_batches(shard_cfg, step, device)
    state = init_node_state(spec, x0, grad_fn, batches(0), robust=robust,
                            momentum=momentum)
    return spec, state, grad_fn, batches, rspec


def sync_tree(rspec, state):
    """The synchronous state as the JAX package's ``ProtocolState``
    tree: every flat ``(rows, p)`` field as the model's nested dict of
    ``(rows, *shape)`` views (the pad tail cut), the step an int."""
    return state._replace(**{f: None if t is None else unravel(rspec, t)
                             for f, t in zip(state._fields[1:], state[1:])})


def load_sync_state(ckpt_dir: str, rspec, state):
    """The latest checkpoint of ``ckpt_dir`` (the JAX package's
    ``ProtocolState`` file) as a flat state shaped like ``state``, on its
    device (the pad tail zero)."""
    tree = load_checkpoint(ckpt_dir, sync_tree(rspec, state))
    return tree._replace(**{f: None if t is None else ravel(rspec, t)
                            for f, t in zip(tree._fields[1:], tree[1:])})


def _train_sync(args, cfg, device) -> dict:
    n = args.nodes
    robust = args.loss_prob > 0
    spec, state, grad_fn, batches, rspec = sync_setup(
        cfg, n, args.topology, batch_per_node=args.batch_per_node,
        seq=args.seq, seed=args.seed, device=device, robust=robust,
        momentum=args.momentum)
    start = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        start = latest_step(args.ckpt)
        state = load_sync_state(args.ckpt, rspec, state)
        print(f"resumed from step {start}", flush=True)
    gamma = warmup_cosine(args.gamma, warmup=max(1, args.steps // 20),
                          total=args.steps)
    # donate=True: the protocol state updates in place; the loop below
    # rebinds ``state`` every step and never replays an old one
    round_fn = make_rfast_round(
        spec, grad_fn, gamma=gamma, robust=robust,
        momentum=args.momentum, impl=args.impl, donate=True)
    p = state.x.shape[1]
    memory = {"init": _cuda_memory(device)}
    print(f"arch={cfg.name} p={p} nodes={n} topo={args.topology} "
          f"robust={robust} momentum={args.momentum} impl={args.impl} "
          f"device={device}", flush=True)

    # as the reference does, a resumed run draws its loss masks afresh
    # from this generator: a resumed lossy run is not the uninterrupted
    # one
    rng = np.random.default_rng(args.seed + 1)
    logger = MetricsLogger(args.metrics) if args.metrics else None
    timer = StepTimer()
    t0 = time.perf_counter()
    losses: list[float] = []
    for step in range(start, args.steps):
        masks = None
        if robust:
            masks = torch.from_numpy(
                (rng.uniform(size=spec.e_pad) >= args.loss_prob)
                .astype(np.float32)).to(device)
        state, metrics = round_fn(state, batches(step), None, masks)
        if step == start:
            memory["round1"] = _cuda_memory(device)
        timer.tick()
        if logger:
            logger.log(step + 1, loss=metrics["loss"],
                       sps=timer.steps_per_sec)
        if (step == start or (step + 1) % args.log_every == 0
                or step + 1 == args.steps):
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"step {step + 1:5d} loss {loss:.4f} "
                  f"({time.perf_counter() - t0:.1f}s, "
                  f"{timer.steps_per_sec:.2f} it/s)", flush=True)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, step + 1, sync_tree(rspec, state))
    if logger:
        logger.close()
    # Lemma 3: Σz + Σ(ρ − ρ̃) == Σ g_prev, relative to |Σ g_prev|
    g_sum = state.g_prev.sum(0)
    mass_rel = float(torch.linalg.vector_norm(
        runtime_tracked_mass(state) - g_sum) / torch.linalg.vector_norm(g_sum))
    state_bytes = sum(t.numel() * t.element_size() for t in state[1:]
                      if t is not None)
    print(f"done: {args.steps} rounds, lemma3 rel {mass_rel:.3e}",
          flush=True)
    return {"mode": "sync", "losses": losses, "steps": args.steps,
            "p": p, "rounds": args.steps, "start": start,
            "mass_rel": mass_rel,
            "state_bytes": state_bytes,
            "memory": {k: v for k, v in memory.items() if v is not None}}


def _cuda_memory(device) -> dict | None:
    """Bytes the CUDA allocator holds for tensors now and at its peak so
    far (None on the CPU): read after the init and after round 1, they
    split the sync run's peak between the init gradient and a round."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return {"allocated": torch.cuda.memory_allocated(dev),
            "peak_allocated": torch.cuda.max_memory_allocated(dev)}


# --------------------------------------------------------------------- #
# fully asynchronous (scenario trace through the wavefront engine)
# --------------------------------------------------------------------- #
def _train_async(args, cfg, device) -> dict:
    n = args.nodes
    topo = get_topology(args.topology, n)
    prob = make_lm_problem(cfg, n, batch_per_node=args.batch_per_node,
                           seq_len=args.seq, seed=args.seed, device=device)
    sc = get_scenario(args.scenario, n)
    K = args.steps * n
    if sc.dynamic:
        return _train_async_dynamic(args, cfg, prob, topo, sc, K, device)
    rank, mesh, say = 0, None, print
    if args.param_shards > 1:
        from repro_torch.launch.mesh import make_sweep_mesh
        mesh = make_sweep_mesh(lanes=1, param_shards=args.param_shards)
        rank = mesh.rank
        if rank:
            say = lambda *a, **k: None        # rank 0 alone prints
        if mesh.coords is None:               # ranks beyond the mesh idle
            return {"mode": "async", "idle": True, "rank": rank}
    trace = sc.realize(topo, K, seed=args.seed)
    sched = trace.schedule
    # delivered fraction over *attempted* sends (the active agent's
    # out-edges per event), not over the all-False inactive rows
    outdeg = np.zeros((2, n))
    for g, edges in enumerate((topo.edges_W(), topo.edges_A())):
        for (j, _i) in edges:
            outdeg[g, j] += 1
    attempts = outdeg[:, sched.agent].sum()
    delivered = float((trace.send_ok_w.sum() + trace.send_ok_a.sum())
                      / max(1.0, attempts))
    say(f"arch={cfg.name} p={prob.p} ({prob.spec.p_model} model) "
        f"nodes={n} topo={topo.name} scenario={args.scenario} "
        f"K={K} D={sched.D} T={sched.T} send_ok={delivered:.2f} "
        f"impl={args.impl} device={device}", flush=True)
    if mesh is not None:
        import torch.distributed as dist
        say(f"mesh: 1x{args.param_shards} (lane x param shards) of "
            f"{dist.get_world_size() if _in_group() else 1} ranks",
            flush=True)

    x0 = prob.x0_flat
    # chunk (= eval/ckpt) boundaries: log_every activations per node
    eval_every = max(n, min(K, args.log_every * n))
    save_every_chunks = max(1, args.ckpt_every // max(1, args.log_every))
    state0 = None
    if args.ckpt and latest_step(args.ckpt) is not None:
        template = zeros_state(topo, prob.p, int(sched.D) + 2,
                               device=device)
        state0 = load_checkpoint(args.ckpt, template)
        del template
        print(f"resumed from event {state0.k}/{K}", flush=True)
    start = 0 if state0 is None else state0.k
    logger = MetricsLogger(args.metrics) if args.metrics and not rank \
        else None
    timer = StepTimer()
    t0 = time.perf_counter()
    losses: list[float] = [prob.mean_loss(x0)]
    say(f"event {0:6d} loss {losses[0]:.4f} (init)", flush=True)

    def eval_and_log(state, t):
        loss = prob.mean_loss(_consensus_average(state, mesh, prob.p))
        losses.append(loss)
        timer.tick()
        if logger:
            logger.log(state.k, loss=loss, sps=timer.steps_per_sec)
        say(f"event {state.k:6d} loss {loss:.4f} vtime {t:8.1f} "
            f"({time.perf_counter() - t0:.1f}s)", flush=True)
        return {"loss": loss, "t": t}

    published: list[int] = []

    def chunk_cb(state, k):
        if args.ckpt and (k >= K
                          or (k // eval_every) % save_every_chunks == 0):
            save_checkpoint(args.ckpt, k, state)
        if args.publish_dir:
            # serving checkpoint: the consensus average x̄ as the model's
            # parameter tree
            save_checkpoint(args.publish_dir, k,
                            unravel(prob.spec, state.x.mean(0)))
            published.append(k)

    if mesh is None:
        state, metrics = run_rfast(
            topo, sched, prob, x0, args.gamma, seed=args.seed,
            eval_every=eval_every, eval_fn=eval_and_log, impl=args.impl,
            state0=state0,
            chunk_cb=chunk_cb if args.ckpt or args.publish_dir else None,
            device=device, verify_plans=args.verify_plans)
    else:
        # one lane, its flat state split over the mesh's param shards;
        # --ckpt / --publish-dir were refused in parse_args
        states, metrics = run_sweep(
            topo, [sched], prob, x0, args.gamma, seeds=[args.seed],
            eval_every=eval_every, eval_fn=eval_and_log, impl=args.impl,
            device=device, verify_plans=args.verify_plans, mesh=mesh)
        state, metrics = states[0], metrics[0]
    del x0, state0
    if logger:
        logger.close()
    mass_rel = _lemma3_rel(state, mesh)
    packed_bytes = 4 * (4 * state.x.numel() + 2 * state.rho.numel()
                        + state.v_hist.numel() + state.rho_hist.numel())
    if len(losses) > 1:
        say(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {K} "
            f"events ({float(sched.times[-1]):.1f} vtime), lemma3 rel "
            f"{mass_rel:.3e}", flush=True)
    else:
        say("done (schedule already complete)", flush=True)
    out = {"mode": "async", "scenario": args.scenario, "losses": losses,
           "events": K, "vtime": float(sched.times[-1]),
           "send_ok": delivered, "p": prob.p, "start": start,
           "published": published,
           "waves": sum(m["waves"] for m in metrics),
           "mass_rel": mass_rel, "packed_bytes": packed_bytes}
    if mesh is not None:
        out.update(param_shards=args.param_shards, rank=rank)
    return out


def _consensus_average(state, mesh, p: int) -> torch.Tensor:
    """x̄ of a lane state, at full width: a param shard gathers its
    slice's average over the mesh's param group (one row)."""
    x_bar = state.x.mean(0)
    if mesh is None:
        return x_bar
    return all_gather_flat(x_bar, mesh.group("model"))[:p]


def _lemma3_rel(state, mesh=None) -> float:
    """Lemma 3's residual ``|Σz + Σ(ρ − ρ̃) − Σ g_prev| / |Σ g_prev|``;
    a param shard sums the squared norms of every shard's slice."""
    g_sum = state.g_prev.sum(0)
    if mesh is None:
        return float(torch.linalg.vector_norm(tracked_mass(state) - g_sum)
                     / torch.linalg.vector_norm(g_sum))
    sq = torch.stack([torch.sum((tracked_mass(state) - g_sum) ** 2),
                      torch.sum(g_sum ** 2)]).to(torch.float32)
    num, den = all_gather_flat(sq[:, None], mesh.group("model")).sum(
        1).tolist()
    return float(np.sqrt(num / den))


# --------------------------------------------------------------------- #
# dynamic scenarios (membership epochs through run_epochs)
# --------------------------------------------------------------------- #
def _train_async_dynamic(args, cfg, prob, topo, sc, K, device) -> dict:
    """Train under a dynamic-membership scenario: the realized trace is
    partitioned into topology epochs (joins, leaves, regional failures,
    root re-election when a common root enters a crash window) and run
    through :func:`run_epochs`, which migrates the packed state across
    every plan change.  ``--ckpt`` is rejected in :func:`parse_args`."""
    n = args.nodes
    et = sc.realize_epochs(topo, K, seed=args.seed)
    print(f"arch={cfg.name} p={prob.p} ({prob.spec.p_model} model) "
          f"nodes={n} topo={topo.name} scenario={args.scenario} "
          f"K={K} epochs={len(et.epochs)} impl={args.impl} device={device}",
          flush=True)
    table = []
    for i, ep in enumerate(et.epochs):
        table.append({"k0": ep.k0, "events": ep.K, "t0": ep.t0,
                      "root": ep.root,
                      "active": int(ep.topology.active_mask().sum()),
                      "graph": ep.topology.name})
        print(f"  epoch {i}: t0={ep.t0:7.1f} events {ep.k0}..{ep.k0 + ep.K} "
              f"root={ep.root} active={table[-1]['active']}/{n} "
              f"graph={ep.topology.name}", flush=True)

    x0 = prob.x0_flat
    eval_every = max(n, min(K, args.log_every * n))
    t0 = time.perf_counter()
    losses: list[float] = [prob.mean_loss(x0)]
    print(f"event {0:6d} loss {losses[0]:.4f} (init)", flush=True)

    def eval_and_log(state, t):
        loss = prob.mean_loss(state.x.mean(0))
        losses.append(loss)
        print(f"event {state.k:6d} loss {loss:.4f} vtime {t:8.1f} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        return {"loss": loss, "t": t}

    published: list[int] = []

    def publish(state, k):
        save_checkpoint(args.publish_dir, k,
                        unravel(prob.spec, state.x.mean(0)))
        published.append(k)

    state, metrics = run_epochs(
        et, prob, x0, args.gamma, seed=args.seed, eval_every=eval_every,
        eval_fn=eval_and_log, impl=args.impl,
        chunk_cb=publish if args.publish_dir else None, device=device,
        verify_plans=args.verify_plans)
    del x0
    mass_rel = _lemma3_rel(state)
    vtime = metrics[-1]["t"]
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {K} "
          f"events, {len(et.epochs)} epochs ({vtime:.1f} vtime), lemma3 "
          f"rel {mass_rel:.3e}", flush=True)
    return {"mode": "async-dynamic", "scenario": args.scenario,
            "losses": losses, "events": K, "epochs": len(et.epochs),
            "epoch_table": table, "published": published,
            "vtime": float(vtime), "p": prob.p,
            "waves": sum(m["waves"] for m in metrics), "mass_rel": mass_rel}


if __name__ == "__main__":
    main()
