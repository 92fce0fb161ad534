"""End-to-end asynchronous R-FAST training driver of the port.

Counterpart of ``src/repro/launch/train.py --scenario <name>``: a static
:class:`~repro_torch.core.scenario.NetworkScenario` (stragglers, latency,
loss, crash/recovery) is realized into a per-event trace, and the LM
trains through the wavefront engine on the flat-parameter substrate.
``--steps N`` means N activations per node (K = N·nodes events).

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --nodes 4 --steps 20 --scenario straggler --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when no GPU
is present and the CPU was not asked for.  ``--impl kernel`` (default)
commits every wave through the hand-written ``commit_grid`` kernel;
``--impl plain`` through PyTorch ops.  On the card, float32 matmuls run
in full float32 (TF32 off), as the reference does.

Not ported yet, each rejected with an error: the synchronous regime (no
``--scenario``), ``--ckpt``, ``--publish-dir``, ``--param-shards`` and
dynamic (membership) scenarios.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.scenario import SCENARIOS, get_scenario
from repro_torch.core.simulator import IMPLS, run_rfast, tracked_mass
from repro_torch.core.topology import get_topology
from repro_torch.data.objectives import make_lm_problem
from repro_torch.kernels.rfast_update import dispatch

_NOT_PORTED = "is not ported yet (repro_torch runs the async regime only)"


def main(argv=None) -> dict:
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
    ap.add_argument("--scenario", default="", metavar="NAME",
                    help="train asynchronously under a named static "
                         f"NetworkScenario ({', '.join(sorted(SCENARIOS))})")
    ap.add_argument("--impl", default="kernel", choices=IMPLS,
                    help="commit backend: kernel (hand-written CUDA "
                         "commit_grid) or plain (PyTorch ops)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--publish-dir", default="")
    ap.add_argument("--param-shards", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not args.scenario:
        ap.error(f"the synchronous regime {_NOT_PORTED}; pass --scenario")
    for flag, on in (("--ckpt", args.ckpt), ("--publish-dir",
                                             args.publish_dir),
                     ("--param-shards", args.param_shards > 1)):
        if on:
            ap.error(f"{flag} is not ported yet")
    if get_scenario(args.scenario, args.nodes).dynamic:
        ap.error(f"dynamic scenario {args.scenario!r}: membership epochs "
                 "are not ported yet")
    device = dispatch.resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return _train_async(args, cfg, device)


def _train_async(args, cfg, device) -> dict:
    n = args.nodes
    topo = get_topology(args.topology, n)
    prob = make_lm_problem(cfg, n, batch_per_node=args.batch_per_node,
                           seq_len=args.seq, seed=args.seed, device=device)
    K = args.steps * n
    trace = get_scenario(args.scenario, n).realize(topo, K, seed=args.seed)
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
    print(f"arch={cfg.name} p={prob.p} ({prob.spec.p_model} model) "
          f"nodes={n} topo={topo.name} scenario={args.scenario} "
          f"K={K} D={sched.D} T={sched.T} send_ok={delivered:.2f} "
          f"impl={args.impl} device={device}", flush=True)

    x0 = prob.x0_flat
    eval_every = max(n, min(K, args.log_every * n))
    t0 = time.perf_counter()
    losses: list[float] = [prob.mean_loss(x0)]
    print(f"event {0:6d} loss {losses[0]:.4f} (init)", flush=True)

    def eval_and_log(state, t):
        loss = prob.mean_loss(state.x.mean(0))
        losses.append(loss)
        ev = min(K, (len(losses) - 1) * eval_every)
        print(f"event {ev:6d} loss {loss:.4f} vtime {t:8.1f} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        return {"loss": loss, "t": t}

    state, metrics = run_rfast(
        topo, sched, prob, x0, args.gamma, seed=args.seed,
        eval_every=eval_every, eval_fn=eval_and_log, impl=args.impl,
        device=device)
    del x0
    # Lemma 3: Σz + Σ(ρ − ρ̃) == Σ g_prev, relative to |Σ g_prev|
    g_sum = state.g_prev.sum(0)
    mass_rel = float(torch.linalg.vector_norm(tracked_mass(state) - g_sum)
                     / torch.linalg.vector_norm(g_sum))
    packed_bytes = 4 * (4 * state.x.numel() + 2 * state.rho.numel()
                        + state.v_hist.numel() + state.rho_hist.numel())
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {K} events "
          f"({float(sched.times[-1]):.1f} vtime), lemma3 rel {mass_rel:.3e}",
          flush=True)
    return {"mode": "async", "scenario": args.scenario, "losses": losses,
            "events": K, "vtime": float(sched.times[-1]),
            "send_ok": delivered, "p": prob.p,
            "waves": sum(m["waves"] for m in metrics),
            "mass_rel": mass_rel, "packed_bytes": packed_bytes}


if __name__ == "__main__":
    main()
