"""The port's counterpart of examples/topology_zoo.py: Fig. 4a, R-FAST
over five topologies (a loss and accuracy table), then the dynamic-graph
coda: the sole common root of ``robust_tree`` departs mid-run and the
epochized engine re-elects a root on the surviving subgraph; on the card
(or the CPU).

    PYTHONPATH=src python3 tools/topology_zoo.py --device cpu
    python3 tools/topology_zoo.py               # on the CUDA card

The example's steps and sizes; ``--events`` cuts K for a quick run.  The
gradients draw from the port's per-event generators, so the losses
follow the example's statistically, not digit for digit.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402

from repro_torch.core import (generate_schedule, get_scenario,  # noqa: E402
                              get_topology, run_rfast)
from repro_torch.core.simulator import run_epochs  # noqa: E402
from repro_torch.data import make_logistic_problem  # noqa: E402

N_NODES, GAMMA = 7, 5e-3
TOPOLOGIES = ("binary_tree", "line", "directed_ring", "exponential",
              "mesh2d")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--events", type=int, default=10_000,
                    help="events K of every run")
    args = ap.parse_args(argv)
    n, K = N_NODES, args.events
    prob = make_logistic_problem(n, m=2800, d=64, batch=16,
                                 heterogeneous=True, device=args.device)
    x0 = torch.zeros(prob.p, device=prob.device)
    out: dict = {"topologies": {}}

    print(f"{'topology':>16} | common roots | final loss | acc")
    print("-" * 55)
    for name in TOPOLOGIES:
        topo = get_topology(name, n)
        sched = generate_schedule(topo, K, latency=0.3, seed=0)
        state, _ = run_rfast(topo, sched, prob.grad_fn(), x0, GAMMA,
                             device=prob.device)
        x_bar = state.x.mean(0)
        loss, acc = float(prob.mean_loss(x_bar)), float(prob.accuracy(x_bar))
        out["topologies"][name] = {"roots": topo.roots(), "loss": loss,
                                   "acc": acc}
        print(f"{name:>16} | {str(topo.roots()):>12} | {loss:10.4f} | "
              f"{acc:.3f}")

    # mid-run root re-election: node 0 (the ONLY common root of the tree)
    # leaves permanently; the trace splits into topology epochs and the
    # engine migrates state onto a rebuilt plan rooted at a survivor
    print("\nroot failover on robust_tree (sole common root departs):")
    topo = get_topology("robust_tree", n)
    trace = get_scenario("root_failover", n).realize_epochs(topo, K, seed=0)
    out["epochs"] = []
    for i, ep in enumerate(trace.epochs):
        act = int(ep.topology.active_mask().sum())
        out["epochs"].append({"root": ep.root, "active": act})
        print(f"  epoch {i}: t0={ep.t0:6.1f}  events {ep.k0}..{ep.k0 + ep.K}"
              f"  root={ep.root}  active={act}/{n}  "
              f"graph={ep.topology.name}")
    state, _ = run_epochs(trace, prob.grad_fn(), x0, GAMMA, seed=0,
                          device=prob.device)
    alive = torch.as_tensor(trace.epochs[-1].topology.active_mask(),
                            device=state.x.device)
    x_bar = state.x[alive].mean(0)
    out["survivors"] = {"loss": float(prob.mean_loss(x_bar)),
                        "acc": float(prob.accuracy(x_bar))}
    print(f"  survivors' final loss {out['survivors']['loss']:.4f} | "
          f"acc {out['survivors']['acc']:.3f}")
    return out


if __name__ == "__main__":
    main()
