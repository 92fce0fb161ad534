"""The port's counterpart of examples/straggler_robustness.py: the
paper's Table II story, R-FAST vs Ring-AllReduce vs OSGP with one
4x-slow node, every algorithm on the SAME NetworkScenario virtual clock,
on the card (or the CPU).

    PYTHONPATH=src python3 tools/straggler_robustness.py --device cpu
    python3 tools/straggler_robustness.py       # on the CUDA card

The example's steps and sizes; ``--events`` cuts K for a quick run.  The
gradients draw from the port's per-event generators, so the virtual
times follow the example's statistically, not digit for digit.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402

from repro_torch.core import (binary_tree, directed_ring,  # noqa: E402
                              generate_schedule, get_scenario, run_rfast)
from repro_torch.core.baselines import (run_osgp,  # noqa: E402
                                        run_ring_allreduce)
from repro_torch.data import make_logistic_problem  # noqa: E402

N_NODES, TARGET, GAMMA = 8, 0.35, 5e-3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--events", type=int, default=9600,
                    help="R-FAST's and OSGP's events K (rounds: K / n)")
    args = ap.parse_args(argv)
    n, K = N_NODES, args.events
    scenario = get_scenario("straggler", n)   # last node 4x slow, latency 0.3
    prob = make_logistic_problem(n, m=2800, d=64, batch=16,
                                 heterogeneous=True, device=args.device)
    gfn = prob.grad_fn()

    def eval_fn(x, t):
        xb = x.x if hasattr(x, "x") else x
        if xb.ndim == 2:
            xb = xb.mean(0)
        return {"loss": float(prob.mean_loss(xb)), "t": t}

    def t_to(ms):
        return next((m["t"] for m in ms if m["loss"] <= TARGET),
                    float("inf"))

    x0 = torch.zeros(prob.p, device=prob.device)
    # one scenario realization drives R-FAST's schedule...
    sched = generate_schedule(binary_tree(n), K, scenario=scenario)
    _, ms_rfast = run_rfast(binary_tree(n), sched, gfn, x0, GAMMA,
                            eval_every=300, eval_fn=eval_fn,
                            device=prob.device)
    t_rfast = t_to(ms_rfast)
    print(f"R-FAST         : vtime-to-loss={t_rfast:8.1f}  (1.00x)")

    # ... the same scenario's barrier clock prices the synchronous rounds
    _, ms_ring = run_ring_allreduce(n, gfn, x0, GAMMA, K // n,
                                    scenario=scenario, eval_fn=eval_fn,
                                    eval_every=30, device=prob.device)
    t_ring = t_to(ms_ring)
    print(f"Ring-AllReduce : vtime-to-loss={t_ring:8.1f}  "
          f"({t_ring / t_rfast:.2f}x slower — pays the straggler every "
          "barrier)")

    # ... and the same scenario's event clock drives OSGP's pushes.
    _, ms_osgp = run_osgp(directed_ring(n), gfn, x0, GAMMA, K,
                          scenario=scenario, eval_fn=eval_fn,
                          eval_every=300, device=prob.device)
    t_osgp = t_to(ms_osgp)
    print(f"OSGP           : vtime-to-loss={t_osgp:8.1f}  "
          f"({t_osgp / t_rfast:.2f}x)")
    return {"rfast": ms_rfast, "ring_allreduce": ms_ring, "osgp": ms_osgp,
            "vtime_to_target": {"rfast": t_rfast, "ring_allreduce": t_ring,
                                "osgp": t_osgp}}


if __name__ == "__main__":
    main()
