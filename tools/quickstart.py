"""The port's counterpart of examples/quickstart.py: logistic regression
with R-FAST over a binary tree, fully asynchronously, with a straggler
and packet loss, on the card (or the CPU).

    PYTHONPATH=src python3 tools/quickstart.py --device cpu
    python3 tools/quickstart.py                 # on the CUDA card

The same steps and numbers as the JAX example; the gradients draw from
the port's per-event generators, so the losses follow the example's
statistically, not digit for digit.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402

from repro_torch.core import (binary_tree, generate_schedule,  # noqa: E402
                              run_rfast)
from repro_torch.data import make_logistic_problem  # noqa: E402

N_NODES = 7


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # 1. node-local data shards (heterogeneous: label-sorted, large ς)
    prob = make_logistic_problem(N_NODES, m=2800, d=64, batch=16,
                                 heterogeneous=True, device=args.device)

    # 2. two spanning-tree communication graphs W (pull) / A (push)
    topo = binary_tree(N_NODES)
    print("common roots:", topo.roots())

    # 3. an asynchronous schedule: node 6 is a 4x straggler, 20% loss
    sched = generate_schedule(topo, 12_000,
                              compute_time=[1, 1, 1, 1, 1, 1, 4.0],
                              loss_prob=0.2, latency=0.3, seed=0)
    print(f"realized delay bound D={sched.D}, activation bound T={sched.T}")

    # 4. run the exact Algorithm-2 recursion
    def eval_fn(state, t):
        x_bar = state.x.mean(0)
        return {"loss": float(prob.mean_loss(x_bar)),
                "acc": float(prob.accuracy(x_bar)), "t": t}

    _, metrics = run_rfast(topo, sched, prob, torch.zeros(prob.p), 5e-3,
                           eval_every=2000, eval_fn=eval_fn,
                           device=prob.device)
    for m in metrics:
        print(f"k={m['k']:6d}  vtime={m['t']:8.1f}  "
              f"loss={m['loss']:.4f}  acc={m['acc']:.3f}")


if __name__ == "__main__":
    main()
