"""The port's counterpart of examples/train_rfast.py: train an LM with
the R-FAST protocol through ``repro_torch.launch.train``.

Default is a reduced model through the synchronous rounds; ``--full``
trains the real ~100M-param ``rfast-100m`` config for a few hundred
steps.  ``--scenario <name>`` trains *fully asynchronously* instead: the
named NetworkScenario (stragglers, lossy links, crash/recovery — see
``repro_torch.core.scenario.SCENARIOS``) is realized into a per-event
trace and the model rides the wavefront engine.  Runs on the card
unless given ``--device cpu``.

    PYTHONPATH=src python3 tools/train_rfast.py --device cpu      # smoke
    python3 tools/train_rfast.py --full --steps 300
    python3 tools/train_rfast.py --scenario straggler

Checkpoints go under ``build/`` of the checkout (one directory per
regime and scale: the sync rounds persist a ProtocolState, ``--scenario``
a flat RFASTState, and ``--full`` another parameter count, so mixing
them in one directory cannot resume), or to ``--ckpt``.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def command(argv=None) -> list[str]:
    """The ``launch.train`` command line the arguments ask for."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--scenario", default="",
                    help="train asynchronously under a named "
                         "NetworkScenario (e.g. straggler, packet_loss, "
                         "crash_recovery)")
    ap.add_argument("--loss-prob", type=float, default=0.1,
                    help="simulated packet loss in the synchronous rounds "
                         "(exercises robust tracking); ignored with "
                         "--scenario")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: under build/)")
    args = ap.parse_args(argv)
    ckpt = args.ckpt or str(
        ROOT / "build" / f"rfast_ckpt_{args.scenario or 'sync'}"
        f"_{'full' if args.full else 'reduced'}")
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "rfast-100m", "--nodes", "4", "--topology",
           "binary_tree", "--ckpt", ckpt]
    if args.scenario:
        cmd += ["--scenario", args.scenario]   # the scenario owns loss/delay
    else:
        cmd += ["--loss-prob", str(args.loss_prob)]
    if args.full:
        cmd += ["--steps", str(args.steps or 300), "--seq", "512",
                "--batch-per-node", "8", "--gamma", "1e-3"]
    else:
        cmd += ["--reduced", "--steps", str(args.steps or 60), "--seq", "64",
                "--batch-per-node", "2"]
    if args.device:
        cmd += ["--device", args.device]
    return cmd


def main(argv=None) -> int:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    return subprocess.call(command(argv), env=env, cwd=ROOT)


if __name__ == "__main__":
    raise SystemExit(main())
