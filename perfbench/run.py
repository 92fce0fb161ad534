"""Run one cell of the benchmark once, on the card, and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared beside its limit); the checks are also the last lines
of standard error.  The run exits non-zero and prints no result without a
CUDA card, without the program (``src/repro_torch``), or when JAX or the
JAX package was loaded.

``--control tf32`` and ``--fault <name>`` are for setting the comparison's
limits: the first puts the reference, in TF32, in the program's place; the
second plants a fault in the program (``bench/faults.py``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _say(text: str) -> None:
    print(text, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


def _finite(obj):
    """``obj`` with every non-finite number written as a string."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",))
    ap.add_argument("--fault")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        _say("the program (src/repro_torch) is not in this checkout")
        return 2
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch
    from bench import cell

    try:
        need = cell.load_cell(args.workload, ROOT)["cell"]["chips"]
    except (KeyError, OSError, ValueError) as e:
        _say(f"cannot load workload {args.workload!r}: {e}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        _say(f"needs {need} CUDA card(s); "
             f"found {torch.cuda.device_count()}")
        return 3
    torch.set_num_threads(1)
    # no path of the benchmark compiles with Triton; should one, its cache
    # stays in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    _say(f"card: {_power_limit()}")
    result = cell.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), root=ROOT, t_start=T_START,
                           control=args.control, fault=args.fault, log=_say)
    found = sorted(set(FORBIDDEN) & cell.top_level_modules())
    if found:
        _say(f"modules of JAX or the JAX package were loaded: {found}")
        return 4
    for k, c in result["checks"].items():
        _say(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
