"""Hillclimb runner: run named dry-run variants for the three chosen
(arch × shape) pairs and print their roofline terms side by side, at the
H100 SXM 80GB data-sheet rates (``launch.mesh.HW``).

Counterpart of ``src/repro/launch/hillclimb.py``; the variants are the
reference's.  Each runs through the port's :func:`.dryrun.run_case` (one
rank on meta).  ``comm``, ``node_axes`` and, for a decode case whose
ring the KV heads do not divide, ``cache_seq_shard`` change what the
port runs; ``rules`` beyond the ``model`` axis change only what its
record reports (the port runs no GSPMD layout).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair train|moe|decode
"""
from __future__ import annotations

import argparse
import json
import os

from .dryrun import run_case
from .roofline import terms_s

__all__ = ["VARIANTS", "terms", "main"]


def terms(rec: dict) -> str:
    if not rec.get("ok"):
        return f"FAILED: {rec.get('error', '')[:160]}"
    t = terms_s(rec)
    mem = rec["memory"]
    return (f"compute={t['compute']:.3f}s "
            f"memory={t['memory']:.3f}s "
            f"collective={t['collective']:.3f}s "
            f"args={mem['argument_size_in_bytes']/2**30:.1f}GiB "
            f"temp={mem['temp_size_in_bytes']/2**30:.1f}GiB")


VARIANTS = {
    "train": [  # llama3-8b x train_4k (paper-representative)
        ("it0_dense_fullce", "llama3-8b", "train_4k",
         dict(), "base", dict(comm="dense", ce="full")),
        ("it1_ppermute_fullce", "llama3-8b", "train_4k",
         dict(), "base", dict(comm="ppermute", ce="full")),
        ("it2_ppermute_lsece", "llama3-8b", "train_4k",
         dict(), "base", dict(comm="ppermute", ce="lse")),
    ],
    "moe": [   # deepseek-v2-236b x train_4k (worst memory / does not fit)
        ("it0_nodes32_base", "deepseek-v2-236b", "train_4k",
         dict(multi_pod=True), "base", dict()),
        ("it1_nodepod_fsdp", "deepseek-v2-236b", "train_4k",
         dict(multi_pod=True), "fsdp", dict(node_axes=("pod",))),
    ],
    "decode": [  # llama3-8b x decode_32k (most collective-bound)
        ("it0_headdim_cache", "llama3-8b", "decode_32k",
         dict(), "base", dict()),
        ("it1_seqshard_cache", "llama3-8b", "decode_32k",
         dict(), "base", dict(cache_seq_shard=True)),
    ],
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", choices=list(VARIANTS) + ["all"],
                    default="all")
    ap.add_argument("--out", default="reports/hillclimb_torch")
    ap.add_argument("--no-fit", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    pairs = list(VARIANTS) if args.pair == "all" else [args.pair]
    for pair in pairs:
        print(f"=== {pair} ===", flush=True)
        for name, arch, shape, case_kw, rules, build_kw in VARIANTS[pair]:
            rec = run_case(arch, shape, rules_name=rules,
                           fit=not args.no_fit, build_kw=build_kw,
                           verbose=False, **case_kw)
            rec["variant"] = name
            with open(os.path.join(args.out, f"{pair}__{name}.json"),
                      "w") as f:
                json.dump(rec, f, indent=1)
            print(f"{name:24s} {terms(rec)}", flush=True)


if __name__ == "__main__":
    main()
