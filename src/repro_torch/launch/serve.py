"""Serving entry point of the port: continuous-batching decode over
hot-swappable weights.

Counterpart of ``src/repro/launch/serve.py``: a thin CLI over
:mod:`repro_torch.serve` — a fixed-shape ``(B, max_len)`` decode batch
with slot recycling, a shape-keyed cache of step callables (no new entry
at steady state) and a double-buffered :class:`WeightStore` that polls a
``--publish-dir`` written by ``launch/train.py`` and flips weights
between decode steps.  DESIGN.md §14 has the architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --reduced --batch 4 --requests 64 --rate 50 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rfast-100m \\
        --publish-dir build/pub --poll-every 2

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when no GPU
is present and the CPU was not asked for; on the card float32 matmuls
run in full float32 (TF32 off), as the reference does.  ``--arch`` takes
every arch of the port; the engine serves the decoder-only attention
archs (``rfast-100m``, ``llama3-8b``, ``deepseek-7b``, ``olmo-1b``,
``qwen2.5-3b``, the MoE ``phi3.5-moe-42b-a6.6b`` and the MLA + MoE
``deepseek-v2-236b``) and refuses SSM and hybrid mixers, enc-dec
(``whisper-large-v3``) and frontend archs (``pixtral-12b``), as the
reference's does: those decode through ``models.transformer``'s
``prefill_cache(frontend=)`` and ``decode_step``.

RNG: the reference splits one JAX key into a parameter key and a traffic
key; torch cannot reproduce JAX's keys (ROADMAP ground rules), so the
port draws the parameters from a ``torch.Generator`` on the serving
device seeded with ``--seed`` (on the card a full-width model is drawn
there, without a host copy) and the traffic from a numpy seed drawn from
``default_rng(--seed)``: one stream per consumer, as there, but not the
reference's numbers.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.rfast_update.dispatch import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve import (DEFAULT_BUCKETS, ServeEngine, WeightStore,
                               cache as serve_cache, make_workload)


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ARCHS,
                    help="a decoder-only attention arch (the engine "
                         "refuses SSM, hybrid, enc-dec and frontend archs)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots B (fixed batch shape)")
    ap.add_argument("--max-len", type=int, default=64,
                    help="KV ring capacity bound per slot")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-prompt", type=int, default=16)
    ap.add_argument("--max-gen", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate (req/s); 0 = closed "
                         "backlog (all requests queued at t=0)")
    ap.add_argument("--zipf-s", type=float, default=1.2)
    ap.add_argument("--buckets", default=",".join(map(str, DEFAULT_BUCKETS)),
                    help="comma-separated prompt-length buckets (one "
                         "prefill cache entry each)")
    ap.add_argument("--publish-dir", default="",
                    help="poll this checkpoint dir (written by train.py "
                         "--publish-dir) and hot-swap between decode steps")
    ap.add_argument("--poll-every", type=int, default=16,
                    help="poll the manifest every N engine steps")
    ap.add_argument("--swap-mode", default="drain",
                    choices=("drain", "immediate"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def make_engine(args: argparse.Namespace) -> ServeEngine:
    """The engine of ``args``: parameters drawn on the serving device (or
    the latest step of ``--publish-dir`` loaded over them) behind a
    :class:`WeightStore`."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(args.seed))
    store = WeightStore(params)
    del params
    if args.publish_dir:
        man = ckpt.read_manifest(args.publish_dir)
        if man is not None and store.poll(args.publish_dir):
            store.flip()
            print(f"loaded published step {store.step} "
                  f"from {args.publish_dir}")
    buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    return ServeEngine(
        cfg, store, batch=args.batch, max_len=args.max_len,
        buckets=buckets, swap_mode=args.swap_mode,
        poll_every=args.poll_every if args.publish_dir else 0,
        ckpt_dir=args.publish_dir or None)


def make_requests(args: argparse.Namespace, vocab: int) -> list:
    """``args``' workload, from its own numpy stream."""
    seed = int(np.random.default_rng(args.seed).integers(0, 2**31 - 1))
    return make_workload(
        args.requests, vocab=vocab, max_prompt=args.max_prompt,
        max_gen=args.max_gen, rate_rps=args.rate, s=args.zipf_s, seed=seed)


def main(argv=None) -> dict:
    args = parse_args(argv)
    engine = make_engine(args)
    cfg = engine.cfg
    reqs = make_requests(args, cfg.vocab)

    report = engine.run(reqs)
    step_us = [r["us"] for r in report["steps"]]
    p50, p99 = _percentile(step_us, 50), _percentile(step_us, 99)
    print(f"arch={cfg.name} B={args.batch} C={engine.C} "
          f"buckets={engine.buckets} swap_mode={args.swap_mode} "
          f"device={engine.device}")
    print(f"served {len([r for r in reqs if r.done])}/{len(reqs)} req "
          f"({report['tokens']} tok) in {report['wall_s']:.2f}s "
          f"-> {report['reqs_per_s']:.1f} req/s")
    print(f"step p50 {p50:.0f}us p99 {p99:.0f}us; "
          f"swaps={len(report['swaps'])}; cache={report['cache']}")
    stats = serve_cache.stats()
    return {"mode": "serve", "arch": cfg.name,
            "served": sum(r.done for r in reqs),
            "reqs_per_s": report["reqs_per_s"], "p50_us": p50,
            "p99_us": p99, "swaps": len(report["swaps"]),
            "cache": stats, "report": report}


if __name__ == "__main__":
    main()
