"""Dry-run of the production matrix on the meta device: every
(architecture × input shape) for the production meshes, one rank each,
with its memory, cost and collective counts.

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and
compiles each case for a TPU pod of placeholder devices and reads XLA's
``memory_analysis()``, ``cost_analysis()`` and the collectives of its
HLO.  PyTorch has no compiler to ask.  Here a case's step
(:mod:`.specs`) runs once, eagerly, on tensors of ``torch.device(
"meta")``: shapes and dtypes, no data, nothing allocated.  A
``TorchDispatchMode`` sees every aten op of it, backward included, and
the kernel wrappers and the collectives record themselves
(:mod:`repro_torch.kernels.meta`, ``core/runtime_sharded``).  Per case
(the reference's record fields):

* ``memory.argument_size_in_bytes`` — the bytes of the step's inputs;
* ``memory.temp_size_in_bytes`` — the peak of live tensor bytes above
  the inputs (a storage counts from the op that makes it until its last
  tensor dies, so the tensors saved for backward count until the
  backward frees them);
* ``memory.output_size_in_bytes`` — the bytes of the step's outputs;
  ``generated_code_size_in_bytes`` is 0 (nothing is compiled);
* ``cost_scanned.flops`` — ``torch.utils.flop_counter``'s formulas over
  the aten ops, plus each kernel's own count;
* ``cost_scanned.bytes`` — each aten op's inputs plus outputs (views and
  allocations move nothing), as XLA's "bytes accessed" counts them, plus
  each kernel's own bytes;
* ``collectives_scanned`` — the collectives by kind (``all-gather``,
  ``collective-permute``, and the tensor-parallel ``all-reduce``,
  ``reduce-scatter`` and ``all-to-all`` over the ``model`` group) with
  their count and output bytes, split into those whose group stays
  within one host (``nvlink_bytes``: the ``model`` axis of the
  production mesh) and those that cross hosts (``ib_bytes``).  A
  serving case whose batch rows the ``data`` axes split
  (``case.batch_ranks``: ``decode_32k``, and ``prefill_32k`` on (32,
  8)) adds, for each MoE layer, one ``all-gather`` of the experts'
  choice counts over the batch group (``models/moe.py``): G × E × 8 B,
  across hosts on the production mesh (40,960 B a layer for
  deepseek-v2 at (32, 8)).  Where every rank holds every row
  (``long_500k``, ``prefill_32k`` on (2, 32, 8)) there is none.

``lower_s`` is the seconds spent building the case and ``compile_s``
those of the meta run that takes the compile's place.  The port runs
every layer eagerly, so its count over the whole depth is exact; the
reference's linear fit in L (``fit``, at L = 2 and 4) is kept so that
:mod:`.roofline` reads the same schema, and at full L it equals the
direct count.  ``--rules fsdp`` changes the GSPMD layout the record
reports (``gspmd``: the bytes a rank would hold under the reference's
specs) beside what the port's rank holds (the same blocks for a
tensor-parallel case, ``model_axis: "tensor"``: every arch's train,
prefill and decode cases, whose serving arguments are a rank's blocks
of the weights and of the cache as ``cache_pspecs`` lays it out, an
enc-dec arch's cross caches and MLA's latent included; the record's
``case.cache_layout`` names the ring's, the SSM state's, the cross
caches' and the latent's layouts).

Artifacts: ``<out>/<arch>__<shape>__<mesh>[__<rules>].json``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..core import runtime_sharded
from ..kernels import meta as kmeta
from . import shardings as shd
from .mesh import make_production_mesh
from .specs import SHAPES, build_case, shape_supported, tensors_of

__all__ = ["run_case", "case_path", "measure", "run_live", "scale_layers",
           "lin", "main", "COLLECTIVE_KINDS", "SCAN_KERNELS"]

# the port's collective -> the HLO op the reference's record names
COLLECTIVE_KINDS = {"all_gather_flat": "all-gather",
                    "all_gather_seq": "all-gather",
                    "ppermute": "collective-permute",
                    "all_reduce_sum": "all-reduce",
                    "all_reduce_max": "all-reduce",
                    "reduce_scatter_seq": "reduce-scatter",
                    "all_to_all": "all-to-all"}
SCAN_KERNELS = ("ssm_scan", "ssm_scan_bwd")
aten = torch.ops.aten
# ops that allocate and move nothing
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default}


class _Counter(TorchDispatchMode):
    """Bytes each aten op reads and writes, and the live bytes of the
    storages made inside the mode (their peak)."""

    def __init__(self, inputs):
        super().__init__()
        self.known = {t.untyped_storage()._cdata for t in inputs}
        self.alive: dict[int, int] = {}
        self.live = self.peak = self.bytes = self.ops = 0

    def _free(self, key: int) -> None:
        self.live -= self.alive.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self.alive:
            return
        self.alive[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        self.ops += 1
        if not func.is_view and func not in _NO_TRAFFIC:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        return out


def _distinct_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def measure(step, args) -> dict:
    """Run ``step(*args)`` once under the counters; returns the record's
    ``memory``, ``cost_scanned`` and ``collectives_scanned`` and the
    kernels' launches with their counts."""
    ins = tensors_of(args)
    counter = _Counter(ins)
    with kmeta.recording() as launches, \
            runtime_sharded.record_collectives() as colls, \
            FlopCounterMode(display=False) as flops, counter:
        out = step(*args)
    out_t = [t for t in tensors_of(out)
             if t.untyped_storage()._cdata not in counter.known]
    kernels: dict[str, dict] = {}
    for c in launches:
        k = kernels.setdefault(c["name"], {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += c["flops"]
        k["bytes"] += c["bytes"]
    coll: dict[str, dict] = {}
    for c in colls:
        if c["group_size"] <= 1:
            continue
        d = coll.setdefault(COLLECTIVE_KINDS[c["name"]], {
            "count": 0, "bytes": 0, "nvlink_bytes": 0, "ib_bytes": 0})
        d["count"] += 1
        d["bytes"] += c["bytes"]
        d["nvlink_bytes" if c["intra_host"] else "ib_bytes"] += c["bytes"]
    aten_flops = int(flops.get_total_flops())
    k_flops = sum(k["flops"] for k in kernels.values())
    k_bytes = sum(k["bytes"] for k in kernels.values())
    return {
        "memory": {"argument_size_in_bytes": _distinct_bytes(ins),
                   "output_size_in_bytes": _distinct_bytes(out_t),
                   "temp_size_in_bytes": counter.peak,
                   "generated_code_size_in_bytes": 0},
        "cost_scanned": {"flops": float(aten_flops + k_flops),
                         "bytes": float(counter.bytes + k_bytes)},
        "collectives_scanned": coll,
        "flops_aten": aten_flops, "flops_kernels": k_flops,
        "bytes_aten": counter.bytes, "bytes_kernels": k_bytes,
        "kernels": kernels, "aten_ops": counter.ops,
        "ssm_scan_flops": sum(kernels[k]["flops"] for k in SCAN_KERNELS
                              if k in kernels),
    }


def run_live(step, args, runs: int = 2) -> dict:
    """The same step on a live device, for holding a meta record to it:
    the bytes of its inputs, its aten FLOPs (``FlopCounterMode`` over
    the first run), and for each of ``runs`` runs of ``step(*args)`` the
    kernel launches (``dispatch``'s counters, zeroed before each), the
    peak allocator bytes above those before the run, and the wall
    seconds (synchronized; the counted first run is not timed)."""
    from ..kernels.rfast_update import dispatch
    ins = tensors_of(args)
    cuda = any(t.device.type == "cuda" for t in ins)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with FlopCounterMode(display=False) as flops:
        out = step(*args)
    del out
    sync()
    got = {"argument_size_in_bytes": _distinct_bytes(ins),
           "flops_aten": int(flops.get_total_flops()), "launches": [],
           "peak_above_args_bytes": [], "wall_s": []}
    for _ in range(runs):
        dispatch.clear()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = step(*args)
        sync()
        got["wall_s"].append(time.perf_counter() - t0)
        got["launches"].append(dispatch.stats()["by_kernel"])
        if cuda:
            got["peak_above_args_bytes"].append(
                torch.cuda.max_memory_allocated() - base)
        del out
    dispatch.clear()
    return got


def scale_layers(cfg, k: int):
    return dataclasses.replace(
        cfg, n_layers=k,
        n_enc_layers=(min(k, cfg.n_enc_layers) if cfg.enc_dec else 0))


def lin(f2: float, f4: float, L: int) -> float:
    """The reference's fit: a count at L = 2 and 4 extended to L layers."""
    body = (f4 - f2) / 2.0
    return max(0.0, f2 - 2 * body) + L * body


def _coll_bytes(coll: dict, which: str = "bytes") -> int:
    return sum(v[which] for v in coll.values())


def _gspmd(cfg, mesh, rules) -> dict:
    """What a rank would hold of the parameter tree under the
    reference's GSPMD layout (``rules``), beside the whole tree that a
    rank of the port holds."""
    from ..models.transformer import param_shapes
    held = []
    shd.tree_map_with_path(lambda p, leaf: held.append((
        leaf.numel(), math.prod(shd.shard_shape(
            shd.param_pspec(p, leaf, mesh, rules), leaf.shape, mesh)))),
        param_shapes(cfg))
    return {"param_elements": sum(n for n, _ in held),
            "param_shard_elements_per_rank": sum(s for _, s in held)}


def _mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def run_case(arch: str, shape: str, *, multi_pod: bool = False,
             rules_name: str = "base", fit: bool = True,
             build_kw: dict | None = None, verbose: bool = True,
             cfg=None) -> dict:
    """One case's record (the reference's fields; see the module
    docstring) on a rank of the production mesh; ``cfg`` defaults to
    ``get_config(arch)``.  A failed case is a record with ``error``."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = cfg or get_config(arch)
    rules = shd.RULES_FSDP if rules_name == "fsdp" else shd.RULES_BASE
    chips = 1
    for a in mesh.axis_names:
        chips *= mesh.shape[a]
    rec: dict = {"arch": arch, "shape": shape, "mesh": _mesh_name(mesh),
                 "chips": chips, "rules": rules_name, "ok": False}
    ok, why = shape_supported(cfg, shape)
    if not ok:
        rec["skipped"] = why
        return rec
    kw = dict(rules=rules, **(build_kw or {}))
    try:
        t0 = time.perf_counter()
        fn, args = build_case(cfg, mesh, shape, **kw)
        t1 = time.perf_counter()
        got = measure(fn, args)
        t2 = time.perf_counter()
        rec["ok"] = True
        rec["lower_s"] = round(t1 - t0, 1)
        rec["compile_s"] = round(t2 - t1, 1)
        rec.update(got)
        rec["case"] = fn.info
        rec["model_axis"] = fn.info["model_axis"]
        rec["dtype"] = fn.info["dtype"]
        rec["gspmd"] = _gspmd(cfg, mesh, rules)
        if verbose:
            mem = rec["memory"]
            print(f"  [{arch} {shape} {rec['mesh']}] meta run ok "
                  f"({rec['compile_s']}s): args/device="
                  f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB, "
                  f"temp/device={mem['temp_size_in_bytes'] / 2**30:.2f} GiB"
                  + (f", cache {fn.info['cache_layout']}"
                     if fn.info.get("cache_layout") else ""), flush=True)
        del args
        if fit:
            costs = {}
            for k in (2, 4):
                fnk, argsk = build_case(scale_layers(cfg, k), mesh, shape,
                                        **kw)
                gk = measure(fnk, argsk)
                costs[k] = dict(gk["cost_scanned"],
                                collectives=gk["collectives_scanned"])
                del argsk
            L = cfg.n_layers
            c2, c4 = (costs[k]["collectives"] for k in (2, 4))
            rec["fit"] = {
                "L": L,
                "flops_perdev": lin(costs[2]["flops"], costs[4]["flops"], L),
                "bytes_perdev": lin(costs[2]["bytes"], costs[4]["bytes"], L),
                "coll_bytes_perdev": lin(_coll_bytes(c2), _coll_bytes(c4),
                                         L),
                "coll_nvlink_bytes_perdev": lin(
                    _coll_bytes(c2, "nvlink_bytes"),
                    _coll_bytes(c4, "nvlink_bytes"), L),
                "coll_ib_bytes_perdev": lin(_coll_bytes(c2, "ib_bytes"),
                                            _coll_bytes(c4, "ib_bytes"), L),
                "l2": costs[2], "l4": costs[4],
            }
    except Exception as e:  # noqa: BLE001 — a failed case is a data point
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"  [{arch} {shape} {rec['mesh']}] FAILED: {rec['error']}",
                  flush=True)
    return rec


def case_path(outdir: str, rec: dict) -> str:
    name = (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
            + ("" if rec["rules"] == "base" else f"__{rec['rules']}")
            + ".json")
    return os.path.join(outdir, name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--rules", default="base", choices=["base", "fsdp"])
    ap.add_argument("--no-fit", action="store_true")
    ap.add_argument("--out", default="reports/dryrun_torch")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    archs = ARCHS[:10] if args.all else [args.arch]
    shapes = list(SHAPES) if args.all else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_case(arch, shape, multi_pod=mp,
                               rules_name=args.rules, fit=not args.no_fit)
                with open(case_path(args.out, rec), "w") as f:
                    json.dump(rec, f, indent=1)
                n_ok += rec["ok"]
                n_fail += (not rec["ok"]) and ("skipped" not in rec)
                n_skip += "skipped" in rec
    print(f"dry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
