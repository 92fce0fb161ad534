"""Roofline analysis over the dry-run records, at the H100's rates.

Counterpart of ``src/repro/launch/roofline.py``.  For every (arch ×
shape × mesh) JSON that ``dryrun.py`` writes, derive, per card:

  compute term    = FLOPs_perdev / bf16 tensor-core peak          [s]
  memory term     = bytes_perdev / HBM rate                       [s]
  collective term = NVLink bytes / NVLink rate
                    + InfiniBand bytes / InfiniBand rate          [s]

(every collective the record counts: the node axes' ppermutes and
gathers, and the ``model`` axis' all-gathers, all-reduces,
reduce-scatters and all-to-alls of a tensor-parallel train case, on
NVLink within a host)

at the H100 SXM 80GB data-sheet rates of ``launch.mesh.HW`` (an
analysis at those rates, not a measurement).  FLOPs and bytes come from
the linear-in-L fit (``fit``) when the record has one, else from the
direct count; either is the port's exact eager count.  The reference
adds an analytic correction for the selective scan, whose while-loop
body XLA counts once; here the scan's wrappers count their own
operations, so no correction is added, and ``ssm_corr_perdev`` reports
the part of the count that came from them.

Also reports MODEL_FLOPS (6·N_active·tokens for training, 2·N_active·
tokens for inference), the MODEL/counted usefulness ratio, the HBM-fit
verdict (args + temp against a card's memory: 80 GB, or the card's own
``total_memory`` where one is present), the dominant term, and a
one-line lever.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --reports reports/dryrun_torch --out reports/roofline_torch.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import get_config
from .mesh import HBM_BYTES, HW
from .specs import SHAPES

__all__ = ["HBM_PER_CHIP", "hbm_per_chip", "ssm_correction_flops",
           "model_flops", "lever", "analyze", "analyze_record", "terms_s",
           "fmt_s",
           "to_markdown", "HEADER", "main"]

HBM_PER_CHIP = HBM_BYTES           # H100 SXM 80GB, data sheet
HEADER = ("# Roofline (H100 SXM 80GB data-sheet rates: 989 TF/s bf16 "
          "tensor cores, 3.35 TB/s HBM3, 450 GB/s NVLink 4 a direction "
          "within a host of 8, 50 GB/s NDR InfiniBand a card between "
          "hosts; an analysis, not a run)")


def hbm_per_chip() -> float:
    """A card's memory: the card's own ``total_memory`` where CUDA is
    present, else the data sheet's 80 GB."""
    import torch
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return float(HBM_PER_CHIP)


def ssm_correction_flops(cfg, shape: str, kind: str) -> float:
    """The reference's analytic scan FLOPs (global): 8·d_inner·d_state a
    token a layer, ×3 for training; 0 for decode.  Kept for comparison:
    the port counts the scan through its wrappers instead."""
    if cfg.mixer not in ("ssm", "hybrid"):
        return 0.0
    info = SHAPES[shape]
    tokens = info["batch"] * (info["seq"] if kind != "decode" else 1)
    if kind == "decode":
        return 0.0                      # decode has no scan
    mult = 3.0 if kind == "train" else 1.0
    return mult * cfg.n_layers * 8.0 * cfg.d_inner * cfg.ssm_state * tokens


def model_flops(cfg, shape: str) -> tuple[float, str]:
    info = SHAPES[shape]
    n_active = cfg.active_param_count()
    if info["kind"] == "train":
        tokens = info["batch"] * info["seq"]
        return 6.0 * n_active * tokens, "6·N_active·tokens"
    if info["kind"] == "prefill":
        tokens = info["batch"] * info["seq"]
        return 2.0 * n_active * tokens, "2·N_active·tokens"
    return 2.0 * n_active * info["batch"], "2·N_active·batch"


def lever(dom: str, rec: dict) -> str:
    if dom == "memory":
        return ("cut HBM traffic: coarser remat, fused protocol commit "
                "(commit_grid), chunked lse cross entropy, bf16 state")
    if dom == "collective":
        return ("cut gossip bytes: overlap the ppermutes with the "
                "gradient, keep matchings on NVLink within a host, "
                "quantize protocol messages; overlap the model axis' "
                "all-gathers and reduce-scatters with the GEMMs")
    return ("raise tensor-core use: bf16 wgmma GEMMs at larger per-card "
            "tiles, the flash kernels for attention")


def _counts(rec: dict) -> tuple[float, float, float, float]:
    """(flops, bytes, NVLink bytes, InfiniBand bytes) a card."""
    fit = rec.get("fit")
    if fit:
        return (fit["flops_perdev"], fit["bytes_perdev"],
                fit["coll_nvlink_bytes_perdev"], fit["coll_ib_bytes_perdev"])
    cs = rec["cost_scanned"]
    coll = rec.get("collectives_scanned", {}).values()
    return (cs["flops"], cs["bytes"], sum(v["nvlink_bytes"] for v in coll),
            sum(v["ib_bytes"] for v in coll))


def terms_s(rec: dict) -> dict:
    """The three roofline terms of a record, in seconds, at ``HW``."""
    fl, by, nv, ib = _counts(rec)
    return {"compute": fl / HW["peak_flops_bf16"],
            "memory": by / HW["hbm_bw"],
            "collective": nv / HW["ici_bw"] + ib / HW["ib_bw"]}


def analyze(path: str) -> dict | None:
    """:func:`analyze_record` of the record in the JSON file ``path``."""
    with open(path) as f:
        return analyze_record(json.load(f))


def analyze_record(rec: dict) -> dict:
    """A dry-run record's roofline row (see the module docstring)."""
    if rec.get("skipped"):
        return {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"], "skipped": rec["skipped"]}
    if not rec.get("ok"):
        return {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"], "error": rec.get("error", "?")}
    cfg = get_config(rec["arch"])
    chips = rec["chips"]
    terms = terms_s(rec)
    dom = max(terms, key=terms.get)
    fl_pd = _counts(rec)[0]
    mf, mf_kind = model_flops(cfg, rec["shape"])
    counted_global = fl_pd * chips
    mem = rec["memory"]
    hbm_need = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "rules": rec.get("rules", "base"),
        "chips": chips,
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "collective_s": terms["collective"], "dominant": dom,
        "model_flops": mf, "model_flops_kind": mf_kind,
        "hlo_flops_global": counted_global,
        "useful_ratio": mf / counted_global if counted_global else 0.0,
        "ssm_corr_perdev": float(rec.get("ssm_scan_flops", 0)),
        "args_gib": mem["argument_size_in_bytes"] / 2**30,
        "temp_gib": mem["temp_size_in_bytes"] / 2**30,
        "fits_hbm": hbm_need <= hbm_per_chip(),
        "lever": lever(dom, rec),
    }


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def to_markdown(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | compute | memory | collective | "
           "dominant | MODEL/counted | args GiB | temp GiB | fits |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"SKIP: {r['skipped'][:40]}… ||||||||")
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"ERROR: {r['error'][:40]} ||||||||")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{r['dominant']}** | "
            f"{r['useful_ratio']:.2f} | {r['args_gib']:.1f} | "
            f"{r['temp_gib']:.1f} | {'Y' if r['fits_hbm'] else 'N'} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reports", default="reports/dryrun_torch")
    ap.add_argument("--out", default="reports/roofline_torch.md")
    ap.add_argument("--json-out", default="reports/roofline_torch.json")
    args = ap.parse_args(argv)

    rows = []
    for path in sorted(glob.glob(os.path.join(args.reports, "*.json"))):
        r = analyze(path)
        if r:
            rows.append(r)
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    md = to_markdown(rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(HEADER + "\n\n" + md + "\n")
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1)
    print(md)


if __name__ == "__main__":
    main()
