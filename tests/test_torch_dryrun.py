"""The meta-device dry-run, its counts, and the roofline over it.

* the record has the reference's schema (its keys, read from the
  reference's ``run_case``; the reference's own dry-run cannot run here,
  ROADMAP Queue 3) and the port's added keys;
* on reduced dense cases the meta FLOPs equal ``FlopCounterMode`` over
  the same step run on the CPU through the plain versions, plus the
  kernels' own counts, and the argument bytes equal the live ones;
* the linear fit in L at full L equals the direct count;
* a ppermute case's ``collective-permute`` bytes equal matchings × p ×
  itemsize, split by NVLink and InfiniBand as the mesh places the group;
* on meta tensors every kernel wrapper and both collectives record
  themselves and run no kernel, no plain twin and no ``torch.distributed``;
* ``model_flops`` and ``ssm_correction_flops`` equal the reference's, and
  the scan wrappers' FLOPs are their own per-launch counts;
* ``roofline.analyze`` and ``hillclimb.terms`` on a fixed record are the
  formulas at ``HW``'s H100 rates;
* the CLIs run in a subprocess, and ``multihost.main`` on one process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.launch import roofline as jroof
from repro_torch.configs import get_config
from repro_torch.core import runtime_sharded as rs
from repro_torch.core.plan import build_comm_plan
from repro_torch.core.topology import binary_tree
from repro_torch.kernels import meta as kmeta
from repro_torch.kernels.flash_attention import backward as fbwd
from repro_torch.kernels.flash_attention import kernel as ffwd
from repro_torch.kernels.rfast_update import dispatch, grid
from repro_torch.kernels.rfast_update import kernel as node
from repro_torch.kernels.ssm_scan import backward as sbwd
from repro_torch.kernels.ssm_scan import kernel as sfwd
from repro_torch.launch import dryrun, hillclimb, multihost, roofline, specs
from repro_torch.launch.mesh import HW, describe_mesh

ROOT = Path(__file__).resolve().parents[1]
# the record fields the reference's run_case writes (src/repro/launch/
# dryrun.py): its top level, memory, cost and fit keys
REF_KEYS = {"arch", "shape", "mesh", "chips", "rules", "ok", "lower_s",
            "compile_s", "memory", "cost_scanned", "collectives_scanned",
            "fit"}
REF_MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes"}
REF_FIT = {"L", "flops_perdev", "bytes_perdev", "coll_bytes_perdev", "l2",
           "l4"}
PORT_KEYS = {"flops_aten", "flops_kernels", "bytes_aten", "bytes_kernels",
             "kernels", "aten_ops", "ssm_scan_flops", "case", "model_axis",
             "dtype", "gspmd"}
PORT_FIT = {"coll_nvlink_bytes_perdev", "coll_ib_bytes_perdev"}


def _reduced(arch, layers=2):
    return dryrun.scale_layers(get_config(arch).reduced(), layers)


def test_record_has_the_reference_schema():
    rec = dryrun.run_case("rfast-100m", "decode_32k", cfg=_reduced(
        "rfast-100m"), verbose=False)
    assert rec["ok"], rec.get("error")
    assert set(rec) == REF_KEYS | PORT_KEYS
    assert set(rec["memory"]) == REF_MEMORY
    assert set(rec["cost_scanned"]) == {"flops", "bytes"}
    assert set(rec["fit"]) == REF_FIT | PORT_FIT
    assert rec["mesh"] == "32x8" and rec["chips"] == 256
    # decode runs the model axis tensor-parallel (the ring by slots)
    assert rec["model_axis"] == "tensor" and rec["dtype"] == "bfloat16"
    assert rec["case"]["cache_layout"] == {"kv": "slots", "ssm": None}
    skip = dryrun.run_case("whisper-large-v3", "long_500k", verbose=False)
    assert set(skip) == {"arch", "shape", "mesh", "chips", "rules", "ok",
                         "skipped"}
    fsdp = dryrun.run_case("rfast-100m", "decode_32k", rules_name="fsdp",
                           cfg=_reduced("rfast-100m"), fit=False,
                           verbose=False)
    assert fsdp["cost_scanned"] == rec["cost_scanned"]
    assert (fsdp["gspmd"]["param_shard_elements_per_rank"]
            < rec["gspmd"]["param_shard_elements_per_rank"])


@pytest.mark.parametrize("arch", ["rfast-100m", "hymba-1.5b"])
def test_meta_flops_equal_a_cpu_run_plus_the_kernels(arch):
    cfg = _reduced(arch)
    mesh = describe_mesh((4, 1), ("data", "model"))
    kw = dict(seq=16, global_batch=8, comm="dense", dtype=torch.float32)
    fn, args = specs.build_train(cfg, mesh, **kw)
    rec = dryrun.measure(fn, args)
    lfn, largs = specs.build_train(cfg, mesh, device="cpu", **kw)
    live = dryrun.run_live(lfn, largs, runs=1)
    assert rec["flops_aten"] == live["flops_aten"] > 0
    assert rec["cost_scanned"]["flops"] == (live["flops_aten"]
                                            + rec["flops_kernels"])
    assert rec["memory"]["argument_size_in_bytes"] == \
        live["argument_size_in_bytes"]
    assert rec["kernels"]["commit_grid"]["launches"] == 1
    plan = build_comm_plan(binary_tree(4))
    assert rec["kernels"]["commit_grid"]["flops"] == grid.commit_grid_flops(
        4, plan.ka, plan.ko, fn.info["p"])
    if arch == "hymba-1.5b":
        # forward, its recompute under remat, and the backward: per layer
        assert rec["kernels"]["ssm_scan"]["launches"] == 2 * 2 * 4
        assert rec["kernels"]["ssm_scan_bwd"]["launches"] == 2 * 4
    assert dispatch.stats()["launches"] == 0


def test_fit_at_full_depth_equals_the_direct_count():
    rec = dryrun.run_case("llama3-8b", "train_4k",
                          cfg=_reduced("llama3-8b", layers=5), verbose=False)
    assert rec["ok"], rec.get("error")
    fit = rec["fit"]
    assert fit["L"] == 5
    assert fit["flops_perdev"] == rec["cost_scanned"]["flops"]
    assert fit["bytes_perdev"] == rec["cost_scanned"]["bytes"]
    coll = rec["collectives_scanned"]
    assert fit["coll_bytes_perdev"] == sum(v["bytes"] for v in coll.values())
    assert fit["coll_ib_bytes_perdev"] == sum(v["ib_bytes"]
                                              for v in coll.values())


def test_ppermute_bytes_are_matchings_times_the_state_row():
    cfg = _reduced("rfast-100m")
    # (4, 8): the data axis crosses hosts; (1, 8): one host of 8 ranks
    for shape, nvlink in [((4, 8), False), ((1, 8), True)]:
        mesh = describe_mesh(shape, ("model", "data") if nvlink else
                             ("data", "model"))
        fn, args = specs.build_train(cfg, mesh, seq=16, global_batch=8,
                                     comm="ppermute")
        rec = dryrun.measure(fn, args)
        perm = rec["collectives_scanned"]["collective-permute"]
        m, p = fn.info["matchings"], fn.info["p"]
        assert perm["count"] == m
        assert perm["bytes"] == m * p * 2          # bf16 rows
        assert perm["nvlink_bytes" if nvlink else "ib_bytes"] == m * p * 2
        gather = rec["collectives_scanned"]["all-gather"]
        if nvlink:      # a model axis of 1: the one gather of n losses
            assert gather == {"count": 1, "bytes": 4 * fn.info["n_nodes"],
                              "nvlink_bytes": 4 * fn.info["n_nodes"],
                              "ib_bytes": 0}
        else:           # beside it, the tensor-parallel model group's
            assert fn.info["model_axis"] == "tensor"
            assert gather["ib_bytes"] == 4 * fn.info["n_nodes"]
            assert gather["nvlink_bytes"] == gather["bytes"] - 4 * fn.info[
                "n_nodes"] > 0


def _refuse(name):
    def f(*a, **k):
        raise AssertionError(f"{name} ran on meta tensors")
    return f


def test_meta_path_runs_no_kernel_no_twin_no_collective(monkeypatch):
    for mod, names in [
            (grid, ["commit_grid_plain", "_library"]),
            (node, ["rfast_commit_node_plain", "rfast_update_node_plain",
                    "_library"]),
            (ffwd, ["flash_fwd_plain", "_library"]),
            (fbwd, ["flash_bwd_plain", "_library"]),
            (sfwd, ["ssm_scan_plain", "_library"]),
            (sbwd, ["ssm_scan_bwd_plain", "_library"])]:
        for n in names:
            monkeypatch.setattr(mod, n, _refuse(f"{mod.__name__}.{n}"))
    import torch.distributed as dist
    for n in ("all_gather_into_tensor", "batch_isend_irecv", "get_rank",
              "get_backend"):
        monkeypatch.setattr(dist, n, _refuse(f"dist.{n}"))
    dispatch.clear()
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    P, ka, ko, kw = 100, 3, 2, 2
    with kmeta.recording() as calls:
        z, ro, rb = grid.commit_grid(
            np.zeros(5, np.int32), np.zeros(5, np.int32),
            np.zeros((5, ka), np.int32), np.zeros((5, ka), np.int32),
            np.zeros((5, ko), np.int32), m(5), m(5, ka), m(5, ko),
            m(8, P), m(5, P), m(8, P), m(9, P), m(9, P), m(9, P))
        assert (z.shape, ro.shape, rb.shape) == ((5, P), (5, ko, P),
                                                 (5, ka, P))
        out = node.rfast_commit_node(m(P), m(P), m(P), m(ka, P), m(ka, P),
                                     m(ka), m(ko, P), m(ko), a_self=0.5)
        assert [o.shape for o in out] == [(P,), (ko, P), (ka, P)]
        out = node.rfast_update_node(m(P), m(P), m(P), m(P), m(kw, P), m(kw),
                                     m(ka, P), m(ka, P), m(ka), m(ko, P),
                                     m(ko), gamma=0.1, w_self=0.5, a_self=0.5)
        assert len(out) == 5 and all(o.shape[-1] == P for o in out)
        for dt in (torch.float32, torch.bfloat16):
            o, lse = ffwd.flash_fwd(m(2, 8, 64, 32, dt=dt),
                                    m(2, 2, 64, 32, dt=dt),
                                    m(2, 2, 64, 32, dt=dt), window=16)
            assert o.shape == (2, 8, 64, 32) and lse.shape == (2, 8, 64)
            dq, dk, dv = fbwd.flash_bwd(
                m(2, 8, 64, 32, dt=dt), m(2, 8, 64, 32, dt=dt),
                m(2, 8, 64, 32, dt=dt), m(2, 8, 64, 32, dt=dt), m(2, 8, 64),
                m(2, 8, 64), scale=0.1)
            assert dq.dtype == torch.float32 and dk.shape == (2, 8, 64, 32)
        u = m(2, 40, 24)
        y, h, ck = sfwd.ssm_scan(u, m(2, 40, 24), m(24, 16), m(2, 40, 16),
                                 m(2, 40, 16), m(24), ckpt_every=8)
        assert (y.shape, h.shape, ck.shape) == ((2, 40, 24), (2, 24, 16),
                                                (2, 5, 24, 16))
        grads = sbwd.ssm_scan_bwd(u, m(2, 40, 24), m(24, 16), m(2, 40, 16),
                                  m(2, 40, 16), m(24), m(2, 40, 24), None,
                                  ck, ckpt_every=8)
        assert [g.shape for g in grads][:3] == [(2, 40, 24), (2, 40, 24),
                                                (24, 16)]
    names = [c["name"] for c in calls]
    assert names == ["commit_grid", "rfast_commit_node", "rfast_update_node",
                     "flash_fwd_3xtf32", "flash_bwd_3xtf32", "flash_fwd_tc",
                     "flash_bwd_tc", "ssm_scan", "ssm_scan_bwd"]
    c = {c["name"]: c for c in calls}
    assert c["commit_grid"] == {"name": "commit_grid",
                                "flops": grid.commit_grid_flops(5, ka, ko, P),
                                "bytes": grid.commit_grid_bytes(5, ka, ko, P,
                                                                4)}
    assert c["rfast_update_node"]["flops"] == P * node.node_flops(
        kw, ka, ko, full=True)
    assert c["flash_fwd_tc"]["flops"] == ffwd.flash_fwd_work(
        2, 8, 2, 64, 64, 32, True, 16, 2)[0]
    assert c["ssm_scan"]["flops"] == sfwd.ssm_scan_ops(2, 40, 24, 16)[0]
    assert c["ssm_scan"]["bytes"] == (sfwd.ssm_scan_bytes(2, 40, 24, 16, 4)
                                      + 4 * 2 * 5 * 24 * 16)
    # the backward's own work at the split an H100 takes (pass A counted)
    segments = sfwd.scan_bwd_segments(2, 40, 24, 16, sbwd.META_SMS)
    assert segments > 1
    assert c["ssm_scan_bwd"]["flops"] == sbwd.ssm_scan_bwd_ops(
        2, 40, 24, 16, segments)[0]
    assert dispatch.stats()["launches"] == 0
    # the collectives over a described mesh: recorded, nothing sent
    mesh = describe_mesh((4, 8), ("data", "model"), rank=9)
    with rs.record_collectives() as colls:
        g = rs.all_gather_flat(m(3, 5), mesh.group("model"))
        r = rs.ppermute(m(1, 7), [(0, 1), (1, 2)], mesh.group("data"))
        e = rs.ppermute(m(1, 7), [], mesh.group("data"))
    assert g.shape == (3, 40) and r.shape == e.shape == (1, 7)
    assert [(c["name"], c["bytes"], c["group_size"], c["intra_host"])
            for c in colls] == [("all_gather_flat", 3 * 40 * 4, 8, True),
                                ("ppermute", 7 * 4, 4, False)]
    with pytest.raises(ValueError, match="described mesh"):
        rs.ppermute(torch.zeros(1, 7), [(0, 1)], mesh.group("data"))


def test_model_and_scan_flops_against_the_reference():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget(arch)
        for shape, info in specs.SHAPES.items():
            assert roofline.model_flops(cfg, shape) == \
                jroof.model_flops(jcfg, shape)
            assert roofline.ssm_correction_flops(cfg, shape, info["kind"]) \
                == jroof.ssm_correction_flops(jcfg, shape, info["kind"])
    # the scan wrappers count (6N+3)·d_inner a token and layer forward
    # where the reference's correction counts 8N·d_inner; per card, on the
    # rank's rows and its d_inner / 8 channels (the model axis
    # tensor-parallel)
    for arch in ("falcon-mamba-7b", "hymba-1.5b"):
        cfg = get_config(arch)
        rec = dryrun.run_case(arch, "prefill_32k", fit=False, verbose=False)
        N, di, L = cfg.ssm_state, cfg.d_inner, cfg.n_layers
        rows = rec["case"]["rows"]
        assert rec["case"]["cache_layout"]["ssm"] == "channels"
        assert rec["kernels"]["ssm_scan"]["launches"] == L
        assert rec["ssm_scan_flops"] == L * sfwd.ssm_scan_ops(
            rows, 32768, di // 8, N)[0]
        ref_global = jroof.ssm_correction_flops(jget(arch), "prefill_32k",
                                                "prefill")
        shards = 32 // rows
        assert rec["ssm_scan_flops"] * shards * 8 * 8 * N == pytest.approx(
            ref_global * (6 * N + 3), rel=1e-12)


def _record(tmp_path, **over):
    rec = {"arch": "llama3-8b", "shape": "train_4k", "mesh": "32x8",
           "chips": 256, "rules": "base", "ok": True,
           "memory": {"argument_size_in_bytes": 40 * 2**30,
                      "output_size_in_bytes": 1,
                      "temp_size_in_bytes": 50 * 2**30,
                      "generated_code_size_in_bytes": 0},
           "cost_scanned": {"flops": 1.0e15, "bytes": 2.0e12},
           "collectives_scanned": {"collective-permute": {
               "count": 4, "bytes": 9e10, "nvlink_bytes": 1e10,
               "ib_bytes": 8e10}},
           "ssm_scan_flops": 7.0}
    rec.update(over)
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(rec))
    return rec, str(path)


def test_roofline_and_hillclimb_terms_at_h100_rates(tmp_path):
    rec, path = _record(tmp_path)
    r = roofline.analyze(path)
    assert r["compute_s"] == 1.0e15 / 989e12
    assert r["memory_s"] == 2.0e12 / 3.35e12
    assert r["collective_s"] == 1e10 / 450e9 + 8e10 / 50e9
    assert r["dominant"] == "collective"
    assert r["ssm_corr_perdev"] == 7.0
    assert r["fits_hbm"] is False                  # 90 GiB > 80 GB
    mf = roofline.model_flops(get_config("llama3-8b"), "train_4k")[0]
    assert r["useful_ratio"] == mf / (1.0e15 * 256)
    assert hillclimb.terms(rec) == (
        f"compute={1.0e15 / HW['peak_flops_bf16']:.3f}s "
        f"memory={2.0e12 / HW['hbm_bw']:.3f}s "
        f"collective={1e10 / HW['ici_bw'] + 8e10 / HW['ib_bw']:.3f}s "
        f"args=40.0GiB temp=50.0GiB")
    fit = {"flops_perdev": 1e15, "bytes_perdev": 1e12,
           "coll_bytes_perdev": 3e9, "coll_nvlink_bytes_perdev": 1e9,
           "coll_ib_bytes_perdev": 2e9}
    rec, path = _record(tmp_path, fit=fit)
    r = roofline.analyze(path)
    assert (r["compute_s"], r["memory_s"], r["collective_s"]) == (
        1e15 / 989e12, 1e12 / 3.35e12, 1e9 / 450e9 + 2e9 / 50e9)
    assert "wgmma" in r["lever"] or "tensor" in r["lever"]
    assert "FAILED" in hillclimb.terms({"ok": False, "error": "x"})
    assert set(hillclimb.VARIANTS) == {"train", "moe", "decode"}
    md = roofline.to_markdown([r])
    assert "| llama3-8b | train_4k | 32x8 |" in md


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


def test_cli_dryrun_then_roofline(tmp_path):
    out = tmp_path / "dr"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "rfast-100m", "--shape", "decode_32k", "--no-fit", "--out",
         str(out)], capture_output=True, text=True, env=_env(), timeout=300,
        cwd=ROOT)
    assert run.returncode == 0, run.stderr
    assert "dry-run: 1 ok, 0 failed, 0 skipped" in run.stdout
    rec = json.loads((out / "rfast-100m__decode_32k__32x8.json").read_text())
    assert rec["ok"] and "fit" not in rec
    md = tmp_path / "roof.md"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--reports",
         str(out), "--out", str(md), "--json-out", str(tmp_path / "r.json")],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=ROOT)
    assert run.returncode == 0, run.stderr
    assert md.read_text().startswith(roofline.HEADER)


def test_multihost_main_runs_its_rank_on_meta(capsys):
    rec = multihost.main(["--arch", "rfast-100m", "--shape", "decode_32k"])
    assert rec["coords"] == {"data": 0, "model": 0}
    assert rec["memory"]["argument_size_in_bytes"] > 0
    out = capsys.readouterr().out
    assert "fleet: 1 processes" in out and "GiB/device args" in out
