"""Check and time two builds of the selective scan's kernels on one card.

    python3 tools/scan_ab.py A_DIR [B_DIR] [--splits 2,3,4,6,8] [--sass DIR]

A side is a directory holding ``ssm_scan.cu`` and/or ``ssm_scan_bwd.cu``
and the ``scan_common.cuh`` they include, with the C interface of this
checkout's ``src/repro_torch/kernels/ssm_scan/csrc/``: a variant copied
under the git-ignored ``build/``.  B defaults to the checkout's ``csrc/``.
A side without ``ssm_scan.cu`` runs the checkout's forward and is timed on
its backward alone.  Two older interfaces are launched through their own:
a forward that does not include ``scan_common.cuh`` is the first port's
(one thread per state, no checkpoints, no split), and a backward without
a segment length is the first backward's (one block per channel tile and
batch row walking all of S; no split).  To set those beside the
checkout's:

    mkdir -p build/scan_old build/scan_bwd_old
    git show 8e2e2d5:src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu \\
        > build/scan_old/ssm_scan.cu
    for f in ssm_scan_bwd.cu scan_common.cuh; do
        git show 5e64b83:src/repro_torch/kernels/ssm_scan/csrc/$f \\
            > build/scan_bwd_old/$f; done
    python3 tools/scan_ab.py build/scan_bwd_old --splits 2,3,4,5,6,8

Each side is built (ptxas's registers, spills and shared memory printed;
with ``--sass DIR`` its SASS written to ``DIR/scan_ab_<side>_<source>.sass``)
and held to the plain twins by ``chip_smoke.py``'s ``compare_scan`` and
``compare_scan_bwd`` at its ``SCAN_SMALL`` cases and hymba-1.5b's train
shape, in fp32 (1e-4) and bf16 (3e-2), split where the side splits.  A
variant with a part cut out may be wrong by design, so a failed check only
sets the exit code.  Then, at ``chip_smoke.SCAN_TIMED`` (the train shape
and the hymba-1.5b and falcon-mamba-7b op widths) and
``chip_smoke.TP_SCAN_SHAPES`` (the tensor-parallel ranks' shapes), both
sides are timed in turns A B B A (CUDA-graph medians of 20 launches): the
forward without checkpoints, unsplit, at the split ``scan_segments``
chooses and, at S > 1024, at every split of ``--splits``; the forward with
checkpoints; and the backward unsplit, at the split ``scan_bwd_segments``
chooses and at every split of ``--splits`` that leaves segments of at
least 16 steps; beside ``scan_bound`` and ``scan_bwd_bound``.  One JSON
line per side, check and shape, then the card's name and power limit.
"""
import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssm_scan import backward as sb  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as sk  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def first_port_forward(lib):
    """A launcher of the first port's forward, in the checkout's
    ``ssm_scan`` signature: (y, h_last), unsplit, without checkpoints."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ssm_scan_launch.argtypes = ([i32] + [vp] * 8 + [i64, i64, i64, i32]
                                    + [i64] * 4 + [vp])
    lib.ssm_scan_launch.restype = i32

    def fwd(u, dt, A, B, C, D, ckpt_every=None, segments=1):
        assert segments in (None, 1), "the first port does not split"
        Bsz, S, di = u.shape
        N = A.shape[1]
        y = torch.empty((Bsz, S, di), device="cuda")
        h = torch.empty((Bsz, di, N), device="cuda")
        p = lambda t: ctypes.c_void_p(t.data_ptr())
        err = lib.ssm_scan_launch(
            sk._DTYPE_CODE[u.dtype], p(u), p(dt), p(A), p(B), p(C), p(D),
            p(y), p(h), Bsz, S, di, N, B.stride(0), B.stride(1),
            C.stride(0), C.stride(1),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert err == 0, err
        return y, h
    return fwd


def first_backward(lib):
    """A launcher of the first backward (no segments, no sync
    buffer), in the checkout's ``ssm_scan_bwd`` signature, unsplit."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ssm_scan_bwd_launch.argtypes = (
        [i32] + [vp] * 15 + [i64, i64, i64, i32] + [i64] * 5 + [vp])
    lib.ssm_scan_bwd_launch.restype = i32

    def bwd(u, dt, A, B, C, D, gy, gh, ckpt, *, ckpt_every, segments=1):
        assert segments in (None, 1), "the first backward does not split"
        Bsz, S, di = u.shape
        N = A.shape[1]
        f32 = torch.float32
        du = torch.empty((Bsz, S, di), dtype=f32, device="cuda")
        ddt = torch.empty_like(du)
        dA = torch.zeros((di, N), dtype=f32, device="cuda")
        dB = torch.zeros((Bsz, S, N), dtype=f32, device="cuda")
        dC = torch.zeros_like(dB)
        dD = torch.zeros((di,), dtype=f32, device="cuda")
        p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
        err = lib.ssm_scan_bwd_launch(
            sk._DTYPE_CODE[u.dtype], p(u), p(dt), p(A), p(B), p(C),
            p(D.float().contiguous()), p(gy), p(gh), p(ckpt), p(du), p(ddt),
            p(dA), p(dB), p(dC), p(dD), Bsz, S, di, N, B.stride(0),
            B.stride(1), C.stride(0), C.stride(1), ckpt_every,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert err == 0, err
        return tuple(g.to(t.dtype) for g, t in zip(
            (du, ddt, dA, dB, dC, dD), (u, dt, A, B, C, D)))
    return bwd


class Side:
    """One build: ``fwd`` and ``bwd`` (or None) launch it through the
    checkout's wrappers, pointed at this side's libraries."""

    def __init__(self, tag: str, directory: Path):
        self.tag, self.dir = tag, directory
        fwd_src = directory / "ssm_scan.cu"
        bwd_src = directory / "ssm_scan_bwd.cu"
        self.own_fwd = fwd_src.exists()
        self.sources = ([fwd_src] if self.own_fwd else []) + (
            [bwd_src] if bwd_src.exists() else [])
        self.first_port = (self.own_fwd and "scan_common.cuh"
                           not in fwd_src.read_text())
        self.first_bwd = (bwd_src.exists()
                          and "seg_len" not in bwd_src.read_text())
        _build.build(self.sources)
        if self.first_port:
            self._fwd = first_port_forward(_build.load(fwd_src))
        else:
            self.flib = self._load(sk, fwd_src if self.own_fwd
                                   else sk.KERNEL_SOURCE)
        self.blib = None
        if self.first_bwd:
            self.bwd = first_backward(_build.load(bwd_src))
        elif bwd_src.exists():
            self.blib = self._load(sb, bwd_src)
            self.bwd = self._bwd
        else:
            self.bwd = None

    @property
    def bwd_splits(self) -> bool:
        return self.bwd is not None and not self.first_bwd

    @staticmethod
    def _load(module, source):
        saved = module.KERNEL_SOURCE, module._lib
        module.KERNEL_SOURCE, module._lib = source, None
        try:
            return module._library()
        finally:
            module.KERNEL_SOURCE, module._lib = saved

    def fwd(self, *args, **kw):
        if self.first_port:
            return self._fwd(*args, **kw)
        saved, sk._lib = sk._lib, self.flib
        try:
            return sk.ssm_scan(*args, **kw)
        finally:
            sk._lib = saved

    def _bwd(self, *args, **kw):
        saved, sb._lib = sb._lib, self.blib
        try:
            return sb.ssm_scan_bwd(*args, **kw)
        finally:
            sb._lib = saved


def check_side(side: Side) -> bool:
    ok = True
    for case in cs.SCAN_SMALL + [cs.SCAN_TRAIN[1]]:
        for dtype, tol in ((torch.float32, cs.SCAN_FP32_TOL),
                           (torch.bfloat16, cs.SCAN_BF16_TOL)):
            sargs = cs.scan_inputs(*case, dtype)
            row = {"check": side.tag, "case": case, "dtype": str(dtype),
                   "tol": tol}
            try:
                row["fwd_max_abs_err"] = cs.compare_scan(
                    sargs, tol, f"{side.tag} ssm_scan {case}",
                    segments=(1,) if side.first_port else (1, 3),
                    fwd=side.fwd)
                if side.bwd is not None:
                    row["bwd_max_rel_err"], _ = cs.compare_scan_bwd(
                        sargs, tol, f"{side.tag} ssm_scan_bwd {case}",
                        bwd=side.bwd,
                        segments=(1, 3) if side.bwd_splits else (1,))
                row["ok"] = True
            except RuntimeError as e:
                row.update(ok=False, error=str(e))
                ok = False
            emit(**row)
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a_dir", type=Path)
    ap.add_argument("b_dir", type=Path, nargs="?",
                    default=sk.KERNEL_SOURCE.parent)
    ap.add_argument("--splits", default="",
                    help="comma-separated segment counts to time (the forward "
                         "at S > 1024, the backward where a segment keeps "
                         "16 steps)")
    ap.add_argument("--sass", type=Path, default=None, metavar="DIR")
    opt = ap.parse_args()
    sweep = {int(k) for k in opt.splits.split(",") if k}
    smi = cs.nvidia_smi()
    sides = {tag: Side(tag, d) for tag, d in (("A", opt.a_dir),
                                              ("B", opt.b_dir))}
    for side in sides.values():
        if opt.sass is not None:
            opt.sass.mkdir(parents=True, exist_ok=True)
            for s in side.sources:
                (opt.sass / f"scan_ab_{side.tag}_{s.stem}.sass").write_text(
                    _build.sass(s))
        emit(side=side.tag, dir=str(side.dir), first_port=side.first_port,
             first_bwd=side.first_bwd, own_fwd=side.own_fwd,
             ptxas={s.name: cs.ptxas_entries(s) for s in side.sources})
    ok = all([check_side(side) for side in sides.values()])
    every = sk.CKPT_EVERY
    clock = cs.sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, shape, dt_rank in cs.SCAN_TIMED + cs.TP_SCAN_SHAPES:
        Bsz, S, di, N = shape
        sargs = cs.scan_inputs(*shape, torch.float32, dt_rank=dt_rank, seed=5)
        rule = sk.scan_segments(Bsz, S, di, N, sms)
        splits = sorted({1, rule} | (sweep if S > 1024 else set()))
        brule = sk.scan_bwd_segments(Bsz, S, di, N, sms)
        bsplits = sorted({1, brule} | {
            k for k in sweep if sk.bwd_segment_length(S, k, every) >= 16})
        _, _, ck = sk.ssm_scan(*sargs, ckpt_every=every)
        g = torch.Generator(device="cuda").manual_seed(6)
        gy = torch.randn(Bsz, S, di, generator=g, device="cuda")
        gh = torch.randn(Bsz, di, N, generator=g, device="cuda")
        row = {"shape": name, "rule_segments": rule,
               "bwd_rule_segments": brule}
        for tag in "ABBA":
            side = sides[tag]
            if side.own_fwd:
                for nseg in splits[:1] if side.first_port else splits:
                    row.setdefault(f"{tag}_fwd_seg{nseg}_ms", []).append(
                        cs.graph_ms(lambda: side.fwd(*sargs,
                                                     segments=nseg)))
                if not side.first_port:
                    row.setdefault(f"{tag}_fwd_ckpt_ms", []).append(
                        cs.graph_ms(lambda: side.fwd(*sargs,
                                                     ckpt_every=every)))
            if side.bwd is not None:
                for nseg in bsplits if side.bwd_splits else [1]:
                    row.setdefault(f"{tag}_bwd_seg{nseg}_ms", []).append(
                        cs.graph_ms(lambda: side.bwd(
                            *sargs, gy, gh, ck, ckpt_every=every,
                            segments=nseg)))
        row["fwd_bound_ms"], row["fwd_bound_by"], _ = cs.scan_bound(
            *shape, 4, clock)
        row["bwd_bound_ms"], row["bwd_bound_by"], _ = cs.scan_bwd_bound(
            *shape, 4, sk.n_checkpoints(S, cs.SCAN_BOUND_CKPT_EVERY), clock)
        row["bwd_bound_ms_at_ckpt_every"], _, _ = cs.scan_bwd_bound(
            *shape, 4, sk.n_checkpoints(S, every), clock)
        emit(timing=row, nvidia_smi=smi)
        del sargs, ck, gy, gh
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
