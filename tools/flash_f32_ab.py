"""A/B timing of two builds of the fp32 flash kernels on one card.

    python3 tools/flash_f32_ab.py A_DIR [B_DIR]

A side is a directory of CUDA sources: either ``flash_fwd_3xtf32.cu``
and ``flash_bwd_3xtf32.cu`` (the C interface of this checkout's
``src/repro_torch/kernels/flash_attention/csrc/``, the default B), or
the CUDA-core kernels that they replaced, ``flash_fwd.cu`` (exporting
``flash_fwd_launch``) and ``flash_bwd.cu`` (``flash_dq_launch``,
``flash_dkv_launch``), each beside the ``flash_common.cuh`` it includes.
The old kernels come from git into the git-ignored ``build/``:

    mkdir -p build/f32_old
    for f in flash_fwd.cu flash_bwd.cu flash_common.cuh; do
        git show 8052989:src/repro_torch/kernels/flash_attention/csrc/$f \
            > build/f32_old/$f
    done
    python3 tools/flash_f32_ab.py build/f32_old

(8052989 is the last commit with the CUDA-core kernels.)  Both sides are
built, held to the plain twins at small odd cases and at every width (o
and lse within 2e-5, dq, dk, dv within 2e-4 as max abs errors:
tests/test_kernels.py's fp32 tolerances), then timed in turns A, B, B, A
(CUDA-event medians of 10 calls each; the backward as a caller pays it:
the old side's two launches, the new side's zeroed dq and one launch) at
the llama3-8b, hymba-1.5b and rfast-100m attention widths.  Prints each
new side's ptxas report and SASS tensor-core count, one JSON line per
check and per timing, and the card's name and power limit.  Needs one
CUDA card and the CUDA toolkit; times both sides even when a check
fails (a side with a part cut out, to see what that part costs), and
then exits 1.
"""
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import backward as fb  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

# (B, H, KV, Sq, Sk, D, causal, window)
CASES = [(1, 4, 4, 128, 128, 32, True, None),
         (2, 8, 2, 256, 256, 64, False, None),
         (1, 5, 1, 192, 192, 128, True, 128),
         (1, 10, 2, 128, 256, 64, True, None),
         (1, 4, 1, 256, 128, 32, True, None),
         (1, 5, 5, 200, 200, 64, True, 5),
         (2, 4, 4, 200, 200, 48, True, 100),
         (1, 3, 1, 100, 100, 36, True, 50),
         (1, 3, 1, 104, 104, 35, True, 50)]
WIDTHS = [("llama3-8b", 1, 32, 8, 4096, 128, None),
          ("hymba-1.5b", 1, 25, 5, 4096, 64, 1024),
          ("rfast-100m", 4, 12, 4, 128, 64, None)]
FWD_TOL, GRAD_TOL = 2e-5, 2e-4


def load_side(src_dir):
    """(forward, backward) callables of the kernels in ``src_dir``, and
    the sources built."""
    d = Path(src_dir).resolve()
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    tail = [i32, i32, i64, i64, i32, ctypes.c_float, i32, i64, vp]
    new = (d / "flash_fwd_3xtf32.cu").exists()
    srcs = [d / n for n in (("flash_fwd_3xtf32.cu", "flash_bwd_3xtf32.cu")
                            if new else ("flash_fwd.cu", "flash_bwd.cu"))]
    libs = _build.build(srcs)
    lf, lb = (ctypes.CDLL(str(libs[s])) for s in srcs)
    if new:
        lf.flash_fwd_3xtf32_launch.argtypes = [vp] * 5 + [i32] + tail
        lb.flash_bwd_3xtf32_launch.argtypes = [vp] * 9 + tail
        fns = (lf.flash_fwd_3xtf32_launch, lb.flash_bwd_3xtf32_launch)
    else:
        lf.flash_fwd_launch.argtypes = [vp] * 5 + [i32] + tail
        lb.flash_dq_launch.argtypes = [vp] * 7 + tail
        lb.flash_dkv_launch.argtypes = [vp] * 8 + tail
        fns = (lf.flash_fwd_launch, lb.flash_dq_launch, lb.flash_dkv_launch)
    for fn in fns:
        fn.restype = i32
    if new:
        return ((lambda *a: new_fwd(fns[0], *a)),
                (lambda *a: new_bwd(fns[1], *a))), srcs
    return ((lambda *a: old_fwd(fns[0], *a)),
            (lambda *a: old_bwd(fns[1], fns[2], *a))), None


def old_fwd(fn, q, k, v, causal, window):
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fk.launch_status("flash_fwd", fn(
        fk.ptr(q), fk.ptr(k), fk.ptr(v), fk.ptr(o), fk.ptr(lse), B, H, KV,
        Sq, Sk, D, D ** -0.5, int(causal), window or 0, fk.stream_of(q)))
    return o, lse


def old_bwd(fn_dq, fn_dkv, q, k, v, do, lse, delta, causal, window):
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    tail = (B, H, Sq, Sk, D, D ** -0.5, int(causal), window or 0,
            fk.stream_of(q))
    ins = [fk.ptr(t) for t in (q, k, v, do, lse, delta)]
    fk.launch_status("flash_dq", fn_dq(*ins, fk.ptr(dq), *tail))
    fk.launch_status("flash_dkv", fn_dkv(*ins, fk.ptr(dk), fk.ptr(dv),
                                         *tail))
    return dq, dk, dv


def new_fwd(fn, q, k, v, causal, window):
    """What ``kernel.flash_fwd`` does for fp32 tensors, through ``fn``."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    q, k, v = (fk.pad_head_dim(t) for t in (q, k, v))
    Dp = q.shape[-1]
    o = torch.empty((B, H, Sq, Dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fk.launch_status("flash_fwd_3xtf32", fn(
        fk.ptr(q), fk.ptr(k), fk.ptr(v), fk.ptr(o), fk.ptr(lse), B, H, KV,
        Sq, Sk, Dp, D ** -0.5, int(causal), window or 0, fk.stream_of(q)))
    return o[..., :D], lse


def new_bwd(fn, q, k, v, do, lse, delta, causal, window):
    """What ``backward.flash_bwd`` does for fp32 tensors, through ``fn``."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    q, k, v, do = (fk.pad_head_dim(t) for t in (q, k, v, do))
    Dp = q.shape[-1]
    dq = torch.zeros((B, H, Sq, Dp), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, H, Sk, Dp), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    fk.launch_status("flash_bwd_3xtf32", fn(
        *(fk.ptr(t) for t in (q, k, v, do, lse, delta, dq, dk, dv)), B, H,
        Sq, Sk, Dp, D ** -0.5, int(causal), window or 0, fk.stream_of(q)))
    return dq[..., :D], dk[..., :D], dv[..., :D]


def cuda_ms(fn, reps=10):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def err(got, want):
    return float((got - want).abs().max())


def check(sides, B, H, KV, Sq, Sk, D, causal, window, seed):
    """Every side against the plain twins on one case: the errors."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda")
    q, k, v, do = rand(B, H, Sq, D), rand(B, KV, Sk, D), rand(B, KV, Sk, D), \
        rand(B, H, Sq, D)
    kw = dict(causal=causal, window=window, bq=1, bk=1)
    o_w, lse_w = fk.flash_fwd_plain(q, k, v, **kw)
    kr, vr = (t.repeat_interleave(H // KV, 1) for t in (k, v))
    delta = (do * o_w).sum(-1)
    want = fb.flash_bwd_plain(q, kr, vr, do, lse_w, delta, scale=D ** -0.5,
                              **kw)
    out = {}
    for name, (fwd, bwd) in sides.items():
        o, lse = fwd(q, k, v, causal, window)
        grads = bwd(q, kr, vr, do, lse_w, delta, causal, window)
        torch.cuda.synchronize()
        e = {"o": err(o, o_w), "lse": err(lse, lse_w),
             **{n: err(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads,
                                                want)}}
        e["ok"] = (e["o"] <= FWD_TOL and e["lse"] <= FWD_TOL
                   and max(e["dq"], e["dk"], e["dv"]) <= GRAD_TOL)
        out[name] = e
    return out


def main(a_dir, b_dir=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    b_dir = b_dir or fk.KERNEL_SOURCE.parent
    sides = {}
    for name, d in (("A", a_dir), ("B", b_dir)):
        sides[name], srcs = load_side(d)
        for src in srcs or ():
            print(json.dumps(dict(
                side=name, source=str(src),
                ptxas=[ln.strip() for ln in
                       _build.build_log(src).splitlines()
                       if re.search(r"registers|spill|Compiling", ln)],
                hmma=_build.sass(src).count("HMMA"))), flush=True)
    ok = True
    for case in CASES:
        res = check(sides, *case, seed=0)
        ok &= all(r["ok"] for r in res.values())
        print(json.dumps(dict(check=case, **res)), flush=True)
    for cfg, B, H, KV, S, D, window in WIDTHS:
        res = check(sides, B, H, KV, S, S, D, True, window, seed=1)
        ok &= all(r["ok"] for r in res.values())
        print(json.dumps(dict(check=cfg, **res)), flush=True)
        torch.cuda.empty_cache()
    for cfg, B, H, KV, S, D, window in WIDTHS:
        g = torch.Generator(device="cuda").manual_seed(2)
        rand = lambda *s: torch.randn(*s, generator=g, device="cuda")
        q, k, v, do = rand(B, H, S, D), rand(B, KV, S, D), \
            rand(B, KV, S, D), rand(B, H, S, D)
        kr, vr = (t.repeat_interleave(H // KV, 1) for t in (k, v))
        o, lse = sides["B"][0](q, k, v, True, window)
        delta = (do * o).sum(-1)
        ms = {"fwd": {"A": [], "B": []}, "bwd": {"A": [], "B": []}}
        for name in "ABBA":
            fwd, bwd = sides[name]
            ms["fwd"][name].append(cuda_ms(
                lambda: fwd(q, k, v, True, window)))
            ms["bwd"][name].append(cuda_ms(
                lambda: bwd(q, kr, vr, do, lse, delta, True, window)))
        print(json.dumps(dict(config=cfg, ms=ms)), flush=True)
        del q, k, v, do, kr, vr, o, lse, delta
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
