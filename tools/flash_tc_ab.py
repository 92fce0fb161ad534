"""A/B timing of two builds of the bf16 flash forward on one card.

    python3 tools/flash_tc_ab.py A.cu B.cu

Each source exports ``flash_fwd_tc_launch`` with the C interface of
``src/repro_torch/kernels/flash_attention/csrc/flash_fwd_tc.cu`` and sits
beside the headers it includes.  Both are built, held to
``flash_fwd_plain`` at a few odd cases (o within 2e-2, lse within 2e-5),
then timed in turns A, B, B, A (CUDA-event medians of 20 calls each) at
the llama3-8b and hymba-1.5b attention widths.  Prints one JSON line per
check and per timing, and the card's name and power limit.  Needs one
CUDA card and the CUDA toolkit.
"""
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

CASES = [(1, 4, 4, 128, 128, 32, True, None),
         (1, 5, 1, 192, 192, 128, True, 128),
         (1, 10, 2, 128, 256, 64, True, None),
         (2, 4, 4, 200, 200, 48, True, 100),
         (1, 2, 1, 64, 296, 100, False, None),
         (1, 4, 2, 136, 136, 36, True, None)]
WIDTHS = [("llama3-8b", 1, 32, 8, 4096, 128, None),
          ("hymba-1.5b", 1, 25, 5, 4096, 64, 1024)]


def load(source):
    lib = ctypes.CDLL(str(_build.build([source])[source]))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.flash_fwd_tc_launch.argtypes = (
        [i32] + [vp] * 5 + [i32, i32, i32, i64, i64, i32, ctypes.c_float,
                            i32, i64, vp])
    lib.flash_fwd_tc_launch.restype = i32
    return lib


def forward(lib, q, k, v, causal, window):
    """What ``kernel.flash_fwd`` does for bf16 tensors, through ``lib``."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qp, kp, vp = (fk.pad_head_dim(t) for t in (q, k, v))
    Dp = qp.shape[-1]
    o = torch.empty((B, H, Sq, Dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd_tc_launch(
        0, fk.ptr(qp), fk.ptr(kp), fk.ptr(vp), fk.ptr(o), fk.ptr(lse), B, H,
        KV, Sq, Sk, Dp, float(D ** -0.5), int(causal), window or 0,
        fk.stream_of(q))
    fk.launch_status("flash_fwd_tc", err)
    return o[..., :D], lse


def cuda_ms(fn, reps=20):
    for _ in range(3):
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


def main(a_src, b_src):
    libs = {"A": load(Path(a_src).resolve()), "B": load(Path(b_src).resolve())}
    g = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g, device="cuda").bfloat16()
    ok = True
    for case in CASES:
        B, H, KV, Sq, Sk, D, causal, window = case
        q, k, v = rand(B, H, Sq, D), rand(B, KV, Sk, D), rand(B, KV, Sk, D)
        o_w, lse_w = fk.flash_fwd_plain(q, k, v, causal=causal,
                                        window=window, bq=1, bk=1)
        for name, lib in libs.items():
            o, lse = forward(lib, q, k, v, causal, window)
            torch.cuda.synchronize()
            good = (torch.allclose(o.float(), o_w.float(), rtol=2e-2,
                                   atol=2e-2)
                    and torch.allclose(lse, lse_w, rtol=2e-5, atol=2e-5))
            ok &= good
            print(json.dumps(dict(
                check=name, case=case, ok=good,
                o_err=float((o.float() - o_w.float()).abs().max()),
                lse_err=float((lse - lse_w).abs().max()))), flush=True)
    for cfg, B, H, KV, S, D, window in WIDTHS:
        q, k, v = rand(B, H, S, D), rand(B, KV, S, D), rand(B, KV, S, D)
        ms = {"A": [], "B": []}
        for name in "ABBA":
            ms[name].append(cuda_ms(
                lambda: forward(libs[name], q, k, v, True, window)))
        print(json.dumps(dict(config=cfg, ms=ms)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
