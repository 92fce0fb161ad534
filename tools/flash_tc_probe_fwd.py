"""Short card probe of the bf16 tensor-core flash kernel `flash_fwd_tc`.

    python3 tools/flash_tc_probe_fwd.py

Builds the flash forward sources, prints ptxas's report and the count
of tensor-core instructions in the SASS, then holds the bf16 forward
(`kernel.flash_fwd`) against `flash_fwd_plain` at chip_smoke.py's small
cases, D 36 / 44 and the three full widths, o in bf16 and in fp32, and
times it (CUDA events) at llama3-8b and hymba-1.5b beside SDPA.  About
25 s of command time on an H100, against about 100 s for chip_smoke.py:
a quick loop while the kernel changes.  Needs one CUDA card and the
CUDA toolkit.
"""
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.rfast_update import dispatch  # noqa: E402

print(sys.version, torch.__version__, torch.version.cuda, flush=True)
print(subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True).stdout[-200:])
t0 = time.time()
srcs = [fk.TC_SOURCE, fk.KERNEL_SOURCE] + [Path(a) for a in sys.argv[1:]]
try:
    libs = _build.build(srcs)
except Exception as e:
    print("BUILD FAILED", str(e)[-6000:])
    sys.exit(1)
print("build s", time.time() - t0)
for s in srcs:
    print("=== log", s.name)
    print(_build.build_log(s)[-3000:])
    sass = _build.sass(s)
    print(s.name, "HGMMA", sass.count("HGMMA"), "HMMA", sass.count("HMMA"), "UTMALDG", sass.count("UTMALDG"), "SYNCS", sass.count("SYNCS"))

CASES = [
    (1, 4, 4, 128, 128, 32, True, None),
    (2, 8, 2, 256, 256, 64, False, None),
    (1, 5, 1, 192, 192, 128, True, 128),
    (1, 10, 2, 128, 256, 64, True, None),
    (1, 4, 1, 256, 128, 32, True, None),
    (1, 5, 5, 200, 200, 64, True, 5),
    (2, 4, 4, 200, 200, 48, True, 100),
    (1, 8, 2, 1, 1, 64, True, None),
    (1, 2, 1, 64, 296, 100, False, None),
    (3, 3, 3, 8, 72, 16, True, 7),
    (1, 4, 2, 130, 130, 36, True, None),
    (1, 4, 2, 130, 130, 44, False, None),
    (1, 32, 8, 4096, 4096, 128, True, None),
    (1, 25, 5, 4096, 4096, 64, True, 1024),
    (4, 12, 4, 128, 128, 64, True, None),
]
g = torch.Generator(device="cuda").manual_seed(0)
ok = True
for case in CASES:
    B, H, KV, Sq, Sk, D, causal, window = case
    a = lambda *s: torch.randn(*s, generator=g, device="cuda")
    q, k, v = a(B, H, Sq, D).bfloat16(), a(B, KV, Sk, D).bfloat16(), a(B, KV, Sk, D).bfloat16()
    kw = dict(causal=causal, window=window, bq=1, bk=1)
    for od in (None, torch.float32):
        try:
            dispatch.clear()
            o, lse = fk.flash_fwd(q, k, v, out_dtype=od, **kw)
            torch.cuda.synchronize()
            o_w, lse_w = fk.flash_fwd_plain(q, k, v, out_dtype=od, **kw)
            eo = float((o.float() - o_w.float()).abs().max())
            el = float((lse - lse_w).abs().max())
            good = eo <= 2e-2 * (1 + 0) and torch.allclose(lse, lse_w, rtol=2e-5, atol=2e-5) and torch.allclose(o.float(), o_w.float(), rtol=2e-2, atol=2e-2)
            ok &= bool(good)
            print(json.dumps(dict(case=case, out=str(od), err_o=eo, err_lse=el, ok=bool(good), launches=dispatch.stats()["by_kernel"])), flush=True)
        except Exception:
            ok = False
            traceback.print_exc()
            print("FAILED", case, flush=True)
            sys.exit(1)
# fp32 still right
q, k, v = (torch.randn(1, 4, 200, 48, generator=g, device="cuda") for _ in range(3))
o, lse = fk.flash_fwd(q, k, v, window=100, bq=1, bk=1)
o_w, lse_w = fk.flash_fwd_plain(q, k, v, window=100, bq=1, bk=1)
print("fp32", float((o - o_w).abs().max()), float((lse - lse_w).abs().max()))


def cuda_ms(fn, reps=10):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize(); ts.append(a.elapsed_time(b))
    return statistics.median(ts)

import torch.nn.functional as F  # noqa: E402
for (B, H, KV, S, D, window) in [(1, 32, 8, 4096, 128, None), (1, 25, 5, 4096, 64, 1024)]:
    q, k, v = torch.randn(B, H, S, D, device="cuda").bfloat16(), torch.randn(B, KV, S, D, device="cuda").bfloat16(), torch.randn(B, KV, S, D, device="cuda").bfloat16()
    t = cuda_ms(lambda: fk.flash_fwd(q, k, v, window=window))
    t32 = cuda_ms(lambda: fk.flash_fwd(q, k, v, window=window, out_dtype=torch.float32))
    if window is None:
        ts = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))
    else:
        ts = None
    print(json.dumps(dict(S=S, H=H, D=D, window=window, tc_ms=t, tc_f32out_ms=t32, sdpa_ms=ts)), flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout)
print("ALL OK" if ok else "SOME FAILED")
