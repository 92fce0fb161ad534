"""Short card probe of the fused bf16 flash backward `flash_bwd_tc`.

    python3 tools/flash_tc_probe_bwd.py [skip]

Builds the flash sources, prints ptxas's report and the count of
tensor-core instructions in the SASS, then holds the bf16 backward
(`backward.flash_bwd`) against `flash_bwd_plain` at chip_smoke.py's
small cases, D 36 / 44 and the three full widths (``skip`` leaves them
out), checks the fp32 route and the autograd launches, and times it
(CUDA events) at llama3-8b and hymba-1.5b beside SDPA's backward.
About 25 s of command time on an H100: a quick loop while the kernel
changes.  Needs one CUDA card and the CUDA toolkit.
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
import torch.nn.functional as F  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import backward as fb  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.rfast_update import dispatch  # noqa: E402

t0 = time.time()
srcs = [fb.TC_SOURCE, fb.KERNEL_SOURCE, fk.TC_SOURCE, fk.KERNEL_SOURCE]
try:
    libs = _build.build(srcs)
except Exception as e:
    print("BUILD FAILED", str(e)[-8000:]); sys.exit(1)
print("build s", time.time() - t0)
for s in srcs[:2]:
    print("=== log", s.name)
    print(_build.build_log(s)[-2500:])
    sass = _build.sass(s)
    print(s.name, "HGMMA", sass.count("HGMMA"), "HMMA", sass.count("HMMA"), "LDSM", sass.count("LDSM"), "RED", sass.count("RED"), "ATOM", sass.count("ATOM"), flush=True)

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
for case in (CASES if 'skip' not in sys.argv else []):
    B, H, KV, Sq, Sk, D, causal, window = case
    a = lambda *s: torch.randn(*s, generator=g, device="cuda")
    q, k, v = a(B, H, Sq, D).bfloat16(), a(B, H, Sk, D).bfloat16(), a(B, H, Sk, D).bfloat16()
    do = a(B, H, Sq, D).bfloat16()
    kw = dict(causal=causal, window=window, bq=1, bk=1)
    o, lse = fk.flash_fwd_plain(q, k, v, out_dtype=torch.float32, **kw)
    delta = (do.float() * o).sum(-1)
    try:
        dispatch.clear()
        got = fb.flash_bwd(q, k, v, do, lse, delta, scale=D ** -0.5, **kw)
        torch.cuda.synchronize()
        want = fb.flash_bwd_plain(q, k, v, do, lse, delta, scale=D ** -0.5, **kw)
        errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
        good = all(torch.allclose(x, y, rtol=2e-2, atol=2e-2) for x, y in zip(got, want)) and all(bool(torch.isfinite(x).all()) for x in got)
        ok &= good
        print(json.dumps(dict(case=case, err=errs, ok=good, launches=dispatch.stats()["by_kernel"])), flush=True)
        del got, want
    except Exception:
        traceback.print_exc(); print("FAILED", case); sys.exit(1)
    torch.cuda.empty_cache()
# fp32 regression through flash_bwd
q, k, v, do = (torch.randn(1, 4, 200, 48, generator=g, device="cuda") for _ in range(4))
o, lse = fk.flash_fwd_plain(q, k, v, window=100, bq=1, bk=1)
delta = (do * o).sum(-1)
dispatch.clear()
got = fb.flash_bwd(q, k, v, do, lse, delta, scale=48 ** -0.5, window=100, bq=1, bk=1)
want = fb.flash_bwd_plain(q, k, v, do, lse, delta, scale=48 ** -0.5, window=100, bq=1, bk=1)
print("fp32", [float((x - y).abs().max()) for x, y in zip(got, want)], dispatch.stats()["by_kernel"])
# autograd bf16
B, H, KV, S, D = 2, 8, 2, 192, 64
leaves = [torch.randn(B, h, S, D, generator=g, device="cuda").bfloat16().requires_grad_() for h in (H, KV, KV)]
dispatch.clear()
out = fb.flash_attention_vjp(leaves[0], leaves[1].repeat_interleave(4, 1), leaves[2].repeat_interleave(4, 1), True, 64, None, 64, 64)
out.float().sum().backward()
print("autograd launches", dispatch.stats()["by_kernel"])

def cuda_ms(fn, reps=10):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize(); ts.append(a.elapsed_time(b))
    return statistics.median(ts)

for (B, H, KV, S, D, window) in [(1, 32, 8, 4096, 128, None), (1, 25, 5, 4096, 64, 1024)]:
    q = torch.randn(B, H, S, D, device="cuda").bfloat16()
    k, v = (torch.randn(B, KV, S, D, device="cuda").bfloat16() for _ in range(2))
    do = torch.randn(B, H, S, D, device="cuda").bfloat16()
    o, lse = fk.flash_fwd(q, k, v, window=window, out_dtype=torch.float32)
    delta = (do.float() * o).sum(-1)
    kr, vr = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
    t = cuda_ms(lambda: fb.flash_bwd(q, kr, vr, do, lse, delta, scale=D ** -0.5, window=window))
    res = dict(S=S, H=H, D=D, window=window, bwd_tc_ms=t)
    if window is None:
        lv = [x.detach().requires_grad_() for x in (q, k, v)]
        ol = F.scaled_dot_product_attention(*lv, is_causal=True, enable_gqa=True)
        res["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(ol, lv, do, retain_graph=True))
    print(json.dumps(res), flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout)
print("ALL OK" if ok else "SOME FAILED")
