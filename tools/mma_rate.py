"""Peak rate of mma.sync on one card: TF32 m16n8k8 and bf16 m16n8k16.

    python3 tools/mma_rate.py

Builds ``tools/mma_rate.cu`` with the port's ``nvcc`` flags, launches
8 blocks of 256 threads per SM, each warp issuing 8 independent
products a round for 4096 rounds, and prints one JSON line per shape:
the CUDA-event median of 5 launches and the dense TFLOP/s it implies
(2 m n k flops a product), beside the card's name and power limit.  The
TF32 rate over three is the ceiling of a 3xTF32 kernel built on
mma.sync, as the fp32 flash kernels are.
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

SOURCE = Path(__file__).resolve().parent / "mma_rate.cu"
THREADS, ITERS = 256, 4096
SHAPES = [("tf32 m16n8k8", 0, 16 * 8 * 8), ("bf16 m16n8k16", 1, 16 * 8 * 16)]


def main():
    lib = ctypes.CDLL(str(_build.build([SOURCE])[SOURCE]))
    lib.mma_rate_launch.argtypes = [ctypes.c_int, ctypes.c_void_p] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mma_rate_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 8 * sms
    out = torch.empty(blocks * THREADS, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for name, kind, mnk in SHAPES:
        run = lambda: lib.mma_rate_launch(kind, ctypes.c_void_p(
            out.data_ptr()), blocks, THREADS, ITERS, stream)
        if run() != 0:
            raise RuntimeError(f"mma_rate launch failed ({name})")
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            run()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times)
        flops = blocks * THREADS // 32 * ITERS * 8 * 2 * mnk
        print(json.dumps(dict(shape=name, ms=ms, tflop_s=flops / ms / 1e9,
                              sms=sms, blocks=blocks, nvidia_smi=smi)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
