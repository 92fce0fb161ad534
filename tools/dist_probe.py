"""Which torch.distributed ops carry CUDA tensors on this machine.

    python3 tools/dist_probe.py

Starts, one op at a time, two gloo ranks that share cuda:0 (and one
world-1 NCCL rank) and runs on CUDA tensors: ``all_gather_into_tensor``,
``all_gather`` into a list, ``batch_isend_irecv`` and ``send`` /
``recv``, ``all_reduce`` with SUM and MAX and ``reduce_scatter_tensor``
(the tensor-parallel collectives; four ranks too, each rank's result
hashed to show whether every rank holds the same bits) and
``all_to_all_single`` with uneven splits (rank r's two chunks to ranks
2r and 2r + 1 mod the world, as a rank's in_proj block of the Mamba
block would move to its channels); then times a gather of 62,334,336
floats a rank (half of rfast-100m's flat vector) directly and through
pinned host buffers, and, at hymba-1.5b's in_proj block on 2 ranks (4
× 128 × 3200 floats a rank), the gather the port runs against an
``all_to_all_single``, 3 times each.  Prints one JSON line a probe (an
op that fails records its error: finding that out is the point) after
the torch version, whether ``all_gather_single`` exists, and the card's
name and power limit.  What it finds is what
``core/runtime_sharded.STAGED`` encodes.

    python3 tools/dist_probe.py all_to_all_single a2a_timing

runs only the probes named (on 2 ranks, and on 4 those of ``OPS4``).
"""
import datetime
import hashlib
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_gather_into_tensor", "all_gather_list", "batch_isend_irecv",
       "send_recv", "all_reduce_sum", "all_reduce_max",
       "reduce_scatter_tensor", "all_to_all_single")
# the ops also probed on four ranks sharing the card
OPS4 = ("all_gather_into_tensor", "all_reduce_sum", "all_reduce_max",
        "reduce_scatter_tensor", "all_to_all_single")
BIG = 62_334_336
XZ_BLOCK = 4 * 128 * 3200         # hymba-1.5b's in_proj block at M = 2


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def probe(rank, world, port, backend, op, q):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=30),
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    out = {"rank": rank}
    try:
        t = torch.full((4, 1000), float(rank + 1), device=dev)
        want = [float(i + 1) for i in range(world)]
        if op == "all_gather_into_tensor":
            o = torch.empty((world * 4, 1000), device=dev)
            dist.all_gather_into_tensor(o, t)
            out["ok"] = o[::4, 0].tolist() == want
        elif op == "all_gather_list":
            os_ = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(os_, t)
            out["ok"] = [float(x[0, 0]) for x in os_] == want
        elif op == "batch_isend_irecv":
            r = torch.zeros_like(t)
            for w in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, t, (rank + 1) % world),
                     dist.P2POp(dist.irecv, r, (rank - 1) % world)]):
                w.wait()
            out["ok"] = float(r[0, 0]) == want[(rank - 1) % world]
        elif op == "send_recv":
            r = torch.zeros_like(t)
            if rank == 0:
                dist.send(t, 1)
                dist.recv(r, 1)
            else:
                dist.recv(r, 0)
                dist.send(t, 0)
            out["ok"] = float(r[0, 0]) == want[1 - rank]
        elif op in ("all_reduce_sum", "all_reduce_max"):
            g = torch.Generator().manual_seed(rank)
            x = torch.randn(4, 1000, generator=g).to(dev)
            xs = [torch.randn(4, 1000, generator=torch.Generator()
                              .manual_seed(r)) for r in range(world)]
            red = dist.ReduceOp.SUM if op.endswith("sum") else \
                dist.ReduceOp.MAX
            dist.all_reduce(x, op=red)
            ref = (torch.stack(xs).sum(0) if op.endswith("sum")
                   else torch.stack(xs).amax(0))
            out["ok"] = bool(torch.allclose(x.cpu(), ref, atol=1e-5))
            out["sha1"] = hashlib.sha1(x.cpu().numpy().tobytes()).hexdigest()
        elif op == "reduce_scatter_tensor":
            x = torch.full((world * 4, 1000), float(rank + 1), device=dev)
            o = torch.empty((4, 1000), device=dev)
            dist.reduce_scatter_tensor(o, x)
            out["ok"] = float(o[0, 0]) == sum(want)
        elif op == "all_to_all_single":
            dests = {(2 * rank) % world, (2 * rank + 1) % world}
            send = [int(q in dests) for q in range(world)]
            recv = [int(rank in {(2 * r) % world, (2 * r + 1) % world})
                    for r in range(world)]
            x = torch.tensor([[float(rank * world + q)] * 1000
                              for q in range(world) if send[q]], device=dev)
            o = torch.empty((sum(recv), 1000), device=dev)
            dist.all_to_all_single(o, x, output_split_sizes=recv,
                                   input_split_sizes=send)
            out["ok"] = o[:, 0].tolist() == [float(r * world + rank)
                                             for r in range(world) if recv[r]]
        elif op == "a2a_timing":
            x = torch.full((XZ_BLOCK,), float(rank), device=dev)
            o = torch.empty((world * XZ_BLOCK,), device=dev)
            o2 = torch.empty((XZ_BLOCK,), device=dev)
            for tag, fn in (("gather_s", lambda: dist.all_gather_into_tensor(
                    o, x)), ("all_to_all_s", lambda: dist.all_to_all_single(
                        o2, x))):
                out[tag] = []
                for _ in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    out[tag].append(time.perf_counter() - t0)
            out["bytes_received"] = {"gather": (world - 1) * XZ_BLOCK * 4,
                                     "all_to_all": (world - 1) * XZ_BLOCK
                                     * 4 // world}
            out["ok"] = True
        elif op == "gather_timing":
            x = torch.full((BIG,), float(rank), device=dev)
            o = torch.empty((world * BIG,), device=dev)
            hx = torch.empty((BIG,), pin_memory=True)
            ho = torch.empty((world * BIG,), pin_memory=True)
            for tag, run in (("direct_s", lambda: dist.all_gather_into_tensor(
                    o, x)), ("staged_s", lambda: (
                        hx.copy_(x), dist.all_gather_into_tensor(ho, hx),
                        o.copy_(ho)))):
                out[tag] = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    out[tag].append(time.perf_counter() - t0)
            out["ok"] = True
        torch.cuda.synchronize()
        dist.barrier()
    except Exception as e:  # noqa: BLE001 - an op that fails is the finding
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {str(e)[:200]}"
    q.put(out)
    dist.destroy_process_group()


def run(world, backend, op):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    ps = [ctx.Process(target=probe, args=(r, world, port, backend, op, q))
          for r in range(world)]
    for p in ps:
        p.start()
    got = []
    for _ in ps:
        try:
            got.append(q.get(timeout=120))
        except Exception:  # noqa: BLE001 - a rank that hangs or dies
            break
    for p in ps:
        p.join(10)
        if p.is_alive():
            p.kill()
    print(json.dumps({"world": world, "backend": backend, "op": op,
                      "results": sorted(got, key=lambda r: r["rank"])}),
          flush=True)


if __name__ == "__main__":
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "all_gather_single": hasattr(dist, "all_gather_single"),
                      "nvidia_smi": smi}), flush=True)
    only = set(sys.argv[1:])
    if not only:
        run(1, "nccl", "all_gather_into_tensor")
    for op in OPS + ("gather_timing", "a2a_timing"):
        if not only or op in only:
            run(2, "gloo", op)
    for op in OPS4:
        if not only or op in only:
            run(4, "gloo", op)
