"""Process-group bring-up for multi-device runs of the port.

Counterpart of ``src/repro/launch/multihost.py`` on ``torch.distributed``.
Every rank runs the same program; :func:`initialize_distributed` joins it
to the group from the launcher's environment:

* torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``
  / ``MASTER_PORT``, or
* the reference's ``COORDINATOR_ADDRESS`` (``host:port``) /
  ``NUM_PROCESSES`` / ``PROCESS_ID``.

The backend is NCCL with rank r on ``cuda:LOCAL_RANK`` when every rank
has a card of its own.  Ranks that would share a card (or a machine with
no card) need ``backend="gloo"`` from the caller: the backend is never
chosen quietly.  Then each rank runs on ``cuda:LOCAL_RANK % cards`` or on
the CPU, as the caller's ``device`` says.

Mesh-mapped sweep contract (the reference's DESIGN.md §13): every rank
calls :func:`initialize_distributed`, builds the SAME
``launch.mesh.make_sweep_mesh(lanes=D, param_shards=M)`` and calls
``run_sweep`` with identical host inputs (plans and wave tables are host
numpy, cheap and deterministic, so every rank builds them itself rather
than receiving them).  Each rank then holds only its lane group and its
slice of the flat parameter axis.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --scenario uniform --param-shards 4

:func:`spawn_local` is the CPU dev loop: it starts the ranks itself
(``train.py --host-devices N``, the tests).

:func:`main` is the reference's one production step a host: every rank
joins the group, takes its place in the production mesh
(``launch.mesh.make_production_mesh``, described) and runs its share of
the case (``launch.specs.build_case``) once on the meta device, where
the reference compiles it; rank 0 prints the fleet, the argument bytes a
rank and, for a train case, how the ``model`` axis runs (tensor-parallel
for every arch: a rank's flat rows are its blocks of the tree).

    python -m repro_torch.launch.multihost --arch llama3-8b --shape train_4k
"""
from __future__ import annotations

import argparse
import datetime
import multiprocessing as _mp
import os
import queue
import socket
import time
import traceback

import torch

__all__ = ["initialize_distributed", "host_local_batch", "spawn_local",
           "group_timeout", "DEFAULT_TIMEOUT_S", "main"]

DEFAULT_TIMEOUT_S = 300.0
_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def group_timeout() -> datetime.timedelta:
    """The timeout of the process group :func:`initialize_distributed`
    made (subgroups get the same, so a deadlock fails, never hangs)."""
    return _timeout


def _env_int(*names) -> int | None:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def initialize_distributed(backend: str | None = None, *,
                           timeout_s: float | None = None
                           ) -> tuple[int, int]:
    """Join the process group the environment describes; returns
    ``(rank, world)``.

    With neither torchrun's nor the reference's variables set this is a
    no-op that returns ``(0, 1)``, as the reference's is on one host.
    ``backend=None`` is NCCL, one card a rank; it raises when the ranks
    on this host outnumber its cards (pass ``backend="gloo"`` for ranks
    that share a card or run on the CPU).  Without ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE`` (the reference's variables) the ranks are taken
    to share this host.  ``timeout_s`` bounds every collective of the
    group (default 300 s)."""
    import torch.distributed as dist

    global _timeout
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank = _env_int("RANK", "PROCESS_ID")
    world = _env_int("WORLD_SIZE", "NUM_PROCESSES")
    if rank is None or world is None:
        return 0, 1
    if os.environ.get("COORDINATOR_ADDRESS") and not os.environ.get(
            "MASTER_ADDR"):
        host, _, port = os.environ["COORDINATOR_ADDRESS"].rpartition(":")
        os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = host, port
    local = _env_int("LOCAL_RANK")
    local = rank if local is None else local
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    if timeout_s is not None:
        _timeout = datetime.timedelta(seconds=float(timeout_s))
    kw = {}
    if backend is None:
        cards = torch.cuda.device_count()
        if cards < local_world:
            raise RuntimeError(
                f"{local_world} ranks on this host and {cards} CUDA "
                "card(s): NCCL needs one card a rank; pass backend='gloo' "
                "to share a card or run on the CPU")
        backend = "nccl"
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, timeout=_timeout, **kw)
    return rank, world


def host_local_batch(make_local, device=None):
    """``make_local(rank)`` on this rank's device.

    The reference assembles one global array from every host's local
    rows; torch ranks hold only their own, so each rank builds its own
    batch (from the rank, as the reference's ``make_local`` does) and
    nothing is exchanged.  Tensors in the (nested tuple / list / dict)
    result move to ``device`` (``cuda`` unless the caller asks for
    another)."""
    import torch.distributed as dist

    from ..kernels.rfast_update.dispatch import resolve_device
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
    dev = resolve_device(device)

    def put(obj):
        if isinstance(obj, torch.Tensor):
            return obj.to(dev)
        if isinstance(obj, dict):
            return {k: put(v) for k, v in obj.items()}
        if isinstance(obj, (tuple, list)):
            return type(obj)(put(v) for v in obj)
        return obj

    return put(make_local(rank))


def _free_port() -> int:
    """A TCP port of this host that no one listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, rank: int, world: int, port: int, backend: str,
               timeout_s: float, results, done) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)        # ranks of one host share its cores
    import torch.distributed as dist
    try:
        initialize_distributed(backend, timeout_s=timeout_s)
        out = fn(*args)
        results.put((rank, True, out))
        # a CPU tensor of the result goes by file descriptor, which the
        # parent fetches from this process: stay until it has read them
        done.wait()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(fn, world: int, *args, backend: str | None = "gloo",
                timeout_s: float = 60.0, join_s: float = 300.0) -> list:
    """Run ``fn(*args)`` on ``world`` ranks of this host, each a spawned
    process with one intra-op thread, joined to one group (``backend``:
    :func:`initialize_distributed`'s, ``timeout_s`` bounding every
    collective) on a free port.  Returns the ranks' results in rank order.
    Raises when a rank raises (with its traceback) or when the ranks do
    not finish within ``join_s`` seconds; no rank outlives the call.  ``fn`` must be importable by
    name (a module-level function)."""
    ctx = _mp.get_context("spawn")
    results, done = ctx.Queue(), ctx.Event()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, world, port, backend, timeout_s,
                               results, done), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    failed = []
    deadline = time.monotonic() + join_s
    try:
        while len(got) + len(failed) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{join_s} s")
            try:
                rank, ok, out = results.get(timeout=min(1.0, left))
            except queue.Empty:
                # a rank that died without reporting (killed, a crash)
                failed = [(r, f"exit code {p.exitcode}")
                          for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0) and r not in got]
                if failed:
                    break
                continue
            if not ok:
                failed.append((rank, out))
                break
            got[rank] = out
        if failed:
            raise RuntimeError("rank(s) failed:\n" + "\n".join(
                f"--- rank {r} ---\n{msg}" for r, msg in failed))
        done.set()
        for p in procs:
            p.join(min(60.0, max(1.0, deadline - time.monotonic())))
    finally:
        done.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [got[r] for r in range(world)]


def main(argv=None) -> dict:
    """One production step a rank, on meta (see the module docstring):
    returns this rank's record (its mesh coordinates, argument and
    temporary bytes, and counts).  The backend is gloo: the step moves
    no data between ranks, the group only places them."""
    ap = argparse.ArgumentParser(description="one production step a "
                                 "rank of the production mesh, on meta")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=10,
                    help="the reference's; the meta step runs once")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    rank, world = initialize_distributed("gloo")
    from ..configs import get_config
    from .dryrun import measure
    from .mesh import make_production_mesh
    from .specs import build_case

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                rank=rank % len(mesh.ranks))
    if rank == 0:
        print(f"fleet: {world} processes, {torch.cuda.device_count()} "
              f"CUDA devices here; mesh {dict(mesh.shape)} of "
              f"{len(mesh.ranks)} ranks", flush=True)
    fn, step_args = build_case(get_config(args.arch), mesh, args.shape)
    rec = measure(fn, step_args)
    rec["coords"] = mesh.coords
    rec["case"] = fn.info
    if rank == 0:
        mem = rec["memory"]
        print(f"built {args.arch}/{args.shape} on meta: "
              f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB/device args, "
              f"{mem['temp_size_in_bytes'] / 2**30:.2f} GiB/device temp",
              flush=True)
        info = fn.info
        if info["kind"] == "train":
            print(f"model axis {info['model_axis']}: a rank's flat state "
                  f"rows {info['p']:,} of the whole {info['p_whole']:,} "
                  f"elements, {info['state_dtype']}; sequence parallel "
                  f"{info['seq_parallel']}", flush=True)
    # A real run would now draw each rank's state and batch
    # (host_local_batch) and loop its round; launch/train.py is that loop.
    return rec


if __name__ == "__main__":
    main()
