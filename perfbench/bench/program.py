"""The program under test, driven through its own entry points.

Sync cells build the round with ``repro_torch.core.runtime.
make_rfast_round`` (robust, ``impl="kernel"``, donated state) and call it
with the benchmark's batches and masks; async cells run ``repro_torch.
core.simulator.run_rfast`` (wavefront, ``impl="kernel"``) over the
benchmark's schedule.  Either way the gradient is ``repro_torch.core.
paramvec.value_and_grad`` of ``repro_torch.models.transformer.loss_fn``,
inside the benchmark's span ``perfbench.grad``.

Set-up builds the one training object, runs its paper init and its first
(checked) steps through the window's own call and feed, and reads what
the comparison needs from its state; the window then runs whole rounds,
or whole chunks of events, until ``seconds`` have passed.  The program
is only read: the per-leaf norms of its gradients and of its parameters'
change, and the losses it computed.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from reference.rfast import edges

from . import inputs
from .counts import commit_lane_rows

__all__ = ["Observed", "Window", "port_config", "port_layout",
           "leaf_norms", "run_sync", "run_async"]


class Observed:
    """What the comparison reads of one side: every loss, in the order
    computed (the paper init's, then the steps'), and for every node the
    per-leaf norms of its gradient after the first checked step
    (``grad``) and of its parameters' change after the last (``change``),
    ``(nodes, leaves)`` float64 arrays."""

    def __init__(self):
        self.losses: list[float] = []
        self.grad = None
        self.change = None
        self.note = ""


class Window:
    """The measured window: its wall seconds, the units of work it ran
    (rounds or events), the gradients computed, and the program's launch
    counters over it."""

    def __init__(self):
        self.seconds = 0.0
        self.units = 0
        self.grads = 0
        self.commit_launches = 0
        self.commit_rows = 0


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.models.config import ModelConfig
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
            "d_ff", "vocab", "mixer", "norm", "mlp", "tie_embeddings",
            "attn_window", "ssm_state", "ssm_conv", "ssm_expand",
            "rope_theta")
    return ModelConfig(name=cfg["name"],
                       **{k: cfg[k] for k in keys if k in cfg})


def port_layout(cfg: dict, leaves):
    """The program's flat layout (``RavelSpec``) of the model whose
    leaves are ``leaves`` (``(path, shape)`` pairs), made from empty meta
    tensors; a non-parametric norm is the empty dict the program's tree
    holds in its place."""
    from repro_torch.core.paramvec import make_ravel_spec
    tree: dict = {}
    empty = [("final_norm",), ("layers", "ln1"), ("layers", "ln2")] \
        if cfg["norm"] == "nonparam_ln" else []
    for path, shape in [(p, None) for p in empty] + list(leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = {} if shape is None else torch.empty(
            shape, device="meta")
    return make_ravel_spec(tree)


def leaf_norms(rows: torch.Tensor, offsets, sizes) -> np.ndarray:
    """``(rows, leaves)`` norms (fp64) of each row's leaf segments."""
    out = np.zeros((rows.shape[0], len(offsets)))
    for j, (o, n) in enumerate(zip(offsets, sizes)):
        out[:, j] = torch.linalg.vector_norm(
            rows[:, o:o + n], dim=1, dtype=torch.float64).cpu().numpy()
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Grad:
    """The benchmark's gradient of the program's loss: ``(x, (toks,
    labels)) -> (loss, g)`` in the span ``perfbench.grad``, counting its
    calls and keeping the losses while ``keep`` is set."""

    def __init__(self, mcfg, spec):
        from repro_torch.core.paramvec import value_and_grad
        from repro_torch.models import transformer

        def loss(params, batch, _key):
            return transformer.loss_fn(mcfg, params, *batch)

        self.vg = value_and_grad(spec, loss)
        self.calls = 0
        self.keep = True
        self.losses: list[torch.Tensor] = []

    def __call__(self, x, batch, key=None):
        with record_function("perfbench.grad"):
            loss, g = self.vg(x, batch, key)
        self.calls += 1
        if self.keep:
            self.losses.append(loss)
        return loss, g


def _launches() -> int:
    from repro_torch.kernels.rfast_update import dispatch
    return dispatch.launches("commit_grid")


def run_sync(mcfg, spec, net, traffic, x0, seed, seconds, *, cdf, device,
             offsets, sizes, on_window):
    """A sync cell: returns ``(Observed, Window)``.  ``on_window(start)``
    is called with True as the window opens and False as it closes (the
    profiler's hooks)."""
    from repro_torch.core.runtime import init_node_state, make_rfast_round
    from repro_torch.core.plan import build_comm_plan
    from repro_torch.core.topology import Topology

    n, B, S = traffic["nodes"], traffic["batch"], traffic["seq"]
    W, A = net
    plan = build_comm_plan(Topology("benchmark_tree", n, W, A))
    n_edges = max(plan.n_edges_w, plan.n_edges_a)
    grad = _Grad(mcfg, spec)

    def feed(step):
        toks, labels = zip(*(inputs.token_batch(seed, step, i, B, S, cdf)
                             for i in range(n)))
        m = inputs.round_masks(seed, step, n_edges, plan.e_pad,
                               traffic["loss_prob"])
        return (torch.stack(toks), torch.stack(labels)), m

    obs = Observed()
    round_fn = make_rfast_round(plan, grad, gamma=traffic["gamma"],
                                robust=True, impl="kernel", donate=True)
    state = init_node_state(plan, x0, grad, feed(0)[0], robust=True)
    checked = traffic["checked_steps"]
    for step in range(1, checked + 1):
        batches, m = feed(step)
        state, _ = round_fn(state, batches, None, torch.from_numpy(m).to(
            device))
        if step == 1:
            obs.grad = leaf_norms(state.g_prev, offsets, sizes)
    obs.change = leaf_norms(state.x - x0, offsets, sizes)
    obs.losses = [float(v) for v in grad.losses]
    grad.keep = False
    grad.losses.clear()

    win = Window()
    in_a = plan.in_a_val.sum(1).astype(int)
    out_a = plan.out_a_val.sum(1).astype(int)
    _sync(device)
    on_window(True)
    calls0, launches0 = grad.calls, _launches()
    t0 = t_prev = time.perf_counter()
    step = checked
    while t_prev - t0 < seconds:
        step += 1
        batches, m = feed(step)
        state, _ = round_fn(state, batches, None, torch.from_numpy(m).to(
            device))
        _sync(device)
        t_prev = time.perf_counter()
        win.units += 1
        delivered = [int(sum(m[e] for e in plan.in_a_epos[i, :in_a[i]]))
                     for i in range(n)]
        win.commit_rows += sum(commit_lane_rows(in_a[i], delivered[i],
                                                out_a[i]) for i in range(n))
    on_window(False)
    win.seconds = t_prev - t0
    win.grads = grad.calls - calls0
    win.commit_launches = _launches() - launches0
    del state, round_fn
    return obs, win


class _WindowClosed(Exception):
    """Raised by the chunk hook to end the async run at a chunk's end."""


def run_async(mcfg, spec, net, traffic, x0, seed, seconds, *, cdf, device,
              offsets, sizes, schedule, on_window):
    """An async cell over ``schedule`` (:class:`inputs.Schedule`):
    returns ``(Observed, Window)``.  The first chunk of
    ``traffic["chunk_events"]`` events is set-up and the checked steps;
    the window is every later whole chunk until ``seconds`` have
    passed."""
    from repro_torch.core.schedule import Schedule
    from repro_torch.core.simulator import run_rfast
    from repro_torch.core.topology import Topology

    n, B, S = traffic["nodes"], traffic["batch"], traffic["seq"]
    W, A = net
    E = traffic["chunk_events"]
    grad = _Grad(mcfg, spec)
    agent = schedule.agent

    def grad_fn(i, x, _gen):
        k = grad.calls - n          # the paper init's n calls come first
        if k >= 0 and int(agent[k]) != i:
            raise RuntimeError(f"gradient call {k} is node {i}, but the "
                               f"schedule runs node {int(agent[k])}")
        # the init's batches are step 0's, event k's step k + 1's
        toks, labels = inputs.token_batch(seed, max(k, -1) + 1, i, B, S,
                                          cdf)
        return grad(x, (toks, labels))[1]

    obs, win = Observed(), Window()
    ea = edges(A)
    # an event reads every in-edge's running sum: all are delivered
    rows = [commit_lane_rows(sum(d == a for _, d in ea),
                             sum(d == a for _, d in ea),
                             sum(s == a for s, _ in ea)) for a in range(n)]
    clock = {}

    def chunk_cb(state, k):
        if k == E:
            obs.grad = leaf_norms(state.g_prev, offsets, sizes)
            obs.change = leaf_norms(state.x - x0, offsets, sizes)
            obs.losses = [float(v) for v in grad.losses]
            grad.keep = False
            grad.losses.clear()
            _sync(device)
            on_window(True)
            clock.update(t0=time.perf_counter(), k0=k, calls=grad.calls,
                         launches=_launches())
            return
        _sync(device)
        t = time.perf_counter()
        clock["t"], clock["k"] = t, k
        if t - clock["t0"] >= seconds:
            raise _WindowClosed

    sched = Schedule(agent=schedule.agent, stamp_v=schedule.stamp_v,
                     stamp_rho=schedule.stamp_rho, times=schedule.times,
                     D=schedule.D, T=schedule.activation_gap(n))
    try:
        run_rfast(Topology("benchmark_tree", n, W, A), sched, grad_fn, x0,
                  traffic["gamma"], eval_every=E, chunk_cb=chunk_cb,
                  mode="wavefront", impl="kernel", device=device)
    except _WindowClosed:
        pass
    on_window(False)
    if "t" not in clock:
        raise RuntimeError("the schedule ended before the window's first "
                           "chunk: give the traffic more events")
    win.seconds = clock["t"] - clock["t0"]
    win.units = clock["k"] - clock["k0"]
    win.grads = grad.calls - clock["calls"]
    win.commit_launches = _launches() - clock["launches"]
    win.commit_rows = sum(rows[int(a)] for a in agent[clock["k0"]:clock["k"]])
    return obs, win
