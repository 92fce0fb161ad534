"""The engines' profiler spans (``repro_torch.spans``): absent without a
profiler session, nested as documented inside one, and without effect on
what the engines compute."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core.paramvec import make_ravel_spec, value_and_grad
from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                      make_rfast_round)
from repro_torch.core.scenario import get_scenario
from repro_torch.core.simulator import run_rfast
from repro_torch.core.topology import binary_tree

N, P = 4, 6
FIELDS = ("x", "z", "g_prev", "rho", "rho_buf", "mail_v")


def quad(n=N, p=P, seed=0):
    """f_i = ½ s_i |w − c_i|² through ``value_and_grad`` (so each
    gradient has its forward and backward), and node i's (c, s)."""
    rng = np.random.default_rng(seed)
    C = torch.from_numpy(rng.normal(0, 1, (n, p)).astype(np.float32))
    S = torch.from_numpy(rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32))
    vg = value_and_grad(make_ravel_spec({"w": torch.zeros(p)}),
                        lambda prm, b, _k: 0.5 * torch.sum(
                            b[1] * (prm["w"] - b[0]) ** 2))
    return vg, (C, S)


def sync_setup(rounds=2, impl="kernel"):
    """A 4-node tree's robust round (backend ``impl``), its paper-init
    state, the batches and ``rounds`` packet-loss masks."""
    vg, batches = quad()
    plan = edge_arrays(binary_tree(N))
    state = init_node_state(plan, torch.zeros(P), vg, batches, robust=True)
    round_fn = make_rfast_round(plan, vg, gamma=0.05, robust=True,
                                impl=impl, donate=True)
    rng = np.random.default_rng(1)
    masks = [torch.from_numpy((rng.uniform(size=plan.e_pad) > 0.3)
                              .astype(np.float32)) for _ in range(rounds)]
    return round_fn, state, batches, masks


def run_rounds(round_fn, state, batches, masks):
    """The rounds; returns the state and every round's losses."""
    losses = []
    for m in masks:
        state, metrics = round_fn(state, batches, None, m)
        losses.append(metrics["losses"])
    return state, torch.stack(losses)


def sync_round():
    return run_rounds(*sync_setup())


def wavefront(K=24):
    """A wavefront run of K events (kernel backend, one chunk); returns
    the state and the chunk's wave count."""
    vg, (C, S) = quad()
    topo = binary_tree(N)
    sched = get_scenario("uniform", N).realize(topo, K, seed=3).schedule
    state, metrics = run_rfast(
        topo, sched, lambda i, x, gen: vg(x, (C[i], S[i]), gen)[1],
        torch.zeros(P), 0.05, eval_every=K, eval_fn=lambda s, t: {},
        impl="kernel", device="cpu")
    return state, sum(m["waves"] for m in metrics)


def profiled(fn):
    """``fn()``'s result and its ``rfast.*`` spans ``(start, end, name)``
    under a CPU profiler session."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events() if e.name.startswith("rfast."))
    return out, ev


def named(ev, name):
    return [(a, b) for a, b, n in ev if n == name]


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_no_profiler_session_enters_no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert spans.span("rfast.round") is spans.span("rfast.mix")
    sync_round()
    run_rounds(*sync_setup(impl="plain"))
    wavefront()


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_round_spans_nest_as_documented(impl):
    setup = sync_setup(rounds=1, impl=impl)
    _, ev = profiled(lambda: run_rounds(*setup))
    (rnd,) = named(ev, "rfast.round")
    (mix,) = named(ev, "rfast.mix")
    (commit,) = named(ev, "rfast.commit")
    (scatter,) = named(ev, "rfast.scatter")
    grads = named(ev, "rfast.grad")
    assert len(grads) == N
    fwd, bwd = named(ev, "rfast.grad.fwd"), named(ev, "rfast.grad.bwd")
    assert len(fwd) == len(bwd) == N
    for part in [mix, commit, scatter] + grads:
        assert inside(part, rnd)
    assert mix[1] <= grads[0][0] and grads[-1][1] <= commit[0]
    assert commit[1] <= scatter[0]
    for g in grads:
        assert sum(inside(f, g) for f in fwd) == 1
        assert sum(inside(b, g) for b in bwd) == 1
    for f, b in zip(fwd, bwd):
        assert f[1] <= b[0]
    # the init's gradients (before the session) are not in it
    assert {n for _, _, n in ev} == {
        "rfast.round", "rfast.mix", "rfast.grad", "rfast.grad.fwd",
        "rfast.grad.bwd", "rfast.commit", "rfast.scatter"}


def test_wave_spans_one_per_wave_and_one_gradient_per_lane():
    K = 24
    (_, waves), ev = profiled(lambda: wavefront(K))
    assert waves > 0
    for name in ("rfast.wave", "rfast.mix", "rfast.commit",
                 "rfast.scatter"):
        assert len(named(ev, name)) == waves, name
    wave_spans = named(ev, "rfast.wave")
    grads = named(ev, "rfast.grad")
    # the paper init's N gradients, then one a lane (an event)
    assert len(grads) == N + K
    assert sum(any(inside(g, w) for w in wave_spans) for g in grads) == K
    assert len(named(ev, "rfast.grad.fwd")) == N + K
    assert len(named(ev, "rfast.grad.bwd")) == N + K


@pytest.mark.parametrize("run", [sync_round, wavefront])
def test_profiler_changes_nothing_computed(run):
    a = run()
    b, _ = profiled(run)
    if run is sync_round:
        for f in FIELDS:
            assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
        assert torch.equal(a[1], b[1])
    else:
        for x, y in zip(a[0][1:], b[0][1:]):
            assert torch.equal(x, y)
        assert a[1] == b[1]
