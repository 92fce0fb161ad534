"""Port run_rfast (wavefront) vs JAX run_rfast(mode="wavefront").

The same Schedule (realized by the JAX package's scenario code), the
same x0 and a key-free objective go through both engines; the state is
compared after every eval chunk.  Backends are paired as
port ``plain`` ↔ JAX ``jnp`` and port ``kernel`` (its plain commit on
CPU tensors) ↔ JAX ``pallas`` (its emulation twin).  Tolerance 1e-4:
fp32 on both sides, sums taken in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_topology
from repro.core.scenario import get_scenario
from repro.core.simulator import run_rfast as jax_run_rfast
from repro_torch.core.simulator import (init_state, pack_state, run_rfast,
                                        tracked_mass, unpack_state,
                                        zeros_state)
from repro_torch.kernels.rfast_update import dispatch

FIELDS = ("x", "v", "z", "g_prev", "rho", "rho_buf", "v_hist", "rho_hist")
PAIRS = {"plain": "jnp", "kernel": "pallas"}
TOL = dict(rtol=1e-4, atol=1e-4)


def quad(n, p, seed=0):
    """f_i = ½ s_i |x − c_i|² (tests/test_simulator.py's quad_grad_fn
    with noise=0), as a JAX and a torch gradient on the same numbers."""
    rng = np.random.default_rng(seed)
    C = rng.normal(0, 1, (n, p)).astype(np.float32)
    S = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    jC, jS = jnp.asarray(C), jnp.asarray(S)
    tC, tS = torch.from_numpy(C), torch.from_numpy(S)
    return (lambda i, x, key: jS[i] * (x - jC[i]),
            lambda i, x, gen: tS[i] * (x - tC[i]))


def _snap(state):
    return {f: np.array(getattr(state, f), np.float32) for f in FIELDS}


def _runs(topo, sched, jfn, tfn, x0, gamma, impl, eval_every):
    jsnaps, tsnaps = [], []
    jax_run_rfast(topo, sched, jfn, jnp.asarray(x0), gamma,
                  eval_every=eval_every, impl=PAIRS[impl],
                  eval_fn=lambda s, t: jsnaps.append(_snap(s)) or {})
    dispatch.clear()
    state, metrics = run_rfast(
        topo, sched, tfn, torch.from_numpy(x0), gamma,
        eval_every=eval_every, impl=impl, device="cpu",
        eval_fn=lambda s, t: tsnaps.append(_snap(s)) or {})
    assert dispatch.stats()["launches"] == 0      # CPU: no kernel launch
    assert [m["k"] for m in metrics] == list(
        range(eval_every, sched.K + 1, eval_every))
    return jsnaps, tsnaps, state


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("topo_name,scen,n", [
    ("binary_tree", "uniform", 4), ("binary_tree", "straggler", 7),
    ("binary_tree", "packet_loss", 4), ("binary_tree", "crash_recovery", 7),
    ("directed_ring", "uniform", 7), ("directed_ring", "straggler", 4),
    ("directed_ring", "packet_loss", 7), ("directed_ring", "crash_recovery", 4),
    ("exponential", "uniform", 4), ("exponential", "straggler", 7),
    ("exponential", "packet_loss", 4), ("exponential", "crash_recovery", 7),
])
def test_engine_matches_jax_quadratic(topo_name, scen, n, impl):
    p, K = 24, 8 * n
    topo = get_topology(topo_name, n)
    sched = get_scenario(scen, n).realize(topo, K, seed=1).schedule
    jfn, tfn = quad(n, p)
    x0 = np.random.default_rng(2).normal(0, 1, (n, p)).astype(np.float32)
    jsnaps, tsnaps, state = _runs(topo, sched, jfn, tfn, x0, 0.05, impl,
                                  eval_every=2 * n)
    assert len(jsnaps) == len(tsnaps) == K // (2 * n)
    for c, (js, ts) in enumerate(zip(jsnaps, tsnaps)):
        for f in FIELDS:
            np.testing.assert_allclose(ts[f], js[f], **TOL,
                                       err_msg=f"chunk {c} field {f}")
    # Lemma 3: the tracked mass is the sum of the last sampled gradients
    np.testing.assert_allclose(tracked_mass(state).numpy(),
                               state.g_prev.sum(0).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_run_rfast_defaults_to_cuda_and_rejects_event_mode():
    topo = get_topology("binary_tree", 4)
    sched = get_scenario("uniform", 4).realize(topo, 8, seed=0).schedule
    _, tfn = quad(4, 8)
    x0 = torch.zeros(4, 8)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        run_rfast(topo, sched, tfn, x0, 0.1, mode="event", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_rfast(topo, sched, tfn, x0, 0.1)


def test_state_layouts_round_trip():
    topo = get_topology("directed_ring", 5)
    _, tfn = quad(5, 12)
    st = init_state(topo, torch.ones(12), tfn, H=4)
    assert st.k == 0 and st.x.shape == (5, 12) and st.v_hist.shape == (4, 5, 12)
    np.testing.assert_array_equal(st.z.numpy(), st.g_prev.numpy())
    packed = pack_state(st)
    assert packed.nodes.shape == (5, 4, 12) and packed.rho2.shape == (10, 12)
    back = unpack_state(packed, 3)
    assert back.k == 3
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      getattr(st, f).numpy())
    # unpack gives views: an in-place write to the packed state shows
    packed.nodes[2, 2] += 1.0
    np.testing.assert_array_equal(back.z[2].numpy(), st.z[2].numpy() + 1.0)
    z = zeros_state(topo, 12, 4)
    assert all(not getattr(z, f).any() for f in FIELDS)
    assert z.rho.shape == st.rho.shape
