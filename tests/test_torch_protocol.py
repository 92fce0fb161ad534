"""The port's protocol round against the JAX package's.

The same quadratic problem, start and masks (numpy, seeded) go through
JAX's ``make_rfast_round(impl="jnp")`` and ``impl="pallas"`` (its CPU
default, the fused edge-major emulation) and through the port's
``impl="plain"``, ``impl="kernel"`` (``commit_grid``'s plain twin on CPU
tensors) and ``impl="kernel", oracle=True`` (the per-node commit
kernel's twin).  x, z, ρ and ρ̃ must agree at 2e-5, the tolerance
tests/test_protocol.py holds the reference's two backends to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_topology as j_get_topology
from repro.core.runtime import edge_arrays as j_edge_arrays
from repro.core.runtime import init_node_state as j_init_node_state
from repro.core.runtime import make_rfast_round as j_make_rfast_round
from repro_torch.core.protocol import (ProtocolState, consensus_mix,
                                       protocol_tracked_mass)
from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                      make_rfast_round)
from repro_torch.core.topology import get_topology
from repro_torch.kernels.rfast_update import dispatch

TOPOS = [("binary_tree", 5), ("directed_ring", 6), ("exponential", 7),
         ("mesh2d", 6), ("line", 4), ("parameter_server", 7)]
ROUTES = [("plain", False), ("kernel", False), ("kernel", True)]
FIELDS = ("x", "z", "rho", "rho_buf")


def quad_np(n, p, seed):
    r = np.random.default_rng(seed)
    return (r.normal(0, 1, (n, p)).astype(np.float32),
            r.uniform(0.5, 2.0, (n, 1)).astype(np.float32))


def j_grad_fn(params, batch, key):
    c, s = batch
    return 0.5 * jnp.sum(s * (params["w"] - c) ** 2), \
        {"w": s * (params["w"] - c)}


def t_grad_fn(x, batch, key):
    c, s = batch
    return 0.5 * torch.sum(s * (x - c) ** 2), s * (x - c)


def masks_seq(e_pad, rounds, loss_prob, seed):
    rng = np.random.default_rng(seed)
    return [None if loss_prob == 0 else
            (rng.uniform(size=e_pad) >= loss_prob).astype(np.float32)
            for _ in range(rounds)]


def run_jax(topo_name, n, p, C, S, masks, *, impl, gamma, robust,
            momentum=0.0):
    spec = j_edge_arrays(j_get_topology(topo_name, n))
    batches = (jnp.asarray(C), jnp.asarray(S))
    key = jax.random.PRNGKey(0)
    st = j_init_node_state(spec, {"w": jnp.zeros((p,), jnp.float32)},
                           j_grad_fn, batches, key, robust=robust,
                           momentum=momentum)
    rf = jax.jit(j_make_rfast_round(spec, j_grad_fn, gamma=gamma,
                                    robust=robust, momentum=momentum,
                                    impl=impl))
    losses = []
    for mk in masks:
        st, met = rf(st, batches, jax.random.split(key, n),
                     None if mk is None else jnp.asarray(mk))
        losses.append(np.asarray(met["losses"]))
    out = {f: np.asarray(getattr(st, f)["w"]) for f in FIELDS}
    if momentum:
        out["m"] = np.asarray(st.m["w"])
    return out, losses


def run_torch(topo_name, n, p, C, S, masks, *, impl, oracle, gamma, robust,
              momentum=0.0, donate=False):
    spec = edge_arrays(get_topology(topo_name, n))
    batches = (torch.from_numpy(C), torch.from_numpy(S))
    st = init_node_state(spec, torch.zeros(p), t_grad_fn, batches,
                         robust=robust, momentum=momentum)
    rf = make_rfast_round(spec, t_grad_fn, gamma=gamma, robust=robust,
                          momentum=momentum, impl=impl, oracle=oracle,
                          donate=donate)
    losses = []
    for mk in masks:
        st, met = rf(st, batches, None,
                     None if mk is None else torch.from_numpy(mk))
        losses.append(met["losses"].numpy())
    out = {f: getattr(st, f).numpy() for f in FIELDS}
    if momentum:
        out["m"] = st.m.numpy()
    return out, losses, st


@pytest.mark.parametrize("name,n", TOPOS)
@pytest.mark.parametrize("loss_prob", [0.0, 0.4])
def test_routes_match_jax_backends(name, n, loss_prob):
    p = 9
    C, S = quad_np(n, p, seed=n)
    robust = loss_prob > 0
    e_pad = j_edge_arrays(j_get_topology(name, n)).e_pad
    masks = masks_seq(e_pad, 12, loss_prob, seed=7)
    want = {impl: run_jax(name, n, p, C, S, masks, impl=impl, gamma=0.05,
                          robust=robust)[0] for impl in ("jnp", "pallas")}
    for impl, oracle in ROUTES:
        got, _, _ = run_torch(name, n, p, C, S, masks, impl=impl,
                              oracle=oracle, gamma=0.05, robust=robust)
        for j_impl, w in want.items():
            for f in FIELDS:
                np.testing.assert_allclose(
                    got[f], w[f], rtol=2e-5, atol=2e-5,
                    err_msg=f"{impl} oracle={oracle} vs {j_impl}: {name} {f}")


def test_routes_match_jax_with_momentum():
    n, p = 6, 5
    C, S = quad_np(n, p, seed=2)
    e_pad = j_edge_arrays(j_get_topology("binary_tree", n)).e_pad
    masks = masks_seq(e_pad, 10, 0.3, seed=3)
    kw = dict(gamma=0.03, robust=True, momentum=0.7)
    want = {impl: run_jax("binary_tree", n, p, C, S, masks, impl=impl,
                          **kw)[0] for impl in ("jnp", "pallas")}
    for impl, oracle in ROUTES:
        got, _, _ = run_torch("binary_tree", n, p, C, S, masks, impl=impl,
                              oracle=oracle, **kw)
        for w in want.values():
            for f in ("x", "z", "m"):
                np.testing.assert_allclose(got[f], w[f], rtol=2e-5,
                                           atol=2e-5, err_msg=f)


def test_schedule_gamma_and_losses_metric():
    """A schedule for gamma and the per-node losses metric, as JAX's."""
    n, p = 4, 3
    C, S = quad_np(n, p, seed=5)
    sched = lambda step: 0.1 / (1.0 + 0.1 * step)
    masks = [None] * 3
    _, want = run_jax("directed_ring", n, p, C, S, masks, impl="jnp",
                      gamma=sched, robust=False)
    for impl, oracle in ROUTES:
        _, got, _ = run_torch("directed_ring", n, p, C, S, masks, impl=impl,
                              oracle=oracle, gamma=sched, robust=False)
        for g, w in zip(got, want):
            assert g.shape == (n,)
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("impl,oracle", ROUTES)
def test_tracked_mass_invariant_under_random_masks(impl, oracle):
    n, p = 7, 4
    C, S = quad_np(n, p, seed=3)
    spec = edge_arrays(get_topology("binary_tree", n))
    batches = (torch.from_numpy(C), torch.from_numpy(S))
    state = init_node_state(spec, torch.zeros(p), t_grad_fn, batches,
                            robust=True)
    rf = make_rfast_round(spec, t_grad_fn, gamma=0.02, robust=True,
                          impl=impl, oracle=oracle, donate=True)
    rng = np.random.default_rng(6)
    for _ in range(30):
        masks = torch.from_numpy(
            (rng.uniform(size=spec.e_pad) > 0.4).astype(np.float32))
        state, _ = rf(state, batches, None, masks)
        torch.testing.assert_close(protocol_tracked_mass(state),
                                   state.g_prev.sum(0), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("impl,oracle", ROUTES)
def test_donate_false_leaves_its_input_unchanged(impl, oracle):
    n, p = 5, 6
    C, S = quad_np(n, p, seed=1)
    spec = edge_arrays(get_topology("binary_tree", n))
    batches = (torch.from_numpy(C), torch.from_numpy(S))
    st0 = init_node_state(spec, torch.zeros(p), t_grad_fn, batches,
                          robust=True, momentum=0.5)
    kw = dict(gamma=0.05, robust=True, momentum=0.5, impl=impl,
              oracle=oracle)
    rf = make_rfast_round(spec, t_grad_fn, **kw)
    masks = torch.tensor([1.0, 0.0] * (spec.e_pad // 2)
                         + [1.0] * (spec.e_pad % 2))
    st1, _ = rf(st0, batches, None, masks)       # leaves a non-zero state
    snap = [None if t is None else t.clone() for t in st1[1:]]
    a, _ = rf(st1, batches, None, masks)
    b, _ = rf(st1, batches, None, masks)         # replay: same result
    for t, s in zip(st1[1:], snap):
        assert torch.equal(t, s)
    for u, w in zip(a[1:], b[1:]):
        assert torch.equal(u, w)
    # donate=True writes the same values into the given tensors
    donated = ProtocolState(st1.step, *(t.clone() for t in st1[1:]))
    c, _ = make_rfast_round(spec, t_grad_fn, donate=True, **kw)(
        donated, batches, None, masks)
    assert c.x is donated.x and c.rho is donated.rho
    for u, w in zip(a, c):
        assert torch.equal(torch.as_tensor(u), torch.as_tensor(w))


def test_route_launches_and_arguments():
    n, p = 4, 5
    C, S = quad_np(n, p, seed=0)
    spec = edge_arrays(get_topology("binary_tree", n))
    batches = (torch.from_numpy(C), torch.from_numpy(S))
    st = init_node_state(spec, torch.zeros(p), t_grad_fn, batches)
    dispatch.clear()
    for impl, oracle in ROUTES:     # CPU tensors: plain twins, no launch
        make_rfast_round(spec, t_grad_fn, gamma=0.1, impl=impl,
                         oracle=oracle)(st, batches)
    assert dispatch.stats()["launches"] == 0
    with pytest.raises(ValueError, match="impl"):
        make_rfast_round(spec, t_grad_fn, gamma=0.1, impl="jnp")
    with pytest.raises(ValueError, match="oracle"):
        make_rfast_round(spec, t_grad_fn, gamma=0.1, impl="plain",
                         oracle=True)
    with pytest.raises(ValueError, match="robust"):   # masks, sync state
        make_rfast_round(spec, t_grad_fn, gamma=0.1)(
            st, batches, None, torch.ones(spec.e_pad))
    mixed = st._replace(rho=st.rho.to(torch.bfloat16))
    with pytest.raises(ValueError, match="one dtype"):
        make_rfast_round(spec, t_grad_fn, gamma=0.1, impl="kernel")(
            mixed, batches)


def test_consensus_mix_is_the_batched_pull():
    r = np.random.default_rng(0)
    v, vin = torch.randn(3, 4), torch.randn(2, 3, 4)
    w = torch.from_numpy(r.uniform(size=(2, 3, 1)).astype(np.float32))
    torch.testing.assert_close(consensus_mix(0.5, v, w, vin),
                               0.5 * v + w[0] * vin[0] + w[1] * vin[1])
