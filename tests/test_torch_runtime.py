"""The port's runtime (one device): convergence, invariants, path
agreement — tests/test_runtime.py in the port, with its tolerances, for
both round backends."""
import numpy as np
import pytest
import torch

from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                      make_rfast_round, runtime_tracked_mass)
from repro_torch.core.topology import binary_tree, directed_ring

IMPLS = ["plain", "kernel"]


def quad_setup(n, p, seed=0):
    rng = np.random.default_rng(seed)
    C = torch.from_numpy(rng.normal(0, 1, (n, p)).astype(np.float32))
    S = torch.from_numpy(rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32))

    def grad_fn(x, batch, key):
        # batch carries the node's own (c, s)
        c, s = batch
        return 0.5 * torch.sum(s * (x - c) ** 2), s * (x - c)

    x_star = (S * C).sum(0) / S.sum(0)
    return grad_fn, (C, S), x_star


def _run(topo, rounds, gamma, robust=False, masks_fn=None, momentum=0.0,
         p=6, seed=0, impl="plain"):
    spec = edge_arrays(topo)
    grad_fn, batches, x_star = quad_setup(topo.n, p, seed)
    state = init_node_state(spec, torch.zeros(p), grad_fn, batches,
                            robust=robust, momentum=momentum)
    round_fn = make_rfast_round(spec, grad_fn, gamma=gamma, robust=robust,
                                momentum=momentum, impl=impl, donate=True)
    rng = np.random.default_rng(seed + 1)
    for _ in range(rounds):
        masks = None
        if masks_fn is not None:
            masks = torch.from_numpy(
                np.asarray(masks_fn(rng, spec.e_pad), np.float32))
        state, _ = round_fn(state, batches, None, masks)
    return state, x_star


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("builder", [binary_tree, directed_ring])
def test_runtime_sync_converges_exactly(builder, impl):
    state, x_star = _run(builder(5), rounds=700, gamma=0.08, impl=impl)
    err = float((state.x - x_star[None]).abs().max())
    assert err < 1e-4, err


@pytest.mark.parametrize("impl", IMPLS)
def test_runtime_momentum_converges(impl):
    state, x_star = _run(binary_tree(5), rounds=800, gamma=0.05,
                         momentum=0.5, impl=impl)
    err = float((state.x - x_star[None]).abs().max())
    assert err < 1e-3, err


@pytest.mark.parametrize("impl", IMPLS)
def test_runtime_robust_path_matches_sync_when_all_delivered(impl):
    topo = directed_ring(5)
    s1, _ = _run(topo, rounds=50, gamma=0.05, robust=False, impl=impl)
    s2, _ = _run(topo, rounds=50, gamma=0.05, robust=True,
                 masks_fn=lambda rng, e: np.ones(e), impl=impl)
    torch.testing.assert_close(s1.x, s2.x, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_runtime_converges_under_packet_loss(impl):
    state, x_star = _run(
        binary_tree(5), rounds=2500, gamma=0.05, robust=True,
        masks_fn=lambda rng, e: (rng.uniform(size=e) > 0.3).astype(float),
        impl=impl)
    err = float((state.x - x_star[None]).abs().max())
    assert err < 1e-3, err


@pytest.mark.parametrize("impl", IMPLS)
def test_runtime_mass_conservation_under_loss(impl):
    spec = edge_arrays(binary_tree(7))
    grad_fn, batches, _ = quad_setup(7, 4)
    state = init_node_state(spec, torch.zeros(4), grad_fn, batches,
                            robust=True)
    round_fn = make_rfast_round(spec, grad_fn, gamma=0.02, robust=True,
                                impl=impl)
    rng = np.random.default_rng(3)
    for _ in range(60):
        masks = torch.from_numpy(
            (rng.uniform(size=spec.e_pad) > 0.4).astype(np.float32))
        state, _ = round_fn(state, batches, None, masks)
        torch.testing.assert_close(runtime_tracked_mass(state),
                                   state.g_prev.sum(0), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("impl", IMPLS)
def test_runtime_heterogeneity_free(impl):
    """Fixed point is the exact global optimum despite extreme per-node
    heterogeneity (gradient tracking, Remark 7)."""
    state, x_star = _run(directed_ring(4), rounds=900, gamma=0.06, seed=9,
                         impl=impl)
    assert float((state.x.mean(0) - x_star).abs().max()) < 5e-4


def test_init_takes_a_flat_start():
    """The state starts from one flat (p,) vector, broadcast to every
    node; anything else is refused."""
    spec = edge_arrays(binary_tree(3))
    grad_fn, batches, _ = quad_setup(3, 4)
    state = init_node_state(spec, torch.arange(4.0), grad_fn, batches)
    assert torch.equal(state.x, torch.arange(4.0).expand(3, 4))
    with pytest.raises(ValueError, match="flat"):
        init_node_state(spec, torch.zeros(3, 4), grad_fn, batches)
