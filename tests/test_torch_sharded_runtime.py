"""The port's ppermute round (core/runtime_sharded.py) against JAX.

* The two ``matchings`` tests of tests/test_sharded_runtime.py,
  mirrored on the port's re-export; ``init_node_state(stacked=True)``
  against JAX's, and ``node_axes`` accepted by the dense round (one
  process: it changes nothing).
* One spawn of 4 gloo ranks, one node each (binary tree of 4, p 16,
  the reference helper's sizes): ``make_sharded_round`` for 200 rounds
  against JAX's DENSE ``make_rfast_round`` (within 1e-4), converging to
  x* (< 1e-2), Lemma 3 on the slotted layout (1e-4); then robust mode,
  300 rounds at 30 % loss, against JAX's ``make_sharded_round`` itself
  on the same 0/1 masks, run once in a subprocess with 8 forced host
  devices and the mesh (4, 2), as tests/helpers/sharded_equiv.py runs
  it (1e-4; Lemma 3 and convergence < 5e-2 too).

The objective is key-free, as the reference helper's.  The ranks import
this module by name, so JAX is imported inside the tests only.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import binary_tree, directed_ring, exponential
from repro_torch.core.runtime_sharded import (init_sharded_state,
                                              make_sharded_round, matchings,
                                              shard_state)
from repro_torch.launch.mesh import make_sweep_mesh
from repro_torch.launch.multihost import spawn_local

ROOT = Path(__file__).resolve().parents[1]
N, P, ROUNDS, GAMMA = 4, 16, 200, 0.06
RN, RP, R_ROUNDS, R_GAMMA, LOSS = 4, 8, 300, 0.05, 0.3
TOL = 1e-4


def test_matchings_cover_and_unique():
    for topo in (binary_tree(7), directed_ring(8), exponential(8)):
        for edges in (topo.edges_W(), topo.edges_A()):
            slots = matchings(edges)
            flat = [e for s in slots for e in s]
            assert sorted(flat) == sorted(edges)
            for s in slots:
                srcs = [j for j, _ in s]
                dsts = [i for _, i in s]
                assert len(set(srcs)) == len(srcs)
                assert len(set(dsts)) == len(dsts)


def test_tree_needs_two_matchings():
    slots = matchings(binary_tree(7).edges_W())
    assert len(slots) == 2      # binary tree: out-degree 2
    assert len(matchings(directed_ring(8).edges_W())) == 1


def _dense_problem():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 1, (N, P)).astype(np.float32),
            rng.uniform(0.5, 2.0, (N, 1)).astype(np.float32))


def _robust_problem():
    """The robust helper's C, then one (n, S) delivery mask a round, in
    its order of draws."""
    from repro_torch.core.plan import as_comm_plan
    plan = as_comm_plan(binary_tree(RN))
    S = len(plan.slots_w) + len(plan.slots_a)
    rng = np.random.default_rng(1)
    C = rng.normal(0, 1, (RN, RP)).astype(np.float32)
    masks = np.stack([(rng.uniform(size=(RN, S)) > LOSS).astype(np.float32)
                      for _ in range(R_ROUNDS)])
    return C, masks


def _snap(st):
    return {f: getattr(st, f).numpy().copy() for f in
            ("x", "z", "g_prev", "rho_out", "rho_buf")
            + (("mail_v",) if st.mail_v is not None else ())}


def _sharded_rank():
    """One node of the 4-rank spawn: the dense problem, then robust."""
    mesh = make_sweep_mesh(lanes=N, param_shards=1)
    na = ("data",)
    C, Sc = (torch.from_numpy(a) for a in _dense_problem())

    def grad_fn(x, batch, key):
        c, s = batch
        return 0.5 * torch.sum(s * (x - c) ** 2), s * (x - c)

    topo = binary_tree(N)
    st = shard_state(init_sharded_state(topo, torch.zeros(P), grad_fn,
                                        (C, Sc)), mesh, na)
    batch = shard_state((C, Sc), mesh, na)
    rf = make_sharded_round(topo, grad_fn, mesh, gamma=GAMMA, node_axes=na)
    for _ in range(ROUNDS):
        st, metrics = rf(st, batch)
    out = {"dense": _snap(st), "losses": metrics["losses"].numpy().copy()}

    Cr, masks = (torch.from_numpy(a) for a in _robust_problem())
    gf = lambda x, c, key: (0.5 * torch.sum((x - c) ** 2), x - c)
    topo = binary_tree(RN)
    st = shard_state(init_sharded_state(topo, torch.zeros(RP), gf, Cr,
                                        robust=True), mesh, na)
    rf = make_sharded_round(topo, gf, mesh, gamma=R_GAMMA, node_axes=na,
                            robust=True)
    c_loc = shard_state(Cr, mesh, na)
    for t in range(R_ROUNDS):
        st, _ = rf(st, c_loc, None, shard_state(masks[t], mesh, na))
    out["robust"] = _snap(st)
    return out


def _jax_robust(path_in: str, path_out: str) -> None:
    """tests/helpers/sharded_equiv.py's robust mode on the masks of
    ``path_in`` (run with 8 forced host devices); the final state to
    ``path_out``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as Pspec

    from repro.core import binary_tree as j_binary_tree
    from repro.core.runtime_sharded import (init_sharded_state as j_init,
                                            make_sharded_round as j_round)
    assert len(jax.devices()) == 8, jax.devices()
    data = np.load(path_in)
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    C = jnp.asarray(data["C"])

    def gf(params, batch, key):
        return (0.5 * jnp.sum((params["w"] - batch) ** 2),
                {"w": params["w"] - batch})

    params = {"w": jnp.zeros((RP,), jnp.float32)}
    keys = jax.random.split(jax.random.PRNGKey(1), RN)
    topo = j_binary_tree(RN)
    st = j_init(topo, params, gf, C, keys, robust=True)
    put = lambda t: jax.tree.map(lambda l: jax.device_put(
        l, NamedSharding(mesh, Pspec("data", *([None] * (l.ndim - 1))))), t)
    st = st._replace(x=put(st.x), z=put(st.z), g_prev=put(st.g_prev),
                     rho_out=put(st.rho_out), rho_buf=put(st.rho_buf),
                     mail_v=put(st.mail_v))
    rf = jax.jit(j_round(topo, gf, mesh, gamma=R_GAMMA, node_axes=("data",),
                         robust=True))
    for t in range(R_ROUNDS):
        st, _ = rf(st, put(C), keys, jnp.asarray(data["masks"][t]))
        jax.block_until_ready(st.x["w"])
    np.savez(path_out, **{f: np.asarray(getattr(st, f)["w"]) for f in (
        "x", "z", "g_prev", "rho_out", "rho_buf", "mail_v")})


@pytest.fixture(scope="module")
def spawned():
    outs = spawn_local(_sharded_rank, N, timeout_s=60.0, join_s=240.0)
    stack = lambda mode: {f: np.concatenate([o[mode][f] for o in outs])
                          for f in outs[0][mode]}
    return stack("dense"), stack("robust"), outs


def _lemma3(st):
    mass = st["z"].sum(0) + (st["rho_out"] - st["rho_buf"]).sum((0, 1))
    np.testing.assert_allclose(mass, st["g_prev"].sum(0), rtol=TOL, atol=TOL)


def test_sharded_round_matches_jax_dense_round(spawned):
    import jax
    import jax.numpy as jnp

    from repro.core import binary_tree as j_binary_tree
    from repro.core.runtime import (edge_arrays, init_node_state,
                                    make_rfast_round)
    dense, _, outs = spawned
    C, Sc = (jnp.asarray(a) for a in _dense_problem())

    def grad_fn(params, batch, key):
        c, s = batch
        return (0.5 * jnp.sum(s * (params["w"] - c) ** 2),
                {"w": s * (params["w"] - c)})

    spec = edge_arrays(j_binary_tree(N))
    st = init_node_state(spec, {"w": jnp.zeros((P,), jnp.float32)}, grad_fn,
                         (C, Sc), jax.random.PRNGKey(0))
    rf = jax.jit(make_rfast_round(spec, grad_fn, gamma=GAMMA))
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    for _ in range(ROUNDS):
        st, _m = rf(st, (C, Sc), keys, None)
    xd = np.asarray(st.x["w"])
    assert np.abs(xd - dense["x"]).max() < TOL
    x_star = np.asarray((Sc * C).sum(0) / Sc.sum(0))
    assert np.abs(dense["x"] - x_star[None]).max() < 1e-2
    _lemma3(dense)
    # every rank reports every node's loss
    for o in outs:
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
        assert o["losses"].shape == (N,)


def test_robust_sharded_round_matches_jax_sharded_round(spawned, tmp_path):
    _, robust, _ = spawned
    C, masks = _robust_problem()
    np.savez(tmp_path / "in.npz", C=C, masks=masks)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = ("import sys; sys.path.insert(0, {!r}); "
            "import test_torch_sharded_runtime as t; "
            "t._jax_robust({!r}, {!r})").format(
                str(Path(__file__).parent), str(tmp_path / "in.npz"),
                str(tmp_path / "out.npz"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    for f in want.files:
        np.testing.assert_allclose(robust[f], want[f], rtol=TOL, atol=TOL,
                                   err_msg=f)
    _lemma3(robust)
    assert np.abs(robust["x"] - C.mean(0)[None]).max() < 5e-2
    assert json.dumps(sorted(want.files)) == json.dumps(sorted(robust))


def test_stacked_init_and_node_axes_match_jax():
    import jax
    import jax.numpy as jnp

    from repro.core import binary_tree as j_binary_tree
    from repro.core.runtime import edge_arrays as j_edge_arrays
    from repro.core.runtime import init_node_state as j_init
    from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                          make_rfast_round)
    C, Sc = _dense_problem()
    x0 = np.random.default_rng(3).normal(0, 1, (N, P)).astype(np.float32)

    def j_grad(params, batch, key):
        c, s = batch
        return (0.5 * jnp.sum(s * (params - c) ** 2), s * (params - c))

    want = j_init(j_edge_arrays(j_binary_tree(N)), jnp.asarray(x0), j_grad,
                  (jnp.asarray(C), jnp.asarray(Sc)), jax.random.PRNGKey(0),
                  stacked=True)
    spec = edge_arrays(binary_tree(N))
    batch = (torch.from_numpy(C), torch.from_numpy(Sc))
    got = init_node_state(spec, torch.from_numpy(x0.copy()), lambda x, b, k: (
        0.5 * torch.sum(b[1] * (x - b[0]) ** 2), b[1] * (x - b[0])), batch,
        stacked=True, node_axes=("data",))
    for f in ("x", "z", "g_prev", "rho", "rho_buf"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    with pytest.raises(ValueError, match="stacked params"):
        init_node_state(spec, torch.zeros(P), lambda x, b, k: (x, x), batch,
                        stacked=True)
    gf = lambda x, b, k: (0.5 * torch.sum(b[1] * (x - b[0]) ** 2),
                          b[1] * (x - b[0]))
    runs = [make_rfast_round(spec, gf, gamma=GAMMA, **kw)(
        got, batch, None, None)[0].x for kw in ({}, {"node_axes": ("data",)})]
    assert torch.equal(*runs)
