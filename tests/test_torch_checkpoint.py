"""The port's checkpoints against the JAX package's, and resume.

* The module's own contract, mirrored from tests/test_substrate.py
  (round trip, latest step, a mismatched template) and
  tests/test_serve.py (the manifest, a torn npz, a manifest pointing at
  a missing file, an unreadable manifest, the fallback without one).
* Files cross-load both ways, bitwise: an async ``RFASTState``, the
  synchronous ``ProtocolState`` (robust and momentum, so ``.mail_v``
  and ``.m`` exist; the port's flat rows become the reference's
  node-stacked model trees), and a ``--publish-dir`` model tree that
  the reference loads with its ``init_params`` as the template.
* ``run_rfast(state0=...)`` from a chunk boundary is bitwise the
  uninterrupted run (both engines, a stochastic objective: the
  generators are counter-based).  A state saved by the reference's
  ``run_rfast`` on the key-free logistic objective (batch 0) resumes in
  the port to within 1e-5 of the reference's uninterrupted run (fp32 on
  both sides; the sums' order differs).  A wrong history depth and an
  off-boundary ``k`` raise.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as j_get_config
from repro.core import get_scenario as j_get_scenario
from repro.core import get_topology as j_get_topology
from repro.core import run_rfast as j_run_rfast
from repro.core.protocol import ProtocolState as JProtocolState
from repro.core.simulator import RFASTState as JState
from repro.data import make_logistic_problem as j_make_logistic_problem
from repro.models import transformer as jt
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core.paramvec import make_ravel_spec, ravel
from repro_torch.core.protocol import ProtocolState
from repro_torch.core.scenario import get_scenario
from repro_torch.core.simulator import RFASTState, run_rfast, zeros_state
from repro_torch.core.topology import get_topology
from repro_torch.data import make_logistic_problem
from repro_torch.launch import train
from repro_torch.models.transformer import init_params
from test_torch_engine import two_torch_threads  # noqa: F401

FIELDS = RFASTState._fields[1:]


def _tree():
    return {"w": torch.ones(3, 4), "b": torch.zeros(4),
            "nested": {"s": torch.full((2,), 2.0)}}


# ------------------------------------------------------------------ #
# the module's contract (tests/test_substrate.py, tests/test_serve.py)
# ------------------------------------------------------------------ #
def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    ckpt.save_checkpoint(d, 7, tree)
    ckpt.save_checkpoint(d, 12, {k: (v + 1 if torch.is_tensor(v) else v)
                                 for k, v in tree.items()})
    assert ckpt.latest_step(d) == 12
    back = ckpt.load_checkpoint(d, tree)
    torch.testing.assert_close(back["w"], tree["w"] + 1, rtol=0, atol=0)
    back7 = ckpt.load_checkpoint(d, tree, step=7)
    torch.testing.assert_close(back7["nested"]["s"], torch.full((2,), 2.0),
                               rtol=0, atol=0)
    assert back7["w"].dtype == torch.float32


def test_checkpoint_structure_mismatch(tmp_path):
    d = str(tmp_path / "c2")
    ckpt.save_checkpoint(d, 1, _tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load_checkpoint(d, {"other": torch.zeros(1)})


def test_ckpt_manifest_written_and_read(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    ckpt.save_checkpoint(d, 12, tree)
    man = ckpt.read_manifest(d)
    assert man["step"] == 12 and man["file"] == "step_0000000012.npz"
    assert man["leaves"] == 1 and man["time"] <= time.time()
    assert ckpt.latest_step(d) == 12
    ckpt.save_checkpoint(d, 20, tree)
    assert ckpt.read_manifest(d)["step"] == 20
    assert torch.equal(ckpt.load_checkpoint(d, tree)["w"], tree["w"])
    # no leftover tmp files from the atomic writes
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_ckpt_rejects_torn_npz(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.zeros(4, 4)}
    path = ckpt.save_checkpoint(d, 3, tree)
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:           # simulate a torn writer
        fh.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="torn or partial checkpoint"):
        ckpt.load_checkpoint(d, tree, step=3)


def test_ckpt_manifest_pointing_at_missing_file(tmp_path):
    d = str(tmp_path)
    path = ckpt.save_checkpoint(d, 3, {"w": torch.zeros(3)})
    os.remove(path)
    with pytest.raises(ValueError, match="points at missing"):
        ckpt.read_manifest(d)


def test_ckpt_unreadable_manifest(tmp_path):
    d = str(tmp_path)
    with open(os.path.join(d, ckpt.MANIFEST), "w") as fh:
        fh.write("{not json")
    with pytest.raises(ValueError, match="unreadable checkpoint manifest"):
        ckpt.read_manifest(d)


def test_latest_step_fallback_without_manifest(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 7, {"w": torch.zeros(3)})
    os.remove(os.path.join(d, ckpt.MANIFEST))
    assert ckpt.latest_step(d) == 7        # regex fallback still works
    assert ckpt.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "empty"), {"w": torch.zeros(3)})


# ------------------------------------------------------------------ #
# cross-loads, bitwise
# ------------------------------------------------------------------ #
def _rfast_fields(seed=0):
    rng = np.random.default_rng(seed)
    shapes = dict(x=(3, 5), v=(3, 5), z=(3, 5), g_prev=(3, 5), rho=(2, 5),
                  rho_buf=(2, 5), v_hist=(4, 3, 5), rho_hist=(4, 2, 5))
    return {f: rng.normal(size=s).astype(np.float32)
            for f, s in shapes.items()}


def test_reference_rfast_state_loads_in_the_port(tmp_path):
    arrs = _rfast_fields()
    jckpt.save_checkpoint(str(tmp_path), 16, JState(
        k=jnp.asarray(16, jnp.int32),
        **{f: jnp.asarray(a) for f, a in arrs.items()}))
    like = RFASTState(0, *(torch.zeros(a.shape) for a in arrs.values()))
    back = ckpt.load_checkpoint(str(tmp_path), like)
    assert back.k == 16 and isinstance(back.k, int)
    for f, a in arrs.items():
        assert torch.equal(getattr(back, f), torch.from_numpy(a)), f


def test_port_rfast_state_loads_in_the_reference(tmp_path):
    arrs = _rfast_fields(1)
    ckpt.save_checkpoint(str(tmp_path), 32, RFASTState(
        32, **{f: torch.from_numpy(a) for f, a in arrs.items()}))
    with np.load(tmp_path / "step_0000000032.npz") as data:
        assert data[".k"].dtype == np.int32 and data[".k"].shape == ()
    like = JState(k=jnp.zeros((), jnp.int32),
                  **{f: jnp.zeros(a.shape) for f, a in arrs.items()})
    back = jckpt.load_checkpoint(str(tmp_path), like)
    assert int(back.k) == 32
    for f, a in arrs.items():
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), a)


def _rows(tree) -> np.ndarray:
    """A node-stacked JAX tree as (rows, p) in the ravel order."""
    leaves = jax.tree.leaves(tree)
    return np.concatenate([np.asarray(l).reshape(l.shape[0], -1)
                           for l in leaves], axis=1)


def test_sync_state_cross_loads_both_ways(tmp_path):
    """The reference's synchronous ProtocolState (robust + momentum)
    into the port's flat state, and the port's back into the
    reference's."""
    np_params = jax.tree.map(np.asarray, jt.init_params(
        j_get_config("rfast-100m").reduced(), jax.random.PRNGKey(0)))
    rspec = make_ravel_spec(np_params)
    N, E = 4, 6
    rng = np.random.default_rng(0)
    rand = lambda lead: jax.tree.map(
        lambda l: jnp.asarray(rng.normal(size=(lead,) + l.shape)
                              .astype(np.float32)), np_params)
    jstate = JProtocolState(step=jnp.asarray(3, jnp.int32), x=rand(N),
                            z=rand(N), g_prev=rand(N), rho=rand(E),
                            rho_buf=rand(E), mail_v=rand(E), m=rand(N))
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    jckpt.save_checkpoint(jdir, 3, jstate)
    zeros = lambda r: torch.zeros(r, rspec.p)
    like = ProtocolState(step=0, x=zeros(N), z=zeros(N), g_prev=zeros(N),
                         rho=zeros(E), rho_buf=zeros(E), mail_v=zeros(E),
                         m=zeros(N))
    st = train.load_sync_state(jdir, rspec, like)
    assert st.step == 3
    for f in JProtocolState._fields[1:]:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      _rows(getattr(jstate, f)), err_msg=f)
    # the port's flat state, saved, is the reference's file
    ckpt.save_checkpoint(pdir, 3, train.sync_tree(rspec, st))
    with np.load(os.path.join(jdir, "step_0000000003.npz")) as a, \
            np.load(os.path.join(pdir, "step_0000000003.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "_treedef":
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = jckpt.load_checkpoint(pdir, jstate)
    for f in JProtocolState._fields:
        for u, w in zip(jax.tree.leaves(getattr(back, f)),
                        jax.tree.leaves(getattr(jstate, f))):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(w))


def test_published_model_tree_loads_in_the_reference(tmp_path):
    pub = str(tmp_path / "pub")
    res = train.main(["--reduced", "--nodes", "2", "--steps", "4", "--seq",
                      "16", "--batch-per-node", "2", "--log-every", "2",
                      "--scenario", "uniform", "--publish-dir", pub,
                      "--device", "cpu"])
    assert res["published"] == [4, 8] and ckpt.latest_step(pub) == 8
    jparams = jt.init_params(j_get_config("rfast-100m").reduced(),
                             jax.random.PRNGKey(0))
    jback = jckpt.load_checkpoint(pub, jparams)
    back = ckpt.load_checkpoint(pub, init_params(
        get_config("rfast-100m").reduced(), torch.Generator()))
    for u, w in zip(jax.tree.leaves(jback), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), back))):
        assert np.isfinite(u).all()
        np.testing.assert_array_equal(np.asarray(u), w)
    assert ravel(make_ravel_spec(back), back).shape == (res["p"],)


# ------------------------------------------------------------------ #
# resume
# ------------------------------------------------------------------ #
def _logistic_run(n=7, K=280):
    prob = make_logistic_problem(n, m=700, d=16, batch=8, heterogeneous=True,
                                 seed=0, device="cpu")
    topo = get_topology("binary_tree", n)
    sched = get_scenario("straggler", n).realize(topo, K, seed=1).schedule
    return prob, topo, sched


@pytest.mark.parametrize("mode", ["wavefront", "event"])
def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, mode):
    prob, topo, sched = _logistic_run()
    ev = lambda s, t: {"m": float(s.x.abs().sum()), "t": t}
    d = str(tmp_path)
    kw = dict(seed=2, eval_every=70, eval_fn=ev, mode=mode, device="cpu")
    st, ms = run_rfast(topo, sched, prob, torch.zeros(prob.p), 5e-3,
                       chunk_cb=lambda s, k: k == 140 and
                       ckpt.save_checkpoint(d, k, s), **kw)
    like = zeros_state(topo, prob.p, int(sched.D) + 2, device="cpu")
    st0 = ckpt.load_checkpoint(d, like)
    assert st0.k == 140
    st2, ms2 = run_rfast(topo, sched, prob, None, 5e-3, state0=st0, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(st, f), getattr(st2, f)), f
    assert ms2 == ms[2:]
    # the saved state itself is left as it was
    assert torch.equal(st0.x, ckpt.load_checkpoint(d, like).x)
    # a finished run resumes to nothing
    st3, ms3 = run_rfast(topo, sched, prob, None, 5e-3,
                         state0=st._replace(k=sched.K), **kw)
    assert ms3 == [] and torch.equal(st3.x, st.x)


def test_resume_from_a_reference_checkpoint(tmp_path):
    n, K, gamma = 7, 280, 5e-3
    jprob = j_make_logistic_problem(n, m=700, d=16, batch=0,
                                    heterogeneous=True, seed=0)
    jtopo = j_get_topology("binary_tree", n)
    sched = j_get_scenario("straggler", n).realize(jtopo, K,
                                                   seed=1).schedule
    d = str(tmp_path)
    jst, _ = j_run_rfast(jtopo, sched, jprob, jnp.zeros((n, jprob.p)),
                         gamma, eval_every=70,
                         chunk_cb=lambda s, k: k == 140 and
                         jckpt.save_checkpoint(d, k, s))
    prob = make_logistic_problem(n, m=700, d=16, batch=0, heterogeneous=True,
                                 seed=0, device="cpu")
    topo = get_topology("binary_tree", n)
    like = zeros_state(topo, prob.p, int(sched.D) + 2, device="cpu")
    st0 = ckpt.load_checkpoint(d, like)
    st, _ = run_rfast(topo, sched, prob, None, gamma, eval_every=70,
                      state0=st0, device="cpu")
    for f in ("x", "v", "z", "g_prev", "rho", "rho_buf"):
        want = np.asarray(getattr(jst, f))
        np.testing.assert_allclose(getattr(st, f).numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f)


def test_resume_checks_the_saved_state():
    prob, topo, sched = _logistic_run(K=140)
    H = int(sched.D) + 2
    bad_h = zeros_state(topo, prob.p, H + 1, device="cpu")
    with pytest.raises(ValueError, match=f"needs H={H}"):
        run_rfast(topo, sched, prob, None, 5e-3, eval_every=70,
                  state0=bad_h, device="cpu")
    off = zeros_state(topo, prob.p, H, device="cpu")._replace(k=35)
    for mode in ("wavefront", "event"):
        with pytest.raises(ValueError, match="eval-chunk boundary"):
            run_rfast(topo, sched, prob, None, 5e-3, eval_every=70,
                      state0=off, mode=mode, device="cpu")
