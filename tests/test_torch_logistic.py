"""Port LogisticProblem and data/synthetic.py vs the JAX package.

``repro_torch.data.synthetic`` is a verbatim numpy copy: the same
arguments give ``assert_array_equal`` arrays.  ``LogisticProblem``'s
closed-form gradient is held to ``jax.grad`` of the reference's loss at
n 4, m 400, d 16: the full gradient (``batch = 0``, the key-free parity
objective) and the minibatch one with the reference's sampled indices
fed in; ``mean_loss``, ``accuracy`` and ``optimum`` (2000 steps of
full-batch descent) likewise.  Tolerance 1e-5 relative to each
quantity's largest entry: fp32 on both sides, sums taken in another
order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_logistic_problem as j_make
from repro.data import synthetic as j_syn
from repro_torch.data import make_logistic_problem, synthetic

N, M, D = 4, 400, 16


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("m,d,seed,het", [(400, 16, 0, False),
                                          (1000, 64, 3, True),
                                          (777, 5, 1, True)])
def test_synthetic_arrays_equal_reference(m, d, seed, het):
    X, y = synthetic.logistic_dataset(m, d, seed=seed)
    jX, jy = j_syn.logistic_dataset(m, d, seed=seed)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    assert X.dtype == jX.dtype and y.dtype == jy.dtype
    Xs, ys = synthetic.partition(X, y, 7, heterogeneous=het, seed=seed)
    jXs, jys = j_syn.partition(jX, jy, 7, heterogeneous=het, seed=seed)
    np.testing.assert_array_equal(Xs, jXs)
    np.testing.assert_array_equal(ys, jys)
    got = list(synthetic.token_stream(50, 3, 8, n_batches=3, seed=seed))
    want = list(j_syn.token_stream(50, 3, 8, n_batches=3, seed=seed))
    for (t, lbl), (jt, jl) in zip(got, want):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(lbl, jl)


@pytest.fixture(scope="module", params=[False, True], ids=["iid", "het"])
def problems(request):
    kw = dict(m=M, d=D, batch=0, heterogeneous=request.param, seed=2)
    return j_make(N, **kw), make_logistic_problem(N, device="cpu", **kw)


def _points():
    rng = np.random.default_rng(5)
    return [np.zeros(D + 1, np.float32)] + [
        rng.normal(0, s, D + 1).astype(np.float32) for s in (0.3, 3.0)]


def test_problem_layout(problems):
    jp, tp = problems
    assert (tp.n, tp.p, tp.batch) == (jp.n, jp.p, jp.batch) == (N, D + 1, 0)
    assert tp.lam == pytest.approx(jp.lam)
    np.testing.assert_array_equal(tp.X.numpy(), np.asarray(jp.X))
    np.testing.assert_array_equal(tp.y.numpy(), np.asarray(jp.y))
    assert tp.device == torch.device("cpu")


def test_full_gradient_and_losses_match_jax(problems):
    jp, tp = problems
    jg, tg = jp.grad_fn(), tp.grad_fn()
    for x in _points():
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        for i in range(N):
            _close(tg(i, tx, None).numpy(), jg(i, jx, None))
            _close(float(tp.local_loss(i, tx)),
                   float(jp.local_loss(jnp.asarray(i), jx)))
        _close(float(tp.global_loss(tx)), float(jp.global_loss(jx)))
        _close(float(tp.mean_loss(tx)), float(jp.mean_loss(jx)))
        assert float(tp.accuracy(tx)) == pytest.approx(
            float(jp.accuracy(jx)), abs=1e-6)


def test_large_margins_use_softplus_not_the_identity():
    """At margins beyond 20 F.softplus turns into the identity; the
    reference's softplus (logaddexp) does not."""
    kw = dict(m=40, d=3, batch=0, seed=1)
    jp, tp = j_make(2, **kw), make_logistic_problem(2, device="cpu", **kw)
    x = np.full(4, 40.0, np.float32)
    _close(float(tp.mean_loss(torch.from_numpy(x))),
           float(jp.mean_loss(jnp.asarray(x))))


def test_optimum_matches_jax(problems):
    jp, tp = problems
    _close(tp.optimum().numpy(), jp.optimum())


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_minibatch_gradient_with_the_reference_indices(batch):
    kw = dict(m=M, d=D, batch=batch, heterogeneous=True, seed=0)
    jp, tp = j_make(N, **kw), make_logistic_problem(N, device="cpu", **kw)
    m_i = M // N
    jg = jp.grad_fn()
    for s, x in enumerate(_points()):
        key = jax.random.PRNGKey(s)
        idx = np.array(jax.random.randint(key, (batch,), 0, m_i))
        for i in range(N):
            want = jg(i, jnp.asarray(x), key)
            got = tp.grad_at(i, torch.from_numpy(x), torch.from_numpy(idx))
            _close(got.numpy(), want)


def test_minibatch_draw_follows_the_generator():
    tp = make_logistic_problem(N, m=M, d=D, batch=8, device="cpu")
    g = tp.grad_fn()
    x = torch.from_numpy(_points()[1])
    a = g(1, x, torch.Generator().manual_seed(4))
    b = g(1, x, torch.Generator().manual_seed(4))
    c = g(1, x, torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    idx = torch.randint(0, M // N, (8,),
                        generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, tp.grad_at(1, x, idx), rtol=0, atol=0)
    # batch >= m_i is the full, key-free gradient
    full = make_logistic_problem(N, m=M, d=D, batch=M, device="cpu")
    torch.testing.assert_close(full.grad_fn()(1, x, None),
                               full.grad_at(1, x), rtol=0, atol=0)


def test_make_logistic_problem_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_logistic_problem(N, m=M, d=D)
