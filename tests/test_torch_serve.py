"""The port's serving package against the JAX package's, on the CPU.

Weights from one JAX ``init_params`` tree (tests/test_serve.py's TINY
decoder) carried into the port by ``params_from_jax``:

* ``make_workload`` draws bitwise the reference's requests; the
  scheduler pops them in its order.
* ``ServeEngine``'s greedy tokens equal the port's B = 1 ``prefill_cache``
  + ``decode_step`` loop and the JAX package's ``ServeEngine`` on the same
  requests (the smallest top-2 logit gap is printed: a tie would make
  the comparison depend on the order of sums).
* Mirrors of tests/test_serve.py: the cache pin (1 decode + n_buckets
  entries over more than 100 mixed requests, none added across a live
  swap), drain mode, the refusal of non-attention archs, ``bucket_for``,
  ``WeightStore.poll``/``flip`` on a checkpoint that the JAX package's
  ``save_checkpoint`` wrote, the CLI, and the publish -> poll -> hot-swap
  loop against the port's ``train.py --publish-dir``.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as j_get_config
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import cache as j_serve_cache
from repro.serve import make_workload as j_make_workload
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig
from repro_torch.serve import (DEFAULT_BUCKETS, Request, Scheduler,
                               ServeEngine, WeightStore,
                               cache as serve_cache, make_workload)
from tests.helpers.recompiles import assert_no_recompiles
from test_torch_engine import two_torch_threads  # noqa: F401

TINY = dict(name="serve-tiny", n_layers=1, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=64, vocab=64)
CFG = ModelConfig(**TINY)


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, port params) of TINY from one JAX tree."""
    jp = jt.init_params(JModelConfig(**TINY), jax.random.PRNGKey(0))
    params, _ = tt.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jp, params


def scale(params, f):
    return jax.tree.map(lambda a: a * f, params)


def _engine(params, *, batch=4, buckets=(4, 8, 16), **kw):
    return ServeEngine(CFG, WeightStore(params), batch=batch, max_len=32,
                       buckets=buckets, **kw)


def _requests(n, seed, *, gen=None, max_prompt=14, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, CFG.vocab, size=int(
        rng.integers(1, max_prompt))).astype(np.int32),
        gen=int(rng.integers(1, 6)) if gen is None else gen, arrive_s=0.0)
        for i in range(n)]


def _greedy(params, prompt, gen, max_len=32):
    """The port's B = 1 loop: tokens and each step's top-2 logit gap."""
    cache, logits = tt.prefill_cache(CFG, params,
                                     torch.from_numpy(prompt)[None], max_len)
    out, gaps = [], []
    for i in range(gen):
        if i:
            logits, cache = tt.decode_step(CFG, params, cache,
                                           torch.tensor([[out[-1]]]))
        top = torch.topk(logits[0, 0], 2).values
        gaps.append(float(top[0] - top[1]))
        out.append(int(torch.argmax(logits[0, 0])))
    return out, gaps


# ------------------------------------------------------------------ #
# traffic, scheduler, cache
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kw", [
    dict(n_requests=40, vocab=64, max_prompt=16, max_gen=4, seed=3),
    dict(n_requests=25, vocab=32000, max_prompt=64, max_gen=32,
         rate_rps=50.0, s=1.1, seed=7),
    dict(n_requests=1, vocab=5, max_prompt=1, max_gen=1),
    dict(n_requests=0, vocab=64, max_prompt=16, max_gen=4)])
def test_make_workload_is_bitwise_the_references(kw):
    got, want = make_workload(**kw), j_make_workload(**kw)
    assert len(got) == len(want) == kw["n_requests"]
    for a, b in zip(got, want):
        assert (a.rid, a.gen, a.arrive_s) == (b.rid, b.gen, b.arrive_s)
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_scheduler_pops_in_the_references_order():
    kw = dict(n_requests=30, vocab=64, max_prompt=8, max_gen=4,
              rate_rps=100.0, seed=1)
    s, js = Scheduler(make_workload(**kw)), JScheduler(j_make_workload(**kw))
    for now in np.linspace(0.0, 0.4, 9):
        assert s.next_arrival() == js.next_arrival()
        while (r := s.pop_ready(now)) is not None:
            assert r.rid == js.pop_ready(now).rid
        assert js.pop_ready(now) is None and len(s) == len(js)
    assert s.admitted == js.admitted and s.next_arrival() is None
    r = Request(rid=0, prompt=np.zeros(2, np.int32), gen=1, arrive_s=1.0)
    assert not r.done and np.isnan(r.latency_s)


def test_cache_contract():
    serve_cache.clear()
    built = []
    build = lambda: built.append(1) or (lambda: 42)   # noqa: E731
    f = serve_cache.lookup(("decode", "a", 4, 8, "float32"), build)
    assert f() == 42 and serve_cache.lookup(
        ("decode", "a", 4, 8, "float32"), build) is f
    serve_cache.lookup(("prefill", "a", 4, 8, 4, "float32"), build)
    assert built == [1, 1]
    assert serve_cache.stats() == {"hits": 1, "misses": 2, "entries": 2}
    serve_cache.clear()
    assert serve_cache.stats() == {"hits": 0, "misses": 0, "entries": 0}


def test_engine_keys_spell_the_references_dtype(tiny):
    serve_cache.clear()
    eng = _engine(tiny[1])
    eng._decode_exec()
    eng._prefill_exec(8)
    assert set(serve_cache._cache) == {
        ("decode", "serve-tiny", 4, 32, "float32"),
        ("prefill", "serve-tiny", 4, 32, 8, "float32")}
    assert DEFAULT_BUCKETS == (4, 8, 16, 32, 64)


# ------------------------------------------------------------------ #
# the engine against the B = 1 loop and the reference's engine
# ------------------------------------------------------------------ #
def test_engine_matches_single_request_decode_and_the_reference(tiny):
    """tests/test_serve.py::test_engine_matches_single_request_decode,
    and the JAX package's engine on the same requests."""
    jp, params = tiny
    reqs, jreqs = _requests(12, 0), _requests(12, 0, cls=JRequest)
    serve_cache.clear()
    _engine(params).run(reqs)
    j_serve_cache.clear()
    JServeEngine(JModelConfig(**TINY), jp, batch=4, max_len=32,
                 buckets=(4, 8, 16)).run(jreqs)
    gaps = []
    for r, jr in zip(reqs, jreqs):
        want, g = _greedy(params, r.prompt, r.gen)
        gaps += g
        assert r.done and r.tokens == want, f"request {r.rid}"
        assert jr.tokens == r.tokens, f"request {r.rid} vs the reference"
    print(f"smallest top-2 logit gap: {min(gaps):.3e}")
    assert min(gaps) > 1e-4          # no tie the order of sums could flip


def test_steady_state_cache_pin_and_zero_entries_across_swap(tiny):
    """tests/test_serve.py::test_steady_state_cache_pin_and_zero_recompile_
    swap: >= 100 mixed-length requests settle the cache at exactly 1
    decode + n_buckets prefill entries; a live weight swap with requests
    in flight then adds ZERO entries and drops nothing."""
    params = tiny[1]
    eng = _engine(params, swap_mode="immediate")
    store = eng.store
    reqs = make_workload(110, vocab=CFG.vocab, max_prompt=16, max_gen=4,
                         seed=3)
    assert len({len(r.prompt) for r in reqs}) > 3   # genuinely mixed

    with assert_no_recompiles(expect_entries=4, cache=serve_cache) as rec:
        eng.run(reqs)
    assert all(r.done for r in reqs)
    assert rec.misses == 4 and rec.hits > 100

    more = _requests(30, 4, gen=5, max_prompt=16)
    with assert_no_recompiles(expect_entries=0, fresh=False,
                              cache=serve_cache) as rec2:
        sched = Scheduler(more)
        eng._t0 = time.perf_counter()
        while eng.in_flight == 0:
            eng.step(sched)
        in_flight_rids = {r.rid for r in eng._slot_req if r is not None}
        assert in_flight_rids                       # swap lands mid-batch
        store.offer(scale(params, 0.9), step=7, published_at=time.time())
        while len(sched) or eng.in_flight or store.staged:
            eng.step(sched)
    assert rec2.misses == 0 and rec2.hits > 0
    assert store.swaps and store.step == 7
    assert store.swaps[0]["engine_step"] <= max(
        r.done_step for r in more if r.rid in in_flight_rids)
    assert all(r.done for r in more)
    assert {r.weights_step for r in more} >= {7}


def test_drain_mode_finishes_in_flight_on_old_weights(tiny):
    """tests/test_serve.py::test_drain_mode_finishes_in_flight_on_old_
    weights, and the old weights really serve the in-flight requests."""
    params = tiny[1]
    eng = _engine(params, batch=2, swap_mode="drain")
    store = eng.store
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, CFG.vocab, size=4).astype(np.int32), gen=6, arrive_s=0.0)
        for i in range(6)]
    sched = Scheduler(reqs)
    eng._t0 = time.perf_counter()
    while eng.in_flight < 2:
        eng.step(sched)
    old_rids = {r.rid for r in eng._slot_req if r is not None}
    new = scale(params, 0.9)
    store.offer(new, step=3, published_at=time.time())
    while len(sched) or eng.in_flight or store.staged:
        eng.step(sched)
    assert store.swaps and store.step == 3
    flip_step = store.swaps[0]["engine_step"]
    for r in reqs:
        assert r.done
        if r.rid in old_rids:
            assert r.weights_step == -1 and r.done_step <= flip_step
            assert r.tokens == _greedy(params, r.prompt, r.gen)[0]
        else:
            assert r.weights_step == 3 and r.admit_step >= flip_step
            assert r.tokens == _greedy(new, r.prompt, r.gen)[0]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_engine_rejects_non_attention_archs(arch):
    cfg = get_config(arch).reduced()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="decoder-only attention") as err:
        ServeEngine(cfg, WeightStore(params))
    jcfg = j_get_config(arch).reduced()
    with pytest.raises(ValueError) as jerr:
        JServeEngine(jcfg, jt.init_params(jcfg, jax.random.PRNGKey(0)))
    assert str(err.value) == str(jerr.value)


def test_engine_rejects_an_unknown_swap_mode(tiny):
    with pytest.raises(ValueError, match="swap_mode 'lazy'"):
        _engine(tiny[1], swap_mode="lazy")


def test_bucket_for_and_overflow(tiny):
    eng = _engine(tiny[1], buckets=(4, 8))
    assert [eng.bucket_for(s) for s in (1, 4, 5, 8)] == [4, 4, 8, 8]
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        eng.bucket_for(9)
    assert _engine(tiny[1], buckets=None).bucket_for(13) == 13


# ------------------------------------------------------------------ #
# weights: the reference's files
# ------------------------------------------------------------------ #
def test_weightstore_poll_flip_on_a_reference_checkpoint(tmp_path, tiny):
    """tests/test_serve.py::test_weightstore_poll_flip, the checkpoints
    written by the JAX package's save_checkpoint."""
    d = str(tmp_path)
    jp, params = tiny
    newer = jax.tree.map(lambda a: a + 1.0, jp)
    store = WeightStore(params, step=2)
    assert store.poll(d) is False          # empty dir: nothing staged
    jckpt.save_checkpoint(d, 2, jp)
    assert store.poll(d) is False          # same step: no reload
    jckpt.save_checkpoint(d, 6, newer)
    active = store.params
    assert store.poll(d) is True and store.staged
    assert store.step == 2 and store.params is active
    assert store.loads == 1 and store.polls == 3
    assert store.flip(at_step=11) is True
    assert store.step == 6 and not store.staged
    assert store.swaps == [{"engine_step": 11, "from": 2, "to": 6}]
    assert store.published_at == ckpt.read_manifest(d)["time"]
    for (path, want) in jax.tree_util.tree_flatten_with_path(newer)[0]:
        got, old = store.params, active
        for k in path:
            got, old = got[k.key], old[k.key]
        assert got.device == old.device and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(old.numpy() + 1.0, np.asarray(want))
    assert store.flip() is False           # nothing staged: no-op
    store.offer(params, step=4, published_at=0.0)
    assert not store.staged                # older step: rejected


def test_weightstore_poll_loads_a_staged_step_once(tmp_path, tiny):
    """A step that waits for its flip (a drain swap with requests in
    flight) is not loaded again at the next polls; a newer one is."""
    d = str(tmp_path)
    jp, params = tiny
    store = WeightStore(params, step=2)
    jckpt.save_checkpoint(d, 6, jax.tree.map(lambda a: a + 1.0, jp))
    assert store.poll(d) is True
    staged = store._spare
    assert store.poll(d) is False and store.poll(d) is False
    assert store.loads == 1 and store._spare is staged and store.step == 2
    jckpt.save_checkpoint(d, 8, jax.tree.map(lambda a: a + 2.0, jp))
    assert store.poll(d) is True and store.loads == 2
    assert store.flip(at_step=5) is True
    assert store.swaps == [{"engine_step": 5, "from": 2, "to": 8}]
    np.testing.assert_array_equal(store.params["embed"].numpy(),
                                  np.asarray(jp["embed"]) + 2.0)
    assert store.poll(d) is False and store.loads == 2


def test_engine_serves_a_reference_checkpoint_like_the_reference(tmp_path,
                                                                  tiny):
    """Both packages' engines start on their own weights and poll one
    directory that the JAX package wrote: after the swap they serve the
    same tokens."""
    jp, params = tiny
    d = str(tmp_path)
    pub = scale(jp, 1.1)
    jckpt.save_checkpoint(d, 5, pub)
    reqs, jreqs = _requests(8, 6), _requests(8, 6, cls=JRequest)
    serve_cache.clear()
    _engine(scale(params, 0.5), poll_every=1, ckpt_dir=d).run(reqs)
    j_serve_cache.clear()
    JServeEngine(JModelConfig(**TINY), jp, batch=4, max_len=32,
                 buckets=(4, 8, 16), poll_every=1, ckpt_dir=d).run(jreqs)
    for r, jr in zip(reqs, jreqs):
        assert r.weights_step == jr.weights_step == 5
        assert r.tokens == jr.tokens


# ------------------------------------------------------------------ #
# the CLI and the publish -> poll -> hot-swap loop
# ------------------------------------------------------------------ #
def test_serve_cli_on_the_cpu():
    """tests/test_serve.py::test_serve_cli_smoke with ``--device cpu``."""
    from repro_torch.launch import serve
    serve_cache.clear()
    out = serve.main(["--arch", "llama3-8b", "--reduced", "--batch", "2",
                      "--requests", "8", "--max-prompt", "6",
                      "--max-gen", "3", "--buckets", "4,8", "--device",
                      "cpu"])
    assert out["mode"] == "serve" and out["arch"] == "llama3-8b-smoke"
    assert out["served"] == 8 and out["swaps"] == 0
    assert 2 <= out["cache"]["entries"] <= 3
    assert out["p50_us"] <= out["p99_us"]
    assert set(out) == {"mode", "arch", "served", "reqs_per_s", "p50_us",
                        "p99_us", "swaps", "cache", "report"}


def test_serve_cli_needs_a_gpu_unless_the_cpu_is_asked_for(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])


def test_publish_serve_hot_swap_e2e(tmp_path):
    """tests/test_serve.py::test_publish_serve_hot_swap_e2e on the port:
    its train.py publishes, its engine serves the first checkpoint, and
    the last is re-published while requests are in flight."""
    from repro_torch.data.objectives import make_lm_problem
    from repro_torch.core.paramvec import ravel
    from repro_torch.launch import serve, train

    pub = str(tmp_path / "pub")
    res = train.main(["--arch", "llama3-8b", "--reduced", "--nodes", "3",
                      "--steps", "12", "--batch-per-node", "2",
                      "--seq", "16", "--scenario", "straggler",
                      "--log-every", "4", "--publish-dir", pub,
                      "--device", "cpu"])
    published = res["published"]
    assert len(published) >= 2
    assert ckpt.read_manifest(pub)["step"] == published[-1]

    cfg = get_config("llama3-8b").reduced()
    template = tt.init_params(cfg, torch.Generator().manual_seed(0))
    trees = {k: ckpt.load_checkpoint(pub, template, step=k)
             for k in published}

    live = str(tmp_path / "live")
    ckpt.save_checkpoint(live, published[0], trees[published[0]])
    store = WeightStore(trees[published[0]], step=published[0])
    serve_cache.clear()
    eng = ServeEngine(cfg, store, batch=4, max_len=48, buckets=(4, 8),
                      swap_mode="drain", poll_every=2, ckpt_dir=live)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=5,
                                               ).astype(np.int32),
                    gen=8, arrive_s=0.0) for i in range(12)]
    sched = Scheduler(reqs)
    eng._t0 = time.perf_counter()
    while eng.in_flight < 4:
        eng.step(sched)
    in_flight_rids = {r.rid for r in eng._slot_req if r is not None}
    ckpt.save_checkpoint(live, published[-1], trees[published[-1]])
    with assert_no_recompiles(expect_entries=0, fresh=False,
                              cache=serve_cache):
        while len(sched) or eng.in_flight or store.staged:
            eng.step(sched)

    assert store.swaps and store.step == published[-1]
    assert all(r.done for r in reqs)
    assert {r.weights_step for r in reqs
            if r.rid in in_flight_rids} == {published[0]}
    assert {r.weights_step for r in reqs} == {published[0], published[-1]}

    # later checkpoints serve strictly lower eval loss
    prob = make_lm_problem(cfg, 3, batch_per_node=2, seq_len=16, seed=0,
                           device="cpu")
    losses = [prob.mean_loss(ravel(prob.spec, trees[k])) for k in published]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses

    # the CLI loads the latest published step before serving
    serve_cache.clear()
    out = serve.main(["--arch", "llama3-8b", "--reduced", "--batch", "2",
                      "--requests", "4", "--max-prompt", "6", "--max-gen",
                      "3", "--publish-dir", pub, "--poll-every", "1",
                      "--device", "cpu"])
    assert out["served"] == 4 and out["swaps"] == 1     # the load itself
    assert {r.weights_step for r in out["report"]["requests"]} == {
        published[-1]}


def test_llama3_8b_is_the_reference_config():
    assert (dataclasses.asdict(get_config("llama3-8b"))
            == dataclasses.asdict(j_get_config("llama3-8b")))
    cfg = get_config("llama3-8b")         # the analytic count has no norms
    assert cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model \
        == 8_030_261_248
