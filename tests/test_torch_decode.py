"""The port's KV-cache decode and prefill against the JAX package's.

Small configs on the CPU, weights from one JAX ``init_params`` tree
carried into the port by ``params_from_jax``: tests/test_serve.py's TINY
GQA decoder, the same with a 6-token window (ring capacity C = 6 < S =
16, so slots are overwritten mid-sequence), and reduced ``rfast-100m``,
``llama3-8b``, ``hymba-1.5b`` (hybrid) and ``falcon-mamba-7b`` (SSM).

* ``prefill_cache`` + ``decode_step``, ``prefill`` (token by token),
  ``prefill_rows`` and ``decode_step_slots`` give JAX's logits and cache
  leaves within 1e-4 of their largest |entry| (fp32 on both sides; only
  the order of sums differs), and equal ``idx`` and ``slot_pos``.
* The port's own teacher-forced check: its incremental logits equal one
  ``forward`` over the whole sequence at tests/test_serve.py's 2e-3.
* ``decode_step_slots``, written as one batched step, equals the
  reference's definition (a ``vmap`` of ``decode_step`` over slots) with
  each slot at its own position, the rings wrapping.
* The layer pieces (``apply_rope`` with a position per row,
  ``gqa_decode``, ``ssm_cache``, ``ssm_decode``) match JAX's at 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import get_config
from repro_torch.kernels.rfast_update import dispatch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig

TINY = dict(name="serve-tiny", n_layers=1, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=64, vocab=64)
TOL = 1e-4         # of the largest |entry|: fp32 on both sides
TF_TOL = 2e-3      # tests/test_serve.py's teacher-forced rtol and atol
LAYER_TOL = 1e-5   # tests/test_torch_model.py's tolerance for one layer
# (case, S, S_prompt): tests/test_serve.py's shapes
CASES = [("tiny", 16, 6), ("tiny-window", 16, 4), ("rfast-100m", 16, 6),
         ("llama3-8b", 16, 6), ("hymba-1.5b", 16, 6),
         ("falcon-mamba-7b", 16, 6)]


def configs(case: str):
    if case.startswith("tiny"):
        kw = dict(TINY, attn_window=6) if case == "tiny-window" else TINY
        return JModelConfig(**kw), ModelConfig(**kw)
    return j_get_config(case).reduced(), get_config(case).reduced()


@functools.cache
def model(case: str):
    """(jcfg, cfg, JAX params, port params) from one JAX tree.  The
    tests never write into the parameters, so one tree serves them all."""
    jcfg, cfg = configs(case)
    jp = jax.jit(lambda k: jt.init_params(jcfg, k))(jax.random.PRNGKey(0))
    params, _ = tt.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jcfg, cfg, jp, params


def rel(got, want) -> float:
    """max |got − want| over max |want|."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def assert_cache_close(cache, jcache, tol=TOL):
    """Float leaves within ``tol`` of their largest |entry| (an all-zero
    leaf exactly), integer leaves equal."""
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             jcache))[0]
    for path, want in flat:
        got = cache
        for k in path:
            got = got[k.key]
        assert tuple(got.shape) == want.shape, path
        if want.dtype.kind == "f":
            if np.max(np.abs(want)) == 0:
                assert not got.any(), path
            else:
                assert rel(got, want) <= tol, (path, rel(got, want))
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


_j_prefill_cache = jax.jit(jt.prefill_cache, static_argnums=(0, 3))
_j_decode_step = jax.jit(jt.decode_step, static_argnums=(0,))
_j_decode_slots = jax.jit(jt.decode_step_slots, static_argnums=(0,))
_j_prefill_rows = jax.jit(jt.prefill_rows, static_argnums=(0, 4))


# ------------------------------------------------------------------ #
# single sequence: prefill_cache + decode_step, prefill
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("case,S,Sp", CASES)
def test_prefill_cache_and_decode_step_match_jax(case, S, Sp):
    jcfg, cfg, jp, params = model(case)
    toks = tokens(cfg, (2, S))
    jcache, jl = _j_prefill_cache(jcfg, jp, jnp.asarray(toks[:, :Sp]), S)
    cache, logits = tt.prefill_cache(cfg, params,
                                     torch.from_numpy(toks[:, :Sp]), S)
    assert tuple(logits.shape) == (2, 1, cfg.vocab)
    assert rel(logits, jl) <= TOL
    assert_cache_close(cache, jcache)
    for t in range(Sp, S):
        jl, jcache = _j_decode_step(jcfg, jp, jcache,
                                    jnp.asarray(toks[:, t:t + 1]))
        logits, cache = tt.decode_step(cfg, params, cache,
                                       torch.from_numpy(toks[:, t:t + 1]))
        assert rel(logits, jl) <= TOL, (case, t)
    assert_cache_close(cache, jcache)
    if case == "tiny-window":        # the ring wrapped: C 6 < S 16
        assert cache["slot_pos"].tolist() == [12, 13, 14, 15, 10, 11]


@pytest.mark.parametrize("case,S,Sp", CASES)
def test_teacher_forced_decode_matches_forward(case, S, Sp):
    """tests/test_serve.py::_teacher_forced_check on the port alone."""
    _, cfg, _, params = model(case)
    toks = torch.from_numpy(tokens(cfg, (2, S), seed=1))
    ref = tt.forward(cfg, params, toks)[0]
    cache, logits = tt.prefill_cache(cfg, params, toks[:, :Sp], S)
    np.testing.assert_allclose(logits[:, 0], ref[:, Sp - 1], rtol=TF_TOL,
                               atol=TF_TOL)
    for t in range(Sp, S):
        logits, cache = tt.decode_step(cfg, params, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(
            logits[:, 0], ref[:, t], rtol=TF_TOL, atol=TF_TOL,
            err_msg=f"{cfg.name}: decode position {t}")


@pytest.mark.parametrize("case", ["tiny-window", "rfast-100m",
                                  "hymba-1.5b", "falcon-mamba-7b"])
def test_token_by_token_prefill_matches_jax(case):
    jcfg, cfg, jp, params = model(case)
    toks = tokens(cfg, (2, 9), seed=2)
    jcache, jl = jax.jit(jt.prefill, static_argnums=(0,))(
        jcfg, jp, jt.init_cache(jcfg, jp, 2, 12), jnp.asarray(toks))
    cache, logits = tt.prefill(cfg, params,
                               tt.init_cache(cfg, params, 2, 12),
                               torch.from_numpy(toks))
    assert tuple(logits.shape) == (2, 9, cfg.vocab)
    assert rel(logits, jl) <= TOL
    assert_cache_close(cache, jcache)
    # and it fills the cache that one batched prefill fills
    batched, last = tt.prefill_cache(cfg, params, torch.from_numpy(toks), 12)
    assert rel(logits[:, -1:], last) <= TOL
    assert_cache_close(batched, jcache)


@pytest.mark.parametrize("case", [c for c, _, _ in CASES])
def test_init_cache_layout_matches_jax(case):
    jcfg, cfg, jp, params = model(case)
    jc = jt.init_cache(jcfg, jp, 3, 10)
    c = tt.init_cache(cfg, params, 3, 10)
    assert tt.cache_capacity(cfg, 10) == jt.cache_capacity(jcfg, 10)
    assert_cache_close(c, jc)
    leaves = jax.tree_util.tree_flatten_with_path(jc)[0]
    for path, want in leaves:
        got = c
        for k in path:
            got = got[k.key]
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    if case == "tiny-window":                   # C = window < max_len
        assert c["layers"]["attn"]["k"].shape[:3] == (cfg.n_layers, 3, 6)


# ------------------------------------------------------------------ #
# continuous batching: prefill_rows, decode_step_slots
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("case,Sb,true_len,C", [
    ("tiny", 8, 5, 16),            # true_len < Sb, C > Sb
    ("rfast-100m", 8, 3, 8),       # true_len < Sb = C
    ("rfast-100m", 8, 7, 4),       # true_len > C: the ring keeps the tail
    ("tiny-window", 16, 16, 6),    # a full bucket through a windowed ring
])
def test_prefill_rows_matches_jax(case, Sb, true_len, C):
    jcfg, cfg, jp, params = model(case)
    toks = tokens(cfg, (1, Sb), seed=3)
    toks[:, true_len:] = 0                      # the bucket's padding
    jring, jsp, jl = _j_prefill_rows(jcfg, jp, jnp.asarray(toks),
                                     jnp.int32(true_len), C)
    ring, sp, logits = tt.prefill_rows(cfg, params, torch.from_numpy(toks),
                                       true_len, C)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    assert sp.dtype == torch.int32
    assert rel(logits, jl) <= TOL
    assert_cache_close(ring, jring)
    # slot c holds position p_c = q − ((q − c) mod C), q = true_len − 1
    q = true_len - 1
    want = [q - ((q - c) % C) for c in range(C)]
    assert sp.tolist() == [p if p >= 0 else -1 for p in want]
    # the valid rows are an unpadded prefill's: padding is inert
    cache, last = tt.prefill_cache(
        cfg, params, torch.from_numpy(toks[:, :true_len]), C)
    assert rel(logits, last[:, 0]) <= TOL
    assert_cache_close(ring, {"attn": {k: v.numpy() for k, v in
                                       cache["layers"]["attn"].items()}})


@pytest.mark.parametrize("case", ["hymba-1.5b", "falcon-mamba-7b"])
def test_prefill_rows_refuses_non_attention_mixers(case):
    jcfg, cfg, jp, params = model(case)
    toks = tokens(cfg, (1, 8))
    with pytest.raises(ValueError) as jerr:
        jt.prefill_rows(jcfg, jp, jnp.asarray(toks), 5, 8)
    with pytest.raises(ValueError) as err:
        tt.prefill_rows(cfg, params, torch.from_numpy(toks), 5, 8)
    assert str(err.value).replace(cfg.name, "") == \
        str(jerr.value).replace(jcfg.name, "")
    assert "an SSM carry absorbs the pad tail" in str(err.value)


def slot_state(cfg, B: int, C: int, idx: list[int], seed: int):
    """A serving cache with random ring rows, slot b at position idx[b]
    with its ring holding the positions before it (numpy leaves)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, C, cfg.n_kv_heads, cfg.hd)
    sp = np.full((B, C), -1, np.int32)
    for b, n in enumerate(idx):
        for p in range(max(0, n - C), n):
            sp[b, p % C] = p
    return {"idx": np.asarray(idx, np.int32), "slot_pos": sp,
            "layers": {"attn": {
                "k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}}}


@pytest.mark.parametrize("case,C", [("tiny", 6), ("tiny-window", 6),
                                    ("rfast-100m", 8), ("llama3-8b", 5)])
def test_decode_step_slots_matches_jax(case, C):
    """Three slots at positions 0, 3 and 11 (its ring already wrapped),
    seven steps: the rings wrap mid-run, every slot at its own depth."""
    jcfg, cfg, jp, params = model(case)
    state = slot_state(cfg, 3, C, [0, 3, 11], seed=4)
    jcache = jax.tree.map(jnp.asarray, state)
    cache = jax.tree.map(lambda a: torch.from_numpy(a.copy()), state)
    toks = tokens(cfg, (7, 3, 1), seed=5)
    for t in range(7):
        jl, jcache = _j_decode_slots(jcfg, jp, jcache, jnp.asarray(toks[t]))
        logits, cache = tt.decode_step_slots(cfg, params, cache,
                                             torch.from_numpy(toks[t]))
        assert tuple(logits.shape) == (3, 1, cfg.vocab)
        assert rel(logits, jl) <= TOL, (case, t)
    assert_cache_close(cache, jcache)
    assert cache["idx"].tolist() == [7, 10, 18]


def test_decode_step_slots_is_decode_step_per_slot():
    """The reference's definition, on the port alone: slot b's logits and
    cache row are decode_step's on that slot's row (B = 1)."""
    _, cfg, _, params = model("rfast-100m")
    state = slot_state(cfg, 3, 8, [2, 9, 5], seed=6)
    toks = torch.from_numpy(tokens(cfg, (3, 1), seed=7))
    one = [{"idx": torch.tensor(state["idx"][b]),
            "slot_pos": torch.from_numpy(state["slot_pos"][b].copy()),
            "layers": {"attn": {k: torch.from_numpy(v[:, b:b + 1].copy())
                                for k, v in state["layers"]["attn"].items()}}}
           for b in range(3)]
    logits, cache = tt.decode_step_slots(
        cfg, params, jax.tree.map(torch.from_numpy, state), toks)
    for b in range(3):
        lb, cb = tt.decode_step(cfg, params, one[b], toks[b:b + 1])
        assert rel(logits[b:b + 1], lb) <= TOL
        assert torch.equal(cache["slot_pos"][b], cb["slot_pos"])
        assert int(cache["idx"][b]) == int(cb["idx"])
        for k in ("k", "v"):
            assert rel(cache["layers"]["attn"][k][:, b:b + 1],
                       cb["layers"]["attn"][k]) <= TOL


def test_decode_step_slots_rejects_enc_dec():
    cfg = dataclasses.replace(ModelConfig(**TINY), enc_dec=True,
                              n_enc_layers=1)
    with pytest.raises(ValueError, match="enc-dec"):
        tt.decode_step_slots(cfg, {}, {}, None)


# ------------------------------------------------------------------ #
# layer pieces
# ------------------------------------------------------------------ #
def test_apply_rope_with_a_position_per_row_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    pos = np.array([0, 7, 130], np.int32)
    jcos, jsin = jlayers.rope_cos_sin(jnp.asarray(pos), 16, 500_000.0)
    want = jlayers.apply_rope(jnp.asarray(x), jcos[:, None], jsin[:, None])
    cos, sin = tlayers.rope_cos_sin(torch.from_numpy(pos), 16, 500_000.0)
    got = tlayers.apply_rope(torch.from_numpy(x), cos[:, None], sin[:, None])
    assert rel(got, want) <= LAYER_TOL
    # a row's rotation is the (S, D/2) branch's at that row's position
    for b in range(3):
        one = tlayers.apply_rope(torch.from_numpy(x[b:b + 1]),
                                 cos[b:b + 1], sin[b:b + 1])
        assert torch.equal(one, got[b:b + 1])


def test_gqa_decode_matches_jax_per_row():
    """The reference's single-sequence gqa_decode at each row's position
    against the port's one call with a position per row."""
    jcfg, cfg, jp, params = model("tiny-window")
    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    jlp = {k: v[0] for k, v in jp["layers"]["attn"].items()}
    st = slot_state(cfg, 2, 6, [4, 13], seed=9)
    x = np.random.default_rng(10).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32)
    pos = torch.from_numpy(st["idx"])
    sp = torch.from_numpy(st["slot_pos"])
    sp[torch.arange(2), pos % 6] = pos
    cache = {k: torch.from_numpy(v[0].copy()) for k, v in
             st["layers"]["attn"].items()}
    out, cache = tattn.gqa_decode(cfg, lp, torch.from_numpy(x), cache, pos,
                                  sp, window=cfg.attn_window)
    for b in range(2):
        jout, jc = jattn.gqa_decode(
            jcfg, jlp, jnp.asarray(x[b:b + 1]),
            {k: jnp.asarray(v[0, b:b + 1]) for k, v in
             st["layers"]["attn"].items()},
            jnp.int32(st["idx"][b]), jnp.asarray(sp[b].numpy()),
            window=jcfg.attn_window)
        assert rel(out[b:b + 1], jout) <= LAYER_TOL
        for k in ("k", "v"):
            assert rel(cache[k][b:b + 1], jc[k]) <= LAYER_TOL


@pytest.mark.parametrize("case", ["hymba-1.5b", "falcon-mamba-7b"])
def test_ssm_cache_and_decode_match_jax(case):
    jcfg, cfg, jp, params = model(case)
    jc = jssm.ssm_cache(jcfg, 2, jnp.float32)
    c = tssm.ssm_cache(cfg, 2, torch.float32)
    for k in ("conv", "h"):
        assert tuple(c[k].shape) == jc[k].shape and not c[k].any()
        assert str(c[k].dtype).removeprefix("torch.") == str(jc[k].dtype)
    assert c["h"].dtype == torch.float32
    lp = {k: v[0] for k, v in params["layers"]["ssm"].items()}
    jlp = {k: v[0] for k, v in jp["layers"]["ssm"].items()}
    rng = np.random.default_rng(11)
    state = {"conv": rng.standard_normal(c["conv"].shape).astype(np.float32),
             "h": rng.standard_normal(c["h"].shape).astype(np.float32)}
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy, jnew = jssm.ssm_decode(jcfg, jlp, jnp.asarray(x),
                               jax.tree.map(jnp.asarray, state))
    y, new = tssm.ssm_decode(cfg, lp, torch.from_numpy(x),
                             jax.tree.map(torch.from_numpy, state))
    assert rel(y, jy) <= LAYER_TOL
    for k in ("conv", "h"):
        assert rel(new[k], jnew[k]) <= LAYER_TOL
    # one decode step from the prefill state is the full-sequence block
    seq = torch.from_numpy(rng.standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32))
    full = tssm.ssm_apply(cfg, lp, seq)
    _, st = tssm.ssm_apply(cfg, lp, seq[:, :4], return_state=True)
    y5, _ = tssm.ssm_decode(cfg, lp, seq[:, 4:], st)
    assert rel(y5, full[:, 4:]) <= LAYER_TOL


def test_ssm_prefill_runs_the_scan_wrapper_and_decode_does_not(monkeypatch):
    """prefill_cache calls the kernel wrapper once per SSM layer (and it
    returns h_last); a decode step takes its one step in PyTorch ops."""
    _, cfg, _, params = model("hymba-1.5b")
    import repro_torch.kernels.ssm_scan.ops as ops
    calls = []
    real = ops.ssm_scan

    def counting(*a, **kw):
        calls.append((tuple(a[0].shape), kw.get("ckpt_every")))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "ssm_scan", counting)
    dispatch.clear()
    toks = torch.from_numpy(tokens(cfg, (2, 7)))
    cache, _ = tt.prefill_cache(cfg, params, toks, 10)
    assert calls == [((2, 7, cfg.d_inner), None)] * cfg.n_layers
    tt.decode_step(cfg, params, cache, toks[:, :1])
    assert len(calls) == cfg.n_layers
    assert dispatch.launches("ssm_scan") == 0       # CPU: the plain twin


def test_decode_rejects_what_is_not_ported():
    """Nothing of the decode path is left unported: each variant that
    raised before the enc-dec and frontend archs were ported (enc-dec,
    a frontend, absolute positions, the GELU MLP, MLP biases) inits a
    cache (the encoder's over a frontend), prefills and decodes a step
    within 1e-4 of JAX's."""
    rng = np.random.default_rng(11)
    toks = tokens(ModelConfig(**TINY), (2, 4), seed=12)
    for var in (dict(enc_dec=True, n_enc_layers=1, use_rope=False,
                     frontend="audio", frontend_seq=5, frontend_dim=16),
                dict(frontend="vision", frontend_seq=4, frontend_dim=16),
                dict(use_rope=False),
                dict(mlp="gelu"),
                dict(mlp_bias=True)):
        kw = dict(TINY, **var)
        jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
        jp = jt.init_params(jcfg, jax.random.PRNGKey(1))
        params, _ = tt.params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")
        front = (rng.standard_normal((2, cfg.frontend_seq, 16))
                 .astype(np.float32) if cfg.frontend else None)
        jcache = jt.init_cache(jcfg, jp, 2, 8, frontend=None if front is None
                               else jnp.asarray(front))
        cache = tt.init_cache(cfg, params, 2, 8, frontend=None
                              if front is None else torch.from_numpy(front))
        jcache, jl = jt.prefill(jcfg, jp, jcache, jnp.asarray(toks[:, :3]))
        cache, logits = tt.prefill(cfg, params, cache,
                                   torch.from_numpy(toks[:, :3]))
        assert rel(logits, jl) <= TOL, var
        jl, jcache = jt.decode_step(jcfg, jp, jcache,
                                    jnp.asarray(toks[:, 3:]))
        logits, cache = tt.decode_step(cfg, params, cache,
                                       torch.from_numpy(toks[:, 3:]))
        assert rel(logits, jl) <= TOL, var
        assert_cache_close(cache, jcache)


def test_cpu_init_draws_are_unchanged():
    """Drawing on the generator's device keeps the CPU's numbers: the
    weights are ``randn · scale`` from the same generator as before."""
    g = torch.Generator().manual_seed(5)
    w = tlayers.dense_init(g, 6, 4, lead=(2,))
    want = torch.randn(2, 6, 4, generator=torch.Generator().manual_seed(5))
    assert w.device.type == "cpu" and torch.equal(w, want * 6 ** -0.5)
    cfg = get_config("rfast-100m").reduced()
    p = tt.init_params(cfg, torch.Generator().manual_seed(0))
    g0 = torch.Generator().manual_seed(0)
    assert torch.equal(p["embed"],
                       torch.randn(cfg.vocab, cfg.d_model, generator=g0)
                       * 0.02)
