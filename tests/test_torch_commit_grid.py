"""Port commit_grid (plain version on CPU tensors) vs the JAX commit_grid.

The cases are those of tests/test_kernels.py (ragged widths, one full
Pallas block, sentinel clamping, bf16 sources), made with numpy and fed
to both packages.  JAX runs its kernel in the Pallas interpreter where
the width tiles into blocks (P = 32768) and its emulation twin
otherwise, as tests/test_kernels.py does.  Tolerance 1e-5, that test's
own; bf16 outputs are compared in bf16 (both sides accumulate in fp32
and round once).  The CUDA kernel itself is held to this plain version
on the card by chip_smoke.py and tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rfast_update.grid import commit_grid as jax_commit_grid
from repro_torch.kernels.rfast_update import dispatch
from repro_torch.kernels.rfast_update.grid import (commit_grid,
                                                   commit_grid_bytes)
from repro_torch.kernels.rfast_update.ref import rfast_commit_ref

SRC = ("z_src", "g_new", "go_src", "ri_src", "rb_src", "ro_src")


def _case(P, B=5, Ka=3, Ko=2, seed=0):
    """numpy sources, gather tables and lane floats (test_kernels'
    _grid_case layout)."""
    r = np.random.default_rng(seed)
    a = lambda *s: r.normal(0, 1, s).astype(np.float32)
    Nz, Nri, Nr = B * 4, 40, 16
    kw = dict(z_src=a(Nz, P), g_new=a(B, P), go_src=a(Nz, P),
              ri_src=a(Nri, P), rb_src=a(Nr, P), ro_src=a(Nr, P),
              idx_z=r.integers(0, Nz, B).astype(np.int32),
              idx_g=r.integers(0, Nz, B).astype(np.int32),
              idx_ri=r.integers(0, Nri, (B, Ka)).astype(np.int32),
              idx_rb=r.integers(0, Nr, (B, Ka)).astype(np.int32),
              idx_ro=r.integers(0, Nr, (B, Ko)).astype(np.int32),
              a_self=a(B), mask=r.integers(0, 2, (B, Ka)).astype(np.float32),
              a_out=a(B, Ko))
    return kw


def _both(kw, mode, dtype):
    jd, td = {jnp.float32: (jnp.float32, torch.float32),
              jnp.bfloat16: (jnp.bfloat16, torch.bfloat16)}[dtype]
    jkw = {k: jnp.asarray(v, jd if k in SRC else None)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v).to(td) if k in SRC
               else torch.from_numpy(v)) for k, v in kw.items()}
    want = jax_commit_grid(mode=mode, **jkw)
    dispatch.clear()
    got = commit_grid(**tkw)
    assert dispatch.stats()["launches"] == 0      # CPU: plain, no launch
    return got, want


@pytest.mark.parametrize("P,mode", [(37, "emulate"), (1000, "emulate"),
                                    (32768, "interpret"),
                                    (32768, "emulate"),
                                    (100_001, "emulate")])
def test_commit_grid_matches_jax(P, mode):
    got, want = _both(_case(P), mode, jnp.float32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P", [37, 1000])
def test_commit_grid_matches_jax_bf16(P):
    got, want = _both(_case(P), "emulate", jnp.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=1e-5, atol=1e-5)


def test_commit_grid_matches_per_lane_ref():
    kw = _case(1000)
    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    z_o, ro_o, rb_o = commit_grid(**t)
    for b in range(5):
        zr, ror, rbr = rfast_commit_ref(
            t["z_src"][t["idx_z"][b]], t["g_new"][b],
            t["go_src"][t["idx_g"][b]], t["ri_src"][t["idx_ri"][b].long()],
            t["rb_src"][t["idx_rb"][b].long()], t["mask"][b],
            t["ro_src"][t["idx_ro"][b].long()], t["a_out"][b],
            a_self=t["a_self"][b])
        for g, w in ((z_o[b], zr), (ro_o[b], ror), (rb_o[b], rbr)):
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_commit_grid_clamps_sentinel_rows():
    """Out-of-range (drop-sentinel) rows clamp as in JAX; a zero mask
    makes the clamped reads inert in z'."""
    kw = _case(256)
    kw["idx_ri"] = np.full_like(kw["idx_ri"], 10_000)
    kw["idx_ro"] = np.full_like(kw["idx_ro"], -3)
    kw["mask"] = np.zeros_like(kw["mask"])
    got, want = _both(kw, "emulate", jnp.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    z = kw["a_self"][:, None] * (kw["z_src"][kw["idx_z"]] + kw["g_new"]
                                 - kw["go_src"][kw["idx_g"]])
    np.testing.assert_allclose(got[0].numpy(), z, rtol=1e-6, atol=1e-6)


def test_commit_grid_rejects_other_devices_and_counts_bytes():
    kw = {k: torch.from_numpy(v) for k, v in _case(37).items()}
    kw = {k: (v.to("meta") if k in SRC else v) for k, v in kw.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        commit_grid(**kw)
    # per lane: reads 3 + 2·ka + ko rows, writes 1 + ka + ko rows
    assert commit_grid_bytes(3, 2, 1, 10, 4) == 3 * (4 + 6 + 2) * 10 * 4

