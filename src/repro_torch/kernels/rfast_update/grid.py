"""Fused R-FAST wave commit: one kernel launch per wave.

Counterpart of ``src/repro/kernels/rfast_update/grid.py::commit_grid``,
with the same signature (less the ``mode``), the same clamping of the
five row tables and the same output dtypes.  The lane tables of one wave
become flat-row gather indices into the packed state
(``nodes.reshape(n·4, p)``, ``rho_hist.reshape(H·E, p)``, ``rho2``), so
no per-lane neighbour stacks are materialized and one launch commits
the whole wave.

Commit math per lane b (identical to :func:`.ref.rfast_commit_ref`):

  recv    = Σ_k mask[b,k] · (ri[b,k] − rb[b,k])
  z_half  = z[b] + recv + g_new[b] − g_old[b]
  z'      = a_self[b] · z_half
  ρ_out'  [k] = ro[b,k] + a_out[b,k] · z_half
  ρ̃'     [k] = mask[b,k] · ri[b,k] + (1 − mask[b,k]) · rb[b,k]

Where it runs follows from the tensors: on CUDA tensors
:func:`commit_grid` launches the hand-written Hopper kernel
(``csrc/commit_grid.cu``) or raises; on CPU tensors it runs
:func:`commit_grid_plain`, the PyTorch twin of the JAX package's
``_emulate``.  Nothing falls back from one to the other.  On meta
tensors it runs neither: it returns empty meta outputs and notes the
launch's operations and bytes for the dry-run (:mod:`..meta`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from .. import meta
from . import dispatch

__all__ = ["commit_grid", "commit_grid_plain", "commit_grid_bytes",
           "commit_grid_flops", "KERNEL_SOURCE"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "commit_grid.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .._build import load
        lib = load(KERNEL_SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.commit_grid_launch.argtypes = (
            [i32] + [vp] * 17 + [i64, i32, i32, i32] + [i64] * 5 + [vp])
        lib.commit_grid_launch.restype = i32
        lib.commit_grid_max_k.argtypes = []
        lib.commit_grid_max_k.restype = i32
        _lib = lib
    return _lib


def _as_tensor(a, device, dtype):
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return torch.as_tensor(a, device=device).to(dtype).contiguous()


def commit_grid_plain(idx_z, idx_g, idx_ri, idx_rb, idx_ro,
                      a_self, mask, a_out,
                      z_src, g_new, go_src, ri_src, rb_src, ro_src):
    """Plain PyTorch version of the commit: the same clamped flat-row
    gathers and blend math as the kernel, with fp32 accumulation over
    the small k axis.  Runs on whatever device the sources lie on."""
    dev = z_src.device
    rows = lambda idx, src: _as_tensor(idx, dev, torch.int64).clamp(
        0, src.shape[0] - 1)
    f32 = torch.float32
    z = z_src[rows(idx_z, z_src)].to(f32)                # (B, Pf)
    go = go_src[rows(idx_g, go_src)].to(f32)
    ri = ri_src[rows(idx_ri, ri_src)].to(f32)            # (B, ka, Pf)
    rb = rb_src[rows(idx_rb, rb_src)].to(f32)
    ro = ro_src[rows(idx_ro, ro_src)].to(f32)
    m = _as_tensor(mask, dev, f32)[..., None]
    recv = torch.sum(m * (ri - rb), dim=1)
    z_half = z + recv + g_new.to(f32) - go
    z_o = (_as_tensor(a_self, dev, f32)[:, None] * z_half).to(z_src.dtype)
    ro_o = (ro + _as_tensor(a_out, dev, f32)[..., None]
            * z_half[:, None]).to(ro_src.dtype)
    rb_o = (m * ri + (1.0 - m) * rb).to(rb_src.dtype)
    return z_o, ro_o, rb_o


def commit_grid_bytes(B: int, ka: int, ko: int, Pf: int,
                      itemsize: int) -> int:
    """Bytes one launch must move: each lane reads 3 + 2·ka + ko source
    rows and writes 1 + ka + ko output rows of ``Pf`` elements."""
    return B * (4 + 3 * ka + 2 * ko) * Pf * itemsize


def commit_grid_flops(B: int, ka: int, ko: int, Pf: int) -> int:
    """fp32 operations of one launch: per lane and element, 4 per
    in-slot (recv's multiply-add and difference, the ρ̃ blend's), 2 per
    out-slot (ρ_out's multiply-add) and 4 for z½ and z'."""
    return B * Pf * (4 * ka + 2 * ko + 4)


def _commit_grid_meta(idx_ri, idx_ro, z_src, ro_src, rb_src):
    if z_src.dtype not in _DTYPE_CODE:
        raise TypeError(f"commit_grid kernel takes float32 or bfloat16 "
                        f"sources, got {z_src.dtype}")
    B, ka = (int(d) for d in idx_ri.shape)
    ko = int(idx_ro.shape[1])
    Pf = z_src.shape[1]
    meta.note("commit_grid", flops=commit_grid_flops(B, ka, ko, Pf),
              nbytes=commit_grid_bytes(B, ka, ko, Pf,
                                       z_src.element_size()))
    new = lambda shape, like: torch.empty(shape, dtype=like.dtype,
                                          device="meta")
    return (new((B, Pf), z_src), new((B, ko, Pf), ro_src),
            new((B, ka, Pf), rb_src))


def commit_grid(idx_z, idx_g, idx_ri, idx_rb, idx_ro,
                a_self, mask, a_out,
                z_src, g_new, go_src, ri_src, rb_src, ro_src):
    """One fused commit over B lanes gathered from flat source arrays.

    Args:
      idx_z / idx_g: (B,) int rows of ``z_src`` / ``go_src``.
      idx_ri: (B, ka) int rows of ``ri_src`` (delivered ρ payloads).
      idx_rb: (B, ka) int rows of ``rb_src`` (receiver ρ̃ buffers).
      idx_ro: (B, ko) int rows of ``ro_src`` (sender ρ running sums).
      a_self: (B,); mask: (B, ka) 0/1; a_out: (B, ko) floats.
      z_src/go_src/ri_src/rb_src/ro_src: (rows, Pf) flat sources —
        aliasing is fine (the engine passes one array several times).
      g_new: (B, Pf) — each lane's fresh gradient, indexed by lane.

    Returns ``(z' (B, Pf), rho_out' (B, ko, Pf), rho_buf' (B, ka, Pf))``
    in the respective source dtypes.  Every index is clamped into its
    source's row range (drop-sentinel lanes must be discarded by the
    caller).  On CUDA sources the Hopper kernel runs (fp32 or bf16, one
    dtype for every source); on CPU sources, :func:`commit_grid_plain`;
    on meta sources nothing runs (:func:`_commit_grid_meta`).
    """
    if z_src.device.type == "meta":
        return _commit_grid_meta(idx_ri, idx_ro, z_src, ro_src, rb_src)
    if z_src.device.type == "cpu":
        return commit_grid_plain(idx_z, idx_g, idx_ri, idx_rb, idx_ro,
                                 a_self, mask, a_out, z_src, g_new, go_src,
                                 ri_src, rb_src, ro_src)
    if z_src.device.type != "cuda":
        raise ValueError(f"commit_grid runs on cuda or cpu tensors, got "
                         f"{z_src.device}")
    dev = z_src.device
    srcs = (z_src, g_new, go_src, ri_src, rb_src, ro_src)
    dt = z_src.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"commit_grid kernel takes float32 or bfloat16 "
                        f"sources, got {dt}")
    for s in srcs:
        if s.device != dev or s.dtype != dt or s.dim() != 2 \
                or not s.is_contiguous():
            raise ValueError("commit_grid kernel needs contiguous 2-D "
                             f"sources of one dtype on {dev}; got "
                             f"{tuple(s.shape)} {s.dtype} on {s.device}")
    i32, f32 = torch.int32, torch.float32
    idx_z, idx_g = _as_tensor(idx_z, dev, i32), _as_tensor(idx_g, dev, i32)
    idx_ri, idx_rb = _as_tensor(idx_ri, dev, i32), _as_tensor(idx_rb, dev, i32)
    idx_ro = _as_tensor(idx_ro, dev, i32)
    a_self, mask = _as_tensor(a_self, dev, f32), _as_tensor(mask, dev, f32)
    a_out = _as_tensor(a_out, dev, f32)
    B, ka = idx_ri.shape
    ko = idx_ro.shape[1]
    Pf = z_src.shape[1]
    if g_new.shape != (B, Pf) or any(s.shape[1] != Pf for s in srcs):
        raise ValueError(f"commit_grid: g_new must be ({B}, {Pf}) and every "
                         f"source {Pf} wide")
    if (idx_z.shape != (B,) or idx_g.shape != (B,) or idx_rb.shape != (B, ka)
            or a_self.shape != (B,) or mask.shape != (B, ka)
            or a_out.shape != (B, ko)):
        raise ValueError("commit_grid: inconsistent lane-table shapes")
    z_o = torch.empty((B, Pf), dtype=dt, device=dev)
    ro_o = torch.empty((B, ko, Pf), dtype=dt, device=dev)
    rb_o = torch.empty((B, ka, Pf), dtype=dt, device=dev)
    if B == 0 or Pf == 0:
        return z_o, ro_o, rb_o
    lib = _library()
    if ka > lib.commit_grid_max_k() or ko > lib.commit_grid_max_k() \
            or B > 65535:
        raise ValueError(f"commit_grid kernel takes ka, ko <= "
                         f"{lib.commit_grid_max_k()} and B <= 65535; got "
                         f"ka={ka} ko={ko} B={B}")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.commit_grid_launch(
        _DTYPE_CODE[dt], ptr(idx_z), ptr(idx_g), ptr(idx_ri), ptr(idx_rb),
        ptr(idx_ro), ptr(a_self), ptr(mask), ptr(a_out),
        *(ptr(s) for s in srcs), ptr(z_o), ptr(ro_o), ptr(rb_o),
        Pf, B, ka, ko, *(s.shape[0] for s in (z_src, go_src, ri_src,
                                              rb_src, ro_src)),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"commit_grid kernel launch failed: CUDA error "
                           f"{err}")
    dispatch.record_launch("commit_grid")
    return z_o, ro_o, rb_o
