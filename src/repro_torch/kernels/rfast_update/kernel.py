"""The per-node R-FAST update and commit kernels and their plain twins.

Counterparts of ``src/repro/kernels/rfast_update/kernel.py``:

* :func:`rfast_update_node` — ``rfast_update_pallas`` (body ``_kernel``),
  the full fused update of one node: returns ``(x', v, z', ρ_out', ρ̃')``;
* :func:`rfast_commit_node` — ``rfast_commit_pallas`` (body
  ``_commit_kernel``), its S.2b–S.4 tail: returns ``(z', ρ_out', ρ̃')``.

Math per parameter element (``ref.py`` holds the oracle)::

  v       = x − γ z
  x'      = w_self · v + Σ_k w_in[k] · v_in[k]
  recv    = Σ_k mask[k] · (ρ_in[k] − ρ̃[k])
  z_half  = z + recv + g_new − g_old
  z'      = a_self · z_half
  ρ_out'[k] = ρ_out[k] + a_out[k] · z_half
  ρ̃'[k]  = mask[k] · ρ_in[k] + (1 − mask[k]) · ρ̃[k]

Flat operands: ``x``/``z``/``g_*`` are ``(P,)``, the neighbour stacks
``(K, P)``.  The TPU kernels took them padded to ``(R, 128)`` blocks; the
CUDA kernel (``csrc/rfast_node.cu``) masks its ragged tail, so nothing is
padded.  Every source must have one dtype (float32 or bfloat16 on the
card); the outputs take it.  The slot weights and the scalars may be
device tensors, so a mask computed on the card costs no host sync.

Where it runs follows from the tensors: on CUDA tensors a wrapper
launches the kernel or raises; on CPU tensors it runs its plain twin
(:func:`rfast_update_node_plain`, :func:`rfast_commit_node_plain`), which
repeats the kernel's fp32 arithmetic in PyTorch.  Nothing falls back from
one to the other.  On meta tensors neither runs: a wrapper returns empty
meta outputs and notes the launch's operations and bytes for the
dry-run (:mod:`..meta`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import meta
from . import dispatch

__all__ = ["rfast_update_node", "rfast_commit_node",
           "rfast_update_node_plain", "rfast_commit_node_plain",
           "rfast_update_node_bytes", "rfast_commit_node_bytes",
           "node_flops", "one_dtype", "KERNEL_SOURCE"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "rfast_node.cu"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .._build import load
        lib = load(KERNEL_SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rfast_update_node_launch.argtypes = (
            [i32] + [vp] * 17 + [i64, i32, i32, i32, vp])
        lib.rfast_update_node_launch.restype = i32
        lib.rfast_commit_node_launch.argtypes = (
            [i32] + [vp] * 12 + [i64, i32, i32, vp])
        lib.rfast_commit_node_launch.restype = i32
        lib.rfast_node_max_k.argtypes = []
        lib.rfast_node_max_k.restype = i32
        _lib = lib
    return _lib


def rfast_update_node_bytes(kw: int, ka: int, ko: int, P: int,
                            itemsize: int) -> int:
    """Bytes the full update must move: 4 + Kw + 2·Ka + Ko source rows
    read and 3 + Ka + Ko output rows written, of ``P`` elements."""
    return (7 + kw + 3 * ka + 2 * ko) * P * itemsize


def rfast_commit_node_bytes(ka: int, ko: int, P: int, itemsize: int) -> int:
    """Bytes the commit must move: 3 + 2·Ka + Ko rows read, 1 + Ka + Ko
    written."""
    return (4 + 3 * ka + 2 * ko) * P * itemsize


def node_flops(kw: int, ka: int, ko: int, *, full: bool) -> int:
    """fp32 operations per element: recv and the ρ̃ blend 7 per in-slot,
    z½ and z' 4, ρ_out 2 per out-slot; the full update adds v (2), the
    self weight (1) and 2 per consensus slot."""
    return 7 * ka + 4 + 2 * ko + (3 + 2 * kw if full else 0)


def _empty_like(*ts):
    return tuple(torch.empty_like(t) for t in ts)


def one_dtype(name: str, sources) -> torch.dtype:
    """The one dtype of ``sources``; raises ``ValueError`` on a mix."""
    dt = sources[0].dtype
    for s in sources:
        if s.dtype != dt:
            raise ValueError(f"{name}: every source must have one dtype; "
                             f"got {sorted({str(t.dtype) for t in sources})}")
    return dt


def _weights(w, dev) -> torch.Tensor:
    """Slot weights as a contiguous float32 vector on ``dev``."""
    return torch.as_tensor(w, dtype=torch.float32, device=dev).reshape(-1) \
        .contiguous()


def _scalars(vals, dev) -> torch.Tensor:
    """Per-node scalars (floats or 0-d tensors) as one float32 vector."""
    if all(isinstance(v, (int, float)) for v in vals):
        return torch.tensor(vals, dtype=torch.float32, device=dev)
    return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=dev).reshape(())
                        for v in vals])


def _check_shapes(name, P, stacks):
    for what, t, k in stacks:
        if t.dim() != 2 or t.shape[1] != P or (k is not None
                                               and t.shape[0] != k):
            raise ValueError(f"{name}: {what} must be ({k or 'K'}, {P}); "
                             f"got {tuple(t.shape)}")


def rfast_commit_node_plain(z, g_new, g_old, rho_in, rho_buf, mask, rho_out,
                            a_out, *, a_self):
    """Plain PyTorch twin of the commit kernel: the same fp32 arithmetic,
    in the same order, on whatever device the sources lie on."""
    f32 = torch.float32
    dev, dt = z.device, z.dtype
    m, ao = _weights(mask, dev), _weights(a_out, dev)
    ri, rb = rho_in.to(f32), rho_buf.to(f32)
    recv = torch.zeros(z.shape, dtype=f32, device=dev)
    for k in range(ri.shape[0]):
        recv = recv + m[k] * (ri[k] - rb[k])
    z_half = z.to(f32) + recv + g_new.to(f32) - g_old.to(f32)
    a_s = torch.as_tensor(a_self, dtype=f32, device=dev)
    return ((a_s * z_half).to(dt),
            (rho_out.to(f32) + ao[:, None] * z_half).to(dt),
            (m[:, None] * ri + (1.0 - m[:, None]) * rb).to(dt))


def rfast_update_node_plain(x, z, g_new, g_old, v_in, w_in, rho_in, rho_buf,
                            mask, rho_out, a_out, *, gamma, w_self, a_self):
    """Plain PyTorch twin of the full-update kernel."""
    f32 = torch.float32
    dev, dt = x.device, x.dtype
    wi = _weights(w_in, dev)
    g = torch.as_tensor(gamma, dtype=f32, device=dev)
    v = x.to(f32) - g * z.to(f32)
    x_new = torch.as_tensor(w_self, dtype=f32, device=dev) * v
    for k in range(v_in.shape[0]):
        x_new = x_new + wi[k] * v_in[k].to(f32)
    z_o, ro_o, rb_o = rfast_commit_node_plain(
        z, g_new, g_old, rho_in, rho_buf, mask, rho_out, a_out,
        a_self=a_self)
    return x_new.to(dt), v.to(dt), z_o, ro_o, rb_o


def _launch_checks(name, sources, k_max_needed):
    dev = sources[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    dt = sources[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 sources, "
                        f"got {dt}")
    for s in sources:
        if s.device != dev or not s.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous sources on "
                             f"{dev}; got {tuple(s.shape)} on {s.device}, "
                             f"contiguous={s.is_contiguous()}")
    lib = _library()
    if k_max_needed > lib.rfast_node_max_k():
        raise ValueError(f"{name} kernel takes Kw, Ka, Ko <= "
                         f"{lib.rfast_node_max_k()}; got {k_max_needed}")
    return lib, dev, dt


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def rfast_commit_node(z, g_new, g_old, rho_in, rho_buf, mask, rho_out, a_out,
                      *, a_self):
    """Commit of one node: z, g_new, g_old ``(P,)``; rho_in, rho_buf
    ``(Ka, P)``; rho_out ``(Ko, P)``; mask ``(Ka,)`` 0/1; a_out ``(Ko,)``;
    a_self a float or 0-d tensor.  Returns ``(z' (P,), ρ_out' (Ko, P),
    ρ̃' (Ka, P))`` in the sources' dtype."""
    name = "rfast_commit_node"
    sources = (z, g_new, g_old, rho_in, rho_buf, rho_out)
    one_dtype(name, sources)
    P = z.shape[-1]
    if any(t.shape != (P,) for t in (z, g_new, g_old)):
        raise ValueError(f"{name}: z, g_new and g_old must be ({P},)")
    ka, ko = rho_in.shape[0], rho_out.shape[0]
    _check_shapes(name, P, (("rho_in", rho_in, None),
                            ("rho_buf", rho_buf, ka),
                            ("rho_out", rho_out, None)))
    if meta.is_meta(z):
        meta.note(name, flops=P * node_flops(0, ka, ko, full=False),
                  nbytes=rfast_commit_node_bytes(ka, ko, P, z.element_size()))
        return _empty_like(z, rho_out, rho_buf)
    if z.device.type == "cpu":
        return rfast_commit_node_plain(z, g_new, g_old, rho_in, rho_buf,
                                       mask, rho_out, a_out, a_self=a_self)
    lib, dev, dt = _launch_checks(name, sources, max(ka, ko))
    m, ao = _weights(mask, dev), _weights(a_out, dev)
    if m.shape != (ka,) or ao.shape != (ko,):
        raise ValueError(f"{name}: mask must be ({ka},) and a_out ({ko},)")
    scal = _scalars([a_self], dev)
    z_o = torch.empty_like(z)
    ro_o = torch.empty_like(rho_out)
    rb_o = torch.empty_like(rho_buf)
    if P == 0:
        return z_o, ro_o, rb_o
    err = lib.rfast_commit_node_launch(
        _DTYPE_CODE[dt], *(_ptr(t) for t in sources), _ptr(m), _ptr(ao),
        _ptr(scal), _ptr(z_o), _ptr(ro_o), _ptr(rb_o), P, ka, ko,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    dispatch.record_launch(name)
    return z_o, ro_o, rb_o


def rfast_update_node(x, z, g_new, g_old, v_in, w_in, rho_in, rho_buf, mask,
                      rho_out, a_out, *, gamma, w_self, a_self):
    """Full update of one node: as :func:`rfast_commit_node`, plus x
    ``(P,)``, v_in ``(Kw, P)``, w_in ``(Kw,)``, gamma and w_self.
    Returns ``(x', v, z', ρ_out', ρ̃')`` in the sources' dtype."""
    name = "rfast_update_node"
    sources = (x, z, g_new, g_old, v_in, rho_in, rho_buf, rho_out)
    one_dtype(name, sources)
    P = x.shape[-1]
    if any(t.shape != (P,) for t in (x, z, g_new, g_old)):
        raise ValueError(f"{name}: x, z, g_new and g_old must be ({P},)")
    kw, ka, ko = v_in.shape[0], rho_in.shape[0], rho_out.shape[0]
    _check_shapes(name, P, (("v_in", v_in, None), ("rho_in", rho_in, None),
                            ("rho_buf", rho_buf, ka),
                            ("rho_out", rho_out, None)))
    if meta.is_meta(x):
        meta.note(name, flops=P * node_flops(kw, ka, ko, full=True),
                  nbytes=rfast_update_node_bytes(kw, ka, ko, P,
                                                 x.element_size()))
        return _empty_like(x, x, z, rho_out, rho_buf)
    if x.device.type == "cpu":
        return rfast_update_node_plain(
            x, z, g_new, g_old, v_in, w_in, rho_in, rho_buf, mask, rho_out,
            a_out, gamma=gamma, w_self=w_self, a_self=a_self)
    lib, dev, dt = _launch_checks(name, sources, max(kw, ka, ko))
    wi, m, ao = (_weights(w, dev) for w in (w_in, mask, a_out))
    if wi.shape != (kw,) or m.shape != (ka,) or ao.shape != (ko,):
        raise ValueError(f"{name}: w_in must be ({kw},), mask ({ka},) and "
                         f"a_out ({ko},)")
    scal = _scalars([gamma, w_self, a_self], dev)
    x_o, v_o, z_o = (torch.empty_like(x) for _ in range(3))
    ro_o = torch.empty_like(rho_out)
    rb_o = torch.empty_like(rho_buf)
    if P == 0:
        return x_o, v_o, z_o, ro_o, rb_o
    err = lib.rfast_update_node_launch(
        _DTYPE_CODE[dt], *(_ptr(t) for t in sources), _ptr(wi), _ptr(m),
        _ptr(ao), _ptr(scal), _ptr(x_o), _ptr(v_o), _ptr(z_o), _ptr(ro_o),
        _ptr(rb_o), P, kw, ka, ko,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    dispatch.record_launch(name)
    return x_o, v_o, z_o, ro_o, rb_o
