"""Plain PyTorch oracle for the R-FAST commit (S.2b, S.2c, S.4).

Counterpart of ``src/repro/kernels/rfast_update/ref.py::rfast_commit_ref``.
On flat per-node parameter vectors:

  recv   = Σ_j m[j] · (rho_in[j] − rho_buf[j])
  z_half = z + recv + g_new − g_old
  z'     = a_self · z_half
  rho_out'[j] = rho_out[j] + a_out[j] · z_half
  rho_buf'[j] = m[j] ? rho_in[j] : rho_buf[j]
"""
from __future__ import annotations

import torch

__all__ = ["rfast_commit_ref"]


def rfast_commit_ref(z, g_new, g_old, rho_in, rho_buf, mask, rho_out, a_out,
                     *, a_self):
    """Shapes: z/g_* (P,); rho_in/rho_buf (Ka, P); mask (Ka,);
    rho_out (Ko, P); a_out (Ko,).  Accumulates in fp32 and returns
    ``(z', rho_out', rho_buf')`` in ``z``'s / ``rho_buf``'s dtypes."""
    f32 = torch.float32
    zf = z.to(f32)
    recv = torch.einsum("k,kp->p", mask.to(f32),
                        rho_in.to(f32) - rho_buf.to(f32))
    z_half = zf + recv + g_new.to(f32) - g_old.to(f32)
    rho_out_new = rho_out.to(f32) + a_out.to(f32)[:, None] * z_half
    rho_buf_new = torch.where(mask[:, None] > 0, rho_in, rho_buf)
    dt = z.dtype
    return ((a_self * z_half).to(dt), rho_out_new.to(dt),
            rho_buf_new.to(rho_buf.dtype))
