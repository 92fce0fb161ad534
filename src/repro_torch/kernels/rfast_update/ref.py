"""Plain PyTorch oracles for the R-FAST update (S.1, S.2a–c, S.4).

Counterparts of ``src/repro/kernels/rfast_update/ref.py``
(``rfast_update_ref``, ``rfast_commit_ref``).  On flat per-node
parameter vectors:

  v      = x − γ z                                   (update only)
  x'     = w_self · v + Σ_j w_in[j] · v_in[j]        (update only)
  recv   = Σ_j m[j] · (rho_in[j] − rho_buf[j])
  z_half = z + recv + g_new − g_old
  z'     = a_self · z_half
  rho_out'[j] = rho_out[j] + a_out[j] · z_half
  rho_buf'[j] = m[j] ? rho_in[j] : rho_buf[j]
"""
from __future__ import annotations

import torch

__all__ = ["rfast_update_ref", "rfast_commit_ref"]


def rfast_update_ref(x, z, g_new, g_old, v_in, w_in, rho_in, rho_buf, mask,
                     rho_out, a_out, *, gamma, w_self, a_self):
    """Shapes: x/z/g_* (P,); v_in (Kw, P); w_in (Kw,); rho_in/rho_buf
    (Ka, P); mask (Ka,); rho_out (Ko, P); a_out (Ko,).  Accumulates in
    fp32 and returns ``(x', v, z', rho_out', rho_buf')``, each in
    ``x``'s dtype except ``rho_buf'``, which keeps ``rho_buf``'s."""
    f32 = torch.float32
    xf, zf = x.to(f32), z.to(f32)
    v = xf - gamma * zf
    x_new = w_self * v + torch.einsum("k,kp->p", w_in.to(f32),
                                      v_in.to(f32))
    recv = torch.einsum("k,kp->p", mask.to(f32),
                        rho_in.to(f32) - rho_buf.to(f32))
    z_half = zf + recv + g_new.to(f32) - g_old.to(f32)
    rho_out_new = rho_out.to(f32) + a_out.to(f32)[:, None] * z_half
    rho_buf_new = torch.where(mask[:, None] > 0, rho_in, rho_buf)
    dt = x.dtype
    return (x_new.to(dt), v.to(dt), (a_self * z_half).to(dt),
            rho_out_new.to(dt), rho_buf_new.to(rho_buf.dtype))


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
