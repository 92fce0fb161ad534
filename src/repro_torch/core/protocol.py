"""The R-FAST protocol core: the S.1–S.5 formulas and the dense round.

Counterpart of ``src/repro/core/protocol.py``.  Algorithm 2's recursion,
written once::

  S.1   v_i = x_i − γ ẑ_i                       (ẑ = momentum-mixed z)
  S.2a  x_i⁺ = w_ii v_i + Σ_j w_ij recv_ij       (masked consensus pull,
                                                  mailbox reuse on loss)
  S.2b  z½  = z_i + Σ_j m_ij (ρ_ji − ρ̃_ji) + ∇f_i(x⁺;ζ) − ∇f_i(x;ζ⁻)
  S.2c  z_i⁺ = a_ii z½ ;  ρ_ij += a_ji z½        (push running sums)
  S.4   ρ̃_ji ← ρ_ji  where delivered             (buffer commit)

The scalar building blocks (:func:`descent_step` …) are what the
wavefront engine composes; :func:`make_protocol_round` runs one dense
round of every node over a :class:`~repro_torch.core.plan.CommPlan`.

Two backends, selected with ``impl`` (the JAX package's names in
brackets):

* ``"plain"`` [``"jnp"``] — edge-major scatter/gather over the plan's
  dense padded edge arrays, with ``index_add_``;
* ``"kernel"`` [``"pallas"``] — the whole round's commit (every node,
  every ρ/ρ̃ row) in ONE :func:`~repro_torch.kernels.rfast_update.grid.
  commit_grid` launch over the plan's per-node tables on CUDA tensors
  (its plain twin on CPU tensors).  ``oracle=True`` [``interpret=True``]
  commits each node with its own
  :func:`~repro_torch.kernels.rfast_update.kernel.rfast_commit_node`
  launch instead.

The gradient is sampled at the mixed point x⁺ (S.2b), so the consensus
pull runs before the commit in both backends.

State layout: flat.  ``x``/``z``/``g_prev``/``m`` are ``(N, p)``,
``rho``/``rho_buf``/``mail_v`` are ``(E_pad, p)``, with ``p`` the ravel
of the model in the JAX order (:mod:`repro_torch.core.paramvec`).  The
reference's kernel backend concatenates its pytree leaves into one flat
vector per dtype group every round; here the state already is that
vector, in one dtype (the kernel backend raises on a mixed-dtype state).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..kernels.rfast_update.grid import commit_grid
from ..kernels.rfast_update.kernel import one_dtype, rfast_commit_node
from ..spans import span
from .plan import CommPlan

__all__ = [
    "ProtocolState", "VGradFn", "make_protocol_round", "init_protocol_state",
    "protocol_tracked_mass", "descent_step", "momentum_mix", "consensus_mix",
    "tracking_step", "mailbox_merge", "IMPLS", "device_tables",
    "round_commit_args",
]

IMPLS = ("plain", "kernel")

VGradFn = Callable[[torch.Tensor, Any, Any],
                   tuple[torch.Tensor, torch.Tensor]]
# vgrads(x (N, p), batches, keys) -> (losses (N,), grads (N, p))


# --------------------------------------------------------------------- #
# scalar building blocks — the protocol formulas, written once
# --------------------------------------------------------------------- #
def descent_step(x, z, lr):
    """S.1: local descent direction v = x − γ z."""
    return x - lr * z


def momentum_mix(m, z, beta):
    """Heavy-ball mix of the tracked direction: m⁺ = β m + z."""
    return beta * m + z


def consensus_mix(w_self, v_self, w_in, v_in):
    """S.2a: x⁺ = w_ii v_i + Σ_k w_in[k] · v_in[k] (sum over leading axis)."""
    return w_self * v_self + torch.sum(w_in * v_in, dim=0)


def tracking_step(z, recv, g_new, g_old):
    """S.2b: robust gradient tracking z½ = z + recv + g_new − g_old."""
    return z + recv + g_new - g_old


def mailbox_merge(new, old, mask):
    """Masked commit (S.2a mailboxes / S.4 buffers): m·new + (1−m)·old."""
    return mask * new + (1 - mask) * old


# --------------------------------------------------------------------- #
# protocol state
# --------------------------------------------------------------------- #
class ProtocolState(NamedTuple):
    """Stacked per-node protocol state (flat rows; see the module doc)."""

    step: int
    x: torch.Tensor        # (N, p)
    z: torch.Tensor        # (N, p)
    g_prev: torch.Tensor   # (N, p)
    rho: torch.Tensor      # (E_pad, p) sender running sums
    rho_buf: torch.Tensor  # (E_pad, p) receiver buffers
    mail_v: torch.Tensor | None   # (E_pad, p) robust mode only
    m: torch.Tensor | None        # (N, p) momentum only


def init_protocol_state(
    plan: CommPlan,
    params: torch.Tensor,
    vgrads: VGradFn,
    batches: Any,
    keys: Any,
    *,
    robust: bool = False,
    momentum: float = 0.0,
    stacked: bool = False,
) -> ProtocolState:
    """Paper init: x_i = x0 (broadcast), z_i = g_prev_i = ∇f_i(x0; ζ0).

    ``params`` is the flat ``(p,)`` start, or with ``stacked=True`` every
    node's own ``(N, p)`` start, which the state then takes as its x (no
    copy); the state lies on its device, in its dtype."""
    n, e = plan.n, plan.e_pad
    if stacked:
        if params.dim() != 2 or params.shape[0] != n:
            raise ValueError(f"stacked params must be ({n}, p), got "
                             f"{tuple(params.shape)}")
        x = params
    elif params.dim() != 1:
        raise ValueError(f"params must be flat (p,), got "
                         f"{tuple(params.shape)}")
    else:
        x = params.reshape(1, -1).expand(n, -1).clone()
    g0 = vgrads(x, batches, keys)[1]
    zeros_e = lambda: x.new_zeros((e, x.shape[1]))
    return ProtocolState(
        step=0, x=x, z=g0, g_prev=g0.clone(), rho=zeros_e(),
        rho_buf=zeros_e(), mail_v=zeros_e() if robust else None,
        m=torch.zeros_like(x) if momentum else None)


def protocol_tracked_mass(state: ProtocolState) -> torch.Tensor:
    """Lemma-3 LHS on stacked state: Σ_i z_i + Σ_e (ρ_e − ρ̃_e)."""
    return state.z.sum(0) + (state.rho - state.rho_buf).sum(0)


# --------------------------------------------------------------------- #
# the round builder
# --------------------------------------------------------------------- #
class _Tables(NamedTuple):
    """A plan's tables on one device."""

    w_diag: torch.Tensor; a_diag: torch.Tensor
    src_w: torch.Tensor; dst_w: torch.Tensor; w_edge: torch.Tensor
    src_a: torch.Tensor; dst_a: torch.Tensor; a_edge: torch.Tensor
    in_w_epos: torch.Tensor; in_w_src: torch.Tensor; in_w_wt: torch.Tensor
    in_a_epos: torch.Tensor; in_a_val: torch.Tensor
    out_a_epos: torch.Tensor; out_a_wt: torch.Tensor
    node_ids: torch.Tensor
    ones: torch.Tensor     # (E_pad,) the all-delivered mask


def device_tables(plan: CommPlan) -> Callable[[torch.device], _Tables]:
    """Memoized per device: the plan's tables are moved once."""
    cache: dict = {}

    def get(dev: torch.device) -> _Tables:
        if dev not in cache:
            i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                            device=dev)
            f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                            device=dev)
            cache[dev] = _Tables(
                w_diag=f32(plan.w_diag), a_diag=f32(plan.a_diag),
                src_w=i64(plan.src_w), dst_w=i64(plan.dst_w),
                w_edge=f32(plan.w_edge), src_a=i64(plan.src_a),
                dst_a=i64(plan.dst_a), a_edge=f32(plan.a_edge),
                in_w_epos=i64(plan.in_w_epos), in_w_src=i64(plan.in_w_src),
                in_w_wt=f32(plan.in_w_wt), in_a_epos=i64(plan.in_a_epos),
                in_a_val=f32(plan.in_a_val), out_a_epos=i64(plan.out_a_epos),
                out_a_wt=f32(plan.out_a_wt),
                node_ids=torch.arange(plan.n, dtype=torch.int32, device=dev),
                ones=torch.ones(plan.e_pad, dtype=torch.float32, device=dev))
        return cache[dev]

    return get


def round_commit_args(t: _Tables, state: ProtocolState, g_new: torch.Tensor,
                      mk: torch.Tensor) -> dict:
    """The round's :func:`commit_grid` arguments: one lane per node over
    the plan's node tables, ρ read as both the ρ_in and the ρ_out source.
    ``mk`` is the (E_pad,) delivery mask; pad slots get mask 0."""
    return dict(
        idx_z=t.node_ids, idx_g=t.node_ids, idx_ri=t.in_a_epos,
        idx_rb=t.in_a_epos, idx_ro=t.out_a_epos, a_self=t.a_diag,
        mask=mk[t.in_a_epos] * t.in_a_val, a_out=t.out_a_wt,
        z_src=state.z, g_new=g_new, go_src=state.g_prev, ri_src=state.rho,
        rb_src=state.rho_buf, ro_src=state.rho)


def _lr(gamma, step: int) -> float:
    """γ at ``step``: a constant or a schedule ``step -> lr`` (the
    schedules of :mod:`repro_torch.optim.schedules` give fp32 values)."""
    return float(gamma(step)) if callable(gamma) else float(gamma)


def _masks(masks, x: torch.Tensor, t: _Tables) -> torch.Tensor:
    if masks is None:
        return t.ones
    return torch.as_tensor(masks, dtype=torch.float32, device=x.device)


def _finish(state: ProtocolState, donate: bool, losses: torch.Tensor,
            **new) -> tuple[ProtocolState, dict]:
    """The round's result: a new state, or (``donate``) the old state's
    tensors overwritten in place."""
    metrics = {"loss": losses.mean(), "losses": losses}
    if not donate:
        return ProtocolState(step=state.step + 1, **new), metrics
    for name, val in new.items():
        dst = getattr(state, name)
        if dst is not None and val is not dst:
            dst.copy_(val)
    return state._replace(step=state.step + 1), metrics


def make_protocol_round(
    plan: CommPlan,
    vgrads: VGradFn,
    *,
    gamma,
    robust: bool = False,
    momentum: float = 0.0,
    impl: str = "plain",
    oracle: bool = False,
    donate: bool = False,
):
    """Build ``round_fn(state, batches, keys, masks) -> (state, metrics)``.

    ``masks``: (E_pad,) float {0, 1} delivery indicators for BOTH graphs
    (1 = delivered; a tensor, on any device, or an array), or None for the
    synchronous special case (Remark 2).  Masks must be binary, as in the
    reference.  ``gamma`` may be a schedule ``step -> lr``.  ``impl``
    selects the backend; ``oracle=True`` (kernel backend only) commits
    node by node through the per-node kernel.  ``metrics`` is
    ``{"loss": mean, "losses": (N,)}``, as tensors.

    ``donate=True`` updates the state's tensors in place and returns them
    (the caller rebinds and never reuses the old state: training loops
    do); with ``donate=False`` the given state is never mutated, so tests
    and benchmarks may replay it.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if oracle and impl != "kernel":
        raise ValueError("oracle=True is a route of the kernel backend")
    tables = device_tables(plan)
    if impl == "plain":
        return _make_round_plain(plan, vgrads, tables, gamma, robust,
                                 momentum, donate)
    return _make_round_kernel(plan, vgrads, tables, gamma, robust, momentum,
                              oracle, donate)


def _descent(state: ProtocolState, lr: float, momentum: float):
    """S.1 with the optional heavy-ball mix: returns (v, m⁺ or None)."""
    if momentum:
        if state.m is None:
            raise ValueError("momentum needs a state made with momentum")
        m = momentum_mix(state.m, state.z, momentum)
        return descent_step(state.x, m, lr), m
    return descent_step(state.x, state.z, lr), None


def _mailbox(state: ProtocolState, pulled: torch.Tensor, mk: torch.Tensor):
    if state.mail_v is None:
        raise ValueError("the robust path (masks given or robust=True) "
                         "needs a state made with robust=True")
    return mailbox_merge(pulled, state.mail_v, mk[:, None])


# --------------------------------------------------------------------- #
# impl="plain": edge-major scatter/gather over the dense edge arrays
# --------------------------------------------------------------------- #
def _make_round_plain(plan, vgrads, tables, gamma, robust, momentum, donate):

    def round_fn(state: ProtocolState, batches, keys=None, masks=None):
        with span("rfast.round"):
            return _round(state, batches, keys, masks)

    def _round(state, batches, keys, masks):
        t = tables(state.x.device)
        with span("rfast.mix"):
            v, m = _descent(state, _lr(gamma, state.step), momentum)

            # ---- (S2a) consensus pull over G(W) --------------------------
            if masks is None and not robust:
                recv_w = v[t.src_w]
                mail_v = state.mail_v
            else:
                recv_w = _mailbox(state, v[t.src_w], _masks(masks, v, t))
                mail_v = recv_w
            x_new = (t.w_diag[:, None] * v).index_add_(
                0, t.dst_w, t.w_edge[:, None] * recv_w)
            del v, recv_w

        # ---- (S2b) new gradient sample + robust tracking ------------------
        losses, g_new = vgrads(x_new, batches, keys)
        with span("rfast.commit"):
            mk = _masks(masks, x_new, t)[:, None]
            recv = torch.zeros_like(state.z).index_add_(
                0, t.dst_a, mk * (state.rho - state.rho_buf))
            z_half = tracking_step(state.z, recv, g_new, state.g_prev)
            del recv
            # (S2c) split mass; (S4) buffers take the consumed values
            new = dict(
                x=x_new, z=t.a_diag[:, None] * z_half, g_prev=g_new,
                rho=state.rho + t.a_edge[:, None] * z_half[t.src_a],
                rho_buf=mailbox_merge(state.rho, state.rho_buf, mk),
                mail_v=mail_v, m=m)
        with span("rfast.scatter"):
            return _finish(state, donate, losses, **new)

    return round_fn


# --------------------------------------------------------------------- #
# impl="kernel": one fused commit launch per round over the node tables
# --------------------------------------------------------------------- #
def _make_round_kernel(plan, vgrads, tables, gamma, robust, momentum, oracle,
                       donate):
    n = plan.n
    # scatter targets of the per-node slot results, chosen on the host:
    # only real edges (each owned by exactly one (node, slot) pair); pad
    # slots are dropped here, as the reference drops them (mode="drop")
    out_rows = [(i, k, int(plan.out_a_epos[i, k]))
                for i in range(n) for k in range(plan.ko)
                if plan.out_a_val[i, k] > 0]
    in_rows = [(i, k, int(plan.in_a_epos[i, k]))
               for i in range(n) for k in range(plan.ka)
               if plan.in_a_val[i, k] > 0]

    def round_fn(state: ProtocolState, batches, keys=None, masks=None):
        with span("rfast.round"):
            return _round(state, batches, keys, masks)

    def _round(state, batches, keys, masks):
        t = tables(state.x.device)
        robust_path = robust or masks is not None
        with span("rfast.mix"):
            mk = _masks(masks, state.x, t)
            v, m = _descent(state, _lr(gamma, state.step), momentum)

            # ---- (S2a) mailbox merge + gathered consensus pull ------------
            if robust_path:
                mail_v = _mailbox(state, v[t.src_w], mk)
                v_in = mail_v[t.in_w_epos]                  # (N, kw, p)
            else:
                mail_v = state.mail_v
                v_in = v[t.in_w_src]
            x_new = consensus_mix(t.w_diag[:, None], v,
                                  t.in_w_wt.T[..., None],
                                  v_in.transpose(0, 1))
            del v, v_in

        losses, g_new = vgrads(x_new, batches, keys)

        # ---- fused commit: S.2b/c + S.4 -----------------------------------
        rho, buf = state.rho, state.rho_buf
        with span("rfast.commit"):
            one_dtype("the kernel backend",
                      (state.z, g_new, state.g_prev, rho, buf))
            a = round_commit_args(t, state, g_new, mk)
            if oracle:
                outs = [rfast_commit_node(
                    a["z_src"][i], g_new[i], a["go_src"][i],
                    rho[a["idx_ri"][i]], buf[a["idx_rb"][i]], a["mask"][i],
                    rho[a["idx_ro"][i]], a["a_out"][i],
                    a_self=a["a_self"][i]) for i in range(n)]
                z_out, rout, rbuf = (torch.stack(o) for o in zip(*outs))
                del outs
            else:
                z_out, rout, rbuf = commit_grid(**a)
            del a
        # scatter the slot results back to the edge-major rows, after
        # the launch (ρ was read as both ρ_in and ρ_out source)
        with span("rfast.scatter"):
            rho_new = rho if donate else rho.clone()
            buf_new = buf if donate else buf.clone()
            for i, k, e in out_rows:
                rho_new[e].copy_(rout[i, k])
            for i, k, e in in_rows:
                buf_new[e].copy_(rbuf[i, k])
            del rout, rbuf
            return _finish(state, donate, losses, x=x_new, z=z_out,
                           g_prev=g_new, rho=rho_new, rho_buf=buf_new,
                           mail_v=mail_v, m=m)

    return round_fn
