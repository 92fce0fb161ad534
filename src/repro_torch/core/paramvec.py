"""The flat-parameter substrate: a model's parameters as one ``(p,)`` lane.

Counterpart of ``src/repro/core/paramvec.py``.  The asynchronous engine
(:mod:`repro_torch.core.simulator`) runs Algorithm 2 over flat per-node
parameter vectors; a model is a nested ``dict`` of tensors.  This module
is the bridge:

* :class:`RavelSpec` — a static flatten plan: per-leaf key paths,
  shapes, dtypes and offsets, and tail padding to a multiple of
  ``pad_to``.  Leaves are ordered by sorted key path, the order
  ``jax.tree_util`` gives a nested dict, so a flat vector means the same
  weights in both packages.
* :func:`ravel` copies a tree into a new flat buffer; :func:`unravel`
  returns **views** into a flat buffer, so a model built from a lane
  that requires grad differentiates straight back to that lane.  Both
  take leading axes too: ``(N, p)`` rows are the node-stacked trees of
  ``(N, *shape)`` leaves the JAX package's synchronous state holds.
* :class:`GradProvider` / :func:`as_grad_fn` — what an objective exposes
  to the engine: ``n`` nodes, flat dimension ``p`` and
  ``grad_fn() -> (i, x_flat, gen) -> g_flat``, where ``i`` is a node id
  and ``gen`` a ``torch.Generator`` seeded per (event, node) by the
  engine (the JAX package passes a ``jax.random`` key instead).
* :class:`ModelGradProvider` wraps a ``(params, batch, gen) -> loss``
  model loss into that signature with :func:`torch.autograd.grad`;
  :func:`value_and_grad` is the same bridge with the batch passed in,
  ``(x_flat, batch, key) -> (loss, g_flat)``, the per-node gradient of
  the synchronous rounds.

All protocol operations are linear in the lane, so the zero pad tail
stays zero (its gradient is zero: no parameter views it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from ..spans import span

__all__ = ["RavelSpec", "make_ravel_spec", "ravel", "unravel",
           "GradProvider", "ModelGradProvider", "as_grad_fn",
           "value_and_grad", "tree_map", "tree_leaves"]

FlatGradFn = Callable[[int, torch.Tensor, torch.Generator], torch.Tensor]
# (node_id, x_flat, generator) -> g_flat


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a nested dict (and the same leaves of
    ``rest``): the counterpart of ``jax.tree.map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict in sorted key order, as
    ``jax.tree.leaves`` gives them."""
    return [leaf for _, leaf in _flatten(tree)]


def _flatten(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(key path, leaf) pairs of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def _empty_paths(tree: Any, prefix: tuple = ()) -> list[tuple]:
    """Key paths of the empty dicts in a nested dict (a layer norm with
    no parameters): they hold no leaf, but belong to the structure."""
    if not isinstance(tree, dict):
        return []
    if not tree and prefix:
        return [prefix]
    return [p for k in sorted(tree) for p in _empty_paths(tree[k],
                                                          prefix + (k,))]


@dataclasses.dataclass(frozen=True)
class RavelSpec:
    """Static plan flattening one nested-dict layout to a ``(p,)`` buffer.

    ``p`` includes the tail padding (``p = ceil(p_model / pad_to) *
    pad_to``); ``p_model`` is the true parameter count.  ``empty`` holds
    the key paths of the tree's empty dicts, which :func:`unravel`
    rebuilds, so the tree keeps the JAX package's structure.
    """

    paths: tuple[tuple[str, ...], ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    offsets: tuple[int, ...]
    p_model: int
    p: int
    pad_to: int
    dtype: torch.dtype = torch.float32
    empty: tuple[tuple[str, ...], ...] = ()

    def __repr__(self) -> str:
        return (f"RavelSpec(leaves={len(self.shapes)}, "
                f"p_model={self.p_model}, p={self.p}, pad_to={self.pad_to})")


def make_ravel_spec(tree: Any, *, pad_to: int = 1,
                    dtype: torch.dtype = torch.float32) -> RavelSpec:
    """Build the flatten plan for ``tree``'s layout (leaves may be
    tensors or numpy arrays; only shapes and dtypes are read)."""
    if pad_to < 1:
        raise ValueError(f"pad_to must be >= 1, got {pad_to}")
    items = _flatten(tree)
    shapes = tuple(tuple(int(s) for s in l.shape) for _, l in items)
    dtypes = tuple(l.dtype if isinstance(l.dtype, torch.dtype)
                   else torch.from_numpy(np.zeros(0, l.dtype)).dtype
                   for _, l in items)
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    offsets = tuple(int(o) for o in np.concatenate([[0],
                                                    np.cumsum(sizes)[:-1]]))
    p_model = int(sum(sizes))
    return RavelSpec(paths=tuple(p for p, _ in items), shapes=shapes,
                     dtypes=dtypes, offsets=offsets, p_model=p_model,
                     p=-(-p_model // pad_to) * pad_to, pad_to=pad_to,
                     dtype=dtype, empty=tuple(_empty_paths(tree)))


def ravel(spec: RavelSpec, tree: Any) -> torch.Tensor:
    """Tree -> new ``(*lead, spec.p)`` buffer (working dtype, zero pad
    tail).  ``lead`` is what each leaf has before its spec shape: none
    for one model, ``(N,)`` for a node-stacked tree (the JAX package's
    synchronous state)."""
    items = _flatten(tree)
    if len(items) != len(spec.shapes):
        raise ValueError(f"tree has {len(items)} leaves, spec expects "
                         f"{len(spec.shapes)}")
    first = items[0][1]
    lead = tuple(first.shape[:first.dim() - len(spec.shapes[0])])
    flat = torch.zeros(*lead, spec.p, dtype=spec.dtype, device=first.device)
    for (_, leaf), off in zip(items, spec.offsets):
        n = leaf.numel() // max(1, int(np.prod(lead)))
        flat[..., off:off + n] = leaf.reshape(*lead, n)
    return flat


def unravel(spec: RavelSpec, vec: torch.Tensor) -> dict:
    """``(*lead, spec.p)`` buffer -> nested dict of ``(*lead, *shape)``
    views into ``vec`` (no copies: autograd through the views lands in
    ``vec``'s gradient; the pad tail is in no view), the spec's empty
    dicts in their places.  The views come from one ``split`` of
    ``vec``, whose backward concatenates the leaves' gradients into one
    buffer (a slice a leaf would fill and add a ``vec``-sized buffer for
    each leaf, three times ``vec`` at the peak)."""
    lead = tuple(vec.shape[:-1])
    sizes = [int(np.prod(shape)) if shape else 1 for shape in spec.shapes]
    parts = vec.split(sizes + [vec.shape[-1] - sum(sizes)], dim=-1)
    tree: dict = {}
    for path, shape, part in zip(spec.paths, spec.shapes, parts):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = part.view(*lead, *shape)
    for path in spec.empty:
        node = tree
        for k in path:
            node = node.setdefault(k, {})
    return tree


def value_and_grad(spec: RavelSpec,
                   loss_fn: Callable[[dict, Any, Any], torch.Tensor]):
    """``(params, batch, key) -> loss`` -> ``(x_flat, batch, key) ->
    (loss, g_flat)``: the lane becomes a leaf that requires grad, the
    parameters are views into it (:func:`unravel`), and
    ``torch.autograd.grad(loss, lane)`` is already the flat gradient.
    The loss comes back detached."""

    def vg(x_flat, batch, key):
        lane = x_flat.detach().requires_grad_(True)
        with torch.enable_grad():
            with span("rfast.grad.fwd"):
                loss = loss_fn(unravel(spec, lane), batch, key)
            with span("rfast.grad.bwd"):
                (g,) = torch.autograd.grad(loss, lane)
        return loss.detach(), g

    return vg


@runtime_checkable
class GradProvider(Protocol):
    """What an objective exposes to drive the flat-vector engine."""

    @property
    def n(self) -> int: ...

    @property
    def p(self) -> int: ...

    def grad_fn(self) -> FlatGradFn: ...


def as_grad_fn(objective) -> FlatGradFn:
    """A bare ``(i, x_flat, gen) -> g_flat`` callable passes through;
    anything exposing ``grad_fn()`` contributes that."""
    if hasattr(objective, "grad_fn"):
        return objective.grad_fn()
    if callable(objective):
        return objective
    raise TypeError(
        f"objective must be a (i, x_flat, gen) -> g_flat callable or a "
        f"GradProvider with .grad_fn(); got {type(objective).__name__}")


@dataclasses.dataclass(frozen=True)
class ModelGradProvider:
    """Wrap a model loss ``(params, batch, gen) -> loss`` into the flat
    ``(i, x_flat, gen) -> g_flat`` engine signature.

    ``batch_fn(i, gen) -> batch`` draws node ``i``'s batch from the
    per-(event, node) generator; the gradient is :func:`value_and_grad`'s.
    """

    spec: RavelSpec
    n_nodes: int
    loss_fn: Callable[[dict, Any, torch.Generator], torch.Tensor]
    batch_fn: Callable[[int, torch.Generator], Any]

    @property
    def n(self) -> int:
        return self.n_nodes

    @property
    def p(self) -> int:
        return self.spec.p

    def grad_fn(self) -> FlatGradFn:
        vg, batch_fn = value_and_grad(self.spec, self.loss_fn), self.batch_fn
        return lambda i, x_flat, gen: vg(x_flat, batch_fn(i, gen), gen)[1]
