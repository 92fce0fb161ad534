"""npz checkpoints of nested tensors with step metadata.

Counterpart of ``src/repro/checkpoint/ckpt.py``, file for file: the JAX
package loads what this module writes and the other way round.

Layout: ``<dir>/step_<N>.npz`` holding the flattened leaves keyed by
path, plus a ``_treedef`` record.  Every write is atomic (tmp file +
``fsync`` + ``os.replace``), and each successful save also replaces a
``LATEST.json`` manifest — the single pointer a polling reader follows,
so a reader can NEVER observe a torn checkpoint:

* the npz only appears under its final name after its bytes are durable;
* the manifest only points at a step whose npz replace already happened;
* a partial/corrupt npz (a crashed foreign writer, a truncated copy)
  is rejected by :func:`load_checkpoint` with a pointed error instead
  of a deep numpy traceback.

Keys are spelled as ``jax.tree_util`` spells a path: a NamedTuple field
is ``.name`` (an :class:`~repro_torch.core.simulator.RFASTState` gives
``.k``, ``.x``, …), a dict key is bare (sorted, as JAX orders them), a
sequence index is its number, the parts are joined with ``/``, and a
bare leaf is ``_root``.  ``None`` writes nothing.  Tensors are saved as
their numpy arrays, Python ints as 0-d ``int32`` (the JAX package's
step and event counters).  ``_treedef`` holds a description of the
structure; neither package's loader parses it, the structure comes from
the template ``like``.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
import zipfile
from typing import Any

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "read_manifest", "MANIFEST"]

MANIFEST = "LATEST.json"


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree: Any) -> list[tuple[str, Any]] | None:
    """``(key, child)`` pairs of a container in JAX's order, or None for
    a leaf."""
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _paths(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs of ``tree``, keys spelled as JAX's paths."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix) or "_root", tree)]
    return [kv for k, child in kids for kv in _paths(child, prefix + (k,))]


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _describe(tree: Any) -> str:
    """A readable description of the structure (leaves are ``*``)."""
    kids = _children(tree)
    if tree is None or kids is None:
        return "None" if tree is None else "*"
    inner = ", ".join(f"{k}: {_describe(v)}" for k, v in kids)
    name = type(tree).__name__
    return f"{name}({inner})" if _is_namedtuple(tree) else f"{name}[{inner}]"


def _atomic_write(path: str, write_fn) -> None:
    """Write via tmp file in the same dir + fsync + os.replace, so the
    final name only ever names a complete file."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            write_fn(fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write ``tree`` as ``step_<step>.npz`` and point the manifest at
    it; returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _paths(tree)}
    path = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    _atomic_write(path, lambda fh: np.savez(
        fh, _treedef=json.dumps(_describe(tree)), **flat))
    manifest = {"step": int(step), "file": os.path.basename(path),
                "time": time.time(), "leaves": len(flat)}
    _atomic_write(os.path.join(ckpt_dir, MANIFEST),
                  lambda fh: fh.write(
                      (json.dumps(manifest) + "\n").encode()))
    return path


def read_manifest(ckpt_dir: str) -> dict | None:
    """The LATEST pointer: ``{"step", "file", "time", "leaves"}`` or
    ``None`` when the dir has no manifest yet.  A manifest pointing at a
    missing file is an error — the pointer is only ever replaced AFTER
    its npz, so this means external tampering."""
    path = os.path.join(ckpt_dir, MANIFEST)
    try:
        with open(path) as fh:
            man = json.load(fh)
    except FileNotFoundError:
        return None
    except (json.JSONDecodeError, OSError) as e:
        raise ValueError(
            f"unreadable checkpoint manifest {path}: {e} — manifests are "
            "written atomically by save_checkpoint; a torn one means a "
            "foreign writer bypassed it") from e
    target = os.path.join(ckpt_dir, man["file"])
    if not os.path.exists(target):
        raise ValueError(
            f"manifest {path} points at missing {man['file']} — "
            "save_checkpoint replaces the npz before the pointer, so "
            "the checkpoint file was removed out from under the reader")
    return man


def latest_step(ckpt_dir: str) -> int | None:
    """The manifest's step, else the largest ``step_<N>.npz`` (a
    directory written without manifests), else None."""
    if not os.path.isdir(ckpt_dir):
        return None
    man = read_manifest(ckpt_dir)
    if man is not None:
        return int(man["step"])
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _restore(like: Any, flat: dict[str, np.ndarray], prefix: tuple = ()):
    """``like`` with every leaf replaced by its saved array: a tensor on
    the template leaf's device and dtype, an int as an int, anything
    else as the array."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        arr = flat["/".join(prefix) or "_root"]
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(arr).to(device=like.device,
                                            dtype=like.dtype)
        if isinstance(like, int) and not isinstance(like, bool):
            return int(arr)
        return arr
    vals = [_restore(v, flat, prefix + (k,)) for k, v in kids]
    if _is_namedtuple(like):
        return type(like)(*vals)
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    return type(like)(vals)


def load_checkpoint(ckpt_dir: str, like: Any, step: int | None = None) -> Any:
    """Restore into the structure of ``like`` (leaves replaced by the
    saved ones; the latest step unless ``step`` is given)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}.npz")
    try:
        with np.load(path, allow_pickle=False) as data:
            if "_treedef" not in data.files:
                raise ValueError("no _treedef record")
            flat = {k: data[k] for k in data.files if k != "_treedef"}
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as e:
        if isinstance(e, FileNotFoundError):
            raise
        raise ValueError(
            f"torn or partial checkpoint {path}: {e} — complete "
            "checkpoints only ever appear via save_checkpoint's "
            "tmp+fsync+rename, so this file was written by something "
            "else (or truncated in transit); refusing to load it") from e
    ref = {k for k, _ in _paths(like)}
    if ref != set(flat):
        missing = ref ^ set(flat)
        raise ValueError(
            f"checkpoint structure mismatch: {sorted(missing)[:5]}")
    return _restore(like, flat)
