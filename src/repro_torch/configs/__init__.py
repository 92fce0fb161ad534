"""Architecture registry of the port: ``get_config(arch_id)``.

``rfast-100m``, ``llama3-8b``, ``hymba-1.5b`` and ``falcon-mamba-7b`` are
ported so far (their modules are copies of ``src/repro/configs/``); the
JAX package's other architectures raise a "not ported yet" error.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ["falcon-mamba-7b", "hymba-1.5b", "llama3-8b", "rfast-100m"]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet; have {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch]}").get_config()
