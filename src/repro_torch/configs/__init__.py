"""Architecture registry of the port: ``get_config(arch_id)``.

Every decoder-only text architecture of the JAX package is ported: the
dense ``rfast-100m``, ``llama3-8b``, ``deepseek-7b``, ``olmo-1b`` and
``qwen2.5-3b``, the MoE ``phi3.5-moe-42b-a6.6b`` and ``deepseek-v2-236b``
(MLA), the hybrid ``hymba-1.5b`` and the SSM ``falcon-mamba-7b`` (their
modules are copies of ``src/repro/configs/``).  The enc-dec and frontend
archs (``whisper-large-v3``, ``pixtral-12b``) raise a "not ported yet"
error.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = ["olmo-1b", "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b",
         "qwen2.5-3b", "llama3-8b", "hymba-1.5b", "deepseek-7b",
         "deepseek-v2-236b", "rfast-100m"]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet; have {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch]}").get_config()
