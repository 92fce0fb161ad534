"""Architecture registry of the port: ``get_config(arch_id)``.

Every architecture of the JAX package is ported, in its order: the
enc-dec ``whisper-large-v3`` (audio frames into an encoder, cross
attention in the decoder), the dense ``olmo-1b``, ``qwen2.5-3b``,
``llama3-8b``, ``deepseek-7b`` and ``rfast-100m``, the MoE
``phi3.5-moe-42b-a6.6b`` and ``deepseek-v2-236b`` (MLA), the
vision-frontend ``pixtral-12b`` (projected patches prepended to the
text), the SSM ``falcon-mamba-7b`` and the hybrid ``hymba-1.5b``.  The
modules are copies of ``src/repro/configs/``; an unknown arch raises
the JAX package's ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "whisper-large-v3",
    "olmo-1b",
    "phi3.5-moe-42b-a6.6b",
    "pixtral-12b",
    "falcon-mamba-7b",
    "qwen2.5-3b",
    "llama3-8b",
    "hymba-1.5b",
    "deepseek-7b",
    "deepseek-v2-236b",
    "rfast-100m",          # the paper-scale LM used by the e2e example
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch]}").get_config()
