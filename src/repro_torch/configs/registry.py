"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

Each registered architecture has its exact public configuration plus a
reduced smoke variant of the same family (small widths and depths, a tiny
vocab) that the CPU tests use.  The port registers the architectures whose
serving and training paths it runs: the dense family (``qwen3-8b``,
``command-r-plus-104b``, ``gemma3-1b`` with its local/global attention,
``deepseek-coder-33b``), the moe family (``mixtral-8x22b``, and
``deepseek-v3-671b`` with its Multi-head Latent Attention), the ssm
family (``mamba2-130m``) and the hybrid family (``zamba2-7b``: Mamba2
groups with one weight-shared attention block).
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict

from repro_torch.models.common import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}

_MODULES = ["zamba2_7b", "qwen3_8b", "command_r_plus_104b", "gemma3_1b",
            "deepseek_coder_33b", "mixtral_8x22b", "deepseek_v3_671b",
            "mamba2_130m"]
_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str) -> ModelConfig:
    _load_all()
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    _load_all()
    return _SMOKE[name]()


def list_archs():
    _load_all()
    return sorted(_REGISTRY)
