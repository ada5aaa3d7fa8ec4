"""Architecture registry of the port: ``--arch <id>`` resolves here.

Each architecture module holds the published configuration (CONFIG) and a
reduced same-family smoke configuration (SMOKE), copied field for field
from the JAX package's: all ten architectures it holds.
"""

from __future__ import annotations

import importlib

from ..models.config import ArchConfig

_MODULES = {
    "hubert-xlarge": "hubert_xlarge",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen2-1.5b": "qwen2_1_5b",
    "mistral-large-123b": "mistral_large_123b",
    "gemma3-12b": "gemma3_12b",
    "qwen3-14b": "qwen3_14b",
    "mixtral-8x7b": "mixtral_8x7b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "mamba2-780m": "mamba2_780m",
    "internvl2-1b": "internvl2_1b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> dict[str, ArchConfig]:
    return {n: get_config(n, smoke) for n in ARCH_NAMES}
