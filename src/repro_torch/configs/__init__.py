"""Config registry of the port: the architectures whose family it runs.

``get_config(name)`` returns the full-size published config, equal field
for field to the JAX package's; ``get_config(name).reduced()`` is the CPU
test variant.  The other architectures of ``repro.configs`` raise
``KeyError`` until the slice that ports their family.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.base import ModelConfig

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3-8b": "llama3_8b",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"arch '{name}' is unknown or its family is not "
                       f"ported yet; ported: {sorted(_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG


def list_configs() -> List[str]:
    return list(_MODULES)
