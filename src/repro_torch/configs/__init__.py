"""Config registry of the port: the architectures whose family it runs.

``get_config(name)`` returns the full-size published config, equal field
for field to the JAX package's (a ``-swa`` name gives its module's
``SWA_VARIANT``); ``get_config(name).reduced()`` is the CPU test variant.
Every architecture of ``repro.configs`` is here, in its registry's order;
an unknown name raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.base import ModelConfig

_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-7b": "deepseek_7b",
    "gemma2-9b": "gemma2_9b",
    "whisper-small": "whisper_small",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen2.5-3b": "qwen2_5_3b",
    "mamba2-370m": "mamba2_370m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "llama3-8b": "llama3_8b",
    "llava-next-34b": "llava_next_34b",
    # sliding-window variants (all-local layouts)
    "gemma2-9b-swa": "gemma2_9b",
    "llama3-8b-swa": "llama3_8b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SWA_VARIANT if name.endswith("-swa") else mod.CONFIG


def list_configs(include_variants: bool = False) -> List[str]:
    """The ported architectures in the JAX registry's order; the ``-swa``
    variants only with ``include_variants``."""
    return [n for n in _MODULES
            if include_variants or not n.endswith("-swa")]
