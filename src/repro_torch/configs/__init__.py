"""Architecture registry of the port: ``get_config(arch_id)`` / ``--arch``.
The dense and hybrid families' configs are ported so far, and rwkv6's
(the serve CLI's default arch; its model family is a later slice)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ModelConfig,
    SpryConfig,
    SSMConfig,
    reduce_config,
)

_ARCH_MODULES = {
    "roberta-large-lora": "roberta_large_lora",
    "llama2-7b": "llama2_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; "
                       f"known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


__all__ = ["ModelConfig", "SpryConfig", "SSMConfig", "reduce_config", "get_config"]
