"""Architecture registry of the port: ``get_config(arch_id)`` / ``--arch``.
Every config of the reference is ported: dense (roberta-large-lora,
llama2-7b, gemma3-12b, gemma3-27b, h2o-danube-3-4b, command-r-plus-104b),
moe (qwen3-moe-235b-a22b, llama4-maverick-400b-a17b), vlm (internvl2-76b),
audio (whisper-tiny), hybrid (zamba2-1.2b) and ssm (rwkv6-1.6b).
``ASSIGNED_ARCHS`` and ``ALL_ARCHS`` are the reference's, in its order."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    SpryConfig,
    SSMConfig,
    reduce_config,
)

# arch_id -> module name, in the reference's order: the first 10 are the
# assigned pool, the last two the paper's own evaluation models.
_ARCH_MODULES = {
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma3-12b": "gemma3_12b",
    "internvl2-76b": "internvl2_76b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-tiny": "whisper_tiny",
    "gemma3-27b": "gemma3_27b",
    "zamba2-1.2b": "zamba2_1_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "roberta-large-lora": "roberta_large_lora",
    "llama2-7b": "llama2_7b",
}

ASSIGNED_ARCHS = tuple(list(_ARCH_MODULES)[:10])
ALL_ARCHS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """Contract from the assignment: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


__all__ = ["ALL_ARCHS", "ASSIGNED_ARCHS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "MoEConfig", "SpryConfig", "SSMConfig", "get_config", "get_shape", "reduce_config",
           "shape_applicable"]
