"""Architecture registry (twin of ``repro.configs``).

Every architecture of the JAX package: ``gemma3-1b``, ``starcoder2-15b``,
``command-r-35b`` and ``nemotron-4-340b`` (dense), ``mixtral-8x7b`` and
``dbrx-132b`` (moe), ``rwkv6-7b`` (ssm, RWKV-6), ``zamba2-7b`` (hybrid:
Mamba-2 + shared attention), ``whisper-medium`` (audio: encoder-decoder)
and ``internvl2-76b`` (vlm: image prefix).  ``input_specs`` (JAX abstract
shapes for the dry-run) has no counterpart yet.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCHS", "get_config", "get_smoke"]

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "mixtral-8x7b": "mixtral_8x7b",
    "dbrx-132b": "dbrx_132b",
    "rwkv6-7b": "rwkv6_7b",
    "starcoder2-15b": "starcoder2_15b",
    "command-r-35b": "command_r_35b",
    "nemotron-4-340b": "nemotron4_340b",
    "zamba2-7b": "zamba2_7b",
    "whisper-medium": "whisper_medium",
    "internvl2-76b": "internvl2_76b",
}

ARCHS: tuple[str, ...] = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; one of {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()
