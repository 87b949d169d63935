"""Registry mapping --arch ids to ModelConfigs."""
from __future__ import annotations

from repro_torch.configs import (
    granite_8b, granite_3_8b, rwkv6_7b, mixtral_8x7b, internvl2_26b,
    zamba2_1_2b, qwen3_1_7b, codeqwen15_7b, dbrx_132b, musicgen_medium,
)
from repro_torch.configs.base import ModelConfig, reduced

ARCHS: dict[str, ModelConfig] = {
    "granite-8b": granite_8b.CONFIG,
    "granite-3-8b": granite_3_8b.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "internvl2-26b": internvl2_26b.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
    "codeqwen1.5-7b": codeqwen15_7b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "musicgen-medium": musicgen_medium.CONFIG,
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choices: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke_arch(name: str) -> ModelConfig:
    return reduced(get_arch(name))
