"""Config registry: --arch <id> resolution."""

from typing import Dict

from repro_torch.configs.base import ModelConfig

from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2_1_5b
from repro_torch.configs.qwen1_5_32b import CONFIG as _qwen1_5_32b
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2_20b
from repro_torch.configs.granite_3_8b import CONFIG as _granite_3_8b
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper_large_v3
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _deepseek_v2_lite
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2_130m
from repro_torch.configs.llava_next_34b import CONFIG as _llava_next_34b
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2_2_7b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _qwen2_1_5b,
        _qwen1_5_32b,
        _internlm2_20b,
        _granite_3_8b,
        _whisper_large_v3,
        _deepseek_v2_lite,
        _qwen3_moe,
        _mamba2_130m,
        _llava_next_34b,
        _zamba2_2_7b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
