"""Architecture registry: the 10 assigned archs (full + smoke configs)."""
from importlib import import_module
from typing import Dict

from repro_torch.models.config import ModelConfig

_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-medium": "whisper_medium",
    "yi-34b": "yi_34b",
    "gemma3-4b": "gemma3_4b",
    "nemotron-4-15b": "nemotron_4_15b",
    "internlm2-1.8b": "internlm2_1_8b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "zamba2-7b": "zamba2_7b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    return import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return import_module(f"repro_torch.configs.{_MODULES[name]}").smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
