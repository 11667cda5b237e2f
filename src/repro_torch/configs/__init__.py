"""Configurations: the LM architectures and the paper's FIR testbed.

``get_arch`` knows every name the reference registry has and raises
``KeyError`` for any other.
"""
import importlib

from .base import AmmConfig, ArchConfig, reduced

_PORTED = {
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen1.5-110b": "qwen1_5_110b",
    "llama3.2-3b": "llama3_2_3b",
    "yi-34b": "yi_34b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "grok-1-314b": "grok1_314b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-2.7b": "zamba2_2_7b",
    "chameleon-34b": "chameleon_34b",
    "whisper-base": "whisper_base",
}

ARCH_NAMES = sorted(_PORTED)


def get_arch(name: str) -> ArchConfig:
    if name not in _PORTED:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f".{_PORTED[name]}", __package__).CONFIG


__all__ = ["AmmConfig", "ArchConfig", "ARCH_NAMES", "get_arch", "reduced"]
