"""Config registry: ``get_config("qwen3-8b")`` / ``--arch qwen3-8b``."""
from __future__ import annotations

from .archs import ARCHS, DENSE_GQA
from .base import ModelConfig, SSMConfig

_REGISTRY = {c.name: c for c in ARCHS}


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(_REGISTRY)}") from None


__all__ = ["ModelConfig", "SSMConfig", "ARCHS", "DENSE_GQA", "get_config"]
