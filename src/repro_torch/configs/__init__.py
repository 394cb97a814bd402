"""Config registry of the PyTorch port.

``get_config(name)`` returns a registered ``ModelConfig``. The port carries
the configs it serves: ``tiny``, ``tiny-relu``, ``tiny-opt`` and
``tiny-moe`` (configs/tiny.py), the paper's dense models
(configs/paper_models.py) and the MoE models (configs/moe_models.py).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig, SparsityConfig  # noqa: F401

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    from repro_torch.configs import moe_models, paper_models, tiny  # noqa: F401


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> List[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)
