"""Config registry of the PyTorch port.

``get_config(name)`` returns a registered ``ModelConfig``;
``smoke_config(name)`` a reduced same-family config for CPU runs (the
reference's rule). The port carries the configs it serves: ``tiny``,
``tiny-relu``, ``tiny-opt`` and ``tiny-moe`` (configs/tiny.py), the
paper's dense models (configs/paper_models.py) and the MoE models
(configs/moe_models.py). An arch the port has not registered raises
KeyError with the known list.
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


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small dims, few layers/experts, tiny
    vocab (the reference's ``configs.smoke_config``, over the families the
    port serves)."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke", n_layers=2, d_model=64, d_ff=128,
        vocab_size=256, max_seq_len=256, n_heads=4,
        n_kv_heads=(min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
                    else 4),
        head_dim=16,
    )
    if cfg.family == "moe":
        # high capacity factor -> drop-free routing, so cache-path
        # equivalence is exact (capacity behaviour is tested separately)
        kw.update(n_experts=4, moe_group_size=64, capacity_factor=8.0)
    return cfg.replace(**kw)
