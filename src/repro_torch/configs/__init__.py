"""Config registry of the PyTorch port.

``get_config(name)`` returns a registered ``ModelConfig``;
``smoke_config(name)`` a reduced same-family config for CPU runs (the
reference's rule). The port carries the configs it serves: ``tiny``,
``tiny-relu``, ``tiny-opt`` and ``tiny-moe`` (configs/tiny.py), the
paper's dense models (configs/paper_models.py), the assigned dense models
(configs/dense_models.py), the MoE models (configs/moe_models.py) and
the other families' assigned models (configs/other_families.py:
falcon-mamba-7b, zamba2-7b, whisper-small, internvl2-1b). ``ASSIGNED``
lists the ten assigned archs, as the reference's does. An arch the port
has not registered raises KeyError with the known list.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
    ModelConfig, ShapeConfig, SparsityConfig, TrainConfig,
)

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    from repro_torch.configs import (  # noqa: F401
        dense_models, moe_models, other_families, paper_models, tiny)


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


ASSIGNED = [
    "internvl2-1b", "starcoder2-15b", "qwen3-4b", "qwen2-7b", "deepseek-67b",
    "zamba2-7b", "mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "whisper-small",
    "falcon-mamba-7b",
]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small dims, few layers/experts, tiny
    vocab (the reference's ``configs.smoke_config``)."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke", n_layers=2, d_model=64,
        d_ff=0 if cfg.family == "mamba" else 128,
        vocab_size=256, max_seq_len=256, n_heads=4,
        n_kv_heads=(min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
                    else 4),
        head_dim=16,
    )
    if cfg.family == "moe":
        # high capacity factor -> drop-free routing, so cache-path
        # equivalence is exact (capacity behaviour is tested separately)
        kw.update(n_experts=4, moe_group_size=64, capacity_factor=8.0)
    if cfg.family in ("mamba", "hybrid"):
        kw.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=32)
    if cfg.family == "hybrid":
        kw.update(n_layers=5, attn_every=2)
    if cfg.family == "encdec":
        kw.update(n_encoder_layers=2, n_audio_frames=24)
    if cfg.family == "vlm":
        kw.update(n_vision_tokens=8)
    return cfg.replace(**kw)
