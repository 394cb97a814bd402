"""Sparsity measurement (paper Secs. 3-5), the reference's
``core/sparsity.py``:

* ``measure_site_sparsity`` — per-layer, per-site input sparsity (Fig. 1a /
  Fig. 4 / Table 1 columns) from the instrumented forward;
* ``preactivation_stats`` — per-layer pre-activation mean/std/frac_neg
  (Fig. 5 / Fig. 11), which ``relufication.calibrate_shift`` reads;
* ``ffn_activity_masks`` — per-layer down-projection input activity of a
  stats decode step;
* ``AggregatedTracker`` — the union of FFN units activated while decoding
  tokens 1..t, per request (Sec. 5.1), in numpy. The engine feeds one
  tracker per request from the step's activity when
  ``EngineConfig(track_sparsity=True)``.

The forward statistics run the family's forward under ``torch.no_grad()``
with an active ``StatsCollector`` and fetch its scalars to the host once.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import registry


@torch.no_grad()
def _forward_stats(params, batch, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    stats = cm.StatsCollector(True)
    registry.get_family(cfg).model_forward(params, batch, cfg, stats=stats)
    return stats.stats


def measure_site_sparsity(params, batch, cfg: ModelConfig) -> Dict[str, float]:
    """Mean input sparsity per site, averaged over layers: keys 'qkv', 'up',
    'down' (paper Table 1 columns) + per-layer details."""
    out: Dict[str, float] = {}
    agg: Dict[str, List[float]] = {"qkv_in": [], "up_in": [], "down_in": []}
    for k, v in _forward_stats(params, batch, cfg).items():
        if v.dim():  # vector stats (activity masks) skipped
            continue
        val = float(v)
        out[k] = val
        for site in agg:
            if k.endswith("/" + site):
                agg[site].append(val)
    for site, vals in agg.items():
        if vals:
            out["mean/" + site.replace("_in", "")] = float(np.mean(vals))
    return out


def preactivation_stats(params, batch, cfg: ModelConfig) -> Dict[str, float]:
    """Per-layer pre-activation mean/std/frac_neg (Fig. 5 / Fig. 11)."""
    return {k: float(v) for k, v in _forward_stats(params, batch, cfg).items()
            if "pre/" in k or k.endswith(("mean", "std", "frac_neg"))}


class AggregatedTracker:
    """Union of activated units over decoded tokens (paper Sec. 5.1).

    `update(masks)` takes per-layer boolean activity (n_layers, n_units)
    for one token; `aggregated_sparsity()` returns the fraction of units
    never used so far (non-increasing in t — the paper's Fig. 7a curve).
    """

    def __init__(self, n_layers: int, n_units: int):
        self.used = np.zeros((n_layers, n_units), bool)
        self.per_token_sparsity: List[float] = []
        self.curve: List[float] = []

    def update(self, masks: np.ndarray) -> None:
        masks = np.asarray(masks, bool)
        self.per_token_sparsity.append(1.0 - masks.mean())
        self.used |= masks
        self.curve.append(1.0 - self.used.mean())

    def aggregated_sparsity(self) -> float:
        return 1.0 - self.used.mean()

    def mean_token_sparsity(self) -> float:
        return (float(np.mean(self.per_token_sparsity))
                if self.per_token_sparsity else 0.0)

    def random_baseline(self, t: Optional[int] = None) -> float:
        """Random aggregated sparsity s^t (paper Fig. 7b dashed line)."""
        s = self.mean_token_sparsity()
        t = t if t is not None else len(self.per_token_sparsity)
        return float(s ** t)


def ffn_activity_masks(stats: cm.StatsCollector, cfg: ModelConfig,
                       tile: int = 0) -> np.ndarray:
    """Per-layer down-proj input activity of a stats decode step: the
    stored 'layerN/down_act' vectors stacked (n_layers, d_ff) on the host,
    or an empty (0, 0) array when the step stored none."""
    masks = [np.asarray(stats.stats[f"layer{i}/down_act"].cpu())
             for i in range(cfg.n_layers)
             if f"layer{i}/down_act" in stats.stats]
    return np.stack(masks) if masks else np.zeros((0, 0))
