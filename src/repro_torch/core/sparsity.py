"""Aggregated sparsity (paper Sec. 5.1): the union of FFN units activated
while decoding tokens 1..t, per request — the port's copy of the
reference's ``AggregatedTracker`` (``core/sparsity.py``), in numpy. The
engine feeds one tracker per request from the step's activity when
``EngineConfig(track_sparsity=True)``.

The reference's forward-pass statistics (``measure_site_sparsity``,
``preactivation_stats``, ``ffn_activity_masks``) are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


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
