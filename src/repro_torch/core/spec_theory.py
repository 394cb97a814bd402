"""Speculative-decoding latency theory (paper Sec. 5.2, App. C); a copy of
the reference's ``core/spec_theory.py`` (numpy only).

Theorem 1: speedup of SPARSE speculative decoding over STANDARD
speculative decoding:   (c·γ + 1) / (c·γ + (1 - s_agg(γ)))

Theorem 2: speedup of sparse speculative decoding over plain
autoregressive decoding:  (1 - α^{γ+1}) / ((c·γ + (1 - s_agg(γ)))·(1 - α))

α = draft-token acceptance probability (i.i.d. assumption), c = draft/target
cost ratio, s_agg(γ) = aggregated sparsity over a γ-token window.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def thm1_speedup(gamma: int, c: float, s_agg: float) -> float:
    return (c * gamma + 1.0) / (c * gamma + (1.0 - s_agg))


def thm2_speedup(gamma: int, c: float, s_agg: float, alpha: float) -> float:
    if alpha >= 1.0:  # limit of the geometric series: every draft accepted
        expected_tokens = gamma + 1.0
    else:
        expected_tokens = (1.0 - alpha ** (gamma + 1)) / (1.0 - alpha)
    return expected_tokens / (c * gamma + (1.0 - s_agg))


def standard_spec_speedup(gamma: int, c: float, alpha: float) -> float:
    """Standard speculative decoding vs autoregressive (Leviathan et al.)."""
    return thm2_speedup(gamma, c, 0.0, alpha)


def optimal_gamma(c: float, alpha: float,
                  s_agg_fn: Callable[[int], float] = lambda g: 0.0,
                  gamma_max: int = 64) -> Tuple[int, float]:
    """argmax_γ of Thm-2 speedup given a (measured) s_agg(γ) curve.

    With s_agg≡0 this is the standard spec-decoding optimum; with a real
    aggregated-sparsity curve the optimum shifts to smaller γ (paper
    Fig. 10a: the sparse optimum is below the standard one, gap < 20%).
    """
    best = (1, 0.0)
    for g in range(1, gamma_max + 1):
        sp = thm2_speedup(g, c, s_agg_fn(g), alpha)
        if sp > best[1]:
            best = (g, sp)
    return best


def expected_accepted_tokens(gamma: int, alpha: float) -> float:
    return (1.0 - alpha ** (gamma + 1)) / (1.0 - alpha)
