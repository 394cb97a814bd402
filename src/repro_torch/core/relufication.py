"""Relufication surgery (paper Sec. 4): the config transforms the
launchers call, copied from the reference's ``core/relufication.py``.

The paper's procedure keeps the pretrained weights and only swaps the
activation function (stage 1) / inserts ReLU after norms (stage 2), then
fine-tunes briefly. Surgery here is therefore a *config* transformation —
parameters pass through unchanged. ``calibrate_shift`` picks the shifted
ReLU's shift (Sec. 5.3) from the forward's pre-activation statistics.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


def _norm_ppf(q: float) -> float:
    """Inverse normal CDF (Acklam's approximation; avoids scipy dep)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if q < plow:
        ql = np.sqrt(-2 * np.log(q))
        return (((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]) / \
               ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1)
    if q > phigh:
        return -_norm_ppf(1 - q)
    ql = q - 0.5
    r = ql * ql
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * ql / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def relufy_stage1(cfg: ModelConfig) -> ModelConfig:
    """Replace the FFN/gate activation with ReLU (weights unchanged)."""
    return cfg.replace(activation="relu")


def relufy_stage2(cfg: ModelConfig) -> ModelConfig:
    """Stage 1 + ReLU after normalization layers (sparse QKV/up inputs)."""
    return relufy_stage1(cfg).replace(post_norm_relu=True)


def shifted_relufy(cfg: ModelConfig, shift: float) -> ModelConfig:
    """ReLU(x - b) activation (paper Sec. 5.3)."""
    return cfg.replace(activation="shifted_relu").replace_sparsity(shift=shift)


def calibrate_shift(params, batch, cfg: ModelConfig,
                    target_sparsity: float = 0.95) -> float:
    """Pick the shift b so that ~target_sparsity of pre-activations fall
    below it, from the measured pre-activation distribution (the paper reads
    b off the distribution plot, e.g. b=1 for relufied Llama; we use the
    per-layer mean/std under a normal approximation and average).
    """
    from repro_torch.core.sparsity import preactivation_stats
    stats = preactivation_stats(params, batch, cfg)
    shifts = []
    means = {k[: -len("/mean")]: v for k, v in stats.items() if k.endswith("/mean")}
    for base, mu in means.items():
        sd = stats.get(base + "/std", 0.0)
        if sd > 0:
            shifts.append(mu + _norm_ppf(target_sparsity) * sd)
    return float(np.mean(shifts)) if shifts else 0.0


def enable_sparse_serving(cfg: ModelConfig, ffn_density: float,
                          input_density: float = 1.0,
                          reuse_window: int = 0) -> ModelConfig:
    """Turn on the tile-gathered sparse decode path. The decode steps serve
    tile capacities below 1 through ``common.maybe_sparse_matmul``, whose
    tile gather is kernel 5 (``sparse_matmul``) on CUDA tensors."""
    return cfg.replace_sparsity(enabled=True, ffn_tile_density=ffn_density,
                                input_tile_density=input_density,
                                reuse_window=reuse_window)
