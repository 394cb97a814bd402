"""Offline predictor calibration (the reference's
``predictor/calibration.py``): fit thresholds (and low-rank factors) on a
calibration batch to hit a target recall, with per-layer reports, and
save / load in the reference's checkpoint format.

One forward over the calibration batch with raw capture
(``StatsCollector(raw=True)``) collects each layer's FFN input; the fit is
numpy:

* a unit fires iff its gate pre-activation exceeds the activation's firing
  threshold;
* sign: probe = X @ W_lp at the probe dtype; only tau is fitted;
* lowrank: reduced-rank regression of the pre-activations Z = X @ W on the
  inputs: the truncated SVD of Z gives B = V_r^T, A = W V_r;
* tau per layer: the highest threshold keeping calibration recall >= the
  target; target_recall >= 1 also clamps the sign tau to the firing
  threshold (recall 1.0 by construction at a full-precision probe).

The gate weights are copied to host f32 one layer at a time (all of
OPT-6.7B's at once would be 8.6 GB); the numbers are the same.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.predictor.predictors import (LayerReport, Predictor, ffn_tile,
                                              firing_threshold, gate_weight_key,
                                              probe)


@torch.inference_mode()
def collect_ffn_inputs(params, batch: Dict, cfg: ModelConfig) -> np.ndarray:
    """One instrumented forward over the calibration batch; returns the
    per-layer FFN inputs, stacked (L, N, d) f32 (N = batch * seq tokens)."""
    stats = cm.StatsCollector(True, raw=True)
    registry.get_family(cfg).model_forward(params, batch, cfg, stats=stats)
    xs = []
    for i in range(cfg.n_layers):
        key = f"layer{i}/ffn_x"
        if key not in stats.stats:
            raise ValueError(f"no FFN capture for layer {i} — family "
                             f"{cfg.family!r} lacks predictor support")
        xs.append(stats.stats[key].float().cpu().numpy())
    return np.stack(xs)


def _fit_tau(probe_act: np.ndarray, target_recall: float) -> float:
    """Highest tau with calibration recall >= target: allow
    floor((1-target)*n) misses, set tau just below the first kept probe."""
    n = probe_act.size
    if n == 0:
        return 0.0
    allowed = int(np.floor((1.0 - min(target_recall, 1.0)) * n))
    srt = np.sort(probe_act)  # ascending
    anchor = srt[min(allowed, n - 1)]
    eps = 1e-6 * max(1.0, abs(float(anchor)))
    return float(anchor) - eps


def _layer_report(layer: int, tau: float, probe: np.ndarray,
                  active: np.ndarray, tile: int) -> LayerReport:
    pred = probe > tau
    n_act = max(1, int(active.sum()))
    n_pred = max(1, int(pred.sum()))
    N, F = pred.shape
    pred_tiles = pred.reshape(N, F // tile, tile).any(-1)
    covered = np.repeat(pred_tiles, tile, axis=-1)
    return LayerReport(
        layer=layer,
        tau=float(tau),
        recall=float((pred & active).sum() / n_act),
        tile_recall=float((covered & active).sum() / n_act),
        precision=float((pred & active).sum() / n_pred),
        unit_density=float(pred.mean()),
        tile_density=float(pred_tiles.mean()),
    )


@torch.inference_mode()
def calibrate(params, cfg: ModelConfig, batch: Dict, *, kind: str = "sign",
              target_recall: float = 0.99, rank: int = 8,
              probe_dtype: str = "bfloat16", tile: Optional[int] = None,
              k_tiles: Optional[int] = None) -> Predictor:
    """Fit a predictor of the given kind on one calibration batch (token
    ids on the params' device). Its params lie on that device; its reports
    record the calibration recall / precision / density at the fitted
    thresholds. tile defaults to the config's gather tile; k_tiles to the
    full tile count (savings come from nvalid, never from truncation)."""
    thr = firing_threshold(cfg)
    tile = ffn_tile(cfg) if tile is None else tile
    if cfg.d_ff % tile:
        raise ValueError(f"d_ff={cfg.d_ff} is not a multiple of tile={tile}")
    X = collect_ffn_inputs(params, batch, cfg)  # (L, N, d)
    W = params["layers"]["ffn"][gate_weight_key(cfg)]
    dev = W.device
    n_tiles = cfg.d_ff // tile

    taus, reports = [], []
    a_l, b_l, w_lp = [], [], []
    for layer in range(cfg.n_layers):
        x = X[layer]
        w = W[layer].float().cpu().numpy()
        pre = x @ w  # (N, F) true gate pre-activation (f32 reference)
        active = pre > thr
        xt = torch.from_numpy(x).to(dev)
        # the probe is predictors.probe, the computation the decode step
        # runs (its rounding at low probe dtypes included): tau binds to it
        if kind == "sign":
            lp = W[layer].to(getattr(torch, probe_dtype))
            w_lp.append(lp)
            pr = probe("sign", {"w": lp}, xt).cpu().numpy()
        elif kind == "lowrank":
            _, _, vt = np.linalg.svd(pre, full_matrices=False)
            v_r = vt[: min(rank, vt.shape[0])].T  # (F, r)
            a = torch.from_numpy((w @ v_r).astype(np.float32)).to(dev)
            b = torch.from_numpy(np.ascontiguousarray(v_r.T, np.float32)).to(dev)
            a_l.append(a)
            b_l.append(b)
            pr = probe("lowrank", {"a": a, "b": b}, xt).cpu().numpy()
        else:
            raise ValueError(f"unknown predictor kind {kind!r}")
        tau = _fit_tau(pr[active], target_recall)
        if kind == "sign" and target_recall >= 1.0:
            tau = min(tau, thr)
        taus.append(tau)
        reports.append(_layer_report(layer, tau, pr, active, tile))

    tau_t = torch.tensor(np.asarray(taus, np.float32), device=dev)
    if kind == "sign":
        p = {"w": torch.stack(w_lp), "tau": tau_t}
    else:
        p = {"a": torch.stack(a_l), "b": torch.stack(b_l), "tau": tau_t}
    return Predictor(
        kind=kind, params=p, n_tiles=n_tiles,
        k_tiles=n_tiles if k_tiles is None else min(k_tiles, n_tiles),
        tile=tile, target_recall=target_recall, probe_dtype=probe_dtype,
        reports=reports)


def calibrate_from_config(params, cfg: ModelConfig, batch: Dict,
                          **overrides) -> Predictor:
    """Calibrate with the SparsityConfig predictor knobs (kind, target
    recall, rank, probe dtype), keyword overrides for experiments."""
    if cfg.sparsity.predictor == "none":
        raise ValueError("cfg.sparsity.predictor is 'none' — set it to "
                         "'sign' or 'lowrank' (or call calibrate directly)")
    kw = dict(kind=cfg.sparsity.predictor,
              target_recall=cfg.sparsity.predictor_recall,
              rank=cfg.sparsity.predictor_rank,
              probe_dtype=cfg.sparsity.probe_dtype)
    kw.update(overrides)
    return calibrate(params, cfg, batch, **kw)


# ---------------------------------------------------------------------------
# serialization (the reference's checkpoint format)


def save_predictor(pred: Predictor, directory: str, step: int = 0) -> None:
    """Atomic-write the predictor under ``directory`` (arrays stored f32,
    re-cast to probe_dtype on load), as the reference writes it."""
    mgr = CheckpointManager(directory, keep=2)
    tree = {k: v.float() for k, v in pred.params.items()}
    extras = {
        "kind": pred.kind,
        "n_tiles": pred.n_tiles,
        "k_tiles": pred.k_tiles,
        "tile": pred.tile,
        "target_recall": pred.target_recall,
        "probe_dtype": pred.probe_dtype,
        "reports": [dataclasses.asdict(r) for r in pred.reports],
    }
    mgr.save(step, tree, extras=extras)


def load_predictor(directory: str, step: Optional[int] = None,
                   device="cuda") -> Predictor:
    """A saved predictor (by either package) with its params on ``device``
    (CUDA unless the caller passes ``device="cpu"``)."""
    dev = cm.resolve_device(device)
    mgr = CheckpointManager(directory)
    step = mgr.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no predictor checkpoints in {directory}")
    with open(os.path.join(directory, f"step_{step:010d}",
                           "manifest.json")) as f:
        extras = json.load(f)["extras"]
    template = ({"w": 0, "tau": 0} if extras["kind"] == "sign"
                else {"a": 0, "b": 0, "tau": 0})
    tree, extras = mgr.restore(template, step=step)
    # probe_dtype governs only the sign probe's weight; low-rank factors and
    # thresholds are f32
    pd = getattr(torch, extras["probe_dtype"])
    params = {k: torch.from_numpy(v).to(device=dev,
                                        dtype=pd if k == "w" else torch.float32)
              for k, v in tree.items()}
    return Predictor(
        kind=extras["kind"], params=params, n_tiles=extras["n_tiles"],
        k_tiles=extras["k_tiles"], tile=extras["tile"],
        target_recall=extras["target_recall"],
        probe_dtype=extras["probe_dtype"],
        reports=[LayerReport(**r) for r in extras["reports"]])
