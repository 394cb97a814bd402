"""Activation-sparsity predictors (the reference's
``predictor/predictors.py``): know which FFN units fire BEFORE paying for
their weights.

A predictor turns the FFN input x (the post-norm block activation) into a
per-token probe approximating the gate pre-activation ``x @ W_gate``; units
whose probe exceeds the layer's calibrated threshold ``tau`` are predicted
to fire, and rounding the units up to gather tiles gives the weight-I/O
plan of both the up- and the down-projection.

* ``sign``: the probe is ``x @ W_lp``, the model's own gate weight in
  ``probe_dtype``; at the compute dtype it IS the pre-activation, so tau =
  the firing threshold gives recall 1.0 by construction.
* ``lowrank``: ``(x @ A) @ B`` with rank-r factors fitted per layer by
  calibration (predictor/calibration.py).

Parameters are stacked on a leading layer axis. The tile-list helpers
(unit <-> tile masks, the fixed-capacity packing every gather kernel
consumes) pack one group of tiles, or with ``n_groups > 1`` one group per
model-axis shard (the reference's model-axis-local packing). A rank of
the port's sharded engine holds only its own d_ff slice and packs it as
one group of ceil(k / TP): that group's lists, in its local tile ids.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import activations as acts

TILE = 128  # default gather tile


def ffn_tile(cfg: ModelConfig) -> int:
    """The weight-gather tile width (``models.common.ffn_gather_tile``, the
    one the serving steps use). tile=1 is the paper's exact row-skipping."""
    from repro_torch.models.common import ffn_gather_tile
    return ffn_gather_tile(cfg)


@dataclasses.dataclass
class LayerReport:
    """Per-layer calibration metrics (predictor quality at the fitted tau)."""

    layer: int
    tau: float
    recall: float          # active units whose probe cleared tau
    tile_recall: float     # active units whose TILE was predicted (>= recall)
    precision: float       # predicted units that were truly active
    unit_density: float    # fraction of units predicted active
    tile_density: float    # fraction of tiles predicted active (the I/O)


@dataclasses.dataclass
class Predictor:
    """A fitted predictor: stacked per-layer params + static serving knobs.

    params (leading axis = layer):
      sign:    {"w": (L, d, F) probe_dtype, "tau": (L,) f32}
      lowrank: {"a": (L, d, r) f32, "b": (L, r, F) f32, "tau": (L,) f32}

    ``k_tiles`` is the gather capacity per token: predicted tile lists are
    padded or truncated to exactly k_tiles indices (truncation is a
    recorded recall event)."""

    kind: str  # "sign" | "lowrank"
    params: Dict[str, torch.Tensor]
    n_tiles: int
    k_tiles: int
    tile: int = TILE
    target_recall: float = 1.0
    probe_dtype: str = "float32"
    reports: List[LayerReport] = dataclasses.field(default_factory=list)

    def layer_tau(self, layer: int) -> float:
        return float(self.params["tau"][layer])

    def mean_report(self) -> Dict[str, float]:
        if not self.reports:
            return {}
        keys = ("recall", "tile_recall", "precision", "unit_density",
                "tile_density")
        n = len(self.reports)
        return {k: sum(getattr(r, k) for r in self.reports) / n for k in keys}

    def describe(self) -> str:
        m = self.mean_report()
        extra = ("" if not m else
                 f" recall={m['recall']:.3f} tile_density="
                 f"{m['tile_density']:.3f}")
        return (f"{self.kind}-predictor(k_tiles={self.k_tiles}/"
                f"{self.n_tiles}, target_recall={self.target_recall})"
                + extra)


# ---------------------------------------------------------------------------
# probe + mask machinery (called from the decode step)


def probe(kind: str, pred_l: Dict[str, torch.Tensor], x: torch.Tensor
          ) -> torch.Tensor:
    """Per-layer probe. x: (T, d) -> (T, F) f32 approximate pre-activation.
    At a low probe dtype the product is rounded to that dtype before the
    cast to f32, as in the reference (the fitted tau binds to it)."""
    if kind == "sign":
        w = pred_l["w"]
        return (x.to(w.dtype) @ w).float()
    if kind == "lowrank":
        a, b = pred_l["a"], pred_l["b"]
        return ((x.to(a.dtype) @ a) @ b).float()
    raise ValueError(f"unknown predictor kind {kind!r}")


def predict_units(kind: str, pred_l: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
    """(T, d) -> (T, F) bool predicted-active units (probe > layer tau)."""
    return probe(kind, pred_l, x) > pred_l["tau"].float()


def units_to_tiles(units: torch.Tensor, tile: int) -> torch.Tensor:
    """(T, F) unit mask -> (T, F // tile) tile mask (any unit in the tile)."""
    T, F = units.shape
    return units.reshape(T, F // tile, tile).any(-1)


def tiles_to_units(tiles: torch.Tensor, tile: int) -> torch.Tensor:
    """(T, nT) tile mask -> (T, nT * tile) unit-resolution coverage mask."""
    return tiles.repeat_interleave(tile, dim=-1)


def _valid_first(mask: torch.Tensor) -> torch.Tensor:
    """Indices ordering the last axis of a bool mask True first, each part
    in ascending index (a stable sort: ``torch.topk`` promises no order
    among equal scores, where the reference's ``lax.top_k`` keeps it)."""
    return torch.argsort(mask.logical_not().to(torch.uint8), dim=-1,
                         stable=True)


def pack_tile_indices(tile_mask: torch.Tensor, k: int, n_groups: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity packing: (T, nT) bool -> (idx (T, k') int32, nvalid
    (T,) int32), k' = min(k, nT) (n_groups rounds it up to a multiple).

    Active tiles come first in ascending tile id, then the pads, which
    repeat the row's first entry. Rows with more than k actives keep their
    k lowest ids.

    ``n_groups > 1`` packs model-axis-locally, as the reference does for a
    d_ff split over n_groups shards: the tile axis is cut into n_groups
    contiguous slices, each selecting (and truncating) its own
    ceil(k / n_groups) from its slice. The groups are ascending ranges, so
    the valid-first list is still globally ascending: at full capacity it
    is the n_groups = 1 list."""
    T, nT = tile_mask.shape
    k = min(k, nT)
    if n_groups <= 1:
        order = _valid_first(tile_mask)[:, :k]
        nvalid = torch.clamp(tile_mask.sum(-1), max=k).to(torch.int32)
        keep = torch.arange(k, device=tile_mask.device)[None, :] < nvalid[:, None]
        idx = torch.where(keep, order, order[:, :1])
        return idx.to(torch.int32), nvalid
    if nT % n_groups:
        raise ValueError(f"n_tiles={nT} not divisible by "
                         f"n_groups={n_groups} shards")
    gsz = nT // n_groups
    k_g = min(gsz, -(-k // n_groups))
    mg = tile_mask.reshape(T, n_groups, gsz)
    dev = tile_mask.device
    idx = (_valid_first(mg)[..., :k_g]
           + (torch.arange(n_groups, device=dev) * gsz)[None, :, None])
    ng = torch.clamp(mg.sum(-1), max=k_g)  # (T, G)
    valid = torch.arange(k_g, device=dev)[None, None, :] < ng[..., None]
    kt = n_groups * k_g
    # valid first across the groups, group-major: globally ascending
    order = _valid_first(valid.reshape(T, kt))
    idx = torch.gather(idx.reshape(T, kt), 1, order)
    nvalid = ng.sum(-1).to(torch.int32)
    keep = torch.arange(kt, device=dev)[None, :] < nvalid[:, None]
    idx = torch.where(keep, idx, idx[:, :1])
    return idx.to(torch.int32), nvalid


def tile_counts(idx: torch.Tensor, nvalid: torch.Tensor,
                n_tiles: int) -> torch.Tensor:
    """(T, k), (T,) -> (T, n_tiles) int32: how many valid slots of each row
    name each tile. The list-driven kernels add one product per valid slot,
    so a tile a row lists twice counts twice."""
    T, k = idx.shape
    valid = torch.arange(k, device=idx.device)[None, :] < nvalid[:, None]
    out = torch.zeros((T, n_tiles), dtype=torch.int32, device=idx.device)
    return out.scatter_add_(1, idx.long(), valid.to(torch.int32))


def covered_tiles(idx: torch.Tensor, nvalid: torch.Tensor,
                  n_tiles: int) -> torch.Tensor:
    """Invert packing: (T, k), (T,) -> (T, n_tiles) bool tiles gathered."""
    T, k = idx.shape
    valid = torch.arange(k, device=idx.device)[None, :] < nvalid[:, None]
    out = torch.zeros((T, n_tiles), dtype=torch.int32, device=idx.device)
    out.scatter_reduce_(1, idx.long(), valid.to(torch.int32), reduce="amax")
    return out.bool()


# ---------------------------------------------------------------------------
# training-free construction


def gate_weight_key(cfg: ModelConfig) -> str:
    """The FFN weight whose pre-activation the activation gates: the gate
    projection for GLU FFNs, the single up projection otherwise."""
    return "wg" if cfg.ffn_kind == "glu" else "wu"


def firing_threshold(cfg: ModelConfig) -> float:
    thr = acts.firing_threshold(cfg.activation, cfg.sparsity.shift)
    if thr is None:
        raise ValueError(
            f"activation {cfg.activation!r} has no exact firing threshold; "
            "the predictor subsystem needs a ReLU-family activation "
            "(relu / shifted_relu / fatrelu)")
    return thr


def sign_predictor(params, cfg: ModelConfig, *, probe_dtype: str = "bfloat16",
                   tau: Optional[float] = None, tile: Optional[int] = None,
                   k_tiles: Optional[int] = None) -> Predictor:
    """Training-free sign predictor straight from the model weights, on
    their device (no copy when ``probe_dtype`` is their dtype). tau
    defaults to the activation's firing threshold (exact at probe_dtype ==
    compute dtype; calibrate for margin at lower probe precision)."""
    thr = firing_threshold(cfg)
    w = params["layers"]["ffn"][gate_weight_key(cfg)]
    L = w.shape[0]
    tile = ffn_tile(cfg) if tile is None else tile
    if cfg.d_ff % tile:
        raise ValueError(f"d_ff={cfg.d_ff} is not a multiple of tile={tile}")
    n_tiles = cfg.d_ff // tile
    tau = thr if tau is None else float(tau)
    return Predictor(
        kind="sign",
        params={"w": w.to(getattr(torch, probe_dtype)),
                "tau": torch.full((L,), tau, dtype=torch.float32,
                                  device=w.device)},
        n_tiles=n_tiles,
        k_tiles=n_tiles if k_tiles is None else min(k_tiles, n_tiles),
        tile=tile,
        target_recall=1.0,
        probe_dtype=probe_dtype,
    )
