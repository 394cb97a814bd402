"""Tile-list machinery of the activity predictors (the subset of the
reference's ``predictor/predictors.py`` the serving path uses): unit <->
tile masks and the fixed-capacity packing every gather kernel consumes.

The probes, sign/low-rank predictors and calibration are not ported yet
(ROADMAP.md)."""
from __future__ import annotations

from typing import Tuple

import torch


def units_to_tiles(units: torch.Tensor, tile: int) -> torch.Tensor:
    """(T, F) unit mask -> (T, F // tile) tile mask (any unit in the tile)."""
    T, F = units.shape
    return units.reshape(T, F // tile, tile).any(-1)


def tiles_to_units(tiles: torch.Tensor, tile: int) -> torch.Tensor:
    """(T, nT) tile mask -> (T, nT * tile) unit-resolution coverage mask."""
    return tiles.repeat_interleave(tile, dim=-1)


def pack_tile_indices(tile_mask: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity packing (the reference's ``n_groups=1`` case):
    (T, nT) bool -> (idx (T, k') int32, nvalid (T,) int32), k' = min(k, nT).

    Active tiles come first in ascending tile id, then the pads, which
    repeat the row's first entry. The reference gets that order from
    ``lax.top_k`` being stable on {0, 1} scores; ``torch.topk`` is not
    stable, so this uses a stable sort. Rows with more than k actives keep
    their k lowest ids."""
    T, nT = tile_mask.shape
    k = min(k, nT)
    order = torch.argsort(tile_mask.logical_not().to(torch.uint8), dim=-1,
                          stable=True)[:, :k]
    nvalid = torch.clamp(tile_mask.sum(-1), max=k).to(torch.int32)
    keep = torch.arange(k, device=tile_mask.device)[None, :] < nvalid[:, None]
    idx = torch.where(keep, order, order[:, :1])
    return idx.to(torch.int32), nvalid


def covered_tiles(idx: torch.Tensor, nvalid: torch.Tensor,
                  n_tiles: int) -> torch.Tensor:
    """Invert packing: (T, k), (T,) -> (T, n_tiles) bool tiles gathered."""
    T, k = idx.shape
    valid = torch.arange(k, device=idx.device)[None, :] < nvalid[:, None]
    out = torch.zeros((T, n_tiles), dtype=torch.int32, device=idx.device)
    out.scatter_reduce_(1, idx.long(), valid.to(torch.int32), reduce="amax")
    return out.bool()
