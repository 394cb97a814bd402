"""Tile-activity scores (plain torch; XLA functions in the reference's
``kernels/fused_ffn.py``, not kernels). The reference's ``fused_up_relu*``
Pallas kernels are not on this port's serving path yet (ROADMAP.md)."""
from __future__ import annotations

import torch

TILE = 128


def tile_activity(h: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Per-token tile-activity scores: (T, F) -> (T, F // tile) max |h|."""
    T, F = h.shape
    return h.abs().reshape(T, F // tile, tile).amax(-1)


def window_tile_activity(h: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Window-union tile-activity scores: (B, W, F) -> (B, F // tile), the
    max |h| over the window tokens and the tile lanes."""
    B, W, F = h.shape
    return h.abs().reshape(B, W, F // tile, tile).amax(dim=(1, 3))
