"""The sparse FFN hot path as one entry point (the reference's
``kernels/ops.py``): fused up-projection + ReLU with tile scores
(``fused_up_relu``), static top-k tile selection, then the gathered
down-projection over the shared tile list (``sparse_matmul``).

``sparse_ffn_apply`` runs on the card unless the caller passes
``device="cpu"``, where each kernel wrapper takes its plain version.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.fused_ffn import TILE, fused_up_relu
from repro_torch.kernels.sparse_matmul import sparse_matmul
from repro_torch.models.common import resolve_device, select_active_tiles


def select_tiles_static(scores: torch.Tensor, density: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k tile selection with static capacity k = ceil(density * n):
    (n,) scores -> (idx (k,) int32 in score order, nvalid () int32 the
    count of selected tiles with a score above 0). Equal scores keep
    ascending tile order, as ``lax.top_k`` does in the reference: it is
    ``common.select_active_tiles`` with its mask counted."""
    idx, mask = select_active_tiles(scores, density)
    return idx, mask.sum(dtype=torch.int32)


def sparse_ffn_apply(x, wu, wd, *, density: float = 0.25, shift: float = 0.0,
                     device="cuda"):
    """Full sparse FFN hot path: h = relu(x @ wu - shift); y = h @ wd over
    the top-ceil(density * F / 128) active tiles only, summed in score
    order. x (T, d), wu (d, F), wd (F, D), moved to ``device``. Returns
    (y (T, D) f32, h (T, F) f32, idx (k,) int32, nvalid () int32)."""
    dev = resolve_device(device)
    x, wu, wd = (t.to(dev) for t in (x, wu, wd))
    h, scores = fused_up_relu(x, wu, shift)
    idx, nvalid = select_tiles_static(scores, density)
    y = sparse_matmul(h.to(x.dtype), wd, idx, nvalid, tile=TILE)
    return y, h, idx, nvalid


def flops_saved(F: int, D: int, T: int, density: float) -> dict:
    """Analytic savings of the gathered down-projection (paper Fig. 1c)."""
    dense = 2.0 * T * F * D
    sparse = 2.0 * T * math.ceil(density * F / 128) * 128 * D
    bytes_dense = F * D * 2
    bytes_sparse = math.ceil(density * F / 128) * 128 * D * 2
    return {"dense_flops": dense, "sparse_flops": sparse,
            "flops_saving": 1 - sparse / dense,
            "dense_weight_bytes": bytes_dense,
            "sparse_weight_bytes": bytes_sparse,
            "io_saving": 1 - bytes_sparse / bytes_dense}
