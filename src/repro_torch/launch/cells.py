"""The assigned (arch × shape) cell plan: the port's copy of the
reference's ``launch/cells.py``.

40 nominal cells; long_500k runs only for the subquadratic archs
(zamba2, falcon-mamba), the pure full-attention archs skip it. Decode
cells are planned dense AND sparse (relufied, at a static FFN tile
density) so the roofline table shows the paper's saving.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import ASSIGNED, get_config

# per-arch microbatch counts of the train cells
_TRAIN_MICROBATCHES = {
    "deepseek-67b": 16,
    "mixtral-8x22b": 8,
    "phi3.5-moe-42b-a6.6b": 8,
    "starcoder2-15b": 8,
    "qwen2-7b": 8,
    "qwen3-4b": 8,
    "zamba2-7b": 16,
    "falcon-mamba-7b": 8,
    "internvl2-1b": 2,
    "whisper-small": 2,
}

# archs whose train/prefill cells run Megatron-SP sharded residuals
_SP_RESIDUALS = {"deepseek-67b", "falcon-mamba-7b", "mixtral-8x22b",
                 "zamba2-7b"}
_SP_PREFILL = {"deepseek-67b"}
# remat policy per arch (save_ars: keep the sublayers' outputs)
_REMAT = {"deepseek-67b": "save_ars", "mixtral-8x22b": "save_ars"}

# decode-cell sparse variants: the static FFN tile density. Batch-1 long
# context keeps per-token sparsity; batched decode takes the cross-batch
# tile union, which is denser.
_SPARSE_DENSITY = {"decode_32k": 0.60, "long_500k": 0.125}


def skip_reason(arch: str, shape: str) -> str:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return "full-attention arch: 500k ctx needs sub-quadratic attention"
    return ""


def cell_plan(multi_pod: bool = False, include_sparse: bool = True
              ) -> List[Dict]:
    cells = []
    for arch in ASSIGNED:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if skip_reason(arch, shape):
                continue
            cell = {"arch": arch, "shape": shape, "multi_pod": multi_pod}
            if shape == "train_4k":
                cell["microbatches"] = _TRAIN_MICROBATCHES.get(arch, 4)
                if arch in _SP_RESIDUALS:
                    cell["sp"] = True
                if arch in _REMAT:
                    cell["remat"] = _REMAT[arch]
            if shape == "prefill_32k" and arch in _SP_PREFILL:
                cell["sp"] = True
            cells.append(cell)
            if include_sparse and shape in _SPARSE_DENSITY and not multi_pod:
                cells.append({**cell, "sparse": _SPARSE_DENSITY[shape]})
    return cells
