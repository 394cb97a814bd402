"""Reference parameters -> port parameters.

``params_from_jax`` takes the JAX package's parameter tree as numpy arrays
(``params["layers"]`` stacked on a leading layer axis, as its
``transformer.init_params`` builds it) and returns the port's tree: the
same names and layouts, each float leaf stored once in the compute dtype on
the device for serving, or as f32 masters for training (``dtype=
torch.float32``; the port's ``transformer.forward`` casts them at its
entry, as the reference's ``cast_params`` does at every call). The values
both compute with are the same.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def params_from_jax(np_params: Any, cfg: ModelConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None):
    """Map a nested dict of numpy arrays onto torch tensors on ``device``
    (floats cast to ``dtype``, default ``cfg.compute_dtype``)."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        t = torch.from_numpy(np.array(a))  # a writable copy
        return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)

    return conv(np_params)
