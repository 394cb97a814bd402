"""Activation-function registry (paper Sec. 3 + Sec. 5.3), in torch.

The counterpart of the reference's ``core/activations.py``: the
one-parameter family ``f(x) = x * sigmoid(beta * x)`` (beta=1 is SiLU,
beta≈1.7 approximates GELU, beta→inf is ReLU), tanh-approximate GELU, ReLU,
the paper's shifted ReLU ``relu(x - b)`` and FATReLU thresholding.

``kernel_code`` maps a resolved activation onto the (enum, parameter) pair
the CUDA FFN kernels apply in-kernel (csrc/ffn_up.cuh); the enum values
there must match ``ACT_*`` here. ``ACT_IDENTITY`` is the bare product of
the ``sparse_up_matmul`` kernel.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Act = Callable[[torch.Tensor], torch.Tensor]

# enum shared with csrc/ffn_up.cuh
(ACT_RELU, ACT_GELU_TANH, ACT_GATED_SIGMOID, ACT_SHIFTED_RELU, ACT_FATRELU,
 ACT_IDENTITY) = range(6)


def relu(x):
    return torch.relu(x)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


def gated_sigmoid(x, beta: float):
    """f(x) = x * sigmoid(beta x). beta=1: SiLU; beta->inf: ReLU (Fig. 2a)."""
    return x * torch.sigmoid(beta * x)


def shifted_relu(x, shift: float):
    """relu(x - b) — paper Sec. 5.3."""
    return torch.relu(x - shift)


def fat_relu(x, threshold: float):
    """FATReLU: x if x > t else 0."""
    return torch.where(x > threshold, x, torch.zeros_like(x))


_REGISTRY: Dict[str, Act] = {
    "relu": relu,
    "gelu": gelu,
    "silu": silu,
    "swish": silu,
    "silu_b1": functools.partial(gated_sigmoid, beta=1.0),
    "gelu_b1.7": functools.partial(gated_sigmoid, beta=1.7),
    "gated_b8": functools.partial(gated_sigmoid, beta=8.0),
}

_GATED_BETA = {"silu": 1.0, "swish": 1.0, "silu_b1": 1.0, "gelu_b1.7": 1.7,
               "gated_b8": 8.0}


def register(name: str, fn: Act) -> None:
    """Add (or replace) a named activation."""
    _REGISTRY[name] = fn


def get(name: str, shift: float = 0.0) -> Act:
    """Resolve an activation by name: registry keys, ``beta=<float>``,
    ``shifted_relu`` (uses ``shift``), ``shifted_relu:<b>``, ``fatrelu:<t>``."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith("beta="):
        return functools.partial(gated_sigmoid, beta=float(name[5:]))
    if name == "shifted_relu":
        return functools.partial(shifted_relu, shift=shift)
    if name.startswith("shifted_relu:"):
        return functools.partial(shifted_relu, shift=float(name.split(":", 1)[1]))
    if name.startswith("fatrelu:"):
        return functools.partial(fat_relu, threshold=float(name.split(":", 1)[1]))
    raise KeyError(f"unknown activation {name!r}; known: {sorted(_REGISTRY)}")


def kernel_code(name: str, shift: float = 0.0) -> Tuple[int, float]:
    """(ACT_* enum, parameter) of an activation for the CUDA FFN kernel:
    beta for the gated family, the shift for shifted ReLU, the threshold
    for FATReLU, unused (0) otherwise."""
    if name == "relu":
        return ACT_RELU, 0.0
    if name == "gelu":
        return ACT_GELU_TANH, 0.0
    if name in _GATED_BETA:
        return ACT_GATED_SIGMOID, _GATED_BETA[name]
    if name.startswith("beta="):
        return ACT_GATED_SIGMOID, float(name[5:])
    if name == "shifted_relu":
        return ACT_SHIFTED_RELU, float(shift)
    if name.startswith("shifted_relu:"):
        return ACT_SHIFTED_RELU, float(name.split(":", 1)[1])
    if name.startswith("fatrelu:"):
        return ACT_FATRELU, float(name.split(":", 1)[1])
    raise KeyError(f"unknown activation {name!r}; known: {sorted(_REGISTRY)}")


def is_sparse_activation(name: str) -> bool:
    """Does this activation produce exact zeros (hence exploitable
    sparsity)?"""
    return (name == "relu" or name.startswith("shifted_relu")
            or name.startswith("fatrelu"))


def firing_threshold(name: str, shift: float = 0.0) -> Optional[float]:
    """Pre-activation threshold above which a ReLU-family unit fires
    (f(pre) != 0 iff pre > threshold); None for soft activations."""
    if name == "relu":
        return 0.0
    if name == "shifted_relu":
        return shift
    if name.startswith("shifted_relu:"):
        return float(name.split(":", 1)[1])
    if name.startswith("fatrelu:"):
        return float(name.split(":", 1)[1])
    return None


def sparsity_of(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Fraction of entries that are (exactly or nearly) zero, an f32
    scalar on x's device."""
    return (x.abs() <= eps).float().mean()
