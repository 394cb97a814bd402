"""AdamW with decoupled weight decay (the paper's fine-tuning recipe), as
the reference's ``optim/adamw.py``: f32 moments, decay on matrices only
(ndim >= 2), bias corrections from the step on the device.

Functional over parameter trees: ``adamw_update`` returns new params and a
new ``OptState``, leaf by leaf under ``torch.no_grad()``, so at most one
leaf's new tensors are in flight beside the old tree. The port trains on
one device, so the moments live beside the params there (the reference
shards them with the params, ZeRO-style).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import flatten, tree_map, unflatten

Tree = Any


class OptState(NamedTuple):
    step: torch.Tensor  # () int32, on the params' device
    m: Tree
    v: Tree


def init_opt_state(params: Tree) -> OptState:
    """Step 0 and zero f32 moments shaped like ``params``."""
    leaves = flatten(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, summed leaf by leaf
    in the reference's leaf order."""
    total = 0
    for leaf in flatten(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)) in f32 and cast
    back to their dtypes, the norm before clipping)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(grads: Tree, state: OptState, params: Tree,
                 lr: torch.Tensor, tc: TrainConfig) -> Tuple[Tree, OptState]:
    """One AdamW step: (new params, new OptState). lr is a 0-d tensor (the
    schedule's); the bias corrections 1 - b^t use the device step t."""
    step = state.step + 1
    b1, b2, eps, wd = tc.b1, tc.b2, tc.eps, tc.weight_decay
    t = step.float()
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(flatten(params), flatten(grads), flatten(state.m),
                          flatten(state.v)):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf.square()
        update = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        # decoupled weight decay on matrices only (ndim >= 2), like the
        # usual no-decay-on-norms/bias convention
        if p.dim() >= 2:
            update = update + wd * p.float()
        new_p.append((p.float() - lr * update).to(p.dtype))
        new_m.append(m2)
        new_v.append(v2)
    return unflatten(params, new_p), OptState(
        step=step, m=unflatten(state.m, new_m), v=unflatten(state.v, new_v))
