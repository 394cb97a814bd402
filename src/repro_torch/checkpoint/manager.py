"""Checkpoints in the reference's format (``checkpoint/manager.py``), so a
tree saved by one package loads in the other.

One directory per step, ``step_{step:010d}/``, holding
  manifest.json — step, leaf count, per-leaf dtype/shape, extras (JSON)
  arrays.npz    — the leaves keyed "0".."n-1" in the reference's flattening
                  order: ``jax.tree_util.tree_flatten``, which visits dict
                  keys sorted and sequences in order, depth first.
Writes are atomic (a temporary directory renamed into place) and keep the
newest ``keep`` steps. Saves are synchronous: the reference's background
writer thread is not ported. Restored leaves are numpy arrays; the caller
puts them on its device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


def flatten(tree: Tree) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_flatten`` order: dicts by sorted key,
    lists and tuples in order, None an empty subtree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in flatten(v)]
    return [] if tree is None else [tree]


def unflatten(template: Tree, leaves: List[Any]) -> Tree:
    """Rebuild ``template``'s structure from leaves in ``flatten`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Tree, extras: Optional[Dict] = None
             ) -> None:
        """Write ``tree`` (torch or numpy leaves; numpy has no bfloat16, so
        cast such leaves first) as step ``step``, returning when it is on
        disk."""
        leaves = [_host(l) for l in flatten(tree)]
        manifest = {
            "step": int(step),
            "n_leaves": len(leaves),
            "dtypes": [str(l.dtype) for l in leaves],
            "shapes": [list(l.shape) for l in leaves],
            "extras": extras or {},
        }
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        try:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{str(i): l for i, l in enumerate(leaves)})
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def all_steps(self) -> List[int]:
        return sorted(int(n[5:]) for n in os.listdir(self.dir)
                      if n.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Tree, step: Optional[int] = None
                ) -> Tuple[Tree, Dict]:
        """(tree of numpy leaves in ``template``'s structure, extras) of
        ``step`` (default the latest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = [data[str(i)] for i in range(manifest["n_leaves"])]
        return unflatten(template, leaves), manifest["extras"]
