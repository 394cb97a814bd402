"""Checkpoints in the reference's format (``checkpoint/manager.py``), so a
tree saved by one package loads in the other.

One directory per step, ``step_{step:010d}/``, holding
  manifest.json — step, leaf count, per-leaf dtype/shape, extras (JSON)
  arrays.npz    — the leaves keyed "0".."n-1" in the reference's flattening
                  order (``tree.flatten``: dict keys sorted, sequences and
                  NamedTuples in order, depth first), so ``(params,
                  OptState)`` visits the same leaves as the reference's.
Writes are atomic (a temporary directory renamed into place) and keep the
newest ``keep`` steps. With ``async_save`` the leaves are copied to the
host on the calling thread and written by a daemon thread, so training
steps on while the disk works (the reference's writer); ``wait()`` joins
it. Restored leaves are numpy arrays; the caller puts them on its device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

Tree = Any


def _host(leaf) -> np.ndarray:
    """A host copy of the leaf (a tensor is copied even on the CPU: a
    write in flight must not see the caller's later in-place updates)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


class CheckpointManager:
    """Saves and restores trees under ``directory``. ``async_save`` writes
    in the background (the reference's default; the port's is False, so a
    ``save`` returns with the step on disk unless asked otherwise)."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Tree, extras: Optional[Dict] = None,
             block: bool = False) -> None:
        """Snapshot ``tree`` (torch or numpy leaves; numpy has no bfloat16,
        so cast such leaves first) to host memory now, then write it as
        step ``step``: in the background when ``async_save`` and not
        ``block``, else before returning. A save first waits for the one
        before it; the newest complete step on disk is never touched."""
        leaves = [_host(l) for l in flatten(tree)]
        manifest = {
            "step": int(step),
            "n_leaves": len(leaves),
            "dtypes": [str(l.dtype) for l in leaves],
            "shapes": [list(l.shape) for l in leaves],
            "extras": extras or {},
        }
        self.wait()

        def write():
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

        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Join the background write, if one is in flight."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
        ``step`` (default the latest). A 0-d leaf comes back 0-d."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = [data[str(i)] for i in range(manifest["n_leaves"])]
        return unflatten(template, leaves), manifest["extras"]
