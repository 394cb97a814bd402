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

Sharded trees (the elastic path, the reference's ``restore(shardings=)``):
``save(..., shardings=)`` takes a tree of each rank's blocks and a tree
of ``rules.Sharding`` saying where each lies on the mesh; every leaf is
put back together in full (one gather over the mesh a split leaf, on the
calling thread), rank 0 writes the reference's format (full arrays, the
same manifest), and a barrier follows the write (with ``async_save``, in
``wait()``), so a restore after it sees the step. ``restore(...,
shardings=)`` gives each rank its block of every leaf under the target
shardings, on the target mesh's device, holding one whole leaf on the
host at a time; that mesh may have another size than the saving one (8
ranks saved, 4 restore).
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

from repro_torch.sharding import comm
from repro_torch.tree import flatten, unflatten

Tree = Any


def _host(leaf) -> np.ndarray:
    """A host copy of the leaf (a tensor is copied even on the CPU: a
    write in flight must not see the caller's later in-place updates)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _whole(leaf, sharding) -> Optional[np.ndarray]:
    """On rank 0 of the sharding's mesh, the host copy of a leaf put
    together from every rank's block (one gather to rank 0 where the leaf
    is split, which every rank joins); None on the others."""
    mesh = sharding.mesh
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
    if any(a is not None for a in sharding.spec):
        blocks = comm.gather_to_first(t, mesh)
        if blocks is None:
            return None
        t = sharding.full(blocks)
    return _host(t) if mesh.rank == 0 else None


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
        self._barrier_mesh = None  # a sharded save's write not yet fenced
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Tree, extras: Optional[Dict] = None,
             block: bool = False, shardings: Optional[Tree] = None) -> None:
        """Snapshot ``tree`` (torch or numpy leaves; numpy has no bfloat16,
        so cast such leaves first) to host memory now, then write it as
        step ``step``: in the background when ``async_save`` and not
        ``block``, else before returning. A save first waits for the one
        before it; the newest complete step on disk is never touched.

        With ``shardings`` (a tree of ``rules.Sharding`` in ``tree``'s
        structure) ``tree`` holds this rank's blocks: every rank of the
        mesh must call ``save`` alike; the leaves are put together in full
        and rank 0 writes them, then every rank waits at a barrier."""
        mesh = None
        if shardings is not None:
            sh = flatten(shardings)
            mesh = sh[0].mesh
            leaves = [_whole(l, s) for l, s in zip(flatten(tree), sh)]
            if mesh.rank != 0:
                leaves = None
        else:
            leaves = [_host(l) for l in flatten(tree)]
        self.wait()
        if leaves is None:  # another rank writes
            self._barrier_mesh = mesh
            if not self.async_save or block:
                self.wait()
            return
        manifest = {
            "step": int(step),
            "n_leaves": len(leaves),
            "dtypes": [str(l.dtype) for l in leaves],
            "shapes": [list(l.shape) for l in leaves],
            "extras": extras or {},
        }

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

        self._barrier_mesh = mesh
        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self.wait()

    def wait(self) -> None:
        """Join the background write, if one is in flight; after a sharded
        save, every rank of its mesh then meets at a barrier (every rank
        must call it)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier_mesh is not None:
            mesh, self._barrier_mesh = self._barrier_mesh, None
            comm.barrier(mesh)

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

    def restore(self, template: Tree, step: Optional[int] = None,
                shardings: Optional[Tree] = None) -> Tuple[Tree, Dict]:
        """(tree of numpy leaves in ``template``'s structure, extras) of
        ``step`` (default the latest). A 0-d leaf comes back 0-d. With
        ``shardings`` (a tree of ``rules.Sharding`` in that structure) each
        leaf is this rank's block under its target sharding, a tensor on
        the target mesh's device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        n = manifest["n_leaves"]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            if shardings is None:
                leaves = [data[str(i)] for i in range(n)]
            else:  # each whole leaf is cut, and freed, before the next
                leaves = [s.block(torch.from_numpy(
                    np.ascontiguousarray(data[str(i)])))
                    .to(s.mesh.device, copy=True).contiguous()
                    for i, s in zip(range(n), flatten(shardings))]
        return unflatten(template, leaves), manifest["extras"]
