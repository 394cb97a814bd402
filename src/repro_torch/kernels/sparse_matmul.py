"""Per-row tile-gathered sparse matmul.

Kernel: ``csrc/sparse_matmul_tokens.cu`` (CUDA C++, sm_90a), the port of
the TPU kernel ``src/repro/kernels/sparse_matmul.py:sparse_matmul_tokens``.
Its source note says what bounds it on the H100 (weight bytes); the design
(``csrc/common.cuh``): blocks of 16 rows walk consecutive runs of the tile
list in list order, and a second launch sums the runs in order through a
(T, S, D) f32 scratch that ``runtime.gather_runs`` keeps under 9 MB.

The other kernels of the reference module (``sparse_matmul``,
``sparse_up_matmul``, ``expert_up_matmul``, ``expert_down_matmul``) are not
on this port's serving path yet (ROADMAP.md, queue B).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.predictor import predictors as preds

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def sparse_matmul_tokens_plain(x, w, idx, nvalid, *, tile: int = 128
                               ) -> torch.Tensor:
    """The plain PyTorch version: x with the units of non-listed tiles
    zeroed, times w, in f32 — the same sum, as skipped tiles add exact
    zeros."""
    T, F = x.shape
    units = preds.tiles_to_units(preds.covered_tiles(idx, nvalid, F // tile),
                                 tile)
    xs = torch.where(units, x.to(w.dtype).float(), 0.0)
    return xs @ w.float()


def sparse_matmul_tokens(x, w, idx, nvalid, *, tile: int = 128) -> torch.Tensor:
    """Per-row tile gather: x (T, F), w (F, D), idx (T, K) int32 tile ids,
    nvalid (T,) int32. Returns (T, D) f32: row t sums its own
    idx[t, :nvalid[t]] tiles in list order. CPU tensors take the plain
    version; CUDA tensors launch the kernel
    (``sparse_matmul_tokens.launches`` counts them)."""
    if rt.on_cpu(x, w, idx, nvalid):
        return sparse_matmul_tokens_plain(x, w, idx, nvalid, tile=tile)
    T, F = x.shape
    D = w.shape[1]
    K = idx.shape[1]
    rt.require(w.shape[0] == F and F % tile == 0 and D % 2 == 0,
               f"x {tuple(x.shape)} / w {tuple(w.shape)} / tile {tile}")
    rt.require(idx.shape == (T, K) and nvalid.shape == (T,), "idx/nvalid shape")
    rt.require(idx.dtype == torch.int32 and nvalid.dtype == torch.int32,
               "idx and nvalid must be int32")
    xc, wc = rt.DTYPE_CODES.get(x.dtype), rt.DTYPE_CODES.get(w.dtype)
    rt.require(xc is not None and wc is not None and (xc == wc or xc == 0),
               f"dtypes x {x.dtype} / w {w.dtype} not supported")
    rt.require_contiguous(x=x, w=w, idx=idx, nvalid=nvalid)
    y = torch.empty((T, D), dtype=torch.float32, device=x.device)
    run, scratch = rt.gather_runs(T, K, D, x.device)
    fn = rt.entry("sparse_matmul_tokens", "sparse_matmul_tokens", _ARGS)
    rc = fn(rt.ptr(x), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(scratch),
            rt.ptr(y), T, F, D, K, run, tile, xc, wc, rt.stream_ptr(x.device))
    rt.check(rc, "sparse_matmul_tokens")
    sparse_matmul_tokens.launches += 1
    return y


sparse_matmul_tokens.launches = 0
