"""Tile-gathered sparse matmuls.

Kernels (CUDA C++, sm_90a), ports of the TPU kernels of
``src/repro/kernels/sparse_matmul.py``:

- ``sparse_matmul_tokens`` (``csrc/sparse_matmul_tokens.cu``): per-row tile
  lists, the down-projection of chunked prefill and of the unfused
  predictor FFN;
- ``sparse_matmul`` (``csrc/sparse_matmul.cu``): one tile list shared by
  every row, the down-projection of ``ops.sparse_ffn_apply``;
- ``sparse_up_matmul`` (``csrc/sparse_up_matmul.cu``): output-tile gather,
  the up-projection of the unfused predictor FFN.

The two down-projections share the row gather of ``csrc/common.cuh``:
blocks of 16 rows walk consecutive runs of the tile list in list order, and
a second launch sums the runs in order through a (T, S, D) f32 scratch that
``runtime.gather_runs`` keeps under 9 MB. ``sparse_up_matmul`` shares
``ffn_up`` (``csrc/ffn_up.cuh``) with ``fused_sparse_ffn``. Each source
note says what bounds the kernel on the H100.

The grouped expert gathers of the reference module (``expert_up_matmul``,
``expert_down_matmul``) are not ported yet (ROADMAP.md, queue B).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.fused_decode import scatter_compact
from repro_torch.predictor import predictors as preds

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_UP_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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
    xc, wc = _check_gather(x, w, idx, nvalid, tile, (T, K), (T,))
    y = torch.empty((T, D), dtype=torch.float32, device=x.device)
    run, scratch = rt.gather_runs(T, K, D, x.device)
    fn = rt.entry("sparse_matmul_tokens", "sparse_matmul_tokens", _ARGS)
    rc = fn(rt.ptr(x), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(scratch),
            rt.ptr(y), T, F, D, K, run, tile, xc, wc, rt.stream_ptr(x.device))
    rt.check(rc, "sparse_matmul_tokens")
    sparse_matmul_tokens.launches += 1
    return y


sparse_matmul_tokens.launches = 0


def _check_gather(x, w, idx, nvalid, tile: int, idx_shape, nv_shape):
    """Shapes, types and layout the row-gather kernels take; returns the
    (x, w) dtype codes."""
    T, F = x.shape
    D = w.shape[1]
    rt.require(w.shape[0] == F and F % tile == 0 and D % 2 == 0,
               f"x {tuple(x.shape)} / w {tuple(w.shape)} / tile {tile}")
    rt.require(tuple(idx.shape) == idx_shape and tuple(nvalid.shape) == nv_shape,
               f"idx {tuple(idx.shape)} / nvalid {tuple(nvalid.shape)}")
    rt.require(idx.dtype == torch.int32 and nvalid.dtype == torch.int32,
               "idx and nvalid must be int32")
    xc, wc = rt.DTYPE_CODES.get(x.dtype), rt.DTYPE_CODES.get(w.dtype)
    rt.require(xc is not None and wc is not None and (xc == wc or xc == 0),
               f"dtypes x {x.dtype} / w {w.dtype} not supported")
    rt.require_contiguous(x=x, w=w, idx=idx, nvalid=nvalid)
    return xc, wc


def sparse_matmul_plain(x, w, idx, nvalid, *, tile: int = 128) -> torch.Tensor:
    """The plain PyTorch version of ``sparse_matmul``: x with the units of
    non-listed tiles zeroed, times w, in f32."""
    n_tiles = x.shape[1] // tile
    tiles = preds.covered_tiles(idx.reshape(1, -1), nvalid.reshape(1), n_tiles)
    xs = torch.where(preds.tiles_to_units(tiles, tile),
                     x.to(w.dtype).float(), 0.0)
    return xs @ w.float()


def sparse_matmul(x, w, idx, nvalid, *, tile: int = 128) -> torch.Tensor:
    """One tile list shared by every row: x (T, F), w (F, D), idx (K,) int32
    tile ids in any order, nvalid () int32. Returns (T, D) f32, the sum over
    idx[:nvalid] in list order. CPU tensors take the plain version; CUDA
    tensors launch the kernel (``sparse_matmul.launches`` counts them)."""
    if rt.on_cpu(x, w, idx, nvalid):
        return sparse_matmul_plain(x, w, idx, nvalid, tile=tile)
    T = x.shape[0]
    D, K = w.shape[1], idx.shape[0]
    xc, wc = _check_gather(x, w, idx, nvalid, tile, (K,), ())
    y = torch.empty((T, D), dtype=torch.float32, device=x.device)
    run, scratch = rt.gather_runs(T, K, D, x.device)
    fn = rt.entry("sparse_matmul", "sparse_matmul", _ARGS)
    rc = fn(rt.ptr(x), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(scratch),
            rt.ptr(y), T, x.shape[1], D, K, run, tile, xc, wc,
            rt.stream_ptr(x.device))
    rt.check(rc, "sparse_matmul")
    sparse_matmul.launches += 1
    return y


sparse_matmul.launches = 0


def sparse_up_matmul_plain(x, w, idx, nvalid, *, tile: int = 128
                           ) -> torch.Tensor:
    """The plain PyTorch version of ``sparse_up_matmul``: the dense f32
    product with the columns of non-listed tiles zeroed."""
    cov = preds.tiles_to_units(
        preds.covered_tiles(idx, nvalid, w.shape[1] // tile), tile)
    return torch.where(cov, x.float() @ w.float(), 0.0)


def sparse_up_matmul(x, w, idx, nvalid, *, tile: int = 128) -> torch.Tensor:
    """Output-tile gather for the up-projection: x (T, d), w (d, F), idx
    (T, K) int32 output tile ids, nvalid (T,) int32. Returns (T, F) f32:
    row t's listed tiles of x @ w, exact zeros elsewhere. CUDA tensors launch
    the kernel, which writes a compact (T, K, tile) buffer (zeros past
    nvalid), and ``scatter_compact`` places it (``sparse_up_matmul.launches``
    counts the launches); CPU tensors take the plain version."""
    if rt.on_cpu(x, w, idx, nvalid):
        return sparse_up_matmul_plain(x, w, idx, nvalid, tile=tile)
    T, d = x.shape
    F, K = w.shape[1], idx.shape[1]
    rt.require(w.shape[0] == d and F % tile == 0,
               f"x {tuple(x.shape)} / w {tuple(w.shape)} / tile {tile}")
    rt.require(idx.shape == (T, K) and nvalid.shape == (T,), "idx/nvalid shape")
    rt.require(idx.dtype == torch.int32 and nvalid.dtype == torch.int32,
               "idx and nvalid must be int32")
    code = rt.dtype_code(x, w)
    rt.require_contiguous(x=x, w=w, idx=idx, nvalid=nvalid)
    compact = torch.empty((T, K, tile), dtype=torch.float32, device=x.device)
    fn = rt.entry("sparse_up_matmul", "sparse_up_matmul", _UP_ARGS)
    rc = fn(rt.ptr(x), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(compact),
            T, d, F, K, tile, code, rt.stream_ptr(x.device))
    rt.check(rc, "sparse_up_matmul")
    sparse_up_matmul.launches += 1
    return scatter_compact(compact, idx, nvalid, F // tile)


sparse_up_matmul.launches = 0
