"""Tile-gathered sparse matmuls.

Kernels (CUDA C++, sm_90a), ports of the TPU kernels of
``src/repro/kernels/sparse_matmul.py``:

- ``sparse_matmul_tokens`` (``csrc/sparse_matmul_tokens.cu``): per-row tile
  lists, the down-projection of chunked prefill and of the unfused
  predictor FFN;
- ``sparse_matmul`` (``csrc/sparse_matmul.cu``): one tile list shared by
  every row, the down-projection of ``ops.sparse_ffn_apply``;
- ``sparse_up_matmul`` (``csrc/sparse_up_matmul.cu``): output-tile gather,
  the up-projection of the unfused predictor FFN;
- ``expert_up_matmul`` / ``expert_down_matmul`` (``csrc/expert_up_matmul.cu``,
  ``csrc/expert_down_matmul.cu``): the grouped per-expert gathers over the
  stacked (E, ...) expert weights, driven by ``expert_tile_lists`` (plain
  torch, as in the reference); the up- and down-projection of the
  grouped-gather MoE FFN (``models/moe.py`` ``apply_moe_gathered``).

The two down-projections share the row gather of ``csrc/common.cuh``:
blocks of 16 rows walk consecutive runs of the tile list in list order, and
a second launch sums the runs in order through a (T, S, D) f32 scratch that
``runtime.gather_runs`` keeps under 9 MB; ``expert_down_matmul`` is the same
gather over the stacked weight viewed as one (E * F, d) matrix.
``sparse_up_matmul`` and ``expert_up_matmul`` share ``ffn_up``
(``csrc/ffn_up.cuh``) with ``fused_sparse_ffn``. Each source note says what
bounds the kernel on the H100.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.fused_decode import scatter_compact
from repro_torch.predictor import predictors as preds

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_UP_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DOWN_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


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


# ---------------------------------------------------------------------------
# grouped per-expert gathers (MoE)


def expert_tile_lists(topi, tiles_per_expert: int, k_valid=None):
    """Per-token GLOBAL tile lists from top-k expert routing (the
    reference's ``expert_tile_lists``, exactly).

    topi (T, k) expert ids; tiles_per_expert = F // tile. Token t lists its
    k experts' contiguous tile ranges in routing order: topi[t, 0] * tpe ..
    topi[t, 0] * tpe + tpe - 1, then topi[t, 1]'s, ... ``k_valid`` (T,)
    optionally counts each token's live assignments: entries past
    k_valid * tpe repeat the token's FIRST tile, so padded ids stay in
    range (the kernels skip them through nvalid). Returns (idx (T, k * tpe)
    int32, nvalid (T,) int32)."""
    T, k = topi.shape
    tpe = tiles_per_expert
    dev = topi.device
    idx = (topi.to(torch.int32)[:, :, None] * tpe
           + torch.arange(tpe, dtype=torch.int32, device=dev)[None, None, :])
    idx = idx.reshape(T, k * tpe)
    if k_valid is None:
        return idx, torch.full((T,), k * tpe, dtype=torch.int32, device=dev)
    nvalid = k_valid.to(torch.int32) * tpe
    pos = torch.arange(k * tpe, dtype=torch.int32, device=dev)[None, :]
    return torch.where(pos < nvalid[:, None], idx, idx[:, :1]), nvalid


def _live(idx, nvalid) -> torch.Tensor:
    """(T, K) bool: list slots below each row's nvalid."""
    return (torch.arange(idx.shape[1], device=idx.device)[None, :]
            < nvalid[:, None])


def expert_up_matmul_plain(x, w, idx, nvalid, *, tile: int = 128
                           ) -> torch.Tensor:
    """The plain PyTorch version of ``expert_up_matmul``: every expert's
    dense f32 product, one expert at a time, then each listed block taken
    from it; zeros past nvalid."""
    T = x.shape[0]
    K = idx.shape[1]
    xf = x.float()
    full = torch.stack([xf @ w[e].float() for e in range(w.shape[0])], 1)
    blocks = full.reshape(T, -1, tile)
    compact = torch.gather(blocks, 1, idx.long()[:, :, None].expand(T, K, tile))
    return torch.where(_live(idx, nvalid)[:, :, None], compact, 0.0)


def expert_up_matmul(x, w, idx, nvalid, *, tile: int = 128) -> torch.Tensor:
    """Expert-offset up-projection gather: x (T, d), w (E, d, F) stacked
    expert weights, idx (T, K) int32 GLOBAL tile ids over the (E, F // tile)
    grid (``expert_tile_lists``), nvalid (T,) int32. Returns the compact
    (T, K, tile) f32 blocks: block i of token t is x[t] @ w[e, :, ft * tile:
    (ft + 1) * tile] with (e, ft) = divmod(idx[t, i], F // tile); exact
    zeros past nvalid[t]. CPU tensors take the plain version; CUDA tensors
    launch the kernel (``expert_up_matmul.launches`` counts them)."""
    if rt.on_cpu(x, w, idx, nvalid):
        return expert_up_matmul_plain(x, w, idx, nvalid, tile=tile)
    T, d = x.shape
    E, d2, F = w.shape
    K = idx.shape[1]
    rt.require(d2 == d and F % tile == 0,
               f"x {tuple(x.shape)} / w {tuple(w.shape)} / tile {tile}")
    rt.require(idx.shape == (T, K) and nvalid.shape == (T,), "idx/nvalid shape")
    rt.require(idx.dtype == torch.int32 and nvalid.dtype == torch.int32,
               "idx and nvalid must be int32")
    code = rt.dtype_code(x, w)
    rt.require_contiguous(x=x, w=w, idx=idx, nvalid=nvalid)
    compact = torch.empty((T, K, tile), dtype=torch.float32, device=x.device)
    fn = rt.entry("expert_up_matmul", "expert_up_matmul", _UP_ARGS)
    rc = fn(rt.ptr(x), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(compact),
            T, d, F, K, tile, code, rt.stream_ptr(x.device))
    rt.check(rc, "expert_up_matmul")
    expert_up_matmul.launches += 1
    return compact


expert_up_matmul.launches = 0


def expert_down_matmul_plain(compact, w, idx, nvalid) -> torch.Tensor:
    """The plain PyTorch version of ``expert_down_matmul``: the live blocks
    placed at their (E * F) positions (``scatter_compact``), then each
    expert's f32 product, summed. compact keeps its values (an f32 compact
    with bf16 weights multiplies unrounded, as the reference's promoted dot
    does)."""
    E, F, d = w.shape
    tile = compact.shape[2]
    h = scatter_compact(compact.float(), idx, nvalid, E * F // tile)
    y = torch.zeros((compact.shape[0], d), dtype=torch.float32,
                    device=compact.device)
    for e in range(E):
        y += h[:, e * F:(e + 1) * F] @ w[e].float()
    return y


_DOWN_DTYPES = {(torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16)}


def expert_down_matmul(compact, w, idx, nvalid) -> torch.Tensor:
    """Expert-offset down-projection: compact (T, K, tile) hidden blocks in
    ``expert_up_matmul``'s layout (after the activation and the routing
    gates), w (E, F, d) stacked expert weights, idx/nvalid as there.
    Returns (T, d) f32: token t sums block i @ w[e, ft * tile: (ft + 1) *
    tile, :] over its nvalid[t] live blocks, in list order. Types (compact,
    w): (f32, f32), (bf16, bf16), or (f32, bf16) with compact unrounded.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``expert_down_matmul.launches`` counts them)."""
    if rt.on_cpu(compact, w, idx, nvalid):
        return expert_down_matmul_plain(compact, w, idx, nvalid)
    T, K, tile = compact.shape
    E, F, d = w.shape
    rt.require(F % tile == 0 and d % 2 == 0,
               f"compact {tuple(compact.shape)} / w {tuple(w.shape)}")
    rt.require(idx.shape == (T, K) and nvalid.shape == (T,), "idx/nvalid shape")
    rt.require(idx.dtype == torch.int32 and nvalid.dtype == torch.int32,
               "idx and nvalid must be int32")
    rt.require((compact.dtype, w.dtype) in _DOWN_DTYPES,
               f"dtypes compact {compact.dtype} / w {w.dtype} not supported")
    cc, wc = rt.DTYPE_CODES[compact.dtype], rt.DTYPE_CODES[w.dtype]
    rt.require_contiguous(compact=compact, w=w, idx=idx, nvalid=nvalid)
    y = torch.empty((T, d), dtype=torch.float32, device=compact.device)
    run, scratch = rt.gather_runs(T, K, d, compact.device)
    fn = rt.entry("expert_down_matmul", "expert_down_matmul", _DOWN_ARGS)
    rc = fn(rt.ptr(compact), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid),
            rt.ptr(scratch), rt.ptr(y), T, K, tile, d, run, cc, wc,
            rt.stream_ptr(compact.device))
    rt.check(rc, "expert_down_matmul")
    expert_down_matmul.launches += 1
    return y


expert_down_matmul.launches = 0
