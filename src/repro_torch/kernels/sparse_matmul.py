"""Tile-gathered sparse matmuls.

Kernels (CUDA C++, sm_90a), ports of the TPU kernels of
``src/repro/kernels/sparse_matmul.py``:

- ``sparse_matmul_tokens`` (``csrc/sparse_matmul_tokens.cu``): per-row tile
  lists, the down-projection of chunked prefill and of the unfused
  predictor FFN;
- ``sparse_matmul`` (``csrc/sparse_matmul.cu``): one tile list shared by
  every row, the down-projection of ``ops.sparse_ffn_apply``; with bf16
  weights the shared-list mode of ``csrc/tile_group.cuh`` (chunks of 64
  consecutive rows, the list's valid slots walked in list order, x and the
  weight brought by the TMA engine as boxes, tensor cores);
- ``sparse_up_matmul`` (``csrc/sparse_up_matmul.cu``): output-tile gather,
  the up-projection of the unfused predictor FFN;
- ``expert_up_matmul`` / ``expert_down_matmul`` (``csrc/expert_up_matmul.cu``,
  ``csrc/expert_down_matmul.cu``): the grouped per-expert gathers over the
  stacked (E, ...) expert weights, driven by ``expert_tile_lists`` (plain
  torch, as in the reference); the up- and down-projection of the
  grouped-gather MoE FFN (``models/moe.py`` ``apply_moe_gathered``).

With bf16 weights, ``sparse_matmul_tokens`` and ``expert_down_matmul`` run
the tile-grouped routine of ``csrc/tile_group.cuh``: the tile ids are cut
into runs (one expert for ``expert_down_matmul``), the rows that name a run
into chunks of 64 (``tile_group_plan`` is that chunking in plain torch),
and a block reads each weight tile its chunk lists once, on tensor cores,
with no host sync; a second launch sums each row's runs in ascending order
through scratch kept under 32 MiB. With f32 weights they, like
``sparse_matmul`` and the down-projection of ``fused_sparse_ffn``, run the
CUDA-core row gather of ``csrc/common.cuh`` (blocks of 16 rows walk runs of
list slots in list order; ``runtime.gather_runs`` keeps its scratch under
9 MB). Every kernel adds one product per valid list slot, so a tile listed
twice counts twice, as in the reference; the plain versions weight each
tile by its count (``predictors.tile_counts``). An f32 x against bf16
weights is multiplied unrounded, as the reference's promoted dot does.
``sparse_up_matmul`` and ``expert_up_matmul`` with bf16 x and weights at
tile 128 run the tensor-core up-projection routine of ``csrc/up_tiles.cuh``
(a block per weight tile, a global tile id of the stacked experts for
``expert_up_matmul``, and chunk of up to 64 rows listing it), as does the
up half of ``fused_sparse_ffn``; in f32 they share ``ffn_up``
(``csrc/ffn_up.cuh``) with ``fused_sparse_ffn``. Each source note says what
bounds the kernel on the H100.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.kernels.fused_decode import scatter_compact
from repro_torch.kernels.runtime import (TG_M, TG_MAX_RUNS, TG_RMAX,
                                         TG_SCRATCH_BYTES, tile_group_slab_rows)
from repro_torch.predictor import predictors as preds

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_UP_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def sparse_matmul_tokens_plain(x, w, idx, nvalid, *, tile: int = 128
                               ) -> torch.Tensor:
    """The plain PyTorch version: x's units weighted by the number of valid
    slots naming their tile (zero for non-listed tiles), times w, in f32 —
    the same sum, as skipped tiles add exact zeros and a tile listed twice
    adds its product twice. An f32 x against bf16 weights keeps its values,
    as the reference's promoted dot does."""
    T, F = x.shape
    counts = preds.tiles_to_units(preds.tile_counts(idx, nvalid, F // tile),
                                  tile)
    return (x.float() * counts) @ w.float()


def sparse_matmul_tokens(x, w, idx, nvalid, *, tile: int = 128) -> torch.Tensor:
    """Per-row tile gather: x (T, F), w (F, D), idx (T, K) int32 tile ids,
    nvalid (T,) int32. Returns (T, D) f32: row t sums one product per valid
    slot of its idx[t, :nvalid[t]] list. CPU tensors take the plain version;
    CUDA tensors launch the kernel (``sparse_matmul_tokens.launches`` counts
    them): for bf16 weights the tile-grouped tensor-core routine (an f32 x
    multiplied unrounded, as three bf16 terms), for f32 weights and x the
    CUDA-core row gather."""
    if rt.on_cpu(x, w, idx, nvalid):
        return sparse_matmul_tokens_plain(x, w, idx, nvalid, tile=tile)
    T, F = x.shape
    D = w.shape[1]
    K = idx.shape[1]
    xc, wc = _check_gather(x, w, idx, nvalid, tile, (T, K), (T,))
    y = torch.empty((T, D), dtype=torch.float32, device=x.device)
    if wc == rt.DTYPE_CODES[torch.float32]:
        run, scratch = rt.gather_runs(T, K, D, x.device)
        fn = rt.entry("sparse_matmul_tokens", "sparse_matmul_tokens",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        rc = fn(rt.ptr(x), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid),
                rt.ptr(scratch), rt.ptr(y), T, F, D, K, run, tile,
                rt.stream_ptr(x.device))
    else:
        R = min(F // tile, TG_RMAX)
        fn = rt.entry("sparse_matmul_tokens", "sparse_matmul_tokens_tc",
                      _TC_ARGS + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        rc = _tile_groups(fn, x, w, idx, nvalid, y,
                          n_tiles=F // tile, run=R, tile=tile,
                          ints=lambda T_, S: (T_, F, D, K, S, R, tile, xc))
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
               lambda: f"x {tuple(x.shape)} / w {tuple(w.shape)} / tile {tile}")
    rt.require(idx.shape == idx_shape and nvalid.shape == nv_shape,
               lambda: f"idx {tuple(idx.shape)} / nvalid {tuple(nvalid.shape)}")
    rt.require(idx.dtype == torch.int32 and nvalid.dtype == torch.int32,
               "idx and nvalid must be int32")
    xc, wc = rt.DTYPE_CODES.get(x.dtype), rt.DTYPE_CODES.get(w.dtype)
    rt.require(xc is not None and wc is not None
               and (xc == wc or xc == rt.DTYPE_CODES[torch.float32]),
               lambda: f"dtypes x {x.dtype} / w {w.dtype} not supported")
    rt.require_contiguous(x=x, w=w, idx=idx, nvalid=nvalid)
    return xc, wc


# ---------------------------------------------------------------------------
# the tile-grouped tensor-core routine (csrc/tile_group.cuh)

# its chunk size, longest run and most runs, and the bound on its scratch
# (kernels/runtime.py); the longest shared list
TG_LIST_MAX = TG_M * TG_RMAX
_TC_ARGS = [ctypes.c_void_p] * 7  # a, w, idx, nvalid, mask, P, y


class TilePlan(NamedTuple):
    """The chunks of the tile-grouped routine: mask (T,) int64, bit s set
    when a valid slot of row t names a tile of run s; chunk_rows (n_runs *
    ceil(T / chunk), chunk) int32, chunk s * ceil(T / chunk) + c holding
    the rows of run s ranked c * chunk .. in ascending order, -1 past
    them."""
    mask: torch.Tensor
    chunk_rows: torch.Tensor


def tile_group_plan(idx, nvalid, run: int, n_runs: int,
                    chunk: int = TG_M) -> TilePlan:
    """The plain version of the routine's chunking (``row_runs`` and the
    blocks' row ranking in csrc/tile_group.cuh), in exact torch integer ops:
    tile ids are cut into ``n_runs`` runs of ``run`` consecutive ids; row t
    has a (row, run) pair in run s when one of its valid slots names a tile
    of s. The pairs of a run, rows ascending, are cut into chunks of at most
    ``chunk``; the launch grid holds ceil(T / chunk) chunks a run (the upper
    bound), so it needs no count from the device."""
    T, K = idx.shape
    dev = idx.device
    live = torch.arange(K, device=dev)[None, :] < nvalid[:, None]
    runs = torch.where(live, idx.long() // run, n_runs)
    pres = torch.zeros((T, n_runs + 1), dtype=torch.bool, device=dev)
    pres = pres.scatter_(1, runs, True)[:, :n_runs]                # (T, S)
    bits = torch.ones((), dtype=torch.int64, device=dev) << torch.arange(
        n_runs, device=dev)
    mask = (pres.long() * bits).sum(1)
    cpr = -(-T // chunk)
    rank = torch.cumsum(pres, 0) - 1                               # (T, S)
    dump = n_runs * cpr * chunk
    pos = torch.where(pres, torch.arange(n_runs, device=dev) * cpr * chunk
                      + rank, dump)
    rows = torch.arange(T, dtype=torch.int32, device=dev)[:, None].expand(T, n_runs)
    chunk_rows = torch.full((dump + 1,), -1, dtype=torch.int32, device=dev)
    chunk_rows.scatter_(0, pos.reshape(-1), rows.reshape(-1))
    return TilePlan(mask, chunk_rows[:dump].view(n_runs * cpr, chunk))


def _tile_groups(fn, a, w, idx, nvalid, y, *, n_tiles: int, run: int,
                 tile: int, ints) -> int:
    """Launch a ``*_tc`` entry point (csrc/tile_group.cuh) over the rows of
    a / idx / nvalid / y; ``ints(T, n_runs)`` gives its integer arguments.
    Rows go in slabs whose scratch (the runs mask and the pair partials)
    stays under TG_SCRATCH_BYTES. Returns the first non-zero CUDA error
    code, else 0."""
    T, K = idx.shape
    D = y.shape[1]
    n_runs = -(-n_tiles // run)
    rt.require(tile % 16 == 0 and D % 8 == 0 and n_runs <= TG_MAX_RUNS,
               lambda: f"the tensor-core gather takes tile % 16 == 0, D % 8 == "
                       f"0 and at most {TG_MAX_RUNS} runs of {run} tiles; got "
                       f"tile {tile}, D {D}, {n_runs} runs")
    stream = rt.stream_ptr(y.device)
    if n_runs == 1:  # no scratch: one launch over every row
        return fn(rt.ptr(a), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid), None, None,
                  rt.ptr(y), *ints(T, 1), stream)
    slab = tile_group_slab_rows(D, n_runs)
    for r0 in range(0, T, slab):
        r1 = min(T, r0 + slab)
        mask = torch.empty(r1 - r0, dtype=torch.int64, device=y.device)
        P = torch.empty((n_runs * (r1 - r0), D), dtype=torch.float32,
                        device=y.device)
        rc = fn(rt.ptr(a[r0:r1]), rt.ptr(w), rt.ptr(idx[r0:r1]),
                rt.ptr(nvalid[r0:r1]), rt.ptr(mask), rt.ptr(P),
                rt.ptr(y[r0:r1]), *ints(r1 - r0, n_runs), stream)
        if rc:
            return rc
    return 0


def sparse_matmul_plain(x, w, idx, nvalid, *, tile: int = 128) -> torch.Tensor:
    """The plain PyTorch version of ``sparse_matmul``: x's units weighted by
    the number of valid slots naming their tile, times w, in f32 (an f32 x
    unrounded against bf16 weights, as the reference's promoted dot)."""
    n_tiles = x.shape[1] // tile
    counts = preds.tile_counts(idx.reshape(1, -1), nvalid.reshape(1), n_tiles)
    return (x.float() * preds.tiles_to_units(counts, tile)) @ w.float()


def shared_list_columns(T: int) -> int:
    """Output columns a block of the shared-list mode takes: 32 when the
    rows fit one chunk of TG_M (twice the blocks of 64 columns, for a grid
    of a few rows), else 64."""
    return 32 if T <= TG_M else 64


@torch.library.custom_op("repro_torch::sparse_matmul", mutates_args=())
def sparse_matmul_op(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                     nvalid: torch.Tensor, tile: int) -> torch.Tensor:
    """``sparse_matmul`` as one operator of torch's dispatcher, so that a
    dispatch mode sees kernel 5 whole: on "meta" tensors its fake makes
    the empty (T, D) f32 output, and the dry run's ``launch/op_cost.py``
    counts the call by the kernel's own bytes and FLOPs."""
    return sparse_matmul(x, w, idx, nvalid, tile=tile)


@sparse_matmul_op.register_fake
def _(x, w, idx, nvalid, tile):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.float32)


def sparse_matmul(x, w, idx, nvalid, *, tile: int = 128) -> torch.Tensor:
    """One tile list shared by every row: x (T, F), w (F, D), idx (K,) int32
    tile ids in any order, nvalid () int32. Returns (T, D) f32, the sum over
    idx[:nvalid] in list order. CPU tensors take the plain version; CUDA
    tensors launch the kernel (``sparse_matmul.launches`` counts them): for
    bf16 weights the shared-list mode of the tile-grouped tensor-core
    routine (an f32 x multiplied unrounded, as three bf16 terms), for f32
    weights and x the CUDA-core row gather. On "meta" tensors (the dry
    run) it is the operator ``sparse_matmul_op``, which a dispatch mode
    sees as one call."""
    if rt.on_cpu(x, w, idx, nvalid):
        if x.is_meta:
            return sparse_matmul_op(x, w, idx, nvalid, tile)
        return sparse_matmul_plain(x, w, idx, nvalid, tile=tile)
    T, F = x.shape
    D, K = w.shape[1], idx.shape[0]
    xc, wc = _check_gather(x, w, idx, nvalid, tile, (K,), ())
    y = torch.empty((T, D), dtype=torch.float32, device=x.device)
    if wc == rt.DTYPE_CODES[torch.float32]:
        run, scratch = rt.gather_runs(T, K, D, x.device)
        fn = rt.entry("sparse_matmul", "sparse_matmul", _ARGS)
        rc = fn(rt.ptr(x), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid),
                rt.ptr(scratch), rt.ptr(y), T, F, D, K, run, tile,
                rt.stream_ptr(x.device))
    else:
        rt.require(tile % 16 == 0 and D % 8 == 0 and K <= TG_LIST_MAX,
                   lambda: f"the tensor-core gather takes tile % 16 == 0, D % 8 "
                           f"== 0 and at most {TG_LIST_MAX} list slots; got "
                           f"tile {tile}, w {tuple(w.shape)}, K {K}")
        rt.require_aligned(x=x, w=w)
        fn = rt.entry("sparse_matmul", "sparse_matmul_tc",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        rc = fn(rt.ptr(x), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(y),
                T, F, D, K, tile, shared_list_columns(T), xc,
                rt.stream_ptr(x.device))
    rt.check(rc, "sparse_matmul")
    sparse_matmul.launches += 1
    return y


sparse_matmul.launches = 0


def sparse_up_matmul_plain(x, w, idx, nvalid, *, tile: int = 128
                           ) -> torch.Tensor:
    """The plain PyTorch version of ``sparse_up_matmul``: the dense f32
    product with each column weighted by the number of valid slots naming
    its tile (zero for non-listed tiles; the kernel's blocks are
    scatter-added, so a tile listed twice reads twice its product)."""
    counts = preds.tiles_to_units(
        preds.tile_counts(idx, nvalid, w.shape[1] // tile), tile)
    return (x.float() @ w.float()) * counts


def sparse_up_matmul(x, w, idx, nvalid, *, tile: int = 128) -> torch.Tensor:
    """Output-tile gather for the up-projection: x (T, d), w (d, F), idx
    (T, K) int32 output tile ids, nvalid (T,) int32. Returns (T, F) f32:
    row t's listed tiles of x @ w, exact zeros elsewhere. CUDA tensors launch
    the kernel, which writes a compact (T, K, tile) buffer (zeros past
    nvalid), and ``scatter_compact`` places it (``sparse_up_matmul.launches``
    counts the launches); CPU tensors take the plain version. bf16 at tile
    128 runs the tensor-core routine of csrc/up_tiles.cuh (a block per
    weight tile and chunk of up to 64 rows listing it); f32, or another
    tile, the CUDA-core ``ffn_up``."""
    if rt.on_cpu(x, w, idx, nvalid):
        return sparse_up_matmul_plain(x, w, idx, nvalid, tile=tile)
    T, d = x.shape
    F, K = w.shape[1], idx.shape[1]
    rt.require(w.shape[0] == d and F % tile == 0,
               lambda: f"x {tuple(x.shape)} / w {tuple(w.shape)} / tile {tile}")
    rt.require(idx.shape == (T, K) and nvalid.shape == (T,), "idx/nvalid shape")
    rt.require(idx.dtype == torch.int32 and nvalid.dtype == torch.int32,
               "idx and nvalid must be int32")
    code = rt.dtype_code(x, w)
    rt.require_contiguous(x=x, w=w, idx=idx, nvalid=nvalid)
    compact = torch.empty((T, K, tile), dtype=torch.float32, device=x.device)
    bits = None
    if x.dtype == torch.bfloat16 and tile == rt.UT_BN:
        rt.require(d % 8 == 0,
                   lambda: f"x {tuple(x.shape)}: bf16 needs d % 8 == 0")
        rt.require_aligned(x=x, w=w)
        bits = torch.empty((-(-(F // tile) // 32), T), dtype=torch.int32,
                           device=x.device)
    fn = rt.entry("sparse_up_matmul", "sparse_up_matmul",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    rc = fn(rt.ptr(x), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(bits),
            rt.ptr(compact), T, d, F, K, tile, code, rt.stream_ptr(x.device))
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
    launch the kernel (``expert_up_matmul.launches`` counts them): bf16 at
    tile 128 the tensor-core routine of csrc/up_tiles.cuh over the stacked
    weight (a block per global tile id and chunk of up to 64 tokens routed
    to its expert); f32, or another tile, the CUDA-core ``ffn_up``."""
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
    bits = None
    if x.dtype == torch.bfloat16 and tile == rt.UT_BN:
        rt.require(d % 8 == 0,
                   lambda: f"x {tuple(x.shape)}: bf16 needs d % 8 == 0")
        rt.require_aligned(x=x, w=w)
        bits = torch.empty((-(-(E * F // tile) // 32), T), dtype=torch.int32,
                           device=x.device)
    fn = rt.entry("expert_up_matmul", "expert_up_matmul", _UP_ARGS)
    rc = fn(rt.ptr(x), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(bits),
            rt.ptr(compact), T, d, E, F, K, tile, code,
            rt.stream_ptr(x.device))
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
    tile, :] over its nvalid[t] live blocks. Types (compact, w): (f32, f32),
    (bf16, bf16), or (f32, bf16) with compact unrounded. CPU tensors take
    the plain version; CUDA tensors launch the kernel
    (``expert_down_matmul.launches`` counts them): for bf16 weights the
    tile-grouped tensor-core routine with one run per expert (a token's
    experts summed in ascending expert id), for f32 the CUDA-core row
    gather (list order)."""
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
    rt.require_contiguous(compact=compact, w=w, idx=idx, nvalid=nvalid)
    y = torch.empty((T, d), dtype=torch.float32, device=compact.device)
    if w.dtype == torch.float32:
        run, scratch = rt.gather_runs(T, K, d, compact.device)
        fn = rt.entry("expert_down_matmul", "expert_down_matmul",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        rc = fn(rt.ptr(compact), rt.ptr(w), rt.ptr(idx), rt.ptr(nvalid),
                rt.ptr(scratch), rt.ptr(y), T, K, tile, d, run,
                rt.stream_ptr(compact.device))
    else:
        tpe = F // tile
        R = min(tpe, TG_RMAX)
        cc = rt.DTYPE_CODES[compact.dtype]
        fn = rt.entry("expert_down_matmul", "expert_down_matmul_tc",
                      _TC_ARGS + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        rc = _tile_groups(fn, compact, w, idx, nvalid, y, n_tiles=E * tpe,
                          run=R, tile=tile,
                          ints=lambda T_, S: (T_, K, tile, d, S, R, cc, E * F))
    rt.check(rc, "expert_down_matmul")
    expert_down_matmul.launches += 1
    return y


expert_down_matmul.launches = 0
