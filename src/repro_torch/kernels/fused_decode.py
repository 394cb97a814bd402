"""Fused gather-up -> activation -> scatter-down decode FFN.

Kernel: ``csrc/fused_sparse_ffn.cu`` (CUDA C++, sm_90a), the port of the
TPU kernel ``src/repro/kernels/fused_decode.py:fused_sparse_ffn``. The
source note there says what bounds it on the H100 (weight bytes) and how
its launches replace the TPU's carried output block: bf16 at tile 128 runs
the tensor-core up-projection routine (``csrc/up_tiles.cuh``) with the
activation, GLU and mask in its epilogue, then the tile-grouped down
gather (``csrc/tile_group.cuh``) over a bf16 copy of h; f32 (the parity
path) runs ``ffn_up`` and the CUDA-core row gather in list order.

For token t and list slot i < nvalid[t]:
``h = act(x_t @ Wg[:, tile_i]) [* (x_t @ Wu[:, tile_i])] [* mask]``,
``y_t += h.to(Wd.dtype) @ Wd[tile_i, :]``. Tile lists are the fixed-K
lists of ``predictor.predictors.pack_tile_indices`` (valid first,
ascending, pads repeating the first entry).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import activations as acts
from repro_torch.kernels import runtime as rt
from repro_torch.predictor import predictors as preds

_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
_TC_ARGS = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])

# the H100's SMs, which the down half's blocks should fill
SMS = 132


def down_runs(T: int, D: int, n_tiles: int) -> Tuple[int, int]:
    """(n_runs, R): the down half (csrc/tile_group.cuh, compact mode) cuts
    the tile ids into n_runs runs of R, a block per (run, chunk of 64 rows,
    128 output columns), as many runs as keep the blocks within one wave of
    the card's SMs (4 runs of 32 tiles at OPT-6.7B decode, T = 8: 128
    blocks, where one run gives 32), and at least enough that no run holds
    more than TG_RMAX ids."""
    blocks = -(-D // 128) * -(-T // rt.TG_M)
    n = max(1, min(n_tiles, rt.TG_MAX_RUNS, SMS // blocks),
            -(-n_tiles // rt.TG_RMAX))
    R = -(-n_tiles // n)
    return -(-n_tiles // R), R


def fused_sparse_ffn_plain(x, w_gate, wd, idx, nvalid, *, w_up=None,
                           unit_mask=None, activation: str = "relu",
                           shift: float = 0.0, tile: int = 128
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: dense f32 products over all units, then
    each unit's h weighted by the number of valid slots naming its tile —
    the same function, since a skipped tile contributes nothing, adding
    exact zeros changes no sum, and the kernel adds a tile's product once
    per valid slot (a tile listed twice counts twice)."""
    T, d = x.shape
    F = w_gate.shape[1]
    K = idx.shape[1]
    n_tiles = F // tile
    act = acts.get(activation, shift=shift)
    xf = x.float()
    h = act(xf @ w_gate.float())
    if w_up is not None:
        h = h * (xf @ w_up.float())
    if unit_mask is not None:
        h = h * unit_mask.float()
    counts = preds.tiles_to_units(preds.tile_counts(idx, nvalid, n_tiles), tile)
    y = (h.to(wd.dtype).float() * counts) @ wd.float()
    valid = torch.arange(K, device=x.device)[None, :] < nvalid[:, None]
    compact = torch.gather(h.view(T, n_tiles, tile), 1,
                           idx.long()[:, :, None].expand(T, K, tile))
    compact = torch.where(valid[:, :, None], compact, 0.0)
    return y, compact


def fused_sparse_ffn(x, w_gate, wd, idx, nvalid, *, w_up=None, unit_mask=None,
                     activation: str = "relu", shift: float = 0.0,
                     tile: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass sparse FFN over per-token tile lists.

    x (T, d); w_gate (d, F) the activation-gated projection (``wu`` for an
    MLP, ``wg`` for GLU with the GLU's ``wu`` as ``w_up``); wd (F, d_out);
    idx (T, K) int32; nvalid (T,) int32; unit_mask optional (T, F) bool or
    f32 multiplied into h. Returns (y (T, d_out) f32, h_compact (T, K, tile)
    f32, zeros past nvalid). CPU tensors take the plain version; CUDA
    tensors launch the kernel (``fused_sparse_ffn.launches`` counts them):
    bf16 at tile 128 the tensor-core routines, f32 or another tile the
    CUDA-core pair.
    """
    if rt.on_cpu(x, w_gate, wd, idx, nvalid, w_up, unit_mask):
        return fused_sparse_ffn_plain(x, w_gate, wd, idx, nvalid, w_up=w_up,
                                      unit_mask=unit_mask,
                                      activation=activation, shift=shift,
                                      tile=tile)
    T, d = x.shape
    F = w_gate.shape[1]
    K = idx.shape[1]
    d_out = wd.shape[1]
    rt.require(w_gate.shape == (d, F) and wd.shape[0] == F,
               f"shape mismatch: x {tuple(x.shape)}, w_gate "
               f"{tuple(w_gate.shape)}, wd {tuple(wd.shape)}")
    rt.require(F % tile == 0, f"d_ff={F} not a multiple of tile={tile}")
    rt.require(d_out % 2 == 0, f"d_out={d_out} must be even")
    rt.require(w_up is None or w_up.shape == w_gate.shape, "w_up shape")
    rt.require(idx.shape == (T, K) and nvalid.shape == (T,), "idx/nvalid shape")
    rt.require(idx.dtype == torch.int32 and nvalid.dtype == torch.int32,
               "idx and nvalid must be int32")
    rt.require(d <= 32768, f"d_model={d} exceeds the kernel's shared memory")
    code = rt.dtype_code(*(t for t in (x, w_gate, w_up, wd) if t is not None))
    mask = None
    if unit_mask is not None:
        rt.require(unit_mask.shape == (T, F), "unit_mask shape")
        mask = unit_mask.to(torch.float32).contiguous()
    rt.require_contiguous(x=x, w_gate=w_gate, w_up=w_up, wd=wd, idx=idx,
                          nvalid=nvalid)
    act, prm = acts.kernel_code(activation, shift)
    y = torch.empty((T, d_out), dtype=torch.float32, device=x.device)
    h = torch.empty((T, K, tile), dtype=torch.float32, device=x.device)
    if code == rt.DTYPE_CODES[torch.bfloat16] and tile == rt.UT_BN:
        rc = _fused_tc(x, w_gate, w_up, wd, mask, idx, nvalid, h, y, act, prm)
    else:
        run, scratch = rt.gather_runs(T, K, d_out, x.device)
        fn = rt.entry("fused_sparse_ffn", "fused_sparse_ffn", _ARGS)
        rc = fn(rt.ptr(x), rt.ptr(w_gate), rt.ptr(w_up), rt.ptr(wd),
                rt.ptr(mask), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(h),
                rt.ptr(scratch), rt.ptr(y), T, d, F, d_out, K, run, tile, code,
                act, prm, rt.stream_ptr(x.device))
    rt.check(rc, "fused_sparse_ffn")
    fused_sparse_ffn.launches += 1
    return y, h


fused_sparse_ffn.launches = 0


def _fused_tc(x, w_gate, w_up, wd, mask, idx, nvalid, h, y, act: int,
              prm: float) -> int:
    """The bf16 route at tile 128 (``fused_sparse_ffn_tc``): its scratch
    (the up half's bitmap, the bf16 copy of h, and with several runs the
    runs mask and pair partials) allocated here; rows go in slabs whose
    partials stay under TG_SCRATCH_BYTES. Returns the first non-zero CUDA
    error code, else 0."""
    T, d = x.shape
    F, K, d_out = w_gate.shape[1], idx.shape[1], wd.shape[1]
    rt.require(d % 8 == 0 and d_out % 8 == 0,
               lambda: f"bf16 needs d % 8 == 0 and d_out % 8 == 0; got "
                       f"{d}, {d_out}")
    rt.require_aligned(x=x, w_gate=w_gate, w_up=w_up, wd=wd, mask=mask)
    n_tiles = F // rt.UT_BN
    n_runs, R = down_runs(T, d_out, n_tiles)
    rt.require(n_runs <= rt.TG_MAX_RUNS,
               lambda: f"d_ff={F}: more than {rt.TG_MAX_RUNS} runs of "
                       f"{rt.TG_RMAX} tiles")
    hb = torch.empty((T, K, rt.UT_BN), dtype=torch.bfloat16, device=x.device)
    fn = rt.entry("fused_sparse_ffn", "fused_sparse_ffn_tc", _TC_ARGS)
    stream = rt.stream_ptr(x.device)
    slab = rt.tile_group_slab_rows(d_out, n_runs) or max(T, 1)
    for r0 in range(0, T, slab):
        r1 = min(T, r0 + slab)
        bits = torch.empty((-(-n_tiles // 32), r1 - r0), dtype=torch.int32,
                           device=x.device)
        runs = P = None
        if n_runs > 1:
            runs = torch.empty(r1 - r0, dtype=torch.int64, device=x.device)
            P = torch.empty((n_runs * (r1 - r0), d_out), dtype=torch.float32,
                            device=x.device)
        rc = fn(rt.ptr(x[r0:r1]), rt.ptr(w_gate), rt.ptr(w_up), rt.ptr(wd),
                rt.ptr(None if mask is None else mask[r0:r1]),
                rt.ptr(idx[r0:r1]), rt.ptr(nvalid[r0:r1]), rt.ptr(bits),
                rt.ptr(hb[r0:r1]), rt.ptr(runs), rt.ptr(P), rt.ptr(h[r0:r1]),
                rt.ptr(y[r0:r1]), r1 - r0, d, F, d_out, K, n_runs, R, act, prm,
                stream)
        if rc:
            return rc
    return 0


def scatter_compact(compact, idx, nvalid, n_tiles: int) -> torch.Tensor:
    """Place a (T, K, tile) compact activation buffer at its tile positions:
    (T, n_tiles * tile) f32, exact zeros on non-gathered tiles. Padding is
    zeroed first, so duplicate pad indices contribute nothing."""
    T, K, tile = compact.shape
    valid = torch.arange(K, device=compact.device)[None, :] < nvalid[:, None]
    compact = compact * valid[:, :, None].to(compact.dtype)
    y = torch.zeros((T, n_tiles, tile), dtype=compact.dtype,
                    device=compact.device)
    y.index_put_((torch.arange(T, device=compact.device)[:, None], idx.long()),
                 compact, accumulate=True)
    return y.reshape(T, n_tiles * tile)


def modeled_weight_bytes(k_tiles: float, tile: int, d_model: int,
                         itemsize: int, n_proj: int) -> float:
    """HBM weight bytes ONE token needs through this kernel in one layer:
    ``k_tiles`` gathered tiles x ``n_proj`` projections (gate + [up] +
    down) x the (tile x d_model) tile footprint."""
    return float(k_tiles) * n_proj * tile * d_model * itemsize
