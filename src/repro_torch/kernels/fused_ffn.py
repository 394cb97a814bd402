"""Fused up-projection + (shifted) ReLU + tile-activity scores, and the
tile-activity score functions.

Kernels: ``csrc/fused_up_relu.cu`` (CUDA C++, sm_90a), the ports of the three
TPU kernels of ``src/repro/kernels/fused_ffn.py``. Each computes h =
relu(x @ wu - shift) and per-128-lane tile scores in one pass; they differ
only in which rows share a score:

- ``fused_up_relu``: one score row, the max over all rows;
- ``fused_up_relu_tokens``: a score row per token (continuous batching keeps
  every request's activity its own);
- ``fused_up_relu_window``: a score row per slot, the union over its W
  window tokens (the selection input of a window's sparse down-projection).

What bounds them on the H100 is wu's bytes (0.040 ms for OPT-6.7B's 134
MB in bf16). The first design ran on f32 CUDA cores, whose 0.26 ms for
the 17.2 GFLOP at T = 128 held it at 0.62 ms; bf16 now runs the tensor-core
up-projection routine of ``csrc/up_tiles.cuh`` (a block per 128-column
tile of wu and 64 rows over all of d, TMA boxes, ``wgmma``, the shift,
ReLU and scores in its epilogue); f32 stays on CUDA cores, the parity
path, with d split over blocks at small T (``up_relu_plan``). The source note says how the scores stay exact without ordering the
atomics. Each wrapper has its own C entry point and launch counter.

``tile_activity`` and ``window_tile_activity`` are plain torch (XLA
functions in the reference, not kernels).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import runtime as rt

TILE = 128

# csrc/fused_up_relu.cu up_relu (f32): columns per block, rows of d per
# staged slice, threads across a block's rows, and the grid it aims for
# when it splits d
UR_BN, UR_BK, UR_TY, UR_TARGET_BLOCKS = 64, 32, 16, 1024
UR_MAX_SCRATCH = 64 * 2 ** 20

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_WIN_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def tile_activity(h: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Per-token tile-activity scores: (T, F) -> (T, F // tile) max |h|."""
    T, F = h.shape
    return h.abs().reshape(T, F // tile, tile).amax(-1)


def window_tile_activity(h: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Window-union tile-activity scores: (B, W, F) -> (B, F // tile), the
    max |h| over the window tokens and the tile lanes."""
    B, W, F = h.shape
    return h.abs().reshape(B, W, F // tile, tile).amax(dim=(1, 3))


def up_relu_plan(T: int, d: int, F: int) -> Tuple[int, int, int]:
    """(tm, S, kc) for the f32 CUDA-core kernel: tm rows per thread (a block
    covers 16 * tm rows); the d axis cut into S consecutive ranges of kc rows
    (a multiple of the staged slice), as many as bring the grid to about
    UR_TARGET_BLOCKS blocks, with at least 4 slices per range and the
    (S, T, F) f32 partial-sum scratch under UR_MAX_SCRATCH bytes."""
    tm = 1 if T <= 16 else 4 if T <= 64 else 8
    blocks = (F // UR_BN) * -(-T // (UR_TY * tm))
    S = max(1, min(-(-UR_TARGET_BLOCKS // blocks), d // (4 * UR_BK),
                   UR_MAX_SCRATCH // max(1, T * F * 4)))
    kc = -(-(-(-d // S)) // UR_BK) * UR_BK
    return tm, -(-d // kc), kc


def fused_up_relu_plain(x, wu, shift: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the dense f32 product, shift, ReLU, and
    the max over rows and tile lanes."""
    h = torch.relu(x.float() @ wu.float() - shift)
    T, F = h.shape
    return h, h.abs().reshape(T, F // TILE, TILE).amax(dim=(0, 2))


def _launch(entry: str, x, wu, shift: float, n_groups: int, *window
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one of the kernel's C entry points on x (T, d), wu (d, F):
    returns (h (T, F) f32, scores (n_groups, F // 128) f32). ``window``
    holds W for ``fused_up_relu_window``."""
    T, d = x.shape
    F = wu.shape[1]
    rt.require(wu.shape[0] == d and F % TILE == 0,
               lambda: f"x {tuple(x.shape)} / wu {tuple(wu.shape)}: F must be "
                       f"a multiple of {TILE}")
    code = rt.dtype_code(x, wu)
    rt.require_contiguous(x=x, wu=wu)
    rt.require_aligned(wu=wu)
    if x.dtype == torch.bfloat16:  # the tensor-core routine
        rt.require(d % 8 == 0,
                   lambda: f"x {tuple(x.shape)}: bf16 needs d % 8 == 0")
        rt.require_aligned(x=x)
        tm, S, kc = 1, 1, d  # the f32 kernel's plan: not read
    else:
        tm, S, kc = up_relu_plan(T, d, F)
    h = torch.empty((T, F), dtype=torch.float32, device=x.device)
    scores = torch.empty((n_groups, F // TILE), dtype=torch.float32,
                         device=x.device)
    scratch = (torch.empty((S, T, F), dtype=torch.float32, device=x.device)
               if S > 1 else None)
    fn = rt.entry("fused_up_relu", entry, _WIN_ARGS if window else _ARGS)
    rc = fn(rt.ptr(x), rt.ptr(wu), rt.ptr(h), rt.ptr(scores), rt.ptr(scratch),
            T, d, F, tm, S, kc, *window, float(shift), code,
            rt.stream_ptr(x.device))
    rt.check(rc, "fused_up_relu")
    return h, scores


def fused_up_relu(x, wu, shift: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d), wu (d, F) -> (h (T, F) f32, scores (F // 128,) f32):
    h = max(x @ wu - shift, 0), scores the max |h| over all T rows and each
    tile's 128 lanes. CPU tensors take the plain version; CUDA tensors
    launch the kernel (``fused_up_relu.launches`` counts them)."""
    if rt.on_cpu(x, wu):
        return fused_up_relu_plain(x, wu, shift)
    h, scores = _launch("fused_up_relu", x, wu, shift, 1)
    fused_up_relu.launches += 1
    return h, scores[0]


fused_up_relu.launches = 0


def fused_up_relu_tokens_plain(x, wu, shift: float = 0.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the dense f32 product, shift, ReLU, and
    each row's max over the tile lanes."""
    h = torch.relu(x.float() @ wu.float() - shift)
    return h, tile_activity(h)


def fused_up_relu_tokens(x, wu, shift: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token scores: x (T, d), wu (d, F) -> (h (T, F) f32, scores
    (T, F // 128) f32), row t's score the max |h[t]| over each tile's 128
    lanes. CPU tensors take the plain version; CUDA tensors launch the
    kernel (``fused_up_relu_tokens.launches`` counts them)."""
    if rt.on_cpu(x, wu):
        return fused_up_relu_tokens_plain(x, wu, shift)
    h, scores = _launch("fused_up_relu_tokens", x, wu, shift, x.shape[0])
    fused_up_relu_tokens.launches += 1
    return h, scores


fused_up_relu_tokens.launches = 0


def fused_up_relu_window_plain(x, wu, shift: float = 0.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the dense f32 product, shift, ReLU, and
    each slot's max over its window rows and the tile lanes."""
    B, W, d = x.shape
    h = torch.relu(x.reshape(B * W, d).float() @ wu.float() - shift)
    h = h.reshape(B, W, -1)
    return h, window_tile_activity(h)


def fused_up_relu_window(x, wu, shift: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-union scores: x (B, W, d), wu (d, F) -> (h (B, W, F) f32,
    scores (B, F // 128) f32), slot b's score the max |h[b]| over its W
    window tokens and each tile's 128 lanes (``window_tile_activity(h)``).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``fused_up_relu_window.launches`` counts them)."""
    if rt.on_cpu(x, wu):
        return fused_up_relu_window_plain(x, wu, shift)
    B, W, d = x.shape
    rt.require(W >= 1, f"x {tuple(x.shape)}: empty window")
    h, scores = _launch("fused_up_relu_window", x.reshape(B * W, d), wu,
                        shift, B, W)
    fused_up_relu_window.launches += 1
    return h.reshape(B, W, -1), scores


fused_up_relu_window.launches = 0
