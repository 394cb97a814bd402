"""Paged window attention: the block-table gather inside the kernel.

Kernel: ``csrc/paged_attention.cu`` (CUDA C++, sm_90a), the port of the
TPU kernel ``src/repro/kernels/paged_attention.py:paged_window_attention``.
Its source note says what bounds it on the H100 (cache bytes) and how the
design reads each owned K/V block once for all W x g query rows.

The plain version is the reference's frozen path: ``paged_gather`` the
slot's blocks into a contiguous cache, then ``window_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.models import common as cm

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                     ctypes.c_void_p]
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


def paged_window_attention_plain(q, k_pages, v_pages, table, pos, *,
                                 window: int = 0) -> torch.Tensor:
    """Materialise the gathered cache, then the reference's windowed
    attention (same rounding placement)."""
    kg = cm.paged_gather(k_pages, table)
    vg = cm.paged_gather(v_pages, table)
    return cm.window_attention(q, kg, vg, pos, window=window)


def paged_window_attention(q, k_pages, v_pages, table, pos, *,
                           window: int = 0) -> torch.Tensor:
    """Windowed grouped attention straight off one layer's paged pool.

    q (b, W, kvp, g, hd); k/v_pages (n_blocks, kvp, bs, hd); table (b, nb)
    int32 (pads -> scratch block); pos (b, W) int32 absolute position of
    each window token (causal within the window). Returns (b, W, kvp, g, hd)
    in q's dtype. CPU tensors take the plain version; CUDA tensors launch
    the kernel (``paged_window_attention.launches`` counts them)."""
    if rt.on_cpu(q, k_pages, v_pages, table, pos):
        return paged_window_attention_plain(q, k_pages, v_pages, table, pos,
                                            window=window)
    b, W, kvp, g, hd = q.shape
    n_blocks, kvp2, bs, hd2 = k_pages.shape
    nb = table.shape[1]
    rt.require(kvp2 == kvp and hd2 == hd and v_pages.shape == k_pages.shape,
               f"q {tuple(q.shape)} does not match pages "
               f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    rt.require(table.shape == (b, nb) and pos.shape == (b, W),
               "table/pos shape")
    rt.require(table.dtype == torch.int32 and pos.dtype == torch.int32,
               "table and pos must be int32")
    code = rt.dtype_code(q, k_pages, v_pages)
    R = W * g
    smem = (2 * R * hd + 2 * bs * hd + R * bs + 3 * R) * 4
    rt.require(smem <= _SMEM_LIMIT,
               f"window of {W} x {g} rows needs {smem} B of shared memory")
    rt.require_contiguous(q=q, k_pages=k_pages, v_pages=v_pages, table=table,
                          pos=pos)
    out = torch.empty_like(q)
    fn = rt.entry("paged_attention", "paged_window_attention", _ARGS)
    rc = fn(rt.ptr(q), rt.ptr(k_pages), rt.ptr(v_pages), rt.ptr(table),
            rt.ptr(pos), rt.ptr(out), b, W, kvp, g, hd, bs, nb, int(window),
            1.0 / math.sqrt(hd), code, rt.stream_ptr(q.device))
    rt.check(rc, "paged_attention")
    paged_window_attention.launches += 1
    return out


paged_window_attention.launches = 0


def paged_decode_attention(q, k_pages, v_pages, table, pos, *,
                           window: int = 0) -> torch.Tensor:
    """W = 1 decode specialisation. q (b, kvp, g, hd); pos (b,)."""
    return paged_window_attention(q[:, None], k_pages, v_pages, table,
                                  pos[:, None], window=window)[:, 0]


def modeled_cache_bytes(nb: int, bs: int, kvp: int, hd: int,
                        itemsize: int) -> float:
    """HBM bytes ONE slot's attention reads per layer through this kernel:
    each owned K and V block read once."""
    return 2.0 * nb * bs * kvp * hd * itemsize
