"""Paged window attention: the block-table gather inside the kernel.

Kernel: ``csrc/paged_attention.cu`` (CUDA C++, sm_90a), the port of the
TPU kernel ``src/repro/kernels/paged_attention.py:paged_window_attention``.
Its source note says what bounds it on the H100 (cache bytes) and how the
design reads each needed K/V page once for all W x g query rows. In bf16
(the served type) a block runs one of S runs of a slot's pages on tensor
cores, its pages brought by the TMA engine into a ring, and a second launch
folds the S partial softmaxes in order (flash-decoding); S comes from
shapes alone (``attention_splits``). In f32 (the engine's parity path) one
block per (slot, kv head) walks the pages on CUDA cores.

The plain version is the reference's frozen path: ``paged_gather`` the
slot's blocks into a contiguous cache, then ``window_attention``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import runtime as rt
from repro_torch.models import common as cm

_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper

# csrc/paged_attention.cu, bf16: keys a ring stage holds, the head dims
# and page sizes it is built for, and the bound on the split partials
ATTN_KEYS_PER_STAGE = 64
ATTN_HEAD_DIMS = (16, 32, 64, 80, 128)
ATTN_PAGE_SIZES = (8, 16, 32, 64)
ATTN_SCRATCH_BYTES = 32 << 20


def attention_splits(b: int, kvp: int, nb: int, R: int, hd: int, bs: int,
                     n_sm: int) -> int:
    """The number of page runs S the bf16 kernel cuts each slot into, from
    shapes alone (never from pos or table, so a call needs no host sync):
    enough (slot, kv head, row group, run) blocks to fill the card once
    (two blocks a streaming multiprocessor for R <= 32 rows; above, one
    block a row group of six m16 tiles), no more runs than a slot's table
    has stages of pages, and the partials (b * kvp * S * R * (hd + 2) f32)
    under ATTN_SCRATCH_BYTES; 1 needs no partials and no second launch."""
    n_tiles = -(-R // 16)
    blocks, row_groups = (2, 1) if n_tiles <= 2 else (1, -(-n_tiles // 6))
    S = max(1, blocks * n_sm // (b * kvp * row_groups))
    S = min(S, -(-nb // (ATTN_KEYS_PER_STAGE // bs)))
    return max(1, min(S, ATTN_SCRATCH_BYTES // (b * kvp * R * (hd + 2) * 4)))


def needed_pages(pos_row, window: int, bs: int, nb: int) -> tuple:
    """(lo, hi): the table pages a slot's window reads, as the kernel finds
    them from its positions: none wholly past the last position, none
    wholly before a sliding window; hi < lo when there is none."""
    pmax, pmin = max(pos_row), min(pos_row)
    lo = max(0, pmin - window + 1) // bs if window else 0
    hi = min(nb - 1, pmax // bs) if pmax >= 0 else -1
    return lo, hi


def split_pages(lo: int, hi: int, S: int, s: int, pps: int) -> tuple:
    """(j0, j1): the pages of run s of S over pages lo..hi, as the kernel
    cuts them: runs of ceil(n / S) pages rounded up to whole stages of
    ``pps`` pages (the kernel's ATTN_KEYS_PER_STAGE // bs), in order; j1 <
    j0 for a run with no page."""
    if hi < lo:
        return 0, -1
    per = -(-(hi - lo + 1) // S)  # ceil(n / S) pages,
    per = -(-per // pps) * pps     # rounded up to whole stages
    j0 = lo + s * per
    return j0, min(hi, j0 + per - 1)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
               lambda: f"q {tuple(q.shape)} does not match pages "
                       f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    rt.require(table.shape == (b, nb) and pos.shape == (b, W),
               "table/pos shape")
    rt.require(table.dtype == torch.int32 and pos.dtype == torch.int32,
               "table and pos must be int32")
    code = rt.dtype_code(q, k_pages, v_pages)
    rt.require_contiguous(q=q, k_pages=k_pages, v_pages=v_pages, table=table,
                          pos=pos)
    R = W * g
    S, scratch = 1, None
    if code == rt.DTYPE_CODES[torch.float32]:
        smem = (2 * R * hd + 2 * bs * hd + R * bs + 3 * R) * 4
        rt.require(smem <= _SMEM_LIMIT,
                   lambda: f"f32 window of {W} x {g} rows (q {tuple(q.shape)}, "
                           f"pages {tuple(k_pages.shape)}) needs {smem} B of "
                           f"shared memory, over {_SMEM_LIMIT}")
    else:
        rt.require(hd in ATTN_HEAD_DIMS and bs in ATTN_PAGE_SIZES,
                   lambda: f"the bf16 kernel takes head dims {ATTN_HEAD_DIMS} "
                           f"and pages of {ATTN_PAGE_SIZES} tokens; got q "
                           f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}")
        rt.require_aligned(k_pages=k_pages, v_pages=v_pages)
        S = attention_splits(b, kvp, nb, R, hd, bs, _sm_count(q.device))
        if S > 1:
            scratch = torch.empty(b * kvp * S * R * (hd + 2),
                                  dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = rt.entry("paged_attention", "paged_window_attention", _ARGS)
    rc = fn(rt.ptr(q), rt.ptr(k_pages), rt.ptr(v_pages), rt.ptr(table),
            rt.ptr(pos), rt.ptr(out), rt.ptr(scratch), b, W, kvp, g, hd, bs,
            nb, n_blocks, int(window), S, 1.0 / math.sqrt(hd), code,
            rt.stream_ptr(q.device))
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
