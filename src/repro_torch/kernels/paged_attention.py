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

Partial mode (``paged_window_attention_partial``), for serving on a data
axis where each data row holds a range of the pool's blocks: every slot's
queries against the pages of the rank's range only (the others skipped),
returning each query row's partial softmax (acc, m, l) in f32 instead of
o; ``fold_partials`` folds the rows' partials, gathered over the data
axis, in ascending data index by the rule the bf16 kernel merges its page
runs with, and divides once. Each has its plain version here and its own
launch counter.
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
_PARTIAL_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_FOLD_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_long,
                                       ctypes.c_long, ctypes.c_long,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p])
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


def _check_shapes(q, k_pages, v_pages, table, pos) -> int:
    """The kernel's shape, dtype and layout contract; returns its dtype
    code."""
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
    return code


def _splits(q, k_pages, table, code):
    """(S, scratch) of a call: the bf16 kernel's page runs and their
    partials' buffer; (1, None) in f32."""
    if code == rt.DTYPE_CODES[torch.float32]:
        return 1, None
    b, W, kvp, g, hd = q.shape
    S = attention_splits(b, kvp, table.shape[1], W * g, hd, k_pages.shape[2],
                         _sm_count(q.device))
    if S == 1:
        return 1, None
    return S, torch.empty(b * kvp * S * W * g * (hd + 2), dtype=torch.float32,
                          device=q.device)


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
    code = _check_shapes(q, k_pages, v_pages, table, pos)
    b, W, kvp, g, hd = q.shape
    n_blocks, _, bs, _ = k_pages.shape
    S, scratch = _splits(q, k_pages, table, code)
    out = torch.empty_like(q)
    fn = rt.entry("paged_attention", "paged_window_attention", _ARGS)
    rc = fn(rt.ptr(q), rt.ptr(k_pages), rt.ptr(v_pages), rt.ptr(table),
            rt.ptr(pos), rt.ptr(out), rt.ptr(scratch), b, W, kvp, g, hd, bs,
            table.shape[1], n_blocks, int(window), S, 1.0 / math.sqrt(hd),
            code, rt.stream_ptr(q.device))
    rt.check(rc, "paged_attention")
    paged_window_attention.launches += 1
    return out


paged_window_attention.launches = 0


def paged_window_attention_partial_plain(q, k_pages, v_pages, table, pos, *,
                                         blocks, window: int = 0
                                         ) -> torch.Tensor:
    """The partial mode's plain version: the rank's pages gathered through
    the table (a page of another rank masked), then the reference's
    windowed attention up to the softmax's sum (same rounding placement: q
    scaled in its dtype and cast to the pages' dtype, p cast to it before
    p @ v, f32 accumulation)."""
    b0, nloc = blocks
    b, W, kvp, g, hd = q.shape
    nb, bs = table.shape[1], k_pages.shape[2]
    t = table.long()
    mine = (t >= b0) & (t < b0 + nloc)
    local = torch.where(mine, t - b0, 0)
    kg = cm.paged_gather(k_pages, local).float()  # (b, kvp, nb * bs, hd)
    vg = cm.paged_gather(v_pages, local).float()
    qs = (q * cm._in_dtype(1.0 / math.sqrt(hd), q.dtype)).to(k_pages.dtype)
    logits = torch.einsum("bqhgd,bhsd->bhgqs", qs.float(), kg)
    ar = torch.arange(nb * bs, device=q.device)
    valid = ar[None, None, :] <= pos[:, :, None]
    if window:
        valid &= ar[None, None, :] > pos[:, :, None] - window
    valid &= mine.repeat_interleave(bs, 1)[:, None, :]  # (b, W, nb * bs)
    valid = valid[:, None, None]
    logits = torch.where(valid, logits, -1e30)
    m = logits.amax(-1)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    acc = torch.einsum("bhgqs,bhsd->bqhgd", p.to(k_pages.dtype).float(), vg)
    ml = torch.stack([m, p.sum(-1)], -1).permute(0, 3, 1, 2, 4)
    return torch.cat([acc, ml], -1)


def paged_window_attention_partial(q, k_pages, v_pages, table, pos, *,
                                   blocks, window: int = 0) -> torch.Tensor:
    """Kernel 2's partial mode. q (b, W, kvp, g, hd); k/v_pages (nloc, kvp,
    bs, hd), the global blocks ``blocks`` = (b0, nloc) as local blocks 0 ..
    nloc - 1; table (b, nb) int32 global block ids (the others' pages are
    skipped); pos (b, W) int32. Returns (b, W, kvp, g, hd + 2) f32: each
    query row's acc (hd), m and l over the rank's pages; m = -1e30, l = 0
    and acc = 0 where none of its keys lies there. CPU tensors take the
    plain version; CUDA tensors launch the kernel
    (``paged_window_attention_partial.launches`` counts them)."""
    rt.require(k_pages.shape[0] == blocks[1],
               lambda: f"{k_pages.shape[0]} local pages for the range "
                       f"{blocks}")
    if rt.on_cpu(q, k_pages, v_pages, table, pos):
        return paged_window_attention_partial_plain(
            q, k_pages, v_pages, table, pos, blocks=blocks, window=window)
    code = _check_shapes(q, k_pages, v_pages, table, pos)
    b, W, kvp, g, hd = q.shape
    bs = k_pages.shape[2]
    S, scratch = _splits(q, k_pages, table, code)
    parts = torch.empty((b, W, kvp, g, hd + 2), dtype=torch.float32,
                        device=q.device)
    fn = rt.entry("paged_attention", "paged_window_attention_partial",
                  _PARTIAL_ARGS)
    rc = fn(rt.ptr(q), rt.ptr(k_pages), rt.ptr(v_pages), rt.ptr(table),
            rt.ptr(pos), rt.ptr(parts), rt.ptr(scratch), b, W, kvp, g, hd, bs,
            table.shape[1], int(blocks[1]), int(blocks[0]), int(window), S,
            1.0 / math.sqrt(hd), code, rt.stream_ptr(q.device))
    rt.check(rc, "paged_attention (partial)")
    paged_window_attention_partial.launches += 1
    return parts


paged_window_attention_partial.launches = 0


def fold_partials_plain(parts, slots, dtype) -> torch.Tensor:
    """The fold's plain version: over the D rows in order, m = max m_d, l
    and acc rescaled by exp(m_d - m) and summed, then divided once."""
    s0, n = slots
    hd = parts.shape[-1] - 2
    p = parts[:, s0:s0 + n]
    m, l, acc = p[..., hd], p[..., hd + 1], p[..., :hd]
    mx = m.amax(0)
    ls, out = torch.zeros_like(mx), torch.zeros_like(acc[0])
    for d in range(parts.shape[0]):
        f = torch.exp(m[d] - mx)
        ls = ls + l[d] * f
        out = out + acc[d] * f[..., None]
    return (out / torch.clamp(ls, min=1e-30)[..., None]).to(dtype)


def fold_partials(parts, slots, dtype) -> torch.Tensor:
    """The partial attentions of D data rows folded into o. parts (D, b, W,
    kvp, g, hd + 2) f32 (``paged_window_attention_partial`` of each row,
    gathered in data-index order); slots (s0, n) the slots to fold. Returns
    (n, W, kvp, g, hd) in ``dtype`` (f32 or bf16). CPU tensors take the
    plain version; CUDA tensors launch the fold kernel
    (``fold_partials.launches``)."""
    if rt.on_cpu(parts):
        return fold_partials_plain(parts, slots, dtype)
    D, b, W, kvp, g, hd2 = parts.shape
    hd = hd2 - 2
    code = rt.DTYPE_CODES.get(dtype)
    rt.require(code is not None and parts.dtype == torch.float32,
               "fold: f32 partials into f32 or bf16")
    rt.require_contiguous(parts=parts)
    s0, n = slots
    rows = W * kvp * g
    out = torch.empty((n, W, kvp, g, hd), dtype=dtype, device=parts.device)
    fn = rt.entry("paged_attention", "paged_attention_fold", _FOLD_ARGS)
    rc = fn(rt.ptr(parts), rt.ptr(out), D, b * rows, s0 * rows, n * rows, hd,
            code, rt.stream_ptr(parts.device))
    rt.check(rc, "paged_attention (fold)")
    fold_partials.launches += 1
    return out


fold_partials.launches = 0


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
