"""The split designs of two port kernels in plain torch / numpy, against the
JAX reference's Pallas kernels (interpret mode on the CPU).

- ``paged_window_attention`` (csrc/paged_attention.cu, bf16): each slot's
  needed pages (``needed_pages``) are cut into S runs (``split_pages``);
  a run's online softmax over its stages of pages gives a partial (m, l,
  acc), a run with no page the neutral (-1e30, 0, 0); the partials fold in
  ascending run order: m = max m_s, l and acc each rescaled by
  exp(m_s - m) and summed, divided once. ``_split_attention`` is that
  model in torch f32. ``attention_splits`` picks S from shapes alone.
- ``sparse_matmul`` (the shared-list mode of csrc/tile_group.cuh, bf16
  weights): chunks of 64 consecutive rows walk the list's valid slots in
  list order, 64 rows of the weight tile a step, each step's product in a
  fresh f32 accumulator added to the total. ``_shared_walk`` is that
  model in numpy, on f32 x against bf16 weights unrounded.

Tolerance 1e-5 of max |ref| (f32 sums in another order)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels import sparse_matmul as jsm
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import sparse_matmul as tsm

torch.set_num_threads(1)


def _rel_close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


# ---------------------------------------------------------------------------
# paged_window_attention: runs of pages, partials, the ordered merge

_BS, _NB, _HD, _KVP = 8, 12, 16, 2
# tokens written per slot: shorter than one page (and than a W = 16 window,
# so its first rows have no valid key); ending inside a page; the whole
# table; nothing (pos = -1 .. : no row has a valid key)
_ENDS = (3, 45, _NB * _BS, 0)


@functools.lru_cache(maxsize=None)
def _attn_inputs(W, g):
    rng = np.random.RandomState(10 * W + g)
    b = len(_ENDS)
    n_blocks = b * _NB + 1
    q = rng.randn(b, W, _KVP, g, _HD).astype(np.float32)
    kp = rng.randn(n_blocks, _KVP, _BS, _HD).astype(np.float32)
    vp = rng.randn(n_blocks, _KVP, _BS, _HD).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks)).reshape(b, _NB)
    end = np.asarray(_ENDS)
    # pages past a slot's length point at the scratch block 0
    table = np.where(np.arange(_NB)[None, :] * _BS < end[:, None], perm,
                     0).astype(np.int32)
    pos = (end[:, None] - W + np.arange(W)[None, :]).astype(np.int32)
    return q, kp, vp, table, pos


@functools.lru_cache(maxsize=None)
def _pallas_attention(W, g, window):
    q, kp, vp, table, pos = _attn_inputs(W, g)
    return np.asarray(jpa.paged_window_attention(
        *map(jnp.asarray, (q, kp, vp, table, pos)), window=window))


def _split_attention(q, kp, vp, table, pos, window, S, pps):
    """The bf16 kernel's split and merge in torch f32 (stages of ``pps``
    pages; the kernel's are ATTN_KEYS_PER_STAGE // bs)."""
    b, W, kvp, g, hd = q.shape
    bs, nb = kp.shape[2], table.shape[1]
    R = W * g
    out = torch.zeros_like(q)
    neutral = 0
    for t in range(b):
        lo, hi = tpa.needed_pages(pos[t].tolist(), window, bs, nb)
        rpos = pos[t].long().repeat_interleave(g)[:, None]  # row r = w * g + gi
        for h in range(kvp):
            qs = q[t, :, h].reshape(R, hd) * (1.0 / np.sqrt(hd))
            parts = []
            for s in range(S):
                j0, j1 = tpa.split_pages(lo, hi, S, s, pps)
                m = torch.full((R,), -1e30)
                l, acc = torch.zeros(R), torch.zeros(R, hd)
                for p0 in range(j0, j1 + 1, pps):
                    pages = range(p0, min(p0 + pps, j1 + 1))
                    k = torch.cat([kp[table[t, j], h] for j in pages])
                    v = torch.cat([vp[table[t, j], h] for j in pages])
                    kpos = torch.arange(p0 * bs, (pages[-1] + 1) * bs)[None, :]
                    valid = kpos <= rpos
                    if window:
                        valid &= kpos > rpos - window
                    logits = torch.where(valid, qs @ k.T, -1e30)
                    m_new = torch.maximum(m, logits.max(1).values)
                    p = torch.where(valid, torch.exp(logits - m_new[:, None]), 0.0)
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ v
                    m = m_new
                neutral += j1 < j0
                parts.append((m, l, acc))
            m = torch.stack([pm for pm, _, _ in parts]).max(0).values
            l = sum(pl * torch.exp(pm - m) for pm, pl, _ in parts)
            acc = sum(pa * torch.exp(pm - m)[:, None] for pm, _, pa in parts)
            o = acc / torch.clamp(l, min=1e-30)[:, None]
            out[t, :, h] = o.reshape(W, g, hd)
    return out, neutral


@pytest.mark.parametrize("runs", ["kernel stages, S=3", "one-page stages, S=4"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("g", [1, 6])
@pytest.mark.parametrize("W", [1, 5, 16])
def test_split_and_merge_match_pallas(W, g, window, runs):
    """Runs of pages, partials and their ordered merge reproduce the Pallas
    kernel: a slot shorter than one run, table pads on the scratch block,
    runs wholly masked for some rows (causal within the window, or before
    the sliding window) and runs with no page, and rows with no valid key,
    which give exact zeros and no NaN."""
    q, kp, vp, table, pos = map(torch.as_tensor, _attn_inputs(W, g))
    S, pps = ((3, tpa.ATTN_KEYS_PER_STAGE // _BS) if runs.startswith("kernel")
              else (4, 1))
    got, neutral = _split_attention(q, kp, vp, table, pos, window, S, pps)
    want = _pallas_attention(W, g, window)
    assert torch.isfinite(got).all()
    _rel_close(got, want)
    assert neutral > 0  # some run read no page and wrote the neutral partial
    assert (got[3] == 0).all()  # slot 3: no row has a valid key


@pytest.mark.parametrize("lo,hi,S,pps", [(0, 319, 4, 4), (44, 300, 4, 4),
                                         (0, 0, 5, 8), (3, 17, 4, 1),
                                         (5, 4, 3, 4), (0, 127, 1, 4),
                                         (10, 50, 7, 2)])
def test_split_pages_cover_each_page_once(lo, hi, S, pps):
    """The S runs of pages lo..hi are contiguous, in order, of whole stages
    (but the last) and cover every needed page exactly once."""
    seen = []
    for s in range(S):
        j0, j1 = tpa.split_pages(lo, hi, S, s, pps)
        if j1 >= j0:
            assert not seen or j0 == seen[-1] + 1
            if j1 < hi:
                assert (j1 - j0 + 1) % pps == 0
            seen.extend(range(j0, j1 + 1))
    assert seen == list(range(lo, hi + 1))


@pytest.mark.parametrize("b,kvp,nb,R,hd,bs", [
    (8, 32, 16, 1, 128, 16),     # OPT-6.7B decode
    (8, 32, 128, 1, 128, 16),    # OPT-6.7B decode at a 2048-token context
    (8, 32, 16, 16, 128, 16),    # OPT-6.7B 16-token chunk
    (8, 8, 320, 6, 128, 16),     # Mixtral-8x22B decode over its 4096 window
    (8, 8, 320, 96, 128, 16),    # Mixtral-8x22B 16-token chunk
    (1, 8, 320, 96, 128, 16),
    (1, 1, 320, 96, 128, 8),
    (1, 1, 320, 768, 128, 16),   # 128-token chunk, R over 128 rows
    (3, 2, 4, 40, 16, 8),
    (64, 8, 320, 6, 128, 16),
])
def test_attention_splits_cover_pages_with_bounded_scratch(b, kvp, nb, R, hd,
                                                           bs):
    """S from shapes alone: at least 1, no more runs than the table has
    stages, partials under ATTN_SCRATCH_BYTES; its runs cover every page
    of any needed range exactly once."""
    S = tpa.attention_splits(b, kvp, nb, R, hd, bs, n_sm=132)
    pps = tpa.ATTN_KEYS_PER_STAGE // bs
    assert 1 <= S <= max(1, -(-nb // pps))
    assert S == 1 or b * kvp * S * R * (hd + 2) * 4 <= tpa.ATTN_SCRATCH_BYTES
    for lo, hi in ((0, nb - 1), (nb // 3, nb - 2), (nb - 1, nb - 1), (2, 1)):
        pages = []
        for s in range(S):
            j0, j1 = tpa.split_pages(lo, hi, S, s, pps)
            pages.extend(range(j0, j1 + 1))
        assert pages == list(range(lo, hi + 1))


# ---------------------------------------------------------------------------
# sparse_matmul: the shared-list walk

_TILE, _NT, _D = 128, 6, 64
_SHARED = {  # (idx (K,), nvalid)
    "score order": ([4, 0, 5, 2, 1, 3], 6),
    "repeated valid tiles": ([3, 1, 3, 0, 3], 4),
    "pads repeat the first tile": ([2, 2, 2, 2], 1),
    "nvalid = 0": ([1, 0, 4], 0),
}


def _shared_walk(x, w, idx, nvalid, tile, ks=64, chunk=64):
    """Chunks of ``chunk`` consecutive rows; per chunk the list's valid
    slots in list order, ``ks`` rows of the tile a step, each step's
    product a fresh f32 partial added to the chunk's total."""
    T = x.shape[0]
    y = np.zeros((T, w.shape[1]), np.float32)
    for c0 in range(0, T, chunk):
        acc = np.zeros((min(chunk, T - c0), w.shape[1]), np.float32)
        for i in range(nvalid):
            for k0 in range(idx[i] * tile, (idx[i] + 1) * tile, ks):
                acc += x[c0:c0 + chunk, k0:k0 + ks] @ w[k0:k0 + ks]
        y[c0:c0 + chunk] = acc
    return y


@pytest.mark.parametrize("case", list(_SHARED))
@pytest.mark.parametrize("T", [1, 8, 100, 128])
def test_shared_list_walk_matches_pallas_sparse_matmul(T, case):
    """The shared-list walk on f32 x against bf16 weights (unrounded)
    reproduces Pallas ``sparse_matmul`` and the port's plain version:
    lists in score order, a tile listed twice counted twice, pads past
    nvalid skipped, nvalid = 0 exact zeros, and a last chunk of fewer than
    64 rows (T = 100)."""
    rng = np.random.RandomState(T)
    x = (rng.randn(T, _NT * _TILE) * 1.37).astype(np.float32)
    w = (rng.randn(_NT * _TILE, _D) / 16).astype(np.float32)
    idx, nv = np.asarray(_SHARED[case][0], np.int32), _SHARED[case][1]
    wb = torch.as_tensor(w).bfloat16()
    got = _shared_walk(x, wb.float().numpy(), idx, nv, _TILE)
    want = jsm.sparse_matmul(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16),
                             jnp.asarray(idx), jnp.asarray(nv, jnp.int32),
                             tile=_TILE, block_d=_D)
    plain = tsm.sparse_matmul_plain(torch.as_tensor(x), wb,
                                    torch.as_tensor(idx),
                                    torch.tensor(nv, dtype=torch.int32))
    if nv == 0:
        assert not got.any() and not np.asarray(want).any()
        assert not plain.any()
        return
    _rel_close(got, want)
    _rel_close(plain.numpy(), want)


@pytest.mark.parametrize("T,columns", [(1, 32), (8, 32), (64, 32), (65, 64),
                                       (128, 64), (4096, 64)])
def test_shared_list_columns_follow_the_rows(T, columns):
    """The shared-list mode takes 32 columns a block while the rows fit one
    chunk of 64 (twice the blocks for a grid of a few rows), else 64."""
    assert tsm.shared_list_columns(T) == columns
