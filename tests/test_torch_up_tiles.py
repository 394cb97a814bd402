"""The tensor-core up-projection routine (csrc/up_tiles.cuh) in plain torch,
and f32 x against bf16 weights in the row gathers, against the JAX
reference's Pallas kernels (interpret mode on the CPU).

- f32 x x bf16 w: the plain versions of ``sparse_matmul_tokens`` and
  ``sparse_matmul`` multiply x unrounded, as the Pallas kernels' promoted
  dot does (rounded to bf16 they differ by about 1e-3 of max |ref|).
- ``up_tile_plan``, a model of the routine's row grouping for
  ``sparse_up_matmul`` (``ut_rows``' bitmap and the blocks' ballot
  ranking): each valid (row, slot) has exactly one writer, a padded slot
  none, and compact blocks filled by the plain product through it
  reproduce the Pallas kernel.

Tolerance 1e-5 of max |ref| (f32 sums in another order)."""
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sparse_matmul as jsm
from repro_torch.kernels import fused_decode as tfd
from repro_torch.kernels import sparse_matmul as tsm

torch.set_num_threads(1)

_LISTS = {  # (idx (3, 5), nvalid (3,)) over 6 tiles
    "repeated valid": ([[1, 1, 4, 0, 1], [5, 2, 5, 5, 5], [3, 0, 3, 3, 3]],
                       [4, 3, 0]),
    "pads repeat the first tile": ([[2, 2, 2, 2, 2], [1, 3, 1, 1, 1],
                                    [4, 5, 0, 4, 4]], [1, 2, 3]),
    "unsorted": ([[5, 0, 2, 1, 3], [2, 4, 1, 0, 5], [0, 5, 4, 3, 2]],
                 [5, 4, 5]),
}


def _rel_close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("case", list(_LISTS))
@pytest.mark.parametrize("kernel", ["sparse_matmul_tokens", "sparse_matmul"])
def test_f32_x_against_bf16_weights_is_not_rounded(kernel, case):
    """The plain versions on f32 x with bf16 w equal the Pallas kernels
    (a promoted f32 dot) within 1e-5 of max |ref|, on repeated, padded and
    unsorted lists; x scaled so that rounding it to bf16 would miss by far
    more."""
    rng = np.random.RandomState(3)
    tile, n_tiles, D = 128, 6, 64
    x = (rng.randn(3, n_tiles * tile) * 1.37).astype(np.float32)
    w = (rng.randn(n_tiles * tile, D) / 16).astype(np.float32)
    idx, nv = (np.asarray(a, np.int32) for a in _LISTS[case])
    if kernel == "sparse_matmul":
        idx, nv = idx[0], nv[0]
    tw = torch.as_tensor(w).bfloat16()
    jw = jnp.asarray(w, jnp.bfloat16)
    got = getattr(tsm, kernel)(torch.as_tensor(x), tw, torch.as_tensor(idx),
                               torch.as_tensor(nv), tile=tile)
    want = getattr(jsm, kernel)(jnp.asarray(x), jw, jnp.asarray(idx),
                                jnp.asarray(nv), tile=tile, interpret=True)
    assert got.dtype == torch.float32
    _rel_close(got.numpy(), want)
    rounded = getattr(tsm, kernel)(torch.as_tensor(x).bfloat16(), tw,
                                   torch.as_tensor(idx), torch.as_tensor(nv),
                                   tile=tile)
    if np.abs(np.asarray(want)).max() > 0:  # the rounded x is far off
        assert (np.abs(rounded.numpy() - np.asarray(want)).max()
                > 1e-4 * np.abs(np.asarray(want)).max())


def _random_lists(rng, T, K, n_tiles):
    """Per-row lists with repeated valid tiles, pads repeating the first
    tile, unsorted entries and nvalid == 0 rows."""
    idx = rng.randint(0, n_tiles, (T, K))
    idx[1::3, 1] = idx[1::3, 0]
    nv = rng.randint(0, K + 1, T)
    nv[0] = 0
    idx = np.where(np.arange(K)[None, :] < nv[:, None], idx, idx[:, :1])
    return idx.astype(np.int32), nv.astype(np.int32)


class UpTilePlan(NamedTuple):
    """bits (ceil(n_tiles / 32), T) uint32: bit j % 32 of word j // 32 set
    when a valid slot of row t names tile j; chunk_rows (n_tiles * ceil(T /
    chunk), chunk) int32: block (c, j) at j * ceil(T / chunk) + c holds the
    rows naming tile j ranked c * chunk .. in ascending order, -1 past
    them."""
    bits: np.ndarray
    chunk_rows: np.ndarray


def up_tile_plan(idx, nvalid, n_tiles: int, chunk: int = 64) -> UpTilePlan:
    """The rows of csrc/up_tiles.cuh for a listed up-projection: ut_rows'
    bitmap, and the rows each block (c, j) ranks from it by ballot. Block
    (c, j) writes compact[t, i] for each of its rows t and each valid slot
    i naming j; ut_rows zeros the slots past nvalid."""
    T = idx.shape[0]
    named = np.zeros((T, -(-n_tiles // 32) * 32), bool)
    for t in range(T):
        named[t, idx[t, :nvalid[t]]] = True
    words = named.reshape(T, -1, 32).astype(np.uint64) << np.arange(
        32, dtype=np.uint64)
    bits = words.sum(2).astype(np.uint32).T.copy()
    cpr = -(-T // chunk)
    chunk_rows = np.full((n_tiles, cpr * chunk), -1, np.int32)
    for j in range(n_tiles):
        rows = np.flatnonzero(named[:, j])
        chunk_rows[j, :len(rows)] = rows
    return UpTilePlan(bits, chunk_rows.reshape(n_tiles * cpr, chunk))


def _writers(plan, idx, nvalid, n_tiles, chunk):
    """{(t, i): number of blocks writing compact[t, i]} for the plan: block
    (c, j) writes the valid slots naming j of its rows."""
    cpr = plan.chunk_rows.shape[0] // n_tiles
    count = {}
    for b, rows in enumerate(plan.chunk_rows.tolist()):
        j = b // cpr
        live = [t for t in rows if t >= 0]
        assert rows[:len(live)] == live and len(live) <= chunk
        for t in live:
            hits = [i for i in range(int(nvalid[t])) if int(idx[t, i]) == j]
            assert hits  # a row in tile j's chunks names j
            for i in hits:
                count[t, i] = count.get((t, i), 0) + 1
    return count


@pytest.mark.parametrize("T,K,n_tiles,chunk", [
    (7, 4, 6, 64), (40, 6, 33, 16), (5, 3, 9, 2), (70, 5, 128, 64),
    (4096, 16, 128, 64)])
def test_up_tile_plan_gives_each_valid_slot_one_writer(T, K, n_tiles, chunk):
    """Every valid (row, slot) of the lists is written by exactly one block
    (the chunk of tile idx[t, i] holding row t), a padded slot by none (the
    row pass zeros it); each tile's chunks hold the rows naming it in
    ascending order; the bitmap's bits are the tiles each row names."""
    rng = np.random.RandomState(T + n_tiles)
    idx, nv = _random_lists(rng, T, K, n_tiles)
    plan = up_tile_plan(idx, nv, n_tiles, chunk)
    cpr = -(-T // chunk)
    assert plan.chunk_rows.shape == (n_tiles * cpr, chunk)
    assert plan.bits.shape == (-(-n_tiles // 32), T)
    count = _writers(plan, idx, nv, n_tiles, chunk)
    valid = {(t, i) for t in range(T) for i in range(int(nv[t]))}
    assert set(count) == valid and set(count.values()) <= {1}
    for j in range(n_tiles):
        rows = plan.chunk_rows[j * cpr:(j + 1) * cpr].reshape(-1).tolist()
        assert [t for t in rows if t >= 0] == [
            t for t in range(T) if j in idx[t, :nv[t]].tolist()]
    for t in range(T):
        named = {j for j in range(n_tiles)
                 if (int(plan.bits[j // 32, t]) >> (j % 32)) & 1}
        assert named == set(idx[t, :nv[t]].tolist())


@pytest.mark.parametrize("case", list(_LISTS) + ["random, chunks of 2"])
def test_up_tile_walk_reproduces_pallas_sparse_up_matmul(case):
    """compact filled through the plan (each block's valid slots get the
    plain product of its tile, the padded slots zeros) and scattered by
    ``scatter_compact`` equals the Pallas kernel and the plain version, a
    tile listed twice counting twice."""
    rng = np.random.RandomState(len(case))
    tile, d, n_tiles = 128, 32, 6
    if case in _LISTS:
        idx, nv = (np.asarray(a, np.int32) for a in _LISTS[case])
        chunk = 64
    else:
        idx, nv = _random_lists(rng, 9, 7, n_tiles)
        chunk = 2
    T, K = idx.shape
    x = rng.randn(T, d).astype(np.float32)
    w = (rng.randn(d, n_tiles * tile) / np.sqrt(d)).astype(np.float32)
    tx, tw, ti, tn = map(torch.as_tensor, (x, w, idx, nv))
    plan = up_tile_plan(idx, nv, n_tiles, chunk)
    cpr = -(-T // chunk)
    compact = torch.full((T, K, tile), float("nan"))
    for t in range(T):  # ut_rows: the slots past nvalid
        compact[t, int(nv[t]):] = 0.0
    for b, rows in enumerate(plan.chunk_rows.tolist()):
        j = b // cpr
        for t in (r for r in rows if r >= 0):
            block = tx[t] @ tw[:, j * tile:(j + 1) * tile]
            for i in range(int(nv[t])):
                if int(idx[t, i]) == j:
                    compact[t, i] = block
    assert not torch.isnan(compact).any()  # every element written
    got = tfd.scatter_compact(compact, ti, tn, n_tiles)
    want = jsm.sparse_up_matmul(*map(jnp.asarray, (x, w, idx, nv)), tile=tile,
                                interpret=True)
    _rel_close(got.numpy(), want)
    _rel_close(tsm.sparse_up_matmul_plain(tx, tw, ti, tn, tile=tile).numpy(),
               want)
