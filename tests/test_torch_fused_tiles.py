"""The tensor-core routes of expert_up_matmul and fused_sparse_ffn (bf16 at
tile 128 on the card) walked in plain torch, against the JAX reference's
Pallas kernels (interpret mode on the CPU, f32).

- expert_up_matmul runs the up-projection routine of csrc/up_tiles.cuh
  over the stacked expert weights with global tile ids: ``up_tile_plan``
  (test_torch_up_tiles.py, the model of ``ut_rows``' bitmap and the
  blocks' ballot ranking) over ``expert_tile_lists``' ids gives each valid
  (token, slot) one writer, and the chunks of tile j hold exactly the
  tokens routed to expert j // tpe; a walk of that plan reading the stacked
  weight at (j // tpe, j % tpe) reproduces the Pallas kernel.
- fused_sparse_ffn runs the same routine in list mode with the
  activation, the GLU product and the unit mask in its epilogue (h_compact
  in f32 and a copy rounded to the weights' type), then the tile-grouped
  down gather of csrc/tile_group.cuh in compact mode over that copy, its
  tile ids cut into ``down_runs`` runs: the walk of both halves reproduces
  the Pallas kernel for every activation, GLU on and off, mask on and off,
  on repeated, padded and unsorted lists and nvalid == 0 rows.

Tolerance 1e-5 of max |ref| (f32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_decode as jfd
from repro.kernels import sparse_matmul as jsm
from repro_torch.core import activations as acts
from repro_torch.kernels import fused_decode as tfd
from repro_torch.kernels import sparse_matmul as tsm
from test_torch_kernels import walk_tile_groups
from test_torch_up_tiles import _LISTS, _rel_close, up_tile_plan

torch.set_num_threads(1)


def _writers(plan, idx, nvalid, n_tiles):
    """(T, K) int: the blocks of the plan writing compact[t, i] (block (c,
    j) writes the valid slots naming j of its rows)."""
    T, K = idx.shape
    cpr = plan.chunk_rows.shape[0] // n_tiles
    valid = np.arange(K)[None, :] < nvalid[:, None]
    count = np.zeros((T, K), int)
    for b, rows in enumerate(plan.chunk_rows):
        live = rows[rows >= 0]
        count[live] += (idx[live] == b // cpr) & valid[live]
    return count


def _routing(rng, T, E, k, case):
    """topi (T, k) and k_valid (T,) for a routing case: random experts;
    every token on experts 0 and 1 (their tiles get several chunks); random
    experts with capacity drops (k_valid 0 .. k)."""
    if case == "all tokens on experts 0, 1":
        topi = np.stack([rng.permutation(2) for _ in range(T)])
    else:
        topi = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    kv = rng.randint(0, k + 1, T) if case == "k_valid drops" else None
    return topi.astype(np.int32), kv


@pytest.mark.parametrize("T,case", [
    (8, "random"), (130, "random"), (130, "all tokens on experts 0, 1"),
    (130, "k_valid drops")])
def test_up_tile_plan_over_global_expert_ids(T, case):
    """Mixtral-8x22B's lists (E = 8, top-2, tpe = 128: 1024 global tile ids,
    32 words of bits a row): every valid (token, slot) has one writer and a
    padded slot none, the chunks of tile j hold exactly the tokens whose
    live assignments route to expert j // tpe, ascending, and a row's bits
    are its experts' tiles."""
    E, k, tpe = 8, 2, 128
    rng = np.random.RandomState(T + len(case))
    topi, kv = _routing(rng, T, E, k, case)
    idx, nv = tsm.expert_tile_lists(
        torch.as_tensor(topi), tpe, None if kv is None else torch.as_tensor(kv))
    idx, nv = idx.numpy(), nv.numpy()
    plan = up_tile_plan(idx, nv, E * tpe)
    cpr = -(-T // 64)
    assert plan.bits.shape == (32, T)
    valid = np.arange(idx.shape[1])[None, :] < nv[:, None]
    np.testing.assert_array_equal(_writers(plan, idx, nv, E * tpe), valid)
    live_k = np.full(T, k) if kv is None else kv
    for j in range(E * tpe):
        rows = plan.chunk_rows[j * cpr:(j + 1) * cpr].reshape(-1)
        routed = [t for t in range(T) if j // tpe in topi[t, :live_k[t]]]
        assert rows[rows >= 0].tolist() == routed
    if case == "all tokens on experts 0, 1":
        assert (plan.chunk_rows[2] >= 0).sum() == T - 128  # a third chunk
    for t in range(T):
        tiles = {j for j in range(E * tpe)
                 if (int(plan.bits[j // 32, t]) >> (j % 32)) & 1}
        assert tiles == set(idx[t, :nv[t]].tolist())


def _walk_expert_up(x, w, idx, nvalid, tile, chunk):
    """csrc/up_tiles.cuh over a stack (E, d, F) in plain torch: ut_rows
    zeros the slots past nvalid; block (c, j) multiplies its rows by the
    slab of matrix j // tpe at columns (j % tpe) * tile and writes every
    valid slot of a row naming j."""
    T, K = idx.shape
    E, _, F = w.shape
    tpe = F // tile
    plan = up_tile_plan(idx.numpy(), nvalid.numpy(), E * tpe, chunk)
    cpr = -(-T // chunk)
    compact = torch.full((T, K, tile), float("nan"))
    for t in range(T):
        compact[t, int(nvalid[t]):] = 0.0
    for b, rows in enumerate(plan.chunk_rows.tolist()):
        j = b // cpr
        e, col = divmod(j, tpe)
        for t in (r for r in rows if r >= 0):
            block = x[t] @ w[e, :, col * tile:(col + 1) * tile]
            for i in range(int(nvalid[t])):
                if int(idx[t, i]) == j:
                    compact[t, i] = block
    assert not torch.isnan(compact).any()  # every element written
    return compact


@pytest.mark.parametrize("padded,chunk", [(False, 64), (True, 64), (True, 2)])
def test_stacked_up_tile_walk_reproduces_pallas_expert_up_matmul(padded, chunk):
    """The walk of the plan over global ids (E = 4 experts of tpe = 2 tiles,
    top-2, k_valid drops and a token with no live expert when padded;
    chunks of 2 rows split an expert's tokens) equals the Pallas kernel
    and the plain version, exact zeros past nvalid."""
    rng = np.random.RandomState(7 + chunk)
    T, E, d, F, tile, k = 6, 4, 32, 256, 128, 2
    x = rng.randn(T, d).astype(np.float32)
    w = (rng.randn(E, d, F) / np.sqrt(d)).astype(np.float32)
    topi = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    kv = np.array([2, 2, 1, 0, 2, 1], np.int32) if padded else None
    idx, nv = tsm.expert_tile_lists(
        torch.as_tensor(topi), F // tile, None if kv is None else torch.as_tensor(kv))
    tx, tw = torch.as_tensor(x), torch.as_tensor(w)
    got = _walk_expert_up(tx, tw, idx, nv, tile, chunk)
    want = jsm.expert_up_matmul(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(idx.numpy()), jnp.asarray(nv.numpy()),
                                tile=tile, interpret=True)
    _rel_close(got.numpy(), want)
    _rel_close(tsm.expert_up_matmul_plain(tx, tw, idx, nv, tile=tile).numpy(),
               want)
    live = np.arange(idx.shape[1])[None, :] < nv.numpy()[:, None]
    assert not got.numpy()[~live].any()


def _walk_fused(x, wg, wu, wd, mask, idx, nvalid, *, activation, shift, tile,
                run):
    """csrc/fused_sparse_ffn.cu's tensor-core route in plain torch: the
    up-tile plan, the epilogue v = act(x @ Wg) [* (x @ Wu)] [* mask] for each
    block's rows written to the valid slots naming its tile, the compact
    copy rounded to the weights' type, then the tile-grouped compact walk
    over runs of ``run`` tile ids."""
    T, K = idx.shape
    n_tiles = wg.shape[1] // tile
    act = acts.get(activation, shift=shift)
    plan = up_tile_plan(idx.numpy(), nvalid.numpy(), n_tiles)
    cpr = -(-T // 64)
    h = torch.zeros((T, K, tile))  # ut_rows: the slots past nvalid
    for b, rows in enumerate(plan.chunk_rows.tolist()):
        j = b // cpr
        cols = slice(j * tile, (j + 1) * tile)
        for t in (r for r in rows if r >= 0):
            v = act(x[t] @ wg[:, cols])
            if wu is not None:
                v = v * (x[t] @ wu[:, cols])
            if mask is not None:
                v = v * mask[t, cols]
            for i in range(int(nvalid[t])):
                if int(idx[t, i]) == j:
                    h[t, i] = v
    hb = h.to(wd.dtype)
    y = walk_tile_groups(hb, wd, idx, nvalid, tile=tile, run=run, compact=True)
    return y, h


_ACTS = [("relu", 0.0), ("gelu", 0.0), ("silu", 0.0), ("beta=8", 0.0),
         ("shifted_relu", 0.25), ("fatrelu:0.1", 0.0)]


@pytest.mark.parametrize("case", list(_LISTS))
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("glu", [False, True])
@pytest.mark.parametrize("activation,shift", _ACTS)
def test_fused_tile_walk_reproduces_pallas_fused_sparse_ffn(
        activation, shift, glu, masked, case):
    """Both halves of kernel 1's tensor-core route, walked with one run of
    tile ids and with the runs ``down_runs`` picks for these shapes (one
    tile a run here), equal the Pallas kernel's y and h_compact; rows with
    nvalid == 0 are exact zeros."""
    rng = np.random.RandomState(len(case) + 3 * glu + masked)
    tile, n_tiles, d = 128, 6, 32
    F = n_tiles * tile
    idx, nv = (np.asarray(a, np.int32) for a in _LISTS[case])
    T = idx.shape[0]
    x = rng.randn(T, d).astype(np.float32)
    wg = (rng.randn(d, F) / np.sqrt(d)).astype(np.float32)
    wu = (rng.randn(d, F) / np.sqrt(d)).astype(np.float32) if glu else None
    wd = (rng.randn(F, d) / np.sqrt(F)).astype(np.float32)
    mask = (rng.rand(T, F) < 0.6).astype(np.float32) if masked else None
    jy, jh = jfd.fused_sparse_ffn(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wd), jnp.asarray(idx),
        jnp.asarray(nv), w_up=None if wu is None else jnp.asarray(wu),
        unit_mask=None if mask is None else jnp.asarray(mask),
        activation=activation, shift=shift, tile=tile, interpret=True)
    t = {k: None if v is None else torch.as_tensor(v)
         for k, v in dict(x=x, wg=wg, wu=wu, wd=wd, mask=mask, idx=idx,
                          nv=nv).items()}
    _, R = tfd.down_runs(T, d, n_tiles)
    for run in {n_tiles, R}:
        y, h = _walk_fused(t["x"], t["wg"], t["wu"], t["wd"], t["mask"],
                           t["idx"], t["nv"], activation=activation,
                           shift=shift, tile=tile, run=run)
        _rel_close(y.numpy(), jy)
        _rel_close(h.numpy(), jh)
        empty = nv == 0
        assert not y.numpy()[empty].any() and not h.numpy()[empty].any()


@pytest.mark.parametrize("T,D,n_tiles,want", [
    (8, 4096, 128, (4, 32)),      # OPT-6.7B decode: 128 blocks, not 32
    (128, 4096, 128, (2, 64)),    # two chunks of rows
    (512, 4096, 128, (1, 128)),   # the rows alone fill the card
    (8, 4096, 224, (4, 56)),      # d_ff = 28672
    (4096, 8192, 224, (2, 112)),  # runs forced by the longest run (128 ids)
    (3, 32, 6, (6, 1)),
])
def test_down_runs_fill_one_wave_within_the_routines_limits(T, D, n_tiles,
                                                           want):
    """The down half's runs: as many as keep (run, chunk, column block)
    blocks within one wave of the card's 132 SMs, none longer than
    TG_RMAX tile ids, covering every id, and the pair partials of a slab
    of rows stay under the routine's scratch bound."""
    n_runs, R = tfd.down_runs(T, D, n_tiles)
    assert (n_runs, R) == want
    assert R <= tsm.TG_RMAX and n_runs <= tsm.TG_MAX_RUNS
    assert (n_runs - 1) * R < n_tiles <= n_runs * R
    blocks = n_runs * -(-T // tsm.TG_M) * -(-D // 128)
    assert blocks <= tfd.SMS or R == -(-n_tiles // -(-n_tiles // tsm.TG_RMAX))
    slab = tsm.tile_group_slab_rows(D, n_runs)
    if slab is not None:
        assert min(T, slab) * (n_runs * D * 4 + 8) <= tsm.TG_SCRATCH_BYTES
