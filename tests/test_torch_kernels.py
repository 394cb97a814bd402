"""The PyTorch port's kernel modules against the JAX reference's Pallas
kernels (interpret mode on the CPU), at the small shapes of
tests/test_fused_decode.py. On the CPU every wrapper takes its plain
PyTorch version; the CUDA kernels themselves are checked against those
plain versions on the card (``cuda``-marked test here, and chip_smoke.py).

Tolerance 1e-5 (f32): the port and the reference sum in different orders.
Tile lists must match exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_decode as jfd
from repro.kernels import fused_ffn as jff
from repro.kernels import paged_attention as jpa
from repro.kernels import sparse_matmul as jsm
from repro.predictor import predictors as jpred
from repro_torch.kernels import fused_decode as tfd
from repro_torch.kernels import fused_ffn as tff
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import runtime as rt
from repro_torch.kernels import sparse_matmul as tsm
from repro_torch.predictor import predictors as tpred

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want),
                               **TOL)


def _both(a):
    """One numpy array handed to both frameworks."""
    return jnp.asarray(a), torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# tile lists: exact


@pytest.mark.parametrize("p,k", [(0.0, 8), (1.0, 8), (0.3, 8), (0.6, 8),
                                 (0.6, 3), (1.0, 5)])
def test_pack_tile_indices_matches_reference_exactly(p, k):
    """Rows with no active tile, all tiles active, and truncation (k below
    the active count): idx and nvalid equal the reference's bit for bit."""
    rng = np.random.RandomState(int(p * 10) + k)
    mask = rng.rand(6, 8) < p
    mask[0] = False
    mask[1] = True
    j_idx, j_nv = jpred.pack_tile_indices(jnp.asarray(mask), k)
    t_idx, t_nv = tpred.pack_tile_indices(torch.as_tensor(mask), k)
    assert t_idx.dtype == torch.int32 and t_nv.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_nv.numpy(), np.asarray(j_nv))
    np.testing.assert_array_equal(
        tpred.covered_tiles(t_idx, t_nv, 8).numpy(),
        np.asarray(jpred.covered_tiles(j_idx, j_nv, 8)))


def test_units_tiles_round_trip_matches_reference():
    units = np.random.RandomState(0).rand(3, 64) < 0.05
    j = jpred.units_to_tiles(jnp.asarray(units), 16)
    t = tpred.units_to_tiles(torch.as_tensor(units), 16)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tpred.tiles_to_units(t, 16).numpy(),
                                  np.asarray(jpred.tiles_to_units(j, 16)))


def test_tile_activity_scores_match_reference():
    h = np.random.RandomState(1).randn(2, 3, 512).astype(np.float32)
    h[h < 0.5] = 0.0
    jh, th = _both(h)
    _close(tff.window_tile_activity(th), jff.window_tile_activity(jh))
    _close(tff.tile_activity(th[:, 0]), jff.tile_activity(jh[:, 0]))


# ---------------------------------------------------------------------------
# fused_sparse_ffn


def _ffn_case(T=4, d=64, F=512, tile=128, p=0.5, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, d).astype(np.float32)
    wg = (rng.randn(d, F) / np.sqrt(d)).astype(np.float32)
    wu = (rng.randn(d, F) / np.sqrt(d)).astype(np.float32)
    wd = (rng.randn(F, d) / np.sqrt(F)).astype(np.float32)
    mask = rng.rand(T, F // tile) < p
    mask[0] = False  # an nvalid == 0 row
    unit = rng.rand(T, F) < 0.6
    return x, wg, wu, wd, mask, unit, tile


@pytest.mark.parametrize("glu,masked,activation,shift", [
    (False, False, "relu", 0.0),
    (True, False, "relu", 0.0),
    (False, True, "relu", 0.0),        # OPT's decode path: MLP + unit mask
    (True, True, "shifted_relu", 0.25),
    (False, False, "gelu", 0.0),
    (True, True, "silu", 0.0),
    (True, False, "fatrelu:0.1", 0.0),
    (False, True, "beta=8", 0.0),
])
def test_fused_sparse_ffn_matches_pallas(glu, masked, activation, shift):
    x, wg, wu, wd, mask, unit, tile = _ffn_case(seed=3)
    n_tiles = wg.shape[1] // tile
    j_idx, j_nv = jpred.pack_tile_indices(jnp.asarray(mask), n_tiles)
    t_idx, t_nv = tpred.pack_tile_indices(torch.as_tensor(mask), n_tiles)
    jy, jh = jfd.fused_sparse_ffn(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wd), j_idx, j_nv,
        w_up=jnp.asarray(wu) if glu else None,
        unit_mask=jnp.asarray(unit) if masked else None,
        activation=activation, shift=shift, tile=tile)
    ty, th = tfd.fused_sparse_ffn(
        torch.as_tensor(x), torch.as_tensor(wg), torch.as_tensor(wd), t_idx,
        t_nv, w_up=torch.as_tensor(wu) if glu else None,
        unit_mask=torch.as_tensor(unit) if masked else None,
        activation=activation, shift=shift, tile=tile)
    _close(ty, jy)
    _close(th, jh)
    _close(tfd.scatter_compact(th, t_idx, t_nv, n_tiles),
           jfd.scatter_compact(jh, j_idx, j_nv, n_tiles))
    assert (ty[0] == 0).all() and (th[0] == 0).all()  # nvalid == 0 row


def test_fused_sparse_ffn_duplicate_pads_add_nothing():
    """Pads repeat the row's first tile; they must add nothing to y and to
    the scattered h (reference's pinned single-tile case)."""
    x, wg, wu, wd, _, _, tile = _ffn_case(T=2, seed=11)
    mask = np.zeros((2, 4), bool)
    mask[0, 2] = True
    idx, nv = tpred.pack_tile_indices(torch.as_tensor(mask), 4)
    assert idx[0].tolist() == [2, 2, 2, 2] and nv.tolist() == [1, 0]
    y, h = tfd.fused_sparse_ffn(torch.as_tensor(x), torch.as_tensor(wg),
                                torch.as_tensor(wd), idx, nv,
                                w_up=torch.as_tensor(wu), tile=tile)
    sl = slice(2 * tile, 3 * tile)
    h_ref = np.maximum(x[:1] @ wg[:, sl], 0.0) * (x[:1] @ wu[:, sl])
    hh = tfd.scatter_compact(h, idx, nv, 4)
    np.testing.assert_allclose(hh[0, sl].numpy(), h_ref[0], **TOL)
    np.testing.assert_allclose(y[0].numpy(), (h_ref @ wd[sl])[0], **TOL)
    assert (y[1] == 0).all() and (hh[1] == 0).all()


def test_modeled_bytes_match_reference():
    assert tfd.modeled_weight_bytes(3, 128, 64, 2, 2) == \
        jfd.modeled_weight_bytes(3, 128, 64, 2, 2)
    assert tpa.modeled_cache_bytes(4, 8, 2, 16, 4) == \
        jpa.modeled_cache_bytes(4, 8, 2, 16, 4)


# ---------------------------------------------------------------------------
# paged_window_attention


def _attn_case(W, b=3, kvp=2, g=2, hd=16, n_blocks=9, bs=8, nb=4, seed=2):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, W, kvp, g, hd).astype(np.float32)
    kp = rng.randn(n_blocks, kvp, bs, hd).astype(np.float32)
    vp = rng.randn(n_blocks, kvp, bs, hd).astype(np.float32)
    table = rng.randint(1, n_blocks, (b, nb)).astype(np.int32)
    table[0, 2:] = 0  # padding rows point at the scratch block
    pos = (rng.randint(W - 1, nb * bs, (b,))[:, None]
           + np.arange(-W + 1, 1)[None, :]).astype(np.int32)
    pos[0] = np.arange(W) + 2 * bs - W  # slot 0 ends inside its second block
    return q, kp, vp, table, pos


@pytest.mark.parametrize("W,window,g", [(1, 0, 2), (5, 5, 2), (5, 0, 8),
                                        (1, 3, 1)])
def test_paged_window_attention_matches_pallas(W, window, g):
    q, kp, vp, table, pos = _attn_case(W, g=g)
    want = jpa.paged_window_attention(*map(jnp.asarray, (q, kp, vp, table, pos)),
                                      window=window)
    got = tpa.paged_window_attention(*map(torch.as_tensor,
                                          (q, kp, vp, table, pos)),
                                     window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got, want)


def test_paged_decode_attention_matches_pallas():
    q, kp, vp, table, pos = _attn_case(1)
    want = jpa.paged_decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(kp),
                                      jnp.asarray(vp), jnp.asarray(table),
                                      jnp.asarray(pos[:, 0]))
    got = tpa.paged_decode_attention(torch.as_tensor(q[:, 0]),
                                     torch.as_tensor(kp), torch.as_tensor(vp),
                                     torch.as_tensor(table),
                                     torch.as_tensor(pos[:, 0]))
    _close(got, want)


# the assigned configs' (kv heads, group) as the served layout pads their
# q heads (to a multiple of 16): Qwen2-7B's 28 heads over 4 kv heads take
# groups of 8 with 7 real; its real ratio g = 7 is a case of its own
ZOO_HEADS = {"qwen3-4b": (8, 4), "qwen2-7b": (4, 8), "qwen2-7b real": (4, 7),
             "starcoder2-15b": (4, 12), "deepseek-67b": (8, 8),
             "phi3.5-moe-42b-a6.6b": (8, 4)}


@pytest.mark.parametrize("name", [n for n in ZOO_HEADS if " " not in n])
def test_zoo_head_layouts_are_the_served_ones(name):
    from repro_torch.configs import get_config
    from repro_torch.models.common import HeadGeometry
    cfg = get_config(name)
    g = HeadGeometry(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert (g.kvp, g.group) == ZOO_HEADS[name]
    assert g.real_per_group == cfg.n_heads // cfg.n_kv_heads


@pytest.mark.parametrize("W", [1, 16])
@pytest.mark.parametrize("name", sorted(set(ZOO_HEADS) - {"phi3.5-moe-42b-a6.6b"}))
def test_paged_window_attention_at_zoo_head_ratios(name, W):
    """Decode (W = 1) and a 16-token chunk at each assigned config's (kvp,
    g) (Phi-3.5-MoE's is Qwen3-4B's), blocks of 8, a slot ending inside a
    block, against the Pallas kernel."""
    kvp, g = ZOO_HEADS[name]
    q, kp, vp, table, pos = _attn_case(W, kvp=kvp, g=g, n_blocks=13, nb=4)
    want = jpa.paged_window_attention(*map(jnp.asarray,
                                           (q, kp, vp, table, pos)))
    got = tpa.paged_window_attention(*map(torch.as_tensor,
                                          (q, kp, vp, table, pos)))
    assert got.shape == q.shape
    _close(got, want)


# ---------------------------------------------------------------------------
# sparse_matmul_tokens


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_sparse_matmul_tokens_matches_pallas(p):
    rng = np.random.RandomState(int(p * 10))
    T, F, D, tile = 5, 512, 64, 128
    x = (rng.randn(T, F) * (rng.rand(T, F) < 0.5)).astype(np.float32)
    w = (rng.randn(F, D) / np.sqrt(F)).astype(np.float32)
    mask = rng.rand(T, F // tile) < p
    j_idx, j_nv = jpred.pack_tile_indices(jnp.asarray(mask), F // tile)
    t_idx, t_nv = tpred.pack_tile_indices(torch.as_tensor(mask), F // tile)
    want = jsm.sparse_matmul_tokens(jnp.asarray(x), jnp.asarray(w), j_idx,
                                    j_nv, tile=tile)
    got = tsm.sparse_matmul_tokens(torch.as_tensor(x), torch.as_tensor(w),
                                   t_idx, t_nv, tile=tile)
    assert got.dtype == torch.float32
    _close(got, want)


# ---------------------------------------------------------------------------
# repeated tiles: every valid slot counts, as in the Pallas kernels

_LISTS = {  # (idx (2, 4), nvalid (2,)) over 4 tiles
    "repeated valid": ([[1, 1, 2, 0], [3, 0, 0, 0]], [3, 1]),
    "pads repeat the first tile": ([[2, 2, 2, 2], [1, 3, 1, 1]], [1, 2]),
    "unsorted": ([[3, 0, 2, 1], [2, 3, 1, 0]], [4, 3]),
}


@pytest.mark.parametrize("case", list(_LISTS))
@pytest.mark.parametrize("kernel", ["sparse_matmul_tokens", "sparse_matmul",
                                    "fused_sparse_ffn", "sparse_up_matmul"])
def test_plain_versions_add_a_repeated_tile_once_per_slot(kernel, case):
    """The four plain versions equal the Pallas kernels on lists whose valid
    entries repeat a tile (the kernels add one product per valid slot),
    whose pads repeat the first tile, or that are not sorted."""
    rng = np.random.RandomState(7)
    tile, d, F = 128, 64, 512
    idx, nv = (np.asarray(a, np.int32) for a in _LISTS[case])
    ji, ti = _both(idx)
    jn, tn = _both(nv)
    if kernel in ("sparse_matmul_tokens", "sparse_matmul"):
        jx, tx = _both(rng.randn(2, F).astype(np.float32))
        jw, tw = _both((rng.randn(F, d) / np.sqrt(F)).astype(np.float32))
        if kernel == "sparse_matmul":
            ji, ti, jn, tn = ji[0], ti[0], jn[0], tn[0]
        want = getattr(jsm, kernel)(jx, jw, ji, jn, tile=tile)
        got = getattr(tsm, kernel)(tx, tw, ti, tn, tile=tile)
    elif kernel == "sparse_up_matmul":
        jx, tx = _both(rng.randn(2, d).astype(np.float32))
        jw, tw = _both((rng.randn(d, F) / np.sqrt(d)).astype(np.float32))
        want = jsm.sparse_up_matmul(jx, jw, ji, jn, tile=tile)
        got = tsm.sparse_up_matmul(tx, tw, ti, tn, tile=tile)
    else:
        x, wg, wu, wd, _, _, _ = _ffn_case(T=2, seed=8)
        jy, jh = jfd.fused_sparse_ffn(*map(jnp.asarray, (x, wg, wd)), ji, jn,
                                      w_up=jnp.asarray(wu), tile=tile)
        ty, th = tfd.fused_sparse_ffn(*map(torch.as_tensor, (x, wg, wd)), ti,
                                      tn, w_up=torch.as_tensor(wu), tile=tile)
        _close(th, jh)
        want, got = jy, ty
    _close(got, want)


# ---------------------------------------------------------------------------
# the tile-grouped tensor-core routine's plan, walked in plain torch


def bf16_terms(v, n: int):
    """The routine's split of an f32 A operand into n bf16 terms: each term
    is the remainder so far rounded to bf16 (csrc/tile_group.cuh
    tg_afrag_f32), returned as f32 tensors."""
    out, r = [], v.float()
    for _ in range(n):
        h = r.to(torch.bfloat16).float()
        out.append(h)
        r = r - h
    return out


def walk_tile_groups(a, w, idx, nvalid, *, tile: int, run: int,
                     compact: bool, terms=None, chunk: int = tsm.TG_M):
    """csrc/tile_group.cuh in plain torch: per chunk of the plan (rows
    c * chunk .. with one run), the union of the tiles its rows name in
    ascending id, each walked once per repeat (a row's A slice zeroed where
    it names the tile no more often, its (rep+1)-th slot's block in compact
    mode), f32 partials per (run, row), then each row's partials summed in
    ascending run order. A is multiplied as it is (terms None) or split
    into ``terms`` bf16 terms."""
    T, K = idx.shape
    D = w.shape[-1]
    w2 = w.reshape(-1, D).float()
    n_tiles = w2.shape[0] // tile
    n_runs = -(-n_tiles // run)
    if n_runs == 1:
        chunks = [(0, list(range(r0, min(T, r0 + chunk))))
                  for r0 in range(0, T, chunk)]
    else:
        plan = tsm.tile_group_plan(idx, nvalid, run, n_runs, chunk)
        cpr = plan.chunk_rows.shape[0] // n_runs
        chunks = [(c // cpr, [t for t in plan.chunk_rows[c].tolist() if t >= 0])
                  for c in range(plan.chunk_rows.shape[0])]
    P = torch.zeros((n_runs, T, D))
    for s, rows in chunks:
        if not rows:
            continue
        tiles = range(s * run, min((s + 1) * run, n_tiles))
        slots = [{ti: [i for i in range(int(nvalid[t])) if int(idx[t, i]) == ti]
                  for ti in tiles} for t in rows]
        acc = torch.zeros((len(rows), D))
        for ti in tiles:  # ascending; tiles no row names add nothing
            for rep in range(max(len(sl[ti]) for sl in slots)):
                A = torch.zeros((len(rows), tile))
                for m, t in enumerate(rows):
                    if len(slots[m][ti]) > rep:
                        A[m] = (a[t, slots[m][ti][rep]] if compact
                                else a[t, ti * tile:(ti + 1) * tile]).float()
                parts = [A] if terms is None else bf16_terms(A, terms)
                for part in reversed(parts):  # smallest term first
                    acc += part @ w2[ti * tile:(ti + 1) * tile]
        P[s, rows] = acc
    return P.sum(0) if n_runs > 1 else P[0]


def _random_lists(rng, T, K, n_tiles, *, unsorted=True, repeats=True):
    idx = np.stack([rng.permutation(n_tiles)[:K] if K <= n_tiles
                    else rng.randint(0, n_tiles, K) for _ in range(T)])
    if not unsorted:
        idx = np.sort(idx, 1)
    if repeats:
        idx[1::3, 1] = idx[1::3, 0]  # a tile listed twice among valid slots
    nv = rng.randint(0, K + 1, T)
    nv[0] = 0
    idx = np.where(np.arange(K)[None, :] < nv[:, None], idx, idx[:, :1])
    return idx.astype(np.int32), nv.astype(np.int32)


@pytest.mark.parametrize("T,K,n_tiles,run,chunk", [
    (7, 4, 8, 8, 64), (7, 4, 8, 2, 64), (40, 6, 12, 4, 16), (5, 3, 9, 4, 2),
    (33, 16, 128, 128, 16), (4096, 16, 128, 32, 64)])
def test_tile_group_plan_covers_each_valid_slot_once(T, K, n_tiles, run, chunk):
    """Every (row, run) named by a valid slot is exactly one pair of one
    chunk of that run; a run's chunks hold its rows in ascending order, at
    most ``chunk`` each; the runs mask has the same pairs; rows with
    nvalid == 0 have none."""
    rng = np.random.RandomState(T + K)
    idx, nv = _random_lists(rng, T, K, n_tiles)
    n_runs = -(-n_tiles // run)
    plan = tsm.tile_group_plan(torch.as_tensor(idx), torch.as_tensor(nv), run,
                               n_runs, chunk)
    cpr = -(-T // chunk)
    assert plan.mask.dtype == torch.int64 and plan.chunk_rows.dtype == torch.int32
    assert plan.chunk_rows.shape == (n_runs * cpr, chunk)
    want = [(s, t) for s in range(n_runs) for t in range(T)
            if s in {int(i) // run for i in idx[t, :nv[t]]}]
    got = []
    for c, rows in enumerate(plan.chunk_rows.tolist()):
        live = [t for t in rows if t >= 0]
        assert rows[:len(live)] == live  # the pairs first, then -1
        got += [(c // cpr, t) for t in live]
    assert got == want  # each pair once, in (run, row) order
    for t in range(T):
        bits = {s for s in range(n_runs) if (int(plan.mask[t]) >> s) & 1}
        assert bits == {int(i) // run for i in idx[t, :nv[t]]}


@pytest.mark.parametrize("T,K,D,n_tiles,run", [
    (8, 128, 4096, 128, 128), (128, 128, 4096, 128, 128),
    (4096, 128, 4096, 128, 128), (4096, 256, 4096, 128, 32),
    (8, 256, 6144, 1024, 128), (128, 256, 6144, 1024, 128),
    (4096, 256, 6144, 1024, 128), (4096, 2, 65536, 1024, 128),
    (4096, 256, 6144, 8192, 128)])
def test_tile_group_scratch_stays_bounded(T, K, D, n_tiles, run):
    """One run needs no scratch (the blocks write y); otherwise each slab's
    pair partials (rows x runs x D f32, sized by the upper bound) and runs
    mask stay under TG_SCRATCH_BYTES up to T = 4096 (16 slots x 256-token
    chunks), and the plan's chunks cover every pair."""
    n_runs = -(-n_tiles // run)
    if n_runs == 1:
        assert tsm.tile_group_slab_rows(D, n_runs) is None
        return
    rows = min(T, tsm.tile_group_slab_rows(D, n_runs))
    assert rows * (n_runs * D * 4 + 8) <= tsm.TG_SCRATCH_BYTES
    idx = ((torch.arange(K)[None, :] * run + torch.arange(rows)[:, None])
           % n_tiles).to(torch.int32)  # slot i in run i mod n_runs
    plan = tsm.tile_group_plan(idx, torch.full((rows,), K, dtype=torch.int32),
                               run, n_runs)
    n_pairs = int((plan.chunk_rows >= 0).sum())
    assert n_pairs == rows * min(K, n_runs)  # every row meets min(K, runs) runs


@pytest.mark.parametrize("case", ["one run", "four runs", "repeats unsorted",
                                  "chunks of 2", "f32 x, bf16 w"])
def test_tile_group_walk_matches_plain_and_pallas(case):
    """The plain walk of the routine (chunks, unions, zeroed rows, repeats,
    ordered sum) equals sparse_matmul_tokens' plain version and the Pallas
    kernel at f32, with nvalid == 0 rows, repeated tiles and unsorted
    lists; an f32 x against bf16 weights through three bf16 terms, not
    rounded."""
    rng = np.random.RandomState(len(case))
    T, K, tile, D = 9, 5, 16, 24
    n_tiles = 8
    run, chunk = {"one run": (8, 64), "four runs": (2, 64),
                  "repeats unsorted": (4, 64), "chunks of 2": (2, 2),
                  "f32 x, bf16 w": (8, 64)}[case]
    idx, nv = _random_lists(rng, T, K, n_tiles,
                            unsorted=case != "one run",
                            repeats=case in ("repeats unsorted", "f32 x, bf16 w"))
    x = (rng.randn(T, n_tiles * tile)).astype(np.float32)
    w = (rng.randn(n_tiles * tile, D) / 8).astype(np.float32)
    w_dtype = "bfloat16" if case == "f32 x, bf16 w" else "float32"
    tx, ti, tn = map(torch.as_tensor, (x, idx, nv))
    tw = torch.as_tensor(w).to(getattr(torch, w_dtype))
    got = walk_tile_groups(tx, tw, ti, tn, tile=tile, run=run, compact=False,
                           chunk=chunk,
                           terms=3 if w_dtype == "bfloat16" else None)
    _close(got, tsm.sparse_matmul_tokens_plain(tx, tw, ti, tn, tile=tile))
    _close(got, jsm.sparse_matmul_tokens(
        jnp.asarray(x), jnp.asarray(w, getattr(jnp, w_dtype)), jnp.asarray(idx),
        jnp.asarray(nv), tile=tile))
    assert not got[nv == 0].any()


# ---------------------------------------------------------------------------
# dispatch


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A wrapper takes the plain version only for CPU tensors; anything
    else must launch the kernel or raise — never fall back."""
    x = torch.zeros(2, 256, device="meta")
    w = torch.zeros(256, 64)
    idx = torch.zeros(2, 2, dtype=torch.int32)
    nv = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
        tsm.sparse_matmul_tokens(x, w, idx, nv)
    assert rt.on_cpu(w, idx, nv)


@pytest.mark.parametrize("T,K,D", [(8, 128, 4096), (128, 128, 4096),
                                   (4096, 128, 4096), (1, 1, 64), (3, 0, 64),
                                   (64, 512, 8192)])
def test_gather_runs_cover_the_list_with_bounded_scratch(T, K, D):
    """The tile gather's runs cover the K list slots exactly (S runs of
    ``run`` slots, the last one non-empty), and its run scratch stays under
    9 MB at any T and K — none when one run holds the whole list."""
    run, scratch = rt.gather_runs(T, K, D, "cpu")
    S = 1 if scratch is None else scratch.shape[1]
    assert run >= 1 and (K == 0 or (S - 1) * run < K <= S * run)
    if scratch is not None:
        assert S > 1 and scratch.shape == (T, S, D)
        assert scratch.dtype == torch.float32
        assert scratch.numel() * 4 < 9 * 2 ** 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the CUDA kernels have no "
                    "CPU mode; their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    """On the card: each kernel against its plain version at small f32
    shapes, with launch counts."""
    x, wg, wu, wd, mask, unit, tile = _ffn_case(seed=5)
    c = lambda a: torch.as_tensor(a).to(cuda_device)  # noqa: E731
    idx, nv = tpred.pack_tile_indices(c(mask), wg.shape[1] // tile)
    n0 = tfd.fused_sparse_ffn.launches
    got = tfd.fused_sparse_ffn(c(x), c(wg), c(wd), idx, nv, w_up=c(wu),
                               unit_mask=c(unit), tile=tile)
    want = tfd.fused_sparse_ffn_plain(c(x), c(wg), c(wd), idx, nv, w_up=c(wu),
                                      unit_mask=c(unit), tile=tile)
    assert tfd.fused_sparse_ffn.launches == n0 + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
    args = [c(a) for a in _attn_case(5)]
    torch.testing.assert_close(
        tpa.paged_window_attention(*args, window=5),
        tpa.paged_window_attention_plain(*args, window=5), **TOL)
    xs = c(np.random.RandomState(0).randn(4, 512).astype(np.float32))
    # f32 weights: the CUDA-core gather; bf16: the tile-grouped tensor-core
    # routine (the f32 x unrounded in both, as three bf16 terms in the kernel,
    # so only the f32 sums' order differs)
    for w in (c(wd), c(wd).bfloat16()):
        torch.testing.assert_close(
            tsm.sparse_matmul_tokens(xs, w, idx, nv, tile=tile),
            tsm.sparse_matmul_tokens_plain(xs, w, idx, nv, tile=tile), **TOL)
    # bf16 attention with its pages cut into several runs, merged by the
    # second launch (bf16 tolerance: p is rounded to bf16 for p @ v)
    args = [c(a) for a in _attn_case(4, b=2, g=6, hd=64, n_blocks=60, bs=16,
                                     nb=24)]
    args[:3] = [a.bfloat16() for a in args[:3]]
    assert tpa.attention_splits(2, 2, 24, 24, 64, 16,
                                tpa._sm_count(cuda_device)) > 1
    got = tpa.paged_window_attention(*args, window=9)
    want = tpa.paged_window_attention_plain(*args, window=9).float()
    assert (got.float() - want).abs().max() <= 1e-2 * want.abs().max()
    # one shared list with bf16 weights: the shared-list tile groups, an f32
    # x unrounded (f32 tolerance), a bf16 x at the bf16 tolerance; a tile
    # listed twice counts twice, the pad past nvalid not at all
    li = c(np.array([3, 1, 3, 0], np.int32))
    lv = c(np.array(3, np.int32))
    wb = c(wd).bfloat16()
    torch.testing.assert_close(tsm.sparse_matmul(xs, wb, li, lv, tile=tile),
                               tsm.sparse_matmul_plain(xs, wb, li, lv,
                                                       tile=tile), **TOL)
    yb = tsm.sparse_matmul(xs.bfloat16(), wb, li, lv, tile=tile)
    want = tsm.sparse_matmul_plain(xs.bfloat16(), wb, li, lv, tile=tile)
    assert (yb - want).abs().max() <= 1e-2 * want.abs().max()
