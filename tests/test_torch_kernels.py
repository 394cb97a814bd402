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
    torch.testing.assert_close(
        tsm.sparse_matmul_tokens(xs, c(wd), idx, nv, tile=tile),
        tsm.sparse_matmul_tokens_plain(xs, c(wd), idx, nv, tile=tile), **TOL)
