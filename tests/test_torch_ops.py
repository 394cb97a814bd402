"""The port's second-slice kernel modules against the JAX reference's Pallas
kernels (interpret mode on the CPU): ``sparse_up_matmul``,
``fused_up_relu`` and ``sparse_matmul`` (their plain versions: on the CPU
every wrapper takes them), and the ``ops.sparse_ffn_apply`` entry point
with its static top-k selection. The CUDA kernels are held against the
plain versions on the card (``cuda``-marked test here, and chip_smoke.py).

Tolerance 1e-5 (f32): the port and the reference sum in different orders.
Tile lists and counts must match exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_ffn as jff
from repro.kernels import ops as jops
from repro.kernels import sparse_matmul as jsm
from repro.predictor import predictors as jpred
from repro_torch.kernels import fused_ffn as tff
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparse_matmul as tsm
from repro_torch.predictor import predictors as tpred

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()), np.asarray(want),
                               **TOL)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# sparse_up_matmul


@pytest.mark.parametrize("case", ["random", "nvalid0", "dup_pads", "full"])
def test_sparse_up_matmul_matches_pallas(case):
    """Listed output tiles equal the reference's, the rest exact zeros;
    rows with nvalid == 0 are zero and duplicate pads add nothing."""
    rng = np.random.RandomState(3)
    T, d, F, tile = 5, 32, 256, 32
    x = rng.randn(T, d).astype(np.float32)
    w = (rng.randn(d, F) / np.sqrt(d)).astype(np.float32)
    p = {"random": 0.4, "nvalid0": 0.0, "dup_pads": 0.15, "full": 1.0}[case]
    mask = rng.rand(T, F // tile) < p
    if case == "dup_pads":
        mask[:] = False
        mask[:, 5] = True  # one tile, padded with duplicates of it
    j_idx, j_nv = jpred.pack_tile_indices(jnp.asarray(mask), F // tile)
    t_idx, t_nv = tpred.pack_tile_indices(_t(mask), F // tile)
    want = jsm.sparse_up_matmul(jnp.asarray(x), jnp.asarray(w), j_idx, j_nv,
                                tile=tile)
    got = tsm.sparse_up_matmul(_t(x), _t(w), t_idx, t_nv, tile=tile)
    assert got.dtype == torch.float32 and got.shape == (T, F)
    _close(got, want)
    cov = tpred.tiles_to_units(tpred.covered_tiles(t_idx, t_nv, F // tile), tile)
    assert (got[~cov] == 0).all()
    if case == "nvalid0":
        assert (got == 0).all()


# ---------------------------------------------------------------------------
# fused_up_relu


@pytest.mark.parametrize("shift", [0.0, 0.3, -0.2, 50.0])
def test_fused_up_relu_matches_pallas(shift):
    """h and the tile scores (max over all rows and lanes) equal the
    reference's; a shift above every pre-activation gives all-zero h and
    scores (tied zero scores)."""
    rng = np.random.RandomState(4)
    x = rng.randn(6, 64).astype(np.float32)
    wu = (rng.randn(64, 1024) / 8.0).astype(np.float32)
    jh, js = jff.fused_up_relu(jnp.asarray(x), jnp.asarray(wu), shift)
    th, ts = tff.fused_up_relu(_t(x), _t(wu), shift)
    assert th.dtype == torch.float32 and ts.shape == (1024 // 128,)
    _close(th, jh)
    _close(ts, js)
    if shift > 10:
        assert (th == 0).all() and (ts == 0).all()


@pytest.mark.parametrize("T,d,F", [(8, 4096, 16384), (128, 4096, 16384),
                                   (40, 4096, 1024), (4, 64, 256),
                                   (4096, 4096, 16384)])
def test_up_relu_plan_covers_d_with_bounded_scratch(T, d, F):
    """The kernel's d-ranges cover d exactly in whole staged slices, and
    its partial-sum scratch stays under the cap."""
    tm, S, kc = tff.up_relu_plan(T, d, F)
    assert tm in (1, 4, 8) and T <= 16 * tm or tm == 8
    assert kc % tff.UR_BK == 0 and (S - 1) * kc < d <= S * kc
    assert S == 1 or S * T * F * 4 <= tff.UR_MAX_SCRATCH


# ---------------------------------------------------------------------------
# sparse_matmul (one shared list)


@pytest.mark.parametrize("idx,nvalid", [([3, 0, 2], 3), ([3, 0, 2], 2),
                                        ([1, 1, 1], 1), ([2, 1, 0], 0)])
def test_sparse_matmul_matches_pallas(idx, nvalid):
    """A list in score order (not ascending), a short nvalid, duplicate
    pads, and nvalid == 0 (exact zeros)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(6, 512) * (rng.rand(6, 512) < 0.5)).astype(np.float32)
    w = (rng.randn(512, 256) / np.sqrt(512)).astype(np.float32)
    ji, jn = jnp.asarray(idx, jnp.int32), jnp.asarray(nvalid, jnp.int32)
    ti = torch.tensor(idx, dtype=torch.int32)
    tn = torch.tensor(nvalid, dtype=torch.int32)
    want = jsm.sparse_matmul(jnp.asarray(x), jnp.asarray(w), ji, jn)
    got = tsm.sparse_matmul(_t(x), _t(w), ti, tn)
    assert got.dtype == torch.float32
    _close(got, want)
    if nvalid == 0:
        assert (got == 0).all()


# ---------------------------------------------------------------------------
# select_tiles_static + sparse_ffn_apply


@pytest.mark.parametrize("density", [0.25, 0.5, 1.0])
def test_select_tiles_static_matches_reference_exactly(density):
    """Equal scores keep ascending tile order, as lax.top_k does: the
    zero-score tail ties whenever the capacity exceeds the active tiles."""
    sc = np.zeros(16, np.float32)
    sc[[3, 7, 11, 12]] = [1.5, 0.5, 1.5, 2.0]
    j_idx, j_nv = jops.select_tiles_static(jnp.asarray(sc), density)
    t_idx, t_nv = tops.select_tiles_static(_t(sc), density)
    assert t_idx.dtype == torch.int32 and t_nv.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert int(t_nv) == int(j_nv)


@pytest.mark.parametrize("density,shift", [(0.25, 0.0), (0.5, 0.1),
                                           (1.0, 0.0), (1.0, 0.6)])
def test_sparse_ffn_apply_matches_reference(density, shift):
    """y, h, idx and nvalid equal the reference's Pallas composition and
    its XLA gather path; at density 1.0 with a large shift many tiles score
    zero and tie. idx and nvalid match exactly."""
    rng = np.random.RandomState(int(density * 10) + int(shift * 10))
    T, d, F, D = 6, 64, 1024, 256
    x = rng.randn(T, d).astype(np.float32)
    wu = (rng.randn(d, F) / 8.0).astype(np.float32)
    wd = (rng.randn(F, D) / 32.0).astype(np.float32)
    if shift > 0.5:
        wu[:, :512] *= 0.01  # the first half of the tiles never fires
    ty, th, ti, tn = tops.sparse_ffn_apply(_t(x), _t(wu), _t(wd),
                                           density=density, shift=shift,
                                           device="cpu")
    for ref in (jops.sparse_ffn_apply, jops.sparse_ffn_apply_xla):
        jy, jh, ji, jn = ref(jnp.asarray(x), jnp.asarray(wu), jnp.asarray(wd),
                             density=density, shift=shift)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert int(tn) == int(jn)
        _close(th, jh)
        _close(ty, jy)
    if shift > 0.5:
        assert int(tn) < F // 128  # tied zero scores were selected as pads


def test_flops_saved_matches_reference():
    assert tops.flops_saved(16384, 4096, 8, 0.25) == \
        jops.flops_saved(16384, 4096, 8, 0.25)


def test_sparse_ffn_apply_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, wu, wd = torch.zeros(2, 64), torch.zeros(64, 256), torch.zeros(256, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.sparse_ffn_apply(x, wu, wd)
    y, *_ = tops.sparse_ffn_apply(x, wu, wd, device="cpu")
    assert y.shape == (2, 64)


def test_new_wrappers_refuse_non_cpu_non_cuda_tensors():
    """On a non-CPU tensor a wrapper launches its kernel or raises."""
    meta = torch.zeros(2, 256, device="meta")
    idx = torch.zeros(2, 2, dtype=torch.int32)
    nv = torch.zeros(2, dtype=torch.int32)
    for call in (lambda: tsm.sparse_up_matmul(meta[:, :64], torch.zeros(64, 256),
                                              idx, nv),
                 lambda: tff.fused_up_relu(meta[:, :64], torch.zeros(64, 256)),
                 lambda: tsm.sparse_matmul(meta, torch.zeros(256, 64), idx[0],
                                           nv[0])):
        with pytest.raises(ValueError, match="CUDA device or all on the CPU"):
            call()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the CUDA kernels have no "
                    "CPU mode; their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    """On the card: each new kernel against its plain version at small f32
    shapes, one launch each."""
    rng = np.random.RandomState(6)
    c = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(cuda_device)  # noqa: E731
    x, w = c(rng.randn(5, 64)), c(rng.randn(64, 512) / 8.0)
    idx, nv = tpred.pack_tile_indices(c(rng.rand(5, 4) < 0.5).bool(), 4)
    n0 = tsm.sparse_up_matmul.launches
    torch.testing.assert_close(tsm.sparse_up_matmul(x, w, idx, nv),
                               tsm.sparse_up_matmul_plain(x, w, idx, nv), **TOL)
    assert tsm.sparse_up_matmul.launches == n0 + 1
    for a, b in zip(tff.fused_up_relu(x, w, 0.1),
                    tff.fused_up_relu_plain(x, w, 0.1)):
        torch.testing.assert_close(a, b, **TOL)
    h, wd = c(rng.randn(5, 512)), c(rng.randn(512, 64) / 16.0)
    li = torch.tensor([3, 0, 2], dtype=torch.int32, device=cuda_device)
    ln = torch.tensor(2, dtype=torch.int32, device=cuda_device)
    torch.testing.assert_close(tsm.sparse_matmul(h, wd, li, ln),
                               tsm.sparse_matmul_plain(h, wd, li, ln), **TOL)
