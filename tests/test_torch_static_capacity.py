"""Static tile capacities of the PyTorch port against the JAX reference on
the CPU, at f32.

* ``tile_scores``, and ``select_active_tiles``' indices and masks exactly:
  1-D and 2-D (batch-union) scores, all-zero and tied scores, one and two
  groups. Ties go to the lower index, as ``lax.top_k`` puts them.
* ``gathered_matmul`` and ``maybe_sparse_matmul`` (one group, and
  group-balanced against the reference's ``grouped_sparse_matmul``) at
  densities 0.25, 0.5 and 1.0 (1e-5), and
  ``maybe_sparse_matmuls`` (one selection for several weights) against
  the reference's product for each weight.
* The plain ``gathered_matmul`` is the contract of its CUDA route, kernel 5
  with nvalid = mask.sum(): the port's plain ``sparse_matmul`` and the
  reference's Pallas ``sparse_matmul`` (interpret mode) give the same
  product.
* The one-device group-balanced selection's CUDA route: the list
  ``rank_tiles`` cuts from it (tiles of at most 16 or 128, valid entries
  first) through kernel 5's plain version equals the reference's
  ``grouped_sparse_matmul`` at 2 and 4 groups (1e-5).
* The continuous-batching engine at ``enable_sparse_serving(cfg, 0.5,
  0.75)`` against the JAX engine on converted weights, plain, chunked and
  speculative: tokens equal, logprobs within 1e-5. The tiny configs'
  d_model is 64, under the default tile of 128, so these runs use a tile
  of 16: at 128 the reference's own ``tile_scores`` cannot reshape a
  64-wide input."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import relufication as jrelu
from repro.kernels import sparse_matmul as jksm
from repro.models import common as jcm
from repro.models import registry as jreg
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving.config import EngineConfig as JConfig
from repro_torch.configs import get_config
from repro_torch.kernels import sparse_matmul as tksm
from repro_torch.models import common as tcm
from torch_twin import port_twin

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

DENSITIES = [0.25, 0.5, 1.0]


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _sparse_x(rng, t, F, tile, live=0.5):
    """(t, F) f32 with about half of its tiles all zero in every row (so
    masks hold zeros at any density) and half of the rest's units zero."""
    x = rng.randn(t, F).astype(np.float32) * (rng.rand(t, F) < 0.5)
    dead = rng.rand(F // tile) >= live
    x.reshape(t, F // tile, tile)[:, dead] = 0.0
    return x


# ---------------------------------------------------------------------------
# tile scores and selection


@pytest.mark.parametrize("shape,tile", [((64,), 16), ((3, 256), 16),
                                        ((2, 4, 384), 128)])
def test_tile_scores_match_reference(shape, tile):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = tcm.tile_scores(torch.as_tensor(x), tile)
    want = jcm.tile_scores(jnp.asarray(x), tile)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _scores(case):
    rng = np.random.RandomState(1)
    if case == "1d":
        return rng.rand(16).astype(np.float32) * (rng.rand(16) < 0.6)
    if case == "2d":  # a union over 3 rows
        return (rng.rand(3, 16) * (rng.rand(3, 16) < 0.3)).astype(np.float32)
    if case == "zeros":
        return np.zeros(16, np.float32)
    if case == "zeros2d":
        return np.zeros((2, 16), np.float32)
    # ties: repeated nonzero scores between runs of zeros
    return np.array([0, 2, 0, 2, 1, 0, 2, 1, 0, 0, 3, 1, 0, 2, 0, 0],
                    np.float32)


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("density", [0.1, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("case", ["1d", "2d", "zeros", "zeros2d", "ties"])
def test_select_active_tiles_exact(case, density, n_groups):
    sc = _scores(case)
    idx, mask = tcm.select_active_tiles(torch.as_tensor(sc), density,
                                        n_groups)
    jidx, jmask = jcm.select_active_tiles(jnp.asarray(sc), density, n_groups)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_array_equal(_np(mask), np.asarray(jmask))


# ---------------------------------------------------------------------------
# the tile-gathered products


def _cfgs(tile=16, n_groups=1):
    jcfg = jget_config("tiny-relu").replace(compute_dtype="float32")
    jcfg = jcfg.replace_sparsity(tile_size=tile, n_groups=n_groups)
    return jcfg, get_config("tiny-relu").replace(
        compute_dtype="float32").replace_sparsity(tile_size=tile,
                                                  n_groups=n_groups)


@pytest.mark.parametrize("density", DENSITIES)
def test_gathered_matmul_matches_reference(density):
    rng = np.random.RandomState(2)
    x = _sparse_x(rng, 5, 256, 16)
    w = rng.randn(256, 48).astype(np.float32)
    jidx, jmask = jcm.select_active_tiles(jcm.tile_scores(jnp.asarray(x), 16),
                                          density)
    idx, mask = tcm.select_active_tiles(tcm.tile_scores(torch.as_tensor(x), 16),
                                        density)
    got = tcm.gathered_matmul(torch.as_tensor(x), torch.as_tensor(w), idx,
                              mask, 16)
    want = jcm.gathered_matmul(jnp.asarray(x), jnp.asarray(w), jidx, jmask, 16)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("F,n_groups", [(256, 2), (360, 3)])
def test_grouped_sparse_matmul_matches_reference(F, n_groups, density):
    """The port's group-balanced product (``maybe_sparse_matmul`` at
    ``n_groups`` groups, its CPU einsum) against the reference's
    ``grouped_sparse_matmul``. (360, 3): a group tile of 40, no multiple
    of 16."""
    rng = np.random.RandomState(3)
    x = _sparse_x(rng, 4, F, tcm.pick_group_tile(F, n_groups))
    w = rng.randn(F, 24).astype(np.float32)
    cfg = _cfgs(16, n_groups)[1]
    got = tcm.maybe_sparse_matmul(torch.as_tensor(x), torch.as_tensor(w), cfg,
                                  density)
    want = jcm.grouped_sparse_matmul(jnp.asarray(x), jnp.asarray(w), density,
                                     n_groups)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n_groups", [1, 2])
def test_maybe_sparse_matmul_matches_reference(n_groups, density):
    jcfg, tcfg = _cfgs(16, n_groups)
    rng = np.random.RandomState(4)
    x = _sparse_x(rng, 6, 256, 16)
    w = rng.randn(256, 40).astype(np.float32)
    got = tcm.maybe_sparse_matmul(torch.as_tensor(x), torch.as_tensor(w),
                                  tcfg, density)
    want = jcm.maybe_sparse_matmul(jnp.asarray(x), jnp.asarray(w), jcfg,
                                   density)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n_groups", [1, 2])
def test_maybe_sparse_matmuls_share_one_selection(n_groups, density):
    """The products of one input made with one tile selection equal the
    reference's product for each weight, and the port's single product
    bit for bit."""
    jcfg, tcfg = _cfgs(16, n_groups)
    rng = np.random.RandomState(8)
    x = _sparse_x(rng, 6, 256, 16)
    ws = [rng.randn(256, n).astype(np.float32) for n in (40, 24, 72)]
    xt = torch.as_tensor(x)
    got = tcm.maybe_sparse_matmuls(xt, [torch.as_tensor(w) for w in ws],
                                   tcfg, density)
    assert len(got) == len(ws)
    for g, w in zip(got, ws):
        want = jcm.maybe_sparse_matmul(jnp.asarray(x), jnp.asarray(w), jcfg,
                                       density)
        np.testing.assert_allclose(_np(g), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(g, tcm.maybe_sparse_matmul(
            xt, torch.as_tensor(w), tcfg, density))


@pytest.mark.parametrize("density", DENSITIES)
def test_gathered_matmul_is_kernel5_with_nvalid_mask_sum(density):
    """The CUDA route's contract: kernel 5 over idx with nvalid =
    mask.sum() is the plain gather, held here through the port's plain
    ``sparse_matmul`` and the reference's Pallas kernel (interpret)."""
    rng = np.random.RandomState(5)
    x = _sparse_x(rng, 4, 512, 128, live=0.4)
    w = rng.randn(512, 256).astype(np.float32)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    idx, mask = tcm.select_active_tiles(tcm.tile_scores(xt, 128), density)
    nvalid = mask.sum().to(torch.int32)
    assert 0 < int(nvalid) <= idx.numel()
    got = tcm.gathered_matmul(xt, wt, idx, mask, 128)
    plain = tksm.sparse_matmul_plain(xt, wt, idx, nvalid, tile=128)
    pallas = jksm.sparse_matmul(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(_np(idx)), jnp.asarray(int(nvalid)),
                                tile=128)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("most", [16, 128])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n_groups", [2, 4])
def test_grouped_selection_through_kernel5_matches_reference(n_groups,
                                                             density, most):
    """The one-device group-balanced selection's CUDA route: the list that
    ``rank_tiles`` cuts from the selection (tiles of at most ``most``, the
    valid entries first) through kernel 5's plain version with nvalid =
    its mask's sum equals the reference's ``grouped_sparse_matmul``."""
    rng = np.random.RandomState(9)
    F = 512
    tile = tcm.pick_group_tile(F, n_groups)
    x = _sparse_x(rng, 5, F, tile, live=0.6)
    w = rng.randn(F, 48).astype(np.float32)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    idx, mask = tcm.select_active_tiles(tcm.batch_tile_scores(xt, tile),
                                        density, n_groups)
    sidx, smask, s = tcm.rank_tiles(idx, mask, tile, 0, F, most)
    assert s == np.gcd(tile, most) and s % 16 == 0
    nvalid = int(smask.sum())
    assert nvalid == int(mask.sum()) * (tile // s)
    assert bool((smask[:nvalid] > 0).all()) and not bool(smask[nvalid:].any())
    got = tksm.sparse_matmul_plain(xt, wt, sidx,
                                   torch.tensor(nvalid, dtype=torch.int32),
                                   tile=s)
    want = jcm.grouped_sparse_matmul(jnp.asarray(x), jnp.asarray(w), density,
                                     n_groups)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gathered_matmul_on_the_cpu_launches_nothing():
    """CPU tensors take the gather-and-matmul; kernel 5's wrapper (and its
    launch count) is reached only by CUDA tensors."""
    rng = np.random.RandomState(6)
    x = torch.as_tensor(_sparse_x(rng, 2, 256, 16))
    w = torch.as_tensor(rng.randn(256, 8).astype(np.float32))
    idx, mask = tcm.select_active_tiles(tcm.tile_scores(x, 16), 0.5)
    n0 = tksm.sparse_matmul.launches
    tcm.gathered_matmul(x, w, idx, mask, 16)
    assert tksm.sparse_matmul.launches == n0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the CUDA kernels have no "
                    "CPU mode; their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gathered_matmul_launches_kernel5_on_cuda(cuda_device):
    rng = np.random.RandomState(7)
    x = torch.as_tensor(_sparse_x(rng, 4, 512, 128, live=0.4))
    w = torch.as_tensor(rng.randn(512, 256).astype(np.float32))
    idx, mask = tcm.select_active_tiles(tcm.tile_scores(x, 128), 0.5)
    want = tcm.gathered_matmul(x, w, idx, mask, 128)
    n0 = tksm.sparse_matmul.launches
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        xc, wc = x.to(cuda_device, dtype), w.to(cuda_device, dtype)
        ic, mc = idx.to(cuda_device), mask.to(cuda_device, dtype)
        got = tcm.gathered_matmul(xc, wc, ic, mc, 128)
        assert got.dtype == dtype
        ref = tcm.gathered_matmul(xc.cpu(), wc.cpu(), idx, mask, 128).float()
        assert (got.float().cpu() - ref).abs().max() <= tol * ref.abs().max()
    assert tksm.sparse_matmul.launches == n0 + 2
    assert want.shape == (4, 256)


# ---------------------------------------------------------------------------
# the continuous engine at static capacities

GEOM = dict(n_slots=2, block_size=8, max_blocks_per_seq=6)
PROMPTS = [(1, 9, 0), (2, 5, 3), (3, 13, 0), (4, 17, 3)]  # seed, len, γ
_ENGINE_SETUP = {}


def _sparse_setup(draft=False):
    key = draft
    if key not in _ENGINE_SETUP:
        jcfg = jrelu.enable_sparse_serving(_cfgs(16)[0], 0.5, 0.75)
        seed = 0
        if draft:
            jcfg, seed = jcfg.replace(name="tiny-relu-draft", n_layers=1), 2
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
        _ENGINE_SETUP[key] = (jcfg, jp)
    return _ENGINE_SETUP[key]


def _serve(eng, vocab):
    uids = [eng.submit(np.random.RandomState(s).randint(0, vocab, n), 8,
                       reuse_window=g) for s, n, g in PROMPTS]
    res = eng.run()
    return [res[u] for u in uids]


@pytest.mark.parametrize("mode", ["plain", "chunked", "spec"])
def test_static_capacity_streams_equal_reference(mode):
    jcfg, jp = _sparse_setup()
    kw = dict(GEOM)
    if mode == "chunked":
        kw["prefill_chunk"] = 4
    if mode == "spec":
        dcfg, dp = _sparse_setup(draft=True)
        kw.update(draft_cfg=dcfg, draft_params=dp, gamma=2)
    jeng = JEngine(jcfg, jp, config=JConfig(**kw))
    want = _serve(jeng, jcfg.vocab_size)
    fasts = (None, True) if mode != "spec" else (None,)
    for fast in fasts:
        eng = port_twin(jeng, fast_kernels=fast)
        assert eng.cfg.sparsity.input_tile_density == 0.75
        got = _serve(eng, jcfg.vocab_size)
        for g, w in zip(got, want):
            assert g.tokens.tolist() == np.asarray(w.tokens).tolist()
            np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0,
                                       atol=1e-5)
        assert eng.weight_io_saved() == pytest.approx(jeng.weight_io_saved(),
                                                      abs=1e-9)
