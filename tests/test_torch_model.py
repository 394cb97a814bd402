"""The PyTorch port's dense model against the JAX reference at f32 on the
CPU: the same parameters (JAX init, converted through numpy), the same
inputs, the same outputs within 1e-4 (logits) / 1e-5 (caches).

jax 0.9 on the CPU rejects bf16 dots, so the reference runs at
compute_dtype="float32" throughout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import activations as jacts
from repro.models import common as jcm
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import activations as tacts
from repro_torch.models import common as tcm
from repro_torch.models import transformer as TT

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

BS = 8  # block size


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


_CACHE = {}


def _setup(name):
    """(jax cfg, port cfg, jax params, port params) at f32, shared."""
    if name not in _CACHE:
        jcfg = jget_config(name).replace(compute_dtype="float32")
        tcfg = get_config(name).replace(compute_dtype="float32")
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _CACHE[name] = (jcfg, tcfg, jp, tp)
    return _CACHE[name]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("name", ["tiny", "tiny-relu", "tiny-opt"])
def test_init_params_layout_matches_reference(name):
    jcfg, tcfg, jp, _ = _setup(name)
    tp = TT.init_params(tcfg, seed=0, device="cpu")
    assert _shapes(tp) == _shapes(jp)
    # padded head slots and padded kv heads hold zeros, as in the reference
    g = TT.attn_geometry(tcfg)
    pad = g.q_slot_mask() == 0
    assert (tp["layers"]["attn"]["wq"][:, :, pad] == 0).all()
    assert (tp["layers"]["attn"]["wo"][:, pad] == 0).all()


@pytest.mark.parametrize("name", ["tiny", "tiny-relu", "tiny-opt"])
def test_forward_logits_match_reference(name):
    jcfg, tcfg, jp, tp = _setup(name)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 19))
    want = JT.forward(jp, jnp.asarray(toks), jcfg)
    got = TT.forward(tp, torch.as_tensor(toks), tcfg)
    assert got.shape == want.shape
    _close(got, want, 1e-4)


@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_prefill_paged_matches_reference(name):
    jcfg, tcfg, jp, tp = _setup(name)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = np.random.RandomState(1).randint(0, jcfg.vocab_size, 13)
    blocks = np.array([3, 1], np.int32)
    jpages = jcm.init_paged_cache(jcfg, 6, BS)
    tpages = tcm.init_paged_cache(tcfg, 6, BS, device="cpu")
    wl, wpages = JT.prefill_paged(jp, jnp.asarray(toks), jcfg, jpages,
                                  jnp.asarray(blocks), block_size=BS,
                                  true_len=jnp.asarray(13))
    gl, gpages = TT.prefill_paged(tp, torch.as_tensor(toks), tcfg, tpages,
                                  torch.as_tensor(blocks), block_size=BS,
                                  true_len=13)
    _close(gl, wl, 1e-4)
    _close(gpages["k"], wpages["k"])
    _close(gpages["v"], wpages["v"])


def _paged_state(jcfg, seed=0, n_blocks=14, b=3, nb=4):
    """A pool with random contents, per-slot tables and γ-masks."""
    rng = np.random.RandomState(seed)
    g = jcm.HeadGeometry(jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    shape = (jcfg.n_layers, n_blocks, g.kvp, BS, g.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    table = rng.permutation(np.arange(1, n_blocks))[: b * nb].reshape(b, nb)
    table = table.astype(np.int32)
    masks = rng.rand(jcfg.n_layers, b, jcfg.d_ff) < 0.5
    refresh = np.array([True, False, False])
    return k, v, table, masks, refresh


def _run_both(jfn, tfn, jcfg, tcfg, jp, tp, args, fast, rows=slice(None)):
    """Run one paged step in both; compare the logits of ``rows`` (window
    tokens past a slot's valid length are discarded by contract), the pool
    outside the scratch block, the new masks and the FFN telemetry."""
    k, v, table, masks, refresh = _paged_state(jcfg)
    wl, wpages, wmasks, waux = jfn(
        jp, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(table),
        *map(jnp.asarray, args), jcfg, jnp.asarray(masks),
        jnp.asarray(refresh), block_size=BS, fast_kernels=False)
    gl, gpages, gmasks, gaux = tfn(
        tp, {"k": torch.as_tensor(k), "v": torch.as_tensor(v)},
        torch.as_tensor(table), *map(torch.as_tensor, args), tcfg,
        torch.as_tensor(masks), torch.as_tensor(refresh), block_size=BS,
        fast_kernels=fast)
    _close(_np(gl)[rows], _np(wl)[rows], 1e-4)
    _close(gpages["k"][:, 1:], _np(wpages["k"])[:, 1:])
    _close(gpages["v"][:, 1:], _np(wpages["v"])[:, 1:])
    np.testing.assert_array_equal(_np(gmasks), _np(wmasks))
    np.testing.assert_array_equal(_np(gaux[0]), _np(waux[0]))  # activity
    np.testing.assert_array_equal(_np(gaux[1]) > 0, _np(waux[1]) > 0)
    _close(gaux[2], waux[2])  # density


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_decode_step_paged_matches_reference(name, fast):
    """One W = 1 decode step: logits, pool writes, new γ-masks and FFN
    telemetry. ``fast`` runs the port's kernel path, whose wrappers take
    their plain versions on the CPU; the reference runs its frozen path."""
    jcfg, tcfg, jp, tp = _setup(name)
    token = np.array([5, 17, 0], np.int32)
    pos = np.array([9, 30, 0], np.int32)
    _run_both(JT.decode_step_paged, TT.decode_step_paged, jcfg, tcfg, jp, tp,
              (token, pos), fast)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_prefill_chunk_paged_matches_reference(name, fast):
    """One chunked-prefill window step: two slots resume at different
    positions, one is idle (clen 0: scratch-routed writes). The fast path
    gathers each slot's union tiles only, so rows past clen may differ —
    as in the reference, whose callers never read them."""
    jcfg, tcfg, jp, tp = _setup(name)
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, jcfg.vocab_size, (3, 4)).astype(np.int32)
    pos0 = np.array([8, 3, 0], np.int32)
    clen = np.array([4, 2, 0], np.int32)
    valid = np.arange(4)[None, :] < clen[:, None]
    _run_both(JT.prefill_chunk_paged, TT.prefill_chunk_paged, jcfg, tcfg, jp,
              tp, (tokens, pos0, clen), fast, rows=valid)


@pytest.mark.parametrize("act", ["relu", "gelu", "silu", "gelu_b1.7",
                                 "beta=3", "shifted_relu", "shifted_relu:0.3",
                                 "fatrelu:0.2"])
def test_activations_match_reference(act):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = jacts.get(act, shift=0.5)(jnp.asarray(x))
    got = tacts.get(act, shift=0.5)(torch.as_tensor(x))
    _close(got, want, 1e-6)
    assert tacts.firing_threshold(act, 0.5) == jacts.firing_threshold(act, 0.5)


def test_params_from_jax_stores_compute_dtype():
    """Weights are stored once in the compute dtype: the values the
    reference gets from ``cast_params`` at each call."""
    jcfg, _, jp, _ = _setup("tiny-opt")
    tcfg = get_config("tiny-opt")  # bfloat16 compute
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    w = tp["layers"]["ffn"]["wu"]
    assert w.dtype == torch.bfloat16
    want = jcm.cast_params(jp, jcfg.replace(compute_dtype="bfloat16"))
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(want["layers"]["ffn"]["wu"].astype(jnp.float32)))


def test_paged_helpers_match_reference():
    rng = np.random.RandomState(3)
    pages = rng.randn(2, 6, 2, BS, 4).astype(np.float32)
    table = np.array([[2, 5, 0], [1, 3, 4]], np.int32)
    pos = np.array([[9, 10], [3, 4]], np.int32)
    val = rng.randn(2, 2, 2, 4).astype(np.float32)
    enable = np.array([[True, False], [True, True]])
    want = jcm.paged_write_window(jnp.asarray(pages), 1, jnp.asarray(table),
                                  jnp.asarray(pos), jnp.asarray(val), BS,
                                  jnp.asarray(enable))
    tp = torch.as_tensor(pages.copy())
    got = tcm.paged_write_window(tp, 1, torch.as_tensor(table),
                                 torch.as_tensor(pos), torch.as_tensor(val),
                                 BS, torch.as_tensor(enable))
    assert got is tp  # in place
    _close(got, want)
    _close(tcm.paged_gather(got[1], torch.as_tensor(table)),
           jcm.paged_gather(want[1], jnp.asarray(table)))
    assert tcm.ffn_gather_tile(get_config("tiny")) == jcm.ffn_gather_tile(
        jget_config("tiny"))


def test_paged_write_duplicates_match_reference():
    """Idle slots (their table all scratch) and disabled tokens write the
    same scratch positions: each position ends with the last such write
    in (slot, token) order, as the reference's scatter leaves it, and the
    live slots' positions with their own values."""
    rng = np.random.RandomState(4)
    pages = rng.randn(2, 6, 2, BS, 4).astype(np.float32)
    table = np.array([[2, 5, 0], [0, 0, 0], [1, 3, 4], [0, 0, 0]], np.int32)
    pos = np.array([[9, 10], [0, 1], [3, 4], [1, 0]], np.int32)
    val = rng.randn(4, 2, 2, 4).astype(np.float32)
    enable = np.array([[True, False], [True, True], [False, True],
                       [True, True]])
    want = jcm.paged_write_window(jnp.asarray(pages), 0, jnp.asarray(table),
                                  jnp.asarray(pos), jnp.asarray(val), BS,
                                  jnp.asarray(enable))
    got = tcm.paged_write_window(torch.as_tensor(pages.copy()), 0,
                                 torch.as_tensor(table), torch.as_tensor(pos),
                                 torch.as_tensor(val), BS,
                                 torch.as_tensor(enable))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    serial = pages.copy()
    for b in range(4):
        for w in range(2):
            blk = table[b, pos[b, w] // BS] if enable[b, w] else 0
            serial[0, blk, :, pos[b, w] % BS] = val[b, w]
    np.testing.assert_array_equal(got.numpy(), serial)
    assert tcm.pick_group_tile(11008, 1) == jcm.pick_group_tile(11008, 1)
