"""The port's predictor subsystem and predictor serving mode against the JAX
reference on the CPU, at f32: probes, calibration, the checkpoint format
(a predictor saved by either package loads in the other), the predicted
decode FFN in both lowerings, the predicted decode step, and the engine's
predictor-mode greedy streams with their density and recall telemetry.

The reference runs its unfused lowering (``fast_kernels=False``: Pallas
``sparse_up_matmul`` / ``sparse_matmul_tokens`` in interpret mode); the
port runs both lowerings with each wrapper's plain version. Tolerances:
1e-5 for values computed from the same inputs (the two packages sum in
different orders), tokens and integer counts exactly."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro.predictor import calibration as jcal
from repro.predictor import predictors as jpred
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving.config import EngineConfig as JConfig
from repro_torch.checkpoint.manager import CheckpointManager as TManager
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as TT
from repro_torch.predictor import calibration as tcal
from repro_torch.predictor import predictors as tpred
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from torch_twin import port_predictor

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

BS = 8
GEOM = dict(n_slots=3, block_size=BS, max_blocks_per_seq=6)
PROMPTS = [(1, 9), (2, 5), (3, 13), (4, 21), (5, 3)]  # (seed, length)
REUSE = [0, 3, 0, 3, 3]
MAX_NEW = 7

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


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _calib_tokens(vocab):
    return np.random.RandomState(2).randint(0, vocab, (4, 24)).astype(np.int32)


def _reference_predictor(name, kind):
    """A reference predictor at tile 1 (the reference tests' exact
    row-skipping): sign at recall 1.0 (f32 probe) or low-rank at 0.9."""
    key = ("pred", name, kind)
    if key not in _CACHE:
        jcfg, _, jp, _ = _setup(name)
        batch = {"tokens": jnp.asarray(_calib_tokens(jcfg.vocab_size))}
        kw = (dict(probe_dtype="float32", target_recall=1.0) if kind == "sign"
              else dict(rank=4, target_recall=0.9))
        _CACHE[key] = jcal.calibrate(jp, jcfg, batch, kind=kind, tile=1, **kw)
    return _CACHE[key]


# ---------------------------------------------------------------------------
# probes and calibration


@pytest.mark.parametrize("kind,probe_dtype", [("sign", "float32"),
                                              ("sign", "bfloat16"),
                                              ("lowrank", "float32")])
def test_probe_and_predict_units_match_reference(kind, probe_dtype):
    """The same inputs give the same probe. At a bf16 probe both round the
    product to bf16 before the f32 cast (tau binds to that rounding): the
    port's values are bf16 numbers within one bf16 step of the reference's
    (the two sum the product in different orders)."""
    rng = np.random.RandomState(7)
    x = rng.randn(6, 64).astype(np.float32)
    if kind == "sign":
        w = (rng.randn(64, 256) / 8.0).astype(np.float32)
        jl = {"w": jnp.asarray(w).astype(jnp.dtype(probe_dtype)),
              "tau": jnp.asarray(0.05, jnp.float32)}
        tl = {"w": torch.from_numpy(w).to(getattr(torch, probe_dtype)),
              "tau": torch.tensor(0.05)}
    else:
        a = rng.randn(64, 4).astype(np.float32)
        b = rng.randn(4, 256).astype(np.float32)
        jl = {"a": jnp.asarray(a), "b": jnp.asarray(b),
              "tau": jnp.asarray(0.05, jnp.float32)}
        tl = {"a": torch.from_numpy(a), "b": torch.from_numpy(b),
              "tau": torch.tensor(0.05)}
    want = np.asarray(jpred.probe(kind, jl, jnp.asarray(x)))
    got = tpred.probe(kind, tl, torch.from_numpy(x))
    assert got.dtype == torch.float32
    if probe_dtype == "bfloat16":
        assert torch.equal(got, got.bfloat16().float())  # rounded to bf16
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -7, atol=1e-6)
        return
    _close(got, want)
    np.testing.assert_array_equal(
        _np(tpred.predict_units(kind, tl, torch.from_numpy(x))),
        np.asarray(jpred.predict_units(kind, jl, jnp.asarray(x))))


@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_collect_ffn_inputs_match_reference(name):
    jcfg, tcfg, jp, tp = _setup(name)
    toks = _calib_tokens(jcfg.vocab_size)
    want = jcal.collect_ffn_inputs(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got = tcal.collect_ffn_inputs(tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    assert got.shape == want.shape == (jcfg.n_layers, 4 * 24, jcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("kind,kw", [
    ("sign", dict(probe_dtype="float32", target_recall=1.0)),
    ("sign", dict(probe_dtype="bfloat16", target_recall=0.95)),
    ("lowrank", dict(rank=4, target_recall=0.9)),
])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_calibrate_matches_reference(monkeypatch, name, kind, kw):
    """On the same captured FFN inputs (the reference's, handed to both),
    calibration fits the same taus, factors and per-layer reports. The
    probes are the two packages' products, so a tau may differ in its last
    bits (1e-5) and a probe at the edge may flip one unit of a report
    (1e-3)."""
    jcfg, tcfg, jp, tp = _setup(name)
    toks = _calib_tokens(jcfg.vocab_size)
    X = jcal.collect_ffn_inputs(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    monkeypatch.setattr(tcal, "collect_ffn_inputs", lambda *a: X)
    want = jcal.calibrate(jp, jcfg, {"tokens": jnp.asarray(toks)}, kind=kind,
                          tile=1, **kw)
    got = tcal.calibrate(tp, tcfg, {"tokens": torch.as_tensor(toks)},
                         kind=kind, tile=1, **kw)
    assert (got.kind, got.n_tiles, got.k_tiles, got.tile, got.probe_dtype) == \
        (want.kind, want.n_tiles, want.k_tiles, want.tile, want.probe_dtype)
    assert set(got.params) == set(want.params)
    for k in got.params:
        _close(got.params[k].float(), np.asarray(want.params[k], np.float32))
    for g, w in zip(got.reports, want.reports):
        assert g.layer == w.layer
        assert g.tau == pytest.approx(w.tau, rel=1e-5, abs=1e-6)
        for f in ("recall", "tile_recall", "precision", "unit_density",
                  "tile_density"):
            assert getattr(g, f) == pytest.approx(getattr(w, f), abs=1e-3)


def test_calibrate_from_config_and_sign_predictor():
    jcfg, tcfg, jp, tp = _setup("tiny-relu")
    with pytest.raises(ValueError, match="'none'"):
        tcal.calibrate_from_config(tp, tcfg, {})
    sp = tpred.sign_predictor(tp, tcfg, probe_dtype="float32", tile=1)
    ref = jpred.sign_predictor(jp, jcfg, probe_dtype="float32", tile=1)
    assert (sp.n_tiles, sp.k_tiles, sp.tile) == (ref.n_tiles, ref.k_tiles,
                                                 ref.tile)
    _close(sp.params["w"], ref.params["w"])
    _close(sp.params["tau"], ref.params["tau"])
    assert sp.params["w"] is tp["layers"]["ffn"]["wg"]  # no copy at f32
    with pytest.raises(ValueError, match="firing threshold"):
        tpred.sign_predictor(tp, get_config("tiny"))
    with pytest.raises(ValueError, match="n_groups"):
        tpred.pack_tile_indices(torch.ones(2, 8, dtype=torch.bool), 8,
                                n_groups=3)


# ---------------------------------------------------------------------------
# checkpoint format


@pytest.mark.parametrize("kind", ["sign", "lowrank"])
def test_predictor_checkpoints_load_across_packages(tmp_path, kind):
    """A predictor saved by the reference loads in the port and one saved
    by the port loads in the reference: equal arrays and extras."""
    ref = _reference_predictor("tiny-relu", kind)
    jcal.save_predictor(ref, str(tmp_path / "from_jax"))
    got = tcal.load_predictor(str(tmp_path / "from_jax"), device="cpu")
    tcal.save_predictor(got, str(tmp_path / "from_torch"))
    back = jcal.load_predictor(str(tmp_path / "from_torch"))
    for a, b in ((got, ref), (back, ref)):
        assert (a.kind, a.n_tiles, a.k_tiles, a.tile, a.target_recall,
                a.probe_dtype) == (b.kind, b.n_tiles, b.k_tiles, b.tile,
                                   b.target_recall, b.probe_dtype)
        assert [dataclasses.asdict(r) for r in a.reports] == \
            [dataclasses.asdict(r) for r in b.reports]
        assert set(a.params) == set(b.params)
        for k in a.params:
            np.testing.assert_array_equal(
                np.asarray(a.params[k].float() if isinstance(a.params[k], torch.Tensor)
                           else a.params[k], np.float32),
                np.asarray(b.params[k], np.float32))
    for sub in ("from_jax", "from_torch"):
        with open(tmp_path / sub / "step_0000000000" / "manifest.json") as f:
            assert json.load(f)["n_leaves"] == len(ref.params)


def test_checkpoint_manager_layout_and_keep_k(tmp_path):
    """Nested trees flatten in the reference's order (sorted dict keys,
    sequences in order), keep-k drops the oldest steps, and either package
    restores the other's steps."""
    rng = np.random.RandomState(0)
    tree = {"b": {"y": rng.randn(2, 3).astype(np.float32),
                  "x": np.arange(4, dtype=np.int32)},
            "a": [rng.randn(5).astype(np.float32), np.float32(2.5)]}
    jm, tm = JManager(str(tmp_path / "j"), keep=2, async_save=False), \
        TManager(str(tmp_path / "t"), keep=2)
    for step in (1, 5, 9):
        jm.save(step, tree, extras={"step": step}, block=True)
        tm.save(step, {"b": {"y": torch.from_numpy(tree["b"]["y"]),
                             "x": tree["b"]["x"]}, "a": tree["a"]},
                extras={"step": step})
    assert tm.all_steps() == jm.all_steps() == [5, 9]
    assert tm.latest_step() == 9
    for d in ("j", "t"):
        with np.load(tmp_path / d / "step_0000000009" / "arrays.npz") as z:
            flat = [z[str(i)] for i in range(4)]
        for got, want in zip(flat, [tree["a"][0], tree["a"][1], tree["b"]["x"],
                                    tree["b"]["y"]]):
            np.testing.assert_array_equal(got, want)
    got, extras = TManager(str(tmp_path / "j")).restore(tree)
    assert extras == {"step": 9}
    np.testing.assert_array_equal(got["b"]["y"], tree["b"]["y"])
    back, _ = jm.restore(tree, step=9)
    np.testing.assert_array_equal(np.asarray(back["a"][0]), tree["a"][0])
    assert sorted(os.listdir(tmp_path / "t")) == ["step_0000000005",
                                                  "step_0000000009"]


# ---------------------------------------------------------------------------
# the predicted decode FFN and step


def _ffn_inputs(jcfg, seed=0, b=3):
    rng = np.random.RandomState(seed)
    h = rng.randn(b, jcfg.d_model).astype(np.float32)
    mask = rng.rand(b, jcfg.d_ff) < 0.3
    refresh = np.array([True, False, False])
    return h, mask, refresh


@pytest.mark.parametrize("kind", ["sign", "lowrank"])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_ffn_decode_predicted_matches_reference(name, kind):
    """One layer's predicted FFN: both lowerings against the reference's
    unfused one, and against each other bit for bit."""
    jcfg, tcfg, jp, tp = _setup(name)
    ref_pred = _reference_predictor(name, kind)
    port_pred = port_predictor(ref_pred)
    layer = 1
    jl = jax.tree.map(lambda a: a[layer], ref_pred.params)
    tl = {k: v[layer] for k, v in port_pred.params.items()}
    jf = jax.tree.map(lambda a: a[layer], jp["layers"]["ffn"])
    tf = {k: v[layer] for k, v in tp["layers"]["ffn"].items()}
    h, mask, refresh = _ffn_inputs(jcfg)
    kw = dict(kind=kind, tile=1, k_tiles=jcfg.d_ff)
    want = JT._ffn_decode_predicted(jf, jnp.asarray(h), jcfg, jl,
                                    mask=jnp.asarray(mask),
                                    refresh=jnp.asarray(refresh), **kw)
    outs = []
    for fused in (False, True):
        got = TT._ffn_decode_predicted(tf, torch.from_numpy(h), tcfg, tl,
                                       mask=torch.from_numpy(mask),
                                       refresh=torch.from_numpy(refresh),
                                       fused=fused, **kw)
        _close(got[0], want[0])                                   # f
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))  # act
        _close(got[2], want[2])                                   # scores
        _close(got[3], want[3])                                   # density
        np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4]))
        np.testing.assert_array_equal(_np(got[5]), np.asarray(want[5]))
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    # the measurement probe off: zero counts, the same FFN
    off = TT._ffn_decode_predicted(tf, torch.from_numpy(h), tcfg, tl,
                                   mask=torch.from_numpy(mask),
                                   refresh=torch.from_numpy(refresh),
                                   fused=True, measure=False, **kw)
    assert torch.equal(off[0], outs[1][0])
    assert (off[4] == 0).all() and (off[5] == 0).all()


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_decode_step_paged_predicted_matches_reference(name, fast):
    """One predicted decode step: logits, pool writes, new γ-masks and
    the (act, scores, density, n_active, n_miss) telemetry."""
    jcfg, tcfg, jp, tp = _setup(name)
    ref_pred = _reference_predictor(name, "sign")
    port_pred = port_predictor(ref_pred)
    rng = np.random.RandomState(0)
    g = TT.attn_geometry(tcfg)
    shape = (jcfg.n_layers, 14, g.kvp, BS, g.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    table = rng.permutation(np.arange(1, 14))[:12].reshape(3, 4).astype(np.int32)
    masks = rng.rand(jcfg.n_layers, 3, jcfg.d_ff) < 0.5
    refresh = np.array([True, False, False])
    token, pos = np.array([5, 17, 0], np.int32), np.array([9, 30, 0], np.int32)
    kw = dict(kind="sign", tile=1, k_tiles=jcfg.d_ff, block_size=BS)
    wl, wpages, wmasks, waux = JT.decode_step_paged_predicted(
        jp, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(table),
        jnp.asarray(token), jnp.asarray(pos), jcfg, jnp.asarray(masks),
        jnp.asarray(refresh), ref_pred.params, **kw)
    gl, gpages, gmasks, gaux = TT.decode_step_paged_predicted(
        tp, {"k": torch.from_numpy(k), "v": torch.from_numpy(v)},
        torch.from_numpy(table), torch.from_numpy(token),
        torch.from_numpy(pos), tcfg, torch.from_numpy(masks),
        torch.from_numpy(refresh), port_pred.params, fast_kernels=fast, **kw)
    _close(gl, wl, 1e-4)
    _close(gpages["k"][:, 1:], np.asarray(wpages["k"])[:, 1:])
    np.testing.assert_array_equal(_np(gmasks), np.asarray(wmasks))
    np.testing.assert_array_equal(_np(gaux[0]), np.asarray(waux[0]))
    _close(gaux[2], waux[2])
    np.testing.assert_array_equal(_np(gaux[3]), np.asarray(waux[3]))
    np.testing.assert_array_equal(_np(gaux[4]), np.asarray(waux[4]))


# ---------------------------------------------------------------------------
# predictor-mode serving

CASES = [("tiny-relu", "sign", 0), ("tiny-opt", "sign", 4),
         ("tiny-relu", "lowrank", 4), ("tiny-opt", "lowrank", 0)]


def _prompts(vocab):
    return [np.random.RandomState(s).randint(0, vocab, n).astype(np.int32)
            for s, n in PROMPTS]


def _serve(eng, vocab):
    uids = [eng.submit(p, MAX_NEW, reuse_window=r)
            for p, r in zip(_prompts(vocab), REUSE)]
    res = eng.run()
    return [res[u] for u in uids]


@pytest.fixture(scope="module")
def reference_streams():
    """(name, kind, chunk) -> (results, predictor_density, predictor_recall)
    of the JAX engine in predictor mode, computed on first use."""
    cache = {}

    def get(name, kind, chunk):
        if (name, kind, chunk) not in cache:
            jcfg, _, jp, _ = _setup(name)
            eng = JEngine(jcfg, jp, config=JConfig(
                prefill_chunk=chunk, predictor=_reference_predictor(name, kind),
                **GEOM))
            res = _serve(eng, jcfg.vocab_size)
            cache[name, kind, chunk] = (res, eng.predictor_density(),
                                        eng.predictor_recall(),
                                        eng.weight_io_bytes_per_step())
        return cache[name, kind, chunk]
    return get


@pytest.mark.parametrize("name,kind,chunk", CASES)
def test_predictor_streams_equal_reference(reference_streams, name, kind,
                                           chunk):
    """Sign at recall 1.0 and low-rank below it, whole-prompt and chunked
    prefill, γ-window reuse on some requests: the port's streams (plain
    lowering and the kernel path's structure) equal the JAX engine's token
    for token, logprobs within 1e-5, with the same density and recall
    telemetry per request and per engine."""
    want, want_dens, want_recall, want_bytes = reference_streams(name, kind,
                                                                 chunk)
    _, tcfg, _, tp = _setup(name)
    pred = port_predictor(_reference_predictor(name, kind))
    for fast in (None, True):
        eng = ContinuousBatchingEngine(
            tcfg, tp, EngineConfig(prefill_chunk=chunk, predictor=pred,
                                   fast_kernels=fast, **GEOM), device="cpu")
        got = _serve(eng, tcfg.vocab_size)
        for g, w in zip(got, want):
            assert g.tokens.tolist() == np.asarray(w.tokens).tolist()
            np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0,
                                       atol=1e-5)
            assert g.pred_misses == w.pred_misses
            assert g.realized_recall == pytest.approx(w.realized_recall,
                                                      abs=1e-12)
            assert g.predicted_density == pytest.approx(w.predicted_density,
                                                        abs=1e-6)
        assert eng.predictor_density() == pytest.approx(want_dens, abs=1e-6)
        assert eng.predictor_recall() == pytest.approx(want_recall, abs=1e-12)
        assert eng.weight_io_bytes_per_step() == pytest.approx(want_bytes,
                                                               rel=1e-6)
        if kind == "sign":
            assert eng.predictor_recall() == 1.0
        else:
            assert eng.predictor_recall() < 1.0
        assert 0.0 < eng.weight_io_saved() < 1.0


def test_predictor_telemetry_off_serves_the_same_stream():
    """predictor_telemetry=False: no recall probe, zero miss counts, the
    same tokens, and predictor_recall() None (never a fake 1.0)."""
    _, tcfg, _, tp = _setup("tiny-opt")
    pred = port_predictor(_reference_predictor("tiny-opt", "sign"))
    streams = []
    for telemetry in (True, False):
        eng = ContinuousBatchingEngine(
            tcfg, tp, EngineConfig(predictor=pred,
                                   predictor_telemetry=telemetry, **GEOM),
            device="cpu")
        res = _serve(eng, tcfg.vocab_size)
        streams.append([r.tokens.tolist() for r in res])
    assert streams[0] == streams[1]
    assert eng.predictor_recall() is None
    assert eng.predictor_density() is not None
    assert all(r.pred_misses == 0 for r in res)


def test_predictor_engine_checks(monkeypatch):
    """The predictor must cover d_ff and lie on the engine's device; with
    no CUDA and no device="cpu", the engine and load_predictor raise."""
    _, tcfg, _, tp = _setup("tiny-relu")
    pred = port_predictor(_reference_predictor("tiny-relu", "sign"))
    bad = dataclasses.replace(pred, n_tiles=pred.n_tiles // 2)
    with pytest.raises(ValueError, match="does not cover d_ff"):
        ContinuousBatchingEngine(tcfg, tp, EngineConfig(predictor=bad),
                                 device="cpu")
    meta = dataclasses.replace(pred, params={k: v.to("meta")
                                             for k, v in pred.params.items()})
    with pytest.raises(ValueError, match="predictor params must lie on cpu"):
        ContinuousBatchingEngine(tcfg, tp, EngineConfig(predictor=meta),
                                 device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(tcfg, tp, EngineConfig(predictor=pred))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcal.load_predictor("unused")
