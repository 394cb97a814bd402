"""The port's legacy single-batch path (contiguous head-major cache,
``ServeEngine``) against the JAX reference on the CPU, at f32, on
converted weights.

* The families' ``init_cache`` / ``model_prefill`` / ``model_decode``:
  caches within 1e-5, logits within 1e-4, over several decode steps.
* ``ServeEngine.generate`` on tiny-relu and tiny-moe with reuse_window 0
  and 3, ``track_sparsity`` and static tile capacities: tokens equal,
  logprobs within 1e-5, site sparsity within 1e-6 (the same sites),
  tracker curves equal. ``score`` within 1e-5.
* The port's legacy streams equal its continuous engine's (greedy, f32),
  as the reference's tests hold for the reference.
* A generation past max_len raises (the reference clamps the write).
* The CLI's legacy path (no ``--continuous``), with and without
  ``--sparse-density``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import relufication as jrelu
from repro.models import registry as jreg
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import registry as treg
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                 GenerationResult, ServeEngine)
from torch_twin import port_cfg

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

MAX_LEN = 32
_SETUP = {}


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _setup(name, static=False):
    """(jax cfg, port cfg, jax params, port params) at f32. ``static``
    serves at tile capacities 0.5 (FFN) and 0.75 (inputs) with a tile of
    16 (the tiny d_model of 64 is under the default tile of 128)."""
    key = (name, static)
    if key not in _SETUP:
        jcfg = jget_config(name).replace(compute_dtype="float32")
        if static:
            jcfg = jrelu.enable_sparse_serving(
                jcfg.replace_sparsity(tile_size=16), 0.5, 0.75)
        tcfg = port_cfg(jcfg)
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _SETUP[key] = (jcfg, tcfg, jp, tp)
    return _SETUP[key]


def _batch(vocab, b=2, s=8, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name,static", [("tiny-relu", False),
                                         ("tiny-opt", False),
                                         ("tiny-moe", False),
                                         ("tiny-relu", True),
                                         ("tiny-moe", True)])
def test_legacy_steps_match_reference(name, static):
    jcfg, tcfg, jp, tp = _setup(name, static)
    jfam, tfam = jreg.get_family(jcfg), treg.get_family(tcfg)
    toks = _batch(jcfg.vocab_size)
    empty = tfam.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    jempty = jfam.init_cache(jcfg, 2, MAX_LEN)
    assert empty["k"].shape == jempty["k"].shape
    assert not empty["k"].any()
    jlast, jcache = jfam.model_prefill(jp, {"tokens": jnp.asarray(toks)},
                                       jcfg, MAX_LEN)
    last, cache = tfam.model_prefill(tp, {"tokens": torch.as_tensor(toks)},
                                     tcfg, MAX_LEN)
    np.testing.assert_allclose(_np(last), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache[k]), np.asarray(jcache[k]),
                                   rtol=1e-5, atol=1e-5)
    tok = np.argmax(np.asarray(jlast)[:, :jcfg.vocab_size], -1).astype(np.int32)
    for step in range(3):
        pos = np.full((2,), 8 + step, np.int32)
        jlogits, jcache = jfam.model_decode(jp, jcache, jnp.asarray(tok),
                                            jnp.asarray(pos), jcfg)
        logits, cache = tfam.model_decode(tp, cache, torch.as_tensor(tok),
                                          torch.as_tensor(pos), tcfg)
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(cache["k"]), np.asarray(jcache["k"]),
                                   rtol=1e-5, atol=1e-5)
        tok = np.argmax(np.asarray(jlogits)[:, :jcfg.vocab_size],
                        -1).astype(np.int32)


def _check_generation(got: GenerationResult, want):
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs),
                               rtol=0, atol=1e-5)
    assert got.steps == want.steps
    assert sorted(got.site_sparsity) == sorted(want.site_sparsity)
    for k, v in want.site_sparsity.items():
        assert abs(got.site_sparsity[k] - v) <= 1e-6, k
    assert (got.aggregated is None) == (want.aggregated is None)
    if want.aggregated is not None:
        np.testing.assert_array_equal(got.aggregated.used,
                                      want.aggregated.used)
        np.testing.assert_array_equal(got.aggregated.curve,
                                      want.aggregated.curve)
        np.testing.assert_array_equal(got.aggregated.per_token_sparsity,
                                      want.aggregated.per_token_sparsity)


@pytest.mark.parametrize("reuse,track,static", [
    (0, False, False), (3, False, False), (0, True, False), (3, True, False),
    (3, True, True)])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-moe"])
def test_generate_matches_reference(name, reuse, track, static):
    jcfg, tcfg, jp, tp = _setup(name, static)
    toks = _batch(jcfg.vocab_size)
    want = JServeEngine(jcfg, jp, max_len=MAX_LEN, track_sparsity=track
                        ).generate({"tokens": jnp.asarray(toks)}, max_new=10,
                                   reuse_window=reuse)
    got = ServeEngine(tcfg, tp, max_len=MAX_LEN, track_sparsity=track,
                      device="cpu").generate({"tokens": toks}, max_new=10,
                                             reuse_window=reuse)
    _check_generation(got, want)
    if track or reuse:
        assert got.site_sparsity  # stats steps ran
    if track and name == "tiny-relu":
        assert 0.0 <= got.aggregated.aggregated_sparsity() <= 1.0


@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt", "tiny-moe"])
def test_score_matches_reference(name):
    jcfg, tcfg, jp, tp = _setup(name)
    toks = _batch(jcfg.vocab_size, b=3, s=12, seed=4)
    want = JServeEngine(jcfg, jp).score({"tokens": jnp.asarray(toks)})
    got = ServeEngine(tcfg, tp, device="cpu").score({"tokens": toks})
    assert abs(got - want) <= 1e-5


@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt", "tiny-moe"])
def test_legacy_streams_equal_continuous_engine(name):
    """Each prompt alone through the legacy engine equals its stream
    through the continuous engine, with more prompts than slots."""
    _, tcfg, _, tp = _setup(name)
    prompts = [np.random.RandomState(s).randint(0, tcfg.vocab_size, n)
               for s, n in ((1, 8), (2, 12), (3, 16), (4, 10))]
    eng = ContinuousBatchingEngine(tcfg, tp, EngineConfig(
        n_slots=2, block_size=8, max_blocks_per_seq=4), device="cpu")
    uids = [eng.submit(p, 7) for p in prompts]
    res = eng.run()
    legacy = ServeEngine(tcfg, tp, max_len=64, device="cpu")
    for uid, p in zip(uids, prompts):
        leg = legacy.generate({"tokens": p[None]}, max_new=7)
        np.testing.assert_array_equal(res[uid].tokens, leg.tokens[0])
        np.testing.assert_allclose(res[uid].logprobs, leg.logprobs[0],
                                   rtol=1e-5, atol=1e-5)


def test_generate_past_max_len_raises():
    _, tcfg, _, tp = _setup("tiny-relu")
    eng = ServeEngine(tcfg, tp, max_len=16, device="cpu")
    toks = _batch(tcfg.vocab_size)
    assert eng.generate({"tokens": toks}, max_new=8).tokens.shape == (2, 8)
    with pytest.raises(ValueError, match="max_len 16"):
        eng.generate({"tokens": toks}, max_new=9)


def test_serve_engine_needs_cuda_unless_asked(monkeypatch):
    _, tcfg, _, tp = _setup("tiny-relu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(tcfg, tp)


@pytest.mark.parametrize("extra", [[], ["--sparse-density", "0.5",
                                        "--reuse-window", "3"]])
@pytest.mark.parametrize("arch", ["tiny-relu", "tiny-moe"])
def test_serve_cli_legacy_path(capsys, arch, extra):
    serve.main(["--arch", arch, "--smoke", "--tokens", "6", "--device",
                "cpu"] + extra)
    out = capsys.readouterr().out
    assert "generated (2, 6) tokens; aggregated FFN sparsity" in out, out
