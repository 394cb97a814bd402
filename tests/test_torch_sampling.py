"""The port's seeded sampling head against the JAX reference on the CPU.

Exact (integer and bit steps): seed keys (seeds at and above 2**32 and
negative ones included), ``fold_in``, ``position_keys`` / ``window_keys``,
the random bits and the uniform's bits, ``request_fingerprint`` and
``request_prng_key``. Within tolerance (float steps, which torch and XLA
round differently in the last bit): the Gumbel noise within 1e-6 x
max(1, |g|); ``filter_logits``'s support identical over a grid of top-k,
top-p and temperature (rows whose nucleus boundary mass lies within 1e-6
of top_p are counted, and the test asserts there are none on its seeds);
``sample_head`` tokens equal and logprobs within 1e-5. Then the engine's
sampled streams (seeded, unseeded under ``base_seed`` and greedy requests
in one batch) against the JAX engine at f32 in plain (whole-prompt and
chunked), predictor and MoE modes: tokens exactly, logprobs within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import registry as jreg
from repro.predictor import calibration as jcal
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import sampling as jsmp
from repro.serving.config import EngineConfig as JConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.predictor import predictors as tpred
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving import prng
from repro_torch.serving import sampling as tsmp

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

SEEDS = [0, 11, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5, 2 ** 40 + 3, -1, -2 ** 31]
VOCABS = [7, 256, 50272]


def _t(a):
    """A jax key array (or any uint32 words) as the port's int64 words."""
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _keys(n, seed=0):
    """n reference keys (n, 2) uint32 drawn from fold-ins of a numpy seed."""
    base = jax.random.PRNGKey(seed)
    data = np.random.RandomState(seed).randint(0, 2 ** 31 - 1, n)
    return jnp.stack([jax.random.fold_in(base, int(d)) for d in data])


# ---------------------------------------------------------------------------
# exact: the key schedule and the random bits


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_key_matches_reference(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    assert prng.seed_key(seed).numpy().tolist() == want.tolist()


@pytest.mark.parametrize("data", [0, 1, 12345, 2 ** 31 - 1])
def test_fold_in_matches_reference(data):
    keys = _keys(5, seed=3)
    want = np.stack([np.asarray(jax.random.fold_in(k, data)) for k in keys])
    got = prng.fold_in(_t(keys), data)
    assert got.numpy().tolist() == want.astype(np.int64).tolist()
    gen = np.arange(5, dtype=np.int32) * 977 + data % 1000
    want = np.asarray(jsmp.position_keys(keys, jnp.asarray(gen)))
    got = tsmp.position_keys(_t(keys), torch.as_tensor(gen))
    assert got.numpy().tolist() == want.astype(np.int64).tolist()


def test_window_keys_match_reference():
    keys = _keys(4, seed=5)
    gen0 = np.array([0, 3, 17, 1000], np.int32)
    want = np.asarray(jsmp.window_keys(keys, jnp.asarray(gen0), 5))
    got = tsmp.window_keys(_t(keys), torch.as_tensor(gen0), 5)
    assert got.shape == (4, 5, 2)
    assert got.numpy().tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("V", VOCABS)
def test_random_bits_and_uniform_match_reference(V):
    for key in _keys(3, seed=V):
        want = np.asarray(jax.random.bits(key, (V,), jnp.uint32))
        got = prng.random_bits32(_t(key), V).numpy()
        assert np.array_equal(got, want.astype(np.int64))
        u_want = np.asarray(jax.random.uniform(key, (V,),
                                               minval=prng.TINY_F32))
        u_got = prng.uniform(_t(key), V).numpy()
        assert np.array_equal(u_got.view(np.int32), u_want.view(np.int32))
    # batched rows: each row under its own key
    keys = _keys(3, seed=V + 1)
    want = np.stack([np.asarray(jax.random.bits(k, (V,), jnp.uint32))
                     for k in keys])
    assert np.array_equal(prng.random_bits32(_t(keys), V).numpy(),
                          want.astype(np.int64))


@pytest.mark.parametrize("tokens,sp", [
    ([1, 2, 3], jsmp.SamplingParams(temperature=0.9, top_k=40, seed=11)),
    ([5], jsmp.SamplingParams(temperature=1.2, top_p=0.9, seed=2 ** 32 + 5)),
    (list(range(40)), jsmp.SamplingParams(temperature=0.8)),
    ([7, 7, 7], jsmp.SamplingParams(temperature=0.5, top_k=3, top_p=0.5,
                                    seed=-1)),
])
def test_request_fingerprint_and_key_match_reference(tokens, sp):
    tsp = tsmp.SamplingParams(**dataclasses.asdict(sp))
    assert tsmp.request_fingerprint(tokens, tsp) == \
        jsmp.request_fingerprint(tokens, sp)
    for base_seed in (0, 7):
        want = jsmp.request_prng_key(tokens, sp, base_seed)
        got = tsmp.request_prng_key(tokens, tsp, base_seed)
        assert got.dtype == np.uint32 and got.shape == (2,)
        assert got.tolist() == want.tolist()


# ---------------------------------------------------------------------------
# within tolerance: Gumbel noise, filtering, the head


@pytest.mark.parametrize("V", VOCABS)
def test_gumbel_noise_within_tolerance(V):
    for key in _keys(3, seed=2 * V):
        want = np.asarray(jax.random.gumbel(key, (V,)))
        got = prng.gumbel_low(_t(key), V).numpy()
        assert np.isfinite(got).all()
        assert np.all(np.abs(got - want) <= 1e-6 * np.maximum(1.0,
                                                              np.abs(want)))


def _grid_rows(V, seed):
    """Rows over a grid of (top_k, top_p, temperature) with logits of a few
    scales drawn from a numpy seed."""
    grid = [(k, p, t) for k in (0, 1, 5, 50) for p in (1.0, 0.9, 0.5, 0.1)
            for t in (0.5, 1.0, 1.7)]
    rng = np.random.RandomState(seed)
    logits = (rng.randn(len(grid), V)
              * rng.choice([0.5, 2.0, 6.0], len(grid))[:, None])
    k, p, t = (np.array(c) for c in zip(*grid))
    return (logits.astype(np.float32), k.astype(np.int32),
            p.astype(np.float32), t.astype(np.float32))


@pytest.mark.parametrize("V", [256, 50272])
def test_filter_logits_support_matches_reference(V):
    logits, k, p, t = _grid_rows(V, seed=V)
    want = np.asarray(jsmp.filter_logits(jnp.asarray(logits), jnp.asarray(k),
                                         jnp.asarray(p), jnp.asarray(t)))
    # the reference's nucleus: how close the preceding mass at any sorted
    # position comes to top_p (a row within 1e-6 may flip either way)
    sv = -np.sort(-(logits / np.maximum(t, 1e-6)[:, None]), -1)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(sv), -1))
    before = np.asarray(jnp.cumsum(jnp.asarray(probs), -1)) - probs
    margin = np.where(p[:, None] < 1.0, np.abs(before - p[:, None]), np.inf)
    near = int((margin.min(-1) < 1e-6).sum())
    print(f"V={V}: nucleus boundary margin {margin.min():.3e}, "
          f"rows within 1e-6: {near}")
    assert near == 0
    got = tsmp.filter_logits(torch.as_tensor(logits), torch.as_tensor(k),
                             torch.as_tensor(p), torch.as_tensor(t)).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    kept = np.isfinite(want)
    np.testing.assert_array_equal(got[kept], want[kept])
    # top_k = 1 keeps the argmax alone (no ties in random logits)
    assert (np.isfinite(got[k == 1]).sum(-1) == 1).all()


@pytest.mark.parametrize("shape", [(12,), (4, 3)])
def test_sample_head_matches_reference(shape):
    """Mixed greedy and sampled rows, batch shape (B,) or (B, W), over a
    padded vocabulary (the head reads only the first ``vocab`` logits)."""
    vocab, vocab_p = 256, 264
    n = int(np.prod(shape))
    rng = np.random.RandomState(n)
    logits = (rng.randn(*shape, vocab_p) * 3).astype(np.float32)
    temps = np.where(np.arange(n) % 3 == 0, 0.0,
                     rng.choice([0.7, 1.0, 1.3], n)).astype(np.float32)
    tks = rng.choice([0, 5, 40], n).astype(np.int32)
    tps = rng.choice([1.0, 0.9, 0.6], n).astype(np.float32)
    keys = np.asarray(_keys(n, seed=n)).reshape(*shape, 2)
    args = [a.reshape(shape) for a in (temps, tks, tps)]
    want_t, want_lp = jsmp.sample_head(jnp.asarray(logits), vocab,
                                       *map(jnp.asarray, args),
                                       jnp.asarray(keys))
    got_t, got_lp = tsmp.sample_head(torch.as_tensor(logits), vocab,
                                     *map(torch.as_tensor, args), _t(keys))
    assert got_t.dtype == torch.int32 and tuple(got_t.shape) == shape
    assert got_t.numpy().tolist() == np.asarray(want_t).tolist()
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0,
                               atol=1e-5)
    # all-greedy rows: the head's outputs are greedy_head's, which the
    # engine calls alone for an all-greedy step
    g = [np.zeros(shape, np.float32), *args[1:]]
    a = tsmp.sample_head(torch.as_tensor(logits), vocab,
                         *map(torch.as_tensor, g), _t(keys))
    b = tsmp.greedy_head(torch.as_tensor(logits), vocab)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# engine streams against the JAX engine

GEOM = dict(n_slots=2, block_size=8, max_blocks_per_seq=4, base_seed=3)
_SETUP = {}


def _setup(name):
    if name not in _SETUP:
        jcfg = jget_config(name).replace(compute_dtype="float32")
        tcfg = get_config(name).replace(compute_dtype="float32")
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _SETUP[name] = (jcfg, tcfg, jp, tp)
    return _SETUP[name]


def _workload(vocab, smp):
    """Seeded sampled (top-k; top-p), unseeded sampled (keyed by the
    engine's base_seed) and greedy requests sharing the batch."""
    rng = np.random.RandomState(0)
    ps = [rng.randint(0, vocab, 3 + 2 * i).tolist() for i in range(4)]
    return [(ps[0], 6, smp.SamplingParams(temperature=0.9, top_k=40, seed=11)),
            (ps[1], 7, smp.SamplingParams(temperature=1.2, top_p=0.9, seed=12)),
            (ps[2], 6, smp.SamplingParams(temperature=0.8)),
            (ps[3], 5, None)]


def _serve(eng, work):
    uids = [eng.submit(p, m, reuse_window=2, sampling=s) for p, m, s in work]
    res = eng.run()
    return [res[u] for u in uids]


def _port_predictor(pred):
    params = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in pred.params.items()}
    return tpred.Predictor(
        kind=pred.kind, params=params, n_tiles=pred.n_tiles,
        k_tiles=pred.k_tiles, tile=pred.tile,
        target_recall=pred.target_recall, probe_dtype=pred.probe_dtype,
        reports=[tpred.LayerReport(**dataclasses.asdict(r))
                 for r in pred.reports])


@pytest.mark.parametrize("name,mode", [
    ("tiny-relu", "whole"), ("tiny-opt", "whole"), ("tiny-relu", "chunked"),
    ("tiny-opt", "chunked"), ("tiny-relu", "predictor"),
    ("tiny-moe", "whole"), ("tiny-moe", "chunked")])
def test_sampled_streams_equal_reference(name, mode):
    jcfg, tcfg, jp, tp = _setup(name)
    jkw, tkw = {}, {}
    if mode != "whole":
        jkw["prefill_chunk"] = tkw["prefill_chunk"] = 4
    if mode == "predictor":
        toks = np.random.RandomState(2).randint(0, jcfg.vocab_size, (4, 24))
        jpr = jcal.calibrate(jp, jcfg, {"tokens": jnp.asarray(toks)},
                             kind="sign", tile=1, probe_dtype="float32",
                             target_recall=1.0)
        jkw["predictor"], tkw["predictor"] = jpr, _port_predictor(jpr)
    want = _serve(JEngine(jcfg, jp, config=JConfig(**GEOM, **jkw)),
                  _workload(jcfg.vocab_size, jsmp))
    fasts = (None,) if name == "tiny-moe" else (None, True)
    for fast in fasts:
        got = _serve(ContinuousBatchingEngine(
            tcfg, tp, EngineConfig(fast_kernels=fast, **GEOM, **tkw),
            device="cpu"), _workload(tcfg.vocab_size, tsmp))
        for g, w in zip(got, want):
            assert g.tokens.tolist() == np.asarray(w.tokens).tolist()
            np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0,
                                       atol=1e-5)
            assert g.finish_reason == w.finish_reason
    # sampled requests really left the greedy stream
    greedy = _serve(ContinuousBatchingEngine(
        tcfg, tp, EngineConfig(**GEOM, **tkw), device="cpu"),
        [(p, m, None) for p, m, _ in _workload(tcfg.vocab_size, tsmp)])
    assert any(g.tokens.tolist() != s.tokens.tolist()
               for g, s in zip(greedy[:3], got[:3]))
