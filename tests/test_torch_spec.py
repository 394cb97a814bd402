"""The port's speculative serving against the JAX reference on the CPU, at
f32.

* ``draft_gamma_paged``: proposals equal and the draft pool's writes
  within 1e-5 of the reference's, greedy and with a sampling ``next_fn``,
  on the plain path and on the kernel path (each wrapper's plain version).
* Engine streams in speculative mode against the JAX engine, with the
  1-layer random draft ``launch/serve_api.py`` builds: tiny-relu and
  tiny-opt targets, greedy and mixed sampled traffic, whole-prompt and
  chunked prefill, a shared-prefix workload on the prefix cache, and a
  tiny-moe target with a tiny-relu draft. Tokens exactly, logprobs within
  1e-5 (valid window rows only are ever read); draft_proposed,
  draft_accepted, target_calls, weight_io_saved(), s_agg_window(),
  weight_io_bytes_per_step() and ``spec_metrics`` equal the reference's.
* Self-consistency of the port: its spec stream equals its
  autoregressive stream, and the target used as its own draft accepts
  every proposal. (Logprobs are compared with a tolerance: the
  reference's own spec and AR logprobs differ by one ulp.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import spec_theory as jtheory
from repro.models import common as jcm
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import sampling as jsmp
from repro.serving import spec_metrics as jspec_metrics
from repro.serving.config import EngineConfig as JConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import spec_theory as ttheory
from repro_torch.models import transformer as TT
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving import sampling as tsmp
from repro_torch.serving import spec_metrics

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

BS = 8
GEOM = dict(n_slots=2, block_size=BS, max_blocks_per_seq=4, base_seed=3)
GAMMA = 2
_SETUP = {}


def _setup(name, draft=False):
    """(jax cfg, port cfg, jax params, port params) at f32; ``draft`` is
    the 1-layer random draft of launch/serve_api.py (PRNGKey(2))."""
    key = (name, draft)
    if key not in _SETUP:
        jcfg = jget_config(name).replace(compute_dtype="float32")
        tcfg = get_config(name).replace(compute_dtype="float32")
        seed = 0
        if draft:
            jcfg = jcfg.replace(name=f"{jcfg.name}-draft", n_layers=1)
            tcfg = tcfg.replace(name=f"{tcfg.name}-draft", n_layers=1)
            seed = 2
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _SETUP[key] = (jcfg, tcfg, jp, tp)
    return _SETUP[key]


# ---------------------------------------------------------------------------
# the draft loop


def _draft_state(jcfg, seed=0, n_blocks=14, b=3, nb=4):
    rng = np.random.RandomState(seed)
    g = jcm.HeadGeometry(jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    shape = (jcfg.n_layers, n_blocks, g.kvp, BS, g.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    table = rng.permutation(np.arange(1, n_blocks))[: b * nb].reshape(b, nb)
    return k, v, table.astype(np.int32)


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_draft_gamma_paged_matches_reference(name, fast, sampled):
    """Three slots: a full window, a shrunken one (wlen 2: later draft
    writes go to the scratch block) and an idle one (wlen 0)."""
    jcfg, tcfg, jp, tp = _setup(name)
    k, v, table = _draft_state(jcfg)
    token = np.array([5, 17, 0], np.int32)
    pos0 = np.array([9, 20, 0], np.int32)
    wlen = np.array([GAMMA + 2, 2, 0], np.int32)
    gamma = GAMMA + 1
    vocab = jcfg.vocab_size
    temps = np.array([0.9, 0.0, 1.1], np.float32)
    tks = np.array([20, 0, 0], np.int32)
    tps = np.array([1.0, 1.0, 0.8], np.float32)
    keys = np.stack([jsmp.request_prng_key([i + 1], jsmp.SamplingParams(
        temperature=1.0, seed=i)) for i in range(3)])
    gen0 = np.array([1, 4, 0], np.int32)

    def jnext(logits, g):
        return jsmp.sample_head(logits, vocab, jnp.asarray(temps),
                                jnp.asarray(tks), jnp.asarray(tps),
                                jsmp.position_keys(jnp.asarray(keys),
                                                   jnp.asarray(gen0) + g))[0]

    def tnext(logits, g):
        gen = torch.as_tensor(gen0, dtype=torch.int64) + g
        return tsmp.sample_head(logits, vocab, torch.as_tensor(temps),
                                torch.as_tensor(tks), torch.as_tensor(tps),
                                tsmp.position_keys(torch.as_tensor(
                                    keys.astype(np.int64)), gen))[0]

    want, wpages = JT.draft_gamma_paged(
        jp, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(table),
        jnp.asarray(token), jnp.asarray(pos0), jnp.asarray(wlen), jcfg,
        gamma=gamma, block_size=BS, next_fn=jnext if sampled else None)
    got, gpages = TT.draft_gamma_paged(
        tp, {"k": torch.as_tensor(k), "v": torch.as_tensor(v)},
        torch.as_tensor(table), torch.as_tensor(token),
        torch.as_tensor(pos0), torch.as_tensor(wlen), tcfg, gamma=gamma,
        block_size=BS, next_fn=tnext if sampled else None, fast_kernels=fast)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, gamma)
    # proposal g comes from a valid row only while g < wlen (the kernel
    # path zeroes the FFN of rows past it); later ones are never read
    for i, n in enumerate(np.minimum(wlen, gamma)):
        assert got[i, :n].tolist() == np.asarray(want)[i, :n].tolist()
    for part in ("k", "v"):
        np.testing.assert_allclose(gpages[part][:, 1:].numpy(),
                                   np.asarray(wpages[part])[:, 1:],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# engine streams


def _workload(vocab, smp, traffic, prefix=False):
    """Four requests: greedy only, or seeded sampled (top-k; top-p),
    unseeded sampled and greedy sharing the batch. ``prefix`` gives every
    prompt the same two-block system prompt."""
    rng = np.random.RandomState(0)
    system = rng.randint(0, vocab, 2 * BS).tolist() if prefix else []
    ps = [system + rng.randint(0, vocab, 3 + 2 * i).tolist()
          for i in range(4)]
    sps = [smp.SamplingParams(temperature=0.9, top_k=40, seed=11),
           smp.SamplingParams(temperature=1.2, top_p=0.9, seed=12),
           smp.SamplingParams(temperature=0.8), None]
    if traffic == "greedy":
        sps = [None, smp.SamplingParams(stop=((7,),)), None, None]
    return [(p, m, s) for p, m, s in zip(ps, (6, 7, 6, 5), sps)]


def _serve(eng, work):
    uids = [eng.submit(p, m, sampling=s) for p, m, s in work]
    res = eng.run()
    return [res[u] for u in uids]


def _spec_kw(target, draft, chunk, prefix):
    """(JAX config kwargs, port config kwargs) of a speculative engine."""
    jd, td, jdp, tdp = draft
    kw = dict(gamma=GAMMA, **GEOM)
    if chunk:
        kw.update(prefill_chunk=chunk, prefix_cache=prefix)
    return (dict(kw, draft_cfg=jd, draft_params=jdp),
            dict(kw, draft_cfg=td, draft_params=tdp))


def _assert_same(got, want, eng, jeng):
    for g, w in zip(got, want):
        assert g.tokens.tolist() == np.asarray(w.tokens).tolist()
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0, atol=1e-5)
        assert (g.draft_proposed, g.draft_accepted, g.target_calls,
                g.finish_reason) == (w.draft_proposed, w.draft_accepted,
                                     w.target_calls, w.finish_reason)
        gm = spec_metrics(g, gamma=GAMMA, c=0.1, s_agg=eng.s_agg_window())
        wm = jspec_metrics(w, gamma=GAMMA, c=0.1, s_agg=jeng.s_agg_window())
        for f in dataclasses.fields(wm):
            if f.name != "tokens":
                assert getattr(gm, f.name) == pytest.approx(
                    getattr(wm, f.name), abs=1e-6), f.name
    assert eng.s_agg_window() == pytest.approx(jeng.s_agg_window(), abs=1e-6)
    assert eng.weight_io_saved() == pytest.approx(jeng.weight_io_saved(),
                                                  abs=1e-6)
    assert eng.weight_io_bytes_per_step() == pytest.approx(
        jeng.weight_io_bytes_per_step(), rel=1e-6)


SPEC_CASES = [(n, c, t) for n in ("tiny-relu", "tiny-opt") for c in (0, 4)
              for t in ("greedy", "sampled")]


@pytest.mark.parametrize("name,chunk,traffic", SPEC_CASES)
def test_spec_streams_equal_reference(name, chunk, traffic):
    jcfg, tcfg, jp, tp = _setup(name)
    jkw, tkw = _spec_kw(name, _setup(name, draft=True), chunk, False)
    jeng = JEngine(jcfg, jp, config=JConfig(**jkw))
    want = _serve(jeng, _workload(jcfg.vocab_size, jsmp, traffic))
    assert all(w.draft_proposed > 0 for w in want)
    for fast in (None, True):
        eng = ContinuousBatchingEngine(
            tcfg, tp, EngineConfig(fast_kernels=fast, **tkw), device="cpu")
        got = _serve(eng, _workload(tcfg.vocab_size, tsmp, traffic))
        _assert_same(got, want, eng, jeng)
        assert 0.0 < eng.s_agg_window() < 1.0


@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_spec_prefix_cache_streams_equal_reference(name):
    """Every prompt opens with the same two-block system prompt: the spec
    engine maps the cached prefix in both pools' tables and prefills only
    the cold suffix, in the target's pool and the draft's."""
    jcfg, tcfg, jp, tp = _setup(name)
    jkw, tkw = _spec_kw(name, _setup(name, draft=True), 4, True)
    jkw["max_blocks_per_seq"] = tkw["max_blocks_per_seq"] = 5
    jeng = JEngine(jcfg, jp, config=JConfig(**jkw))
    want = _serve(jeng, _workload(jcfg.vocab_size, jsmp, "sampled", True))
    eng = ContinuousBatchingEngine(tcfg, tp, EngineConfig(**tkw),
                                   device="cpu")
    got = _serve(eng, _workload(tcfg.vocab_size, tsmp, "sampled", True))
    _assert_same(got, want, eng, jeng)
    assert eng.prefix_hit_rate() == pytest.approx(jeng.prefix_hit_rate())
    assert eng.prefix_hit_rate() > 0


@pytest.mark.parametrize("chunk", [0, 4])
def test_moe_target_spec_streams_equal_reference(chunk):
    """A tiny-moe target verifying a dense tiny-relu draft's windows (both
    vocab 256)."""
    jcfg, tcfg, jp, tp = _setup("tiny-moe")
    jd, td, jdp, tdp = _setup("tiny-relu")
    jkw, tkw = _spec_kw("tiny-moe", (jd, td, jdp, tdp), chunk, False)
    jeng = JEngine(jcfg, jp, config=JConfig(**jkw))
    want = _serve(jeng, _workload(jcfg.vocab_size, jsmp, "sampled"))
    eng = ContinuousBatchingEngine(tcfg, tp, EngineConfig(**tkw),
                                   device="cpu")
    got = _serve(eng, _workload(tcfg.vocab_size, tsmp, "sampled"))
    _assert_same(got, want, eng, jeng)


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_spec_stream_equals_autoregressive(name, chunk):
    """Key-coupled acceptance: with a junk draft the spec engine emits the
    target's scheduled sample at every position, so its streams are the
    autoregressive engine's; with the target as its own draft every
    proposal is accepted."""
    _, tcfg, _, tp = _setup(name)
    _, td, _, tdp = _setup(name, draft=True)
    kw = dict(GEOM, prefill_chunk=chunk)
    work = _workload(tcfg.vocab_size, tsmp, "sampled")
    ar = _serve(ContinuousBatchingEngine(tcfg, tp, EngineConfig(**kw),
                                         device="cpu"), work)
    for dcfg, dparams, perfect in ((td, tdp, False), (tcfg, tp, True)):
        eng = ContinuousBatchingEngine(
            tcfg, tp, EngineConfig(draft_cfg=dcfg, draft_params=dparams,
                                   gamma=GAMMA, **kw), device="cpu")
        got = _serve(eng, work)
        for g, a in zip(got, ar):
            assert g.tokens.tolist() == a.tokens.tolist()
            np.testing.assert_allclose(g.logprobs, a.logprobs, rtol=0,
                                       atol=1e-5)
            assert g.draft_proposed > 0
            if perfect:
                assert g.accept_rate == 1.0


def test_spec_engine_checks():
    """Construction rules of speculative mode, as the reference's."""
    _, tcfg, _, tp = _setup("tiny-opt")
    _, td, _, tdp = _setup("tiny-opt", draft=True)
    with pytest.raises(ValueError, match="share a vocabulary"):
        ContinuousBatchingEngine(tcfg, tp, EngineConfig(
            draft_cfg=td.replace(vocab_size=128), draft_params=tdp),
            device="cpu")
    mcfg = _setup("tiny-moe")[1]
    with pytest.raises(ValueError, match="'spec_draft' serving capability"):
        ContinuousBatchingEngine(tcfg, tp, EngineConfig(
            draft_cfg=mcfg, draft_params=_setup("tiny-moe")[3]),
            device="cpu")
    with pytest.raises(ValueError, match="speculative mode needs gamma"):
        ContinuousBatchingEngine(tcfg, tp, EngineConfig(
            draft_cfg=td, draft_params=tdp, gamma=0), device="cpu")
    plain = ContinuousBatchingEngine(tcfg, tp, EngineConfig(), device="cpu")
    assert plain.s_agg_window() is None


@pytest.mark.parametrize("gamma,c,s_agg,alpha", [
    (4, 0.1, 0.3, 0.6), (1, 0.05, 0.0, 0.0), (8, 0.2, 0.7, 1.0)])
def test_spec_theory_matches_reference(gamma, c, s_agg, alpha):
    for fn in ("thm1_speedup", "standard_spec_speedup"):
        args = (gamma, c, s_agg) if fn == "thm1_speedup" else (gamma, c, alpha)
        assert getattr(ttheory, fn)(*args) == getattr(jtheory, fn)(*args)
    assert ttheory.thm2_speedup(gamma, c, s_agg, alpha) == \
        jtheory.thm2_speedup(gamma, c, s_agg, alpha)
    curve = lambda g: s_agg / g  # noqa: E731
    assert ttheory.optimal_gamma(c, min(alpha, 0.9), curve) == \
        jtheory.optimal_gamma(c, min(alpha, 0.9), curve)
