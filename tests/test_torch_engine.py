"""The PyTorch port's ContinuousBatchingEngine against the JAX reference's
on the CPU, at f32: greedy token streams identical token for token,
logprobs within 1e-5, for tiny-relu (GLU) and tiny-opt (MLP), whole-prompt
and chunked prefill, with and without γ-window reuse.

The reference on the CPU runs its frozen XLA path, which
tests/test_fused_decode.py pins token-identical to its kernel path at f32.
Each reference engine runs once per module (requests with reuse_window 0
and 4 share one run)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import registry as jreg
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving.config import EngineConfig as JConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import Mesh
from repro_torch.obs import EngineObs
from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                 SamplingParams)

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

PROMPTS = [(1, 9), (2, 5), (3, 13), (4, 21), (5, 3)]  # (seed, length)
REUSE = [0, 4, 0, 4, 4]
MAX_NEW = 10
GEOM = dict(n_slots=3, block_size=8, max_blocks_per_seq=6)


def _prompts(vocab):
    return [np.random.RandomState(s).randint(0, vocab, n).astype(np.int32)
            for s, n in PROMPTS]


_PARAMS = {}


def _params(name):
    if name not in _PARAMS:
        jcfg = jget_config(name).replace(compute_dtype="float32")
        tcfg = get_config(name).replace(compute_dtype="float32")
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _PARAMS[name] = (jcfg, tcfg, jp, tp)
    return _PARAMS[name]


def _collect(eng, uids):
    res = eng.run()
    return ([res[u].tokens.tolist() for u in uids],
            [np.asarray(res[u].logprobs) for u in uids])


@pytest.fixture(scope="module")
def reference():
    """(name, prefill_chunk) -> (streams, logprobs, weight_io_saved) of the
    JAX engine, computed on first use."""
    cache = {}

    def get(name, chunk):
        if (name, chunk) not in cache:
            jcfg, _, jp, _ = _params(name)
            eng = JEngine(jcfg, jp, config=JConfig(prefill_chunk=chunk, **GEOM))
            uids = [eng.submit(p, MAX_NEW, reuse_window=r)
                    for p, r in zip(_prompts(jcfg.vocab_size), REUSE)]
            toks, lps = _collect(eng, uids)
            cache[name, chunk] = (toks, lps, eng.weight_io_saved())
        return cache[name, chunk]
    return get


def _port(name, chunk, fast=None, **kw):
    _, tcfg, _, tp = _params(name)
    eng = ContinuousBatchingEngine(
        tcfg, tp, EngineConfig(prefill_chunk=chunk, fast_kernels=fast, **GEOM,
                               **kw), device="cpu")
    uids = [eng.submit(p, MAX_NEW, reuse_window=r)
            for p, r in zip(_prompts(tcfg.vocab_size), REUSE)]
    return _collect(eng, uids) + (eng,)


@pytest.mark.parametrize("reuse", [0, 4])
@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_greedy_streams_equal_reference(reference, name, chunk, reuse):
    want, want_lp, _ = reference(name, chunk)
    got, got_lp, eng = _port(name, chunk)
    assert not eng.fast_kernels  # the CPU default: the plain path
    sel = [i for i, r in enumerate(REUSE) if r == reuse]
    assert [got[i] for i in sel] == [want[i] for i in sel]
    for i in sel:
        np.testing.assert_allclose(got_lp[i], want_lp[i], rtol=0, atol=1e-5)


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_kernel_path_streams_equal_reference(reference, name, chunk):
    """fast_kernels=True on the CPU: the kernel path's structure (tile
    lists, fused FFN, in-kernel paged gather) with each wrapper's plain
    version — the same streams and the same weight-I/O accounting."""
    want, want_lp, want_saved = reference(name, chunk)
    got, got_lp, eng = _port(name, chunk, fast=True)
    assert got == want
    np.testing.assert_allclose(np.concatenate(got_lp),
                               np.concatenate(want_lp), rtol=0, atol=1e-5)
    assert eng.weight_io_saved() == pytest.approx(want_saved, abs=1e-9)
    assert eng.weight_io_saved() > 0  # γ = 4 requests skipped reads


def test_prefix_cache_hits_and_keeps_streams():
    """Requests sharing a two-block system prompt: the cached prefix is
    mapped, not recomputed, and every stream equals the cold run."""
    _, tcfg, _, tp = _params("tiny-opt")
    rng = np.random.RandomState(7)
    system = rng.randint(0, tcfg.vocab_size, 16)
    prompts = [np.concatenate([system, rng.randint(0, tcfg.vocab_size, n)])
               for n in (3, 6, 1, 5)]

    def serve(prefix_cache):
        eng = ContinuousBatchingEngine(
            tcfg, tp, EngineConfig(n_slots=2, block_size=8,
                                   max_blocks_per_seq=6, prefill_chunk=4,
                                   prefix_cache=prefix_cache), device="cpu")
        uids = [eng.submit(p, 6) for p in prompts]
        return _collect(eng, uids)[0], eng

    cold, _ = serve(False)
    warm, eng = serve(True)
    assert warm == cold
    assert eng.prefix_hit_rate() > 0


def _preempting_run(eng, prompts, scenario):
    """Drive either engine (the same API) through one preempt/resume cycle.
    "priority": a priority-2 request arrives while the only slot decodes a
    priority-0 one under a five-block pool, and preempts it. "forced": the
    only decoding slot is preempted by hand mid-stream. Returns (uids,
    results)."""
    low, high = prompts
    uids = [eng.submit(low, 12, reuse_window=4, priority=0, slo_ms=1e6)]
    while True:  # run until mid-decode with a few tokens out
        eng.step()
        slots = [s for s in eng.scheduler.slots if s is not None]
        if slots and not slots[0].prefilling and len(slots[0].out) >= 3:
            break
    if scenario == "priority":
        uids.append(eng.submit(high, 4, priority=2, slo_ms=1e6))
    else:
        (i,) = [i for i, s in enumerate(eng.scheduler.slots) if s is not None]
        eng.scheduler.preempt(i, eng.t)
    return uids, eng.run()


@pytest.mark.parametrize("scenario", ["priority", "forced"])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_preempt_resume_streams_equal_reference(name, scenario):
    """SLO preemption on the chunked-prefill path: the preempted request
    resumes through its parked prefix blocks and chunked prefill of the
    cold tail. Both engines take the same EngineConfig and submit schedule;
    the port's streams (plain path and kernel path) equal the reference's
    token for token, logprobs within 1e-5, with the same preemption
    counts."""
    jcfg, tcfg, jp, tp = _params(name)
    kw = dict(n_slots=1, block_size=8, max_blocks_per_seq=4, n_blocks=5,
              prefill_chunk=4, prefix_cache=True)
    rng = np.random.RandomState(15)
    prompts = [rng.randint(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (10, 8)]
    uids, want = _preempting_run(JEngine(jcfg, jp, config=JConfig(**kw)),
                                 prompts, scenario)
    assert want[uids[0]].preemptions == 1
    for fast in (None, True):
        eng = ContinuousBatchingEngine(
            tcfg, tp, EngineConfig(fast_kernels=fast, **kw), device="cpu")
        got_uids, got = _preempting_run(eng, prompts, scenario)
        assert got_uids == uids
        for u in uids:
            assert got[u].tokens.tolist() == want[u].tokens.tolist()
            np.testing.assert_allclose(got[u].logprobs, want[u].logprobs,
                                       rtol=0, atol=1e-5)
            assert got[u].preemptions == want[u].preemptions
            assert got[u].cached_prompt_tokens == want[u].cached_prompt_tokens
        assert eng.scheduler.preemption_count == 1


def test_unported_modes_raise():
    """Sampled requests and speculative mode are served; observability
    and sparsity tracking are accepted (the engine keeps the hub it was
    given, and a tracker per request); sharded serving on a data axis
    above 1 constructs (the data axis splits the slots and, where they
    divide, the pool's blocks); predictor with a draft raises the
    reference's ValueError; a family with no paged serving raises the
    capability error."""
    _, tcfg, _, tp = _params("tiny-opt")
    eng = ContinuousBatchingEngine(
        tcfg, tp, EngineConfig(draft_cfg=tcfg, draft_params=tp, gamma=2,
                               **GEOM), device="cpu")
    uids = [eng.submit([1, 2, 3], 4, sampling=SamplingParams(temperature=0.8)),
            eng.submit([1, 2, 3], 2, sampling=SamplingParams(stop=((5,),)))]
    res = eng.run()
    assert len(res[uids[0]].tokens) == 4
    assert res[uids[0]].accept_rate == 1.0  # the target drafts for itself
    assert res[uids[1]].finish_reason in ("length", "stop")
    data_mesh = Mesh(shape={"data": 2, "model": 1},
                     coords={"data": 0, "model": 0}, device=torch.device("cpu"))
    eng = ContinuousBatchingEngine(
        tcfg, tp, EngineConfig(mesh=data_mesh, n_blocks=14, **GEOM),
        device="cpu")
    assert eng.data.slots_split == (GEOM["n_slots"] % 2 == 0)
    assert eng.pages["k"].shape[1] == 7
    hub = EngineObs.disabled()
    eng = ContinuousBatchingEngine(
        tcfg, tp, EngineConfig(obs=hub, track_sparsity=True, **GEOM),
        device="cpu")
    uid = eng.submit([1, 2, 3], 3)
    eng.run()
    assert eng.obs is hub and eng.scheduler.obs is hub
    assert len(eng.trackers[uid].curve) == 2  # decode steps after the seed
    with pytest.raises(ValueError, match="mutually exclusive"):
        ContinuousBatchingEngine(tcfg, tp, EngineConfig(
            draft_cfg=tcfg, draft_params=tp, predictor=object()), device="cpu")
    mamba = get_config("tiny-opt").replace(family="mamba", ssm_state=8)
    with pytest.raises(ValueError, match="'paged_decode' serving capability"):
        ContinuousBatchingEngine(mamba, tp, EngineConfig(), device="cpu")


# ---------------------------------------------------------------------------
# warm masks, prefill budget, stop sequences and cancel against the reference

SCENARIOS = {
    "warm_masks": dict(prefill_chunk=4, warm_masks=True),
    "prefill_budget": dict(prefill_chunk=4, prefill_budget=5),
    "stop_greedy": dict(prefill_chunk=0),
    "stop_sampled": dict(prefill_chunk=4, base_seed=5),
    "cancel": dict(prefill_chunk=4),
}


def _scenario_run(eng, smp, prompts, scenario, stops=None):
    """Drive either engine (the same API) through one scenario; returns
    (the results in submit order, None for a request withdrawn from the
    queue; weight_io_saved). ``stops`` (request index -> stop sequence)
    applies to the stop scenarios."""
    stops = stops or {}
    sampled = scenario == "stop_sampled"
    uids = []
    for i, (p, r) in enumerate(zip(prompts, REUSE)):
        kw = dict(stop=(stops[i],)) if i in stops else {}
        if sampled and i % 2 == 0:
            kw.update(temperature=0.9, top_k=50, seed=i if i else None)
        sp = smp.SamplingParams(**kw) if kw else None
        uids.append(eng.submit(p, MAX_NEW, reuse_window=r, sampling=sp))
    if scenario == "cancel":
        while True:  # cancel request 1 once it has three tokens out
            eng.step()
            slots = [s for s in eng.scheduler.slots
                     if s is not None and s.request.uid == uids[1]]
            if slots and len(slots[0].out) >= 3:
                break
        assert eng.cancel(uids[1])
        assert eng.cancel(uids[4])  # still queued: withdrawn at once
    res = eng.run()
    return [res.get(u) for u in uids], eng.weight_io_saved()


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt"])
def test_engine_options_equal_reference(name, scenario):
    """Streams, finish reasons and weight_io_saved of the port equal the
    JAX engine's with warm γ-masks, a prefill budget, greedy and sampled
    stop sequences (each stop taken from the unstopped stream, so it
    fires), and a cancel mid-stream and in the queue."""
    from repro.serving import sampling as jsmp
    from repro_torch.serving import sampling as tsmp

    jcfg, tcfg, jp, tp = _params(name)
    kw = dict(GEOM, **SCENARIOS[scenario])
    prompts = _prompts(tcfg.vocab_size)
    stops = None
    if scenario.startswith("stop"):
        free, _ = _scenario_run(ContinuousBatchingEngine(
            tcfg, tp, EngineConfig(**kw), device="cpu"), tsmp, prompts,
            scenario)
        stops = {0: tuple(free[0].tokens[2:4].tolist()),
                 3: (int(free[3].tokens[5]),)}
    want, want_saved = _scenario_run(JEngine(jcfg, jp, config=JConfig(**kw)),
                                     jsmp, prompts, scenario, stops)
    for fast in (None, True):
        eng = ContinuousBatchingEngine(
            tcfg, tp, EngineConfig(fast_kernels=fast, **kw), device="cpu")
        got, saved = _scenario_run(eng, tsmp, prompts, scenario, stops)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is None:
                continue
            assert g.tokens.tolist() == np.asarray(w.tokens).tolist()
            np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0,
                                       atol=1e-5)
            assert g.finish_reason == w.finish_reason
        assert saved == pytest.approx(want_saved, abs=1e-9)
    reasons = [w.finish_reason for w in want if w is not None]
    if scenario.startswith("stop"):
        assert reasons.count("stop") == 2
    if scenario == "cancel":
        assert "cancelled" in reasons
