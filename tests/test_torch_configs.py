"""The port's copies of the assigned dense configs (qwen3-4b, qwen2-7b,
starcoder2-15b, deepseek-67b) against the reference's, field by field,
full and smoke; and at their smoke size, on the reference's weights
converted through numpy (f32, CPU): forward logits within 1e-5, greedy
and sampled engine streams (whole-prompt and chunked prefill) equal the
JAX engine's, token for token, logprobs within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import sampling as jsmp
from repro.serving.config import EngineConfig as JConfig
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as TT
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving import sampling as tsmp

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

NAMES = ["qwen3-4b", "qwen2-7b", "starcoder2-15b", "deepseek-67b"]
GEOM = dict(n_slots=2, block_size=8, max_blocks_per_seq=4, base_seed=5)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name, smoke):
    got = (smoke_config if smoke else get_config)(name)
    want = (jsmoke_config if smoke else jget_config)(name)
    assert name in list_archs()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


_SETUP = {}


def _setup(name):
    if name not in _SETUP:
        jcfg = jsmoke_config(name).replace(compute_dtype="float32")
        tcfg = smoke_config(name).replace(compute_dtype="float32")
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _SETUP[name] = (jcfg, tcfg, jp, tp)
    return _SETUP[name]


@pytest.mark.parametrize("name", NAMES)
def test_smoke_forward_logits_match_reference(name):
    jcfg, tcfg, jp, tp = _setup(name)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 13))
    want = JT.forward(jp, jnp.asarray(toks), jcfg)
    got = TT.forward(tp, torch.as_tensor(toks), tcfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _workload(vocab, smp, sampled):
    rng = np.random.RandomState(1)
    ps = [rng.randint(0, vocab, n).tolist() for n in (5, 11, 8)]
    if not sampled:
        return [(p, 6, None) for p in ps]
    return [(ps[0], 6, smp.SamplingParams(temperature=0.9, top_k=40, seed=3)),
            (ps[1], 6, smp.SamplingParams(temperature=1.1, top_p=0.9)),
            (ps[2], 6, None)]


def _serve(eng, work):
    uids = [eng.submit(p, m, reuse_window=2, sampling=s) for p, m, s in work]
    res = eng.run()
    return [res[u] for u in uids]


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_smoke_engine_streams_equal_reference(name, sampled, chunk):
    jcfg, tcfg, jp, tp = _setup(name)
    want = _serve(JEngine(jcfg, jp, config=JConfig(prefill_chunk=chunk,
                                                   **GEOM)),
                  _workload(jcfg.vocab_size, jsmp, sampled))
    got = _serve(ContinuousBatchingEngine(
        tcfg, tp, EngineConfig(prefill_chunk=chunk, **GEOM), device="cpu"),
        _workload(tcfg.vocab_size, tsmp, sampled))
    for g, w in zip(got, want):
        assert g.tokens.tolist() == np.asarray(w.tokens).tolist()
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0, atol=1e-5)
