"""Speculative serving on folded workloads: the port against the JAX
reference on the CPU, at f32, on converted weights (tiny-relu and
tiny-opt targets, the 1-layer random draft of launch/serve_api.py, γ = 4).

Each workload (``tests/torch_matrix.py``) runs, in one engine: greedy and
sampled requests with stop sequences that fire, a cancel mid-stream and
one in the queue, a priority-5 late arrival that preempts (with chunked
prefill, which preemption needs to resume), per-request
sparsity trackers, and γ = 4 against a pool of 7 blocks (two slots of up
to four blocks of 8 would need 9). Whole-prompt and chunked prefill.
Tokens exactly, logprobs within 1e-5, finish reasons, preemptions,
``metrics_snapshot()`` and every tracker equal the reference's; on the
port's plain path and on its kernel path (each wrapper's plain version).
Each reference run is shared through a module-scoped fixture."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import registry as jreg
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import sampling as jsmp
from repro.serving.config import EngineConfig as JConfig
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving import sampling as tsmp

import torch_matrix as tm
from torch_twin import port_cfg, port_params

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

GEOM = dict(n_slots=2, block_size=8, max_blocks_per_seq=4, n_blocks=7,
            gamma=4, track_sparsity=True, base_seed=3)
CASES = [("tiny-relu", 0), ("tiny-relu", 4), ("tiny-opt", 0), ("tiny-opt", 4)]


def _jax_engine(name, chunk):
    jcfg = jget_config(name).replace(compute_dtype="float32")
    dcfg = jcfg.replace(name=f"{jcfg.name}-draft", n_layers=1)
    fam = jreg.get_family(jcfg)
    return JEngine(jcfg, fam.init_params(jax.random.PRNGKey(0), jcfg),
                   config=JConfig(prefill_chunk=chunk, draft_cfg=dcfg,
                                  draft_params=fam.init_params(
                                      jax.random.PRNGKey(2), dcfg), **GEOM))


def _port_engine(jeng, fast):
    c = jeng.config
    tcfg, dcfg = port_cfg(jeng.cfg), port_cfg(c.draft_cfg)
    return ContinuousBatchingEngine(
        tcfg, port_params(jeng.params, tcfg), EngineConfig(
            prefill_chunk=c.prefill_chunk, draft_cfg=dcfg,
            draft_params=port_params(c.draft_params, dcfg),
            fast_kernels=fast, **GEOM), device="cpu")


@pytest.fixture(scope="module")
def reference():
    """(name, chunk) -> (reference engine, its served results, the stops);
    the stops come from the port's runs (``find_stops``)."""
    cache = {}

    def get(case):
        if case not in cache:
            jeng = _jax_engine(*case)
            vocab = jeng.cfg.vocab_size
            stops = tm.find_stops(lambda st: tm.drive(
                _port_engine(jeng, None), tsmp, vocab, st))
            uids, res = tm.drive(jeng, jsmp, vocab, stops)
            cache[case] = (jeng, tm.served(uids, res), stops)
        return cache[case]
    return get


@pytest.mark.parametrize("fast", [None, True])
@pytest.mark.parametrize("name,chunk", CASES)
def test_spec_folded_workload_equals_reference(reference, name, chunk, fast):
    jeng, want, stops = reference((name, chunk))
    reasons = [w["finish"] for w in want.values()]
    assert reasons.count("stop") == 2 and "cancelled" in reasons
    # preemption resumes through chunked prefill: whole-prompt mode
    # leaves it off (EngineConfig), and E waits for a slot instead
    assert (jeng.scheduler.preemption_count >= 1) == (chunk > 0)
    teng = _port_engine(jeng, fast)
    uids, res = tm.drive(teng, tsmp, jeng.cfg.vocab_size, stops)
    tm.compare(teng, tm.served(uids, res), jeng, want)
