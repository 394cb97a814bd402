"""MoE serving at droppable capacity: the port against the JAX reference
on the CPU, at f32, on converted weights.

tiny-moe and the Mixtral-8x22B and Phi-3.5-MoE smoke configs (4 experts,
top 2, routing groups of 64 tokens) at capacity factors 1.0 and 1.25,
where an expert takes at most ceil(tokens x 2 x factor / 4) of a group's
tokens and the rest are dropped: whole-prompt and chunked prefill. Each
workload (``tests/torch_matrix.py``) runs, in one engine: γ-window
reuse, greedy and sampled requests with stop sequences that fire, a
cancel mid-stream and one in the queue, a priority-5 late arrival (it
preempts with chunked prefill) and per-request sparsity trackers. Tokens
exactly, logprobs within 1e-5, finish reasons, preemptions,
``metrics_snapshot()`` (expert I/O fraction and weight bytes included)
and every tracker equal the reference's; and the capacity drops tokens:
the port's logprobs differ from a drop-free (capacity 8.0) run of the
same workload. Each reference run is shared through a module-scoped
fixture."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
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

GEOM = dict(n_slots=2, block_size=8, max_blocks_per_seq=4,
            track_sparsity=True, base_seed=3)
ARCHS = ["tiny-moe", "mixtral-8x22b", "phi3.5-moe-42b-a6.6b"]
CASES = [(a, cf, chunk) for a in ARCHS for cf in (1.0, 1.25)
         for chunk in (0, 4)]
_PARAMS = {}


def _jax_cfg(arch, capacity):
    base = (jget_config(arch) if arch.startswith("tiny")
            else jsmoke_config(arch))
    return base.replace(compute_dtype="float32", capacity_factor=capacity)


def _jax_params(arch):
    if arch not in _PARAMS:
        jcfg = _jax_cfg(arch, 1.0)
        _PARAMS[arch] = jreg.get_family(jcfg).init_params(
            jax.random.PRNGKey(0), jcfg)
    return _PARAMS[arch]


def _port_engine(jcfg, jp, chunk, fast=None):
    tcfg = port_cfg(jcfg)
    return ContinuousBatchingEngine(
        tcfg, port_params(jp, tcfg), EngineConfig(
            prefill_chunk=chunk, fast_kernels=fast, **GEOM), device="cpu")


@pytest.fixture(scope="module")
def reference():
    """(arch, capacity, chunk) -> (reference engine, its served results,
    the stops); the stops come from the port's runs (``find_stops``)."""
    cache = {}

    def get(case):
        if case not in cache:
            arch, cf, chunk = case
            jcfg, jp = _jax_cfg(arch, cf), _jax_params(arch)
            vocab = jcfg.vocab_size
            stops = tm.find_stops(lambda st: tm.drive(
                _port_engine(jcfg, jp, chunk), tsmp, vocab, st))
            jeng = JEngine(jcfg, jp, config=JConfig(prefill_chunk=chunk,
                                                    **GEOM))
            uids, res = tm.drive(jeng, jsmp, vocab, stops)
            cache[case] = (jeng, tm.served(uids, res), stops)
        return cache[case]
    return get


@pytest.mark.parametrize("arch,capacity,chunk", CASES)
def test_moe_capacity_workload_equals_reference(reference, arch, capacity,
                                                chunk):
    jeng, want, stops = reference((arch, capacity, chunk))
    reasons = [w["finish"] for w in want.values()]
    assert reasons.count("stop") == 2 and "cancelled" in reasons
    assert (jeng.scheduler.preemption_count >= 1) == (chunk > 0)
    for fast in (None, True):
        teng = _port_engine(jeng.cfg, jeng.params, chunk, fast)
        uids, res = tm.drive(teng, tsmp, jeng.cfg.vocab_size, stops)
        got = tm.served(uids, res)
        tm.compare(teng, got, jeng, want)
    free = _port_engine(jeng.cfg.replace(capacity_factor=8.0), jeng.params,
                        chunk)
    uids, res = tm.drive(free, tsmp, jeng.cfg.vocab_size, stops)
    drop_free = tm.served(uids, res)
    assert any(not np.array_equal(g["logprobs"][:len(d["logprobs"])],
                                  d["logprobs"][:len(g["logprobs"])])
               for g, d in zip(got.values(), drop_free.values()))
