"""Predictor mode on folded workloads: the port against the JAX reference
on the CPU, at f32, on converted weights and predictors.

Sign (training-free, f32 probe) and low-rank (calibrated at recall 0.9,
rank 4) predictors at tile 1 over tiny-relu and tiny-opt. Each workload
(``tests/torch_matrix.py``) runs, in one engine with chunked prefill and
the prefix cache: prompts sharing a one-block prefix (cache hits),
greedy and sampled requests with stop sequences that fire, a cancel
mid-stream and one in the queue, a priority-5 late arrival that
preempts (the preempted request resumes through its cached prefix), and
per-request sparsity trackers. Tokens exactly, logprobs within 1e-5,
finish reasons, preemptions, cached prompt tokens, ``metrics_snapshot()``
(predictor density and recall included) and every tracker equal the
reference's, on the port's plain path and on its kernel path (each
wrapper's plain version). Each reference run is shared through a
module-scoped fixture."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import registry as jreg
from repro.predictor import calibration as jcal
from repro.predictor import sign_predictor
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import sampling as jsmp
from repro.serving.config import EngineConfig as JConfig
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving import sampling as tsmp

import torch_matrix as tm
from torch_twin import port_cfg, port_params, port_predictor

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

GEOM = dict(n_slots=2, block_size=8, max_blocks_per_seq=4, n_blocks=12,
            prefill_chunk=4, prefix_cache=True, track_sparsity=True,
            base_seed=3)
SHARED = 8  # one full block shared by every prompt
CASES = [("tiny-relu", "sign"), ("tiny-relu", "lowrank"),
         ("tiny-opt", "sign"), ("tiny-opt", "lowrank")]


def _jax_engine(name, kind):
    jcfg = jget_config(name).replace(compute_dtype="float32")
    jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    if kind == "sign":
        pred = sign_predictor(jp, jcfg, probe_dtype="float32", tile=1)
    else:
        toks = np.random.RandomState(2).randint(
            0, jcfg.vocab_size, (4, 24)).astype(np.int32)
        pred = jcal.calibrate(jp, jcfg, {"tokens": jax.numpy.asarray(toks)},
                              kind=kind, tile=1, rank=4, target_recall=0.9,
                              probe_dtype="float32")
    return JEngine(jcfg, jp, config=JConfig(predictor=pred, **GEOM))


def _port_engine(jeng, fast):
    tcfg = port_cfg(jeng.cfg)
    return ContinuousBatchingEngine(
        tcfg, port_params(jeng.params, tcfg), EngineConfig(
            predictor=port_predictor(jeng.predictor), fast_kernels=fast,
            **GEOM), device="cpu")


def _drive(eng, smp, stops=None):
    return tm.drive(eng, smp, eng.cfg.vocab_size, stops, shared=SHARED)


@pytest.fixture(scope="module")
def reference():
    """(name, kind) -> (reference engine, its served results, the stops);
    the stops come from the port's runs (``find_stops``)."""
    cache = {}

    def get(case):
        if case not in cache:
            jeng = _jax_engine(*case)
            stops = tm.find_stops(lambda st: _drive(
                _port_engine(jeng, None), tsmp, st))
            uids, res = _drive(jeng, jsmp, stops)
            cache[case] = (jeng, tm.served(uids, res), stops)
        return cache[case]
    return get


@pytest.mark.parametrize("fast", [None, True])
@pytest.mark.parametrize("name,kind", CASES)
def test_predictor_folded_workload_equals_reference(reference, name, kind,
                                                    fast):
    jeng, want, stops = reference((name, kind))
    reasons = [w["finish"] for w in want.values()]
    assert reasons.count("stop") == 2 and "cancelled" in reasons
    assert jeng.scheduler.preemption_count >= 1
    assert jeng.prefix_hit_rate() > 0
    teng = _port_engine(jeng, fast)
    uids, res = _drive(teng, tsmp, stops)
    tm.compare(teng, tm.served(uids, res), jeng, want)
    assert teng.metrics_snapshot()["predictor_density"] < 1.0
