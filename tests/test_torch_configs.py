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


# ---------------------------------------------------------------------------
# the smoke configs relufied to stage 2 at the full configs' head ratios

# (n_heads, n_kv_heads, head_dim): Qwen3-4B's 4 q heads a kv head with
# n_heads * head_dim = 256 != d_model = 64; Qwen2-7B's 7 (padded to groups
# of 8, 7 real); StarCoder2-15B's 12 (its 48 / 4 heads: groups of 12);
# DeepSeek-67B's 8
RATIO_HEADS = {"qwen3-4b": (16, 4, 16), "qwen2-7b": (14, 2, 16),
               "starcoder2-15b": (48, 4, 16), "deepseek-67b": (16, 2, 16)}
RATIO_GEOM = dict(n_slots=3, block_size=8, max_blocks_per_seq=4, base_seed=5)
_RATIO = {}


def _ratio_setup(name):
    """(jax cfg, port cfg, jax params, port params): the smoke config
    relufied to stage 2 (ReLU FFN and ReLU after every norm) with a tile
    of 16 (8 tiles of d_ff), at the full config's head ratio, f32."""
    if name not in _RATIO:
        from repro.core import relufication as jrf
        from repro_torch.core import relufication as trf
        h, kv, hd = RATIO_HEADS[name]
        kw = dict(n_heads=h, n_kv_heads=kv, head_dim=hd,
                  compute_dtype="float32")
        jcfg = jrf.relufy_stage2(jsmoke_config(name)).replace(
            **kw).replace_sparsity(tile_size=16)
        tcfg = trf.relufy_stage2(smoke_config(name)).replace(
            **kw).replace_sparsity(tile_size=16)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(1), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _RATIO[name] = (jcfg, tcfg, jp, tp)
    return _RATIO[name]


def _ratio_workload(vocab):
    """Three requests, one at each γ of 0, 2 and 4."""
    rng = np.random.RandomState(2)
    return [(rng.randint(0, vocab, n).tolist(), 7, None, g)
            for n, g in ((13, 0), (6, 2), (10, 4))]


def _ratio_serve(eng, work):
    uids = [eng.submit(p, m, reuse_window=g, sampling=s)
            for p, m, s, g in work]
    res = eng.run()
    return [res[u] for u in uids], eng.weight_io_saved()


def test_ratio_configs_pad_heads_as_served():
    """The head layouts of the cases: kv heads and (real) group."""
    from repro_torch.models.common import HeadGeometry
    got = {n: (lambda g: (g.kvp, g.group, g.real_per_group))(HeadGeometry(
        *RATIO_HEADS[n])) for n in NAMES}
    assert got == {"qwen3-4b": (4, 4, 4), "qwen2-7b": (2, 8, 7),
                   "starcoder2-15b": (4, 12, 12), "deepseek-67b": (2, 8, 8)}


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("name", NAMES)
def test_relufied_real_ratio_streams_equal_reference(name, chunk):
    """Stage 2 at the real head ratio, requests at γ = 0, 2 and 4, whole
    and chunked prefill: greedy streams token for token, logprobs within
    1e-5 and weight_io_saved() equal the JAX engine's, on the port's plain
    path and on its kernel path (each wrapper's plain version)."""
    jcfg, tcfg, jp, tp = _ratio_setup(name)
    want, want_saved = _ratio_serve(
        JEngine(jcfg, jp, config=JConfig(prefill_chunk=chunk, **RATIO_GEOM)),
        _ratio_workload(jcfg.vocab_size))
    assert want_saved > 0  # the γ-windows skip tiles
    for fast in (None, True):
        got, saved = _ratio_serve(ContinuousBatchingEngine(
            tcfg, tp, EngineConfig(prefill_chunk=chunk, fast_kernels=fast,
                                   **RATIO_GEOM), device="cpu"),
            _ratio_workload(tcfg.vocab_size))
        for g, w in zip(got, want):
            assert g.tokens.tolist() == np.asarray(w.tokens).tolist()
            np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=0,
                                       atol=1e-5)
        assert saved == pytest.approx(want_saved, abs=1e-9)
