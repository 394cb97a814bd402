"""The port's MoE family against the JAX reference at f32 on the CPU:
routing (drop-free and droppable capacity, ties, several groups), the
model's logits, the paged window step and its telemetry, the grouped-gather
lowering, and the engine's greedy streams token for token in whole-prompt
and chunked prefill, with and without γ-window reuse, with the reference's
expert-byte accounting.

The same parameters go to both (JAX init, converted through numpy).
Serving parity is held on tiny-moe, whose capacity is drop-free: the
engine's batch shapes then route every token as a batch of one would."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config
from repro.models import common as jcm
from repro.models import moe as JM
from repro.models import registry as jreg
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving.config import EngineConfig as JConfig
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import common as tcm
from repro_torch.models import moe as TM
from repro_torch.models import registry as treg
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

BS = 8
PROMPTS = [(1, 9), (2, 5), (3, 13), (4, 11)]  # (seed, length)
REUSE = [0, 2, 0, 2]
MAX_NEW = 8
GEOM = dict(n_slots=2, block_size=BS, max_blocks_per_seq=6)


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _mixtral_smoke():
    """The reference's smoke Mixtral (GLU, SiLU, RoPE θ = 1e6, GQA) with a
    sliding window shorter than the test sequences."""
    return smoke_config("mixtral-8x22b").replace(sliding_window=8)


_CACHE = {}


def _setup(name, **over):
    """(jax cfg, port cfg, jax params, port params) at f32, shared."""
    key = (name, tuple(sorted(over.items())))
    if key not in _CACHE:
        if name == "mixtral-smoke":
            jcfg = _mixtral_smoke().replace(compute_dtype="float32", **over)
        else:
            jcfg = jget_config(name).replace(compute_dtype="float32", **over)
        tcfg = ModelConfig.from_json(jcfg.to_json())
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _CACHE[key] = (jcfg, tcfg, jp, tp)
    return _CACHE[key]


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def test_configs_match_reference():
    for name in ("tiny-moe", "mixtral-8x22b", "phi3.5-moe-42b-a6.6b"):
        assert get_config(name).to_json() == jget_config(name).to_json()


def test_init_params_layout_matches_reference():
    _, tcfg, jp, tp = _setup("tiny-moe")

    def shapes(t):
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else tuple(t.shape))
    assert shapes(TM.init_params(tcfg, seed=0, device="cpu")) == shapes(jp)
    # the stacked expert tree converts leaf for leaf
    for k in ("router", "wu", "wd"):
        np.testing.assert_array_equal(tp["layers"]["moe"][k].numpy(),
                                      np.asarray(jp["layers"]["moe"][k]))


# ---------------------------------------------------------------------------
# routing


ROUTE_CASES = {
    # (config overrides, tokens): drop-free tiny-moe; capacity 1.25 with a
    # batch whose experts overflow; three groups of 8; two identical router
    # columns, so every token's gates tie
    "drop_free": ({}, 12),
    "droppable": ({"capacity_factor": 1.25}, 16),
    "groups": ({"moe_group_size": 8, "capacity_factor": 1.25}, 24),
    "ties": ({}, 10),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_matches_reference(case):
    over, t = ROUTE_CASES[case]
    jcfg, tcfg, jp, tp = _setup("tiny-moe", **over)
    rng = np.random.RandomState(len(case))
    x = rng.randn(t, jcfg.d_model).astype(np.float32)
    router = np.array(jp["layers"]["moe"]["router"][0])
    if case == "ties":
        router[:, 2] = router[:, 1]
    jout = JM._route({"router": jnp.asarray(router)}, jnp.asarray(x), jcfg,
                     jcm.StatsCollector(False))
    tout = TM._route({"router": torch.as_tensor(router)}, torch.as_tensor(x),
                     tcfg)
    assert tout[3] == tuple(jout[3])
    np.testing.assert_array_equal(_np(tout[1]), np.asarray(jout[1]))
    _close(tout[2], jout[2], 1e-6)
    kept = int(_np(tout[1]).sum())
    G, tg, _ = tout[3]
    if case in ("droppable", "groups"):
        assert kept < t * tcfg.top_k  # capacity dropped some assignments
    else:
        assert kept == t * tcfg.top_k
    if case == "groups":
        assert G == 3 and tg == 8


@pytest.mark.parametrize("capacity", [8.0, 1.25])
def test_apply_moe_and_gathered_lowering_match_reference(capacity):
    """``apply_moe`` and its grouped-gather lowering (expert_tile_lists,
    expert_up_matmul, expert_down_matmul) against the reference's
    ``apply_moe``, at drop-free and at droppable capacity."""
    jcfg, tcfg, jp, tp = _setup("tiny-moe", capacity_factor=capacity)
    x = np.random.RandomState(7).randn(16, jcfg.d_model).astype(np.float32)
    want = JM.apply_moe(_layer0(jp["layers"]["moe"]), jnp.asarray(x), jcfg,
                        stats=jcm.StatsCollector(False))
    pm = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    _close(TM.apply_moe(pm, torch.as_tensor(x), tcfg), want)
    _close(TM.apply_moe_gathered(pm, torch.as_tensor(x), tcfg), want)


def test_gathered_lowering_glu_matches_apply_moe():
    """GLU experts (the smoke Mixtral), through both lowerings."""
    _, tcfg, _, tp = _setup("mixtral-smoke")
    pm = {k: v[1] for k, v in tp["layers"]["moe"].items()}
    x = torch.as_tensor(np.random.RandomState(8).randn(
        10, tcfg.d_model).astype(np.float32))
    _close(TM.apply_moe_gathered(pm, x, tcfg), TM.apply_moe(pm, x, tcfg))


# ---------------------------------------------------------------------------
# model and paged steps


@pytest.mark.parametrize("name", ["tiny-moe", "mixtral-smoke"])
def test_model_forward_logits_match_reference(name):
    jcfg, tcfg, jp, tp = _setup(name)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 19))
    want = JM.model_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got = treg.get_family(tcfg).model_forward(
        tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    assert got.shape == want.shape
    _close(got, want, 1e-4)


def _paged_state(jcfg, seed=0, n_blocks=14, b=3, nb=4):
    rng = np.random.RandomState(seed)
    g = jcm.HeadGeometry(jcfg.n_heads, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    shape = (jcfg.n_layers, n_blocks, g.kvp, BS, g.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    table = rng.permutation(np.arange(1, n_blocks))[: b * nb].reshape(b, nb)
    masks = rng.rand(jcfg.n_layers, b, jcfg.d_ff) < 0.5
    return k, v, table.astype(np.int32), masks, np.array([True, False, False])


@pytest.mark.parametrize("step", ["decode", "chunk"])
@pytest.mark.parametrize("name", ["tiny-moe", "mixtral-smoke"])
def test_paged_steps_match_reference(name, step):
    """One paged step: logits of the valid rows, the pool outside the
    scratch block, the new γ-masks and the telemetry (activity, scores,
    expert-weighted density; union density for the window step)."""
    jcfg, tcfg, jp, tp = _setup(name)
    rng = np.random.RandomState(4)
    if step == "decode":
        args = (np.array([5, 17, 0], np.int32), np.array([9, 30, 0], np.int32))
        jfn, tfn, rows = JM.model_decode_paged, TM.model_decode_paged, slice(None)
    else:
        clen = np.array([4, 2, 0], np.int32)
        args = (rng.randint(0, jcfg.vocab_size, (3, 4)).astype(np.int32),
                np.array([8, 3, 0], np.int32), clen)
        jfn, tfn = JM.model_verify_window_paged, TM.model_verify_window_paged
        rows = np.arange(4)[None, :] < clen[:, None]
    k, v, table, masks, refresh = _paged_state(jcfg)
    wl, wpages, wmasks, waux = jfn(
        jp, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(table),
        *map(jnp.asarray, args), jcfg, jnp.asarray(masks),
        jnp.asarray(refresh), block_size=BS)
    gl, gpages, gmasks, gaux = tfn(
        tp, {"k": torch.as_tensor(k), "v": torch.as_tensor(v)},
        torch.as_tensor(table), *map(torch.as_tensor, args), tcfg,
        torch.as_tensor(masks), torch.as_tensor(refresh), block_size=BS)
    _close(_np(gl)[rows], _np(wl)[rows], 1e-4)
    _close(gpages["k"][:, 1:], _np(wpages["k"])[:, 1:])
    _close(gpages["v"][:, 1:], _np(wpages["v"])[:, 1:])
    np.testing.assert_array_equal(_np(gmasks), _np(wmasks))
    np.testing.assert_array_equal(_np(gaux[0]), _np(waux[0]))
    np.testing.assert_array_equal(_np(gaux[1]) > 0, _np(waux[1]) > 0)
    for g, w in zip(gaux[2:], waux[2:]):
        _close(g, w)


# ---------------------------------------------------------------------------
# the engine against the reference engine


def _prompts(vocab):
    return [np.random.RandomState(s).randint(0, vocab, n).astype(np.int32)
            for s, n in PROMPTS]


def _serve(engine, reuse):
    uids = [engine.submit(p, MAX_NEW, reuse_window=r)
            for p, r in zip(_prompts(256), reuse)]
    res = engine.run()
    return ([res[u].tokens.tolist() for u in uids],
            [np.asarray(res[u].logprobs) for u in uids])


@pytest.fixture(scope="module")
def reference():
    """(prefill_chunk, reuse) -> (streams, logprobs, engine) of the JAX
    engine on tiny-moe, computed on first use."""
    cache = {}

    def get(chunk, reuse):
        if (chunk, reuse) not in cache:
            jcfg, _, jp, _ = _setup("tiny-moe")
            eng = JEngine(jcfg, jp, config=JConfig(prefill_chunk=chunk, **GEOM))
            cache[chunk, reuse] = _serve(eng, reuse) + (eng,)
        return cache[chunk, reuse]
    return get


def _port(chunk, reuse, **kw):
    _, tcfg, _, tp = _setup("tiny-moe")
    eng = ContinuousBatchingEngine(
        tcfg, tp, EngineConfig(prefill_chunk=chunk, **GEOM, **kw),
        device="cpu")
    return _serve(eng, reuse) + (eng,)


@pytest.mark.parametrize("reuse", [0, 2])
@pytest.mark.parametrize("chunk", [0, 4])
def test_moe_streams_equal_reference(reference, chunk, reuse):
    """Greedy f32 streams token for token, logprobs within 1e-5, and the
    engine's weight-I/O figures equal to the reference's (requests with
    reuse 0 and 2 share one run of each engine)."""
    want, want_lp, jeng = reference(chunk, tuple(REUSE))
    got, got_lp, eng = _port(chunk, tuple(REUSE))
    sel = [i for i, r in enumerate(REUSE) if r == reuse]
    assert [got[i] for i in sel] == [want[i] for i in sel]
    for i in sel:
        np.testing.assert_allclose(got_lp[i], want_lp[i], rtol=0, atol=1e-5)
    assert eng.weight_io_saved() == pytest.approx(jeng.weight_io_saved(),
                                                  abs=1e-9)
    assert eng.weight_io_bytes_per_step() == pytest.approx(
        jeng.weight_io_bytes_per_step(), rel=1e-9)


@pytest.mark.parametrize("chunk", [0, 4])
def test_moe_expert_io_accounting_matches_reference(reference, chunk):
    """At reuse 0 every token reads exactly its top-k experts (drop-free):
    the measured density is top_k / n_experts, and the bytes per step are
    that fraction of the dense bytes of all experts, as in the reference."""
    _, tcfg, _, _ = _setup("tiny-moe")
    reuse = (0,) * len(PROMPTS)
    want, _, jeng = reference(chunk, reuse)
    got, _, eng = _port(chunk, reuse)
    assert got == want
    frac = tcfg.top_k / tcfg.n_experts
    assert eng.expert_io_fraction() == jeng.expert_io_fraction() == frac
    dense_all = (tcfg.n_layers * tcfg.d_ff * tcfg.d_model * tcfg.n_experts * 4)
    assert eng.weight_io_bytes_per_step() == pytest.approx(frac * dense_all)
    assert eng.weight_io_bytes_per_step() == pytest.approx(
        jeng.weight_io_bytes_per_step())


def test_cpu_fast_kernels_warns_and_serves_plain(reference):
    """fast_kernels=True with an MoE config on the CPU does what the
    reference engine does: it warns, then serves the plain path."""
    want, _, _ = reference(4, tuple(REUSE))
    with pytest.warns(UserWarning, match="not wired for MoE"):
        got, _, eng = _port(4, tuple(REUSE), fast_kernels=True)
    assert not eng.fast_kernels
    assert got == want


def test_moe_engine_rejects_predictor_and_keeps_dense_metrics():
    _, tcfg, _, tp = _setup("tiny-moe")
    with pytest.raises(ValueError, match="'moe'.*'predictor'"):
        ContinuousBatchingEngine(tcfg, tp, EngineConfig(predictor=object()),
                                 device="cpu")
    assert treg.serving_caps("moe") == {"paged_decode", "chunked_prefill",
                                        "spec_verify"}
    dense_cfg = get_config("tiny-opt").replace(compute_dtype="float32")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = ContinuousBatchingEngine(
            dense_cfg, treg.get_family(dense_cfg).init_params(
                dense_cfg, device="cpu"), EngineConfig(**GEOM), device="cpu")
    assert eng.expert_io_fraction() is None
    assert tcm.ffn_gather_tile(tcfg) == jcm.ffn_gather_tile(
        jget_config("tiny-moe"))
