"""Tensor-parallel sharded serving of the port against the JAX reference's
single-device engine, on the CPU, at f32.

The port's engine runs on a (1, M) mesh of M gloo ranks (one spawned group
per M, ``tests/torch_ranks.py``, each under its own timeout), every rank
holding its blocks of the converted reference weights. Each case's greedy
streams equal the reference engine's token for token on every rank, with
logprobs within 1e-5 (each rank sums its partial products in another order
than one device), in plain (whole-prompt and chunked, γ-window reuse),
speculative (γ = 4, a 1-layer draft sharded with the target), static
tile capacities (0.5 / 0.75 with chunked prefill, at ``n_groups`` = 1
(M = 2 and 4: the tile scores put together over the ranks) and 4 (M = 4:
a rank's d_ff slice its group)), predictor
(the training-free sign predictor at a bf16 probe, tile 1, lists packed
per rank: ``n_groups`` = TP) and
MoE (the expert axis over "model") modes, at M = 2 and 4, and tiny-relu
plain at M = 8. The metrics equal the reference's (the per-rank FFN
statistics are reduced), ``weight_io_bytes_per_step()`` is the reference's
figure / ``ffn_tp`` and ``per_device=False`` its figure. The engine
compares a checksum of the sampled tokens over the ranks every step, so a
rank that picked another token fails its group.

The rank groups run in background threads while this process runs the
reference engines."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import registry as jreg
from repro.predictor import sign_predictor
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving.config import EngineConfig as JConfig
from repro_torch.sharding import comm

import torch_ranks as tr

# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

# case id -> (arch, mode, prefill chunk)
CASES = {
    "tiny-relu-plain": ("tiny-relu", "plain", 0),
    "tiny-relu-chunked": ("tiny-relu", "plain", 4),
    "tiny-opt-plain": ("tiny-opt", "plain", 0),
    "tiny-opt-chunked": ("tiny-opt", "plain", 4),
    "tiny-relu-spec": ("tiny-relu", "spec", 0),
    "tiny-opt-spec": ("tiny-opt", "spec", 0),
    "tiny-relu-predictor": ("tiny-relu", "predictor", 0),
    "tiny-opt-predictor": ("tiny-opt", "predictor", 0),
    "tiny-moe-plain": ("tiny-moe", "plain", 0),
    "tiny-moe-chunked": ("tiny-moe", "plain", 4),
    # static capacities 0.5 (FFN) / 0.75 (inputs) at tile 16 with
    # n_groups 1 and 4 (the suffix): one device's selection on every
    # rank, and at M = 4 the K/V rows split over d_model take the part of
    # the whole input's selection in their rows
    "tiny-relu-static-1": ("tiny-relu", "static", 4),
    "tiny-relu-static-4": ("tiny-relu", "static", 4),
}
_COMMON = [c for c in CASES if "static" not in c]
WORLDS = {2: _COMMON + ["tiny-relu-static-1"],
          4: _COMMON + ["tiny-relu-static-1", "tiny-relu-static-4"],
          8: ["tiny-relu-plain"]}
GROUP_TIMEOUT = 240.0  # seconds a rank group may take before all are killed


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


_BUILT = {}


def build(cid):
    """(the ranks' case dict, the reference engine's config kwargs, its
    cfg and params) for case ``cid``: the weights of jax.random keys 0
    (target) and 2 (draft), the reference's sign predictor at a bf16
    probe."""
    if cid in _BUILT:
        return _BUILT[cid]
    arch, mode, chunk = CASES[cid]
    jcfg = jget_config(arch).replace(compute_dtype="float32")
    if mode == "static":
        jcfg = jcfg.replace_sparsity(
            enabled=True, ffn_tile_density=0.5, input_tile_density=0.75,
            tile_size=16, n_groups=int(cid.rsplit("-", 1)[1]))
    fam = jreg.get_family(jcfg)
    jp = fam.init_params(jax.random.PRNGKey(0), jcfg)
    jkw = dict(tr.GEOM, prefill_chunk=chunk)
    case = {"cfg": jcfg.to_json(), "params": _np(jp), "chunk": chunk}
    if mode == "spec":
        dcfg = jcfg.replace(name=jcfg.name + "-draft", n_layers=1)
        dp = fam.init_params(jax.random.PRNGKey(2), dcfg)
        jkw.update(draft_cfg=dcfg, draft_params=dp, gamma=4)
        case["draft"] = (dcfg.to_json(), _np(dp))
    if mode == "predictor":
        pred = sign_predictor(jp, jcfg, probe_dtype="bfloat16", tile=1)
        jkw["predictor"] = pred
        case["predictor"] = dict(
            kind=pred.kind, n_tiles=pred.n_tiles, k_tiles=pred.k_tiles,
            tile=pred.tile, target_recall=pred.target_recall,
            probe_dtype=pred.probe_dtype,
            params={k: np.array(v, np.float32)
                    for k, v in pred.params.items()})
    _BUILT[cid] = (case, jkw, jcfg, jp)
    return _BUILT[cid]


def _reference_run(cid):
    _, jkw, jcfg, jp = build(cid)
    eng = JEngine(jcfg, jp, config=JConfig(**jkw))
    uids = [eng.submit(p, tr.MAX_NEW, reuse_window=r)
            for p, r in zip(tr.prompts(jcfg.vocab_size), tr.REUSE)]
    res = eng.run()
    return dict(tokens=[res[u].tokens.tolist() for u in uids],
                logprobs=[np.asarray(res[u].logprobs) for u in uids],
                draft_accepted=[res[u].draft_accepted for u in uids],
                pred_misses=[res[u].pred_misses for u in uids],
                metrics=eng.metrics_snapshot(),
                bytes=eng.weight_io_bytes_per_step())


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(cid):
        if cid not in cache:
            cache[cid] = _reference_run(cid)
        return cache[cid]
    return get


@pytest.fixture(scope="module")
def ranks(reference):
    """world -> the ranks' results (or the exception their group raised).
    The groups run in threads started here, the largest as soon as its
    case is built, while this thread builds the rest and then runs every
    reference engine."""
    out, done = {}, {w: threading.Event() for w in WORLDS}

    def run(worlds):
        for w in worlds:
            cases = {cid: build(cid)[0] for cid in WORLDS[w]}
            try:
                out[w] = comm.spawn(tr.serve_cases, w, timeout=GROUP_TIMEOUT,
                                    args=(cases,), device="cpu")
            except Exception as e:  # noqa: BLE001 — raised in the tests
                out[w] = e
            done[w].set()

    def start(worlds):
        threading.Thread(target=run, args=(worlds,), daemon=True).start()

    for cid in WORLDS[8]:
        build(cid)
    start([8])
    for cid in CASES:
        build(cid)
    start([2, 4])
    for cid in CASES:
        reference(cid)

    def get(world):
        assert done[world].wait(timeout=3 * GROUP_TIMEOUT), \
            "the rank groups did not finish"
        if isinstance(out[world], Exception):
            raise out[world]
        return out[world]
    return get


@pytest.mark.parametrize("world,cid", [(w, c) for w, cs in WORLDS.items()
                                       for c in cs])
def test_sharded_engine_equals_single_device_reference(reference, ranks,
                                                        world, cid):
    want = reference(cid)
    per_rank = ranks(world)
    assert len(per_rank) == world
    for got in (r[cid] for r in per_rank):
        assert got["tokens"] == want["tokens"]
        np.testing.assert_allclose(np.concatenate(got["logprobs"]),
                                   np.concatenate(want["logprobs"]),
                                   rtol=0, atol=1e-5)
        assert got["tp"] == world and got["ffn_tp"] == world
        assert got["all_reduces"] > 0
        # per-device FFN weight bytes: the single-device figure / ffn_tp
        assert got["bytes_per_device"] == pytest.approx(
            want["bytes"] / got["ffn_tp"], rel=1e-12)
        assert got["bytes_total"] == pytest.approx(want["bytes"], rel=1e-12)
        gm, wm = got["metrics"], want["metrics"]
        assert set(gm) == set(wm)
        for k, v in wm.items():
            if k == "weight_io_bytes_per_step":
                v = v / got["ffn_tp"]
            assert gm[k] == pytest.approx(v, rel=1e-12, abs=1e-9), k
        mode = CASES[cid][1]
        if mode == "spec":
            assert got["draft_accepted"] == want["draft_accepted"]
            assert "s_agg_window" in gm
        if mode == "predictor":
            assert got["pred_misses"] == want["pred_misses"]
            assert "predictor_recall" in gm
            assert got["predictor_unchanged"]


# ---------------------------------------------------------------------------
# the rank groups themselves


def test_ranks_that_disagree_on_the_tokens_raise(ranks):
    """After its cases each rank of the M = 2 group offers another
    checksum: ``check_same`` raises on every rank."""
    assert all("disagree" in r["disagree"] for r in ranks(2))


def test_a_failing_rank_fails_its_group():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\\n)*gives up"):
        comm.spawn(tr.one_rank_fails, 2, timeout=GROUP_TIMEOUT, device="cpu")


def test_a_hanging_group_is_killed_at_its_timeout():
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        comm.spawn(tr.one_rank_hangs, 2, timeout=5, device="cpu")
    assert time.monotonic() - t0 < 60
