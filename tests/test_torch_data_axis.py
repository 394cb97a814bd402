"""Serving on a (data, model) mesh with data > 1: the port against the JAX
reference's single-device engine, on the CPU, at f32.

The port's engine runs on gloo ranks (``tests/torch_ranks.py``): a (2, 1)
and a (2, 2) mesh serve every case, and the reference's own case
(``tests/test_sharded_serving.py::test_data_axis_sharded_pool``: tiny-relu,
2 slots, blocks of 8, 6 a sequence, ``n_blocks=14``) runs on (2, 4). Each
data row computes its slot and holds 7 of the 14 pool blocks; attention
reads the pool through kernel 2's partial mode (its plain version here)
and folds the rows' partials. In every case each rank's greedy and
sampled streams equal the reference's token for token, logprobs within
1e-5, and ``metrics_snapshot()`` equals the reference's (the per-device
weight bytes are its figure / ``ffn_tp``).

Cases: plain (whole-prompt and chunked, γ-window reuse), static tile
capacities 0.5 / 0.75 at tile 16 and one group (the batch union's scores
put together over the data axis), speculative (a 1-layer draft; its pool
split too), predictor (sign, bf16 probe; low-rank at recall 0.9), sampled
traffic, tiny-moe at capacity 1.0 with routing groups of 3 tokens (it
drops tokens, and a decode step's group spans both rows: the router
logits are gathered), a tight pool under priority preemption (a resumed
request lands in other blocks), an odd ``n_blocks`` (the pool replicated
on every row), an odd ``n_slots`` (every row computes every slot), the
prefix cache with warm masks (prompts sharing a block), and cancels, one
mid-stream and one in the queue; the last two with per-request sparsity
trackers, whose curves, aggregated sparsities and used masks equal the
reference's, as do every request's finish reason and cached prompt
tokens.
On (2, 2) and (2, 4), with the slots split, a model rank that samples
other tokens than its data row's first rank makes every rank raise.

The partial mode itself: its plain version over a random split of a
pool's pages, folded, equals ``paged_window_attention_plain`` within 1e-6,
a slot with no page on one row included."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import registry as jreg
from repro.predictor import calibration as jcal
from repro.predictor import sign_predictor
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving.config import EngineConfig as JConfig
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch.kernels import paged_attention as kpa
from repro_torch.sharding import comm

import torch_ranks as tr

torch.set_num_threads(1)

POOL = dict(n_blocks=14)  # even: each of the 2 data rows holds 7 blocks
TIGHT = dict(n_slots=2, block_size=8, max_blocks_per_seq=4, n_blocks=8,
             prefill_chunk=4, preemption=True)
MOE_DROPS = dict(capacity_factor=1.0, moe_group_size=3)
# case id -> (arch, options): chunk, geom (EngineConfig fields), static,
# spec, predictor, sampled, preempt, moe (config fields)
CASES = {
    "plain": ("tiny-relu", {}),
    "chunked": ("tiny-relu", dict(chunk=4)),
    "static": ("tiny-relu", dict(chunk=4, static=True)),
    "spec": ("tiny-relu", dict(spec=True)),
    "predictor-sign": ("tiny-relu", dict(predictor="sign")),
    "predictor-lowrank": ("tiny-opt", dict(predictor="lowrank", chunk=4)),
    "sampled": ("tiny-relu", dict(chunk=4, sampled=True)),
    "moe-drops": ("tiny-moe", dict(moe=MOE_DROPS)),
    "moe-drops-chunked": ("tiny-moe", dict(moe=MOE_DROPS, chunk=4)),
    "preempt": ("tiny-opt", dict(preempt=True, geom=TIGHT)),
    "odd-blocks": ("tiny-relu", dict(chunk=4, geom=dict(n_blocks=13))),
    "odd-slots": ("tiny-opt", dict(geom=dict(n_slots=3, n_blocks=20))),
    "prefix-tracked": ("tiny-relu", dict(chunk=4, prefix=True, geom=dict(
        prefix_cache=True, warm_masks=True, track_sparsity=True))),
    "cancel-tracked": ("tiny-opt", dict(chunk=4, cancel=True, geom=dict(
        track_sparsity=True))),
    "reference": ("tiny-relu", {}),
}
MESHES = {(2, 1): [c for c in CASES if c != "reference"],
          (2, 2): [c for c in CASES if c != "reference"],
          (2, 4): ["reference"]}
GROUP_TIMEOUT = 300.0

_BUILT = {}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def build(cid):
    """(the ranks' case dict, the reference's EngineConfig kwargs, its cfg
    and params) of case ``cid`` on the weights of jax.random keys 0
    (target) and 2 (draft)."""
    if cid in _BUILT:
        return _BUILT[cid]
    arch, opts = CASES[cid]
    jcfg = jget_config(arch).replace(compute_dtype="float32",
                                     **opts.get("moe", {}))
    if opts.get("static"):
        jcfg = jcfg.replace_sparsity(enabled=True, ffn_tile_density=0.5,
                                     input_tile_density=0.75, tile_size=16,
                                     n_groups=1)
    fam = jreg.get_family(jcfg)
    jp = fam.init_params(jax.random.PRNGKey(0), jcfg)
    geom = dict(POOL, **opts.get("geom", {}))
    jkw = dict(tr.GEOM, prefill_chunk=opts.get("chunk", 0))
    jkw.update(geom)
    case = {"cfg": jcfg.to_json(), "params": _np(jp),
            "chunk": jkw["prefill_chunk"], "geom": geom,
            "sampled": opts.get("sampled", False),
            "preempt": opts.get("preempt", False),
            "prefix": opts.get("prefix", False),
            "cancel": opts.get("cancel", False)}
    if opts.get("spec"):
        dcfg = jcfg.replace(name=jcfg.name + "-draft", n_layers=1)
        dp = fam.init_params(jax.random.PRNGKey(2), dcfg)
        jkw.update(draft_cfg=dcfg, draft_params=dp, gamma=4)
        case["draft"] = (dcfg.to_json(), _np(dp))
    kind = opts.get("predictor")
    if kind:
        if kind == "sign":
            pred = sign_predictor(jp, jcfg, probe_dtype="bfloat16", tile=1)
        else:
            toks = np.random.RandomState(2).randint(
                0, jcfg.vocab_size, (4, 24)).astype(np.int32)
            pred = jcal.calibrate(jp, jcfg, {"tokens": jax.numpy.asarray(toks)},
                                  kind=kind, tile=1, rank=4, target_recall=0.9)
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
    case, jkw, jcfg, jp = build(cid)
    eng = JEngine(jcfg, jp, config=JConfig(**jkw))
    uids, res = tr.drive(eng, jcfg.vocab_size, case, JSamplingParams)
    return tr.outcome(eng, uids, res)


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
    """(data, model) -> the ranks' results (or the exception their group
    raised). The groups run in a thread started here while this thread
    runs the reference engines."""
    out, done = {}, {m: threading.Event() for m in MESHES}

    def run():
        for mesh in ((2, 4), (2, 1), (2, 2)):
            cases = {cid: build(cid)[0] for cid in MESHES[mesh]}
            try:
                out[mesh] = comm.spawn(tr.serve_cases, mesh[0] * mesh[1],
                                       timeout=GROUP_TIMEOUT,
                                       args=(cases, mesh[0]), device="cpu")
            except Exception as e:  # noqa: BLE001 — raised in the tests
                out[mesh] = e
            done[mesh].set()

    for cid in CASES:
        build(cid)
    threading.Thread(target=run, daemon=True).start()
    for cid in CASES:
        reference(cid)

    def get(mesh):
        assert done[mesh].wait(timeout=3 * GROUP_TIMEOUT), \
            "the rank groups did not finish"
        if isinstance(out[mesh], Exception):
            raise out[mesh]
        return out[mesh]
    return get


@pytest.mark.parametrize("mesh,cid", [(m, c) for m, cs in MESHES.items()
                                      for c in cs])
def test_data_axis_engine_equals_single_device_reference(reference, ranks,
                                                         mesh, cid):
    want = reference(cid)
    per_rank = ranks(mesh)
    data, model = mesh
    assert len(per_rank) == data * model
    case = build(cid)[0]
    n_blocks, n_slots = case["geom"]["n_blocks"], case["geom"].get(
        "n_slots", tr.GEOM["n_slots"])
    if cid == "preempt":
        assert sum(want["preemptions"]) >= 1  # the case preempts
    for got in (r[cid] for r in per_rank):
        assert got["tokens"] == want["tokens"]
        np.testing.assert_allclose(np.concatenate(got["logprobs"]),
                                   np.concatenate(want["logprobs"]),
                                   rtol=0, atol=1e-5)
        assert got["preemptions"] == want["preemptions"]
        # the pool's blocks split over the data rows where they divide
        assert got["pool_blocks"] == (n_blocks // data if n_blocks % data == 0
                                      else n_blocks)
        if n_blocks % data == 0 or n_slots % data == 0:
            assert got["data_collectives"] > 0
        gm, wm = got["metrics"], want["metrics"]
        assert set(gm) == set(wm)
        for k, v in wm.items():
            if k == "weight_io_bytes_per_step":
                v = v / got["ffn_tp"]
            assert gm[k] == pytest.approx(v, rel=1e-12, abs=1e-9), k
        assert got["draft_accepted"] == want["draft_accepted"]
        assert got["pred_misses"] == want["pred_misses"]
        assert got["finish"] == want["finish"]
        assert got["cached"] == want["cached"]
        assert got["trackers"].keys() == want["trackers"].keys()
        for u, (curve, agg, used) in want["trackers"].items():
            g_curve, g_agg, g_used = got["trackers"][u]
            assert g_curve == pytest.approx(curve, abs=1e-6), u
            assert g_agg == pytest.approx(agg, abs=1e-6), u
            np.testing.assert_array_equal(g_used, used)
    if cid == "prefix-tracked":
        assert want["metrics"]["prefix_hit_rate"] > 0
        assert want["trackers"]
    if cid == "cancel-tracked":
        assert want["finish"][1] == want["finish"][3] == "cancelled"
        assert want["tokens"][3] == []  # withdrawn from the queue
        assert len(want["tokens"][1]) >= 3  # cancelled mid-stream


@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)])
def test_model_ranks_that_disagree_within_a_data_row_raise(ranks, mesh):
    """With the slots split over data, a model rank whose sampled tokens
    differ from its row's first rank makes every rank raise."""
    assert all("disagree" in r["model_disagree"] for r in ranks(mesh))


def test_reference_case_holds_seven_blocks_a_rank(ranks):
    """The reference's (2, 4) case: 14 pool blocks, 7 on each rank (the
    reference checks its shard's shape), model axis 4."""
    per_rank = ranks((2, 4))
    assert [r["reference"]["pool_blocks"] for r in per_rank] == [7] * 8
    assert all(r["reference"]["tp"] == 4 for r in per_rank)


# ---------------------------------------------------------------------------
# kernel 2's partial mode (plain version) against the whole-pool attention


@pytest.mark.parametrize("dtype,window", [(torch.float32, 0),
                                          (torch.float32, 11)])
def test_partial_mode_folded_equals_whole_pool_attention(dtype, window):
    """A pool of 24 blocks cut at random into D = 3 ranges of blocks (each
    a row's local pool); every row's partial attention of every slot over
    its range, folded in data order, equals the plain whole-pool attention
    within 1e-6. Slot 0's pages all lie in the first range, so the other
    rows hold none of them (m = -1e30, l = 0, acc = 0 there)."""
    rng = np.random.RandomState(window)
    b, W, kvp, g, hd, bs, nb, n_blocks = 4, 3, 2, 2, 16, 8, 5, 24
    q = torch.as_tensor(rng.randn(b, W, kvp, g, hd), dtype=dtype)
    kp = torch.as_tensor(rng.randn(n_blocks, kvp, bs, hd), dtype=dtype)
    vp = torch.as_tensor(rng.randn(n_blocks, kvp, bs, hd), dtype=dtype)
    cuts = [0, *sorted(rng.choice(np.arange(2, n_blocks - 1), 2,
                                  replace=False)), n_blocks]
    table = rng.randint(0, n_blocks, (b, nb))
    table[0] = rng.randint(0, cuts[1], nb)  # slot 0: the first range only
    table = torch.as_tensor(table, dtype=torch.int32)
    pos = torch.as_tensor(rng.randint(W, nb * bs, b)[:, None]
                          + np.arange(W)[None, :] - W, dtype=torch.int32)
    want = kpa.paged_window_attention_plain(q, kp, vp, table, pos,
                                            window=window)
    parts = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        parts.append(kpa.paged_window_attention_partial(
            q, kp[lo:hi], vp[lo:hi], table, pos, blocks=(lo, hi - lo),
            window=window))
    empty = parts[1][0]  # slot 0 has no page in the second range
    assert (empty[..., hd] == -1e30).all() and (empty[..., hd + 1] == 0).all()
    assert (empty[..., :hd] == 0).all()
    got = kpa.fold_partials(torch.stack(parts), (0, b), dtype)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    # a row's own slots only: the fold of slots 1 .. 2
    got = kpa.fold_partials(torch.stack(parts), (1, 2), dtype)
    np.testing.assert_allclose(got.numpy(), want[1:3].numpy(), rtol=0,
                               atol=1e-6)


def test_partial_mode_takes_its_plain_version_on_cpu_tensors():
    """CPU tensors take the partial mode's and the fold's plain versions,
    which count no launch (on CUDA tensors the wrappers launch, counted,
    or raise); a local pool that does not match its block range
    raises."""
    n0 = kpa.paged_window_attention_partial.launches
    f0 = kpa.fold_partials.launches
    q = torch.zeros((1, 1, 1, 1, 16))
    pages = torch.zeros((2, 1, 8, 16))
    parts = kpa.paged_window_attention_partial(
        q, pages, pages, torch.zeros((1, 1), dtype=torch.int32),
        torch.zeros((1, 1), dtype=torch.int32), blocks=(0, 2))
    assert parts.shape == (1, 1, 1, 1, 18)
    kpa.fold_partials(parts[None], (0, 1), torch.float32)
    assert kpa.paged_window_attention_partial.launches == n0
    assert kpa.fold_partials.launches == f0
    with pytest.raises(ValueError, match="local pages"):
        kpa.paged_window_attention_partial(
            q, pages[:1], pages[:1], torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32), blocks=(0, 2))
