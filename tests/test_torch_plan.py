"""The production cell plan of the port (``launch/cells.py``,
``specs.py``, ``dryrun.py``, ``op_cost.py``), the legacy decode's GQA
layout under a model axis wider than the kv heads, and Megatron-SP
residuals, on the CPU.

* GQA: tiny-relu and tiny-moe (2 kv heads) on a (1, 4) gloo mesh, where
  the serve rules split ``wk`` / ``wv`` over d_model: the legacy
  ``ServeEngine``'s greedy f32 streams (and tiny-relu's through the
  continuous engine) equal the reference's single-device streams,
  logprobs within 1e-5; so do the legacy streams
  of the Qwen3 (qk-norm) and Qwen2 (QKV bias) smoke configs.
* SP: on a (2, 2) gloo mesh the FSDP step's f32 loss and every rank's
  gradient blocks, with ``sp_residuals`` and without, equal the
  reference's single-device ``jax.value_and_grad`` of ``lm_loss`` on the
  same params and tokens (loss within 1e-5 relative, each block within
  1e-5 · max |g| of its leaf), and the two steps equal each other.
* Pod mesh: the same on (2, 2, 2) ("pod", "data", "model"), with the
  train step's grad norm.
* The plan: ``cell_plan`` is the reference's for both meshes; a tiny
  cell's dry run on "meta" (train, prefill, decode on (2, 2)) counts the
  collectives by axis, the FLOPs and the state bytes that a real gloo run
  of the same step counts; its train FLOPs equal the reference's
  ``hlo_cost.CostModel`` of its compiled step on 4 forced devices
  (tolerance 0: both count 2·M·N·K a product over the same products);
  the layer / microbatch extrapolation equals a full run; qwen3-4b's
  decode_32k cell on (16, 16) holds the shard sizes of the rules' specs;
  the launchers' pod paths print a cell's account.

Each rank group is shared by its tests through a module fixture."""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import cells as jcells
from repro.models import registry as jreg
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving.config import EngineConfig as JConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import cells, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import comm, rules

import subproc
import torch_ranks as tr
from test_torch_fsdp import _reference_grads

torch.set_num_threads(1)

GROUP_TIMEOUT = 240.0
MAX_NEW = 8


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _group(fn, world, args):
    """Start ``comm.spawn(fn, world, args=args)`` in a thread; returns a
    getter of its result (or raises what the group raised)."""
    box, done = {}, threading.Event()

    def run():
        try:
            box["out"] = comm.spawn(fn, world, timeout=GROUP_TIMEOUT,
                                    args=args, device="cpu")
        except Exception as e:  # noqa: BLE001 — raised in the tests
            box["out"] = e
        done.set()

    threading.Thread(target=run, daemon=True).start()

    def get():
        assert done.wait(timeout=2 * GROUP_TIMEOUT)
        if isinstance(box["out"], Exception):
            raise box["out"]
        return box["out"]
    return get


# -- GQA under a 4-wide model axis ---------------------------------------------

GQA_ARCHS = ("tiny-relu", "tiny-moe")


def _gqa_case(arch):
    jcfg = jget_config(arch).replace(compute_dtype="float32")
    jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size,
                                            (2, 8)).astype(np.int32)
    return jcfg, jp, toks


# the arch whose engine streams are held too (test_torch_sharded_serving
# holds both archs' at M = 4)
GQA_ENGINE = "tiny-relu"


def gqa_rank(rank, world, cases):
    """Per arch: the legacy generate on (1, world) and, for GQA_ENGINE,
    the engine's served streams on the same mesh."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    for arch, (cfg_json, params, toks) in cases.items():
        legacy = tr.legacy_generate(rank, world, (cfg_json, params, toks,
                                                  MAX_NEW))
        out[arch] = dict(legacy=legacy)
        if arch != GQA_ENGINE:
            continue
        mesh = make_host_mesh(1, world, strict=True, device="cpu")
        case = {"cfg": cfg_json, "params": params}
        engine = tr.serve(ModelConfig.from_json(cfg_json),
                          tr.to_torch(params), tr.engine_kwargs(case), mesh,
                          case)
        out[arch].update(tokens=engine["tokens"],
                         logprobs=engine["logprobs"])
    return out


@pytest.fixture(scope="module")
def gqa():
    built = {a: _gqa_case(a) for a in GQA_ARCHS}
    get = _group(gqa_rank, 4, ({a: (jcfg.to_json(), _np(jp), toks)
                                for a, (jcfg, jp, toks) in built.items()},))
    want = {}
    for arch, (jcfg, jp, toks) in built.items():
        leg = JServeEngine(jcfg, jp, max_len=32).generate(
            {"tokens": jnp.asarray(toks)}, max_new=MAX_NEW)
        want[arch] = dict(legacy=(np.asarray(leg.tokens),
                                  np.asarray(leg.logprobs)))
        if arch != GQA_ENGINE:
            continue
        eng = JEngine(jcfg, jp, config=JConfig(**tr.GEOM))
        uids = [eng.submit(p, tr.MAX_NEW, reuse_window=r)
                for p, r in zip(tr.prompts(jcfg.vocab_size), tr.REUSE)]
        res = eng.run()
        want[arch].update(
            tokens=[res[u].tokens.tolist() for u in uids],
            logprobs=[np.asarray(res[u].logprobs) for u in uids])
    return get, want


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_gqa_fewer_kv_heads_than_model_axis_equals_reference(gqa, arch):
    get, want = gqa
    jcfg = jget_config(arch)
    g = mesh_lib.Mesh(shape={"data": 1, "model": 4},
                      coords={"data": 0, "model": 0})
    # the serve rule splits wk over d_model: the kv heads do not divide 4
    assert jcfg.n_kv_heads < 4
    assert rules.param_pspec("layers/attn/wk", (2, jcfg.d_model,
                                                jcfg.n_kv_heads, 16), g,
                             "serve")[1] == "model"
    per_rank = get()
    w = want[arch]
    for r in per_rank:
        got = r[arch]
        np.testing.assert_array_equal(got["legacy"][0], w["legacy"][0])
        np.testing.assert_allclose(got["legacy"][1], w["legacy"][1],
                                   rtol=0, atol=1e-5)
        if arch != GQA_ENGINE:
            continue
        assert got["tokens"] == w["tokens"]
        np.testing.assert_allclose(np.concatenate(got["logprobs"]),
                                   np.concatenate(w["logprobs"]),
                                   rtol=0, atol=1e-5)


# -- Megatron-SP residuals -------------------------------------------------------

SP_CASES = (("tiny-relu", "none"), ("tiny-relu", "minimal"),
            ("tiny-relu", "save_ars"), ("tiny-moe", "minimal"))


def _ref_case(arch, seed, shape):
    """The reference's f32 config (``sp_residuals`` on: what the reference
    runs at this setting), its params from ``seed`` and seeded tokens."""
    jcfg = jget_config(arch).replace(compute_dtype="float32",
                                     sp_residuals=True)
    jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    toks = np.random.RandomState(seed).randint(
        0, jcfg.vocab_size, shape).astype(np.int64)
    return jcfg, jp, toks


def _reference_mean_grads(jcfg, jp, toks, remat):
    """``jax.value_and_grad`` of the reference's ``lm_loss`` on one
    device, over 2 microbatches: (mean loss, mean gradient leaves)."""
    return _reference_grads(jcfg, jp, {"tokens": toks.astype(np.int32)}, 2,
                            remat)


def _hold_blocks(got, want, what):
    """Each of a rank's gradient blocks (``torch_ranks.grad_blocks``)
    within 1e-5 · max |g| of the same block of the whole gradient."""
    mesh = mesh_lib.Mesh(shape=got["shape"], coords=got["coords"],
                         axis_names=got["axes"])
    assert len(got["grads"]) == len(want)
    for g, w, spec in zip(got["grads"], want, got["specs"]):
        blk = rules.local_block(torch.from_numpy(w), spec, mesh).numpy()
        assert g.shape == blk.shape, what
        np.testing.assert_allclose(g, blk, rtol=0, atol=1e-5 * max(
            float(np.abs(w).max()), 1e-30), err_msg=what)


@pytest.fixture(scope="module")
def sp_runs():
    built = [_ref_case(arch, 0, (8, 32)) + (remat,)
             for arch, remat in SP_CASES]
    get = _group(tr.sp_grads, 4, ([(jcfg.to_json(), _np(jp), toks, remat)
                                   for jcfg, jp, toks, remat in built],))
    return get, built


@pytest.mark.parametrize("i", range(len(SP_CASES)),
                         ids=[f"{a}-{r}" for a, r in SP_CASES])
def test_sp_residuals_match_the_unsplit_step(sp_runs, i):
    """With and without SP, the loss and every rank's gradient blocks
    equal the reference's single-device f32 ``value_and_grad`` on the same
    params and tokens; and the SP step equals the unsplit one."""
    get, built = sp_runs
    wl, wg = _reference_mean_grads(*built[i])  # while the ranks run
    for rank in get():
        loss, grads, loss_sp, grads_sp, kinds = rank[i]
        for what, l, g in (("unsplit", loss, grads), ("sp", loss_sp,
                                                      grads_sp)):
            assert abs(l - wl) <= 1e-5 * abs(wl), (what, l, wl)
            _hold_blocks(g, wg, what)
        assert abs(loss - loss_sp) <= 1e-5
        scale = max(float(np.abs(g).max()) for g in grads["grads"])
        for g, h in zip(grads["grads"], grads_sp["grads"]):
            np.testing.assert_allclose(h, g, rtol=0, atol=1e-5 * max(1.0,
                                                                     scale))
        # the sublayers' outputs were reduce-scattered over "model"
        assert kinds.get("reduce-scatter", 0) > 5


# -- the plan --------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cell_plan_is_the_reference_plan(multi_pod):
    assert cells.cell_plan(multi_pod) == jcells.cell_plan(multi_pod)
    assert (cells.cell_plan(multi_pod, include_sparse=False)
            == jcells.cell_plan(multi_pod, include_sparse=False))
    for c in cells.cell_plan(multi_pod):
        assert cells.skip_reason(c["arch"], c["shape"]) == ""
    assert cells.skip_reason("qwen3-4b", "long_500k") == jcells.skip_reason(
        "qwen3-4b", "long_500k") != ""


# (shape, global batch, sequence, microbatches) of the tiny cells
TINY_CELLS = (("train_4k", 8, 32, 2), ("prefill_32k", 4, 32, 1),
              ("decode_32k", 4, 32, 1))


@pytest.fixture(scope="module")
def tiny_real():
    cfg = get_config("tiny-relu")
    return _group(tr.plan_cells, 4, ([(cfg.to_json(), s, b, q, m)
                                      for s, b, q, m in TINY_CELLS],))


@pytest.fixture(scope="module")
def tiny_dry():
    return {s: dryrun.run_cell("tiny-relu", s, mesh_shape=(2, 2), batch=b,
                               seq=q, microbatches=m, extrapolate=False)
            for s, b, q, m in TINY_CELLS}


@pytest.mark.parametrize("i", range(len(TINY_CELLS)),
                         ids=[c[0] for c in TINY_CELLS])
def test_tiny_dry_run_equals_a_real_gloo_run(tiny_real, tiny_dry, i):
    shape = TINY_CELLS[i][0]
    dry = tiny_dry[shape]
    real = tiny_real()[0][i]  # rank 0: the dry run's rank
    assert dry["collectives_by_axis"] == real["axes"]
    assert dry["flops_per_chip"] == real["flops"] > 0
    assert dry["arg_bytes"] == real["state"]
    assert dry["fits"] and dry["peak_bytes_per_chip"] >= dry["arg_bytes"]
    if shape == "train_4k":
        # 1 + 2·L·nmb layer gathers, L·nmb + 1 reduce-scatters, the loss's
        # sum a microbatch and the replicated leaves' sum: over "data"
        assert real["axes"]["data"]["count"] == 1 + 8 + 5 + 2 + 1


def test_tiny_train_flops_equal_the_reference_hlo_cost():
    ref = subproc.run_forced_devices("""
        import dataclasses
        from repro.configs import get_config, SHAPES, TrainConfig
        from repro.launch import specs, hlo_cost
        from repro.launch.mesh import _make_mesh
        cfg = get_config("tiny-relu")
        shape = dataclasses.replace(SHAPES["train_4k"], global_batch=8,
                                    seq_len=32, num_microbatches=2)
        mesh = _make_mesh((2, 2), ("data", "model"))
        with mesh:
            jitted, args = specs.build_train(cfg, shape, mesh, TrainConfig(
                num_microbatches=2, remat_policy="minimal"))
            compiled = jitted.lower(*args).compile()
        print("FLOPS", hlo_cost.CostModel(compiled.as_text()).flops)
    """, devices=4, timeout=200)
    want = float(ref.split("FLOPS")[-1].split()[0])
    got = dryrun.run_cell("tiny-relu", "train_4k", mesh_shape=(2, 2),
                          batch=8, seq=32, microbatches=2,
                          extrapolate=False)["flops_per_chip"]
    assert got == pytest.approx(want, rel=0, abs=0)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_extrapolated_counts_equal_a_full_run(shape):
    kw = dict(mesh_shape=(2, 2), batch=8, seq=32, layers=4,
              microbatches=4 if shape == "train_4k" else 0)
    full = dryrun.run_cell("tiny-relu", shape, extrapolate=False, **kw)
    fit = dryrun.run_cell("tiny-relu", shape, extrapolate=True, **kw)
    assert "extrapolated_from" in fit and "extrapolated_from" not in full
    for k in ("flops_per_chip", "wire_bytes_per_chip", "collectives",
              "collective_counts", "collectives_by_axis", "arg_bytes"):
        assert fit[k] == full[k], k
    assert fit["bytes_per_chip"] == pytest.approx(full["bytes_per_chip"],
                                                  rel=1e-4)
    # the peak is fitted linear in L from 1 and 2 layers: at this tiny
    # width the place of the peak moves with the depth (at qwen3-4b's
    # full train cell the fit came within 512 B of a full run)
    assert fit["peak_bytes_per_chip"] == pytest.approx(
        full["peak_bytes_per_chip"], rel=0.1)


def _block_bytes(shape, spec, mesh, itemsize):
    n = itemsize
    for d, a in zip(shape, spec):
        n *= d // (rules.axis_block(mesh, a)[1] if a is not None else 1)
    return -(-n // 512) * 512


def test_qwen3_decode_cell_holds_the_rules_shard_sizes():
    rec = dryrun.run_cell("qwen3-4b", "decode_32k")
    assert "error" not in rec and rec["fits"]
    cfg = get_config("qwen3-4b")
    mesh = mesh_lib.Mesh(shape={"data": 16, "model": 16},
                         coords={"data": 0, "model": 0})
    from repro_torch.launch import specs
    from repro_torch.tree import flatten
    whole = specs.params_spec(cfg)
    want = 0
    for path_leaf in _paths(whole):
        path, leaf = path_leaf
        spec = rules.param_pspec(path, tuple(leaf.shape), mesh.model_row(),
                                 "serve")
        want += _block_bytes(leaf.shape, spec, mesh.model_row(), 2)
    cache = specs.cache_specs(cfg, dryrun_shape("decode_32k"))
    for leaf in flatten(cache):
        want += _block_bytes(leaf.shape, rules.cache_pspec(
            tuple(leaf.shape), mesh), mesh, 2)
    want += 2 * 512  # the rank's tokens and positions
    assert rec["arg_bytes"] == want
    assert rec["collectives_by_axis"]["model"]["count"] > 0
    assert rec["collectives_by_axis"]["data"]["count"] == 0


def dryrun_shape(name):
    from repro_torch.configs import SHAPES
    return SHAPES[name]


def _paths(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p, v


def test_launchers_pod_paths_print_the_account(capsys):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    tserve.main(["--arch", "tiny-relu", "--dry-run"])
    out = capsys.readouterr().out
    assert "decode_32k step built for mesh 16x16 (rank 0 of 256" in out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["fits"] and rec["peak_bytes_per_chip"] > rec["arg_bytes"] > 0
    ttrain.main(["--arch", "tiny-relu", "--dry-run", "--shape",
                 "train_4k", "--microbatches", "2"])
    out = capsys.readouterr().out
    assert "train step built for mesh 16x16" in out
    assert json.loads(out.strip().splitlines()[-1])["microbatches"] == 2
    with pytest.raises(NotImplementedError, match="--dry-run"):
        ttrain.main(["--arch", "tiny-relu"])


# -- the FSDP step on a pod mesh ----------------------------------------------


@pytest.fixture(scope="module")
def pod_runs():
    jcfg, jp, toks = _ref_case("tiny-relu", 0, (8, 16))
    get = _group(tr.pod_step, 8, ((jcfg.to_json(), _np(jp), toks), 2))
    return get, _reference_mean_grads(jcfg, jp, toks, "minimal")


def test_fsdp_step_on_a_pod_mesh_equals_one_device(pod_runs):
    """(2, 2, 2) ("pod", "data", "model"): the params split over "data"
    within a pod and replicated over "pod", the batch over pod x data;
    the step's loss, every rank's gradient blocks and the grad norm are
    the reference's single-device f32 ``value_and_grad``'s, and each
    layer reduction and the step-long one add a sum over the pods."""
    get, (wl, wg) = pod_runs
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in wg)))
    for got in get():
        for loss in (got["grad_loss"], got["loss"]):
            assert abs(loss - wl) <= 1e-5 * abs(wl), (loss, wl)
        _hold_blocks(got, wg, "pod")
        assert got["grad_norm"] == pytest.approx(norm, rel=1e-5)
        assert got["step_ok"] == 1.0
        # 17 data collectives of a (2, 2) step, + 2 layers x 2
        # microbatches and the step-long reduction summed over the pods
        assert got["data"] == 17 + 5


def test_sp_collectives_are_each_others_backward():
    """On (1, 2): reduce_scatter_last's backward gathers, all_gather_last's
    reduce-scatters (each rank's objective its own), with ``whole_grad``
    takes the rank's chunk of a gradient whole on every rank, and
    split_last's backward gathers: each value and gradient is one
    device's."""
    world, seed = 2, 5
    got = comm.spawn(tr.sp_collectives, world, timeout=120,
                     args=(seed,), device="cpu")
    rng = np.random.RandomState(seed)
    xs = rng.randn(world, 3, 2 * world).astype(np.float32)
    cs = rng.randn(world, 3, 2 * world).astype(np.float32)
    full = xs.sum(0)
    gathered = np.concatenate([xs[r][:, 2 * r:2 * r + 2]
                               for r in range(world)], -1)
    for r, g in enumerate(got):
        sl = slice(2 * r, 2 * r + 2)
        y, dx = g["reduce_scatter_last"]
        np.testing.assert_allclose(y, full[:, sl], rtol=0, atol=1e-6)
        np.testing.assert_allclose(dx, cs[0], rtol=0, atol=1e-6)
        y, dx = g["split_last"]
        np.testing.assert_array_equal(y, xs[r][:, sl])
        np.testing.assert_allclose(dx, cs[0], rtol=0, atol=1e-6)
        for op, want in (("all_gather_last", cs.sum(0)[:, sl]),
                         ("all_gather_whole", cs[0][:, sl])):
            y, dx = g[op]
            np.testing.assert_array_equal(y, gathered)
            np.testing.assert_allclose(dx, want, rtol=0, atol=1e-6)


# the smoke configs whose attention adds qk-norm (Qwen3) or QKV biases
# (Qwen2) to the GQA split over d_model
GQA_SMOKE = ("qwen3-4b", "qwen2-7b")


@pytest.fixture(scope="module")
def gqa_smoke():
    from repro.configs import smoke_config as jsmoke
    built = {}
    for arch in GQA_SMOKE:
        jcfg = jsmoke(arch).replace(compute_dtype="float32")
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
        toks = np.random.RandomState(2).randint(0, jcfg.vocab_size,
                                                (2, 8)).astype(np.int32)
        built[arch] = (jcfg, jp, toks)
    get = _group(tr.legacy_generates, 4, ([
        (jcfg.to_json(), _np(jp), toks, MAX_NEW)
        for jcfg, jp, toks in built.values()],))
    want = [JServeEngine(jcfg, jp, max_len=32).generate(
        {"tokens": jnp.asarray(toks)}, max_new=MAX_NEW)
        for jcfg, jp, toks in built.values()]
    return get, want


@pytest.mark.parametrize("i", range(len(GQA_SMOKE)), ids=GQA_SMOKE)
def test_gqa_legacy_with_qk_norm_and_bias_equals_reference(gqa_smoke, i):
    get, want = gqa_smoke
    for r in get():
        tokens, logprobs = r[i]
        np.testing.assert_array_equal(tokens, np.asarray(want[i].tokens))
        np.testing.assert_allclose(logprobs, np.asarray(want[i].logprobs),
                                   rtol=0, atol=1e-5)
