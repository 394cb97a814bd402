"""The port's FSDP + TP train step (``repro_torch.train.fsdp``) against the
JAX reference on the CPU, at f32, on gloo ranks (``tests/torch_ranks.py``),
from the same params (the reference's init, converted through numpy) and
the same numpy batches.

* **The reference's 4 x 2 case.** ``repro.launch.specs.build_train`` on a
  forced 8-device (4, 2) mesh (``tests/subproc.py``) with the settings of
  ``tests/test_distributed.py::test_tiny_pjit_train_on_4x2_mesh``
  (tiny-relu, d_ff 256, vocab 512, seq 64, batch 8, 2 microbatches,
  remat "minimal", lr 1e-3, warmup 1 of 4 steps) against the port's step
  on 8 ranks of a (4, 2) mesh over 3 steps, each step run from the
  reference's state before it: losses and grad norms within 1e-5
  relative, lr and step_ok equal, the params after it within 2·lr of the
  reference's (an Adam update is close to lr·sign(g), so a gradient entry
  within rounding of zero moves its parameter by up to 2·lr in one and
  not the other) with at most 1 in 10^4 elements beyond 1e-5
  (``tests/test_torch_ddp.py``'s convention). The same 3 steps run free
  from the first state: the losses within 1e-5, step 1's grad norm too,
  the later grad norms within ``FREE_NORM_TOL`` (1e-4), the params after
  step n within 2·lr·n with the median within 1e-6. The witness: the
  free run on (4, 1) holds 1e-5 for every step, on (1, 2) it drifts as
  on (4, 2) (the f32 partial sums over "model" round near-zero gradient
  entries otherwise, their Adam updates, close to lr·sign(g), differ,
  and the next step's norm follows; the reference's GSPMD run gives one
  device's numbers to the last bit here). Every rank reports the same
  metrics.
* **The layout.** Each rank's blocks of the params and of both moments
  have the train specs' shapes (``rules.local_block`` of the whole leaf);
  ``wd`` (ffn over "model", embed over "data") is split over all 8 ranks,
  1/8 each.
* **Step-1 gradients** (unclipped mean over the microbatches) on a (2, 2)
  mesh, with a ``loss_mask`` that differs across the data rows, against
  ``jax.value_and_grad`` of the reference's ``lm_loss`` summed over the
  microbatches and divided by their count on one device: each leaf within
  1e-5 · max |g| of it, the loss within 1e-5 relative; for tiny-relu
  ("minimal" and "full" remat), tiny-opt (tied embeddings: the embedding
  over (model, data)) and tiny-moe (drop-free), and tiny-relu on (1, 4),
  whose 2 kv heads do not divide the model axis (``wk``/``wv`` whole on
  every model rank, their d_model rows over "data").
* **One rank.** The step on a (1, 1) mesh equals the port's
  ``make_train_step`` over 2 steps: metrics within 1e-6 relative, params
  within 1e-6.
* **The autograd collectives** (``comm``) on 2 ranks: reduce, copy,
  gather_last and the data-axis reduce, forward values and the gradient
  of each rank's input against the one-device function's within 1e-6;
  the data-axis all-gather and reduce-scatter against numpy.
* ``TrainConfig(zero_stage=3)`` builds (``tests/test_torch_ddp.py``)."""
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import registry as jreg
from repro.train import step as jstep
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import comm, rules
from repro_torch.train import fsdp
from repro_torch.tree import flatten

import torch_ranks as tr
from subproc import run_forced_devices

torch.set_num_threads(1)

TC = dict(learning_rate=1e-3, num_microbatches=2, remat_policy="minimal",
          total_steps=4, warmup_steps=1)
STEPS = 3
# The free run's grad norms after step 1 on a mesh with a model axis,
# relative: 4.57e-5 at step 3 on (4, 2) and (1, 2), 3.1e-6 on (4, 1)
# (test_free_run_drift_is_the_model_axis prints them).
FREE_NORM_TOL = 1e-4

_REFERENCE = """
import pickle, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, TrainConfig
from repro.configs.base import ShapeConfig
from repro.launch import specs as specs_lib
from repro.models import registry
from repro.optim import adamw
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = get_config("tiny-relu").replace(d_ff=256, vocab_size=512,
                                      compute_dtype="float32")
shape = ShapeConfig("t", "train", 64, 8, num_microbatches=2)
tc = TrainConfig(**TC)
rng = np.random.RandomState(1)
batches = [{"tokens": rng.randint(0, cfg.vocab_size, (8, 64)).astype(np.int32)}
           for _ in range(STEPS)]
with mesh:
    jitted, _ = specs_lib.build_train(cfg, shape, mesh, tc)
    params = registry.get_family(cfg).init_params(jax.random.PRNGKey(0), cfg)
    out = {"params0": jax.tree.map(np.asarray, params), "batches": batches,
           "cfg": cfg.to_json(), "metrics": [], "params": [],
           "wd_devices": None}
    opt = adamw.init_opt_state(params)
    out["states"] = []
    for b in batches:
        out["states"].append(jax.tree.map(
            np.asarray, (params, (opt.step, opt.m, opt.v))))
        params, opt, m = jitted(params, opt,
                                {k: jnp.asarray(v) for k, v in b.items()})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["params"].append([np.asarray(x) for x in jax.tree.leaves(params)])
    out["wd_devices"] = len(params["layers"]["ffn"]["wd"].sharding.device_set)
pickle.dump(out, open(PATH, "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def reference_run():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fsdp.pkl")
        out = run_forced_devices(
            f"PATH = {path!r}\nTC = {TC!r}\nSTEPS = {STEPS}\n" + _REFERENCE,
            devices=8)
        assert "OK" in out
        with open(path, "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def port_run(reference_run):
    case = dict(cfg=reference_run["cfg"], params=reference_run["params0"],
                tc=TC, batches=reference_run["batches"],
                states=reference_run["states"])
    return comm.spawn(tr.fsdp_steps, 8, timeout=400, args=(4, case),
                      device="cpu")


def test_fsdp_step_matches_reference_build_train(reference_run, port_run):
    want = reference_run
    assert want["wd_devices"] == 8
    for got in port_run:
        assert len(got["metrics"]) == len(got["forced"]) == STEPS
        for n, (g, f, w) in enumerate(zip(got["metrics"], got["forced"],
                                          want["metrics"]), 1):
            assert set(g) == {"loss", "grad_norm", "lr", "step_ok"}
            # each step from the reference's state before it, and the
            # free run's first step
            for k in ("loss", "grad_norm"):
                assert abs(f[k] - w[k]) <= 1e-5 * abs(w[k]), (n, k, f, w)
                # the free run: see FREE_NORM_TOL
                tol = FREE_NORM_TOL if k == "grad_norm" and n > 1 else 1e-5
                assert abs(g[k] - w[k]) <= tol * abs(w[k]), (n, k, g, w)
            for m in (g, f):
                assert m["lr"] == pytest.approx(w["lr"], rel=1e-7)
                assert m["step_ok"] == w["step_ok"] == 1.0
        print("free run:", [(m["loss"], m["grad_norm"])
                            for m in got["metrics"]],
              "reference:", [(m["loss"], m["grad_norm"])
                             for m in want["metrics"]])
        assert got["metrics"] == port_run[0]["metrics"]
        assert got["forced"] == port_run[0]["forced"]
    lr = TC["learning_rate"]
    for n, (fp, gp, wp) in enumerate(zip(port_run[0]["forced_params"],
                                         port_run[0]["params"],
                                         want["params"]), 1):
        forced, free = (np.concatenate([np.abs(g - w).ravel()
                                        for g, w in zip(p, wp)])
                        for p in (fp, gp))
        assert forced.max() <= 2 * lr, (n, forced.max())
        assert (forced > 1e-5).sum() <= 1e-4 * forced.size, (n, forced)
        # the free run's drift: each step's lr·sign flips feed the next
        assert free.max() <= 2 * lr * n, (n, free.max())
        assert np.median(free) <= 1e-6, (n, np.median(free))
        print(f"after step {n}: forced {(forced > 1e-5).sum()}, free "
              f"{(free > 1e-5).sum()} of {free.size} elements beyond 1e-5")


@pytest.mark.parametrize("data,model", [(4, 1), (1, 2)])
def test_free_run_drift_is_the_model_axis(reference_run, data, model):
    """The witness for FREE_NORM_TOL: the same 3 free steps on a mesh
    without a model axis stay within 1e-5 of the reference's losses and
    grad norms; with one, the losses do, and the grad norms after step 1
    are held at FREE_NORM_TOL (step 3's drifts as on (4, 2))."""
    want = reference_run
    case = dict(cfg=want["cfg"], params=want["params0"], tc=TC,
                batches=want["batches"])
    ranks = comm.spawn(tr.fsdp_steps, data * model, timeout=300,
                       args=(data, case), device="cpu")
    for got in ranks:
        assert got["metrics"] == ranks[0]["metrics"]
    rel = [{k: abs(g[k] - w[k]) / abs(w[k]) for k in ("loss", "grad_norm")}
           for g, w in zip(ranks[0]["metrics"], want["metrics"])]
    print((data, model), rel)
    for n, r in enumerate(rel, 1):
        assert r["loss"] <= 1e-5, (n, r)
        tol = 1e-5 if model == 1 or n == 1 else FREE_NORM_TOL
        assert r["grad_norm"] <= tol, (n, r)


def _mesh(data, model, r):
    return Mesh(shape={"data": data, "model": model},
                coords={"data": r // model, "model": r % model})


def test_rank_blocks_are_the_train_specs(reference_run, port_run):
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig.from_json(reference_run["cfg"])
    shapes = fsdp.param_shapes(cfg)
    paths = []

    def walk(t, pre):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], pre + k + "/")
            else:
                paths.append(pre + k)
    walk(shapes, "")
    for r, got in enumerate(port_run):
        mesh = _mesh(4, 2, r)
        want = [tuple(rules.local_block(torch.empty(s.shape, device="meta"),
                                        sh.spec, mesh).shape)
                for s, sh in zip(flatten(shapes),
                                 flatten(fsdp.state_shardings(
                                     cfg, mesh)[0]))]
        for kind in got["shapes"]:  # params, m, v
            assert [tuple(s) for s in kind] == want
        wd = paths.index("layers/ffn/wd")
        whole = flatten(shapes)[wd].shape
        block = got["shapes"][0][wd]
        assert np.prod(block) * 8 == np.prod(whole), (block, whole)
    # every rank holds its own block of wd: the 8 blocks tile it
    wd_spec = rules.param_pspec("layers/ffn/wd", tuple(whole), _mesh(4, 2, 0),
                                "train")
    assert wd_spec == (None, "model", "data")
    seen = {rules.block_slices(wd_spec, tuple(whole), {"data": 4, "model": 2},
                               {"data": r // 2, "model": r % 2})
            for r in range(8)}
    assert len(seen) == 8


def _batches(vocab, seed, mask):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, vocab, (8, 64)).astype(np.int32)
    out = {"tokens": tok}
    if mask:
        # rows differ in how much they keep, so the data rows' counts differ
        keep = np.linspace(0.15, 0.95, 8)[:, None]
        out["loss_mask"] = (rng.rand(8, 64) < keep).astype(np.float32)
    return [out]


def _reference_grads(cfg, params, batch, nmb, remat):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    b = jb["tokens"].shape[0] // nmb
    loss, grads = 0.0, None
    for i in range(nmb):
        mb = {k: v[i * b:(i + 1) * b] for k, v in jb.items()}
        (l, _), g = jax.value_and_grad(
            lambda p: jstep.lm_loss(p, mb, cfg, remat_policy=remat),
            has_aux=True)(params)
        loss = loss + float(l)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return loss / nmb, [np.asarray(x) / nmb for x in jax.tree.leaves(grads)]


GRAD_CASES = [("tiny-relu", (2, 2), "minimal"), ("tiny-relu", (2, 2), "full"),
              ("tiny-relu", (2, 2), "none"), ("tiny-relu", (2, 2), "save_ars"),
              ("tiny-opt", (2, 2), "minimal"), ("tiny-moe", (2, 2), "minimal"),
              ("tiny-relu", (1, 4), "minimal")]


def _grad_case(arch, remat):
    jcfg = jget_config(arch).replace(compute_dtype="float32")
    jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(3), jcfg)
    batches = _batches(jcfg.vocab_size, 4, mask=True)
    return jcfg, jp, dict(cfg=jcfg.to_json(),
                          params=jax.tree.map(np.asarray, jp),
                          tc=dict(TC, remat_policy=remat), batches=batches)


@pytest.fixture(scope="module")
def grad_runs():
    """Each mesh's cases in one rank group: {case: the ranks' results}."""
    out = {}
    for mesh in sorted({m for _, m, _ in GRAD_CASES}):
        cases = [c for c in GRAD_CASES if c[1] == mesh]
        D, M = mesh
        ranks = comm.spawn(tr.fsdp_grads, D * M, timeout=300,
                           args=(D, [_grad_case(a, r)[2]
                                     for a, _, r in cases]), device="cpu")
        for i, c in enumerate(cases):
            out[c] = [got[i] for got in ranks]
    return out


@pytest.mark.parametrize("arch,mesh,remat", GRAD_CASES)
def test_step1_grads_with_uneven_masks_match_reference(arch, mesh, remat,
                                                       grad_runs):
    jcfg, jp, case = _grad_case(arch, remat)
    ranks = grad_runs[(arch, mesh, remat)]
    wl, wg = _reference_grads(jcfg, jp, case["batches"][0],
                              TC["num_microbatches"], remat)
    for got in ranks:
        assert abs(got["loss"] - wl) <= 1e-5 * abs(wl), (got["loss"], wl)
    assert len(ranks[0]["grads"]) == len(wg)
    for g, w in zip(ranks[0]["grads"], wg):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))


def test_one_rank_equals_make_train_step():
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import flatten
    cfg = get_config("tiny-relu").replace(compute_dtype="float32")
    batches = _batches(cfg.vocab_size, 5, mask=True) * 2
    params = registry.get_family(cfg).init_params(cfg, seed=0, device="cpu",
                                                  dtype=torch.float32)
    opt = adamw.init_opt_state(params)
    step = make_train_step(cfg, TrainConfig(**TC))
    want = []
    for b in batches:
        params, opt, m = step(params, opt, {k: torch.as_tensor(v)
                                            for k, v in b.items()})
        want.append({k: float(v) for k, v in m.items()})
    case = dict(cfg=cfg.to_json(), tc=TC, batches=batches)
    got, = comm.spawn(tr.fsdp_steps, 1, timeout=200, args=(1, case),
                      device="cpu")
    for g, w in zip(got["metrics"], want):
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-12), (k, g, w)
    for g, w in zip(got["params"][-1], flatten(params)):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-6)


def _one_device(op, world, seed):
    """The forward value and each rank's input gradient of the one-device
    function ``collective_grads`` splits over the ranks."""
    rng = np.random.RandomState(seed)
    xs = torch.as_tensor(rng.randn(world, 3, 4).astype(np.float32))
    c = torch.as_tensor(rng.randn(3, 5 * world).astype(np.float32))
    ws = torch.as_tensor(rng.randn(world, 4, 5).astype(np.float32))
    if op == "copy":
        x = xs[0].clone().requires_grad_(True)
        y = x @ torch.cat(list(ws), 1)
        (y * c[:, :5 * world]).sum().backward()
        return [dict(y=y[:, 5 * r:5 * r + 5].detach().numpy(),
                     grad=x.grad.numpy()) for r in range(world)]
    x = xs.clone().requires_grad_(True)
    if op == "gather_last":
        y = torch.cat(list(x), -1)
        (y * c[:, :4 * world]).sum().backward()
    else:  # reduce, data_reduce: a sum over the ranks
        y = x.sum(0)
        (y * c[:, :4]).sum().backward()
    return [dict(y=y.detach().numpy(), grad=x.grad[r].numpy())
            for r in range(world)]


OPS = ["reduce", "copy", "gather_last", "data_reduce", "data_all_gather",
       "data_reduce_scatter"]


@pytest.fixture(scope="module")
def collective_runs():
    return comm.spawn(tr.collective_grads, 2, timeout=120, args=(OPS, 7),
                      device="cpu")


@pytest.mark.parametrize("op", OPS)
def test_autograd_collective_matches_one_device(op, collective_runs):
    world, seed = 2, 7
    ranks = [got[op] for got in collective_runs]
    xs = np.random.RandomState(seed).randn(world, 3, 4).astype(np.float32)
    flat = xs.reshape(world, -1)
    if op == "data_all_gather":
        for got in ranks:
            np.testing.assert_array_equal(got["y"], flat)
        return
    if op == "data_reduce_scatter":
        total = flat.sum(0)
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(got["y"], total[6 * r:6 * r + 6],
                                       rtol=0, atol=1e-6)
        return
    for got, want in zip(ranks, _one_device(op, world, seed)):
        np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["grad"], want["grad"], rtol=0,
                                   atol=1e-6)
