"""The FSDP + TP step (``repro_torch.train.fsdp``) on a (2, 2, 2) ("pod",
"data", "model") mesh of 8 gloo ranks on the CPU, in the two layouts the
production plan's last pod cells take, against the reference's
single-device f32 ``jax.value_and_grad`` of ``lm_loss`` on the same
converted params and batch (jitted, microbatch by microbatch, the mean
taken), at 2 microbatches:

* (i) tiny-moe, its experts' d_model split over ("pod", "data") by the
  train rules: gathered and reduce-scattered over the 4 ranks of the pod ×
  data column. 8 rows of 64 tokens: each rank holds one row, one whole
  routing group (``moe_group_size`` 64).
* (ii) tiny-relu with 2 rows a microbatch over the 4 data rows of pod ×
  data: the rows split over "data" within each pod, both pods computing
  the same rows; with Megatron-SP residuals.
* (iii) tiny-moe likewise (its pod × data gradient sums divided by the
  pod count), with Megatron-SP residuals.

Each case holds the loss (within 1e-5 relative), every rank's gradient
blocks (each within 1e-5 · max |g| of its leaf, ``_hold_blocks``), the
train step's grad norm (1e-5 relative) and ``step_ok``, and its
collectives a step against the module note's counts: on the data axis
1 + 2·g·L·nmb all-gathers, g·L·nmb + 1 reduce-scatters, nmb loss sums,
one sum of the replicated leaves and, where the rows split over pod ×
data, L·nmb + 1 pod sums (none where the pods repeat the rows).

The dry run (``launch/dryrun.py``) of tiny-relu's train cell on (2, 2, 2)
counts the reference's ``hlo_cost`` FLOPs of its compiled step on 8
forced devices exactly where a microbatch's rows split over pod × data.
With 2 rows a microbatch the reference's GSPMD also splits the tokens of
most products over the otherwise idle "pod" axis (its forward
projections at half, its backward at 0.57x), which the port's repeated
rows compute whole on each pod: there the dry run counts one row's work
a chip, as at 4 rows, and the reference fewer.

One rank group serves every case (module fixture)."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import registry as jreg
from repro.train import step as jstep
from repro_torch.launch import dryrun
from repro_torch.train.fsdp import microbatch_rows

import subproc
import torch_ranks as tr
from test_torch_plan import _hold_blocks

PODS = 2
NMB = 2
# (name, arch, rows, tokens a row, Megatron-SP residuals)
CASES = (("moe-experts-over-pod-data", "tiny-moe", 8, 64, False),
         ("relu-rows-repeated-over-pods", "tiny-relu", 4, 16, True),
         ("moe-rows-repeated-over-pods", "tiny-moe", 4, 64, True))


def _case(arch, rows, seq, sp, seed):
    jcfg = jget_config(arch).replace(compute_dtype="float32",
                                     sp_residuals=sp)
    jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, jcfg.vocab_size,
                                   (rows, seq)).astype(np.int32),
             # rows keep unequal shares, so the rows' counts differ
             "loss_mask": (rng.rand(rows, seq) < np.linspace(
                 0.2, 0.9, rows)[:, None]).astype(np.float32)}
    return jcfg, jp, batch


def _reference_grads(jcfg, jp, batch):
    """The reference's mean loss and mean gradient leaves over ``NMB``
    microbatches, ``value_and_grad`` of ``lm_loss`` jitted once."""
    fn = jax.jit(jax.value_and_grad(lambda p, mb: jstep.lm_loss(
        p, mb, jcfg, remat_policy="minimal")[0]))
    b = batch["tokens"].shape[0] // NMB
    loss, grads = 0.0, None
    for i in range(NMB):
        l, g = fn(jp, {k: jnp.asarray(v[i * b:(i + 1) * b])
                       for k, v in batch.items()})
        loss += float(l)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return loss / NMB, [np.asarray(x) / NMB for x in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def reference_flops():
    """The reference's compiled FLOPs at 8 and 4 rows (2 microbatches),
    each compiled in a process of its own while the ranks run."""
    pool = ThreadPoolExecutor(2)
    futs = [pool.submit(_reference_flops, b) for b in (8, 4)]
    pool.shutdown(wait=False)
    return lambda: [f.result() for f in futs]


@pytest.fixture(scope="module")
def pod_runs(reference_flops):
    built = [_case(arch, rows, seq, sp, i)
             for i, (_, arch, rows, seq, sp) in enumerate(CASES)]
    get = tr.group(tr.pod_steps, 8, ([
        (jcfg.to_json(), jax.tree.map(np.asarray, jp), batch, NMB)
        for jcfg, jp, batch in built], PODS))
    want = [_reference_grads(jcfg, jp, batch) for jcfg, jp, batch in built]
    return get, want


def _data_collectives(moe: bool, repeated: bool, L: int = 2) -> tuple:
    """(data-axis, pod-axis) collectives a step on (2, 2, 2) by the module
    note: g data groups of more than one rank a layer (the pod × data
    column joins "data" within the pod in an MoE layer)."""
    g = 2 if moe else 1
    pod = 0 if repeated else L * NMB + 1
    return (1 + 2 * g * L * NMB) + (g * L * NMB + 1) + NMB + 1 + pod, pod


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_pod_step_equals_one_device(pod_runs, i):
    get, want = pod_runs
    name, arch, rows, _, _ = CASES[i]
    wl, wg = want[i]
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in wg)))
    data, pod = _data_collectives(arch == "tiny-moe",
                                  rows // NMB < PODS * 2)
    ranks = get()
    assert len(ranks) == 8
    for got in (r[i] for r in ranks):
        for loss in (got["grad_loss"], got["loss"]):
            assert abs(loss - wl) <= 1e-5 * abs(wl), (name, loss, wl)
        _hold_blocks(got, wg, name)
        assert got["grad_norm"] == pytest.approx(norm, rel=1e-5)
        assert got["step_ok"] == 1.0
        assert (got["data"], got["pod"]) == (data, pod), name


def test_moe_expert_blocks_split_over_pod_and_data(pod_runs):
    """Case (i)'s expert leaves are cut over the 4 ranks of pod × data
    (and "model"); its attention leaves over "data" within the pod."""
    get, _ = pod_runs
    got = get()[0][0]
    specs = dict(zip(range(len(got["specs"])), got["specs"]))
    assert any(("pod", "data") in s for s in specs.values())
    assert any("data" in s for s in specs.values())


def _reference_flops(batch: int) -> float:
    ref = subproc.run_forced_devices(f"""
        import dataclasses
        from repro.configs import get_config, SHAPES, TrainConfig
        from repro.launch import specs, hlo_cost
        from repro.launch.mesh import _make_mesh
        cfg = get_config("tiny-relu")
        shape = dataclasses.replace(SHAPES["train_4k"], global_batch={batch},
                                    seq_len=32, num_microbatches=2)
        mesh = _make_mesh((2, 2, 2), ("pod", "data", "model"))
        with mesh:
            jitted, args = specs.build_train(cfg, shape, mesh, TrainConfig(
                num_microbatches=2, remat_policy="minimal"))
            compiled = jitted.lower(*args).compile()
        print("FLOPS", hlo_cost.CostModel(compiled.as_text()).flops)
    """, devices=8, timeout=200)
    return float(ref.split("FLOPS")[-1].split()[0])


def _dry_flops(batch: int) -> float:
    return dryrun.run_cell("tiny-relu", "train_4k", mesh_shape=(2, 2, 2),
                           batch=batch, seq=32, microbatches=2,
                           extrapolate=False)["flops_per_chip"]


def test_pod_train_flops_equal_the_reference_hlo_cost(reference_flops):
    """4 rows a microbatch over the 4 data rows of pod × data: equal to
    the reference's count, to the FLOP. 2 rows a microbatch: the port
    counts the same one row a chip, the reference fewer (module note)."""
    full, repeated = reference_flops()
    assert _dry_flops(8) == pytest.approx(full, rel=0, abs=0)
    assert _dry_flops(4) == pytest.approx(full, rel=0, abs=0)
    assert repeated < full


@pytest.mark.parametrize("b, nmb, shape, want", [
    (8, 2, {"pod": 2, "data": 2, "model": 2}, (4, False)),
    (4, 2, {"pod": 2, "data": 2, "model": 2}, (2, True)),
    (256, 16, {"pod": 2, "data": 16, "model": 16}, (16, True)),
    (256, 8, {"pod": 2, "data": 16, "model": 16}, (32, False)),
    (4, 2, {"pod": 2, "data": 1, "model": 2}, (2, False)),
    (8, 4, {"pod": 2, "data": 2, "model": 1}, (2, True)),
    (8, 2, {"data": 2, "model": 2}, (2, False)),
    (6, 2, {"pod": 2, "data": 2, "model": 2}, None),
    (2, 2, {"pod": 2, "data": 2, "model": 2}, None),
    (12, 2, {"pod": 2, "data": 2, "model": 2}, None),
    (6, 2, {"data": 2, "model": 2}, None)])
def test_microbatch_rows(b, nmb, shape, want):
    """The slices split over pod × data where it divides their rows, else
    over "data" within each pod (fewer rows than pod × data), else the
    step raises, naming the rows and the axes."""
    if want is None:
        with pytest.raises(ValueError, match="data rows"):
            microbatch_rows(b, nmb, shape)
    else:
        assert microbatch_rows(b, nmb, shape) == want


def test_dry_run_takes_a_pod_mesh_triple_and_the_row_rule():
    rec = dryrun.run_cell("tiny-moe", "train_4k", mesh_shape=(2, 2, 2),
                          batch=4, seq=64, microbatches=2, extrapolate=False)
    assert rec["mesh"] == "2x2x2" and rec["n_chips"] == 8
    assert rec["collectives_by_axis"]["pod"]["count"] == 0
    assert rec["collectives_by_axis"]["data"]["count"] == _data_collectives(
        True, True)[0]
    with pytest.raises(ValueError, match="neither"):
        dryrun.run_cell("tiny-relu", "train_4k", mesh_shape=(2, 2, 2),
                        batch=6, seq=32, microbatches=2, extrapolate=False)


@pytest.mark.parametrize("spec", [(None, ("pod", "data"), "model"),
                                  ("data", None, "model"),
                                  ("model", "data", None)])
def test_leaf_from_pod_mesh_blocks(spec):
    """``rules.Sharding.full`` puts a leaf back together from the blocks of
    every rank of a (2, 2, 2) mesh in rank order (the sharded checkpoint's
    save): the rank's coordinates read major axis first, "pod" included."""
    import torch

    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import rules
    shape = {"pod": 2, "data": 2, "model": 2}
    leaf = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    blocks = []
    for r in range(8):
        coords = {"pod": r // 4, "data": r // 2 % 2, "model": r % 2}
        mesh = Mesh(shape=shape, coords=coords, axis_names=tuple(shape))
        blocks.append(rules.Sharding(mesh, spec).block(leaf))
    assert torch.equal(rules.Sharding(mesh, spec).full(torch.stack(blocks)),
                       leaf)
