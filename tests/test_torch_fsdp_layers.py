"""The FSDP step's per-layer gather (``repro_torch.train.fsdp``, step 4 of
its module note) on gloo ranks, at f32, and the reference's compiled
schedule it follows.

* **The reference's schedule.** ``repro.launch.specs.build_train`` for
  tiny-relu at 8 layers on a forced (4, 2) mesh (``tests/subproc.py``),
  remat "minimal" and "none", 2 microbatches, compiled; its HLO read in
  the child: two ``while`` bodies (the forward's and the backward's layer
  loops) each all-gather over the data axis one layer of every layer leaf
  the train specs split over "data" (the port's per-layer columns, by
  element count); every other computation gathers only the token batch
  (s32) and the two vocabulary leaves (the port's step-long columns).
* **The port's schedule** on a (2, 2) mesh, tiny-relu at 2 and 6 layers,
  2 microbatches, each remat policy: a step issues 1 + 2·L·nmb
  all_gathers over "data" (``comm.STATS``), L·nmb layer reductions, one
  reduce_scatter of the step-long columns, one all-reduce of the leaves
  replicated over "data" and the loss's nmb sums; each layer gather
  carries one layer's column (counted here from the train specs, not
  from the step's layout); ``fsdp.GAUGE``'s peak is the same at both
  depths and at most two layers' columns, and nothing is left alive
  after the step.
* **The gradients** of those runs (unclipped mean over the microbatches,
  uneven loss masks over the data rows) against the port's one-device
  ``train.step.loss_and_grads`` summed over the microbatches and divided
  by their count, each leaf within 1e-5 · max |g| and the loss within
  1e-5 relative (``tests/test_torch_fsdp.py``'s tolerances; that file
  holds "none" and "save_ars" against the reference's)."""
import json
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry
from repro_torch.sharding import comm
from repro_torch.train import fsdp
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import flatten

import torch_ranks as tr
from subproc import run_forced_devices

torch.set_num_threads(1)

REMATS = ("none", "minimal", "full", "save_ars")
DEPTHS = (2, 6)
NMB = 2
TC = dict(learning_rate=1e-3, num_microbatches=NMB, total_steps=4,
          warmup_steps=1)


def _cfg(n_layers):
    return get_config("tiny-relu").replace(n_layers=n_layers,
                                           compute_dtype="float32")


def _batch(vocab):
    rng = np.random.RandomState(4)
    keep = np.linspace(0.15, 0.95, 8)[:, None]
    return {"tokens": rng.randint(0, vocab, (8, 64)).astype(np.int32),
            "loss_mask": (rng.rand(8, 64) < keep).astype(np.float32)}


CASES = [(n, remat) for n in DEPTHS for remat in REMATS]


@pytest.fixture(scope="module")
def schedule_runs():
    """{(n_layers, remat): the 4 ranks' ``tr.fsdp_schedule`` results} on
    (2, 2), every case in one rank group."""
    cases = [dict(cfg=_cfg(n).to_json(), tc=dict(TC, remat_policy=remat),
                  batches=[_batch(_cfg(n).vocab_size)]) for n, remat in CASES]
    ranks = comm.spawn(tr.fsdp_schedule, 4, timeout=300, args=(2, cases),
                       device="cpu")
    return {c: [got[i] for got in ranks] for i, c in enumerate(CASES)}


def _layer_bytes(cfg, D, M):
    """(one layer's leaves split over "data" under the train specs, whole
    along "data"; its other leaves), cut along "model", in f32 bytes."""
    mesh = Mesh(shape={"data": D, "model": M}, coords={"data": 0, "model": 0})
    split = whole = 0
    for s, sh in zip(flatten(fsdp.param_shapes(cfg)["layers"]),
                     flatten(fsdp.state_shardings(cfg, mesh)[0]["layers"])):
        n = math.prod(s.shape[1:]) * 4 // (M if "model" in sh.spec else 1)
        if "data" in sh.spec:
            split += n
        else:
            whole += n
    return split, whole


@pytest.mark.parametrize("n_layers,remat", CASES)
def test_collectives_and_gauge_per_step(n_layers, remat, schedule_runs):
    L = n_layers
    col, _ = _layer_bytes(_cfg(L), 2, 2)
    for got in schedule_runs[(L, remat)]:
        assert got["column_bytes"] == col
        assert got["gathers"] == [col] * (2 * L * NMB), got["gathers"]
        assert got["reductions"] == L * NMB
        # the entry gather, the layer gathers and reductions, the entry
        # leaves' reduce_scatter, the replicated leaves' all-reduce and
        # the loss's masked sum and count over "data" per microbatch
        assert got["data_count"] == (1 + 2 * L * NMB + L * NMB + 1 + 1
                                     + NMB), got["data_count"]
        assert 0 < got["peak"] <= 2 * col, (got["peak"], col)
        assert got["live"] == 0
        assert got["step_loss"] == got["loss"]


@pytest.mark.parametrize("remat", REMATS)
def test_gauge_peak_does_not_grow_with_depth(remat, schedule_runs):
    peaks = {n: {got["peak"] for got in schedule_runs[(n, remat)]}
             for n in DEPTHS}
    assert peaks[DEPTHS[0]] == peaks[DEPTHS[1]], peaks
    data_bytes = {n: schedule_runs[(n, remat)][0]["data_bytes"]
                  for n in DEPTHS}
    # the extra layers' traffic only: 2 gathers (compute dtype) and one
    # f32 reduction of one column each, per layer and microbatch, and
    # their replicated leaves in the step's all-reduce
    col, whole = _layer_bytes(_cfg(2), 2, 2)
    assert data_bytes[6] - data_bytes[2] == 4 * (NMB * 3 * col + whole), \
        data_bytes


@pytest.mark.parametrize("n_layers,remat", CASES)
def test_grads_match_one_device(n_layers, remat, schedule_runs):
    cfg = _cfg(n_layers)
    params = registry.get_family(cfg).init_params(
        cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab_size).items()}
    b = batch["tokens"].shape[0] // NMB
    loss, want = 0.0, None
    for i in range(NMB):
        l_i, g = loss_and_grads(params, {k: v[i * b:(i + 1) * b]
                                         for k, v in batch.items()}, cfg,
                                "none")
        loss += float(l_i)
        g = [x.numpy() for x in flatten(g)]
        want = g if want is None else [a + x for a, x in zip(want, g)]
    loss, want = loss / NMB, [x / NMB for x in want]
    ranks = schedule_runs[(n_layers, remat)]
    for got in ranks:
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss), (got["loss"],
                                                              loss)
    for g, w in zip(ranks[0]["grads"], want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))


_REFERENCE_HLO = """
import json, re
import numpy as np, jax
from repro.configs import get_config, TrainConfig
from repro.configs.base import ShapeConfig
from repro.launch import specs as specs_lib

def groups(text):
    if text.startswith("{"):
        return sorted(sorted(int(x) for x in g.split(",") if x)
                      for g in re.findall(r"\\{([\\d,]*)\\}", text[1:-1]))
    m = re.match(r"\\[([\\d,]+)\\]<=\\[([\\d,]+)\\](?:T\\(([\\d,]+)\\))?", text)
    out, dims = [int(x) for x in m.group(1).split(",")], \\
        [int(x) for x in m.group(2).split(",")]
    ids = np.arange(int(np.prod(dims))).reshape(dims)
    if m.group(3):
        ids = ids.transpose([int(x) for x in m.group(3).split(",")])
    return sorted(sorted(g) for g in ids.reshape(out).tolist())

def summary(txt):
    assert "all-gather-start" not in txt
    comps, cur = {}, None
    for line in txt.splitlines():
        head = re.match(r"^(ENTRY )?%?([\\w.\\-]+) .*\\{\\s*$", line)
        if head:
            cur = head.group(2)
            comps[cur] = dict(entry=bool(head.group(1)), gathers=[],
                              bodies=[])
            continue
        if cur is None or not line.startswith(" "):
            continue
        body = re.search(r" while\\(.*body=%?([\\w.\\-]+)", line)
        if body:
            comps[cur]["bodies"].append(body.group(1))
        if " all-gather(" in line:
            res = re.search(r"= (\\w+)\\[([\\d,]*)\\]", line)
            rg = re.search(r"replica_groups=(\\{[\\d,{}]*\\}|\\[[^ ]*)", line)
            dims = [int(x) for x in res.group(2).split(",") if x]
            comps[cur]["gathers"].append(
                [res.group(1), int(np.prod(dims)), groups(rg.group(1).rstrip(","))])
    return comps

mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = get_config("tiny-relu").replace(n_layers=8, d_ff=256, vocab_size=512,
                                      compute_dtype="float32")
shape = ShapeConfig("t", "train", 64, 8, num_microbatches=2)
out = {}
for remat in ("minimal", "none"):
    tc = TrainConfig(learning_rate=1e-3, num_microbatches=2,
                     remat_policy=remat, total_steps=4, warmup_steps=1)
    with mesh:
        jitted, args = specs_lib.build_train(cfg, shape, mesh, tc)
        out[remat] = summary(jitted.lower(*args).compile().as_text())
print("HLO " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_hlo():
    out = run_forced_devices(_REFERENCE_HLO, devices=8)
    line, = [l for l in out.splitlines() if l.startswith("HLO ")]
    return json.loads(line[4:])


@pytest.mark.parametrize("remat", ["minimal", "none"])
def test_reference_gathers_each_layer_inside_its_loops(remat, reference_hlo):
    comps = reference_hlo[remat]
    cfg = get_config("tiny-relu").replace(n_layers=8, d_ff=256,
                                          vocab_size=512,
                                          compute_dtype="float32")
    mesh = Mesh(shape={"data": 4, "model": 2}, coords={"data": 0, "model": 0})
    leaves = fsdp._layout(cfg, mesh)
    per_layer = sorted(math.prod(l.block[1:]) * 4 for l in leaves
                       if l.layer and l.data_dim is not None)
    step_long = sorted(math.prod(l.block) * 4 for l in leaves
                       if not l.layer and l.data_dim is not None)
    assert len(per_layer) == 7 and len(step_long) == 2
    data_groups = [[0, 2, 4, 6], [1, 3, 5, 7]]

    def data_f32(comp):
        return sorted(n for dt, n, g in comp["gathers"]
                      if dt == "f32" and g == data_groups)

    bodies = {b for c in comps.values() for b in c["bodies"]}
    loops = [name for name in bodies if data_f32(comps[name])]
    # the forward's and the backward's layer loop
    assert len(loops) == 2, loops
    for name in loops:
        assert data_f32(comps[name]) == per_layer, comps[name]["gathers"]
        assert all(dt == "f32" and g == data_groups
                   for dt, _, g in comps[name]["gathers"])
    entry, = [c for c in comps.values() if c["entry"]]
    outside = [g for name, c in comps.items() if name not in loops
               for g in c["gathers"]]
    assert sorted(n for dt, n, _ in outside if dt == "f32") == step_long
    assert all(dt in ("f32", "s32") for dt, _, _ in outside)
    assert any(dt == "s32" for dt, _, _ in outside)  # the token batch
    assert data_f32(entry) == step_long
