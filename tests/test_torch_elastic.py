"""Sharded checkpoints and the sequence-sharded decode attention of the
port on gloo ranks (``tests/torch_ranks.py``), against the JAX reference
on the CPU, at f32.

* **The reference's 8 -> 4 reshard**
  (``tests/test_distributed.py::test_elastic_checkpoint_reshard_8_to_4``):
  8 ranks of an (8, 1) mesh each hold one row of an (8, 8) leaf split
  over "data" and save step 5 (``CheckpointManager.save(shardings=)``);
  4 ranks of a (4, 1) mesh restore it (``restore(shardings=)``): each
  holds its 2 rows, exactly, and the extras come back. Also restored onto
  a (2, 1) mesh split over the other dim. Saved with and without
  ``async_save`` (the gather on the calling thread, the write in the
  background: a block changed after ``save`` returns is not in the step).
* **Across packages.** A (2, 2) FSDP train state (tiny-relu, params and
  OptState) saved sharded by the port loads in the reference's
  ``CheckpointManager.restore`` equal to the state put together in full;
  a state the reference saved restores onto a (2, 2) mesh of the port as
  each rank's train-spec blocks of it, exactly.
* **Resume on another mesh.** A (2, 2) FSDP run saved after step 2 and
  restored onto (1, 2) gives the uninterrupted run's step-3 loss and grad
  norm within 1e-5 relative.
* **Sequence-sharded decode.** ``common.decode_attention`` under a (2, 4)
  mesh, the caches split as ``rules.cache_pspec`` lays them out (b over
  "data", S over "model"), against the reference's unsharded
  ``decode_attention``: the reference's case (b 2, S 32, kvp 2, g 2, d 8,
  pos 20, so ranks 2 and 3 of each row hold no valid key), with a window
  of 6, and with positions on a slice boundary (7 and 8); within 1e-5,
  no NaN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.models import common as jcm
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import comm, rules
from repro_torch.train import fsdp
from repro_torch.tree import flatten

import torch_ranks as tr

torch.set_num_threads(1)

W = np.arange(64, dtype=np.float32).reshape(8, 8)


@pytest.fixture(scope="module")
def reshard(tmp_path_factory):
    """Step 5 saved by 8 ranks, without and with ``async_save``, into a
    directory each (one rank group), then restored by 4 ranks over the
    rows and by 2 over the columns: {async_save: (directory, 4 ranks'
    blocks, 2 ranks' blocks)}."""
    dirs = {a: str(tmp_path_factory.mktemp(f"reshard_{a}"))
            for a in (False, True)}
    comm.spawn(tr.elastic_save, 8, timeout=120,
               args=([(d, a) for a, d in dirs.items()], W), device="cpu")
    four = comm.spawn(tr.elastic_restore, 4, timeout=120,
                      args=([(d, ("data", None)) for d in dirs.values()],),
                      device="cpu")
    two = comm.spawn(tr.elastic_restore, 2, timeout=120,
                     args=([(d, (None, "data")) for d in dirs.values()],),
                     device="cpu")
    return {a: (d, [g[i] for g in four], [g[i] for g in two])
            for i, (a, d) in enumerate(dirs.items())}


@pytest.mark.parametrize("async_save", [False, True])
def test_reshard_8_to_4(reshard, async_save):
    d, four, two = reshard[async_save]
    for r, g in enumerate(four):
        np.testing.assert_array_equal(g["w"], W[2 * r:2 * r + 2])
        assert g["extras"] == {"step": 5}
        assert g["device"] == "cpu"
    # the same step onto a (2, 1) mesh split over the columns
    for r, g in enumerate(two):
        np.testing.assert_array_equal(g["w"], W[:, 4 * r:4 * r + 4])
    # the reference's manager reads the port's step whole
    want, extras = JManager(d, async_save=False).restore({"w": W})
    np.testing.assert_array_equal(np.asarray(want["w"]), W)
    assert extras == {"step": 5}


def _tiny():
    jcfg = jget_config("tiny-relu").replace(compute_dtype="float32")
    jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp


def _batches(vocab, n, seed=1):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, vocab, (8, 64)).astype(np.int32),
             "loss_mask": (rng.rand(8, 64) > 0.2).astype(np.float32)}
            for _ in range(n)]


TC = dict(learning_rate=1e-3, num_microbatches=2, remat_policy="minimal",
          total_steps=8, warmup_steps=1)


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    """3 FSDP steps of tiny-relu on (2, 2), the state saved after step 2:
    (directory, the batches, rank 0's results)."""
    d = str(tmp_path_factory.mktemp("fsdp_run"))
    jcfg, jp = _tiny()
    batches = _batches(jcfg.vocab_size, 3, seed=4)
    case = dict(cfg=jcfg.to_json(), params=jax.tree.map(np.asarray, jp),
                tc=TC, batches=batches, save_after=(d, 2))
    return d, batches, comm.spawn(tr.fsdp_steps, 4, timeout=200,
                                  args=(2, case), device="cpu")[0]


def test_port_checkpoint_loads_in_reference(fsdp_run):
    d, _, got = fsdp_run
    jcfg, jp = _tiny()
    template = (jp, jadamw.init_opt_state(jp))
    (jparams, jopt), _ = JManager(d, async_save=False).restore(template, 2)
    for a, b in zip(jax.tree.leaves(jparams), got["params"][1]):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(jopt.step) == 2
    # the moments are finite and as wide as the params
    for a, b in zip(jax.tree.leaves(jopt.m), jax.tree.leaves(jparams)):
        assert a.shape == b.shape and np.isfinite(np.asarray(a)).all()


def test_reference_checkpoint_restores_onto_port_ranks(tmp_path):
    d = str(tmp_path)
    jcfg, jp = _tiny()
    jopt = jadamw.init_opt_state(jp)
    rng = np.random.RandomState(2)
    jopt = jopt._replace(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape),
                                             jnp.float32), jopt.m))
    JManager(d, async_save=False).save(3, (jp, jopt))
    case = dict(cfg=jcfg.to_json(), tc=TC, resume=(d, 3))
    ranks = comm.spawn(tr.restore_state, 4, timeout=200, args=(2, case),
                       device="cpu")
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig.from_json(jcfg.to_json())
    whole = [np.asarray(x) for x in jax.tree.leaves((jp, jopt))]
    for r, got in enumerate(ranks):
        mesh = Mesh(shape={"data": 2, "model": 2},
                    coords={"data": r // 2, "model": r % 2})
        ps, os_ = fsdp.state_shardings(cfg, mesh)
        for g, w, s in zip(got, whole, flatten((ps, os_))):
            np.testing.assert_array_equal(
                g, rules.local_block(torch.as_tensor(np.array(w)), s.spec,
                                     mesh).numpy())


def test_resume_on_another_mesh_gives_the_next_loss(fsdp_run):
    d, batches, run = fsdp_run
    jcfg, _ = _tiny()
    resumed = comm.spawn(tr.fsdp_steps, 2, timeout=200,
                         args=(1, dict(cfg=jcfg.to_json(), tc=TC,
                                       batches=batches[2:],
                                       resume=(d, 2))),
                         device="cpu")
    want = run["metrics"][2]
    for got in resumed:
        m = got["metrics"][0]
        for k in ("loss", "grad_norm"):
            assert abs(m[k] - want[k]) <= 1e-5 * abs(want[k]), (k, m, want)
        assert m["lr"] == pytest.approx(want["lr"], rel=1e-7)


DECODE_CASES = [((20, 20), 0), ((20, 20), 6), ((7, 8), 0), ((8, 7), 6)]


def _decode_inputs(pos, window):
    rng = np.random.RandomState(0)
    b, S, kvp, g, d = 2, 32, 2, 2, 8
    q = rng.randn(b, kvp, g, d).astype(np.float32)
    kc = rng.randn(b, kvp, S, d).astype(np.float32)
    vc = rng.randn(b, kvp, S, d).astype(np.float32)
    return q, kc, vc, np.asarray(pos, np.int32), window


@pytest.fixture(scope="module")
def decode_runs():
    """Every case on one (2, 4) rank group: {case: the ranks' rows}."""
    ranks = comm.spawn(tr.seq_decode, 8, timeout=120,
                       args=(2, [_decode_inputs(*c) for c in DECODE_CASES]),
                       device="cpu")
    return {c: [got[i] for got in ranks] for i, c in enumerate(DECODE_CASES)}


@pytest.mark.parametrize("pos,window", DECODE_CASES)
def test_seq_sharded_decode_attention_matches_reference(pos, window,
                                                        decode_runs):
    q, kc, vc, p, window = _decode_inputs(pos, window)
    want = np.asarray(jcm.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                           jnp.asarray(vc), jnp.asarray(p),
                                           window=window))
    rows = decode_runs[(pos, window)]
    for r, got in enumerate(rows):  # rank r holds batch row r // 4
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want[r // 4:r // 4 + 1], rtol=1e-5,
                                   atol=1e-5)
    # without a mesh nothing changes: the reference's unsharded function
    from repro_torch.models import common as tcm
    np.testing.assert_allclose(
        tcm.decode_attention(*(torch.as_tensor(x) for x in (q, kc, vc, p)),
                             window=window).numpy(), want, rtol=1e-5,
        atol=1e-5)
