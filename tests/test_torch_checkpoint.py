"""The port's checkpoint format with the optimizer state in it: a
``(params, OptState)`` tree round-trips (the NamedTuple rebuilt, the 0-d
int32 step 0-d), an async save is complete after ``wait()``, keep-k
drops the oldest steps, and a training checkpoint written by the
reference's ``CheckpointManager`` restores in the port and the reverse,
leaf for leaf in the reference's flattening order."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import flatten, unflatten

torch.set_num_threads(1)


def _state(seed=0):
    """(jax (params, OptState), port (params, OptState)) of tiny-relu with
    random moments and step 7."""
    jcfg = jget_config("tiny-relu").replace(compute_dtype="float32")
    tcfg = get_config("tiny-relu").replace(compute_dtype="float32")
    jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    jm = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), jp)
    jv = jax.tree.map(lambda p: rng.rand(*p.shape).astype(np.float32), jp)
    jtree = (jp, jadamw.OptState(jnp.asarray(7, jnp.int32), jm, jv))
    conv = lambda t: params_from_jax(jax.tree.map(np.asarray, t), tcfg,  # noqa: E731
                                     device="cpu", dtype=torch.float32)
    ttree = (conv(jp), tadamw.OptState(torch.tensor(7, dtype=torch.int32),
                                       conv(jm), conv(jv)))
    return jtree, ttree


def _equal_leaves(a, b):
    la, lb = flatten(a), flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_namedtuple_tree_round_trips(tmp_path):
    _, ttree = _state()
    leaves = flatten(ttree)
    back = unflatten(ttree, leaves)
    assert isinstance(back[1], tadamw.OptState)
    assert back[1].step is ttree[1].step
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, ttree, extras={"step": 3, "data": {"next_doc": 11}})
    got, extras = mgr.restore(ttree)
    assert extras == {"step": 3, "data": {"next_doc": 11}}
    assert isinstance(got[1], tadamw.OptState)
    assert got[1].step.shape == () and got[1].step.dtype == np.int32
    _equal_leaves(got, [t.numpy() for t in flatten(ttree)])
    # the leaf order is the reference's: params, then step, m, v
    jtree, _ = _state()
    assert [tuple(x.shape) for x in flatten(ttree)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jtree)]


def test_async_save_is_complete_after_wait(tmp_path):
    _, ttree = _state()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    before = ttree[0]["embed"].clone()
    mgr.save(5, ttree, extras={"step": 5})
    # the snapshot was taken on the calling thread: changing the live tree
    # now does not reach the file
    ttree[0]["embed"].add_(1.0)
    mgr.wait()
    assert mgr._thread is None and mgr.all_steps() == [5]
    got, _ = mgr.restore(ttree)
    np.testing.assert_array_equal(got[0]["embed"], before.numpy())
    mgr.save(6, ttree, extras={"step": 6}, block=True)  # blocking
    assert mgr._thread is None and mgr.all_steps() == [5, 6]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]


def test_keep_k_drops_oldest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = {"a": torch.arange(6, dtype=torch.float32), "b": [np.ones(3, np.int32)]}
    for s in (10, 20, 30):
        mgr.save(s, tree, extras={"step": s})
    mgr.wait()
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30


def test_training_checkpoints_cross_packages(tmp_path):
    jtree, ttree = _state(seed=1)
    JManager(str(tmp_path / "j"), async_save=False).save(
        7, jtree, extras={"step": 7, "data": {"next_doc": 40}}, block=True)
    got, extras = CheckpointManager(str(tmp_path / "j")).restore(ttree)
    assert extras["step"] == 7 and isinstance(got[1], tadamw.OptState)
    assert got[1].step.shape == () and int(got[1].step) == 7
    _equal_leaves(got, [np.asarray(x) for x in jax.tree.leaves(jtree)])

    CheckpointManager(str(tmp_path / "t")).save(
        7, ttree, extras={"step": 7, "data": {"next_doc": 40}})
    back, extras = JManager(str(tmp_path / "t")).restore(jtree)
    assert extras["data"] == {"next_doc": 40}
    assert isinstance(back[1], jadamw.OptState) and back[1].step.shape == ()
    for x, y in zip(jax.tree.leaves(back), flatten(ttree)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
