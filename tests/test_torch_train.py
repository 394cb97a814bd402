"""The port's training path against the JAX reference on the CPU, at f32,
on the same parameters (JAX init, converted through numpy as f32 masters)
and the same numpy inputs.

Tolerances, each held separately (an Adam update is close to lr·sign(g),
so a gradient entry near zero whose sign differs by rounding moves that
parameter by up to 2·lr in one package and not the other):

* the schedule at every kind, and ``adamw_update`` / ``clip_by_global_norm``
  on identical numpy grads: within 1e-6 (relative for the schedule and the
  norm, absolute for params and moments of magnitude about 1);
* ``lm_loss`` within 1e-5 and its gradients within 1e-5 of max |g|, for
  tiny-relu, tiny-opt, tiny-moe and tiny relufied to stage 2; the four
  remat policies give bit-equal gradients;
* ``make_train_step`` over 3 steps with 1 and 2 microbatches: loss,
  grad_norm, lr and step_ok within 1e-5; the params after N = 3 steps
  within max |Δ| <= 2·lr·N, with the median |Δ| within 1e-6;
* ``skip_nonfinite``: a NaN loss leaves params, moments and step
  unchanged, and step_ok is 0, in both packages;
* the ``Trainer`` runs, resumes from its own checkpoint and from one the
  reference's ``Trainer`` wrote: the first resumed loss within 1e-5 of the
  reference's continued run, the next ones within 1e-4 (after the
  Adam-sign drift above);
* ``launch/train.py --smoke --device cpu`` trains; without a device the
  entry points ask for CUDA and raise here."""
import gc
import os
import shutil
import subprocess
import sys
import textwrap
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.core import relufication as jrelu
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.train import loop as jloop
from repro.train import step as jstep
from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import relufication as trelu
from repro_torch.data.pipeline import DataConfig, IteratorState, PackedIterator
from repro_torch.launch import train as train_cli
from repro_torch.models import common as tcm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedules as tsched
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep
from repro_torch.tree import flatten, tree_map, unflatten

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MODELS = ["tiny-relu", "tiny-opt", "tiny-moe", "tiny-stage2"]
POLICIES = ["none", "minimal", "full", "save_ars"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


_CACHE = {}


def _setup(name):
    """(jax cfg, port cfg, jax params, port f32 master params), shared."""
    if name not in _CACHE:
        base = "tiny" if name == "tiny-stage2" else name
        jcfg = jget_config(base).replace(compute_dtype="float32")
        tcfg = get_config(base).replace(compute_dtype="float32")
        if name == "tiny-stage2":
            jcfg, tcfg = jrelu.relufy_stage2(jcfg), trelu.relufy_stage2(tcfg)
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu", dtype=torch.float32)
        _CACHE[name] = (jcfg, tcfg, jp, tp)
    return _CACHE[name]


def _batch(vocab, b=4, s=16, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.rand(b, s) > 0.2).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)},
            {"tokens": torch.as_tensor(toks), "loss_mask": torch.as_tensor(mask)})


def _leaves_j(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _leaves_t(tree):
    return [_np(x) for x in flatten(tree)]


# ---------------------------------------------------------------------------
# configs, schedules, AdamW


def test_train_config_defaults_and_single_device_values():
    tc = TrainConfig()
    assert (tc.learning_rate, tc.warmup_steps, tc.weight_decay, tc.b2,
            tc.grad_clip, tc.schedule, tc.remat_policy, tc.skip_nonfinite) \
        == (1.5e-5, 100, 0.1, 0.95, 1.0, "cosine", "minimal", True)
    assert TrainConfig(zero_stage=0).zero_stage == 0
    # as in the reference, the field selects nothing (train/fsdp.py)
    assert TrainConfig(zero_stage=3).zero_stage == 3
    assert TrainConfig(grad_compression="int8_ef").grad_compression == "int8_ef"
    with pytest.raises(ValueError, match="grad_compression"):
        TrainConfig(grad_compression="fp8")


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
def test_schedule_matches_reference(kind):
    kw = dict(learning_rate=3e-4, warmup_steps=10, total_steps=50,
              schedule=kind)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    for s in (0, 1, 5, 9, 10, 11, 30, 49, 50, 70):
        want = float(jsched.learning_rate(jnp.asarray(s, jnp.int32), jtc))
        got = tsched.learning_rate(torch.tensor(s, dtype=torch.int32), ttc)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


def _random_tree(rng, jp):
    """Numpy arrays of the params' shapes, as a jax tree and a port tree."""
    arrs = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), jp)
    return arrs, params_from_jax(arrs, None, device="cpu", dtype=torch.float32)


def test_adamw_update_and_clip_on_identical_grads():
    jcfg, _, jp, tp = _setup("tiny-relu")
    rng = np.random.RandomState(1)
    jg, tg = _random_tree(rng, jp)
    jm, tm = _random_tree(rng, jp)
    jv, tv = _random_tree(rng, jp)
    jv = jax.tree.map(np.abs, jv)
    tv = tree_map(torch.abs, tv)
    jstate = jadamw.OptState(jnp.asarray(3, jnp.int32), jm, jv)
    tstate = tadamw.OptState(torch.tensor(3, dtype=torch.int32), tm, tv)
    kw = dict(weight_decay=0.1, b1=0.9, b2=0.95, eps=1e-8)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)

    # clipping: the norm and the scaled grads
    jclip, jn = jadamw.clip_by_global_norm(jg, 1.0)
    tclip, tn = tadamw.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in zip(_leaves_t(tclip), _leaves_j(jclip)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)

    lr = 1e-3
    jnew, jst = jadamw.adamw_update(jclip, jstate, jp, jnp.float32(lr), jtc)
    tnew, tst = tadamw.adamw_update(tclip, tstate, tp,
                                    torch.tensor(lr, dtype=torch.float32), ttc)
    assert int(tst.step) == int(jst.step) == 4
    assert tst.step.dtype == torch.int32
    for got, want in zip(_leaves_t(tnew), _leaves_j(jnew)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for tt, jt in ((tst.m, jst.m), (tst.v, jst.v)):
        for got, want in zip(_leaves_t(tt), _leaves_j(jt)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    # decay only on leaves of ndim >= 2: with zero grads and moments the
    # final norm's (d,) scale stays where it was (update 0); a stacked
    # (L, d) layer norm scale decays, as it does in the reference
    zg = tree_map(torch.zeros_like, tp)
    z = tadamw.init_opt_state(tp)
    moved, _ = tadamw.adamw_update(zg, z, tp, torch.tensor(lr), ttc)
    assert torch.equal(moved["final_norm"]["scale"], tp["final_norm"]["scale"])
    for key in ("ln1", "ffn"):
        leaf = "scale" if key == "ln1" else "wu"
        assert not torch.equal(moved["layers"][key][leaf],
                               tp["layers"][key][leaf])


# ---------------------------------------------------------------------------
# loss and gradients


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_reference(name):
    jcfg, tcfg, jp, tp = _setup(name)
    jb, tb = _batch(jcfg.vocab_size)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jstep.lm_loss(p, jb, jcfg), has_aux=True)(jp)
    tl, tg = tstep.loss_and_grads(tp, tb, tcfg)
    assert abs(float(tl) - float(jl)) <= 1e-5
    want, got = _leaves_j(jg), _leaves_t(tg)
    assert [w.shape for w in want] == [g.shape for g in got]
    gmax = max(np.abs(w).max() for w in want)
    err = max(np.abs(g - w).max() for g, w in zip(got, want))
    assert err <= 1e-5 * gmax, (err, gmax)
    # the masters are f32 and so are their gradients
    assert all(g.dtype == np.float32 for g in got)


class _CountProducts(TorchDispatchMode):
    """Counts the 2-D products a region runs, and the per-layer
    ``select_backward`` ops (a zero gradient of a whole stacked leaf for
    each layer) it runs."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.select_shapes = set()  # the shapes select_backward builds

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        if func is torch.ops.aten.select_backward.default:
            self.select_shapes.add(tuple(args[1]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["tiny-relu", "tiny-moe"])
def test_remat_policies_give_equal_gradients(name):
    """All four policies, bit for bit; "minimal" keeps the 2-D products
    (its backward runs as many as "none"'s), "full" recomputes them; no
    policy builds a stacked leaf's gradient layer by layer."""
    _, tcfg, _, tp = _setup(name)
    _, tb = _batch(tcfg.vocab_size, seed=3)
    grads, products = {}, {}
    for pol in POLICIES:
        leaves = [p.detach().requires_grad_(True) for p in flatten(tp)]
        loss, _ = tstep.lm_loss(unflatten(tp, leaves), tb, tcfg,
                                remat_policy=pol)
        with _CountProducts() as count:
            g = torch.autograd.grad(loss, leaves)
        grads[pol], products[pol] = g, count.n
        # the stacked layer leaves are split once a forward (unbind), so
        # their gradients are stacked once, not built layer by layer
        stacked = {tuple(p.shape) for p in flatten(tp["layers"])}
        assert not count.select_shapes & stacked, pol
    for pol in POLICIES[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[pol])), pol
    assert products["minimal"] == products["none"]
    assert products["full"] > products["none"]
    with pytest.raises(ValueError, match="unknown remat policy"):
        tcm.wrap_block("everything", lambda *a: None)


def test_stats_under_full_remat_equal_stats_without():
    """A recompute calls the collector again under the same keys: the
    values are those of the forward."""
    _, tcfg, _, tp = _setup("tiny-stage2")
    _, tb = _batch(tcfg.vocab_size, seed=4)
    got = {}
    for pol in ("none", "full", "minimal"):
        stats = tcm.StatsCollector(True)
        leaves = [p.detach().requires_grad_(True) for p in flatten(tp)]
        loss, aux = tstep.lm_loss(unflatten(tp, leaves), tb, tcfg,
                                  remat_policy=pol, stats=stats)
        torch.autograd.grad(loss, leaves)
        got[pol] = {k: v.clone() for k, v in stats.stats.items()}
        assert set(aux) == {"loss"} | set(stats.stats)
    assert got["none"] and "layer1/qkv_in" in got["none"]
    for pol in ("full", "minimal"):
        assert got[pol].keys() == got["none"].keys()
        for k in got["none"]:
            assert torch.equal(got[pol][k], got["none"][k]), (pol, k)


# ---------------------------------------------------------------------------
# the train step


def _run_steps(name, nmb, n=3, lr=1e-3):
    jcfg, tcfg, jp, tp = _setup(name)
    kw = dict(learning_rate=lr, warmup_steps=2, total_steps=10,
              num_microbatches=nmb, remat_policy="minimal")
    jfn = jax.jit(jstep.make_train_step(jcfg, JTrainConfig(**kw)))
    tfn = tstep.make_train_step(tcfg, TrainConfig(**kw))
    jpp, jo = jp, jadamw.init_opt_state(jp)
    tpp, to = tp, tadamw.init_opt_state(tp)
    rows = []
    for i in range(n):
        jb, tb = _batch(jcfg.vocab_size, seed=10 + i)
        jpp, jo, jm = jfn(jpp, jo, jb)
        tpp, to, tm = tfn(tpp, to, tb)
        rows.append(({k: float(v) for k, v in jm.items()},
                     {k: float(v) for k, v in tm.items()}))
    return rows, (jpp, jo), (tpp, to)


# grad_norm's relative tolerance after the first step. tiny-moe's second
# step (one microbatch) has one expert pre-activation at 2.8e-7, inside the
# f32 rounding of zero, so relu' differs between the packages for that unit
# and its wu gradient moves by 6% of the leaf's max (the loss does not)
GRAD_NORM_TOL = {"tiny-relu": 1e-5, "tiny-moe": 1e-3}


@pytest.mark.parametrize("nmb", [1, 2])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-moe"])
def test_train_step_matches_reference_over_three_steps(name, nmb):
    lr, n = 1e-3, 3
    rows, (jp, jo), (tp, to) = _run_steps(name, nmb, n, lr)
    for i, (want, got) in enumerate(rows):
        assert set(got) == {"loss", "grad_norm", "lr", "step_ok"}
        for k in want:
            tol = GRAD_NORM_TOL[name] if k == "grad_norm" and i else 1e-5
            assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), (k, got, want)
        assert got["step_ok"] == 1.0
    assert int(to.step) == int(jo.step) == n
    diffs = np.concatenate([np.abs(g - w).ravel() for g, w in
                            zip(_leaves_t(tp), _leaves_j(jp))])
    assert diffs.max() <= 2 * lr * n, diffs.max()
    assert np.median(diffs) <= 1e-6, np.median(diffs)
    mdiff = np.concatenate([np.abs(g - w).ravel() for g, w in
                            zip(_leaves_t(to.m), _leaves_j(jo.m))])
    assert np.median(mdiff) <= 1e-6


def test_skip_nonfinite_keeps_params_moments_and_step():
    jcfg, tcfg, jp, tp = _setup("tiny-relu")
    kw = dict(learning_rate=1e-3, warmup_steps=1, num_microbatches=2)
    tfn = tstep.make_train_step(tcfg, TrainConfig(**kw))
    jfn = jax.jit(jstep.make_train_step(jcfg, JTrainConfig(**kw)))
    # one good step first, so the moments and the step are not zero
    jb, tb = _batch(jcfg.vocab_size, seed=20)
    tp1, to1, _ = tfn(tp, tadamw.init_opt_state(tp), tb)
    jp1, jo1, _ = jfn(jp, jadamw.init_opt_state(jp), jb)
    jb, tb = _batch(jcfg.vocab_size, seed=21)
    mask = np.asarray(tb["loss_mask"]).copy()
    mask[1, 3] = np.nan
    tb["loss_mask"], jb["loss_mask"] = torch.as_tensor(mask), jnp.asarray(mask)
    tp2, to2, tm = tfn(tp1, to1, tb)
    jp2, jo2, jm = jfn(jp1, jo1, jb)
    assert float(tm["step_ok"]) == float(jm["step_ok"]) == 0.0
    assert not np.isfinite(float(tm["loss"]))
    assert int(to2.step) == int(jo2.step) == 1
    for a, b in zip(flatten((tp2, to2)), flatten((tp1, to1))):
        assert torch.equal(a, b)
    for got, want in zip(_leaves_t((tp2, to2)), _leaves_j((jp2, jo2))):
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * 1e-3)


# ---------------------------------------------------------------------------
# the Trainer and the launcher


def _trainer_setup(name="tiny-relu"):
    jcfg, tcfg, _, _ = _setup(name)
    kw = dict(learning_rate=3e-3, total_steps=8, warmup_steps=2,
              num_microbatches=1, remat_policy="none", seed=0)
    dkw = dict(vocab_size=jcfg.vocab_size, seq_len=32, batch_size=4)
    return (jcfg, JTrainConfig(**kw), JDataConfig(**dkw),
            tcfg, TrainConfig(**kw), DataConfig(**dkw))


def test_trainer_runs_and_resumes(tmp_path):
    _, _, _, tcfg, ttc, tdc = _trainer_setup()
    quiet = dict(eval_every=3, log=lambda *_: None, device="cpu")
    tr = tloop.Trainer(tcfg, ttc, tdc, ckpt_dir=str(tmp_path / "a"),
                       ckpt_every=4, **quiet)
    rep = tr.run(6)
    assert rep.steps == 6 and np.isfinite(rep.losses).all()
    assert rep.skipped_steps == 0 and rep.resumed_from is None
    assert len(rep.eval_losses) == 2 and np.isfinite(rep.eval_losses).all()
    assert len(rep.data_seconds) == len(rep.step_seconds) == 6
    assert all(p.dtype == torch.float32 for p in flatten(tr.params))
    assert tr.ckpt.all_steps() == [4, 6]
    # a restart resumes the params, the optimizer and the iterator at step
    # 6 (the reference's iterator restarts at the next document, dropping
    # the packed remainder): its first step is the step from the run's
    # final state on the batch its iterator state gives
    _, extras = tr.ckpt.restore((tr.params, tr.opt_state))
    assert extras["step"] == 6
    batch = next(PackedIterator(tdc, IteratorState.from_dict(extras["data"])))
    _, _, m = tr.step_fn(tr.params, tr.opt_state,
                         {k: torch.as_tensor(v) for k, v in batch.items()})
    tr2 = tloop.Trainer(tcfg, ttc, tdc, ckpt_dir=str(tmp_path / "a"),
                        ckpt_every=4, **quiet)
    rep2 = tr2.run(8)
    assert rep2.resumed_from == 6 and rep2.steps == 2
    assert rep2.losses[0] == float(m["loss"])
    assert int(tr2.opt_state.step) == 8 and tr2.ckpt.all_steps() == [4, 6, 8]


def test_trainer_drops_the_initial_params():
    """The initial params handed to ``run`` are referenced by no frame
    after the first step (at full width a held copy is 4 GiB of peak)."""
    _, _, _, tcfg, ttc, tdc = _trainer_setup()
    tr = tloop.Trainer(tcfg, ttc, tdc, log=lambda *_: None, device="cpu")
    first = [tree_map(torch.clone, _setup("tiny-relu")[3])]
    ref = weakref.ref(first[0]["embed"])
    seen = []
    step_fn = tr.step_fn

    def spy(p, o, b):
        gc.collect()  # cycles aside: only live references count
        seen.append(ref() is not None)
        return step_fn(p, o, b)

    tr.step_fn = spy
    tr.run(3, params=first.pop())
    assert seen == [True, False, False]


def test_trainer_resumes_from_reference_checkpoint(tmp_path):
    """The reference's Trainer writes (params, OptState) and the iterator
    state at step 4; the port's resumes there, and its next losses follow
    the reference's own continued run."""
    jcfg, jtc, jdc, tcfg, ttc, tdc = _trainer_setup()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    quiet = dict(eval_every=100, log=lambda *_: None)
    jloop.Trainer(jcfg, jtc, jdc, ckpt_dir=str(jdir), ckpt_every=2,
                  **quiet).run(4)
    shutil.copytree(jdir, tdir)
    want = jloop.Trainer(jcfg, jtc, jdc, ckpt_dir=str(jdir), ckpt_every=2,
                         **quiet).run(7)
    got = tloop.Trainer(tcfg, ttc, tdc, ckpt_dir=str(tdir), ckpt_every=2,
                        device="cpu", **quiet).run(7)
    assert got.resumed_from == want.resumed_from == 4
    assert got.steps == want.steps == 3
    assert abs(got.losses[0] - want.losses[0]) <= 1e-5
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-4)
    assert os.listdir(tdir) and 7 in [int(n[5:]) for n in os.listdir(tdir)
                                      if n.startswith("step_")]


def test_sigterm_checkpoints_and_exits(tmp_path):
    """SIGTERM during a run (sent at step 2's eval) stops it after that
    step with a checkpoint; a new Trainer resumes there; the handler the
    process had before the run is back when it returns."""
    prog = textwrap.dedent(f"""
        import os, signal
        from repro_torch.configs import TrainConfig, get_config
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.train.loop import Trainer
        cfg = get_config("tiny-relu").replace(compute_dtype="float32")
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2)
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=1)

        def log(msg):
            if "eval" in msg:
                os.kill(os.getpid(), signal.SIGTERM)
        rep = Trainer(cfg, tc, dc, ckpt_dir={str(tmp_path)!r}, ckpt_every=100,
                      eval_every=2, log=log, device="cpu").run(10)
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
        assert rep.steps == 2, rep.steps
        assert sorted(os.listdir({str(tmp_path)!r})) == ["step_0000000002"]
        rep = Trainer(cfg, tc, dc, ckpt_dir={str(tmp_path)!r},
                      log=lambda *_: None, device="cpu").run(3)
        assert (rep.resumed_from, rep.steps) == (2, 1)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]


def test_train_cli_smoke_on_cpu(capsys, tmp_path):
    train_cli.main(["--arch", "tiny-relu", "--smoke", "--steps", "3",
                    "--relufy-stage", "2", "--ckpt", str(tmp_path),
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "skipped 0" in out
    assert os.path.isdir(tmp_path / "step_0000000003")
    with pytest.raises(NotImplementedError, match="pod-mesh"):
        train_cli.main(["--arch", "tiny-relu", "--device", "cpu"])


def test_training_entry_points_need_cuda_by_default(monkeypatch):
    _, _, _, tcfg, ttc, tdc = _trainer_setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.Trainer(tcfg, ttc, tdc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "tiny-relu", "--smoke", "--steps", "1"])
