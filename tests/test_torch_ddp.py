"""The port's data-parallel train step and int8 error-feedback gradient
compression against the JAX reference, on the CPU, at f32.

* ``quantize_int8`` / ``dequantize_int8`` and the compressed mean
  (``compress`` on each rank, then ``decompress_mean`` of the ranks'
  payloads) against ``repro.optim.compression`` on the same numpy arrays,
  the reference's ``compressed_psum_mean`` run under ``jax.vmap`` with a
  named axis standing for 8 ranks: scales within 1e-6, and the int8
  payloads equal except where x / scale lies within 1e-5 of a half
  integer (the two packages divide in their own way, so round-half-to-even
  may fall either side there; the test counts those elements and says
  how many it met); the mean and the error feedback within 1e-6 of max |g|
  wherever the payloads agree.
* ``make_ddp_train_step`` on 8 gloo ranks (``tests/torch_ranks.py``)
  against ``repro.train.ddp.make_ddp_train_step`` on 8 forced host devices
  (``tests/subproc.py``), tiny-relu from the same params over the same
  ``PackedIterator`` batches (8 x 32 tokens, one row a rank): uncompressed,
  the losses, grad norms and learning rates of 2 steps within 1e-5, and
  the params after them within 1e-5 but for at most 1 in 10^4 elements,
  which stay within 2·lr·N (an Adam update is close to lr·sign(g), so a
  gradient entry within rounding of zero moves its parameter by up to
  2·lr; one element of tiny-relu's 32768 in its wu does, by 1.3e-4: the
  convention of ``tests/test_torch_train.py``), with the median within
  1e-6; with ``grad_compression="int8_ef"``, the losses
  of 4 steps within 1e-4, the last below the first, as the reference's own
  test asserts.
* ``TrainConfig(grad_compression="int8_ef")`` constructs; so does
  ``zero_stage=3``, as in the reference, where the field selects nothing:
  ``train/fsdp.py``'s step accepts it on a one-rank mesh."""
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import compression as tcomp
from repro_torch.sharding import comm

import torch_ranks as tr
from subproc import run_forced_devices

torch.set_num_threads(1)

N_RANKS = 8


def _grads(seed):
    rng = np.random.RandomState(seed)
    return {"a": (rng.randn(N_RANKS, 6, 10) * 0.3).astype(np.float32),
            "b": {"c": rng.randn(N_RANKS, 17).astype(np.float32),
                  "d": (rng.randn(N_RANKS, 3, 4) * 1e-3).astype(np.float32)}}


def _near_half(x, scale):
    """Where x / scale lies within 1e-5 of a half integer."""
    r = np.asarray(x, np.float64) / np.float64(scale)
    return np.abs(np.abs(r - np.floor(r)) - 0.5) < 1e-5


def test_quantize_matches_reference():
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * 2.0).astype(np.float32)
    x[:64] = np.round(x[:64] * 4) / 4 * 1.0  # quarter steps: many ties
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.as_tensor(x))
    assert tq.dtype == torch.int8
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    differ = tq.numpy() != np.asarray(jq)
    near = _near_half(x, float(js))
    assert not (differ & ~near).any()
    print(f"int8 payloads: {int(differ.sum())} of {int(near.sum())} elements "
          f"within 1e-5 of a half step differ, none elsewhere")
    np.testing.assert_allclose(
        tcomp.dequantize_int8(tq, ts).numpy(),
        np.asarray(jcomp.dequantize_int8(jnp.asarray(tq.numpy()), js)),
        rtol=0, atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize("seed", [1, 2])
def test_compressed_mean_matches_reference(seed):
    g = _grads(seed)
    e = jax.tree.map(lambda a: (a * 0.01).astype(np.float32), _grads(seed + 10))
    ref = jax.vmap(lambda gi, ei: jcomp.compressed_psum_mean(gi, ei, "data"),
                   axis_name="data")
    jmean, jef = ref(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    per_rank = [tcomp.compress(jax.tree.map(lambda a: torch.as_tensor(a[r]), g),
                               jax.tree.map(lambda a: torch.as_tensor(a[r]), e))
                for r in range(N_RANKS)]
    payloads = torch.stack([p for p, _, _ in per_rank])
    scales = torch.stack([s for _, s, _ in per_rank])
    like = jax.tree.map(lambda a: torch.as_tensor(a[0]), g)
    mean = tcomp.decompress_mean(payloads, scales, like)
    leaves = jax.tree.leaves(g)
    jm, tm = jax.tree.leaves(jmean), [x for x in _flat(mean)]
    je, te = jax.tree.leaves(jef), None
    n_near = 0
    for i, (gl, el) in enumerate(zip(leaves, jax.tree.leaves(e))):
        for r in range(N_RANKS):
            x = gl[r] + el[r]
            jq, js = jcomp.quantize_int8(jnp.asarray(x))
            n_near += int(_near_half(x, float(js)).sum())
            np.testing.assert_allclose(float(scales[r, i]), float(js),
                                       rtol=1e-6)
            te = _flat(per_rank[r][2])[i].numpy()
            np.testing.assert_allclose(te, np.asarray(je[i][r]), rtol=0,
                                       atol=1e-6 * np.abs(x).max())
        for r in range(N_RANKS):  # the mean is the same on every rank
            np.testing.assert_allclose(tm[i].numpy(), np.asarray(jm[i][r]),
                                       rtol=0,
                                       atol=1e-6 * np.abs(gl).max())
    print(f"compressed mean: {n_near} elements within 1e-5 of a half step")


def _flat(tree):
    from repro_torch.tree import flatten
    return flatten(tree)


def test_train_config_accepts_int8_ef_and_not_zero_stage_3():
    # the name predates the FSDP step: zero_stage=3 is accepted now
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.fsdp import make_fsdp_train_step
    assert TrainConfig(grad_compression="int8_ef").grad_compression == "int8_ef"
    tc = TrainConfig(zero_stage=3)
    assert tc.zero_stage == 3
    step = make_fsdp_train_step(get_config("tiny-relu"), tc,
                                make_host_mesh(1, 1, device="cpu"))
    assert callable(step)


_REFERENCE = """
import pickle, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, TrainConfig
from repro.data.pipeline import DataConfig, PackedIterator
from repro.models import registry
from repro.optim import adamw, compression
from repro.train.ddp import make_ddp_train_step
mesh = jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
cfg = get_config("tiny-relu").replace(compute_dtype="float32")
params0 = registry.get_family(cfg).init_params(jax.random.PRNGKey(0), cfg)
it = PackedIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                               batch_size=8))
batches = [{k: np.asarray(v) for k, v in next(it).items()} for _ in range(4)]
out = {"params": jax.tree.map(np.asarray, params0), "batches": batches}
for comp, steps in (("none", 2), ("int8_ef", 4)):
    tc = TrainConfig(learning_rate=5e-3, total_steps=6, warmup_steps=1,
                     schedule="constant", grad_compression=comp)
    step = make_ddp_train_step(cfg, tc, mesh)
    params, opt = params0, adamw.init_opt_state(params0)
    ef = compression.init_ef_state(params0)
    rows = []
    for b in batches[:steps]:
        params, opt, ef, m = step(params, opt, ef,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        rows.append({k: float(v) for k, v in m.items()})
    out[comp] = {"metrics": rows,
                 "params": [np.asarray(x) for x in jax.tree.leaves(params)]}
pickle.dump(out, open(PATH, "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def reference_run():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ddp.pkl")
        out = run_forced_devices(f"PATH = {path!r}\n" + _REFERENCE,
                                 devices=N_RANKS)
        assert "OK" in out
        with open(path, "rb") as f:
            return pickle.load(f)


def test_ddp_step_uncompressed_matches_reference(reference_run):
    want = reference_run["none"]
    ranks = comm.spawn(tr.ddp_steps, N_RANKS, timeout=300,
                       args=(reference_run, "none", 2), device="cpu")
    for got in ranks:
        for g, w in zip(got["metrics"], want["metrics"]):
            assert set(g) == {"loss", "grad_norm", "lr"}
            for k in w:
                assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), (k, g, w)
        diffs = np.concatenate([np.abs(g - w).ravel() for g, w in
                                zip(got["params"], want["params"])])
        lr, n = 5e-3, 2
        assert diffs.max() <= 2 * lr * n, diffs.max()
        assert (diffs > 1e-5).sum() <= 1e-4 * diffs.size, (diffs > 1e-5).sum()
        assert np.median(diffs) <= 1e-6, np.median(diffs)
    for got in ranks[1:]:  # replicated: every rank the same params
        for a, b in zip(got["params"], ranks[0]["params"]):
            np.testing.assert_array_equal(a, b)


def test_ddp_step_int8_ef_matches_reference(reference_run):
    want = reference_run["int8_ef"]
    ranks = comm.spawn(tr.ddp_steps, N_RANKS, timeout=300,
                       args=(reference_run, "int8_ef", 4), device="cpu")
    wl = [m["loss"] for m in want["metrics"]]
    assert wl[-1] < wl[0]
    for got in ranks:
        gl = [m["loss"] for m in got["metrics"]]
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
        assert gl[-1] < gl[0], gl
