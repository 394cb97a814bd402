"""Checks shared by the split-family tests (tests/test_torch_ssm_split.py,
tests/test_torch_encdec_split.py): the Mamba-1, Zamba-2 and Whisper
smoke configs split over "model" on gloo ranks against the JAX
reference's single-device results, at f32, on the reference's weights
converted through numpy.

* ``legacy_cases``: each arch dense and at static capacities 0.25 (FFN /
  out_proj) / 0.75 (inputs) with a tile of 16 (the smoke d_model 64 is
  under the default tile 128), relufied to stage 2 for the static ones;
  the reference's ``ServeEngine.generate`` greedy streams of 2 prompts of
  8 tokens (Whisper with seeded frames), 8 new tokens.
* ``grad_cases``: the FSDP step's loss and every rank's gradient blocks
  on (2, 2), 2 microbatches, a loss mask whose rows keep different
  shares, against ``jax.value_and_grad`` of the reference's ``lm_loss``
  (jitted) summed over the microbatches and divided by their count.

Tolerances: tokens exact, logprobs within 1e-5; loss within 1e-5
relative, each block within 1e-5 · max |g| of its leaf."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as jsmoke
from repro.core import relufication as jrelu
from repro.models import registry as jreg
from repro.serving.engine import ServeEngine as JServeEngine
from repro.train import step as jstep
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import rules

MAX_NEW = 8
MODES = ("dense", "static")


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def ref_config(arch: str, mode: str = "dense", **kw):
    """The reference's f32 smoke config of ``arch`` (``mode`` "static":
    relufied to stage 2 at capacities 0.25 / 0.75, tile 16)."""
    jcfg = jsmoke(arch).replace(compute_dtype="float32", **kw)
    if mode == "static":
        jcfg = jrelu.enable_sparse_serving(
            jrelu.relufy_stage2(jcfg).replace_sparsity(tile_size=16),
            0.25, 0.75)
    return jcfg


def ref_params(jcfg, seed: int = 0):
    return jreg.get_family(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)


def prompt_batch(jcfg, b: int = 2, s: int = 8, seed: int = 1) -> dict:
    """numpy tokens (b, s), and Whisper's frames (normal * 0.02)."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, jcfg.vocab_size, (b, s)).astype(np.int32)}
    if jcfg.family == "encdec":
        out["frames"] = (rng.randn(b, jcfg.n_audio_frames, jcfg.d_model)
                         * 0.02).astype(np.float32)
    return out


def legacy_cases(archs):
    """[(id, rank case for ``torch_ranks.legacy_generate``, the reference's
    (tokens, logprobs) maker)] for each arch and mode."""
    out = []
    for arch in archs:
        jp = ref_params(ref_config(arch))
        for mode in MODES:
            jcfg = ref_config(arch, mode)
            batch = prompt_batch(jcfg)

            def want(jcfg=jcfg, jp=jp, batch=batch):
                r = JServeEngine(jcfg, jp, max_len=32).generate(
                    {k: jnp.asarray(v) for k, v in batch.items()},
                    max_new=MAX_NEW)
                return np.asarray(r.tokens), np.asarray(r.logprobs)

            out.append((f"{arch}-{mode}",
                        (jcfg.to_json(), _np(jp), batch, MAX_NEW), want))
    return out


def grad_batch(jcfg, b: int = 8, s: int = 16, seed: int = 2) -> dict:
    """A numpy batch of ``prompt_batch`` with a loss mask whose rows keep
    different shares (so the data rows' counts differ)."""
    out = prompt_batch(jcfg, b, s, seed)
    rng = np.random.RandomState(seed + 1)
    keep = np.linspace(0.15, 0.95, b)[:, None]
    out["loss_mask"] = (rng.rand(b, s) < keep).astype(np.float32)
    return out


def reference_grads(jcfg, jp, batch, nmb: int = 2):
    """(mean loss, mean gradient leaves) of the reference's ``lm_loss`` on
    one device, jitted, over ``nmb`` microbatches."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, mb: jstep.lm_loss(p, mb, jcfg)[0]))
    b = batch["tokens"].shape[0] // nmb
    loss, grads = 0.0, None
    for i in range(nmb):
        mb = {k: jnp.asarray(v[i * b:(i + 1) * b]) for k, v in batch.items()}
        l, g = fn(jp, mb)
        loss += float(l)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return loss / nmb, [np.asarray(x) / nmb for x in jax.tree.leaves(grads)]


def hold_streams(got, want) -> None:
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


def hold_grads(loss, blocks, want_loss, want_grads, what="") -> None:
    """The loss within 1e-5 relative; each of a rank's gradient blocks
    (``torch_ranks.grad_blocks``) within 1e-5 · max |g| of the same block
    (its spec and packing) of the whole gradient."""
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (what, loss,
                                                             want_loss)
    mesh = Mesh(shape=blocks["shape"], coords=blocks["coords"],
                axis_names=blocks["axes"])
    assert len(blocks["grads"]) == len(want_grads)
    for g, w, spec, packed in zip(blocks["grads"], want_grads,
                                  blocks["specs"], blocks["packed"]):
        blk = rules.Sharding(mesh, spec, packed).block(
            torch.from_numpy(w)).numpy()
        assert g.shape == blk.shape, (what, g.shape, blk.shape)
        np.testing.assert_allclose(g, blk, rtol=0, atol=1e-5 * max(
            float(np.abs(w).max()), 1e-30), err_msg=what)


def block_bytes(shape, itemsize: int = 2) -> int:
    """A block's bytes as the dry run holds them (512-byte blocks)."""
    n = itemsize * int(np.prod(shape))
    return -(-n // 512) * 512
