"""Checks shared by the port's family tests (tests/test_torch_mamba.py,
test_torch_hybrid.py, test_torch_encdec.py, test_torch_vlm.py): the
port's family module against the JAX package's on the CPU, at f32, on the
reference's smoke-config weights converted through numpy, with the same
numpy inputs (tokens and the modality stubs).

Tolerances: logits within 1e-5 of max |logit|; every cache leaf within
1e-5 of its max |value|; ``ServeEngine`` streams token for token,
logprobs within 1e-5; loss within 1e-5 and gradients within 1e-5 of
max |g|; the four remat policies bit-equal."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.core import relufication as jrelu
from repro.models import registry as jreg
from repro.serving.engine import ServeEngine as JServeEngine
from repro.train import step as jstep
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import relufication as trelu
from repro_torch.models import registry as treg
from repro_torch.serving import ServeEngine
from repro_torch.train import step as tstep
from repro_torch.tree import flatten, unflatten

POLICIES = ["none", "minimal", "full", "save_ars"]
MODES = {  # ServeEngine modes: (reuse_window, track_sparsity, static)
    "dense": (0, False, False),
    "reuse3_track": (3, True, False),
    "static": (0, False, True),
}
_SETUP = {}


def np_(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def setup(arch: str, static: bool = False, train: bool = False):
    """(jax cfg, port cfg, jax params, port params) at f32 for the smoke
    config of ``arch``. ``static``: relufied to stage 2 and served at tile
    capacities 0.5 (FFN / out_proj) and 0.75 (inputs) with a tile of 16
    (the smoke d_model of 64 is under the default tile of 128).
    ``train``: the port's params as f32 masters."""
    key = (arch, static, train)
    if key not in _SETUP:
        jcfg = jsmoke_config(arch).replace(compute_dtype="float32")
        tcfg = smoke_config(arch).replace(compute_dtype="float32")
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        if static:
            jcfg = jrelu.enable_sparse_serving(
                jrelu.relufy_stage2(jcfg).replace_sparsity(tile_size=16),
                0.5, 0.75)
            tcfg = trelu.enable_sparse_serving(
                trelu.relufy_stage2(tcfg).replace_sparsity(tile_size=16),
                0.5, 0.75)
        base = setup(arch) if (static or train) else None
        jp = (base[2] if base else
              jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                             dtype=torch.float32 if train else None)
        _SETUP[key] = (jcfg, tcfg, jp, tp)
    return _SETUP[key]


def batch(cfg, b: int = 2, s: int = 12, seed: int = 1):
    """numpy inputs: tokens (b, s) and the family's stub (patches / frames,
    normal * 0.02)."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = (rng.randn(b, cfg.n_vision_tokens, cfg.d_model)
                          * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (rng.randn(b, cfg.n_audio_frames, cfg.d_model)
                         * 0.02).astype(np.float32)
    return out


def jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def offset(cfg) -> int:
    return cfg.n_vision_tokens if cfg.family == "vlm" else 0


def close(got, want, tol: float = 1e-5, what: str = ""):
    """max |got - want| <= tol * max |want|."""
    got, want = np_(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def check_forward(arch: str) -> None:
    jcfg, tcfg, jp, tp = setup(arch)
    bt = batch(jcfg)
    fam = jreg.get_family(jcfg)
    want = jax.jit(lambda p, b: fam.model_forward(p, b, jcfg))(jp, jb(bt))
    got = treg.get_family(tcfg).model_forward(tp, tb(bt), tcfg)
    close(got, want, what="logits")


def check_prefill_decode(arch: str, static: bool = False, s: int = 12) -> None:
    """Prefill's last logits and every cache leaf, then two decode steps'
    logits and caches, against the reference."""
    jcfg, tcfg, jp, tp = setup(arch, static)
    jfam, tfam = jreg.get_family(jcfg), treg.get_family(tcfg)
    bt = batch(jcfg, s=s)
    max_len = offset(jcfg) + s + 4
    empty = tfam.init_cache(tcfg, 2, max_len, device="cpu")
    jempty = jfam.init_cache(jcfg, 2, max_len)
    assert sorted(empty) == sorted(jempty)
    for k in empty:
        assert tuple(empty[k].shape) == tuple(jempty[k].shape), k
        assert not empty[k].any()
    # jitted: one compile is faster here than the eager op-by-op dispatch
    jprefill = jax.jit(lambda p, b: jfam.model_prefill(p, b, jcfg, max_len))
    jdecode = jax.jit(lambda p, c, t, q: jfam.model_decode(p, c, t, q, jcfg))
    jlast, jcache = jprefill(jp, jb(bt))
    last, cache = tfam.model_prefill(tp, tb(bt), tcfg, max_len)
    close(last, jlast, what="prefill logits")
    assert sorted(cache) == sorted(jcache)
    for k in jcache:
        close(cache[k], jcache[k], what=f"prefill cache {k}")
    tok = np.argmax(np.asarray(jlast)[:, :jcfg.vocab_size], -1).astype(np.int32)
    for step in range(2):
        pos = np.full((2,), offset(jcfg) + s + step, np.int32)
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(tok),
                                  jnp.asarray(pos))
        logits, cache = tfam.model_decode(tp, cache, torch.as_tensor(tok),
                                          torch.as_tensor(pos), tcfg)
        close(logits, jlogits, what=f"decode {step} logits")
        for k in jcache:
            close(cache[k], jcache[k], what=f"decode {step} cache {k}")
        tok = np.argmax(np.asarray(jlogits)[:, :jcfg.vocab_size],
                        -1).astype(np.int32)


def check_prefill_decode_equals_forward(arch: str, s: int) -> None:
    """The port alone: prefill of s tokens then one decode step equals the
    forward over the s + 1 tokens (the cache path is exact)."""
    _, tcfg, _, tp = setup(arch)
    fam = treg.get_family(tcfg)
    bt = tb(batch(tcfg, s=s, seed=5))
    last, cache = fam.model_prefill(tp, bt, tcfg, offset(tcfg) + s + 2)
    close(last, fam.model_forward(tp, bt, tcfg)[:, -1], what="prefill")
    nxt = last[:, :tcfg.vocab_size].argmax(-1).to(torch.int32)
    pos = torch.full((2,), offset(tcfg) + s, dtype=torch.int32)
    dl, _ = fam.model_decode(tp, cache, nxt, pos, tcfg)
    b2 = dict(bt, tokens=torch.cat([bt["tokens"], nxt[:, None].to(
        bt["tokens"].dtype)], 1))
    close(dl, fam.model_forward(tp, b2, tcfg)[:, -1], what="decode")


def check_generate(arch: str, mode: str, max_new: int = 8,
                   reference_mode: str = "") -> None:
    """``ServeEngine.generate`` against the JAX ServeEngine: tokens equal,
    logprobs within 1e-5, the same site sparsity (1e-6) and tracker.
    ``reference_mode`` runs the reference in another mode where its own
    fails (statistics change no number of the stream); the port's sites
    are then only held to [0, 1]."""
    reuse, track, static = MODES[mode]
    jcfg, tcfg, jp, tp = setup(arch, static)
    bt = batch(jcfg, s=8, seed=2)
    max_len = offset(jcfg) + 8 + max_new
    jreuse, jtrack, _ = MODES[reference_mode or mode]
    want = JServeEngine(jcfg, jp, max_len=max_len, track_sparsity=jtrack
                        ).generate(jb(bt), max_new=max_new,
                                   reuse_window=jreuse)
    got = ServeEngine(tcfg, tp, max_len=max_len, track_sparsity=track,
                      device="cpu").generate(bt, max_new=max_new,
                                             reuse_window=reuse)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs),
                               rtol=0, atol=1e-5)
    if reference_mode:
        assert got.site_sparsity and all(
            0.0 <= v <= 1.0 for v in got.site_sparsity.values())
        return
    assert sorted(got.site_sparsity) == sorted(want.site_sparsity)
    for k, v in want.site_sparsity.items():
        assert abs(got.site_sparsity[k] - v) <= 1e-6, k
    if track or reuse:
        assert got.site_sparsity
    assert (got.aggregated is None) == (want.aggregated is None)
    if want.aggregated is not None:
        np.testing.assert_array_equal(got.aggregated.used,
                                      want.aggregated.used)
        np.testing.assert_array_equal(got.aggregated.curve,
                                      want.aggregated.curve)


def check_grads(arch: str) -> None:
    """lm_loss and its gradients against ``jax.value_and_grad`` (the
    reference's params and the port's f32 masters), then the four remat
    policies' gradients bit for bit. Returns the port's gradient tree."""
    jcfg, tcfg, jp, tp = setup(arch, train=True)
    bt = batch(jcfg, b=2, s=10, seed=3)
    mask = (np.random.RandomState(4).rand(2, 10) > 0.2).astype(np.float32)
    jbt, tbt = jb(dict(bt, loss_mask=mask)), tb(dict(bt, loss_mask=mask))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jstep.lm_loss(p, jbt, jcfg), has_aux=True))(jp)
    tl, tg = tstep.loss_and_grads(tp, tbt, tcfg)
    assert abs(float(tl) - float(jl)) <= 1e-5
    want, got = [np.asarray(x) for x in jax.tree.leaves(jg)], flatten(tg)
    assert [w.shape for w in want] == [tuple(g.shape) for g in got]
    gmax = max(np.abs(w).max() for w in want)
    err = max(np.abs(np_(g) - w).max() for g, w in zip(got, want))
    assert err <= 1e-5 * gmax, (err, gmax)
    grads = {}
    for pol in POLICIES:
        leaves = [p.detach().requires_grad_(True) for p in flatten(tp)]
        loss, _ = tstep.lm_loss(unflatten(tp, leaves), tbt, tcfg,
                                remat_policy=pol)
        grads[pol] = torch.autograd.grad(loss, leaves)
    for pol in POLICIES[1:]:
        assert all(torch.equal(a, b) for a, b in
                   zip(grads["none"], grads[pol])), pol
    return unflatten(tp, list(grads["none"]))
