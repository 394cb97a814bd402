"""The port's Zamba-2 hybrid family (Mamba-2 SSD layers and one shared
attention+FFN block) against the JAX package on the CPU, at f32, on the
reference's smoke weights converted through numpy (tolerances in
tests/torch_families.py): config and segments, forward logits, prefill
caches (SSM state, conv tail, the shared block's K/V per application) and
two decode steps, dense and at static tile capacities, at a short prompt,
a prime length over the SSD chunk (one-token chunks) and a two-chunk
length; prefill then decode equal to the forward over s + 1 tokens;
``ServeEngine`` streams in three modes; loss, gradients and the four
remat policies; the shared block's full-width head geometry; the legacy
CLI."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_families as F
from repro.configs import get_config as jget_config
from repro.models import common as jcm
from repro.models import hybrid as jhybrid
from repro.models import transformer as JT
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import common as cm
from repro_torch.models import hybrid
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

ARCH = "zamba2-7b"


def test_config_and_segments_equal_reference():
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      (smoke_config(ARCH), F.jsmoke_config(ARCH))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert hybrid._segments(cfg) == jhybrid._segments(jcfg)
        assert hybrid.n_attn_applications(cfg) == \
            jhybrid.n_attn_applications(jcfg)
    assert hybrid.n_attn_applications(get_config(ARCH)) == 13


def test_forward_logits_match_reference():
    F.check_forward(ARCH)


@pytest.mark.parametrize("static,s", [(False, 12), (True, 12), (False, 37),
                                      (False, 48)])
def test_prefill_and_decode_match_reference(static, s):
    """s = 37 is prime and over the smoke chunk of 32: chunks of one token;
    s = 48: two chunks of 24."""
    assert cm._largest_divisor_leq(37, 32) == 1
    F.check_prefill_decode(ARCH, static, s=s)


@pytest.mark.parametrize("s", [12, 37])
def test_prefill_then_decode_equals_forward(s):
    F.check_prefill_decode_equals_forward(ARCH, s)


@pytest.mark.parametrize("mode", ["dense", "static"])
def test_generate_matches_reference(mode):
    F.check_generate(ARCH, mode)


def test_generate_with_tracking_matches_reference_stream():
    """γ = 3 with track_sparsity: the reference's hybrid decode collects its
    statistics inside the lax.scan over each segment's layers, where they
    cannot be fetched, so its tracked generate fails. The port's tracked
    stream equals the reference's untracked one; its sites (shared by
    every layer, no per-layer masks, so γ-window reuse keeps no mask) are
    the last writer's: down_in of the last Mamba-2 layer, qkv_in and up_in
    of the shared block."""
    F.check_generate(ARCH, "reuse3_track", reference_mode="dense")
    _, tcfg, _, tp = F.setup(ARCH)
    res = F.ServeEngine(tcfg, tp, max_len=24, track_sparsity=True,
                        device="cpu").generate(F.batch(tcfg, s=8), max_new=4,
                                               reuse_window=3)
    assert sorted(res.site_sparsity) == ["down_in", "qkv_in", "up_in"]
    assert not res.aggregated.curve  # no per-layer masks to track


def test_loss_grads_and_remat_policies_match_reference():
    grads = F.check_grads(ARCH)
    assert all(bool(g.any()) for g in (grads["shared"]["attn"]["wq"],
                                       grads["layers"]["ssm"]["out_proj"]))


def test_full_width_shared_block_geometry_matches_reference():
    """zamba2's shared block: 32 MHA heads of 112, no padding; its
    parameter shapes equal the reference's (abstract init there)."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    g, jg = T.attn_geometry(cfg), JT.attn_geometry(jcfg)
    assert (g.hp, g.kvp, g.group, g.head_dim) == (jg.hp, jg.kvp, jg.group,
                                                  jg.head_dim) == (32, 32, 1, 112)
    want = jax.eval_shape(lambda: JT.init_attn(jax.random.PRNGKey(0), jcfg,
                                               jnp.float32))
    got = T.init_attn(cfg, cm.ParamInit(0, torch.device("cpu"),
                                        torch.bfloat16))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert (got["wq"].reshape(cfg.d_model, -1).shape[1] % 8,
            jcm.padded_vocab(cfg.vocab_size)) == (0, 32768)


def test_serve_cli_legacy_path(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--tokens", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 6) tokens; aggregated FFN sparsity" in out, out
