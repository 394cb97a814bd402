"""The port's Whisper-style encoder-decoder family against the JAX package
on the CPU, at f32, on the reference's smoke weights converted through
numpy (tolerances in tests/torch_families.py): config, forward logits,
prefill caches (self K/V, cross K/V over the frames) and two decode steps,
dense and at static tile capacities; prefill then decode equal to the
forward over s + 1 tokens; ``ServeEngine`` streams in three modes; loss,
gradients (reaching the encoder) and the four remat policies; the
encoder's bidirectional attention; the full-width head geometry (12 MHA
heads padded to 16); the legacy CLI."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as F
from repro.configs import get_config as jget_config
from repro.models import encdec as jencdec
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import common as cm
from repro_torch.models import encdec
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

ARCH = "whisper-small"


def test_config_equals_reference():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jget_config(ARCH))
    np.testing.assert_array_equal(encdec.sinusoid(24, 64),
                                  jencdec.sinusoid(24, 64))


def test_forward_logits_match_reference():
    F.check_forward(ARCH)


@pytest.mark.parametrize("static", [False, True])
def test_prefill_and_decode_match_reference(static):
    F.check_prefill_decode(ARCH, static)


@pytest.mark.parametrize("s", [12, 37])
def test_prefill_then_decode_equals_forward(s):
    F.check_prefill_decode_equals_forward(ARCH, s)


@pytest.mark.parametrize("mode", list(F.MODES))
def test_generate_matches_reference(mode):
    F.check_generate(ARCH, mode)


def test_loss_grads_and_remat_policies_reach_the_encoder():
    """The decoder blocks close over the encoder output: under every remat
    policy (bit-equal gradients) each encoder leaf gets a gradient."""
    grads = F.check_grads(ARCH)
    for leaf in jax.tree.leaves(jax.tree.map(F.np_, grads["enc_layers"])):
        assert np.abs(leaf).max() > 0


def test_encoder_attends_both_ways():
    """The encoder output at frame 0 depends on the last frame (causal=False)."""
    _, tcfg, _, tp = F.setup(ARCH)
    frames = torch.as_tensor(F.batch(tcfg)["frames"])
    out = encdec.encode(tp, frames, tcfg)
    moved = frames.clone()
    moved[:, -1] += 1.0
    assert (encdec.encode(tp, moved, tcfg)[:, 0] - out[:, 0]).abs().max() > 0


def test_full_width_attention_geometry_matches_reference():
    """whisper-small: 12 MHA heads of 64 padded to 16 (zero K/V for the
    padded heads); the parameter shapes equal the reference's."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    g, jg = T.attn_geometry(cfg), JT.attn_geometry(jcfg)
    assert (g.hp, g.kvp, g.group, g.head_dim) == (jg.hp, jg.kvp, jg.group,
                                                  jg.head_dim) == (16, 16, 1, 64)
    want = jax.eval_shape(lambda: JT.init_attn(jax.random.PRNGKey(0), jcfg,
                                               jnp.float32))
    got = T.init_attn(cfg, cm.ParamInit(0, torch.device("cpu"), torch.float32))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert not got["wk"][:, 12:].any() and got["wk"][:, :12].abs().min() >= 0
    np.testing.assert_array_equal(F.np_(g.q_slot_mask()), jg.q_slot_mask())


def test_serve_cli_legacy_path(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--tokens", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 6) tokens; aggregated FFN sparsity" in out, out
