"""The port's Mamba-1 family (falcon-mamba-7b) against the JAX package on
the CPU, at f32, on the reference's smoke weights converted through numpy
(tolerances in tests/torch_families.py): config, forward logits,
prefill caches (SSM state, conv tail) and two decode steps, dense and at
static tile capacities (relufied gate, out_proj gathered); prefill then
decode equal to the forward over s + 1 tokens; ``ServeEngine`` streams
in three modes; loss, gradients and the four remat policies; the
selective scan's doubling against a sequential loop; the legacy CLI."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_families as F
from repro.configs import get_config as jget_config
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import mamba

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"


def test_config_equals_reference():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jget_config(ARCH))
    cfg = smoke_config(ARCH)
    assert (cfg.d_ff, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk) == (
        0, 8, 16, 32)


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


def test_loss_grads_and_remat_policies_match_reference():
    F.check_grads(ARCH)


@pytest.mark.parametrize("s", [1, 2, 5, 8, 13])
def test_selective_scan_equals_sequential_recurrence(s):
    g = torch.Generator().manual_seed(s)
    dA = torch.rand((2, s, 3, 4), generator=g)
    dBx = torch.randn((2, s, 3, 4), generator=g)
    h, want = torch.zeros(2, 3, 4), []
    for t in range(s):
        h = dA[:, t] * h + dBx[:, t]
        want.append(h)
    torch.testing.assert_close(mamba.selective_scan(dA, dBx),
                               torch.stack(want, 1), rtol=1e-6, atol=1e-6)


def test_conv_tail_is_a_copy():
    """The cached tail owns its storage: a view would keep each layer's
    whole pre-conv sequence alive until the prefill's cache is built."""
    x1 = torch.randn(2, 12, 8).chunk(2, dim=-1)[0]
    tail = mamba.conv_tail(x1, 4)
    assert torch.equal(tail, x1[:, -3:])
    assert tail.untyped_storage().nbytes() == tail.numel() * tail.element_size()


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_activation_register_and_sparsity_of_match_reference(eps):
    import jax.numpy as jnp
    from repro.core import activations as jacts
    from repro_torch.core import activations as tacts

    x = np.random.RandomState(3).randn(64).astype(np.float32)
    x[::3] = 0.0
    got = tacts.sparsity_of(torch.as_tensor(x), eps)
    assert got.dtype == torch.float32
    assert float(got) == float(jacts.sparsity_of(jnp.asarray(x), eps))
    tacts.register("half_relu", lambda t: 0.5 * torch.relu(t))
    try:
        np.testing.assert_array_equal(
            F.np_(tacts.get("half_relu")(torch.as_tensor(x))),
            0.5 * np.maximum(x, 0))
    finally:
        del tacts._REGISTRY["half_relu"]


def test_prompt_shorter_than_the_conv_window_raises():
    _, tcfg, _, tp = F.setup(ARCH)
    toks = torch.as_tensor(F.batch(tcfg, s=2)["tokens"])
    with pytest.raises(ValueError, match="shorter than the conv window"):
        mamba.model_prefill(tp, {"tokens": toks}, tcfg, 8)


def test_serve_cli_legacy_path(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--tokens", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 6) tokens; aggregated FFN sparsity nan" in out, out
