"""The port's InternVL2 family (dense backbone behind stub vision patches)
against the JAX package on the CPU, at f32, on the reference's smoke
weights converted through numpy (tolerances in tests/torch_families.py):
config, forward logits after the patches, the prefill cache over patches
and tokens and two decode steps, dense and at static tile capacities;
prefill then decode equal to the forward over s + 1 tokens;
``ServeEngine`` streams in three modes; loss, gradients and the four
remat policies; the full-width GQA geometry (14 heads padded to 16 over 2
kv heads); the dense family's numbers unchanged by extra_embeds=None; the
legacy CLI."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as F
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch.configs import ASSIGNED, get_config, list_archs
from repro_torch.launch import serve
from repro_torch.models import common as cm
from repro_torch.models import registry, vlm
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

ARCH = "internvl2-1b"


def test_config_and_assigned_list_equal_reference():
    from repro.configs import ASSIGNED as JASSIGNED
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jget_config(ARCH))
    assert ASSIGNED == JASSIGNED and set(ASSIGNED) <= set(list_archs())
    for name in ASSIGNED:  # every assigned family has a port module
        fam = registry.get_family(get_config(name))
        assert hasattr(fam, "model_decode"), name
    assert vlm.prompt_token_offset(F.smoke_config(ARCH)) == 8


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b",
                                  "whisper-small", "internvl2-1b"])
def test_other_families_declare_no_paged_serving(arch):
    """As in the reference: an empty capability set, so the continuous
    engine raises the uniform capability error and the legacy engine
    serves them."""
    from repro.models import registry as jreg
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    cfg = F.smoke_config(arch).replace(compute_dtype="float32")
    assert registry.serving_caps(cfg) == set() == set(jreg.serving_caps(cfg.family))
    params = registry.get_family(cfg).init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="'paged_decode' serving capability"):
        ContinuousBatchingEngine(cfg, params, EngineConfig(), device="cpu")


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


def test_full_width_gqa_geometry_matches_reference():
    """internvl2-1b: 14 q heads over 2 kv heads of 64, q padded to 16 (8 a
    group, 7 real); the parameter shapes equal the reference's."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    g, jg = T.attn_geometry(cfg), JT.attn_geometry(jcfg)
    assert (g.hp, g.kvp, g.group, g.head_dim) == (jg.hp, jg.kvp, jg.group,
                                                  jg.head_dim) == (16, 2, 8, 64)
    np.testing.assert_array_equal(F.np_(g.q_slot_mask()), jg.q_slot_mask())
    w = np.random.RandomState(0).randn(3, 14, 2).astype(np.float32)
    np.testing.assert_array_equal(F.np_(g.scatter_q(torch.as_tensor(w), 1)),
                                  np.asarray(jg.scatter_q(jnp.asarray(w), 1)))
    want = jax.eval_shape(lambda: JT.init_attn(jax.random.PRNGKey(0), jcfg,
                                               jnp.float32))
    got = T.init_attn(cfg, cm.ParamInit(0, torch.device("cpu"), torch.float32))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def test_forward_without_extra_embeds_is_the_dense_forward():
    """extra_embeds=None and an empty (b, 0, d) prefix give the dense
    family's logits bit for bit."""
    _, tcfg, _, tp = F.setup(ARCH)
    toks = torch.as_tensor(F.batch(tcfg)["tokens"])
    want = T.forward(tp, toks, tcfg)
    empty = torch.zeros((2, 0, tcfg.d_model))
    assert torch.equal(T.forward(tp, toks, tcfg, extra_embeds=empty), want)


def test_serve_cli_legacy_path(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--tokens", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 6) tokens; aggregated FFN sparsity" in out, out


def test_decode_takes_gamma_window_masks():
    """The VLM's decode step is the dense one, ffn_masks included (the
    reference's ``vlm.model_decode`` has no such argument, so its engine's
    masked steps raise TypeError there): all-ones masks change nothing,
    zero masks silence every FFN, and γ = 3 generation runs."""
    _, tcfg, _, tp = F.setup(ARCH)
    bt = F.tb(F.batch(tcfg, s=8))
    off = vlm.prompt_token_offset(tcfg)
    pos = torch.full((2,), off + 8, dtype=torch.int32)
    tok = torch.tensor([3, 5], dtype=torch.int32)

    def step(masks):
        _, cache = vlm.model_prefill(tp, bt, tcfg, off + 12)
        kw = {} if masks is None else {"ffn_masks": masks}
        return vlm.model_decode(tp, cache, tok, pos, tcfg, **kw)[0]

    ones = torch.ones((tcfg.n_layers, tcfg.d_ff))
    assert torch.equal(step(ones), step(None))
    assert not torch.equal(step(torch.zeros_like(ones)), step(None))
    res = F.ServeEngine(tcfg, tp, max_len=off + 16, device="cpu").generate(
        F.batch(tcfg, s=8), max_new=6, reuse_window=3)
    assert res.tokens.shape == (2, 6)
