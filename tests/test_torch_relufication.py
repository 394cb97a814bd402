"""The port's forward statistics, shift calibration and FLOP accounting
against the reference's, on the CPU at f32 with the same parameters (JAX
init, converted through numpy as f32 masters) and the same numpy tokens.

* ``measure_site_sparsity``: the same keys; each site's zero fraction
  within 1e-6 (counts of exact zeros, after f32 products that sum in
  another order);
* ``preactivation_stats``: the same keys, values within 1e-5 of
  max(1, |value|);
* ``calibrate_shift`` within 1e-5 at three targets, and ``shifted_relufy``
  with it raising the down-projection's input sparsity;
* ``_norm_ppf`` equal to the reference's (the same arithmetic), odd about
  1/2, and within 2e-9 of scipy's normal quantiles where scipy is present
  (Acklam's approximation claims 1.15e-9 relative);
* ``core/flops.py``: ``table1_row``, ``macs_per_token``, ``param_count`` and
  ``model_flops`` equal the reference's on OPT-6.7B and llama-7b at
  relufication stages 1 and 2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.core import flops as jflops
from repro.core import relufication as jrelu
from repro.core import sparsity as jsp
from repro.models import registry as jreg
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import flops as tflops
from repro_torch.core import relufication as trelu
from repro_torch.core import sparsity as tsp
from repro_torch.models import common as tcm

torch.set_num_threads(1)

MODELS = ["tiny-relu", "tiny-opt", "tiny-moe", "tiny-stage2", "tiny"]
_CACHE = {}


def _setup(name):
    if name not in _CACHE:
        base = "tiny" if name == "tiny-stage2" else name
        jcfg = jget_config(base).replace(compute_dtype="float32")
        tcfg = get_config(base).replace(compute_dtype="float32")
        if name == "tiny-stage2":
            jcfg, tcfg = jrelu.relufy_stage2(jcfg), trelu.relufy_stage2(tcfg)
        jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(1), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu", dtype=torch.float32)
        toks = np.random.RandomState(2).randint(0, jcfg.vocab_size, (2, 24))
        _CACHE[name] = (jcfg, tcfg, jp, tp, {"tokens": jnp.asarray(toks)},
                        {"tokens": torch.as_tensor(toks)})
    return _CACHE[name]


@pytest.mark.parametrize("name", MODELS)
def test_site_sparsity_matches_reference(name):
    jcfg, tcfg, jp, tp, jb, tb = _setup(name)
    want = jsp.measure_site_sparsity(jp, jb, jcfg)
    got = tsp.measure_site_sparsity(tp, tb, tcfg)
    assert got.keys() == want.keys()
    # the MoE FFN records no up_in site, in either package
    assert {"mean/qkv", "mean/down"} <= set(got)
    assert ("mean/up" in got) == (tcfg.family == "dense")
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    if name == "tiny-stage2":  # ReLU after the norms: sparse inputs
        assert got["mean/qkv"] > 0.2 and got["mean/up"] > 0.2
    if name == "tiny":  # SiLU: no exact zeros
        assert got["mean/qkv"] == got["mean/down"] == 0.0


@pytest.mark.parametrize("name", MODELS)
def test_preactivation_stats_match_reference(name):
    jcfg, tcfg, jp, tp, jb, tb = _setup(name)
    want = jsp.preactivation_stats(jp, jb, jcfg)
    got = tsp.preactivation_stats(tp, tb, tcfg)
    assert got.keys() == want.keys() and got
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k


@pytest.mark.parametrize("target", [0.5, 0.9, 0.95])
@pytest.mark.parametrize("name", ["tiny-relu", "tiny-stage2", "tiny-moe"])
def test_calibrate_shift_matches_reference(name, target):
    jcfg, tcfg, jp, tp, jb, tb = _setup(name)
    want = jrelu.calibrate_shift(jp, jb, jcfg, target_sparsity=target)
    got = trelu.calibrate_shift(tp, tb, tcfg, target_sparsity=target)
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * max(1.0, abs(want))
    if target == 0.9 and name != "tiny-moe":
        before = tsp.measure_site_sparsity(tp, tb, tcfg)["mean/down"]
        after = tsp.measure_site_sparsity(
            tp, tb, trelu.shifted_relufy(tcfg, got))["mean/down"]
        assert after > before


@pytest.mark.parametrize("q", [1e-6, 0.01, 0.02425, 0.1, 0.5, 0.9, 0.95,
                               0.99, 1 - 1e-6])
def test_norm_ppf(q):
    got = trelu._norm_ppf(q)
    assert got == jrelu._norm_ppf(q)
    assert abs(trelu._norm_ppf(1 - q) + got) <= 1e-9 * max(1.0, abs(got))
    try:
        from scipy.stats import norm
    except ImportError:
        return
    assert abs(got - norm.ppf(q)) <= 2e-9 * max(1.0, abs(norm.ppf(q)))


def test_activity_masks_of_a_stats_decode_step():
    _, tcfg, _, _, _, _ = _setup("tiny-relu")
    stats = tcm.StatsCollector(True)
    masks = np.random.RandomState(0).rand(tcfg.n_layers, tcfg.d_ff) > 0.5
    for i in range(tcfg.n_layers):
        stats.add(f"layer{i}/down_act", torch.as_tensor(masks[i]))
    np.testing.assert_array_equal(tsp.ffn_activity_masks(stats, tcfg), masks)
    assert tsp.ffn_activity_masks(tcm.StatsCollector(True), tcfg).shape == (0, 0)


def _relufied(name, stage, get):
    cfg = get(name)
    rf = trelu if get is get_config else jrelu
    return {0: cfg, 1: rf.relufy_stage1(cfg), 2: rf.relufy_stage2(cfg)}[stage]


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("name", ["opt-6.7b", "llama-7b"])
def test_flops_equal_reference(name, stage):
    tcfg = _relufied(name, stage, get_config)
    jcfg = _relufied(name, stage, jget_config)
    assert tcfg.to_json() == jcfg.to_json()
    for sp in [(0.0, 0.0, 0.0), (0.0, 0.0, 0.97), (0.5, 0.4, 0.97)]:
        tsl, jsl = tflops.SparsityLevels(*sp), jflops.SparsityLevels(*sp)
        assert tflops.table1_row(tcfg, tsl) == jflops.table1_row(jcfg, jsl)
        for ctx in (0, 2048):
            assert tflops.macs_per_token(tcfg, tsl, context=ctx,
                                         include_unembed=True) == \
                jflops.macs_per_token(jcfg, jsl, context=ctx,
                                      include_unembed=True)
    assert tflops.param_count(tcfg) == jflops.param_count(jcfg)
    assert tflops.embed_params(tcfg) == jflops.embed_params(jcfg)
    for shape in SHAPES:
        assert tflops.model_flops(tcfg, SHAPES[shape]) == \
            jflops.model_flops(jcfg, JSHAPES[shape])
    # the shape the card's training phase runs (4 of 32 layers)
    cut = tcfg.replace(n_layers=4)
    assert tflops.model_flops(cut, ShapeConfig("t", "train", 1024, 8)) == \
        jflops.model_flops(jcfg.replace(n_layers=4),
                           JSHAPES["train_4k"].__class__("t", "train", 1024, 8))
