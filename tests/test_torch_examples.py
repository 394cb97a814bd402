"""The PyTorch port's examples, its legacy engine keywords and
``Predictor.layer_tau``, on the CPU.

* Each ``examples/*_torch.py`` ``main`` runs with ``--device cpu`` at cut
  step counts and prints its ``OK`` line.
* The quickstart's site sparsity and MACs per token equal the
  reference's ``measure_site_sparsity`` and ``core/flops.py`` on the same
  weights (the port's seeded init, converted through numpy) and tokens.
* ``ContinuousBatchingEngine(cfg, params, **kwargs)``: warns once per
  process, builds the ``EngineConfig`` the keywords name, raises
  TypeError on an unknown keyword and when given ``config=`` as well (the
  reference's tests/test_slo_scheduler.py cases).
* ``Predictor.layer_tau`` reads each layer's fitted threshold, as the
  reference's does on the same predictor."""
import importlib.util
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import flops as jflops
from repro.core import relufication as jrelu
from repro.core.sparsity import measure_site_sparsity as jmeasure
from repro.models import registry as jreg
from repro.predictor import calibrate as jcalibrate
from repro_torch.configs import get_config
from repro_torch.core import relufication as trelu
from repro_torch.models import registry
from repro_torch.predictor import calibrate as tcalibrate
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving import config as config_mod
from torch_twin import port_cfg, port_params, port_predictor

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "quickstart": [],
    "serve_sparse": ["--train-steps", "3", "--draft-steps", "2"],
    "train_relufication": ["--steps", "3", "--finetune-steps", "2"],
}


def _example(name):
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = _example(name).main(EXAMPLES[name] + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == f"{name} OK"
    assert isinstance(out, dict)


def test_quickstart_figures_match_reference(capsys):
    out = _example("quickstart").main(["--device", "cpu"])
    capsys.readouterr()
    tcfg = trelu.relufy_stage2(get_config("tiny"))
    jcfg = jrelu.relufy_stage2(jget_config("tiny"))
    tp = registry.get_family(tcfg).init_params(tcfg, seed=0, device="cpu")

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        return jnp.asarray(t.float().numpy())  # bf16 values, held in f32

    toks = np.random.RandomState(1).randint(0, tcfg.vocab_size, (2, 32))
    want = jmeasure(to_jax(tp), {"tokens": jnp.asarray(toks)}, jcfg)
    got = out["sparsity"]
    for k in ("mean/qkv", "mean/up", "mean/down"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert 0.3 < got["mean/down"] < 0.7
    levels = jflops.SparsityLevels(qkv=got["mean/qkv"], up=got["mean/up"],
                                   down=got["mean/down"])
    assert out["macs_dense"] == jflops.macs_per_token(jcfg) / 1e6
    assert out["macs_sparse"] == jflops.macs_per_token(jcfg, levels) / 1e6
    assert out["max_abs_err"] == 0.0 and 0 < out["nvalid"] <= 2


def _tiny(name="tiny-relu"):
    cfg = get_config(name).replace(compute_dtype="float32")
    return cfg, registry.get_family(cfg).init_params(cfg, seed=0,
                                                     device="cpu")


def test_engine_rejects_config_plus_legacy_kwargs():
    cfg, params = _tiny()
    with pytest.raises(TypeError, match="not both"):
        ContinuousBatchingEngine(cfg, params, config=EngineConfig(),
                                 device="cpu", n_slots=2)


def test_legacy_kwargs_shim_warns_once_and_matches_config():
    cfg, params = _tiny()
    config_mod._LEGACY_KWARGS_WARNED = False
    with pytest.warns(DeprecationWarning, match="EngineConfig"):
        legacy = ContinuousBatchingEngine(cfg, params, n_slots=2,
                                          block_size=8, max_blocks_per_seq=6,
                                          prefill_chunk=4, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ContinuousBatchingEngine(cfg, params, n_slots=2, block_size=8,
                                 max_blocks_per_seq=6, device="cpu")
    assert not [w for w in caught  # warn once: the second use is silent
                if issubclass(w.category, DeprecationWarning)
                and "EngineConfig" in str(w.message)]
    assert legacy.config == EngineConfig(n_slots=2, block_size=8,
                                         max_blocks_per_seq=6,
                                         prefill_chunk=4)
    with pytest.raises(TypeError, match="bogus_knob"):
        ContinuousBatchingEngine(cfg, params, bogus_knob=1, device="cpu")


def test_legacy_kwargs_engine_serves_as_the_config_engine():
    cfg, params = _tiny()
    prompts = [np.arange(1, n + 1) for n in (5, 9, 3)]
    streams = []
    for kw in (dict(config=EngineConfig(n_slots=2, prefill_chunk=4)),
               dict(n_slots=2, prefill_chunk=4)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = ContinuousBatchingEngine(cfg, params, device="cpu", **kw)
        uids = [eng.submit(p, 4, reuse_window=2) for p in prompts]
        res = eng.run()
        streams.append([res[u].tokens.tolist() for u in uids])
    assert streams[0] == streams[1]


def test_layer_tau_reads_each_layers_threshold():
    jcfg = jget_config("tiny-relu").replace(compute_dtype="float32")
    jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    toks = jax.random.randint(jax.random.PRNGKey(3), (2, 16), 0,
                              jcfg.vocab_size)
    jpred = jcalibrate(jp, jcfg, {"tokens": toks}, kind="lowrank",
                       target_recall=0.9, tile=16)
    tpred = port_predictor(jpred)
    taus = [tpred.layer_tau(layer) for layer in range(jcfg.n_layers)]
    assert taus == [jpred.layer_tau(layer) for layer in range(jcfg.n_layers)]
    assert all(isinstance(t, float) for t in taus) and len(set(taus)) > 1
    # the port's own calibration on the converted weights: the same taus
    tcfg = port_cfg(jcfg)
    mine = tcalibrate(port_params(jp, tcfg), tcfg,
                      {"tokens": torch.as_tensor(np.array(toks))},
                      kind="lowrank", target_recall=0.9, tile=16)
    np.testing.assert_allclose(
        [mine.layer_tau(layer) for layer in range(tcfg.n_layers)], taus,
        rtol=1e-4, atol=1e-5)
