"""The port's serving bytes-per-step roofline gate against the reference's
(``repro.launch.roofline --serving``), on the CPU at f32, for tiny-relu and
tiny-opt: the same weights (the reference's ``PRNGKey(0)`` init, converted
through numpy), the same requests and calibration tokens.

* autoregressive mode: ``measured``, ``modeled`` and ``counted`` equal the
  reference's ``measured``, ``modeled`` and ``hlo`` to 1e-9 relative (the
  counted bytes of the frozen step's down-projection matmuls on "meta"
  tensors stand for the reference's dots counted in its compiled HLO);
* predictor mode: density and the three figures within 1e-6 relative;
* ``check_serving`` passes, and an altered record gives the reference's
  violation texts (its "HLO-counted" named "counted");
* ``counted_decode_ffn_bytes`` scales with ``n_layers``, also at OPT-6.7B's
  width, with no memory and no card;
* ``main(["--serving", "--check", "--device", "cpu"])`` exits 0, and the
  dry-run table form reads ``launch/dryrun.py``'s records (a tiny cell's
  and an errored one's) into its table.

The reference's records take ~15 s a config here, so they are made once
per config for the module."""
import copy
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import roofline as jroof
from repro.models import registry as jreg
from repro_torch.configs import get_config
from repro_torch.launch import roofline as troof
from torch_twin import port_cfg, port_params

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["tiny-relu", "tiny-opt"])
def records(request):
    name = request.param
    want = jroof.serving_records(name)
    jcfg = jget_config(name).replace(compute_dtype="float32")
    jp = jreg.get_family(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    calib = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (4, 32), 0,
                                          jcfg.vocab_size))
    got = troof.serving_records(name, params=port_params(jp, port_cfg(jcfg)),
                                calib_tokens=calib, device="cpu")
    return name, got, want


def _by_mode(recs):
    return {r["mode"]: r for r in recs}


def test_ar_figures_equal_reference(records):
    name, got, want = records
    g, w = _by_mode(got)["ar"], _by_mode(want)["ar"]
    assert g["config"] == w["config"] == name
    assert g["density"] == w["density"] == 1.0
    for mine, theirs in (("measured_bytes", "measured_bytes"),
                         ("modeled_bytes", "modeled_bytes"),
                         ("counted_bytes", "hlo_bytes")):
        assert g[mine] == pytest.approx(w[theirs], rel=1e-9), mine
    assert g["ratio"] == pytest.approx(1.0, rel=1e-9)
    assert g["t_memory_h100"] == g["modeled_bytes"] / troof.H100_HBM_BYTES_PER_S


def test_predictor_figures_match_reference(records):
    _, got, want = records
    g, w = _by_mode(got)["predictor"], _by_mode(want)["predictor"]
    assert 0.0 < g["density"] < 1.0
    assert g["density"] == pytest.approx(w["density"], rel=1e-6)
    for mine, theirs in (("measured_bytes", "measured_bytes"),
                         ("modeled_bytes", "modeled_bytes"),
                         ("counted_bytes", "hlo_bytes")):
        assert g[mine] == pytest.approx(w[theirs], rel=1e-6), mine


def test_check_serving_passes_and_reports_the_reference_texts(records):
    _, got, want = records
    assert troof.check_serving(got) == [] == jroof.check_serving(want)
    # one modeled and one counted figure pushed out of the band; the port's
    # check reads the same figures under its own key for the count
    w = copy.deepcopy(want)
    w[1]["modeled_bytes"] *= 1.2
    w[1]["ratio"] = w[1]["modeled_bytes"] / w[1]["measured_bytes"]
    w[0]["hlo_bytes"] *= 0.8
    g = [dict(r, counted_bytes=r["hlo_bytes"]) for r in w]
    mine = troof.check_serving(g, tol=0.15)
    theirs = jroof.check_serving(w, tol=0.15)
    assert len(mine) == 2
    assert mine == [t.replace("HLO-counted", "counted") for t in theirs]
    assert troof.check_serving(g, tol=0.25) == []


@pytest.mark.parametrize("name", ["tiny-relu", "tiny-opt", "opt-6.7b"])
def test_counted_bytes_scale_with_layers(name):
    base = get_config(name)
    if name.startswith("tiny"):
        base = base.replace(compute_dtype="float32")
    itemsize = torch.empty((), dtype=getattr(torch, base.compute_dtype)
                           ).element_size()
    per_layer = base.d_ff * base.d_model * itemsize
    for n in (1, 2, 3):
        cfg = base.replace(n_layers=n)
        assert troof.counted_decode_ffn_bytes(cfg) == n * per_layer
        assert troof.counted_decode_ffn_bytes(cfg, 3) == 3 * n * per_layer


def test_main_gate_exits_zero_and_dry_run_form_exits_two(capsys, tmp_path):
    assert troof.main(["--serving", "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "counted" in out and "t_mem(H100)" in out
    assert "roofline check OK (tol 0.15)" in out
    # the dry-run form reads launch/dryrun.py's records: a tiny cell's
    # record and an errored cell's, in the table
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("tiny-relu", "decode_32k", mesh_shape=(2, 2),
                          batch=4, seq=32)
    path = tmp_path / "dryrun.jsonl"
    path.write_text(json.dumps(rec) + "\n" + json.dumps(
        {"arch": "zamba2-7b", "shape": "train_4k", "error": "x"}) + "\n")
    assert troof.load(str(path))[0] == rec
    assert troof.main([str(path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:3] == ["cell", "mesh", "sparse"]
    row = lines[1].split()
    assert row[:2] == ["tiny-relu/decode_32k", "2x2"]
    assert row[6] == rec["bottleneck"][:4]
    assert float(row[8]) == pytest.approx(rec["peak_bytes_per_chip"] / 1e9,
                                          abs=0.05)
    assert row[9] == "Y"
    assert lines[2].split()[:3] == ["zamba2-7b/train_4k", "16x16", "-"]
    assert "ERROR" in lines[2]
    assert troof.main([str(path), "--md"]) == 0
    assert capsys.readouterr().out.startswith("| cell")
