"""The port's observability (repro_torch.obs and its engine wiring) against
the JAX reference on the CPU, at f32.

* Metrics primitives: on the same hypothesis-drawn registry operations the
  port's ``render``, ``merge_snapshots``, ``hist_quantile``,
  ``snapshot_quantile``, ``render_prometheus`` and ``parse_prometheus``
  give what the reference's give (identical text, equal floats); and the
  reference's own properties hold for the port: associative merges,
  quantiles inside the true quantile's bucket, monotone counters,
  mismatched geometry raising.
* Observability changes nothing: the port's f32 greedy streams are
  identical with the hub on and with ``EngineObs.disabled()`` in the
  plain, spec and predictor modes; a disabled hub records nothing; the
  hooks' own time stays under the reference's ceiling.
* The hub against the reference's on the same workload and converted
  weights (tiny-relu, 2 slots, block 8, γ = 2; and tiny-moe): plain,
  chunked with the prefix cache, predictor, spec with the 1-layer random
  draft and with the target as its own draft, tiny-moe, and a
  preempt/resume cycle. Request and token counters, steps, preemptions,
  drafts, predictor counts, every histogram's series and counts (the
  phase= series included) are equal; ``metrics_snapshot()`` has the same
  keys with floats within 1e-6; with ``track_sparsity`` every request's
  tracker equals the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro import obs as jobs
from repro.configs import get_config as jget_config
from repro.launch.serve_api import build_engine as jbuild
from repro.launch.serve_api import parse_args as jparse
from repro.serving import ContinuousBatchingEngine as JEngine
from repro_torch import obs as tobs
from repro_torch.launch.serve_api import build_engine, parse_args
from repro_torch.obs import (EngineObs, Histogram, Registry, format_statusz,
                             hist_quantile, merge_snapshots,
                             parse_prometheus, render_prometheus,
                             snapshot_quantile)
from torch_twin import port_twin

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

BASE_ARGS = ["--arch", "tiny-relu", "--f32", "--n-slots", "2",
             "--block-size", "8", "--max-blocks", "4", "--gamma", "2"]
MODES = ["plain", "spec", "predictor"]


def _engine(mode: str = "plain", obs_on: bool = True):
    eng = build_engine(parse_args(BASE_ARGS + ["--mode", mode,
                                               "--device", "cpu"]))
    if not obs_on:
        # swap in the null hub after the build (build_engine makes the
        # default enabled one); the scheduler shares the engine's hub
        eng.obs = EngineObs.disabled()
        eng.scheduler.obs = eng.obs
    return eng


def _prompts(n: int = 3, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 256, 3 + 2 * i)]
            for i in range(n)]


def _serve(eng, prompts, budgets):
    uids = [eng.submit(p, m) for p, m in zip(prompts, budgets)]
    res = eng.run()
    return {u: [int(t) for t in res[u].tokens] for u in uids}


# ---------------------------------------------------------------------------
# metrics primitives, against the reference's

_NAMES = ("repro_a_total", "repro_b", "repro_c_seconds", "repro_d_ratio")
_LABELS = ({}, {"reason": "length"}, {"phase": "dispatch"},
           {"k": 'q"uo\\te'})


def _ops(seed: int, n: int):
    """n registry operations: counter incs, gauge sets and histogram
    observations (below lo, in range, overflow, integral values) under a
    few label sets, one histogram geometry per name."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice("cgh")
        name = _NAMES[rng.randrange(len(_NAMES))] + "_" + kind
        v = rng.choice([rng.uniform(0, 1e-4), rng.uniform(1e-4, 50.0),
                        rng.uniform(50.0, 1e4), float(rng.randint(0, 9))])
        ops.append((kind, name, v, _LABELS[rng.randrange(len(_LABELS))]))
    return ops


def _registry(mod, ops):
    r = mod.Registry()
    for kind, name, v, labels in ops:
        if kind == "c":
            r.counter(name, "a counter").inc(v, **labels)
        elif kind == "g":
            r.gauge(name, "a gauge").set(v, **labels)
        else:
            r.histogram(name, "a histogram", unit="seconds", lo=1e-3,
                        factor=2.0, n_buckets=12).observe(v, **labels)
    return r


@settings(max_examples=30, deadline=None)
@given(hst.integers(0, 10 ** 6), hst.integers(0, 10 ** 6),
       hst.integers(1, 60), hst.floats(0.0, 1.0))
def test_metrics_primitives_equal_reference(seed_a, seed_b, n, q):
    ta, tb = (_registry(tobs, _ops(s, n)) for s in (seed_a, seed_b))
    ja, jb = (_registry(jobs, _ops(s, n)) for s in (seed_a, seed_b))
    assert ta.render() == ja.render()
    assert ta.snapshot() == ja.snapshot()
    merged = tobs.merge_snapshots(ta.snapshot(), tb.snapshot())
    jmerged = jobs.merge_snapshots(ja.snapshot(), jb.snapshot())
    assert merged == jmerged
    text = tobs.render_prometheus(merged)
    assert text == jobs.render_prometheus(jmerged)
    assert tobs.parse_prometheus(text) == jobs.parse_prometheus(text)
    for name, m in merged.items():
        if m["kind"] != "histogram":
            continue
        for labels, s in m["series"].items():
            got = tobs.hist_quantile({"bounds": m["bounds"], **s}, q)
            assert got == jobs.hist_quantile({"bounds": m["bounds"], **s}, q)
            assert (tobs.snapshot_quantile(merged, name, q, labels)
                    == jobs.snapshot_quantile(jmerged, name, q, labels))


def _approx_equal(x, y):
    if isinstance(x, dict):
        return (isinstance(y, dict) and x.keys() == y.keys()
                and all(_approx_equal(x[k], y[k]) for k in x))
    if isinstance(x, list):
        return (isinstance(y, list) and len(x) == len(y)
                and all(map(_approx_equal, x, y)))
    if isinstance(x, float):
        return y == pytest.approx(x, rel=1e-9, abs=1e-12)
    return x == y


def _values(seed: int, n: int):
    rng = random.Random(seed)
    # span below-lo, in-range, and overflow territory
    return [rng.uniform(1e-4, 50.0) for _ in range(n)]


def _hist_from(values, lo=1e-3, factor=2.0, n_buckets=12):
    h = Histogram("h", "", lo=lo, factor=factor, n_buckets=n_buckets)
    for v in values:
        h.observe(v)
    return h


@settings(max_examples=30, deadline=None)
@given(hst.integers(0, 10 ** 6), hst.integers(1, 40), hst.integers(1, 40),
       hst.integers(1, 40))
def test_merge_snapshots_is_associative(seed, na, nb, nc):
    vals = _values(seed, na + nb + nc)
    snaps = []
    for chunk in (vals[:na], vals[na:na + nb], vals[na + nb:]):
        r = Registry()
        h = r.histogram("h", "x", lo=1e-3, factor=2.0, n_buckets=12)
        c = r.counter("c", "x")
        g = r.gauge("g", "x")
        for v in chunk:
            h.observe(v)
            c.inc(v, kind="a")
        g.set(chunk[-1] if chunk else 0.0)
        snaps.append(r.snapshot())
    a, b, c_ = snaps
    left = merge_snapshots(merge_snapshots(a, b), c_)
    right = merge_snapshots(a, merge_snapshots(b, c_))
    # bucket counts / counts / min / max are exact; the float sums are
    # associative only up to ulp rounding
    assert _approx_equal(left, right)
    merged = merge_snapshots(*snaps)
    assert merged["h"]["series"][""]["count"] == len(vals)
    assert merged["c"]["series"]['kind="a"'] == pytest.approx(sum(vals))
    assert snapshot_quantile(merged, "h", 1.0) == pytest.approx(max(vals))


@settings(max_examples=30, deadline=None)
@given(hst.integers(0, 10 ** 6), hst.integers(1, 50), hst.floats(0.0, 1.0))
def test_quantile_lands_in_the_true_quantile_bucket(seed, n, q):
    vals = _values(seed, n)
    h = _hist_from(vals)
    got = h.quantile(q)
    assert min(vals) <= got <= max(vals)
    rank = max(1, math.ceil(q * len(vals)))
    true_val = sorted(vals)[rank - 1]
    # got is >= the true quantile and <= its bucket's upper edge
    assert got >= true_val - 1e-12
    upper = next((b for b in h.bounds if true_val <= b), math.inf)
    assert got <= min(upper, max(vals)) + 1e-12


@settings(max_examples=20, deadline=None)
@given(hst.integers(0, 10 ** 6), hst.integers(1, 30))
def test_counter_monotone_and_rejects_negative(seed, n):
    c = tobs.Counter("c", "")
    rng = random.Random(seed)
    last = 0.0
    for _ in range(n):
        c.inc(rng.uniform(0, 5))
        assert c.value() >= last
        last = c.value()
    with pytest.raises(ValueError, match="negative"):
        c.inc(-1.0)
    assert c.value() == last  # the failed inc must not corrupt the series


def test_quantile_rejects_out_of_range_q():
    h = _hist_from([1.0])
    with pytest.raises(ValueError, match="outside"):
        h.quantile(1.5)
    assert Histogram("e", "").quantile(0.5) is None  # empty -> None


def test_prometheus_render_parse_roundtrip():
    r = Registry()
    r.counter("repro_x_total", "a counter").inc(3, reason="length")
    r.gauge("repro_g", "a gauge").set(0.5)
    h = r.histogram("repro_h_seconds", "a histogram", lo=1e-3,
                    factor=2.0, n_buckets=4)
    h.observe(0.002)
    h.observe(10.0)  # overflow bucket
    text = r.render()
    assert '# TYPE repro_x_total counter' in text
    assert '# TYPE repro_h_seconds histogram' in text
    m = parse_prometheus(text)
    assert m[("repro_x_total", 'reason="length"')] == 3
    assert m[("repro_g", "")] == 0.5
    assert m[("repro_h_seconds_count", "")] == 2
    assert m[("repro_h_seconds_bucket", 'le="+Inf"')] == 2
    # cumulative buckets: the last finite edge holds only the small obs
    assert m[("repro_h_seconds_bucket", 'le="0.008"')] == 1
    # unobserved metrics are omitted entirely
    assert render_prometheus(Registry().snapshot()) == ""


def test_merge_rejects_mismatched_geometry_and_kind():
    r1, r2 = Registry(), Registry()
    r1.histogram("h", "", lo=1e-3).observe(1.0)
    r2.histogram("h", "", lo=1e-2).observe(1.0)
    with pytest.raises(ValueError, match="bounds"):
        merge_snapshots(r1.snapshot(), r2.snapshot())
    r3 = Registry()
    r3.counter("h", "").inc()
    with pytest.raises(ValueError, match="histogram"):
        merge_snapshots(r1.snapshot(), r3.snapshot())


def test_hist_quantile_single_observation_is_exact():
    h = _hist_from([0.0123])
    for q in (0.0, 0.5, 1.0):
        assert h.quantile(q) == pytest.approx(0.0123)
    s = {"bounds": h.bounds, **h.snapshot()["series"][""]}
    assert hist_quantile(s, 0.5) == pytest.approx(0.0123)


# ---------------------------------------------------------------------------
# observability changes nothing the engine computes


@pytest.mark.parametrize("mode", MODES)
def test_f32_greedy_byte_identical_with_obs_on_and_off(mode):
    prompts, budgets = _prompts(3), [4, 5, 6]
    on = _serve(_engine(mode, obs_on=True), prompts, budgets)
    off = _serve(_engine(mode, obs_on=False), prompts, budgets)
    assert list(on.values()) == list(off.values())


def test_obs_self_time_is_a_small_fraction_of_step_time():
    eng = _engine("plain")
    _serve(eng, _prompts(3), [5, 5, 5])
    obs = eng.obs
    step_total = obs.h_step.snapshot()["series"][""]["sum"]
    assert step_total > 0
    # the reference's ceiling: 10% of step wall plus 5 ms for coarse timers
    assert obs.self_time_s < 0.10 * step_total + 0.005


def test_disabled_obs_records_nothing():
    eng = _engine("plain", obs_on=False)
    _serve(eng, _prompts(2), [4, 4])
    assert eng.obs.snapshot() == {}
    assert eng.obs.spans == {}
    assert eng.obs.self_time_s == 0.0
    assert eng.obs.render() == ""


@pytest.mark.parametrize("mode", MODES)
def test_metric_helpers_never_raise(mode):
    eng = _engine(mode)
    # fresh engine: nothing measured yet -> None (not a raise, not a fake 0)
    assert eng.predictor_density() is None
    assert eng.predictor_recall() is None
    assert eng.s_agg_window() is None
    assert eng.tile_activity_rate() is None
    assert eng.weight_io_saved() == 0.0
    assert eng.prefix_hit_rate() == 0.0
    assert None not in eng.metrics_snapshot().values()
    _serve(eng, _prompts(2), [4, 4])
    snap = eng.metrics_snapshot()
    assert None not in snap.values()
    assert snap["steps"] == eng.t
    if mode == "predictor":
        assert 0.0 < snap["predictor_density"] <= 1.0
        assert 0.0 <= snap["predictor_recall"] <= 1.0
    else:
        assert "predictor_density" not in snap
        assert "predictor_recall" not in snap
    if mode != "spec":
        assert "s_agg_window" not in snap


def test_metrics_omit_unavailable_series():
    eng = _engine("plain")
    _serve(eng, _prompts(2), [4, 4])
    text = eng.obs.render()
    # mode-gated series never fire in plain mode -> absent, not zero
    assert "repro_predictor_active_neurons_total" not in text
    assert "repro_draft_tokens_proposed_total" not in text
    assert "repro_requests_submitted_total 2" in text


def test_json_event_log_covers_the_lifecycle():
    events = []
    eng = _engine("plain")
    eng.obs.log_event = events.append
    _serve(eng, _prompts(1), [4])
    kinds = [e["event"] for e in events]
    for kind in ("submit", "admit", "first_token", "finish"):
        assert kind in kinds, kinds
    finish = events[kinds.index("finish")]
    assert finish["reason"] == "length" and finish["n_tokens"] == 4
    assert all("ts" in e for e in events)
    json.dumps(events)  # the --log-json stream must be JSON-serializable


def test_statusz_renders_for_disabled_obs():
    eng = _engine("plain", obs_on=False)
    _serve(eng, _prompts(1), [3])
    text = format_statusz(eng)
    assert "observability=off" in text and "tp=1" in text
    assert "latency" not in text


# ---------------------------------------------------------------------------
# the hub, metrics_snapshot and trackers against the reference's

CASES = ["plain", "chunked-prefix", "predictor", "spec", "spec-self", "moe",
         "preempt"]
_RUNS = {}


def _reference_engine(case: str):
    """The reference engine of a case, with per-request sparsity tracking
    (the launcher's build, its config replaced)."""
    args = list(BASE_ARGS)
    if case in ("predictor", "spec"):
        args += ["--mode", case]
    if case == "moe":
        args[1] = "tiny-moe"
    if case == "chunked-prefix":
        args += ["--prefill-chunk", "4", "--prefix-cache"]
    jeng = jbuild(jparse(args))
    cfg = dataclasses.replace(jeng.config, track_sparsity=True)
    if case == "spec-self":  # the target drafts for itself: α = 1
        cfg = dataclasses.replace(cfg, draft_cfg=jeng.cfg,
                                  draft_params=jeng.params, gamma=2)
    if case == "preempt":  # one slot, a five-block pool, chunked prefill
        cfg = dataclasses.replace(cfg, n_slots=1, n_blocks=5,
                                  prefill_chunk=4, prefix_cache=True)
    return JEngine(jeng.cfg, jeng.params, config=cfg)


def _drive(eng, case: str):
    """The case's workload through either engine (the same API); returns
    the uids. "preempt": a priority-2 request arrives while the only slot
    decodes a priority-0 one, and preempts it."""
    if case == "preempt":
        low, high = _prompts(2, seed=15)
        uids = [eng.submit(low + low, 10, reuse_window=2, priority=0,
                           slo_ms=1e6)]
        while True:  # run until mid-decode with a few tokens out
            eng.step()
            slots = [s for s in eng.scheduler.slots if s is not None]
            if slots and not slots[0].prefilling and len(slots[0].out) >= 3:
                break
        uids.append(eng.submit(high, 4, priority=2, slo_ms=1e6))
        eng.run()
        return uids
    prompts = _prompts(4)
    if case == "chunked-prefix":  # a shared full block: prefix-cache hits
        shared = _prompts(1, seed=8)[0] * 3
        prompts = [shared[:8] + p for p in prompts]
    uids = [eng.submit(p, 4 + i % 3, reuse_window=0 if "spec" in case else 2)
            for i, p in enumerate(prompts)]
    eng.run()
    return uids


def _served(case: str):
    if case not in _RUNS:
        jeng = _reference_engine(case)
        teng = port_twin(jeng)
        uids = _drive(jeng, case)
        assert _drive(teng, case) == uids
        for u in uids:
            assert (teng.scheduler.results[u].tokens.tolist()
                    == jeng.scheduler.results[u].tokens.tolist())
        _RUNS[case] = (jeng, teng, uids)
    return _RUNS[case]


_COUNTERS = ("c_submitted", "c_admitted", "c_finished", "c_tokens",
             "c_prefill", "c_prefill_cached", "c_steps", "c_preempted",
             "c_resumed", "c_draft_proposed", "c_draft_accepted",
             "c_pred_active", "c_pred_miss")


@pytest.mark.parametrize("case", CASES)
def test_obs_counters_equal_reference(case):
    jeng, teng, uids = _served(case)
    jo, to = jeng.obs, teng.obs
    for attr in _COUNTERS:
        assert getattr(to, attr).series == getattr(jo, attr).series, attr
    assert to.steps == jo.steps == teng.t == jeng.t
    tsnap, jsnap = to.snapshot(), jo.snapshot()
    hists = sorted(n for n, m in jsnap.items() if m["kind"] == "histogram")
    assert hists == sorted(n for n, m in tsnap.items()
                           if m["kind"] == "histogram")
    for name in hists:
        assert ({k: s["count"] for k, s in tsnap[name]["series"].items()}
                == {k: s["count"] for k, s in jsnap[name]["series"].items()})
    phases = set(tsnap["repro_engine_step_phase_seconds"]["series"])
    assert phases == set(jsnap["repro_engine_step_phase_seconds"]["series"])
    assert {'phase="admit"', 'phase="dispatch"', 'phase="host_sync"',
            'phase="sample"', 'phase="prefill"'} <= phases
    assert to.g_info.series.keys() == jo.g_info.series.keys()
    if case == "spec-self":
        assert 0 < to.c_draft_accepted.value() == to.c_draft_proposed.value()
    if case == "predictor":
        assert to.c_pred_active.value() > 0
    if case == "preempt":
        assert to.c_preempted.value(priority="0") == 1
        assert to.c_resumed.value() == 1
    if case == "chunked-prefix":
        assert to.c_prefill_cached.value() > 0


@pytest.mark.parametrize("case", CASES)
def test_metrics_snapshot_equals_reference(case):
    jeng, teng, _ = _served(case)
    got, want = teng.metrics_snapshot(), jeng.metrics_snapshot()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k
    assert "tile_activity_rate" in got
    assert got["prefill_tokens_saved"] == teng.prefill_tokens_saved()
    # /statusz renders the port's engine with the reference's layout
    text = format_statusz(teng)
    assert text.splitlines()[0] == format_statusz(jeng).splitlines()[0]


@pytest.mark.parametrize("case", CASES)
def test_tracked_sparsity_equals_reference(case):
    jeng, teng, uids = _served(case)
    assert sorted(teng.trackers) == sorted(jeng.trackers) == sorted(uids)
    for u in uids:
        got, want = teng.trackers[u], jeng.trackers[u]
        assert got.curve == pytest.approx(want.curve, abs=1e-6)
        assert got.aggregated_sparsity() == pytest.approx(
            want.aggregated_sparsity(), abs=1e-6)
        np.testing.assert_array_equal(got.used, want.used)
