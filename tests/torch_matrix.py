"""One folded workload for the port's parity-matrix tests
(tests/test_torch_spec_matrix.py, tests/test_torch_predictor_matrix.py,
tests/test_torch_moe_capacity.py): several engine features in one run,
driven the same way through the port's engine and the JAX reference's,
and the comparison the matrix makes of the two.

``drive`` submits five requests to a two-slot engine: A greedy with a
stop sequence, B greedy, C sampled with a stop sequence, D greedy, all at
priority 0; after three steps (B decoding, C and D queued) it cancels B
mid-stream and D in the queue, steps once (C takes B's slot), then E
arrives at priority 5, so with both slots busy admission preempts a
priority-0 slot (where chunked prefill lets it resume); then it runs to
the end. The stop sequences come from the port's own runs of the
workload (two tokens of A's stream, one of C's), so both fire
(``find_stops``). ``compare`` holds the port's results against the
reference's: per request tokens exactly, logprobs within 1e-5, finish
reason, preemptions and cached prompt tokens; the scheduler's preemption
count; ``metrics_snapshot()`` key for key within 1e-6; every tracker's
curve, aggregated sparsity and used mask (with ``track_sparsity``)."""
from __future__ import annotations

import numpy as np
import pytest

PROMPTS = ((1, 9), (2, 5), (3, 13), (4, 7), (5, 11))  # (seed, length)
REUSE = (2, 0, 4, 2, 2)  # each request's γ
MAX_NEW = 8


def prompts(vocab: int, shared: int = 0):
    """The five prompts; ``shared`` > 0 prefixes each with the same
    ``shared`` tokens (prefix-cache hits)."""
    head = np.random.RandomState(8).randint(0, vocab, shared).tolist()
    return [head + np.random.RandomState(s).randint(0, vocab, n).tolist()
            for s, n in PROMPTS]


def drive(eng, smp, vocab: int, stops=None, shared: int = 0):
    """Run the folded workload through ``eng`` (either package's engine,
    the same API; ``smp`` its sampling module). ``stops``: {request index:
    stop sequence}. Returns (uids, {uid: result}); a request withdrawn from
    the queue has an empty "cancelled" result."""
    stops = stops or {}
    ps = prompts(vocab, shared)

    def params(i, **kw):
        if i in stops:
            kw["stop"] = (tuple(stops[i]),)
        return smp.SamplingParams(**kw) if kw else None

    sampling = [params(0), params(1),
                params(2, temperature=0.9, top_k=20, seed=7), params(3)]
    uids = [eng.submit(p, MAX_NEW, reuse_window=r, sampling=s, priority=0,
                       slo_ms=1e6)
            for p, r, s in zip(ps[:4], REUSE, sampling)]
    for _ in range(3):
        eng.step()
    assert eng.cancel(uids[1])  # mid-stream
    assert eng.cancel(uids[3])  # still queued: withdrawn at once
    eng.step()  # B's slot freed: C takes it
    uids.append(eng.submit(ps[4], MAX_NEW // 2, reuse_window=REUSE[4],
                           priority=5, slo_ms=1e6))
    return uids, eng.run()


def find_stops(run) -> dict:
    """Stop sequences that fire: tokens 2-3 of A's stream (greedy) in an
    unstopped run, then token 4 of C's (sampled) in a run with A's stop.
    (A stop changes the batches after it fires, and with droppable MoE
    capacity a token's route depends on its batch, so C's stream is read
    after A's stop.) ``run(stops)`` -> (uids, results) of the workload."""
    uids, res = run({})
    stops = {0: [int(t) for t in res[uids[0]].tokens[2:4]]}
    uids, res = run(stops)
    stops[2] = [int(res[uids[2]].tokens[4])]
    return stops


def served(uids, results) -> dict:
    """What ``compare`` reads of a run, as plain values."""
    return {u: dict(
        tokens=np.asarray(results[u].tokens).tolist(),
        logprobs=np.asarray(results[u].logprobs),
        finish=results[u].finish_reason,
        preemptions=results[u].preemptions,
        cached=results[u].cached_prompt_tokens) for u in uids}


def compare(got_eng, got, want_eng, want) -> None:
    """The port's run (engine, ``served``) against the reference's."""
    assert list(got) == list(want)
    for u, w in want.items():
        g = got[u]
        assert g["tokens"] == w["tokens"], u
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], rtol=0,
                                   atol=1e-5)
        for k in ("finish", "preemptions", "cached"):
            assert g[k] == w[k], (u, k)
    assert (got_eng.scheduler.preemption_count
            == want_eng.scheduler.preemption_count)
    gm, wm = got_eng.metrics_snapshot(), want_eng.metrics_snapshot()
    assert gm.keys() == wm.keys()
    for k, v in wm.items():
        assert gm[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
    assert sorted(got_eng.trackers) == sorted(want_eng.trackers)
    for u, w in want_eng.trackers.items():
        g = got_eng.trackers[u]
        assert g.curve == pytest.approx(w.curve, abs=1e-6), u
        assert g.aggregated_sparsity() == pytest.approx(
            w.aggregated_sparsity(), abs=1e-6), u
        np.testing.assert_array_equal(g.used, w.used)
