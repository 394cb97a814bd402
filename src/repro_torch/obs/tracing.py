"""Step-phase tracing and per-request spans for the serving engine.

``EngineObs`` is the observability hub one ``ContinuousBatchingEngine``
(and its scheduler + async front) feeds:

* ``StepTrace`` — wall-clock phase timer for one ``engine.step()``:
  admit / prefill / dispatch / host_sync / sample, bracketed with
  ``perf_counter`` context managers. The engine hands the trace to
  ``step_end`` together with values it ALREADY holds on the host
  (occupancy, pool use, the step's measured density from the arrays
  ``_account()`` fetched) — observability adds zero device syncs.

* ``RequestSpan`` — one request's lifecycle (queued → prefilled →
  decoding → finished/cancelled), driven by scheduler state transitions
  (``serving/scheduler.py`` calls the ``req_*`` hooks at submit / admit /
  seed / record / retire / cancel). Terminal spans feed the TTFT / TPOT /
  queue-wait / e2e histograms behind the latency percentiles.

Disabled observability (``EngineObs.disabled()``) turns every hook into
an early return and ``step_start`` into a shared null trace whose
``phase()`` is a no-op — the house invariant that f32 greedy streams are
byte-identical with observability on or off is pinned by
tests/test_torch_obs.py,
and ``self_time_s`` (accumulated inside the hooks themselves) bounds the
per-step bookkeeping cost.

A copy of the reference's ``obs/tracing.py``. In the port's eager engine
``dispatch`` is the host queueing the step's kernels and ``host_sync`` the
host waiting for the card: the step's device-to-host fetches, two in a
plain decode step and three in predictor and speculative mode.
Speculative mode's proposal fetch falls in ``dispatch``, and
``track_sparsity``'s activity fetch in ``sample``.
The scheduler is host-only with no torch import; so is this module — hooks
must stay stdlib-only (see obs/metrics.py).
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Optional

from repro_torch.obs.metrics import Registry

__all__ = ["StepTrace", "RequestSpan", "EngineObs", "format_statusz",
           "PHASES"]

# engine.step() phase names, in execution order
PHASES = ("admit", "prefill", "dispatch", "host_sync", "sample")

_pc = time.perf_counter


class StepTrace:
    """Per-phase wall-clock accumulator for one engine step."""
    __slots__ = ("t0", "phases")

    def __init__(self):
        self.t0 = _pc()
        self.phases: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t = _pc()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (_pc() - t)


class _NullTrace:
    """Shared no-op trace handed out when observability is disabled, so
    the engine's ``with st.phase(...)`` brackets cost one empty context
    manager and nothing else."""
    __slots__ = ()

    @contextmanager
    def phase(self, name: str):
        yield


_NULL_TRACE = _NullTrace()


@dataclass
class RequestSpan:
    """One request's serving lifecycle, timestamped with ``perf_counter``.

    States: queued (submitted) → prefilling (admitted) → decoding (first
    token) → finished. Latency derivations:

    * queue wait = t_admitted − t_queued (slot + block allocation wait)
    * TTFT       = t_first − t_queued (engine-side: submit → first token)
    * TPOT       = (t_last − t_first) / (n_tokens − 1), needs ≥ 2 tokens
    * e2e        = t_finished − t_queued
    """
    uid: int
    prompt_len: int
    max_new: int
    t_queued: float
    t_admitted: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    t_finished: Optional[float] = None
    n_tokens: int = 0
    cached_tokens: int = 0
    state: str = "queued"
    finish_reason: Optional[str] = None
    # -- SLO scheduling --
    priority: int = 0
    slo_ms: Optional[float] = None
    preemptions: int = 0
    slo_met: Optional[bool] = None

    def queue_wait_s(self) -> Optional[float]:
        if self.t_admitted is None:
            return None
        return self.t_admitted - self.t_queued

    def ttft_s(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return self.t_first - self.t_queued

    def tpot_s(self) -> Optional[float]:
        if self.t_first is None or self.t_last is None or self.n_tokens < 2:
            return None
        return (self.t_last - self.t_first) / (self.n_tokens - 1)

    def e2e_s(self) -> Optional[float]:
        if self.t_finished is None:
            return None
        return self.t_finished - self.t_queued


class EngineObs:
    """Observability hub for one serving engine: a metrics registry, live
    + recently finished request spans, an optional structured-event sink
    (``log_event`` receives one plain dict per lifecycle event — the
    ``--log-json`` stream), and a self-time accumulator bounding the cost
    of the bookkeeping itself."""

    def __init__(self, registry: Optional[Registry] = None, *,
                 enabled: bool = True,
                 log_event: Optional[Callable[[dict], None]] = None,
                 max_finished_spans: int = 64):
        self.enabled = enabled
        self.registry = registry if registry is not None else Registry()
        self.log_event = log_event
        self.spans: Dict[int, RequestSpan] = {}
        self.finished_spans: Deque[RequestSpan] = deque(
            maxlen=max_finished_spans)
        self.self_time_s = 0.0  # wall time spent inside these hooks
        self.steps = 0          # steps that did work (mirrors the counter)
        r = self.registry
        # -- engine step metrics --------------------------------------------
        self.c_steps = r.counter(
            "repro_engine_steps_total", "engine steps that did work")
        self.h_step = r.histogram(
            "repro_engine_step_seconds", "wall time of one engine step",
            unit="seconds")
        self.h_phase = r.histogram(
            "repro_engine_step_phase_seconds",
            "wall time per step phase (admit/prefill/dispatch/host_sync/"
            "sample)", unit="seconds")
        self.g_active = r.gauge(
            "repro_slots_active", "slots decoding this step")
        self.g_occupancy = r.gauge(
            "repro_batch_occupancy_ratio", "active slots / n_slots")
        self.g_queue = r.gauge(
            "repro_queue_depth", "requests waiting for admission")
        self.g_pool_used = r.gauge(
            "repro_pool_blocks_used", "KV pool blocks allocated")
        self.g_pool_total = r.gauge(
            "repro_pool_blocks_total", "allocatable KV pool blocks")
        self.h_density = r.histogram(
            "repro_step_ffn_density",
            "measured FFN weight-read fraction per step (mean over active "
            "slots)", unit="ratio", lo=1e-3, factor=1.26, n_buckets=25)
        self.h_bytes = r.histogram(
            "repro_step_ffn_bytes",
            "modeled per-device FFN weight bytes read this step "
            "(density x dense bytes / TP)", unit="bytes",
            lo=1024.0, factor=4.0, n_buckets=16)
        # -- request lifecycle ----------------------------------------------
        self.c_submitted = r.counter(
            "repro_requests_submitted_total", "requests accepted by submit()")
        self.c_admitted = r.counter(
            "repro_requests_admitted_total", "requests admitted to a slot")
        self.c_finished = r.counter(
            "repro_requests_finished_total",
            "terminal requests by finish reason")
        self.c_tokens = r.counter(
            "repro_generated_tokens_total", "tokens emitted to requests")
        self.c_prefill = r.counter(
            "repro_prefill_tokens_total", "prompt tokens admitted")
        self.c_prefill_cached = r.counter(
            "repro_prefill_tokens_cached_total",
            "prompt tokens served from the prefix cache")
        self.h_ttft = r.histogram(
            "repro_request_ttft_seconds",
            "submit to first token (engine-side)", unit="seconds")
        # per-priority-class TTFT lives in its OWN histogram: the percentile
        # keys derived from h_ttft predate priorities and must keep their
        # unlabeled series
        self.h_class_ttft = r.histogram(
            "repro_request_class_ttft_seconds",
            "submit to first token by priority class", unit="seconds")
        self.c_preempted = r.counter(
            "repro_requests_preempted_total",
            "decode slots preempted under pool/priority pressure")
        self.c_resumed = r.counter(
            "repro_requests_resumed_total",
            "preempted requests re-admitted (resume via chunked prefill)")
        self.h_tpot = r.histogram(
            "repro_request_tpot_seconds",
            "mean inter-token time per finished request", unit="seconds")
        self.h_queue_wait = r.histogram(
            "repro_request_queue_wait_seconds",
            "submit to slot admission", unit="seconds")
        self.h_e2e = r.histogram(
            "repro_request_e2e_seconds", "submit to terminal event",
            unit="seconds")
        # -- mode-specific (series appear only when the mode produces them) --
        self.c_draft_proposed = r.counter(
            "repro_draft_tokens_proposed_total",
            "draft tokens submitted for verification (speculative mode)")
        self.c_draft_accepted = r.counter(
            "repro_draft_tokens_accepted_total",
            "draft tokens the target accepted (speculative mode)")
        self.c_pred_active = r.counter(
            "repro_predictor_active_neurons_total",
            "active FFN neurons measured in-graph (predictor telemetry)")
        self.c_pred_miss = r.counter(
            "repro_predictor_missed_neurons_total",
            "active neurons the predictor's tiles missed (recall events)")
        # -- API front-door latency (serving/api.py terminal events) ---------
        self.h_api_ttft = r.histogram(
            "repro_api_ttft_seconds",
            "API submit to first streamed token", unit="seconds")
        self.h_api_total = r.histogram(
            "repro_api_request_seconds", "API submit to terminal event",
            unit="seconds")
        self.g_info = r.gauge(
            "repro_engine_info",
            "static engine configuration (value is always 1)")

    @classmethod
    def disabled(cls) -> "EngineObs":
        """A no-op hub for metrics-off serving (the byte-identity and
        overhead baselines in tests/test_torch_obs.py)."""
        return cls(enabled=False)

    # -- event sink ----------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        if self.log_event is not None:
            self.log_event({"event": kind, "ts": time.time(), **fields})

    # -- engine hooks --------------------------------------------------------
    def set_engine_info(self, **labels) -> None:
        if not self.enabled:
            return
        self.g_info.set(1.0, **{k: str(v) for k, v in labels.items()})

    def step_start(self):
        if not self.enabled:
            return _NULL_TRACE
        return StepTrace()

    def step_end(self, st, *, worked: bool, slots_active: int, n_slots: int,
                 queue_depth: int, pool_used: int, pool_total: int,
                 density: Optional[float] = None,
                 tiles: Optional[float] = None,
                 ffn_bytes: Optional[float] = None) -> None:
        """Close one step trace. Gauges always update (an idle engine still
        reports its occupancy truthfully); step/phase histograms only count
        steps that did work, so percentiles aren't diluted by idle polls."""
        if not self.enabled:
            return
        t = _pc()
        self.g_active.set(slots_active)
        self.g_occupancy.set(slots_active / max(1, n_slots))
        self.g_queue.set(queue_depth)
        self.g_pool_used.set(pool_used)
        self.g_pool_total.set(pool_total)
        if worked:
            self.steps += 1
            self.c_steps.inc()
            self.h_step.observe(t - st.t0)
            for name, dt in st.phases.items():
                self.h_phase.observe(dt, phase=name)
            if density is not None:
                self.h_density.observe(density)
            if tiles is not None:
                self.h_density.observe(tiles, granularity="tile")
            if ffn_bytes is not None:
                self.h_bytes.observe(ffn_bytes)
        self.self_time_s += _pc() - t

    def predictor_counts(self, n_active: int, n_miss: int) -> None:
        """Per-step in-graph recall telemetry sums (predictor mode with
        ``predictor_telemetry=True`` only — the series never exists
        otherwise, and /metrics omits it rather than faking a zero)."""
        if not self.enabled:
            return
        t = _pc()
        self.c_pred_active.inc(n_active)
        self.c_pred_miss.inc(n_miss)
        self.self_time_s += _pc() - t

    # -- scheduler (request lifecycle) hooks ---------------------------------
    def req_submitted(self, uid: int, prompt_len: int, max_new: int,
                      priority: int = 0,
                      slo_ms: Optional[float] = None) -> None:
        if not self.enabled:
            return
        t = _pc()
        self.spans[uid] = RequestSpan(uid=uid, prompt_len=prompt_len,
                                      max_new=max_new, t_queued=t,
                                      priority=priority, slo_ms=slo_ms)
        self.c_submitted.inc()
        self._event("submit", uid=uid, prompt_len=prompt_len,
                    max_new=max_new, priority=priority, slo_ms=slo_ms)
        self.self_time_s += _pc() - t

    def req_admitted(self, uid: int, cached_tokens: int = 0) -> None:
        if not self.enabled:
            return
        t = _pc()
        self.c_admitted.inc()
        span = self.spans.get(uid)
        if span is not None:
            span.t_admitted = t
            span.cached_tokens = cached_tokens
            span.state = "prefilling"
            self.c_prefill.inc(span.prompt_len)
            if cached_tokens:
                self.c_prefill_cached.inc(cached_tokens)
            self.h_queue_wait.observe(span.queue_wait_s())
            self._event("admit", uid=uid, queue_wait_s=span.queue_wait_s(),
                        cached_tokens=cached_tokens)
        self.self_time_s += _pc() - t

    def req_preempted(self, uid: int, n_tokens: int,
                      priority: int = 0) -> None:
        """Slot evicted under pressure: its KV blocks returned to the pool,
        the request (prompt + ``n_tokens`` generated so far) requeued."""
        if not self.enabled:
            return
        t = _pc()
        self.c_preempted.inc(priority=str(priority))
        span = self.spans.get(uid)
        if span is not None:
            span.state = "preempted"
            span.preemptions += 1
        self._event("preempt", uid=uid, n_tokens=n_tokens,
                    priority=priority)
        self.self_time_s += _pc() - t

    def req_resumed(self, uid: int, cached_tokens: int = 0) -> None:
        """Preempted request re-admitted to a slot; its prefix resumes via
        chunked prefill (``cached_tokens`` of it straight from the trie)."""
        if not self.enabled:
            return
        t = _pc()
        self.c_resumed.inc()
        span = self.spans.get(uid)
        if span is not None:
            span.state = "prefilling"
            if cached_tokens:
                span.cached_tokens = cached_tokens
                self.c_prefill_cached.inc(cached_tokens)
        self._event("resume", uid=uid, cached_tokens=cached_tokens)
        self.self_time_s += _pc() - t

    def req_tokens(self, uid: int, n: int) -> None:
        """``n`` tokens just emitted to ``uid`` (seed / decode / accepted
        speculative window). The first call marks prefill complete."""
        if not self.enabled:
            return
        t = _pc()
        self.c_tokens.inc(n)
        span = self.spans.get(uid)
        if span is not None:
            if span.t_first is None:
                span.t_first = t
                span.state = "decoding"
                self.h_ttft.observe(span.ttft_s())
                self.h_class_ttft.observe(span.ttft_s(),
                                          priority=str(span.priority))
                self._event("first_token", uid=uid, ttft_s=span.ttft_s())
            elif span.state == "preempted":
                span.state = "decoding"
            span.t_last = t
            span.n_tokens += n
        self.self_time_s += _pc() - t

    def req_finished(self, result) -> None:
        """Terminal transition (retire_finished, or a queued-cancel's
        synthesized result). ``result`` is a scheduler RequestResult."""
        if not self.enabled:
            return
        t = _pc()
        reason = result.finish_reason
        self.c_finished.inc(reason=reason)
        if result.draft_proposed:
            self.c_draft_proposed.inc(result.draft_proposed)
            self.c_draft_accepted.inc(result.draft_accepted)
        span = self.spans.pop(result.uid, None)
        if span is not None:
            span.t_finished = t
            span.state = "finished"
            span.finish_reason = reason
            span.preemptions = getattr(result, "preemptions",
                                       span.preemptions)
            span.slo_met = getattr(result, "slo_met", None)
            self.h_e2e.observe(span.e2e_s())
            tpot = span.tpot_s()
            if tpot is not None:
                self.h_tpot.observe(tpot)
            self.finished_spans.append(span)
            self._event("finish", uid=result.uid, reason=reason,
                        n_tokens=span.n_tokens, ttft_s=span.ttft_s(),
                        tpot_s=tpot, e2e_s=span.e2e_s(),
                        priority=span.priority,
                        preemptions=span.preemptions, slo_met=span.slo_met)
        self.self_time_s += _pc() - t

    # -- API front-door hooks ------------------------------------------------
    def api_request_done(self, uid: int, ttft_s: Optional[float],
                         total_s: Optional[float], n_tokens: int) -> None:
        """Stamped by serving/api.py on each terminal TokenEvent: the
        client-visible latency, measured at the async boundary (includes
        loop scheduling — the engine-side span histograms do not)."""
        if not self.enabled:
            return
        t = _pc()
        if ttft_s is not None:
            self.h_api_ttft.observe(ttft_s)
        if total_s is not None:
            self.h_api_total.observe(total_s)
        self._event("api_finish", uid=uid, ttft_s=ttft_s, total_s=total_s,
                    n_tokens=n_tokens)
        self.self_time_s += _pc() - t

    # -- read side -----------------------------------------------------------
    def quantile(self, name: str, q: float, **labels) -> Optional[float]:
        m = self.registry.get(name)
        if m is None or m.kind != "histogram":
            return None
        return m.quantile(q, **labels)

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def render(self) -> str:
        return self.registry.render()

    def reset(self) -> None:
        """Clear every series and span (benchmark warm-up isolation — see
        Registry.reset; never used on a live server)."""
        self.registry.reset()
        self.spans.clear()
        self.finished_spans.clear()
        self.self_time_s = 0.0
        self.steps = 0


# ---------------------------------------------------------------------------
# /statusz rendering


def _ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{v * 1e3:.2f}ms"


def format_statusz(engine) -> str:
    """Human-readable snapshot of a ContinuousBatchingEngine: config,
    occupancy, the scalar engine metrics (None-valued ones omitted — the
    satellite convention), latency percentiles from the span histograms,
    and live / recently finished requests. Pure read — safe to render
    between steps from the serve loop."""
    obs = engine.obs
    sched = engine.scheduler
    mode = ("spec" if engine.spec
            else "predictor" if engine.predictor is not None else "plain")
    lines = [
        f"repro serving engine — arch={engine.cfg.name} mode={mode} "
        f"steps={engine.t}",
        f"config: n_slots={sched.n_slots} block_size={sched.block_size} "
        f"max_blocks_per_seq={sched.max_blocks_per_seq} "
        f"prefill_chunk={engine.prefill_chunk} tp={engine.tp} "
        f"fast_kernels={engine.fast_kernels} "
        f"observability={'on' if obs.enabled else 'off'}",
        f"occupancy: {len(sched.active_indices())}/{sched.n_slots} slots "
        f"decoding, {len(sched.prefill_indices())} prefilling, "
        f"{len(sched.queue)} queued, pool "
        f"{sched.allocator.allocated}/{sched.allocator.n_blocks - 1} blocks, "
        f"{sched.preemption_count} preemptions",
    ]
    snap = engine.metrics_snapshot()
    lines.append("engine metrics: " + (", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in sorted(snap.items())) or "(none)"))
    if obs.enabled:
        lines.append("latency (p50/p99): " + ", ".join(
            f"{label} {_ms(obs.quantile(name, 0.5))}/"
            f"{_ms(obs.quantile(name, 0.99))}"
            for label, name in (
                ("ttft", "repro_request_ttft_seconds"),
                ("tpot", "repro_request_tpot_seconds"),
                ("queue_wait", "repro_request_queue_wait_seconds"),
                ("step", "repro_engine_step_seconds"))))
        live = sorted(obs.spans.values(), key=lambda s: s.uid)
        lines.append(f"live requests ({len(live)}):")
        for s in live[:32]:
            lines.append(f"  uid={s.uid} {s.state} prio={s.priority} "
                         f"tokens={s.n_tokens}/{s.max_new} "
                         f"prompt={s.prompt_len} "
                         f"queue_wait={_ms(s.queue_wait_s())} "
                         f"ttft={_ms(s.ttft_s())}")
        lines.append(f"recently finished ({len(obs.finished_spans)}):")
        for s in list(obs.finished_spans)[-8:]:
            lines.append(f"  uid={s.uid} {s.finish_reason} "
                         f"tokens={s.n_tokens} ttft={_ms(s.ttft_s())} "
                         f"tpot={_ms(s.tpot_s())} e2e={_ms(s.e2e_s())}")
        lines.append(f"obs self-time: {obs.self_time_s * 1e3:.2f}ms over "
                     f"{obs.steps} steps")
    return "\n".join(lines) + "\n"
