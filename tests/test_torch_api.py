"""The port's serving front door on the CPU: ``AsyncServingEngine``
(serving/api.py), the HTTP/SSE server (launch/serve_api.py), its smoke
client and the serving CLI (launch/serve.py).

* The async layer changes WHEN tokens surface, never WHICH: f32 greedy
  streams through ``AsyncServingEngine`` equal the same engine's offline
  ``engine.run()`` byte for byte in the plain, spec and predictor modes,
  and the tokens of mixed greedy and sampled traffic equal the JAX
  ``AsyncServingEngine``'s on converted weights (logprobs within 1e-5).
* Streams interleave, a mid-stream disconnect cancels its request while
  serving goes on, submit validation reaches the caller, and every step
  runs on one worker thread under inference mode.
* The in-process HTTP wire: SSE and ``"stream": false`` round trips, a
  400 naming an unknown field, ``/metrics`` agreeing with the served
  request, ``/statusz``, ``/healthz``, and ``/profilez`` (403 without its
  flag; with ``--profilez-dir`` a Chrome trace file).
* Entry points: ``launch.serve.main`` prints the reference's report lines;
  ``serve_smoke_client --device cpu`` passes in a subprocess; without CUDA
  and without ``--device cpu`` every launcher raises.
"""
from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch.serve_api import build_engine as jbuild
from repro.launch.serve_api import parse_args as jparse
from repro.serving import AsyncServingEngine as JAsyncServingEngine
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.launch import serve, serve_smoke_client
from repro_torch.launch.serve_api import ApiServer, build_engine, parse_args
from repro_torch.obs import parse_prometheus
from repro_torch.serving import AsyncServingEngine, SamplingParams
from torch_twin import port_twin

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would crowd out the other workers' tests
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300.0

BASE_ARGS = ["--arch", "tiny-relu", "--f32", "--n-slots", "2",
             "--block-size", "8", "--max-blocks", "4", "--gamma", "2"]
MODES = ["plain", "spec", "predictor"]


def _engine(mode: str = "plain"):
    return build_engine(parse_args(BASE_ARGS + ["--mode", mode,
                                               "--device", "cpu"]))


def _prompts(n: int = 4, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 256, 3 + 2 * i)]
            for i in range(n)]


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT_S))


async def _collect(api, prompt, max_new, **kw):
    """Stream one request; returns (streamed tokens, streamed logprobs,
    terminal event)."""
    tokens, lps, final = [], [], None
    async for ev in api.stream(prompt, max_new, **kw):
        if ev.finished:
            final = ev
        else:
            tokens.append(ev.token)
            lps.append(ev.logprob)
    return tokens, lps, final


# ---------------------------------------------------------------------------
# AsyncServingEngine


@pytest.mark.parametrize("mode", MODES)
def test_greedy_streams_byte_identical_to_engine_run(mode):
    """One engine serves both paths (offline run() first, then the async
    API), so the comparison is over identical weights."""
    eng = _engine(mode)
    prompts = _prompts(4)
    budgets = [4 + i % 3 for i in range(len(prompts))]
    uids = [eng.submit(p, m) for p, m in zip(prompts, budgets)]
    ref = eng.run()

    async def serve_all():
        async with AsyncServingEngine(eng) as api:
            return await asyncio.gather(*[
                _collect(api, p, m) for p, m in zip(prompts, budgets)])

    got = _run(serve_all())
    for uid, m, (tokens, lps, final) in zip(uids, budgets, got):
        want = ref[uid]
        assert tokens == [int(t) for t in want.tokens]
        np.testing.assert_array_equal(np.asarray(lps, np.float32),
                                      np.asarray(want.logprobs, np.float32))
        assert final is not None and final.finish_reason == "length"
        assert tokens == [int(t) for t in final.result.tokens]
        assert len(tokens) == m
        assert final.ttft_s is not None and final.ttft_s >= 0.0
        assert final.total_s is not None and final.total_s >= final.ttft_s


@pytest.mark.parametrize("mode", MODES)
def test_streams_equal_reference_async_engine(mode):
    """The reference's launcher engine and the port's twin on its
    converted weights, each behind its own AsyncServingEngine, serve the
    same mixed traffic (greedy, seeded top-k, seeded top-p, unseeded)."""
    jeng = jbuild(jparse(BASE_ARGS + ["--mode", mode]))
    teng = port_twin(jeng)
    prompts = _prompts(4, seed=2)
    kinds = [None, dict(temperature=0.9, top_k=20, seed=5),
             dict(temperature=1.1, top_p=0.8, seed=6),
             dict(temperature=0.7)]

    async def serve_all(api_cls, eng, sp_cls):
        async with api_cls(eng) as api:
            return await asyncio.gather(*[
                _collect(api, p, 5, sampling=sp_cls(**k) if k else None)
                for p, k in zip(prompts, kinds)])

    want = _run(serve_all(JAsyncServingEngine, jeng, JSamplingParams))
    got = _run(serve_all(AsyncServingEngine, teng, SamplingParams))
    for (gt, glp, gf), (wt, wlp, wf) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(glp, wlp, rtol=0, atol=1e-5)
        assert gf.finish_reason == wf.finish_reason


def test_streams_interleave_across_requests():
    """A short request co-scheduled next to a long one streams its first
    token BEFORE the long request finishes."""
    eng = _engine("plain")
    p_long, p_short = _prompts(2, seed=3)
    order = []

    async def client(api, tag, prompt, max_new):
        async for ev in api.stream(prompt, max_new):
            order.append((tag, "done" if ev.finished else ev.index))

    async def serve_all():
        async with AsyncServingEngine(eng) as api:
            await asyncio.gather(client(api, "long", p_long, 12),
                                 client(api, "short", p_short, 3))

    _run(serve_all())
    long_done = order.index(("long", "done"))
    assert order.index(("short", 0)) < long_done, order
    assert order.index(("short", "done")) < long_done, order


def test_midstream_disconnect_cancels_and_serving_continues():
    """Breaking out of events() (the client-disconnect path) retires the
    request with finish_reason "cancelled" and partial output; the engine
    keeps serving other traffic with identical results."""
    eng = _engine("plain")
    p0, p1 = _prompts(2, seed=5)
    ref_uid = eng.submit(p1, 5)
    ref = eng.run()[ref_uid]

    async def serve_all():
        async with AsyncServingEngine(eng) as api:
            uid = await api.submit(p0, 12)
            got = []
            async for ev in api.events(uid):
                got.append(ev.token)
                if len(got) >= 2:
                    break  # closes the generator -> cancel(uid)
            tokens, _, final = await _collect(api, p1, 5)
            return uid, got, tokens, final

    uid, got, tokens, final = _run(serve_all())
    res = eng.scheduler.results[uid]
    assert res.finish_reason == "cancelled"
    assert len(res.tokens) < 12  # partial output only
    assert [int(t) for t in res.tokens][:2] == got
    assert tokens == [int(t) for t in ref.tokens]
    assert final.finish_reason == "length"


def test_submit_validation_surfaces_to_the_caller():
    eng = _engine("plain")

    async def serve_all():
        async with AsyncServingEngine(eng) as api:
            with pytest.raises(ValueError, match="max_new"):
                await api.submit(_prompts(1)[0], 0)
            with pytest.raises(ValueError, match="empty prompt"):
                await api.submit([], 4)
            with pytest.raises(ValueError, match="blocks"):
                await api.submit(list(range(100)), 4)
            # the loop is still healthy after rejects
            ev = await api.generate(_prompts(1)[0], 3)
            assert ev.finish_reason == "length"

    _run(serve_all())


def test_steps_run_on_one_worker_thread_under_inference_mode():
    """Every step of a served workload runs on the same thread, which is
    not the event loop's, with inference mode on (it is per thread)."""
    eng = _engine("plain")
    seen = []
    step = eng.step

    def watched():
        seen.append((threading.get_ident(),
                     torch.is_inference_mode_enabled()))
        out = step()
        seen.append((threading.get_ident(), eng.masks.is_inference()))
        return out

    eng.step = watched

    async def serve_all():
        async with AsyncServingEngine(eng) as api:
            await asyncio.gather(*[_collect(api, p, 4)
                                   for p in _prompts(3, seed=4)])
        return threading.get_ident()

    loop_thread = _run(serve_all())
    threads = {t for t, _ in seen}
    assert len(threads) == 1 and loop_thread not in threads
    assert not any(on for _, on in seen[::2])  # outside step(): off
    assert all(inf for _, inf in seen[1::2])   # tensors made inside: on


# ---------------------------------------------------------------------------
# the in-process HTTP/SSE wire


async def _http(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    raw = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(raw)}\r\n\r\n".encode() + raw)
    await writer.drain()
    data = await reader.read()
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionResetError, BrokenPipeError):
        pass
    head, _, payload = data.partition(b"\r\n\r\n")
    return head.split(b" ", 2)[1].decode(), payload


def _parse_sse(payload: bytes):
    tokens, final, done = [], None, False
    for frame in payload.split(b"\n\n"):
        for line in frame.splitlines():
            if not line.startswith(b"data: "):
                continue
            if line[6:] == b"[DONE]":
                done = True
            else:
                ev = json.loads(line[6:])
                if ev.get("done"):
                    final = ev
                else:
                    tokens.append(ev["token"])
    return tokens, final, done


def _with_server(eng, body, profilez_dir=None):
    """Run ``body(server)`` against an ApiServer on port 0 over ``eng``."""
    async def serve_all():
        async with AsyncServingEngine(eng) as api:
            server = ApiServer(api, mode="plain", profilez_dir=profilez_dir)
            await server.start(port=0)
            try:
                return await body(server)
            finally:
                await server.aclose()
    return _run(serve_all())


def test_http_sse_roundtrip():
    eng = _engine("plain")
    prompt = _prompts(1, seed=9)[0]
    ref_uid = eng.submit(prompt, 4)
    ref = [int(t) for t in eng.run()[ref_uid].tokens]

    async def body(server):
        status, text = await _http(server.port, "GET", "/healthz")
        assert status == "200" and json.loads(text)["ok"]
        status, text = await _http(server.port, "POST", "/v1/generate",
                                   {"prompt": prompt, "max_new": 4})
        assert status == "200"
        tokens, final, done = _parse_sse(text)
        assert done and final is not None
        assert tokens == final["tokens"] == ref
        assert final["finish_reason"] == "length"
        assert final["ttft_s"] is not None
        status, text = await _http(
            server.port, "POST", "/v1/generate",
            {"prompt": prompt, "max_new": 4, "stream": False,
             "temperature": 0.9, "top_k": 8, "seed": 1})
        assert status == "200"
        one = json.loads(text)
        assert one["done"] and len(one["tokens"]) == 4
        status, text = await _http(server.port, "POST", "/v1/generate",
                                   {"max_new": 4})
        assert status == "400" and b"prompt" in text
        status, _ = await _http(server.port, "GET", "/nope")
        assert status == "404"

    _with_server(eng, body)


def test_http_schema_v1_priority_slo_and_unknown_field_400():
    eng = _engine("plain")
    prompt = _prompts(1, seed=11)[0]

    async def body(server):
        status, text = await _http(
            server.port, "POST", "/v1/generate",
            {"prompt": prompt, "max_new": 3, "stream": False,
             "priority": 2, "slo_ms": 60_000.0})
        one = json.loads(text)
        assert status == "200" and one["done"] and one["priority"] == 2
        assert one["preemptions"] == 0 and one["slo_met"] is True
        status, text = await _http(
            server.port, "POST", "/v1/generate",
            {"prompt": prompt, "max_new": 3, "stream": False})
        one = json.loads(text)
        assert one["priority"] == 0 and one["slo_met"] is None
        status, text = await _http(
            server.port, "POST", "/v1/generate",
            {"prompt": prompt, "max_new": 3, "prioritty": 1})
        assert status == "400" and b"prioritty" in text
        # a schema error must not have consumed engine capacity
        status, _ = await _http(server.port, "POST", "/v1/generate",
                                {"prompt": prompt, "max_new": 3})
        assert status == "200"

    _with_server(eng, body)


def test_http_metrics_statusz_healthz_profilez_403():
    eng = _engine("plain")
    prompt = _prompts(1, seed=9)[0]

    async def body(server):
        status, text = await _http(server.port, "POST", "/v1/generate",
                                   {"prompt": prompt, "max_new": 4,
                                    "stream": False})
        served = json.loads(text)
        status, text = await _http(server.port, "GET", "/metrics")
        assert status == "200"
        m = parse_prometheus(text.decode())
        assert m[("repro_requests_submitted_total", "")] == 1
        assert m[("repro_requests_finished_total", 'reason="length"')] == 1
        assert m[("repro_generated_tokens_total", "")] == len(
            served["tokens"])
        assert m[("repro_api_request_seconds_count", "")] == 1
        assert m[("repro_engine_steps_total", "")] == eng.t
        assert ("repro_engine_step_phase_seconds_count",
                'phase="host_sync"') in m
        status, text = await _http(server.port, "GET", "/statusz")
        assert status == "200"
        assert b"repro serving engine" in text
        assert b"recently finished" in text
        # profiling is opt-in: no --profilez-dir -> 403, never 500
        status, _ = await _http(server.port, "GET", "/profilez?ms=5")
        assert status == "403"
        status, text = await _http(server.port, "GET", "/healthz")
        assert status == "200" and json.loads(text)["ok"]

    _with_server(eng, body)


def test_http_profilez_writes_a_trace_on_the_cpu(tmp_path):
    eng = _engine("plain")
    prompt = _prompts(1, seed=9)[0]

    async def body(server):
        gen = asyncio.ensure_future(_http(
            server.port, "POST", "/v1/generate",
            {"prompt": prompt, "max_new": 24, "stream": False}))
        status, text = await _http(server.port, "GET", "/profilez?ms=200")
        assert status == "200", text
        trace = json.loads(text)["trace"]
        status, _ = await gen
        assert status == "200"
        return trace

    trace = _with_server(eng, body, profilez_dir=str(tmp_path))
    assert Path(trace).parent == tmp_path
    events = json.loads(Path(trace).read_text())["traceEvents"]
    assert events


# ---------------------------------------------------------------------------
# entry points


@pytest.mark.parametrize("mode,extra,lines", [
    ("plain", ["--continuous"], []),
    ("spec", ["--speculative", "--gamma", "2"], ["speculative gamma=2"]),
    ("predictor", ["--predictor", "sign"], ["predictor=sign"]),
])
def test_serve_cli_prints_the_report(capsys, mode, extra, lines):
    serve.main(["--arch", "tiny-relu", "--smoke", "--tokens", "6",
                "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    for want in ["continuous batching served 3 requests (18 tokens)",
                 "-- final observability snapshot --",
                 f"arch=tiny-relu-smoke mode={mode}", "engine metrics:",
                 "latency (p50/p99)"] + lines:
        assert want in out, out


def test_serve_smoke_client_passes_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_smoke_client",
         "--mode", "plain", "--device", "cpu",
         "--log", str(tmp_path / "server.log"),
         "--metrics-out", str(tmp_path / "metrics.prom")],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "serve-smoke PASS [plain]" in r.stdout
    assert "repro_requests_submitted_total 9" in (
        tmp_path / "metrics.prom").read_text()


def test_launchers_raise_without_cuda(monkeypatch):
    """No --device means CUDA; with none available every launcher raises
    instead of serving on the CPU. What the CLI does not port raises
    NotImplementedError naming the roadmap (the pod-mesh compile path)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(parse_args(BASE_ARGS))
    for argv in (["--smoke", "--continuous"], ["--smoke"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--arch", "tiny-relu"] + argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_smoke_client.main(["--mode", "plain"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(["--arch", "tiny-relu", "--device", "cpu"])
