"""HTTP/SSE front door for the port's async streaming serving engine (the
reference's ``launch/serve_api.py``, on torch).

A deliberately dependency-free server (stdlib asyncio only) exposing
``AsyncServingEngine`` over:

  GET  /healthz          -> {"ok": true, "mode": ..., "steps": ...,
                             "uptime_s": ...}
  GET  /metrics          -> Prometheus text exposition of the engine's
                            observability registry (repro_torch.obs, the
                            reference's names): request / token counters,
                            step-phase + TTFT/TPOT/queue-wait histograms,
                            occupancy gauges. Unavailable series (e.g.
                            predictor recall with telemetry off) are
                            OMITTED, never rendered as zeros.
  GET  /statusz          -> human-readable engine snapshot: config,
                            occupancy, scalar metrics, latency
                            percentiles, live + recent requests
  GET  /profilez?ms=N    -> opt-in torch.profiler capture (CPU activity,
                            and CUDA activity on the card) of the next N ms
                            of serving, written as a Chrome trace into
                            --profilez-dir (403 unless the flag was given;
                            one capture at a time)
  POST /v1/generate      -> token stream (SSE) or one JSON body

``--log-json PATH`` additionally streams one JSON object per request
lifecycle event (submit / admit / first_token / finish / api_finish) to
PATH ("-" = stderr) — the structured event log.

Request body (JSON)::

    {"prompt": [1, 2, 3],        # token ids (required)
     "max_new": 16,              # generation budget (required)
     "stream": true,             # default true: SSE; false: one JSON reply
     "temperature": 0.8,         # 0 = greedy (default)
     "top_k": 40, "top_p": 0.95,
     "seed": 7,                  # omit -> the engine's --base-seed
     "stop": [[5, 9]],           # stop sequences (token ids)
     "reuse_window": 0,          # γ-window weight reuse (plain mode)
     "priority": 0,              # scheduling class (higher = more urgent)
     "slo_ms": 500.0}            # TTFT target; graded, never scheduled on

This is schema v1: UNKNOWN fields are rejected with a 400 naming the
field (a typo'd "priorty" must not silently serve at default priority).
The terminal event carries the scheduling outcome — ``priority``,
``preemptions``, ``slo_met`` — alongside the token list and latency.

Streaming responses are standard SSE: one ``data: {json}`` line per token,
a terminal ``data:`` object with ``"done": true`` plus the finish reason,
full token list, and serving latency (ttft_s / total_s), then
``data: [DONE]``. A client that disconnects mid-stream cancels its
request — the engine slot is reclaimed for other traffic.

Run (the engine runs on CUDA unless ``--device cpu`` is given; with no
CUDA and no ``--device cpu`` it raises)::

    python -m repro_torch.launch.serve_api --arch opt-6.7b --port 8151
    python -m repro_torch.launch.serve_api --arch tiny-relu --f32 \\
        --device cpu --port 8151

The launcher prints one ``READY {...}`` JSON line to stdout once the
socket is bound — process supervisors (launch/serve_smoke_client.py) wait
on it and read the bound port from it. ``build_engine(args)`` is
importable so callers can construct a bit-identical offline reference
engine for byte-identity checks.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from typing import Optional


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tiny-relu")
    ap.add_argument("--smoke", action="store_true",
                    help="shrink --arch via configs.smoke_config")
    ap.add_argument("--mode", choices=["plain", "spec", "predictor"],
                    default="plain")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft length γ (spec mode)")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-blocks", type=int, default=6)
    ap.add_argument("--f32", action="store_true",
                    help="force float32 compute (exactness smoke runs)")
    ap.add_argument("--init-seed", type=int, default=0,
                    help="seed of the (random) weights")
    ap.add_argument("--base-seed", type=int, default=0,
                    help="engine base seed for unseeded sampled requests")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when CUDA is absent) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8151)
    ap.add_argument("--log-json", default=None, metavar="PATH",
                    help="append one JSON object per request lifecycle "
                         "event to PATH ('-' = stderr)")
    ap.add_argument("--profilez-dir", default=None, metavar="DIR",
                    help="enable GET /profilez?ms=N torch.profiler captures "
                         "into DIR (disabled when omitted)")
    return ap.parse_args(argv)


def build_engine(args: argparse.Namespace):
    """Construct the serving engine the launcher fronts. Deterministic in
    ``args`` (random weights from --init-seed, the draft's from seed 2,
    calibration tokens from seed 7), so a caller building it again gets a
    reference engine producing byte-identical greedy streams."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import common as cm
    from repro_torch.models import registry
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    device = cm.resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.f32:
        cfg = cfg.replace(compute_dtype="float32")
    fam = registry.get_family(cfg)
    params = fam.init_params(cfg, seed=args.init_seed, device=device)
    kw = dict(n_slots=args.n_slots, block_size=args.block_size,
              max_blocks_per_seq=args.max_blocks,
              base_seed=args.base_seed)
    if args.prefill_chunk:
        kw.update(prefill_chunk=args.prefill_chunk,
                  prefix_cache=args.prefix_cache)
    if args.mode == "spec":
        dcfg = cfg.replace(name=f"{cfg.name}-draft", n_layers=1)
        kw.update(draft_cfg=dcfg, gamma=args.gamma,
                  draft_params=fam.init_params(dcfg, seed=2, device=device))
    elif args.mode == "predictor":
        from repro_torch.core import relufication
        from repro_torch.core.activations import is_sparse_activation
        if not is_sparse_activation(cfg.activation):
            cfg = relufication.relufy_stage1(cfg)
            params = fam.init_params(cfg, seed=args.init_seed, device=device)
        cfg = cfg.replace_sparsity(predictor="sign", predictor_recall=0.99)
        kw.update(predictor=smoke_predictor(params, cfg, device))
    return ContinuousBatchingEngine(cfg, params,
                                    config=EngineConfig(**kw).validate(),
                                    device=device)


def smoke_predictor(params, cfg, device):
    """The launchers' predictor: ``cfg.sparsity``'s kind and recall target,
    calibrated on 4 x 32 tokens from seed 7 at tile 1 (exact row-skipping,
    observable on the tiny smoke models, where 128-wide tiles are never
    all-zero)."""
    import torch

    from repro_torch.predictor import calibrate_from_config
    gen = torch.Generator().manual_seed(7)
    calib = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                     generator=gen).to(device)}
    return calibrate_from_config(params, cfg, calib, tile=1)


# /v1/generate schema v1: the complete field set. Anything else is a 400
# naming the offender — a misspelled "priorty" must fail loudly, not
# silently serve at the default priority.
_SCHEMA_V1_FIELDS = frozenset({
    "prompt", "max_new", "stream", "temperature", "top_k", "top_p",
    "seed", "stop", "reuse_window", "priority", "slo_ms"})


def _sampling_from(body: dict):
    from repro_torch.serving import SamplingParams
    return SamplingParams(
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        seed=(int(body["seed"]) if body.get("seed") is not None else None),
        stop=tuple(tuple(int(t) for t in s) for s in body.get("stop", [])))


async def _read_request(reader) -> Optional[tuple]:
    """Minimal HTTP/1.1 request parse: (method, path, body-bytes)."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, path, _ = line.decode("latin-1").split(None, 2)
    except ValueError:
        return None
    length = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            length = int(value.strip())
    body = await reader.readexactly(length) if length else b""
    return method.upper(), path, body


def _response(status: str, body: bytes, ctype: str = "application/json",
              stream: bool = False) -> bytes:
    head = [f"HTTP/1.1 {status}", f"Content-Type: {ctype}",
            "Connection: close"]
    if not stream:
        head.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


class ApiServer:
    """One engine, one asyncio TCP server. Kept as a class so in-process
    callers (tests, chip_smoke.py) can drive the exact wire path without a
    subprocess."""

    def __init__(self, api, mode: str = "plain",
                 profilez_dir: Optional[str] = None):
        self.api = api
        self.mode = mode
        self.profilez_dir = profilez_dir
        self._profiling = False  # one torch.profiler capture at a time
        self._t0 = time.monotonic()
        self._server: Optional[asyncio.AbstractServer] = None

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._server = await asyncio.start_server(self._handle, host, port)

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader, writer) -> None:
        try:
            req = await _read_request(reader)
            if req is None:
                return
            method, path, raw = req
            path, _, query = path.partition("?")
            if method == "GET" and path in ("/healthz", "/metrics",
                                            "/statusz", "/profilez"):
                await self._handle_get(writer, path, query)
                return
            if method != "POST" or path != "/v1/generate":
                writer.write(_response("404 Not Found",
                                       b'{"error": "not found"}'))
                await writer.drain()
                return
            try:
                body = json.loads(raw or b"{}")
                unknown = sorted(set(body) - _SCHEMA_V1_FIELDS)
                if unknown:
                    raise ValueError(
                        f"unknown field(s) {unknown}; schema v1 accepts "
                        f"{sorted(_SCHEMA_V1_FIELDS)}")
                prompt = [int(t) for t in body["prompt"]]
                max_new = int(body["max_new"])
                sampling = _sampling_from(body)
                reuse_window = int(body.get("reuse_window", 0))
                priority = int(body.get("priority", 0))
                slo_ms = (float(body["slo_ms"])
                          if body.get("slo_ms") is not None else None)
            except (KeyError, TypeError, ValueError) as e:
                writer.write(_response("400 Bad Request", json.dumps(
                    {"error": f"bad request: {e}"}).encode()))
                await writer.drain()
                return
            await self._generate(writer, prompt, max_new, sampling,
                                 reuse_window, priority, slo_ms,
                                 stream=body.get("stream", True))
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass  # client went away; any in-flight uid is cancelled below
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _handle_get(self, writer, path: str, query: str) -> None:
        """Observability endpoints — reads of the engine's obs hub, made
        between steps (``AsyncServingEngine.read``), except /profilez which
        runs a bounded torch.profiler capture."""
        from repro_torch.obs import format_statusz
        engine = self.api.engine
        if path == "/healthz":
            writer.write(_response("200 OK", json.dumps(
                {"ok": True, "mode": self.mode, "steps": engine.t,
                 "uptime_s": round(time.monotonic() - self._t0, 3)}
            ).encode()))
        elif path == "/metrics":
            # unavailable series are simply absent from the registry —
            # never a 500, never a fabricated zero
            text = await self.api.read(engine.obs.render)
            writer.write(_response("200 OK", text.encode(),
                                   ctype="text/plain; version=0.0.4"))
        elif path == "/statusz":
            text = await self.api.read(lambda: format_statusz(engine))
            writer.write(_response("200 OK", text.encode(),
                                   ctype="text/plain; charset=utf-8"))
        else:  # /profilez
            await self._profilez(writer, query)
            return
        await writer.drain()

    async def _profilez(self, writer, query: str) -> None:
        """Opt-in torch.profiler capture: trace the next ``ms`` milliseconds
        of serving into --profilez-dir as a Chrome trace. The capture
        window overlaps live traffic — the point is profiling real steps,
        not a synthetic workload. The profiler is made, started and stopped
        on the engine's step thread (its CPU op records are per thread)."""
        if self.profilez_dir is None:
            writer.write(_response("403 Forbidden", json.dumps(
                {"error": "profiling disabled: start the server with "
                          "--profilez-dir"}).encode()))
            await writer.drain()
            return
        params = dict(kv.split("=", 1) for kv in query.split("&")
                      if "=" in kv)
        try:
            ms = max(1, min(60_000, int(params.get("ms", "500"))))
        except ValueError:
            writer.write(_response("400 Bad Request",
                                   b'{"error": "ms must be an integer"}'))
            await writer.drain()
            return
        if self._profiling:
            writer.write(_response(
                "409 Conflict", b'{"error": "a capture is already running"}'))
            await writer.drain()
            return
        self._profiling = True
        try:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.api.engine.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)

            def start():
                prof = profile(activities=activities)
                prof.start()
                return prof

            prof = await self.api.on_step_thread(start)
            try:
                await asyncio.sleep(ms / 1000.0)
            finally:
                await self.api.on_step_thread(prof.stop)
            os.makedirs(self.profilez_dir, exist_ok=True)
            path = os.path.join(self.profilez_dir,
                                f"profilez-{time.time_ns()}.json")
            prof.export_chrome_trace(path)
        except Exception as e:  # capture failure must not kill the server
            writer.write(_response("500 Internal Server Error", json.dumps(
                {"error": f"profiler capture failed: {e}"}).encode()))
            await writer.drain()
            return
        finally:
            self._profiling = False
        writer.write(_response("200 OK", json.dumps(
            {"ok": True, "ms": ms, "dir": self.profilez_dir,
             "trace": path}).encode()))
        await writer.drain()

    async def _generate(self, writer, prompt, max_new, sampling,
                        reuse_window, priority, slo_ms,
                        stream: bool) -> None:
        try:
            uid = await self.api.submit(prompt, max_new, sampling=sampling,
                                        reuse_window=reuse_window,
                                        priority=priority, slo_ms=slo_ms)
        except Exception as e:  # validation errors surface as 400s
            writer.write(_response("400 Bad Request", json.dumps(
                {"error": str(e)}).encode()))
            await writer.drain()
            return
        print(f"serve_api: uid={uid} prompt_len={len(prompt)} "
              f"max_new={max_new} greedy={sampling.is_greedy} "
              f"stream={stream}", file=sys.stderr, flush=True)
        tokens, lps = [], []
        if stream:
            writer.write(_response("200 OK", b"", ctype="text/event-stream",
                                   stream=True))
        try:
            async for ev in self.api.events(uid):
                if ev.finished:
                    final = {"uid": uid, "done": True,
                             "n_tokens": len(ev.result.tokens),
                             "finish_reason": ev.finish_reason,
                             "tokens": [int(t) for t in ev.result.tokens],
                             "logprobs": [float(x)
                                          for x in ev.result.logprobs],
                             "ttft_s": ev.ttft_s, "total_s": ev.total_s,
                             "priority": ev.result.priority,
                             "preemptions": ev.result.preemptions,
                             "slo_met": ev.result.slo_met}
                    if stream:
                        writer.write(b"data: " + json.dumps(final).encode()
                                     + b"\n\ndata: [DONE]\n\n")
                    else:
                        writer.write(_response("200 OK",
                                               json.dumps(final).encode()))
                    await writer.drain()
                    return
                tokens.append(ev.token)
                lps.append(ev.logprob)
                if stream:
                    writer.write(b"data: " + json.dumps(
                        {"uid": uid, "index": ev.index, "token": ev.token,
                         "logprob": ev.logprob}).encode() + b"\n\n")
                    # drain per event: a disconnected client raises here,
                    # freeing its slot instead of decoding to a dead socket
                    await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            print(f"serve_api: uid={uid} client disconnected after "
                  f"{len(tokens)} tokens — cancelling", file=sys.stderr,
                  flush=True)
            self.api.cancel(uid)
            raise


def _json_event_writer(path: str):
    """Line-delimited JSON sink for --log-json ('-' = stderr). Line-
    buffered so a crashed server leaves a readable log behind."""
    stream = sys.stderr if path == "-" else open(path, "a", buffering=1)

    def write(event: dict) -> None:
        stream.write(json.dumps(event) + "\n")
    return write


async def _amain(args: argparse.Namespace) -> None:
    from repro_torch.serving import AsyncServingEngine

    engine = build_engine(args)
    if args.log_json:
        engine.obs.log_event = _json_event_writer(args.log_json)
    async with AsyncServingEngine(engine) as api:
        server = ApiServer(api, mode=args.mode,
                           profilez_dir=args.profilez_dir)
        await server.start(args.host, args.port)
        print("READY " + json.dumps({"host": args.host, "port": server.port,
                                     "mode": args.mode,
                                     "device": str(engine.device)}),
              flush=True)
        try:
            await asyncio.Event().wait()  # serve until killed
        finally:
            await server.aclose()


def main(argv=None) -> None:
    args = parse_args(argv)
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
