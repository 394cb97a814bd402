"""serve-smoke client of the port: boot the API server, hammer it, verify
exactness (the reference's ``launch/serve_smoke_client.py``, on torch).

launch/serve_api.py is the system under test, spawned as a real
subprocess speaking real HTTP:

  1. start ``python -m repro_torch.launch.serve_api`` with the given mode
     and ``--device``, logging the server's stdout/stderr to ``--log``;
  2. drive 8 concurrent streaming clients — 5 greedy, 3 sampled (distinct
     seeds), one of which disconnects mid-stream;
  3. assert every completed greedy stream is byte-identical to an offline
     ``engine.run()`` over a reference engine built with the SAME args
     (the port's serve_api.build_engine — same random weights, same
     config, same device);
  4. assert the server survives the disconnect: /healthz still answers
     and a post-disconnect greedy request still matches the reference;
  5. scrape ``/metrics`` mid-run (availability under load) and again at
     the end, asserting the scraped request/token counters agree with the
     client-observed counts, ``/statusz`` renders, and ``/profilez`` is
     403 without its opt-in flag; the final scrape is written to
     ``--metrics-out`` (a ``.prom`` file).

Exit code 0 = pass (the last line says ``serve-smoke PASS [mode]``). Any
mismatch/timeout prints a diagnosis and exits 1; ``--log`` keeps the
server's output.

  python -m repro_torch.launch.serve_smoke_client --mode plain --device cpu
  python -m repro_torch.launch.serve_smoke_client --mode plain  # on CUDA
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

from pathlib import Path

import numpy as np

CLIENT_TIMEOUT_S = 420  # generous: the first steps on the card build kernels


def server_args(mode: str, device: str) -> List[str]:
    """CLI args shared by the server subprocess and the in-process
    reference engine — byte-identity depends on them matching."""
    return ["--arch", "tiny-relu", "--f32", "--mode", mode,
            "--n-slots", "4", "--block-size", "8", "--max-blocks", "6",
            "--gamma", "3", "--device", device]


def workload(vocab: int) -> List[dict]:
    """8 deterministic client requests: 5 greedy, 3 sampled; request 5
    (sampled) disconnects after 3 streamed tokens. Traffic is
    mixed-priority (schema v1): two interactive requests at priority 2
    with a generous SLO, one at priority 1, the rest default batch class —
    per-class TTFT series must land in /metrics."""
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(8):
        prompt = [int(t) for t in rng.randint(0, vocab, 4 + 2 * i)]
        r = {"prompt": prompt, "max_new": 6 + (i % 3), "stream": True}
        if i in (2, 5, 7):  # the sampled cohort
            r.update(temperature=0.8 + 0.1 * i, top_k=50, top_p=0.95,
                     seed=i)
        if i in (1, 4):  # the interactive cohort (one greedy, one greedy)
            r.update(priority=2, slo_ms=120_000.0)
        elif i == 3:
            r.update(priority=1)
        reqs.append(r)
    return reqs


async def stream_client(port: int, body: dict,
                        disconnect_after: Optional[int] = None,
                        times: Optional[List[float]] = None
                        ) -> Tuple[List[int], Optional[dict]]:
    """One SSE client; returns (streamed tokens, final event or None when
    it disconnected early). ``times``, when given, receives the
    ``time.perf_counter()`` of the request's send and of each streamed
    token's arrival (client-side TTFT and TPOT)."""
    raw = json.dumps(body).encode()
    if times is not None:
        times.append(time.perf_counter())
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\n"
                 b"Content-Length: " + str(len(raw)).encode()
                 + b"\r\n\r\n" + raw)
    await writer.drain()
    tokens: List[int] = []
    final = None
    buf = b""
    try:
        while True:
            chunk = await reader.read(4096)
            if not chunk:
                break
            buf += chunk
            done = False
            while b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                for line in frame.splitlines():
                    if not line.startswith(b"data: "):
                        continue
                    payload = line[6:]
                    if payload == b"[DONE]":
                        done = True
                        break
                    ev = json.loads(payload)
                    if ev.get("done"):
                        final = ev
                    else:
                        tokens.append(ev["token"])
                        if times is not None:
                            times.append(time.perf_counter())
                        if (disconnect_after is not None
                                and len(tokens) >= disconnect_after):
                            return tokens, None  # finally closes the socket
                if done:
                    break
            if done:
                break
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass
    return tokens, final


async def http_get(port: int, path: str) -> Tuple[int, str]:
    """One GET request; returns (status code, body text)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionResetError, BrokenPipeError):
        pass
    head, _, body = data.partition(b"\r\n\r\n")
    status = int(head.split()[1]) if head.split() else 0
    return status, body.decode("utf-8", "replace")


async def healthz(port: int) -> bool:
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /healthz HTTP/1.1\r\nHost: smoke\r\n\r\n")
        await writer.drain()
        data = await reader.read()
        writer.close()
        return b'"ok": true' in data
    except OSError:
        return False


def reference_streams(mode: str, device: str, reqs: List[dict]) -> dict:
    """Offline greedy ground truth from engine.run() on an identically
    built engine of the port (greedy requests only — sampled exactness is
    pinned by the pytest tier; here we check the greedy byte-identity
    contract)."""
    from repro_torch.launch.serve_api import build_engine, parse_args
    eng = build_engine(parse_args(server_args(mode, device)))
    uids = {}
    for i, r in enumerate(reqs):
        if "temperature" not in r:
            uids[i] = eng.submit(r["prompt"], r["max_new"])
    res = eng.run()
    return {i: [int(t) for t in res[u].tokens] for i, u in uids.items()}


async def drive(port: int, mode: str, device: str,
                metrics_out: Optional[str] = None) -> None:
    from repro_torch.configs import get_config
    from repro_torch.obs import parse_prometheus
    vocab = get_config("tiny-relu").vocab_size
    reqs = workload(vocab)
    ref = reference_streams(mode, device, reqs)
    failures: List[str] = []

    async def run_one(i: int):
        return await asyncio.wait_for(
            stream_client(port, reqs[i],
                          disconnect_after=3 if i == 5 else None),
            CLIENT_TIMEOUT_S)

    async def midrun_scrape():
        # scrape while the client streams are likely still in flight:
        # /metrics must answer under load, and the counters must already
        # be consistent
        await asyncio.sleep(1.0)
        status, text = await http_get(port, "/metrics")
        if status != 200:
            failures.append(f"mid-run /metrics returned {status}")
            return
        m = parse_prometheus(text)
        submitted = m.get(("repro_requests_submitted_total", ""), 0.0)
        finished = sum(v for (name, _), v in m.items()
                       if name == "repro_requests_finished_total")
        if not (1 <= submitted <= len(reqs) and 0 <= finished <= submitted):
            failures.append(f"mid-run counters inconsistent: "
                            f"submitted={submitted} finished={finished}")

    results = (await asyncio.gather(*[run_one(i) for i in range(len(reqs))],
                                    midrun_scrape()))[:len(reqs)]
    for i, (tokens, final) in enumerate(results):
        if i == 5:
            if final is not None:
                failures.append(f"client {i}: expected mid-stream "
                                f"disconnect, got a final event")
            continue
        if final is None:
            failures.append(f"client {i}: stream ended without a final "
                            f"event (got {len(tokens)} tokens)")
            continue
        if tokens != final["tokens"]:
            failures.append(f"client {i}: streamed tokens {tokens} != "
                            f"final event tokens {final['tokens']}")
        if len(tokens) != reqs[i]["max_new"]:
            failures.append(f"client {i}: {len(tokens)} tokens, wanted "
                            f"max_new={reqs[i]['max_new']}")
        if i in ref and tokens != ref[i]:
            failures.append(f"client {i}: greedy stream {tokens} != "
                            f"offline engine.run() {ref[i]}")
        if final.get("ttft_s") is None:
            failures.append(f"client {i}: final event missing ttft_s")
        if final.get("priority") != reqs[i].get("priority", 0):
            failures.append(f"client {i}: final event priority "
                            f"{final.get('priority')} != submitted "
                            f"{reqs[i].get('priority', 0)}")
        if "slo_ms" in reqs[i] and final.get("slo_met") is not True:
            failures.append(f"client {i}: slo_met={final.get('slo_met')} "
                            f"under a {reqs[i]['slo_ms']}ms SLO nothing "
                            f"in this smoke run can miss")
    # the server must have survived client 5 vanishing mid-stream
    if not await healthz(port):
        failures.append("healthz failed after mid-stream disconnect")
    post = reqs[0]
    tokens, final = await asyncio.wait_for(stream_client(port, post),
                                           CLIENT_TIMEOUT_S)
    if tokens != ref[0]:
        failures.append(f"post-disconnect greedy stream {tokens} != "
                        f"reference {ref[0]}")

    # -- final /metrics scrape: counters must agree with what the clients
    # themselves observed (9 requests total: the 8-request workload + the
    # post-disconnect probe). The disconnected client saw 3 tokens; the
    # engine may have decoded up to its max_new before the cancel landed,
    # so its engine-side token count is bounded, not pinned.
    status, text = await http_get(port, "/metrics")
    if status != 200:
        failures.append(f"final /metrics returned {status}")
        text = ""
    m = parse_prometheus(text)

    def counter(name: str, labels: str = "") -> float:
        return m.get((name, labels), 0.0)

    n_expected = len(reqs) + 1
    for name in ("repro_requests_submitted_total",
                 "repro_requests_admitted_total"):
        if counter(name) != n_expected:
            failures.append(f"{name}={counter(name)} != {n_expected} "
                            f"client-submitted requests")
    by_reason = {lab: v for (name, lab), v in m.items()
                 if name == "repro_requests_finished_total"}
    if sum(by_reason.values()) != n_expected:
        failures.append(f"finished-by-reason {by_reason} does not sum to "
                        f"{n_expected}")
    if by_reason.get('reason="cancelled"', 0.0) > 1:
        failures.append(f"more than one cancelled request: {by_reason}")
    completed = (sum(len(t) for i, (t, _) in enumerate(results) if i != 5)
                 + len(tokens))
    gen = counter("repro_generated_tokens_total")
    lo, hi = completed + 3, completed + reqs[5]["max_new"]
    if not lo <= gen <= hi:
        failures.append(f"generated_tokens_total={gen} outside "
                        f"[{lo}, {hi}] (clients observed {completed} "
                        f"completed tokens + 3..{reqs[5]['max_new']} on "
                        f"the disconnected stream)")
    if counter("repro_request_ttft_seconds_count") != n_expected:
        failures.append(f"ttft histogram count "
                        f"{counter('repro_request_ttft_seconds_count')} != "
                        f"{n_expected}")
    # per-class TTFT (SLO scheduling): one labeled series per priority
    # class the workload used, counts partitioning the 9 requests —
    # priority 2: clients 1+4; priority 1: client 3; priority 0: the
    # remaining 5 workload clients + the post-disconnect probe
    for prio, n_class in (("2", 2), ("1", 1), ("0", n_expected - 3)):
        got = counter("repro_request_class_ttft_seconds_count",
                      f'priority="{prio}"')
        if got != n_class:
            failures.append(f"class ttft count for priority={prio} is "
                            f"{got}, expected {n_class}")
    if mode == "predictor" and counter(
            "repro_predictor_active_neurons_total") <= 0:
        failures.append("predictor mode served but recall telemetry "
                        "counters are absent from /metrics")
    # /statusz renders; /profilez is 403 without its opt-in flag
    s_status, s_text = await http_get(port, "/statusz")
    if s_status != 200 or "repro serving engine" not in s_text:
        failures.append(f"/statusz broken (status {s_status})")
    p_status, _ = await http_get(port, "/profilez?ms=10")
    if p_status != 403:
        failures.append(f"/profilez without --profilez-dir returned "
                        f"{p_status}, expected 403")
    if metrics_out and text:
        with open(metrics_out, "w") as f:
            f.write(text)

    if failures:
        raise AssertionError("serve-smoke failures:\n  "
                             + "\n  ".join(failures))
    n_sampled = sum(1 for i in range(len(reqs)) if i in (2, 7))
    print(f"serve-smoke PASS [{mode}]: {len(ref)} greedy streams "
          f"byte-identical to engine.run(), {n_sampled} sampled streams "
          f"completed, 1 mid-stream disconnect survived")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["plain", "spec", "predictor"],
                    default="plain")
    ap.add_argument("--device", default="cuda",
                    help="the server's and the reference engine's device: "
                         "cuda (default; raises when CUDA is absent) or cpu")
    ap.add_argument("--log", default="serve_smoke_server.log")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final /metrics scrape here "
                         "(default serve_smoke_metrics_<mode>.prom)")
    ap.add_argument("--boot-timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if args.metrics_out is None:
        args.metrics_out = f"serve_smoke_metrics_{args.mode}.prom"
    from repro_torch.models.common import resolve_device
    resolve_device(args.device)  # no CUDA and no --device cpu: raise here

    import repro_torch
    # the server imports this package from where this client found it
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-u", "-m", "repro_torch.launch.serve_api",
           "--port", "0"] + server_args(args.mode, args.device)
    log = open(args.log, "w")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=log,
                            text=True, env=env)
    port = None
    try:
        deadline = time.monotonic() + args.boot_timeout
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"server exited during boot (rc={proc.poll()}) — "
                    f"see {args.log}")
            log.write(line)
            log.flush()
            if line.startswith("READY "):
                port = json.loads(line[6:])["port"]
                break
        if port is None:
            raise RuntimeError(f"server did not print READY within "
                               f"{args.boot_timeout}s — see {args.log}")
        # keep draining server stdout into the log while clients run
        t = threading.Thread(target=shutil.copyfileobj,
                             args=(proc.stdout, log), daemon=True)
        t.start()
        asyncio.run(drive(port, args.mode, args.device, args.metrics_out))
    except BaseException as e:
        print(f"serve-smoke FAIL [{args.mode}]: {e}", file=sys.stderr)
        raise SystemExit(1)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
        log.close()


if __name__ == "__main__":
    main()
