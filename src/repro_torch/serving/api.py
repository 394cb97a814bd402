"""Async streaming serving layer over the port's ``ContinuousBatchingEngine``
(a copy of the reference's ``serving/api.py``).

``AsyncServingEngine`` turns the engine's step-wise API (submit / step /
cancel) into an online server: an asyncio background task drives
``engine.step()`` in ONE worker thread of its own (the event loop keeps
ingesting requests and feeding client streams while a step runs), and
every request gets its own ``stream()`` async generator yielding
``TokenEvent``s the moment the step that produced them completes. Works
with all three serving modes — plain/γ-reuse, speculative (which can emit
several tokens per event batch), predictor — and with per-request
``SamplingParams`` (serving/sampling.py).

Concurrency contract: the engine and its scheduler are NOT thread-safe
and are touched only from the serve-loop task, between steps — client
submits and cancels are buffered and applied there, and readers of the
engine's state (``/metrics``, ``/statusz``) go through ``read``, which
waits for the step in flight. The only work shipped off the loop thread is
the blocking ``engine.step()`` call itself, always to the same thread, one
step at a time. Torch state that is per thread is carried over:
``engine.step`` runs under inference mode itself, and on CUDA the worker
steps on the stream that was current on the loop thread when the serve
loop started (the engine's kernels launch on the current stream).

The HTTP/SSE front door over this class lives in launch/serve_api.py;
in-process callers (tests, benchmarks) use it directly:

    async with AsyncServingEngine(engine) as api:
        async for ev in api.stream(prompt, max_new=32,
                                   sampling=SamplingParams(temperature=0.8,
                                                           seed=7)):
            ...

Greedy streams are byte-identical to the offline ``engine.run()`` results
for the same prompts — the API changes WHEN tokens surface, never which
tokens (tests/test_torch_api.py pins this in all three modes).
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator, Callable, Dict, Optional

import torch

from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import RequestResult


@dataclasses.dataclass
class TokenEvent:
    """One streamed token — or, with ``finished=True``, the request's
    terminal event carrying the full ``RequestResult`` plus serving
    latency (ttft_s: submit → first token; total_s: submit → finish)."""
    uid: int
    index: int  # generated-token index (0 = the prompt-seeded token)
    token: int = -1
    logprob: float = 0.0
    finished: bool = False
    finish_reason: Optional[str] = None
    result: Optional[RequestResult] = None
    ttft_s: Optional[float] = None
    total_s: Optional[float] = None


@dataclasses.dataclass
class _Session:
    queue: asyncio.Queue
    t_submit: float
    t_first: Optional[float] = None
    n_sent: int = 0  # tokens already published to the queue
    closed: bool = False  # terminal event published


class AsyncServingEngine:
    """Asyncio front for a ``ContinuousBatchingEngine`` — see the module
    docstring. ``start()``/``aclose()`` bracket the serve loop; the async
    context manager form is preferred."""

    def __init__(self, engine: ContinuousBatchingEngine):
        self.engine = engine
        # pending: (prompt, max_new, rw, sp, priority, slo_ms, future)
        self._pending: deque = deque()
        self._cancels: deque = deque()  # uids to cancel
        self._sessions: Dict[int, _Session] = {}
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._worker: Optional[ThreadPoolExecutor] = None
        # held by the serve loop around each step; ``read`` waits on it
        self._step_lock: Optional[asyncio.Lock] = None

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("serve loop already started")
        self._wake = asyncio.Event()
        self._step_lock = asyncio.Lock()
        self._worker = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="repro-step")
        self._running = True
        self._task = asyncio.get_running_loop().create_task(
            self._serve_loop(self._stepper()), name="repro-serve-loop")

    async def aclose(self) -> None:
        self._running = False
        if self._wake is not None:
            self._wake.set()
        try:
            if self._task is not None:
                await self._task
        finally:
            self._task = None
            if self._worker is not None:
                self._worker.shutdown(wait=True)
                self._worker = None

    async def __aenter__(self) -> "AsyncServingEngine":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    def _stepper(self) -> Callable[[], bool]:
        """``engine.step`` as the worker thread runs it: on CUDA under the
        stream current here, on the loop thread, at start (a thread's
        current stream is its own, and defaults to the device's default
        stream)."""
        dev = self.engine.device
        if dev.type != "cuda":
            return self.engine.step
        stream = torch.cuda.current_stream(dev)

        def step() -> bool:
            with torch.cuda.stream(stream):
                return self.engine.step()
        return step

    # -- client API ----------------------------------------------------------
    async def submit(self, prompt, max_new: int, *,
                     sampling: Optional[SamplingParams] = None,
                     reuse_window: int = 0, priority: int = 0,
                     slo_ms: Optional[float] = None) -> int:
        """Enqueue a request; resolves to its uid once the serve loop has
        accepted it (malformed requests raise here, exactly like
        ``engine.submit``). ``priority``/``slo_ms`` pass straight through
        to the SLO scheduler (engine.submit). Pair with ``events(uid)`` —
        or use ``stream``, which fuses both."""
        if self._task is None:
            raise RuntimeError("serve loop not started")
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((prompt, max_new, reuse_window, sampling,
                              priority, slo_ms, fut))
        self._wake.set()
        return await fut

    def cancel(self, uid: int) -> None:
        """Abandon a request (idempotent; safe for finished uids). Its
        stream terminates with finish_reason "cancelled"."""
        self._cancels.append(uid)
        if self._wake is not None:
            self._wake.set()

    async def read(self, fn: Callable):
        """``fn()`` on the loop thread while no step is in flight: for
        readers of the engine's state (format_statusz, the obs registry)
        that must not see a step half done."""
        if self._step_lock is None:
            return fn()
        async with self._step_lock:
            return fn()

    async def on_step_thread(self, fn: Callable):
        """``fn()`` on the engine's step thread, between steps (for state
        that is per thread, such as the profiler's CPU op records)."""
        return await asyncio.get_running_loop().run_in_executor(
            self._worker, fn)

    async def events(self, uid: int) -> AsyncIterator[TokenEvent]:
        """Yield ``uid``'s TokenEvents as the engine produces them; the
        ``finished`` event is always last. Closing the iterator mid-stream
        cancels the request (the mid-stream-disconnect path)."""
        sess = self._sessions[uid]
        try:
            while True:
                ev = await sess.queue.get()
                if isinstance(ev, BaseException):
                    raise ev
                yield ev
                if ev.finished:
                    return
        finally:
            if not sess.closed:
                self.cancel(uid)

    async def stream(self, prompt, max_new: int, *,
                     sampling: Optional[SamplingParams] = None,
                     reuse_window: int = 0, priority: int = 0,
                     slo_ms: Optional[float] = None
                     ) -> AsyncIterator[TokenEvent]:
        """submit + events in one async generator — one call per client
        session."""
        uid = await self.submit(prompt, max_new, sampling=sampling,
                                reuse_window=reuse_window,
                                priority=priority, slo_ms=slo_ms)
        async for ev in self.events(uid):
            yield ev

    async def generate(self, prompt, max_new: int, *,
                       sampling: Optional[SamplingParams] = None,
                       reuse_window: int = 0, priority: int = 0,
                       slo_ms: Optional[float] = None) -> TokenEvent:
        """Non-streaming convenience: the terminal event (with .result)."""
        ev = None
        async for ev in self.stream(prompt, max_new, sampling=sampling,
                                    reuse_window=reuse_window,
                                    priority=priority, slo_ms=slo_ms):
            pass
        return ev

    # -- serve loop ----------------------------------------------------------
    async def _serve_loop(self, step: Callable[[], bool]) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                self._apply_control()
                if not self._running and not self._sessions:
                    return
                if not self.engine.scheduler.has_work():
                    if not self._running:
                        return
                    # fully idle: sleep until a submit/cancel/close arrives
                    await self._wake.wait()
                    self._wake.clear()
                    continue
                async with self._step_lock:
                    progressed = await loop.run_in_executor(self._worker,
                                                            step)
                self._publish()
                if not progressed and self.engine.scheduler.has_work():
                    # queue head can never be admitted (engine.drain would
                    # raise here) — fail those streams instead of spinning
                    self._fail_queued()
        except BaseException as e:  # surface loop crashes to every client
            for sess in self._sessions.values():
                if not sess.closed:
                    sess.closed = True
                    sess.queue.put_nowait(e)
            raise

    def _apply_control(self) -> None:
        """Apply buffered submits/cancels on the loop thread, between
        engine steps (the engine is not thread-safe)."""
        while self._pending:
            (prompt, max_new, rw, sp, priority, slo_ms,
             fut) = self._pending.popleft()
            try:
                uid = self.engine.submit(prompt, max_new, reuse_window=rw,
                                         sampling=sp, priority=priority,
                                         slo_ms=slo_ms)
            except Exception as e:
                if not fut.cancelled():
                    fut.set_exception(e)
                continue
            self._sessions[uid] = _Session(queue=asyncio.Queue(),
                                           t_submit=time.monotonic())
            if not fut.cancelled():
                fut.set_result(uid)
        while self._cancels:
            self.engine.cancel(self._cancels.popleft())
        # a cancel of a queued request synthesizes its result immediately
        self._publish(slots=False)

    def _publish(self, slots: bool = True) -> None:
        """Flush newly produced tokens (and terminal results) to the
        per-request queues. Runs after every step: in-flight slots first
        (so clients see tokens the step they are made, not at retirement),
        then retirement + terminal events."""
        now = time.monotonic()
        if slots:
            for slot in self.engine.scheduler.slots:
                if slot is not None:
                    self._emit(slot.request.uid, slot.out, slot.lps, now)
        self.engine.scheduler.retire_finished(self.engine.t)
        for uid, res in list(self.engine.scheduler.results.items()):
            sess = self._sessions.get(uid)
            if sess is None or sess.closed:
                continue
            self._emit(uid, res.tokens, res.logprobs, now)
            sess.closed = True
            ttft_s = (sess.t_first - sess.t_submit
                      if sess.t_first is not None else None)
            total_s = now - sess.t_submit
            # API-boundary latency span (includes loop scheduling, unlike
            # the engine-side scheduler spans) — feeds repro_api_* series
            self.engine.obs.api_request_done(uid, ttft_s, total_s,
                                             len(res.tokens))
            sess.queue.put_nowait(TokenEvent(
                uid=uid, index=sess.n_sent, finished=True,
                finish_reason=res.finish_reason, result=res,
                ttft_s=ttft_s, total_s=total_s))

    def _emit(self, uid: int, tokens, lps, now: float) -> None:
        sess = self._sessions.get(uid)
        if sess is None or sess.closed:
            return
        while sess.n_sent < len(tokens):
            i = sess.n_sent
            if sess.t_first is None:
                sess.t_first = now
            sess.queue.put_nowait(TokenEvent(uid=uid, index=i,
                                             token=int(tokens[i]),
                                             logprob=float(lps[i])))
            sess.n_sent += 1

    def _fail_queued(self) -> None:
        alloc = self.engine.scheduler.allocator
        err = RuntimeError(
            f"serving deadlock: queued requests "
            f"{self.engine.scheduler.queue.uids()} can never be admitted "
            f"({alloc.available}/{alloc.n_blocks - 1} pool blocks free, "
            f"every slot idle)")
        for uid in list(self.engine.scheduler.queue.uids()):
            self.engine.cancel(uid)
            sess = self._sessions.get(uid)
            if sess is not None and not sess.closed:
                sess.closed = True
                sess.queue.put_nowait(err)
