"""Continuous-batching scheduler: request queue, refcounted block allocator,
prompt-prefix cache, and slot bookkeeping for the paged KV cache
(models/common.py). A copy of the reference's numpy scheduler, kept in the
port so it imports nothing of the JAX package. Its observability hooks
are optional (``obs=None``); the port's engine passes its ``EngineObs``
hub (repro_torch/obs).

Pure host-side logic, so admission/retirement policy is unit-
testable without a model. The engine (serving/engine.py) owns the device
state (page pool, γ-window masks) and calls into this scheduler every step:

  1. retire slots whose requests finished, dropping their block references;
  2. admit queued requests into free slots while blocks last, highest
     EFFECTIVE priority first (priority + waiting-time aging), skipping
     entries whose block demand cannot currently be met — bounded by the
     aging barrier — and preempting strictly-lower-priority slots when the
     candidate cannot fit otherwise;
  3. advance chunked prefill for admitted-but-not-yet-decoding slots;
  4. build the fixed-shape slot batch the jitted decode step consumes.

A request is admitted only if its *entire* lifetime block need fits now
(ceil((prompt + max_new) / block_size)), so decode never stalls mid-flight
on allocation failure.

Admission state machine (one request's lifecycle)
-------------------------------------------------

    submit()            queued      validated against max_blocks_per_seq AND
       |                            the pool itself (a request the pool could
       v                            never hold is rejected, not starved)
    admit()             prefilling  highest effective priority first
       |                            (priority, then FIFO; queued entries age
       |                            one class per ``aging_steps`` waited); a
       |                            free slot + the full lifetime block need,
       |                            with any cached full-block prompt prefix
       |                            mapped from the prefix trie (refcount++,
       |                            prefilled jumps to the cached length) and
       |                            only the cold suffix left to compute. An
       |                            entry that does not fit is SKIPPED (not a
       |                            hard stop) until it has aged, after which
       |                            it becomes a barrier nothing passes.
       v
    record_prefill()    prefilling  one fixed-shape chunk per engine step,
       | (xN chunks)                interleaved with the decode step, until
       |                            ``prefilled == prefill_len``; whole-
       |                            prompt mode (prefill_chunk=0) collapses
       |                            this to a single jump
       v
    seed()              decoding    first generated token recorded from the
       |                            final chunk's logits; the prompt's full
       |                            blocks are registered in the prefix trie
       v
    record()/record_spec()  ...     one token (or one accepted window) per
       |                            step; ``age`` drives the γ-refresh phase
       |
       |   preempt()    queued      under slot/pool pressure a strictly
       |                            higher-priority admission may EVICT the
       |                            slot TO RECOMPUTE: its written full
       |                            blocks are parked in the prefix trie,
       |                            every block reference is dropped, and
       |                            the request re-enters the queue carrying
       |                            its generated prefix. Re-admission maps
       |                            the parked blocks back from the trie and
       |                            chunk-prefills only the cold suffix of
       |                            prompt+generated — f32 greedy streams
       |                            are byte-identical across the cycle.
       v
    retire_finished()   retired     block refcounts dropped — blocks shared
                                    with the trie or other slots survive;
                                    RequestResult lands in ``results``
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

if TYPE_CHECKING:
    from repro_torch.serving.sampling import SamplingParams

# block 0 of the pool: idle slots and table padding point at it (the same
# constant as models/common.py, kept here so the scheduler needs no torch)
SCRATCH_BLOCK = 0


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray  # (s,) int32 prompt
    max_new: int
    # γ-window weight reuse (paper Fig. 7c): refresh the FFN mask every γ
    # decoded tokens; 0 = dense (refresh every step, mask never binds).
    reuse_window: int = 0
    # per-request sampling config (None = greedy) and the request's root
    # PRNG key ((2,) uint32, sampling.request_prng_key) — derived from
    # (seed, request fingerprint), never from uid/slot/admission order
    sampling: Optional["SamplingParams"] = None
    key: Optional[np.ndarray] = None
    # scheduling class: higher admits first and may preempt strictly lower.
    # 0 (default) keeps today's FIFO behavior for homogeneous traffic.
    priority: int = 0
    # TTFT service-level objective in milliseconds (None = no SLO):
    # informational — the scheduler never drops a request for missing it,
    # but RequestResult.slo_met reports the outcome per request
    slo_ms: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass
class RequestResult:
    uid: int
    tokens: np.ndarray  # (max_new,) int32
    logprobs: np.ndarray  # (max_new,) f32
    prompt_len: int
    admitted_step: int
    finished_step: int
    # speculative-decoding accounting (zero when served autoregressively)
    draft_proposed: int = 0  # draft tokens submitted for verification
    draft_accepted: int = 0  # of those, accepted by the target
    # verify windows this request cost; prefill is NOT included here (the
    # reporting layer, spec_decode.spec_metrics, adds it as +1)
    target_calls: int = 0
    # predictor-mode telemetry (zero-information defaults otherwise)
    predicted_density: float = 1.0  # mean fraction of FFN weight tiles read
    realized_recall: float = 1.0    # 1 - misses/actives, measured in-graph
    pred_misses: int = 0            # masked-out-but-active neurons (count)
    # prompt tokens served from the prefix cache (prefill skipped for them)
    cached_prompt_tokens: int = 0
    # mean fraction of the mode's skippable FFN weights this request's steps
    # actually read (1.0 = dense) — the per-request half of the engine's
    # weight_io_bytes_per_step() per-device accounting
    ffn_read_fraction: float = 1.0
    # why generation ended: "length" (max_new budget), "stop" (a stop
    # sequence matched) or "cancelled" (client abandoned the request)
    finish_reason: str = "length"
    # -- SLO-aware scheduling outcomes --
    priority: int = 0
    slo_ms: Optional[float] = None
    # times this request was preempted (evicted to recompute and requeued)
    preemptions: int = 0
    # TTFT SLO verdict: None when the request carried no slo_ms, else
    # whether wall-clock submit→first-token beat it
    slo_met: Optional[bool] = None
    # engine-step stamps for deterministic (wall-clock-free) latency
    # accounting: TTFT in steps = first_token_step - submit_step
    submit_step: int = -1
    first_token_step: int = -1

    @property
    def accept_rate(self) -> float:
        """Measured α: accepted / proposed drafts (NOT a tokens-per-call
        ratio — see spec_decode.spec_metrics)."""
        return self.draft_accepted / max(1, self.draft_proposed)


@dataclasses.dataclass
class _QueueEntry:
    """One queued admission candidate: a fresh request, or a preempted
    slot re-entering with its generated prefix (``resume`` carries the
    live _Slot so no progress is lost)."""
    req: Request
    seq: int            # submission order — the FIFO tiebreak
    submit_step: int    # engine step when (re)queued — drives aging
    t_submit: float     # wall clock when first submitted (SLO accounting)
    resume: Optional["_Slot"] = None


class RequestQueue:
    """Priority admission queue with aging.

    Order = (effective priority DESC, submission seq ASC) where effective
    priority is ``req.priority`` plus one class per ``aging_steps`` engine
    steps waited (aging_steps=0 disables aging → raw priority, then FIFO).
    With homogeneous priorities this degenerates to exactly the historical
    FIFO. Starvation is bounded two ways: a waiting low-priority request
    ages into higher classes, and once an entry has waited ``aging_steps``
    without fitting it becomes an admission BARRIER (Scheduler.admit stops
    skipping past it)."""

    def __init__(self):
        self._q: List[_QueueEntry] = []
        self._seq = 0

    @staticmethod
    def effective_priority(entry: _QueueEntry, step: int,
                           aging_steps: int) -> int:
        aged = (max(0, step - entry.submit_step) // aging_steps
                if aging_steps > 0 else 0)
        return entry.req.priority + aged

    def ordered(self, step: int = 0,
                aging_steps: int = 0) -> List[_QueueEntry]:
        """Entries in admission order for this step."""
        return sorted(self._q, key=lambda e: (
            -self.effective_priority(e, step, aging_steps), e.seq))

    def push(self, req: Request, step: int = 0,
             resume: Optional["_Slot"] = None,
             t_submit: Optional[float] = None) -> _QueueEntry:
        entry = _QueueEntry(req, self._seq, step,
                            time.monotonic() if t_submit is None
                            else t_submit, resume)
        self._seq += 1
        self._q.append(entry)
        return entry

    def peek(self) -> Optional[Request]:
        """Head of the admission order (raw priority, no aging)."""
        return self.ordered()[0].req if self._q else None

    def pop(self) -> Request:
        entry = self.ordered()[0]
        self._q.remove(entry)
        return entry.req

    def remove_entry(self, entry: _QueueEntry) -> None:
        self._q.remove(entry)

    def uids(self) -> List[int]:
        return [e.req.uid for e in self.ordered()]

    def remove(self, uid: int) -> Optional[_QueueEntry]:
        """Withdraw a queued entry (cancellation before (re)admission)."""
        for e in self._q:
            if e.req.uid == uid:
                self._q.remove(e)
                return e
        return None

    def __len__(self) -> int:
        return len(self._q)


class BlockAllocator:
    """Refcounted free-list over the shared page pool. Block 0
    (SCRATCH_BLOCK) is never handed out — idle slots and table padding point
    at it.

    ``alloc`` hands a block out with one reference; requests sharing a
    cached prompt prefix and the prefix trie each take an extra reference
    (``ref``). ``free`` DROPS one reference and returns the block to the
    free list only when the last one is gone, so a shared prefix block
    survives the request that prefilled it. Double-frees and negative
    refcounts trip assertions instead of corrupting the pool.
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, SCRATCH_BLOCK, -1))
        self._refs: Dict[int, int] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> int:
        """Distinct blocks currently held (any refcount > 0)."""
        return len(self._refs)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, blocks: List[int]) -> None:
        """Take an extra reference on already-allocated blocks."""
        for b in blocks:
            assert self._refs.get(b, 0) > 0, f"ref of unallocated block {b}"
            self._refs[b] += 1

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            assert b != SCRATCH_BLOCK
            n = self._refs.get(b, 0)
            assert n > 0, f"double free of block {b}"
            if n == 1:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = n - 1


class _TrieNode:
    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key, block: int, parent: Optional["_TrieNode"]):
        self.key = key
        self.block = block
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Prompt-prefix → KV-block trie, keyed on token-aligned FULL blocks.

    Each node caches one full block of prompt K/V, keyed by that block's
    ``block_size`` tokens at depth = block index, so a root path spells a
    prompt prefix. Full prompt blocks are immutable once prefilled (decode
    writes start at ``prompt_len``, inside the first partial block), which
    is what makes them shareable. Nodes hold their own allocator reference:
    cached blocks survive the requests that wrote them and are reclaimed
    LRU-leaf-first (``evict``) only under pool pressure — and only when no
    live request still shares them (refcount == 1).
    """

    def __init__(self):
        self._children: Dict[tuple, _TrieNode] = {}
        self._clock = 0
        self.lookups = 0
        self.hits = 0

    @staticmethod
    def _keys(tokens, n_full: int, block_size: int) -> List[tuple]:
        toks = np.asarray(tokens)
        return [tuple(int(t) for t in toks[i * block_size:(i + 1) * block_size])
                for i in range(n_full)]

    @staticmethod
    def _shareable_blocks(prompt_len: int, block_size: int) -> int:
        """Full blocks of a prompt that may be cached/matched. Capped one
        token short of the prompt so at least one token always prefills
        cold — the final chunk's logits seed the first generated token."""
        return (prompt_len - 1) // block_size

    def lookup(self, tokens, block_size: int) -> List[int]:
        """Longest cached full-block prefix of ``tokens`` (strictly shorter
        than the prompt). Returns block ids in sequence order; the caller
        takes its own reference on them before using or evicting."""
        self._clock += 1
        self.lookups += 1
        children = self._children
        blocks: List[int] = []
        for key in self._keys(tokens, self._shareable_blocks(len(tokens),
                                                             block_size),
                              block_size):
            node = children.get(key)
            if node is None:
                break
            node.last_used = self._clock
            blocks.append(node.block)
            children = node.children
        if blocks:
            self.hits += 1
        return blocks

    def insert(self, tokens, blocks: List[int], block_size: int,
               allocator: BlockAllocator) -> None:
        """Register a fully prefilled prompt's full blocks. Insert-if-absent:
        an existing node keeps its block (two identical prompts admitted
        concurrently both prefill cold; the loser's copy stays private and
        is freed at retirement). New nodes take a trie reference."""
        self._clock += 1
        children = self._children
        parent: Optional[_TrieNode] = None
        keys = self._keys(tokens, self._shareable_blocks(len(tokens),
                                                         block_size),
                          block_size)
        for i, key in enumerate(keys):
            node = children.get(key)
            if node is None:
                node = _TrieNode(key, blocks[i], parent)
                allocator.ref([node.block])
                children[key] = node
            node.last_used = self._clock
            parent = node
            children = node.children

    def evict(self, allocator: BlockAllocator, n_needed: int) -> int:
        """Return up to ``n_needed`` cached blocks to the pool, dropping
        LRU leaves no live request shares. Leaves-first keeps every
        surviving root path dense (a partial path would be unmatchable)."""
        freed = 0
        while freed < n_needed:
            leaf = self._lru_unshared_leaf(allocator)
            if leaf is None:
                break
            siblings = (leaf.parent.children if leaf.parent is not None
                        else self._children)
            del siblings[leaf.key]
            allocator.free([leaf.block])
            freed += 1
        return freed

    def _iter_nodes(self):
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _lru_unshared_leaf(self, allocator: BlockAllocator):
        best = None
        for node in self._iter_nodes():
            if node.children or allocator.refcount(node.block) != 1:
                continue  # interior, or a live request still shares it
            if best is None or node.last_used < best.last_used:
                best = node
        return best

    def blocks(self) -> List[int]:
        """Every block id the trie currently holds a reference on."""
        return [n.block for n in self._iter_nodes()]

    def __len__(self) -> int:
        return len(self.blocks())


@dataclasses.dataclass
class _Slot:
    request: Request
    blocks: List[int]
    admitted_step: int
    # generated tokens whose K/V is written (drives the γ phase and
    # next_pos). Maintained as len(out) - 1 while decoding — seed() pins
    # that equality so a preempted slot resumes at the exact γ phase and
    # write position it would have reached unpreempted.
    age: int = 0
    # prefill tokens whose K/V is already in the pool: starts at the cached
    # prefix length, advances chunk by chunk, reaches prefill_len at seed()
    prefilled: int = 0
    cached_tokens: int = 0  # of those, mapped from the prefix cache
    warm: bool = False  # γ-mask seeded from the prefill activity harvest
    out: List[int] = dataclasses.field(default_factory=list)
    lps: List[float] = dataclasses.field(default_factory=list)
    # speculative-decoding bookkeeping
    draft_proposed: int = 0
    draft_accepted: int = 0
    target_calls: int = 0
    # predictor-mode accumulators (per decoded token)
    pred_dens_sum: float = 0.0
    pred_steps: int = 0
    pred_active: int = 0
    pred_miss: int = 0
    # per-step FFN weight-read fraction (all modes; engine._account feeds it)
    io_dens_sum: float = 0.0
    io_steps: int = 0
    # early-finish marker ("stop" / "cancelled"); None = run to max_new
    finish: Optional[str] = None
    # -- SLO-aware scheduling state --
    preemptions: int = 0
    # set at preempt(): the prompt + everything generated so far, frozen as
    # the token sequence the NEXT admission must prefill (via the trie's
    # parked blocks + a chunked prefill of the cold tail). None = never
    # preempted: prefill covers just the prompt.
    resume_tokens: Optional[np.ndarray] = None
    submit_step: int = -1       # engine step of the original submit()
    t_submit: float = 0.0       # wall clock of the original submit()
    first_token_step: int = -1  # engine step of the first generated token
    t_first: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.finish is not None or len(self.out) >= self.request.max_new

    @property
    def prefill_tokens(self) -> np.ndarray:
        """Token sequence the current prefill pass must cover: the prompt,
        or prompt + generated prefix when resuming from a preemption."""
        return (self.resume_tokens if self.resume_tokens is not None
                else self.request.tokens)

    @property
    def prefill_len(self) -> int:
        return int(self.prefill_tokens.shape[0])

    @property
    def prefilling(self) -> bool:
        return self.prefilled < self.prefill_len

    @property
    def next_pos(self) -> int:
        """Write position of the current token (prompt occupies 0..s-1)."""
        return self.request.prompt_len + self.age

    @property
    def remaining(self) -> int:
        return self.request.max_new - len(self.out)


class Scheduler:
    """Admission/retirement policy over the slot batch — see the module
    docstring for the request state machine this drives."""

    def __init__(self, n_slots: int, n_blocks: int, block_size: int,
                 max_blocks_per_seq: int, prefix_cache: bool = False,
                 obs=None, preemption: bool = True, aging_steps: int = 32):
        self.n_slots = n_slots
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.allocator = BlockAllocator(n_blocks)
        self.queue = RequestQueue()
        self.slots: List[Optional[_Slot]] = [None] * n_slots
        self.results: Dict[int, RequestResult] = {}
        self.prefix: Optional[PrefixCache] = (PrefixCache() if prefix_cache
                                              else None)
        # SLO-aware scheduling knobs (see EngineConfig for semantics):
        # preemption lets admission evict strictly-lower-priority slots;
        # aging_steps bounds both starvation and admission skip-ahead
        self.preemption = preemption
        self.aging_steps = aging_steps
        self.preemption_count = 0
        # prompt-token accounting behind the engine's prefix_hit_rate()
        self.prefill_tokens_total = 0
        self.prefill_tokens_saved = 0
        # optional observability hub (the engine passes its EngineObs):
        # per-request span hooks fire at the state transitions below.
        self.obs = obs

    # -- lifecycle ----------------------------------------------------------
    def blocks_needed(self, req: Request) -> int:
        return -(-(req.prompt_len + req.max_new) // self.block_size)

    def submit(self, req: Request, step: int = 0) -> None:
        """Validate and enqueue. ``step`` is the engine step of submission:
        it stamps RequestResult.submit_step and starts the aging clock."""
        # reject malformed requests here, before any slot/block state exists:
        # a prefill failure mid-admission would leave a zombie slot behind
        if req.prompt_len == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.max_new < 1:
            raise ValueError(f"request {req.uid}: max_new must be >= 1")
        need = self.blocks_needed(req)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"request {req.uid}: needs {need} blocks > "
                f"max_blocks_per_seq={self.max_blocks_per_seq}")
        # also validate against the pool itself: a request bigger than every
        # allocatable block combined would sit at the head of the FIFO
        # forever (admit() breaks on it, run() sees no progress) — reject it
        # here instead of silently starving it and everything behind it
        if need > self.allocator.n_blocks - 1:
            raise ValueError(
                f"request {req.uid}: needs {need} blocks but the pool holds "
                f"only {self.allocator.n_blocks - 1} allocatable blocks — "
                f"it could never be admitted")
        self.queue.push(req, step)
        if self.obs is not None:  # span starts only for ACCEPTED requests
            self.obs.req_submitted(req.uid, req.prompt_len, req.max_new,
                                   priority=req.priority, slo_ms=req.slo_ms)

    def _result(self, slot: _Slot, step: int) -> RequestResult:
        """Terminal RequestResult from a slot's accumulated state."""
        req = slot.request
        slo_met = None
        if req.slo_ms is not None:
            slo_met = (slot.t_first is not None
                       and (slot.t_first - slot.t_submit) * 1e3 <= req.slo_ms)
        return RequestResult(
            uid=req.uid,
            tokens=np.asarray(slot.out, np.int32),
            logprobs=np.asarray(slot.lps, np.float32),
            prompt_len=req.prompt_len,
            admitted_step=slot.admitted_step,
            finished_step=step,
            draft_proposed=slot.draft_proposed,
            draft_accepted=slot.draft_accepted,
            target_calls=slot.target_calls,
            predicted_density=(slot.pred_dens_sum / slot.pred_steps
                               if slot.pred_steps else 1.0),
            realized_recall=(1.0 - slot.pred_miss / slot.pred_active
                             if slot.pred_active else 1.0),
            pred_misses=slot.pred_miss,
            cached_prompt_tokens=slot.cached_tokens,
            ffn_read_fraction=(slot.io_dens_sum / slot.io_steps
                               if slot.io_steps else 1.0),
            finish_reason=slot.finish or "length",
            priority=req.priority,
            slo_ms=req.slo_ms,
            preemptions=slot.preemptions,
            slo_met=slo_met,
            submit_step=slot.submit_step,
            first_token_step=slot.first_token_step,
        )

    def retire_finished(self, step: int) -> List[int]:
        """Free the blocks of finished slots; returns retired request uids."""
        retired = []
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.done:
                self.allocator.free(slot.blocks)
                self.results[slot.request.uid] = self._result(slot, step)
                if self.obs is not None:
                    self.obs.req_finished(self.results[slot.request.uid])
                retired.append(slot.request.uid)
                self.slots[i] = None
        return retired

    def preempt(self, i: int, step: int) -> None:
        """Evict slot ``i`` to recompute and requeue it with its progress.

        The slot's fully WRITTEN full blocks (prompt + generated prefix K/V)
        are parked in the prefix trie (when enabled) so re-admission maps
        them back with zero prefill; every block reference the slot holds is
        dropped (parked blocks survive on the trie's reference and stay
        reclaimable by LRU eviction if pressure demands); the request
        re-enters the queue carrying the SAME _Slot — output, sampling
        schedule position and γ phase intact. Resume is then an ordinary
        admission whose prefill covers ``prompt + generated`` (the cold
        tail only, under a trie hit), and the final chunk's logits re-derive
        the next token exactly where decode left off: f32 greedy streams
        are byte-identical across the cycle."""
        s = self.slots[i]
        assert s is not None and not s.done, "preempting idle/finished slot"
        resume = np.concatenate(
            [s.request.tokens, np.asarray(s.out, np.int32)]
        ) if s.out else s.request.tokens
        if self.prefix is not None:
            # only positions < written hold valid K/V (the latest generated
            # token's K/V is written when it is FED, not when it is emitted;
            # a mid-prefill slot has written exactly `prefilled`), so park
            # exactly the full blocks below that bound: trie keys are capped
            # one token short of the sequence passed
            written = s.prefilled if s.prefilling else s.next_pos
            self.prefix.insert(resume[:written + 1], s.blocks,
                               self.block_size, self.allocator)
        self.allocator.free(s.blocks)
        s.blocks = []
        s.resume_tokens = resume
        s.preemptions += 1
        s.prefilled = 0
        s.cached_tokens = 0
        s.warm = False
        self.slots[i] = None
        self.preemption_count += 1
        self.queue.push(s.request, step, resume=s, t_submit=s.t_submit)
        if self.obs is not None:
            self.obs.req_preempted(s.request.uid, len(s.out),
                                   priority=s.request.priority)

    def _try_alloc(self, tokens, need: int
                   ) -> Optional[Tuple[List[int], List[int]]]:
        """(cached, cold) blocks for a sequence needing ``need`` total, or
        None without side effects. Cached blocks come pinned (refcount++);
        under pressure, LRU trie blocks nobody shares are evicted first."""
        cached: List[int] = []
        if self.prefix is not None:
            cached = self.prefix.lookup(tokens, self.block_size)
            if cached:
                # pin before any eviction below can consider them
                self.allocator.ref(cached)
        cold = self.allocator.alloc(need - len(cached))
        if cold is None and self.prefix is not None:
            self.prefix.evict(self.allocator, need - len(cached)
                              - self.allocator.available)
            cold = self.allocator.alloc(need - len(cached))
        if cold is None:
            if cached:
                self.allocator.free(cached)  # drop our pins
            return None
        return cached, cold

    def _pick_victim(self, req: Request,
                     protect: frozenset = frozenset()) -> Optional[int]:
        """Slot to preempt so ``req`` can be admitted: strictly lower RAW
        priority only (aging never makes queued work evict running work),
        lowest class first, least progress first (cheapest recompute).
        ``protect`` holds slot indices admitted earlier in the SAME admit()
        call — that order was already committed by effective priority, so
        a later candidate may not churn it back out within the call (an
        aged entry's admission would otherwise be reversed immediately by
        any queued higher-raw-priority entry, re-starving it).
        Returns None when preemption is off, no slot qualifies, or evicting
        every qualifying slot still could not cover the block need (blocks
        shared with other live slots stay allocated — preempting for an
        admission that then fails would churn victims for nothing)."""
        if not self.preemption:
            return None
        victims = [i for i, s in enumerate(self.slots)
                   if s is not None and not s.done and i not in protect
                   and s.request.priority < req.priority]
        if not victims:
            return None
        reclaimable = self.allocator.available + sum(
            sum(1 for b in self.slots[i].blocks
                if self.allocator.refcount(b) == 1)
            for i in victims)
        if self.prefix is not None:
            # unshared trie blocks are reclaimable via _try_alloc's eviction
            reclaimable += sum(
                1 for b in self.prefix.blocks()
                if self.allocator.refcount(b) == 1)
        if reclaimable < self.blocks_needed(req):
            return None
        return min(victims, key=lambda i: (
            self.slots[i].request.priority,
            self.slots[i].prefilled + len(self.slots[i].out)))

    def _try_admit(self, entry: _QueueEntry, step: int,
                   protect: frozenset = frozenset()
                   ) -> Optional[Tuple[int, _Slot]]:
        """Place one queued entry: free slot + blocks, preempting strictly
        lower-priority slots (outside ``protect``) while that is what
        admission is missing. Returns the (slot_index, slot) needing
        prefill, or None."""
        req = entry.req
        need = self.blocks_needed(req)
        tokens = (entry.resume.prefill_tokens if entry.resume is not None
                  else req.tokens)
        while True:
            slot_i = next((i for i, s in enumerate(self.slots)
                           if s is None), None)
            if slot_i is not None:
                got = self._try_alloc(tokens, need)
                if got is not None:
                    cached, cold = got
                    break
            victim = self._pick_victim(req, protect)
            if victim is None:
                return None
            self.preempt(victim, step)
        self.queue.remove_entry(entry)
        n_cached = len(cached) * self.block_size
        if entry.resume is not None:
            slot = entry.resume
            slot.blocks = cached + cold
            slot.prefilled = n_cached
            slot.cached_tokens = n_cached
        else:
            slot = _Slot(request=req, blocks=cached + cold,
                         admitted_step=step, prefilled=n_cached,
                         cached_tokens=n_cached,
                         submit_step=entry.submit_step,
                         t_submit=entry.t_submit)
        self.prefill_tokens_total += slot.prefill_len
        self.prefill_tokens_saved += n_cached
        self.slots[slot_i] = slot
        if self.obs is not None:
            if entry.resume is not None:
                self.obs.req_resumed(req.uid, n_cached)
            else:
                self.obs.req_admitted(req.uid, n_cached)
        return slot_i, slot

    def admit(self, step: int) -> List[Tuple[int, _Slot]]:
        """Fill free slots from the queue while blocks last, highest
        effective priority first (aging promotes waiting entries one class
        per ``aging_steps``; ties admit FIFO). An entry whose block demand
        cannot currently be met is SKIPPED — later entries may admit around
        it — unless it has already waited ``aging_steps``, at which point
        it becomes a hard barrier (the historical head-of-line guarantee,
        now bounded instead of immediate). When the candidate outranks a
        running slot and nothing else fits, admission preempts (see
        ``preempt``) — but never a slot admitted earlier in this same
        call: the call's own effective-priority order is final.

        With a prefix cache, the entry's longest cached full-block prefix
        is mapped from the trie (refcount++ — no prefill, no new blocks)
        and only the cold suffix is allocated; under pool pressure, LRU
        cached prefixes nobody currently shares are evicted first.
        Returns (slot_index, slot) pairs needing (suffix) prefill."""
        admitted = []
        placed = True
        while placed:
            placed = False
            protect = frozenset(i for i, _ in admitted)
            for entry in self.queue.ordered(step, self.aging_steps):
                got = self._try_admit(entry, step, protect)
                if got is not None:
                    admitted.append(got)
                    placed = True
                    break  # queue/slots changed: recompute the order
                if (self.aging_steps > 0
                        and step - entry.submit_step >= self.aging_steps):
                    return admitted  # aged stuck entry: hard barrier
        return admitted

    def cancel(self, uid: int) -> bool:
        """Abandon a request. Queued: withdrawn immediately (an empty
        "cancelled" RequestResult is synthesized so waiters always observe
        a terminal result). Slotted and unfinished: marked finished — the
        next ``retire_finished`` frees its blocks and emits its partial
        output with ``finish_reason="cancelled"``. A PREEMPTED request
        (queued for resume) is withdrawn with the partial output it already
        generated. Returns False if the uid is unknown or already
        finished."""
        entry = self.queue.remove(uid)
        if entry is not None:
            if entry.resume is not None:  # preempted: blocks already freed
                entry.resume.finish = "cancelled"
                self.results[uid] = self._result(entry.resume, -1)
            else:
                self.results[uid] = RequestResult(
                    uid=uid, tokens=np.zeros((0,), np.int32),
                    logprobs=np.zeros((0,), np.float32),
                    prompt_len=entry.req.prompt_len, admitted_step=-1,
                    finished_step=-1, finish_reason="cancelled",
                    priority=entry.req.priority, slo_ms=entry.req.slo_ms,
                    slo_met=(None if entry.req.slo_ms is None else False),
                    submit_step=entry.submit_step)
            if self.obs is not None:  # terminal even without admission
                self.obs.req_finished(self.results[uid])
            return True
        for s in self.slots:
            if s is not None and s.request.uid == uid and not s.done:
                s.finish = "cancelled"
                return True
        return False

    @staticmethod
    def _hits_stop(out: List[int], stop) -> bool:
        return any(s and len(out) >= len(s) and tuple(out[-len(s):]) == s
                   for s in stop)

    def _check_stop(self, slot: _Slot) -> bool:
        """Mark the slot finished if its output now ends with one of the
        request's stop sequences (the stop tokens stay in the output)."""
        sp = slot.request.sampling
        if (slot.finish is None and sp is not None and sp.stop
                and self._hits_stop(slot.out, sp.stop)):
            slot.finish = "stop"
        return slot.finish is not None

    def seed(self, slot: _Slot, token: int, logprob: float,
             step: int = 0) -> None:
        """Record the next generated token (from the prefill logits),
        marking prefill complete and registering the prefilled sequence's
        full blocks in the prefix cache. For a fresh slot this is the FIRST
        token; for a preempted slot resuming, it is the token decode would
        have produced next — either way ``age = len(out) - 1`` afterwards,
        so next_pos and the γ-refresh phase continue exactly."""
        slot.prefilled = slot.prefill_len
        slot.out.append(int(token))
        slot.lps.append(float(logprob))
        slot.age = len(slot.out) - 1
        if slot.t_first is None:  # the span's first token (TTFT edge)
            slot.t_first = time.monotonic()
            slot.first_token_step = step
        if self.obs is not None:
            self.obs.req_tokens(slot.request.uid, 1)
        self._check_stop(slot)
        if self.prefix is not None:
            self.prefix.insert(slot.prefill_tokens, slot.blocks,
                               self.block_size, self.allocator)

    # -- batch assembly -----------------------------------------------------
    def active_indices(self) -> List[int]:
        """Slots currently DECODING (fully prefilled, not finished)."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.done and not s.prefilling]

    def prefill_indices(self) -> List[int]:
        """Slots admitted but still prefilling their (cold) prompt suffix."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.prefilling]

    def has_work(self) -> bool:
        return bool(self.active_indices()) or len(self.queue) > 0 or any(
            s is not None for s in self.slots)

    def batch_arrays(self):
        """Fixed-shape arrays for the jitted step. Idle slots point at the
        scratch block / position 0; their outputs are ignored."""
        B, nb = self.n_slots, self.max_blocks_per_seq
        tokens = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        table = np.full((B, nb), SCRATCH_BLOCK, np.int32)
        # idle slots keep their masks: a prefilling slot's row is its warm
        # harvest in progress and must survive interleaved decode steps
        refresh = np.zeros((B,), bool)
        for i in self.active_indices():
            s = self.slots[i]
            tokens[i] = s.out[-1]
            pos[i] = s.next_pos
            table[i, : len(s.blocks)] = s.blocks
            gamma = s.request.reuse_window
            refresh[i] = gamma <= 1 or (s.age % gamma == 0)
            if s.warm and s.age == 0 and gamma > 1:
                # γ-mask already seeded from the prefill activity harvest
                # (engine warm_masks mode): the first window rides it
                # instead of a dense refresh
                refresh[i] = False
        return tokens, pos, table, refresh

    def sampling_arrays(self):
        """Fixed-shape per-slot sampling state for the jitted sampling head:
        (temperature (B,) f32, top_k (B,) i32, top_p (B,) f32, request root
        keys (B, 2) u32, gen (B,) i32). ``gen`` is the slot's next
        generated-token index (len(out) — the key-schedule position), valid
        for both decode (the token sampled this step) and the base index of
        a speculative verify window. Idle/greedy slots read as temperature 0
        → the head's greedy branch; their keys are never consumed."""
        B = self.n_slots
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        top_ps = np.ones((B,), np.float32)
        keys = np.zeros((B, 2), np.uint32)
        gen = np.zeros((B,), np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            sp = s.request.sampling
            if sp is not None:
                temps[i] = sp.temperature
                top_ks[i] = sp.top_k
                top_ps[i] = sp.top_p
            if s.request.key is not None:
                keys[i] = s.request.key
            gen[i] = len(s.out)
        return temps, top_ks, top_ps, keys, gen

    def prefill_batch(self, chunk: int, budget: int = 0):
        """Fixed-shape arrays for one chunked-prefill step: the next
        ``chunk`` prefill tokens of every prefilling slot, written at its
        own resume position. Idle/decoding slots get clen 0 (their window
        tokens are scratch-routed in-graph). ``budget`` > 0 caps the TOTAL
        prefill tokens across slots this step (the TTFT-vs-TPOT knob): a
        slot past the cap keeps clen 0 and resumes next step; the first
        prefilling slot always gets at least one token, so prefill can
        never stall. Returns (tokens (B, C), pos0 (B,), table (B, nb),
        clen (B,), first (B,)) — ``first`` marks a slot's FIRST chunk of
        the current prefill pass, whose harvest must replace (not OR into)
        any stale mask left by the slot's previous occupant."""
        B, nb = self.n_slots, self.max_blocks_per_seq
        tokens = np.zeros((B, chunk), np.int32)
        pos0 = np.zeros((B,), np.int32)
        table = np.full((B, nb), SCRATCH_BLOCK, np.int32)
        clen = np.zeros((B,), np.int32)
        first = np.zeros((B,), bool)
        spent = 0
        for i in self.prefill_indices():
            s = self.slots[i]
            p = s.prefilled
            n = min(chunk, s.prefill_len - p)
            if budget > 0:
                n = min(n, max(0, budget - spent))
                if n <= 0:
                    continue  # over budget this step: resume next step
            spent += n
            tokens[i, :n] = s.prefill_tokens[p:p + n]
            pos0[i] = p
            clen[i] = n
            first[i] = p == s.cached_tokens
            table[i, : len(s.blocks)] = s.blocks
        return tokens, pos0, table, clen, first

    def record_prefill(self, nxt: np.ndarray, lp: np.ndarray,
                       clen: np.ndarray, *, warm: bool = False,
                       step: int = 0) -> None:
        """Advance every prefilling slot by its chunk; a slot whose prefill
        just completed is seeded from the logits at its last valid chunk
        position (nxt/lp are the (B, C) per-position greedy outputs).
        ``warm`` marks completed slots to skip their age-0 γ-refresh — the
        harvested prefill activity IS their first window mask."""
        for i in self.prefill_indices():
            s = self.slots[i]
            n = int(clen[i])
            if n <= 0:
                continue
            s.prefilled += n
            if s.prefilled >= s.prefill_len:
                s.warm = bool(warm)
                self.seed(s, int(nxt[i, n - 1]), float(lp[i, n - 1]),
                          step=step)

    def record_io(self, active, dens: np.ndarray) -> None:
        """Accumulate each active slot's per-step FFN weight-read fraction
        (the engine's measured density for this step) so RequestResult can
        report a per-request ``ffn_read_fraction`` — requests co-scheduled
        in one batch see different γ phases / predicted sets, so the
        engine-wide mean hides real per-request variance."""
        for i in active:
            s = self.slots[i]
            s.io_dens_sum += float(dens[i])
            s.io_steps += 1

    def record(self, next_tokens: np.ndarray, logprobs: np.ndarray,
               pred_density: Optional[np.ndarray] = None,
               pred_active: Optional[np.ndarray] = None,
               pred_miss: Optional[np.ndarray] = None) -> None:
        """Append the step's outputs to every active slot. The optional
        (B,) predictor-telemetry arrays (predictor serving mode) accumulate
        per-request: mean weight-tile density, and the in-graph
        active/missed neuron counts behind ``realized_recall``."""
        for i in self.active_indices():
            s = self.slots[i]
            s.age += 1
            s.out.append(int(next_tokens[i]))
            s.lps.append(float(logprobs[i]))
            if self.obs is not None:
                self.obs.req_tokens(s.request.uid, 1)
            self._check_stop(s)
            if pred_density is not None:
                s.pred_dens_sum += float(pred_density[i])
                s.pred_steps += 1
                s.pred_active += int(pred_active[i])
                s.pred_miss += int(pred_miss[i])

    # -- speculative decoding ------------------------------------------------
    def ensure_window_capacity(self, slot: _Slot, W: int) -> int:
        """Window-overflow guard: a slot whose next W-token verify window
        would run past its allocated blocks gets one more block from the
        pool — or, when none is free (or the static table is full), a
        SHRUNKEN window this step. Either way no speculative write can land
        out of range (out-of-window writes are additionally scratch-routed
        in-graph). Returns the slot's effective window length W_s >= 1.

        Because the window is capped at ``slot.remaining`` and the current
        admission policy reserves a request's full lifetime blocks
        (ceil((prompt+max_new)/bs)), neither branch binds today — they are
        the safety net that keeps speculative writes in range under lazier
        allocation policies (admit-on-prompt, block stealing), and are
        unit-tested against exactly such states. W_s >= 1 always holds:
        next_pos <= prompt+max_new-1 while the slot is active, so the
        current token's own position is always writable — the engine can
        never deadlock, it just degrades to plain decoding."""
        need = min(W, slot.remaining)
        while (slot.next_pos + need > len(slot.blocks) * self.block_size
               and len(slot.blocks) < self.max_blocks_per_seq):
            extra = self.allocator.alloc(1)
            if extra is None:
                break  # pool exhausted: shrink rather than defer the slot
            slot.blocks.extend(extra)
        return max(1, min(need,
                          len(slot.blocks) * self.block_size - slot.next_pos))

    def spec_batch(self, W: int):
        """Fixed-shape arrays for the speculative step. Idle slots get
        wlen 0 (their draft/verify writes land in the scratch block).
        Returns (tokens (B,), pos0 (B,), table (B, nb), wlen (B,))."""
        B, nb = self.n_slots, self.max_blocks_per_seq
        tokens = np.zeros((B,), np.int32)
        pos0 = np.zeros((B,), np.int32)
        table = np.full((B, nb), SCRATCH_BLOCK, np.int32)
        wlen = np.zeros((B,), np.int32)
        for i in self.active_indices():
            s = self.slots[i]
            tokens[i] = s.out[-1]
            pos0[i] = s.next_pos
            wlen[i] = self.ensure_window_capacity(s, W)
            table[i, : len(s.blocks)] = s.blocks
        return tokens, pos0, table, wlen

    def record_spec(self, window: np.ndarray, target: np.ndarray,
                    logprobs: np.ndarray, wlen: np.ndarray) -> None:
        """Acceptance + KV rewind bookkeeping for one verify step.

        window: (B, W) = [current token, draft proposals...]; target /
        logprobs: (B, W) the target model's own continuation (and its
        logprob) at every window position — the argmax for greedy requests,
        or the token the target SAMPLES with that position's scheduled key
        (sampling.window_keys) for sampled ones; wlen: (B,) valid window
        lengths.

        Per slot: accept the longest prefix of proposals that equals the
        target's own continuation, then the target's correction /
        continuation token. For greedy requests this is exactly Leviathan
        greedy acceptance; for sampled requests it is key-coupled
        acceptance — every emitted token is the target's scheduled sample,
        so either way the output stream is identical to pure autoregressive
        decoding (greedy or sampled under the same key schedule), for any
        draft. The KV rewind is this bookkeeping: advancing ``age`` by only
        the emitted length rolls ``next_pos`` back over the rejected tail,
        whose stale K/V is overwritten by the next window (and masked by
        position until then). Blocks are never allocated per-window-token,
        so rejection leaks nothing past the scratch-block-0 invariant.

        A stop-sequence match inside the window truncates it: tokens after
        the match are discarded (exactly what autoregressive decoding
        would never have produced) and the slot finishes with "stop"."""
        for i in self.active_indices():
            s = self.slots[i]
            n_prop = int(wlen[i]) - 1
            n_acc = 0
            while (n_acc < n_prop
                   and int(window[i, n_acc + 1]) == int(target[i, n_acc])):
                n_acc += 1
            # produced = accepted proposals (== target[:n_acc]) + correction
            n_emit = 0
            for j in range(n_acc + 1):
                s.out.append(int(target[i, j]))
                s.lps.append(float(logprobs[i, j]))
                n_emit += 1
                if self._check_stop(s) or len(s.out) >= s.request.max_new:
                    break
            s.age += n_emit
            s.draft_proposed += n_prop
            s.draft_accepted += min(n_acc, n_emit)
            s.target_calls += 1
            if self.obs is not None:
                self.obs.req_tokens(s.request.uid, n_emit)
