"""Continuous-batching serving engine of the PyTorch port.

``ContinuousBatchingEngine(cfg, params, config=EngineConfig(...),
device="cuda")`` is the reference's engine (``serving/engine.py``) in its
three serving modes: requests are admitted and retired mid-decode by the
copied numpy scheduler, K/V lives in a paged block pool shared by the slot
batch, and admission runs either as whole-prompt prefill
(``prefill_chunk == 0``) or as one fixed-shape chunk per step. The shared
prompt-prefix cache and SLO preemption come with the scheduler. Each step
advances every active slot:

* plain mode: one token, with per-request γ-window FFN masks;
* predictor mode (``EngineConfig(predictor=...)``, a
  ``repro_torch.predictor.Predictor`` on the engine's device): one token;
  the predictor names each token's active FFN tiles before any FFN weight
  is read, and the step gathers only those tiles for the up- and
  down-projections, with density and recall telemetry per step;
* speculative mode (``EngineConfig(draft_cfg=, draft_params=, gamma=)``,
  paper Sec. 5.2): a dense draft proposes γ tokens per slot
  (``draft_gamma_paged``), the target verifies each slot's γ+1-token
  window in one forward (``model_verify_window_paged``) whose FFN
  down-projection reads only the window's union-active rows (s_agg), and
  the scheduler keeps the longest accepted prefix plus the target's own
  token.

Every token comes from one sampling head (serving/sampling.py): greedy
rows take the argmax, sampled rows (temperature > 0) draw with the
request's key schedule, which the draft shares (key-coupled acceptance:
a sampled spec stream equals the autoregressive one for any draft).

The model family comes from ``cfg.family`` (models/registry.py): dense, or
MoE (plain and speculative modes with a dense draft, as in the reference;
routing to top_k of n_experts is itself activation sparsity,
``expert_io_fraction``).

PyTorch runs the step eagerly (no jit). ``fast_kernels`` follows the
device: on CUDA the steps run the hand-written kernels (kernels/*.py) and
``fast_kernels=False`` raises; on the CPU they run the reference's frozen
plain path, or with ``fast_kernels=True`` the kernel path's structure with
each wrapper's plain version. With an MoE config on the CPU,
``fast_kernels=True`` warns and serves the plain path, as the reference
does; on CUDA its steps run the attention kernel. Not ported yet, and raising
NotImplementedError: ``mesh=``.

Observability (``EngineConfig(obs=)``, an ``repro_torch.obs.EngineObs``;
None makes an enabled one): every step is traced in five phases, as in
the reference: ``admit`` (retirement and admission), ``prefill`` (the
prefill work with its fetch), ``dispatch`` (the host building the step's
arrays and queueing its kernels), ``host_sync`` (the host waiting for the
step's one stacked device-to-host fetch) and ``sample`` (the scheduler's
bookkeeping). The hooks read host values the step already fetched: no
device sync is added, and streams are identical with observability on or
off (``EngineObs.disabled()``). ``track_sparsity`` keeps one
``AggregatedTracker`` per request (paper Sec. 5.1) in ``trackers``, fed
from the step's FFN activity: one more fetch a step, made only when on.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparsity import AggregatedTracker
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.obs import EngineObs
from repro_torch.serving.config import EngineConfig
from repro_torch.serving import sampling as smp
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, RequestResult, Scheduler


def _tile_activity(scores: torch.Tensor) -> torch.Tensor:
    """(L, B, n_tiles) tile scores -> (B,) fraction of d_ff tiles with any
    live activation, on the device (fetched with the step's other stats)."""
    return (scores > 0).float().mean((0, 2))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class _Sampling:
    """One step's per-slot sampling state, from the scheduler's
    ``sampling_arrays``. Whether any row samples is known on the host: an
    all-greedy step moves nothing to the device and takes the greedy head.
    The engine builds it before queueing the step's kernels, so its
    host-to-device copies never wait on them."""

    def __init__(self, arrays, tensor):
        temps, tks, tps, keys, gen = arrays
        self.any_sampled = bool((temps > 0).any())
        if self.any_sampled:
            self.temps = tensor(temps, torch.float32)
            self.top_k = tensor(tks, torch.int64)
            self.top_p = tensor(tps, torch.float32)
            self.keys = tensor(keys.astype(np.int64), torch.int64)
            self.gen = tensor(gen, torch.int64)

    def head(self, logits, vocab: int, offset: int = 0):
        """Next token and logprob per row of logits (B, vocab_p), keyed at
        each slot's next generated index plus ``offset``; or per position
        of a verify window (B, W, vocab_p), position j keyed at that index
        plus j."""
        if not self.any_sampled:
            return smp.greedy_head(logits, vocab)
        gen = self.gen + offset
        if logits.dim() == 2:
            return smp.sample_head(logits, vocab, self.temps, self.top_k,
                                   self.top_p, smp.position_keys(self.keys,
                                                                 gen))
        B, W = logits.shape[:2]
        per_slot = (a[:, None].expand(B, W)
                    for a in (self.temps, self.top_k, self.top_p))
        return smp.sample_head(logits, vocab, *per_slot,
                               smp.window_keys(self.keys, gen, W))


class ContinuousBatchingEngine:
    """Continuous-batching serving over a paged KV cache.

    cfg: the model config; params: its parameter tree on ``device``
    (``transformer.init_params`` or ``convert.params_from_jax``); config:
    the EngineConfig (field semantics as in the reference engine);
    device: "cuda" (default) or "cpu". With no CUDA available and no
    ``device="cpu"``, construction raises."""

    def __init__(self, cfg: ModelConfig, params,
                 config: Optional[EngineConfig] = None, device="cuda"):
        config = (config or EngineConfig()).validate()
        self.device = cm.resolve_device(device)
        if self.device.type == "cuda" and config.fast_kernels is False:
            raise ValueError("fast_kernels=False on CUDA: on the card the "
                             "engine runs the hand-written kernels")
        if config.mesh is not None:
            raise NotImplementedError("mesh= (sharded serving) is not ported "
                                      "to PyTorch yet (ROADMAP.md)")
        caps = registry.serving_caps(cfg)
        caps.require("paged_decode", cfg.family)
        if not cfg.d_ff:
            raise ValueError("continuous batching requires an FFN (d_ff > 0)")
        if config.prefill_chunk:
            caps.require("chunked_prefill", cfg.family)
        self._require_on_device(params, "params")
        self.predictor = predictor = config.predictor
        self.predictor_telemetry = config.predictor_telemetry
        if predictor is not None:
            caps.require("predictor", cfg.family)
            if predictor.n_tiles * predictor.tile != cfg.d_ff:
                raise ValueError(
                    f"predictor geometry {predictor.n_tiles}x"
                    f"{predictor.tile} does not cover d_ff={cfg.d_ff}")
            self._require_on_device(predictor.params, "predictor params")
        self.config = config
        self.cfg = cfg
        self.params = params
        self.fam = registry.get_family(cfg)
        self.fast_kernels = (self.device.type == "cuda"
                             or bool(config.fast_kernels))
        if self.fast_kernels and cfg.n_experts and self.device.type == "cpu":
            warnings.warn(
                "fast_kernels is not wired for MoE serving on the CPU: the "
                "MoE step has no fused FFN kernel path, so it runs the plain "
                "path, as the reference engine does", stacklevel=2)
            self.fast_kernels = False
        self.block_size = config.block_size
        self.prefill_chunk = config.prefill_chunk
        self.warm_masks = config.warm_masks
        self.prefill_budget = config.prefill_budget
        self.track = config.track_sparsity
        # one device: no mesh, so no tensor parallelism (format_statusz)
        self.tp = 1
        self.obs = config.obs if config.obs is not None else EngineObs()
        n_blocks = config.resolved_n_blocks
        self.scheduler = Scheduler(
            config.n_slots, n_blocks, config.block_size,
            config.max_blocks_per_seq, prefix_cache=config.prefix_cache,
            obs=self.obs,
            preemption=config.preemption and config.prefill_chunk > 0,
            aging_steps=config.aging_steps)
        self.pages = self.fam.init_paged_cache(cfg, n_blocks, config.block_size,
                                               device=self.device)
        self.base_seed = config.base_seed
        self.spec = config.draft_cfg is not None
        self.gamma = config.gamma
        if self.spec:
            dcfg = config.draft_cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            caps.require("spec_verify", cfg.family)
            registry.serving_caps(dcfg).require("spec_draft", dcfg.family)
            self._require_on_device(config.draft_params, "draft params")
            self.draft_cfg = dcfg
            self.draft_params = config.draft_params
            self.dfam = registry.get_family(dcfg)
            # the draft shares the slots' block TABLES but has its own pool
            # (its layer count / head geometry differ from the target's)
            self.draft_pages = self.dfam.init_paged_cache(
                dcfg, n_blocks, config.block_size, device=self.device)
        self.masks = torch.zeros((cfg.n_layers, config.n_slots, cfg.d_ff),
                                 dtype=torch.bool, device=self.device)
        self.trackers: Dict[int, AggregatedTracker] = {}
        self.t = 0
        self._uid = 0
        # per-(active slot, step) FFN weight-read fraction: down-projection
        # rows under γ-window reuse, gathered tiles in predictor mode;
        # _tiles_sum: the fraction of d_ff tiles with any live activation
        self._dens_sum = 0.0
        self._tiles_sum = 0.0
        self._dens_n = 0
        # predictor-mode recall accounting (miss counts from the step)
        self._pred_active = 0
        self._pred_miss = 0
        # the step's means over active slots, stashed by _account() from
        # the arrays it already holds, for obs.step_end (no extra fetch)
        self._step_density: Optional[float] = None
        self._step_tiles: Optional[float] = None
        self.obs.set_engine_info(
            arch=cfg.name,
            mode=("spec" if self.spec
                  else "predictor" if predictor is not None else "plain"),
            n_slots=config.n_slots, block_size=config.block_size,
            prefill_chunk=config.prefill_chunk, tp=self.tp,
            fast_kernels=self.fast_kernels, family=cfg.family,
            n_experts=cfg.n_experts)

    def _require_on_device(self, tree, what: str) -> None:
        off = [t.device for t in _leaves(tree) if t.device != self.device]
        if off:
            raise ValueError(f"{what} must lie on {self.device}; found "
                             f"{sorted(set(map(str, off)))}")

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- request API --------------------------------------------------------
    def submit(self, prompt, max_new: int, reuse_window: int = 0,
               sampling: Optional[SamplingParams] = None, *,
               priority: int = 0, slo_ms: Optional[float] = None) -> int:
        """Enqueue a request; returns its uid. ``reuse_window`` is the γ of
        the request's FFN weight reuse (0 = dense; ignored in speculative
        mode, where each verify window is its own γ-window). ``sampling``
        (None = greedy) selects the decoding distribution and stop
        sequences; a sampled request's PRNG key comes from (seed, request
        fingerprint), never from its uid, slot or admission order."""
        self._uid += 1
        key = None
        if sampling is not None and not sampling.is_greedy:
            key = smp.request_prng_key(prompt, sampling, self.base_seed)
        req = Request(uid=self._uid,
                      tokens=np.asarray(prompt, np.int32).reshape(-1),
                      max_new=max_new, reuse_window=reuse_window,
                      sampling=sampling, key=key, priority=priority,
                      slo_ms=slo_ms)
        self.scheduler.submit(req, self.t)
        return self._uid

    def cancel(self, uid: int) -> bool:
        return self.scheduler.cancel(uid)

    # -- steps --------------------------------------------------------------
    def _admit(self, st) -> bool:
        """Retire finished requests, admit queued ones, and advance prefill:
        every newly admitted prompt at once (whole-prompt mode) or ONE chunk
        of every prefilling slot (chunked mode). True when prefill ran.
        ``st`` is the step's trace: retirement and admission under
        "admit", the prefill work with its fetches under "prefill"."""
        sched = self.scheduler
        with st.phase("admit"):
            sched.retire_finished(self.t)
            newly = sched.admit(self.t)
            if self.track:
                for _, slot in newly:
                    # a resumed (preempted) slot keeps its tracker: the
                    # union statistics span the whole logical request
                    if slot.request.uid not in self.trackers:
                        self.trackers[slot.request.uid] = AggregatedTracker(
                            self.cfg.n_layers, self.cfg.d_ff)
        if not self.prefill_chunk:
            if not newly:
                return False
            with st.phase("prefill"):
                for i, slot in newly:
                    self._prefill_whole(i, slot)
            return True
        if not sched.prefill_indices():
            return False
        with st.phase("prefill"):
            self._prefill_one_chunk()
        return True

    def _sampling(self, slot: Optional[int] = None) -> _Sampling:
        """The step's sampling state from the scheduler's
        ``sampling_arrays``; with ``slot``, that slot's row alone, keyed at
        generated index 0, where the reference keys the token a
        whole-prompt prefill seeds (a resumed slot's too)."""
        arrays = self.scheduler.sampling_arrays()
        if slot is not None:
            *row, gen = (a[slot:slot + 1] for a in arrays)
            arrays = (*row, np.zeros_like(gen))
        return _Sampling(arrays, self._tensor)

    def _prefill_whole(self, i: int, slot) -> None:
        s = slot.prefill_len
        nb_eff = -(-s // self.block_size)
        toks = np.zeros((1, nb_eff * self.block_size), np.int32)
        toks[0, :s] = slot.prefill_tokens
        batch = {"tokens": self._tensor(toks)}
        blocks = self._tensor(slot.blocks[:nb_eff], torch.int32)
        one = self._sampling(i)
        last, self.pages = self.fam.model_prefill_paged(
            self.params, batch, self.cfg, self.pages, blocks, self.block_size,
            true_len=s)
        if self.spec:
            _, self.draft_pages = self.dfam.model_prefill_paged(
                self.draft_params, batch, self.draft_cfg, self.draft_pages,
                blocks, self.block_size, true_len=s)
        nxt, lp = one.head(last, self.cfg.vocab_size)
        self.scheduler.seed(slot, int(nxt[0]), float(lp[0]), step=self.t)

    def _prefill_one_chunk(self) -> None:
        sched = self.scheduler
        tokens, pos0, table, clen, first = sched.prefill_batch(
            self.prefill_chunk, self.prefill_budget)
        # prefilling slots run dense (refresh on) and harvest their union
        # activity into the mask row; continuing chunks OR into it
        refresh = clen > 0
        keep = self._tensor(refresh & ~first)
        jtok, jtable = self._tensor(tokens), self._tensor(table)
        jpos, jclen = self._tensor(pos0), self._tensor(clen)
        B, C = tokens.shape
        last = np.maximum(clen - 1, 0)
        jlast = self._tensor(last, torch.int64)
        smpl = self._sampling()
        logits, self.pages, new_masks, aux = self.fam.model_prefill_chunk_paged(
            self.params, {"tokens": jtok}, self.cfg, self.pages, jtable, jpos,
            jclen, self.masks, self._tensor(refresh), self.block_size,
            fast_kernels=self.fast_kernels)
        self.masks = torch.where(keep[None, :, None], self.masks | aux[0],
                                 new_masks)
        if self.spec:
            # the draft needs the prompt K/V in ITS pool too. Its own
            # γ-masks never persist, but refresh MUST be on: refresh off
            # with zero masks zeroes the FFN (eff = mask | refresh), which
            # would corrupt the drafted prompt K/V — exact output either
            # way, but acceptance would collapse
            dcfg = self.draft_cfg
            _, self.draft_pages, _, _ = self.dfam.model_verify_window_paged(
                self.draft_params, self.draft_pages, jtable, jtok, jpos, jclen,
                dcfg, torch.zeros((dcfg.n_layers, B, dcfg.d_ff),
                                  dtype=torch.bool, device=self.device),
                torch.ones((B,), dtype=torch.bool, device=self.device),
                self.block_size, fast_kernels=self.fast_kernels)
        # only a slot's last chunk position (clen - 1) can seed a token, so
        # the head runs on that row alone, keyed at the slot's CURRENT
        # generated index (0 for a fresh prompt; a resumed preempted slot
        # continues its schedule at len(out)). The reference samples every
        # position with that key and reads the same row.
        rows = logits[torch.arange(B, device=self.device), jlast]
        nxt, lp = smpl.head(rows, self.cfg.vocab_size)
        nxt_bc = np.zeros((B, C), np.int32)
        lp_bc = np.zeros((B, C), np.float32)
        nxt_bc[np.arange(B), last] = nxt.cpu().numpy()
        lp_bc[np.arange(B), last] = lp.cpu().numpy()
        sched.record_prefill(nxt_bc, lp_bc, clen, warm=self.warm_masks,
                             step=self.t)

    def _advance(self, active, st) -> None:
        """Decode one token for every active slot."""
        sched = self.scheduler
        with st.phase("dispatch"):
            tokens, pos, table, refresh = sched.batch_arrays()
            smpl = self._sampling()
            logits, self.pages, self.masks, (act, scores, density) = \
                self.fam.model_decode_paged(
                    self.params, self.pages, self._tensor(table),
                    self._tensor(tokens), self._tensor(pos), self.cfg,
                    self.masks, self._tensor(refresh), self.block_size,
                    fast_kernels=self.fast_kernels)
            nxt, lp = smpl.head(logits, self.cfg.vocab_size)
            stats = torch.stack([lp, density.mean(0), _tile_activity(scores)])
        with st.phase("host_sync"):
            lp_np, dens_np, tiles_np = stats.cpu().numpy()
            nxt_np = nxt.cpu().numpy()
        with st.phase("sample"):
            self._account(active, dens_np, tiles_np, act)
            sched.record(nxt_np, lp_np)

    def _advance_pred(self, active, st) -> None:
        """Predictor-mode decode: per-token predicted tile lists drive the
        gathered up- and down-projections; density and recall telemetry
        come back with the step."""
        sched = self.scheduler
        pred = self.predictor
        with st.phase("dispatch"):
            tokens, pos, table, refresh = sched.batch_arrays()
            smpl = self._sampling()
            logits, self.pages, self.masks, (act, scores, density, n_act,
                                             n_miss) = \
                self.fam.model_decode_paged_predicted(
                    self.params, self.pages, self._tensor(table),
                    self._tensor(tokens), self._tensor(pos), self.cfg,
                    self.masks, self._tensor(refresh), pred.params,
                    pred.kind, pred.tile, pred.k_tiles, self.block_size,
                    self.predictor_telemetry, fast_kernels=self.fast_kernels)
            nxt, lp = smpl.head(logits, self.cfg.vocab_size)
            stats = torch.stack([lp, density.mean(0), _tile_activity(scores)])
            counts = torch.stack([n_act.sum(0), n_miss.sum(0)])
        with st.phase("host_sync"):
            lp_np, dens_np, tiles_np = stats.cpu().numpy()
            na, nm = counts.cpu().numpy()
            nxt_np = nxt.cpu().numpy()
        with st.phase("sample"):
            self._account(active, dens_np, tiles_np, act)
            step_act = int(sum(na[i] for i in active))
            step_miss = int(sum(nm[i] for i in active))
            self._pred_active += step_act
            self._pred_miss += step_miss
            if self.predictor_telemetry:
                self.obs.predictor_counts(step_act, step_miss)
            sched.record(nxt_np, lp_np, pred_density=dens_np,
                         pred_active=na, pred_miss=nm)

    def _advance_spec(self, active, st) -> None:
        """Speculative decode, batched across slots: γ draft tokens per
        slot from one draft loop, then every slot's γ+1-token window
        through one target forward. The only host traffic is the (B, γ)
        proposal fetch the window is built from and the (B, W) fetch of
        the target's tokens and logprobs. Draft and verify sample with the
        slots' shared key schedule (key-coupled acceptance)."""
        sched = self.scheduler
        vocab = self.cfg.vocab_size
        with st.phase("dispatch"):
            tokens, pos0, table, wlen = sched.spec_batch(self.gamma + 1)
            smpl = self._sampling()
            jt, jp, jw = (self._tensor(table), self._tensor(pos0),
                          self._tensor(wlen))

            def next_fn(logits, g):
                # proposal g is keyed at generated index gen0 + g
                return smpl.head(logits, vocab, offset=g)[0]

            props, self.draft_pages = self.dfam.model_draft_gamma_paged(
                self.draft_params, self.draft_pages, jt, self._tensor(tokens),
                jp, jw, self.draft_cfg, self.gamma, self.block_size,
                next_fn=next_fn, fast_kernels=self.fast_kernels)
            # the (B, γ) proposal fetch is pipeline-necessary (the verify
            # window is built from it), so it stays in "dispatch"
            window = np.concatenate([tokens[:, None], props.cpu().numpy()], 1)
            refresh = torch.ones((self.config.n_slots,), dtype=torch.bool,
                                 device=self.device)
            logits, self.pages, self.masks, (act, scores, _, udens) = \
                self.fam.model_verify_window_paged(
                    self.params, self.pages, jt, self._tensor(window), jp, jw,
                    self.cfg, self.masks, refresh, self.block_size,
                    fast_kernels=self.fast_kernels)
            target, lp = smpl.head(logits, vocab)
            stats = torch.stack([udens.mean(0), _tile_activity(scores)])
        with st.phase("host_sync"):
            dens_np, tiles_np = stats.cpu().numpy()
            target_np, lp_np = target.cpu().numpy(), lp.cpu().numpy()
        with st.phase("sample"):
            self._account(active, dens_np, tiles_np, act)
            sched.record_spec(window, target_np, lp_np, wlen)

    def _account(self, active, dens_np, tiles_np, act) -> None:
        """Per-(active slot, step) weight-read fraction, tile activity and,
        with ``track_sparsity``, the requests' trackers (the step's (L, B,
        F) activity fetched here, the one fetch tracking adds). Stashes the
        step's means for obs.step_end from the arrays it already holds."""
        self.scheduler.record_io(active, dens_np)
        for i in active:
            self._dens_sum += float(dens_np[i])
            self._tiles_sum += float(tiles_np[i])
            self._dens_n += 1
        if active:
            self._step_density = float(np.mean(dens_np[active]))
            self._step_tiles = float(np.mean(tiles_np[active]))
        if self.track:
            act_np = act.cpu().numpy()
            for i in active:
                uid = self.scheduler.slots[i].request.uid
                self.trackers[uid].update(act_np[:, i, :])

    @torch.inference_mode()
    def step(self) -> bool:
        """Retire, admit, advance prefill (one chunk in chunked mode), then
        advance every active slot: one decoded token each, or one drafted
        and verified window each in speculative mode. False when no work
        ran. Runs under inference mode, which is per thread: a worker
        thread stepping the engine (serving/api.py) is covered too."""
        st = self.obs.step_start()
        self._step_density = self._step_tiles = None
        prefilled = self._admit(st)
        active = self.scheduler.active_indices()
        if active:
            if self.spec:
                self._advance_spec(active, st)
            elif self.predictor is not None:
                self._advance_pred(active, st)
            else:
                self._advance(active, st)
        elif not prefilled:
            self._obs_step_end(st, False, active)
            return False
        self.t += 1
        self._obs_step_end(st, True, active)
        return True

    def _obs_step_end(self, st, worked: bool, active) -> None:
        """Close the step's trace with host-side state only (occupancy,
        pool, queue, and the density _account() already stashed)."""
        if not self.obs.enabled:
            return
        sched = self.scheduler
        dens = self._step_density
        self.obs.step_end(
            st, worked=worked, slots_active=len(active),
            n_slots=sched.n_slots, queue_depth=len(sched.queue),
            pool_used=sched.allocator.allocated,
            pool_total=sched.allocator.n_blocks - 1,
            density=dens, tiles=self._step_tiles,
            ffn_bytes=(None if dens is None
                       else dens * self._mode_ffn_bytes() / self.tp))

    def drain(self, max_steps: int = 1_000_000) -> Dict[int, RequestResult]:
        """Drive step() until every submitted request has finished; raises
        rather than drop work (a queue head that can never be admitted, or
        max_steps exhausted with work outstanding)."""
        for _ in range(max_steps):
            progressed = self.step()
            if not self.scheduler.has_work():
                break
            if not progressed:
                alloc = self.scheduler.allocator
                raise RuntimeError(
                    f"serving deadlock: queued requests "
                    f"{self.scheduler.queue.uids()} can never be admitted "
                    f"({alloc.available}/{alloc.n_blocks - 1} pool blocks "
                    f"free, every slot idle)")
        else:
            if self.scheduler.has_work():
                raise RuntimeError(
                    f"drain(max_steps={max_steps}) exhausted with "
                    f"{len(self.scheduler.queue)} request(s) still queued "
                    f"or in flight")
        self.scheduler.retire_finished(self.t)
        return dict(self.scheduler.results)

    def run(self, max_steps: int = 1_000_000) -> Dict[int, RequestResult]:
        """Offline convenience: run every submitted request to completion."""
        return self.drain(max_steps)

    # -- metrics ------------------------------------------------------------
    def weight_io_saved(self) -> float:
        """Fraction of FFN weight reads skipped, averaged over (active slot,
        step); 0.0 before any decode step. Plain mode: down-projection rows
        skipped by γ-window reuse. Speculative mode: down-projection rows
        outside each verify window's union activity, the measured s_agg(γ)
        of paper Sec. 5.2. Predictor mode: up- AND down-projection tiles
        the predictor never gathered (1 - mean predicted density)."""
        if not self._dens_n:
            return 0.0
        return 1.0 - self._dens_sum / self._dens_n

    def _mode_ffn_bytes(self) -> int:
        """Per-step FFN weight bytes per token, dense, in the serving mode's
        skippable scope: every projection for predictor serving and on the
        dense family's kernel path (the fused kernel gathers the γ-mask's
        tiles for the up- and down-projections), the down-projection
        otherwise — speculative mode included, since a verify window's up
        projection stays dense (its union is known only after it runs).
        MoE counts all experts: routing is part of the measured
        density (expert fraction x within-expert density), so density x
        this figure is the activated-expert bytes, as in the reference. Its
        step has no fused FFN kernel, so its scope is the down-projection
        on the card too."""
        cfg = self.cfg
        itemsize = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                               ).element_size()
        proj = cfg.d_ff * cfg.d_model * itemsize * max(1, cfg.n_experts)
        n_all = 3 if cfg.ffn_kind == "glu" else 2
        if self.predictor is not None or (self.fast_kernels and not self.spec
                                          and not cfg.n_experts):
            return cfg.n_layers * n_all * proj
        return cfg.n_layers * proj

    def weight_io_bytes_per_step(self) -> float:
        """Mean FFN weight bytes actually read per (active slot, step) over
        the mode's skippable projections (``_mode_ffn_bytes``)."""
        dens = 1.0 if not self._dens_n else self._dens_sum / self._dens_n
        return dens * self._mode_ffn_bytes()

    def predictor_density(self) -> Optional[float]:
        """Mean fraction of FFN weight tiles gathered per (active slot,
        step, layer) in predictor mode. None outside predictor mode or
        before any decode step."""
        if self.predictor is None or not self._dens_n:
            return None
        return self._dens_sum / self._dens_n

    def predictor_recall(self) -> Optional[float]:
        """Realized recall over every served token: 1 - (active units the
        gathered tiles missed) / (active units). None when recall was never
        measured: outside predictor mode, with ``predictor_telemetry=False``
        (the step then reports zero counts) or before any decode step."""
        if (self.predictor is None or not self.predictor_telemetry
                or not self._dens_n):
            return None
        if not self._pred_active:
            return 1.0  # measured: no unit fired, so none was missed
        return 1.0 - self._pred_miss / self._pred_active

    def s_agg_window(self) -> Optional[float]:
        """Measured mean aggregated sparsity per verify window (speculative
        mode): 1 - mean fraction of FFN units active anywhere in a window.
        None outside speculative mode or before any verify window ran."""
        if not self.spec or not self._dens_n:
            return None
        return self.weight_io_saved()

    def expert_io_fraction(self) -> Optional[float]:
        """Fraction of the expert FFN weights a token's routing activates,
        top_k / n_experts; None for a family without experts. Exact under
        drop-free capacity (a dropped assignment only reads less)."""
        if not self.cfg.n_experts:
            return None
        return self.cfg.top_k / self.cfg.n_experts

    def tile_activity_rate(self) -> Optional[float]:
        """Mean fraction of d_ff tiles with any live activation, per (active
        slot, step): what a tile-gathered down-projection would load. None
        before any measured step."""
        if not self._dens_n:
            return None
        return self._tiles_sum / self._dens_n

    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix cache."""
        s = self.scheduler
        if not s.prefill_tokens_total:
            return 0.0
        return s.prefill_tokens_saved / s.prefill_tokens_total

    def prefill_tokens_saved(self) -> int:
        """Total prompt tokens whose prefill was skipped via cached prefix
        blocks, across every admitted request."""
        return self.scheduler.prefill_tokens_saved

    def metrics_snapshot(self) -> Dict[str, float]:
        """Every scalar engine metric that is currently available: the
        None-valued ones (wrong mode, telemetry off, nothing measured yet)
        are omitted, never faked. /statusz and launch/serve.py's report
        read this."""
        out = {
            "steps": float(self.t),
            "weight_io_saved": self.weight_io_saved(),
            "weight_io_bytes_per_step": self.weight_io_bytes_per_step(),
            "tile_activity_rate": self.tile_activity_rate(),
            "prefix_hit_rate": self.prefix_hit_rate(),
            "prefill_tokens_saved": float(self.prefill_tokens_saved()),
            "predictor_density": self.predictor_density(),
            "predictor_recall": self.predictor_recall(),
            "s_agg_window": self.s_agg_window(),
            "expert_io_fraction": self.expert_io_fraction(),
        }
        return {k: v for k, v in out.items() if v is not None}
