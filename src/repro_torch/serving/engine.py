"""Serving engines of the PyTorch port, the reference's two tiers
(``serving/engine.py``): ``ContinuousBatchingEngine`` below, and the
legacy single-batch ``ServeEngine`` at the end of the module.

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
does; on CUDA its steps run the attention kernel.

Sharded serving (``EngineConfig(mesh=)``, a ``repro_torch.launch.mesh.Mesh``
of shape (D, M) over D x M torch.distributed ranks, one engine a rank):
the engine holds the rank's blocks of the target, draft and predictor
params by the serve-mode rules over its model-axis row
(``sharding/rules.py``: attention heads, d_ff, MoE experts and the
vocabulary split over "model"; the data axis replicates the weights), its
kv heads of the paged pools and its d_ff slice of the γ-masks, and runs
every model call under ``comm.serving(mesh, data)``, which puts the
collectives where the split products meet. Each rank runs the same path as
one device would — the kernels on the card, at the rank's shapes; the
reference turns its kernels off under a mesh instead (GSPMD cannot
partition them). On the data axis (``rules.DataSplit``) data row d holds
global pool blocks [d nb/D, (d+1) nb/D) as its local blocks and computes
the model step for slots [d n/D, (d+1) n/D), each where it divides D (else
every row holds the whole pool, or computes every slot); the one-request
whole-prompt prefill runs on every row. Attention on a split pool runs
kernel 2's partial mode and folds the rows' partials
(``common.paged_attend``). Every rank runs the one scheduler, and the
sampling head over its slots' logits (all-gathered over the model axis,
so every rank of a row picks the same tokens); the step's tokens and
per-slot statistics come together over the mesh (``_step_rows``: a
model-axis all-reduce, or one world sum where the slots are split, which
carries each model rank's own tokens to be compared bit for bit), and
once a step the ranks compare a checksum of the tokens; a mismatch
raises. So the metrics read as on one device, and
``weight_io_bytes_per_step()`` is per device (1/``ffn_tp`` of the total;
the data axis divides nothing).

Observability (``EngineConfig(obs=)``, an ``repro_torch.obs.EngineObs``;
None makes an enabled one): every step is traced in five phases, as in
the reference: ``admit`` (retirement and admission), ``prefill`` (the
prefill work with its fetch), ``dispatch`` (the host building the step's
arrays and queueing its kernels), ``host_sync`` (the host waiting for the
step's device-to-host fetches: in plain mode the stacked logprob and
telemetry rows, then the tokens; predictor mode adds the recall counts;
speculative mode fetches the telemetry, the tokens and the logprobs apart,
after its proposal fetch in ``dispatch``) and ``sample`` (the scheduler's
bookkeeping). The hooks read host values the step already fetched: no
device sync is added, and streams are identical with observability on or
off (``EngineObs.disabled()``). ``track_sparsity`` keeps one
``AggregatedTracker`` per request (paper Sec. 5.1) in ``trackers``, fed
from the step's FFN activity: one more fetch a step, made only when on.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparsity import AggregatedTracker
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.models import serving_protocol as sp
from repro_torch.obs import EngineObs
from repro_torch.predictor import predictors as preds
from repro_torch.serving.config import EngineConfig
from repro_torch.serving import sampling as smp
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request, RequestResult, Scheduler
from repro_torch.sharding import comm
from repro_torch.sharding import rules


@dataclasses.dataclass
class GenerationResult:
    """What ``ServeEngine.generate`` returns: tokens and their logprobs
    (b, n_new), the mean site sparsity of its stats steps by site, the
    batch's aggregated-sparsity tracker (``track_sparsity``) and the step
    count."""
    tokens: np.ndarray  # (b, n_new)
    logprobs: Optional[np.ndarray]
    site_sparsity: Dict[str, float]
    aggregated: Optional[AggregatedTracker]
    steps: int


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
    the EngineConfig (field semantics as in the reference engine), or
    instead its fields as keywords (``legacy_kw``: deprecated, warns once
    per process; both forms at once raise TypeError); device: "cuda"
    (default) or "cpu". With no CUDA available and no ``device="cpu"``,
    construction raises. With ``config.mesh`` the params (and draft
    params) are the whole tree, on any device: the engine copies the
    rank's blocks to ``device`` leaf by leaf and keeps no reference to
    the tree."""

    def __init__(self, cfg: ModelConfig, params,
                 config: Optional[EngineConfig] = None, device="cuda",
                 **legacy_kw):
        if config is None:
            config = (EngineConfig.from_legacy_kwargs(**legacy_kw)
                      if legacy_kw else EngineConfig())
        elif legacy_kw:
            raise TypeError(
                "pass either config=EngineConfig(...) or legacy keyword "
                f"arguments, not both (got {sorted(legacy_kw)})")
        config = config.validate()
        self.device = cm.resolve_device(device)
        if self.device.type == "cuda" and config.fast_kernels is False:
            raise ValueError("fast_kernels=False on CUDA: on the card the "
                             "engine runs the hand-written kernels")
        mesh = config.mesh
        if mesh is not None:
            missing = {"data", "model"} - set(mesh.axis_names)
            if missing:
                raise ValueError("serving mesh needs ('data', 'model') "
                                 f"axes; missing {sorted(missing)}")
            if torch.device(mesh.device) != self.device:
                raise ValueError(f"the mesh's device {mesh.device} is not "
                                 f"the engine's {self.device}")
        self.mesh = mesh
        self.tp = rules.tp_size(mesh)
        # effective TP of the FFN weights: where d_ff (or, for MoE, the
        # expert count) does not divide the model axis the rules replicate
        # the FFN and every rank reads it whole
        tp = max(1, self.tp)
        if cfg.n_experts:
            self.ffn_tp = tp if (cfg.n_experts % tp == 0
                                 or cfg.d_ff % tp == 0) else 1
        else:
            self.ffn_tp = tp if cfg.d_ff and cfg.d_ff % tp == 0 else 1
        caps = registry.serving_caps(cfg)
        caps.require("paged_decode", cfg.family)
        if not cfg.d_ff:
            raise ValueError("continuous batching requires an FFN (d_ff > 0)")
        if config.prefill_chunk:
            caps.require("chunked_prefill", cfg.family)
        if mesh is None:
            self._require_on_device(params, "params")
        else:
            params = cm.shard_params(cfg, params, mesh.model_row(),
                                     device=self.device)
        self.predictor = predictor = config.predictor
        self.predictor_telemetry = config.predictor_telemetry
        if predictor is not None:
            caps.require("predictor", cfg.family)
            if predictor.n_tiles * predictor.tile != cfg.d_ff:
                raise ValueError(
                    f"predictor geometry {predictor.n_tiles}x"
                    f"{predictor.tile} does not cover d_ff={cfg.d_ff}")
            if mesh is None:
                self._require_on_device(predictor.params, "predictor params")
            else:
                # the probe's d_ff slice beside the FFN weights it shadows;
                # never mutate the caller's Predictor (it may drive other
                # engines)
                self.predictor = predictor = dataclasses.replace(
                    predictor, params=rules.shard_predictor_params(
                        predictor.params, mesh, device=self.device))
                n_tiles = cfg.d_ff // predictor.tile
                if self.ffn_tp > 1 and n_tiles % self.tp:
                    warnings.warn(
                        f"predictor tile count {n_tiles} is not divisible "
                        f"by the {self.tp}-way model axis: packed tile lists "
                        "fall back to GLOBAL packing, gathered over the "
                        "ranks (correct, but the shard-local weight-I/O "
                        "property is lost)", stacklevel=2)
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
        self.obs = config.obs if config.obs is not None else EngineObs()
        n_blocks = config.resolved_n_blocks
        self.data = rules.data_split(mesh, config.n_slots, n_blocks)
        s0, ns = self.data.slots if self.data else (0, config.n_slots)
        self._own = slice(s0, s0 + ns)  # the slots this rank computes
        self._n_own = ns
        local_blocks = self.data.blocks[1] if self.data else n_blocks
        self.scheduler = Scheduler(
            config.n_slots, n_blocks, config.block_size,
            config.max_blocks_per_seq, prefix_cache=config.prefix_cache,
            obs=self.obs,
            preemption=config.preemption and config.prefill_chunk > 0,
            aging_steps=config.aging_steps)
        with comm.serving(mesh):
            self.pages = self.fam.init_paged_cache(
                cfg, local_blocks, config.block_size, device=self.device)
            self._lay = cm.shard_layout(cfg)
            self.masks = torch.zeros(
                (cfg.n_layers, ns, cm.local_d_ff(cfg)),
                dtype=torch.bool, device=self.device)
        self.base_seed = config.base_seed
        self.spec = config.draft_cfg is not None
        self.gamma = config.gamma
        if self.spec:
            dcfg = config.draft_cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            caps.require("spec_verify", cfg.family)
            registry.serving_caps(dcfg).require("spec_draft", dcfg.family)
            dparams = config.draft_params
            if mesh is None:
                self._require_on_device(dparams, "draft params")
            else:
                dparams = cm.shard_params(dcfg, dparams, mesh.model_row(),
                                          device=self.device)
            self.draft_cfg = dcfg
            self.draft_params = dparams
            self.dfam = registry.get_family(dcfg)
            # the draft shares the slots' block TABLES but has its own pool
            # (its layer count / head geometry differ from the target's)
            with comm.serving(mesh):
                self.draft_pages = self.dfam.init_paged_cache(
                    dcfg, local_blocks, config.block_size, device=self.device)
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
        self._step_sum = 0  # the step's sampled-token checksum (mesh)
        self._disagree = None  # model ranks' copies differ (device bool)
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
        """The step's sampling state of this rank's slots from the
        scheduler's ``sampling_arrays``; with ``slot``, that slot's row
        alone, keyed at generated index 0, where the reference keys the
        token a whole-prompt prefill seeds (a resumed slot's too)."""
        arrays = self.scheduler.sampling_arrays()
        if slot is not None:
            *row, gen = (a[slot:slot + 1] for a in arrays)
            arrays = (*row, np.zeros_like(gen))
        else:
            arrays = tuple(a[self._own] for a in arrays)
        return _Sampling(arrays, self._tensor)

    def _prefill_whole(self, i: int, slot) -> None:
        """One request's whole prompt: its batch of one does not divide the
        data axis, so every data row runs it (each keeping the blocks it
        holds) and samples the same token."""
        split = comm.data_split()
        if split is not None and split.slots_split:
            with comm.serving(self.mesh, split.whole_batch()):
                return self._prefill_whole(i, slot)
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
        tok = int(nxt[0])
        self._sampled([tok])
        self.scheduler.seed(slot, tok, float(lp[0]), step=self.t)

    def _prefill_one_chunk(self) -> None:
        sched = self.scheduler
        tokens, pos0, table, clen, first = sched.prefill_batch(
            self.prefill_chunk, self.prefill_budget)
        # prefilling slots run dense (refresh on) and harvest their union
        # activity into the mask row; continuing chunks OR into it
        refresh = clen > 0
        own = self._own
        keep = self._tensor((refresh & ~first)[own])
        jtok, jtable = self._tensor(tokens[own]), self._tensor(table[own])
        jpos, jclen = self._tensor(pos0[own]), self._tensor(clen[own])
        B, C = tokens.shape
        b = self._n_own
        last = np.maximum(clen - 1, 0)
        jlast = self._tensor(last[own], torch.int64)
        smpl = self._sampling()
        logits, self.pages, new_masks, aux = self.fam.model_prefill_chunk_paged(
            self.params, {"tokens": jtok}, self.cfg, self.pages, jtable, jpos,
            jclen, self.masks, self._tensor(refresh[own]), self.block_size,
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
                dcfg, torch.zeros((dcfg.n_layers, b, cm.local_d_ff(dcfg)),
                                  dtype=torch.bool, device=self.device),
                torch.ones((b,), dtype=torch.bool, device=self.device),
                self.block_size, fast_kernels=self.fast_kernels)
        # only a slot's last chunk position (clen - 1) can seed a token, so
        # the head runs on that row alone, keyed at the slot's CURRENT
        # generated index (0 for a fresh prompt; a resumed preempted slot
        # continues its schedule at len(out)). The reference samples every
        # position with that key and reads the same row.
        rows = logits[torch.arange(b, device=self.device), jlast]
        nxt, lp = smpl.head(rows, self.cfg.vocab_size)
        nxt, lp = self._step_rows([(nxt, "same"), (lp, "same")])
        nxt_bc = np.zeros((B, C), np.int32)
        lp_bc = np.zeros((B, C), np.float32)
        nxt_bc[np.arange(B), last] = nxt.cpu().numpy()
        lp_bc[np.arange(B), last] = lp.cpu().numpy()
        self._sampled(nxt_bc)
        sched.record_prefill(nxt_bc, lp_bc, clen, warm=self.warm_masks,
                             step=self.t)

    def _advance(self, active, st) -> None:
        """Decode one token for every active slot."""
        sched = self.scheduler
        with st.phase("dispatch"):
            tokens, pos, table, refresh = (a[self._own]
                                           for a in sched.batch_arrays())
            smpl = self._sampling()
            logits, self.pages, self.masks, (act, scores, density) = \
                self.fam.model_decode_paged(
                    self.params, self.pages, self._tensor(table),
                    self._tensor(tokens), self._tensor(pos), self.cfg,
                    self.masks, self._tensor(refresh), self.block_size,
                    fast_kernels=self.fast_kernels)
            nxt, lp = smpl.head(logits, self.cfg.vocab_size)
            ffn, act = self._ffn_stats(density.mean(0), scores, act)
            nxt, lp, *ffn = self._step_rows([(nxt, "same"), (lp, "same")]
                                            + ffn)
            stats = torch.stack([lp, *ffn])
        with st.phase("host_sync"):
            lp_np, dens_np, tiles_np = stats.cpu().numpy()
            nxt_np = nxt.cpu().numpy()
        with st.phase("sample"):
            self._sampled(nxt_np)
            self._account(active, dens_np, tiles_np, act)
            sched.record(nxt_np, lp_np)

    def _advance_pred(self, active, st) -> None:
        """Predictor-mode decode: per-token predicted tile lists drive the
        gathered up- and down-projections; density and recall telemetry
        come back with the step."""
        sched = self.scheduler
        pred = self.predictor
        with st.phase("dispatch"):
            tokens, pos, table, refresh = (a[self._own]
                                           for a in sched.batch_arrays())
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
            ffn, act = self._ffn_stats(density.mean(0), scores, act,
                                       n_act.sum(0), n_miss.sum(0))
            nxt, lp, dens, tiles, n_act, n_miss = self._step_rows(
                [(nxt, "same"), (lp, "same")] + ffn)
            stats = torch.stack([lp, dens, tiles])
            counts = torch.stack([n_act, n_miss]).to(torch.int64)
        with st.phase("host_sync"):
            lp_np, dens_np, tiles_np = stats.cpu().numpy()
            na, nm = counts.cpu().numpy()
            nxt_np = nxt.cpu().numpy()
        with st.phase("sample"):
            self._sampled(nxt_np)
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
            own = self._own
            smpl = self._sampling()
            jt, jp, jw = (self._tensor(table[own]), self._tensor(pos0[own]),
                          self._tensor(wlen[own]))

            def next_fn(logits, g):
                # proposal g is keyed at generated index gen0 + g
                return smpl.head(logits, vocab, offset=g)[0]

            props, self.draft_pages = self.dfam.model_draft_gamma_paged(
                self.draft_params, self.draft_pages, jt,
                self._tensor(tokens[own]), jp, jw, self.draft_cfg, self.gamma,
                self.block_size, next_fn=next_fn,
                fast_kernels=self.fast_kernels)
            # the (B, γ) proposal fetch is pipeline-necessary (the verify
            # window is built from it), so it stays in "dispatch"
            window = np.concatenate([tokens[own][:, None],
                                     props.cpu().numpy()], 1)
            refresh = torch.ones((self._n_own,), dtype=torch.bool,
                                 device=self.device)
            logits, self.pages, self.masks, (act, scores, _, udens) = \
                self.fam.model_verify_window_paged(
                    self.params, self.pages, jt, self._tensor(window), jp, jw,
                    self.cfg, self.masks, refresh, self.block_size,
                    fast_kernels=self.fast_kernels)
            target, lp = smpl.head(logits, vocab)
            ffn, act = self._ffn_stats(udens.mean(0), scores, act)
            props, target, lp, *ffn = self._step_rows(
                [(props, "same"), (target, "same"), (lp, "same")] + ffn)
            if self.data is not None and self.data.slots_split:
                window = np.concatenate([tokens[:, None],
                                         props.cpu().numpy()], 1)
            stats = torch.stack(ffn)
        with st.phase("host_sync"):
            dens_np, tiles_np = stats.cpu().numpy()
            target_np, lp_np = target.cpu().numpy(), lp.cpu().numpy()
        with st.phase("sample"):
            self._sampled(np.concatenate([window.reshape(-1),
                                          target_np.reshape(-1)]))
            self._account(active, dens_np, tiles_np, act)
            sched.record_spec(window, target_np, lp_np, wlen)

    def _ffn_stats(self, density, scores, act, *counts):
        """The step's FFN statistics of this rank's slots, for
        ``_step_rows``: ([(density (b,) mean over layers, how), (tile
        activity (b,), how), *(count (b,), how)], act (L, b, F)). ``how``
        is "same" where every rank of the model axis holds the value;
        where a mesh splits d_ff each rank measured its own units: the
        density means and, when the rank's slice is whole gather tiles,
        the tile-activity means are "avg" (averaged over the ranks: equal
        slices) and the counts "sum"; otherwise the tile activity is read
        off the gathered activity. ``act`` comes back whole over the model
        axis only when it was gathered: for the tile activity or, with
        ``track_sparsity``, for the trackers; with ``track_sparsity`` and
        the slots split over the data axis it comes back for every slot
        (gathered over the data axis)."""
        lay = self._lay
        if self.track and self.data is not None and self.data.slots_split:
            act = self._every_slot_act(act)
        if lay is None or not lay.ffn_split:
            return [(density, "same"), (_tile_activity(scores), "same"),
                    *((c, "same") for c in counts)], act
        F, (f0, _) = self.cfg.d_ff, lay.ffn
        tile = cm.ffn_gather_tile(self.cfg, F)
        whole_tiles = cm.ffn_gather_tile(self.cfg) == tile
        if self.track or not whole_tiles:
            act = comm.gather_last(act.to(torch.uint8), F, f0) > 0
        if whole_tiles:
            tiles = (_tile_activity(scores), "avg")
        else:
            own = act[:, self._own] if act.shape[1] > self._n_own else act
            L, B = own.shape[:2]
            tiles = (_tile_activity(preds.units_to_tiles(
                own.reshape(L * B, F), tile).reshape(L, B, -1).float()),
                "same")
        return [(density, "avg"), tiles,
                *((c.to(torch.float32), "sum") for c in counts)], act

    def _every_slot_act(self, act):
        """(L, b, F) activity of this rank's slots -> (L, n_slots, F) of
        every slot (a data-axis gather; the trackers' one extra
        collective)."""
        every = comm.data_gather([act])[0]  # (D, L, b, F)
        return every.permute(1, 0, 2, 3).reshape(
            act.shape[0], -1, act.shape[2])

    def _step_rows(self, rows):
        """The step's per-slot values for every slot, on the device: each
        of ``rows`` is (value (b, ...) of this rank's slots, how) with how
        as ``_ffn_stats`` gives it. Without a data split that cuts the
        slots, the "avg" and "sum" rows are reduced over the model axis in
        one all-reduce (f32) and the others pass as they are. Where the
        slots are split over the data axis, every value goes into one f32
        buffer of all the slots at this rank's slots (the "same" values in
        a copy for each model rank, each rank filling its own) and the
        buffer is summed over the whole mesh: one collective a step, exact
        for the "same" values (token ids below 2**24 included), the
        model-axis sum for the others; each comes back in its dtype, a
        "same" value as the model axis's first rank gave it. Where the
        model ranks' copies differ in any bit, ``step`` raises (every rank
        sees the same sum, so every rank raises)."""
        data = self.data
        out = [v for v, _ in rows]
        if data is None or not data.slots_split:
            part = [i for i, (_, how) in enumerate(rows) if how != "same"]
            if part:
                summed = comm.all_reduce_sum(torch.stack([out[i]
                                                          for i in part]))
                for j, i in enumerate(part):
                    out[i] = (summed[j] / self._lay.tp
                              if rows[i][1] == "avg" else summed[j])
            return out
        s0, ns = data.slots
        M, m = self.mesh.shape["model"], self.mesh.coords["model"]
        cols = [v.reshape(ns, -1).to(torch.float32) for v, _ in rows]
        same = [i for i, (_, how) in enumerate(rows) if how == "same"]
        other = [i for i in range(len(rows)) if i not in same]
        ws = sum(cols[i].shape[1] for i in same)
        wo = sum(cols[i].shape[1] for i in other)
        buf = torch.zeros((data.n_slots, M * ws + wo), dtype=torch.float32,
                          device=self.device)
        if same:
            buf[s0:s0 + ns, m * ws:(m + 1) * ws] = torch.cat(
                [cols[i] for i in same], 1)
        if other:
            buf[s0:s0 + ns, M * ws:] = torch.cat([cols[i] for i in other], 1)
        comm.world_sum(buf, self.mesh)
        copies = buf[:, :M * ws].reshape(data.n_slots, M, ws)
        if M > 1:  # every model rank's copy, bit for bit
            bits = copies.contiguous().view(torch.int32)
            bad = (bits != bits[:, :1]).any()
            self._disagree = bad if self._disagree is None \
                else self._disagree | bad
        at_same, at_other = 0, M * ws
        for i, (v, how) in enumerate(rows):
            w = cols[i].shape[1]
            if how == "same":
                col = copies[:, 0, at_same:at_same + w]
                at_same += w
            else:
                col = buf[:, at_other:at_other + w]
                at_other += w
            col = col.reshape((data.n_slots,) + v.shape[1:])
            out[i] = (col / self._lay.tp if how == "avg" else col).to(v.dtype)
        return out

    def _sampled(self, tokens) -> None:
        """Fold a step's sampled tokens into its checksum (compared over the
        ranks at the end of the step)."""
        if self.mesh is not None:
            self._step_sum += comm.token_checksum(tokens)

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
        self._step_sum = 0
        self._disagree = None
        with comm.serving(self.mesh, self.data):
            prefilled = self._admit(st)
            active = self.scheduler.active_indices()
            if active:
                if self.spec:
                    self._advance_spec(active, st)
                elif self.predictor is not None:
                    self._advance_pred(active, st)
                else:
                    self._advance(active, st)
            if self._disagree is not None and bool(self._disagree):
                raise RuntimeError("ranks disagree on the sampled tokens: "
                                   "the model ranks of a data row sampled "
                                   "different values for their slots")
            if self.mesh is not None and (active or prefilled):
                comm.check_same(self._step_sum, self.mesh)
        if not active and not prefilled:
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
                       else dens * self._mode_ffn_bytes() / self.ffn_tp))

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

    def weight_io_bytes_per_step(self, per_device: bool = True) -> float:
        """Mean FFN weight bytes actually read per (active slot, step) over
        the mode's skippable projections (``_mode_ffn_bytes``). With a mesh
        the default is the per-device figure, the total / ``ffn_tp``: each
        rank reads its d_ff slice (or its experts) of the tiles the
        sparsity machinery selects. ``ffn_tp`` is 1 where the rules
        replicated the FFN, which every rank then reads whole.
        per_device=False gives the total over the ranks (the one-device
        engine's figure at equal density)."""
        dens = 1.0 if not self._dens_n else self._dens_sum / self._dens_n
        total = dens * self._mode_ffn_bytes()
        return total / self.ffn_tp if per_device else total

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


# ---------------------------------------------------------------------------
# legacy single-batch path (compatibility: generate()/score() callers)

_SITES = ("down_in", "up_in", "qkv_in")


class ServeEngine:
    """The legacy single-batch engine: a contiguous head-major cache of
    ``max_len`` positions (the family's ``model_prefill`` /
    ``model_decode``), one Python loop over tokens, every row of the batch
    at the same position. It serves any registered family (the reference's
    route for families without paged serving) and the paper's
    measurement runs: γ-window reuse through ``decode(ffn_masks=)``
    (Fig. 7c) and per-site sparsity.

    params live on ``device`` ("cuda" by default; with no CUDA and no
    ``device="cpu"`` construction raises). Static tile capacities (a
    config from ``enable_sparse_serving``) gather through kernel 5 on the
    card. A decode step writes the cache in place.

    ``mesh`` (a (1, M) ``launch.mesh.Mesh`` on ``device``): the whole
    ``params`` are cut to this rank's blocks by the serve rules, and every
    model call runs under the mesh (``comm.serving``), the cache split
    over the model axis by sequence (``transformer.apply_attn_decode``);
    every rank returns the same result. ``max_len`` must divide over M;
    statistics steps (``track_sparsity``, ``reuse_window``) and a data
    axis above one are not supported there (ValueError)."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 track_sparsity: bool = False, device="cuda", mesh=None):
        self.device = cm.resolve_device(device)
        off = {str(t.device) for t in _leaves(params)
               if t.device != self.device}
        if off:
            raise ValueError(f"params must lie on {self.device}; found "
                             f"{sorted(off)}")
        if mesh is not None and (mesh.shape["data"] > 1 or track_sparsity
                                 or max_len % mesh.shape["model"]):
            raise ValueError(
                "the legacy engine on a mesh takes a data axis of one, no "
                "track_sparsity and a max_len that divides over the model "
                f"axis (mesh {mesh.shape}, max_len {max_len})")
        self.mesh = mesh if rules.tp_size(mesh) > 1 else None
        if self.mesh is not None:
            params = cm.shard_params(cfg, params, self.mesh, "serve",
                                     device=self.device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.fam = registry.get_family(cfg)
        self.track = track_sparsity

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    # -- basic API ----------------------------------------------------------
    def prefill(self, batch):
        """The whole prompt batch (dense) -> (last logits (b, vocab_p),
        the cache at max_len)."""
        with comm.serving(self.mesh):
            return self.fam.model_prefill(self.params, self._batch(batch),
                                          self.cfg, self.max_len)

    def decode(self, cache, token, pos, ffn_masks=None, stats=cm.NO_STATS):
        """One step: token (b,), pos (b,) (rows written at pos[0]);
        ffn_masks (L, d_ff) γ-window masks, stats a StatsCollector.
        Returns (logits (b, vocab_p), cache)."""
        kw = {} if ffn_masks is None else {"ffn_masks": ffn_masks}
        with comm.serving(self.mesh):
            return self.fam.model_decode(self.params, cache, token, pos,
                                         self.cfg, stats=stats, **kw)

    # -- generation with the paper's machinery ------------------------------
    @torch.inference_mode()
    def generate(self, batch, max_new: int,
                 reuse_window: int = 0) -> GenerationResult:
        """Greedy generation. reuse_window=γ enables the paper's Fig. 7c
        strategy: every γ-th step runs with statistics and its (L, d_ff)
        batch-union activity becomes the mask of the steps until the next
        refresh (only the window's loaded FFN rows participate). With
        ``track_sparsity`` every step collects statistics. Raises when
        prompt and generation overrun max_len (the reference clamps the
        write position instead).

        The loop queues each step's kernels without a host sync: tokens,
        logprobs, the stats steps' site values and masks stay on the
        device and come back in one fetch at the end."""
        cfg = self.cfg
        if self.mesh is not None and reuse_window > 0:
            raise ValueError("reuse_window on a mesh: the γ-window masks "
                             "are per rank's d_ff slice (not supported)")
        batch = self._batch(batch)
        b, s = batch["tokens"].shape
        offset = sp.prompt_token_offset(self.fam, cfg)
        if offset + s + max_new > self.max_len:
            raise ValueError(
                f"prompt offset {offset} + length {s} + max_new {max_new} "
                f"exceeds the cache's max_len {self.max_len}")
        last, cache = self.prefill(batch)
        vocab = cfg.vocab_size
        toks: List[torch.Tensor] = []
        lps: List[torch.Tensor] = []
        sites: List[tuple] = []  # (site name, device scalar)
        step_masks: List[torch.Tensor] = []  # (L, d_ff) per stats step
        masks = None

        def head(logits):
            lf = logits[:, :vocab].float()
            nxt = torch.argmax(lf, -1)
            lp = torch.log_softmax(lf, -1).gather(1, nxt[:, None])[:, 0]
            return nxt.to(torch.int32), lp

        nxt, lp = head(last)
        for step in range(max_new):
            toks.append(nxt)
            lps.append(lp)
            pos = torch.full((b,), offset + s + step, dtype=torch.int32,
                             device=self.device)
            need_stats = self.track or (
                reuse_window > 0 and step % max(1, reuse_window) == 0)
            if need_stats:
                stats = cm.StatsCollector(True)
                logits, cache = self.decode(cache, nxt, pos, stats=stats)
                act = _collect_down_act(stats, cfg)
                if act is not None and self.track and cfg.d_ff:
                    step_masks.append(act)
                sites += [(k.split("/")[-1], v) for k, v in stats.stats.items()
                          if k.endswith(_SITES)]
                if reuse_window > 0 and act is not None:
                    masks = act
            else:
                logits, cache = self.decode(cache, nxt, pos, ffn_masks=masks)
            nxt, lp = head(logits)

        tok_np = torch.stack(toks, 1).cpu().numpy()
        lp_np = torch.stack(lps, 1).cpu().numpy()
        site_acc: Dict[str, List[float]] = {}
        if sites:
            vals = torch.stack([v for _, v in sites]).cpu().numpy()
            for (name, _), v in zip(sites, vals):
                site_acc.setdefault(name, []).append(float(v))
        tracker = (AggregatedTracker(cfg.n_layers, cfg.d_ff)
                   if self.track and cfg.d_ff else None)
        if tracker is not None and step_masks:
            for m in torch.stack(step_masks).cpu().numpy():
                tracker.update(m)
        return GenerationResult(
            tokens=tok_np, logprobs=lp_np,
            site_sparsity={k: float(np.mean(v)) for k, v in site_acc.items()},
            aggregated=tracker, steps=max_new)

    @torch.inference_mode()
    def score(self, batch) -> float:
        """Mean NLL of batch['tokens'] (perplexity = exp(score))."""
        from repro_torch.train.step import lm_loss
        loss, _ = lm_loss(self.params, self._batch(batch), self.cfg)
        return float(loss)


def _collect_down_act(stats: cm.StatsCollector,
                      cfg: ModelConfig) -> Optional[torch.Tensor]:
    """The stats step's per-layer (d_ff,) unit activity stacked to
    (L, d_ff) bool on the device, or None when the family records none
    (MoE)."""
    masks = [stats.stats[key] for key in
             (f"layer{i}/down_act" for i in range(cfg.n_layers))
             if key in stats.stats]
    return torch.stack(masks) if masks else None
