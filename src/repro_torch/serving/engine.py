"""Continuous-batching serving engine of the PyTorch port.

``ContinuousBatchingEngine(cfg, params, config=EngineConfig(...),
device="cuda")`` is the reference's engine (``serving/engine.py``) for
greedy requests in two of its serving modes: requests are admitted and
retired mid-decode by the copied numpy scheduler, K/V lives in a paged
block pool shared by the slot batch, and admission runs either as
whole-prompt prefill (``prefill_chunk == 0``) or as one fixed-shape chunk
per step. The shared prompt-prefix cache and SLO preemption come with the
scheduler. Every step decodes one token per active slot:

* plain mode, with per-request γ-window FFN masks;
* predictor mode (``EngineConfig(predictor=...)``, a
  ``repro_torch.predictor.Predictor`` on the engine's device): the
  predictor names each token's active FFN tiles before any FFN weight is
  read, and the step gathers only those tiles for the up- and
  down-projections, with density and recall telemetry per step.

The model family comes from ``cfg.family`` (models/registry.py): dense, or
MoE (plain mode only, as in the reference; routing to top_k of n_experts
is itself activation sparsity, ``expert_io_fraction``).

PyTorch runs the step eagerly (no jit). ``fast_kernels`` follows the
device: on CUDA the steps run the hand-written kernels (kernels/*.py) and
``fast_kernels=False`` raises; on the CPU they run the reference's frozen
plain path, or with ``fast_kernels=True`` the kernel path's structure with
each wrapper's plain version. With an MoE config on the CPU,
``fast_kernels=True`` warns and serves the plain path, as the reference
does; on CUDA its steps run the attention kernel. Not ported yet, and raising
NotImplementedError: speculative mode, ``mesh=``, ``obs=``,
``track_sparsity`` and sampled (temperature > 0) requests.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.sampling import SamplingParams, greedy_head, require_greedy
from repro_torch.serving.scheduler import Request, RequestResult, Scheduler


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class ContinuousBatchingEngine:
    """Continuous-batching greedy serving over a paged KV cache.

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
        for on, what in ((config.draft_cfg is not None, "speculative mode"),
                         (config.mesh is not None, "mesh= (sharded serving)"),
                         (config.obs is not None, "obs= (observability)"),
                         (config.track_sparsity, "track_sparsity")):
            if on:
                raise NotImplementedError(
                    f"{what} is not ported to PyTorch yet (ROADMAP.md)")
        caps = registry.serving_caps(cfg)
        caps.require("paged_decode", cfg.family)
        if not cfg.d_ff:
            raise ValueError("continuous batching requires an FFN (d_ff > 0)")
        if config.prefill_chunk:
            caps.require("chunked_prefill", cfg.family)
        off = [t.device for t in _leaves(params) if t.device != self.device]
        if off:
            raise ValueError(f"params must lie on {self.device}; found "
                             f"{sorted(set(map(str, off)))}")
        self.predictor = predictor = config.predictor
        self.predictor_telemetry = config.predictor_telemetry
        if predictor is not None:
            caps.require("predictor", cfg.family)
            if predictor.n_tiles * predictor.tile != cfg.d_ff:
                raise ValueError(
                    f"predictor geometry {predictor.n_tiles}x"
                    f"{predictor.tile} does not cover d_ff={cfg.d_ff}")
            off = [t.device for t in predictor.params.values()
                   if t.device != self.device]
            if off:
                raise ValueError(f"predictor params must lie on {self.device}; "
                                 f"found {sorted(set(map(str, off)))}")
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
        n_blocks = config.resolved_n_blocks
        self.scheduler = Scheduler(
            config.n_slots, n_blocks, config.block_size,
            config.max_blocks_per_seq, prefix_cache=config.prefix_cache,
            preemption=config.preemption and config.prefill_chunk > 0,
            aging_steps=config.aging_steps)
        self.pages = self.fam.init_paged_cache(cfg, n_blocks, config.block_size,
                                               device=self.device)
        self.masks = torch.zeros((cfg.n_layers, config.n_slots, cfg.d_ff),
                                 dtype=torch.bool, device=self.device)
        self.t = 0
        self._uid = 0
        # per-(active slot, step) FFN weight-read fraction: down-projection
        # rows under γ-window reuse, gathered tiles in predictor mode
        self._dens_sum = 0.0
        self._dens_n = 0
        # predictor-mode recall accounting (miss counts from the step)
        self._pred_active = 0
        self._pred_miss = 0

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- request API --------------------------------------------------------
    def submit(self, prompt, max_new: int, reuse_window: int = 0,
               sampling: Optional[SamplingParams] = None, *,
               priority: int = 0, slo_ms: Optional[float] = None) -> int:
        """Enqueue a greedy request; returns its uid. ``reuse_window`` is
        the γ of the request's FFN weight reuse (0 = dense)."""
        require_greedy(sampling)
        self._uid += 1
        req = Request(uid=self._uid,
                      tokens=np.asarray(prompt, np.int32).reshape(-1),
                      max_new=max_new, reuse_window=reuse_window,
                      sampling=sampling, priority=priority, slo_ms=slo_ms)
        self.scheduler.submit(req, self.t)
        return self._uid

    def cancel(self, uid: int) -> bool:
        return self.scheduler.cancel(uid)

    # -- steps --------------------------------------------------------------
    @torch.inference_mode()
    def _admit(self) -> bool:
        """Retire finished requests, admit queued ones, and advance prefill:
        every newly admitted prompt at once (whole-prompt mode) or ONE chunk
        of every prefilling slot (chunked mode). True when prefill ran."""
        sched = self.scheduler
        sched.retire_finished(self.t)
        newly = sched.admit(self.t)
        if not self.prefill_chunk:
            for _, slot in newly:
                self._prefill_whole(slot)
            return bool(newly)
        if not sched.prefill_indices():
            return False
        self._prefill_one_chunk()
        return True

    def _prefill_whole(self, slot) -> None:
        s = slot.prefill_len
        nb_eff = -(-s // self.block_size)
        toks = np.zeros((1, nb_eff * self.block_size), np.int32)
        toks[0, :s] = slot.prefill_tokens
        last, self.pages = self.fam.model_prefill_paged(
            self.params, {"tokens": self._tensor(toks)}, self.cfg, self.pages,
            self._tensor(slot.blocks[:nb_eff], torch.int32), self.block_size,
            true_len=s)
        nxt, lp = greedy_head(last, self.cfg.vocab_size)
        self.scheduler.seed(slot, int(nxt[0]), float(lp[0]), step=self.t)

    def _prefill_one_chunk(self) -> None:
        sched = self.scheduler
        tokens, pos0, table, clen, first = sched.prefill_batch(
            self.prefill_chunk, self.prefill_budget)
        # prefilling slots run dense (refresh on) and harvest their union
        # activity into the mask row; continuing chunks OR into it
        refresh = clen > 0
        keep = self._tensor(refresh & ~first)
        logits, self.pages, new_masks, aux = self.fam.model_prefill_chunk_paged(
            self.params, {"tokens": self._tensor(tokens)}, self.cfg, self.pages,
            self._tensor(table), self._tensor(pos0), self._tensor(clen),
            self.masks, self._tensor(refresh), self.block_size,
            fast_kernels=self.fast_kernels)
        self.masks = torch.where(keep[None, :, None], self.masks | aux[0],
                                 new_masks)
        nxt, lp = greedy_head(logits, self.cfg.vocab_size)
        sched.record_prefill(nxt.cpu().numpy(), lp.cpu().numpy(), clen,
                             warm=self.warm_masks, step=self.t)

    @torch.inference_mode()
    def _advance(self, active) -> None:
        """Decode one token for every active slot."""
        sched = self.scheduler
        tokens, pos, table, refresh = sched.batch_arrays()
        logits, self.pages, self.masks, (_, _, density) = \
            self.fam.model_decode_paged(
                self.params, self.pages, self._tensor(table),
                self._tensor(tokens), self._tensor(pos), self.cfg, self.masks,
                self._tensor(refresh), self.block_size,
                fast_kernels=self.fast_kernels)
        nxt, lp = greedy_head(logits, self.cfg.vocab_size)
        lp_np, dens_np = torch.stack([lp, density.mean(0)]).cpu().numpy()
        nxt_np = nxt.cpu().numpy()
        self._account(active, dens_np)
        sched.record(nxt_np, lp_np)

    @torch.inference_mode()
    def _advance_pred(self, active) -> None:
        """Predictor-mode decode: per-token predicted tile lists drive the
        gathered up- and down-projections; density and recall telemetry
        come back with the step."""
        sched = self.scheduler
        pred = self.predictor
        tokens, pos, table, refresh = sched.batch_arrays()
        logits, self.pages, self.masks, (_, _, density, n_act, n_miss) = \
            self.fam.model_decode_paged_predicted(
                self.params, self.pages, self._tensor(table),
                self._tensor(tokens), self._tensor(pos), self.cfg, self.masks,
                self._tensor(refresh), pred.params, pred.kind, pred.tile,
                pred.k_tiles, self.block_size, self.predictor_telemetry,
                fast_kernels=self.fast_kernels)
        nxt, lp = greedy_head(logits, self.cfg.vocab_size)
        lp_np, dens_np = torch.stack([lp, density.mean(0)]).cpu().numpy()
        na, nm = torch.stack([n_act.sum(0), n_miss.sum(0)]).cpu().numpy()
        nxt_np = nxt.cpu().numpy()
        self._account(active, dens_np)
        self._pred_active += int(sum(na[i] for i in active))
        self._pred_miss += int(sum(nm[i] for i in active))
        sched.record(nxt_np, lp_np, pred_density=dens_np, pred_active=na,
                     pred_miss=nm)

    def _account(self, active, dens_np) -> None:
        """Per-(active slot, step) weight-read fraction."""
        self.scheduler.record_io(active, dens_np)
        for i in active:
            self._dens_sum += float(dens_np[i])
            self._dens_n += 1

    def step(self) -> bool:
        """Retire, admit, advance prefill (one chunk in chunked mode), then
        decode one token per active slot. False when no work ran."""
        prefilled = self._admit()
        active = self.scheduler.active_indices()
        if active:
            if self.predictor is not None:
                self._advance_pred(active)
            else:
                self._advance(active)
        elif not prefilled:
            return False
        self.t += 1
        return True

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
        skipped by γ-window reuse. Predictor mode: up- AND down-projection
        tiles the predictor never gathered (1 - mean predicted density)."""
        if not self._dens_n:
            return 0.0
        return 1.0 - self._dens_sum / self._dens_n

    def _mode_ffn_bytes(self) -> int:
        """Per-step FFN weight bytes per token, dense, in the serving mode's
        skippable scope: every projection for predictor serving and on the
        dense family's kernel path (the fused kernel gathers the γ-mask's
        tiles for the up- and down-projections), the down-projection
        otherwise. MoE counts all experts: routing is part of the measured
        density (expert fraction x within-expert density), so density x
        this figure is the activated-expert bytes, as in the reference. Its
        step has no fused FFN kernel, so its scope is the down-projection
        on the card too."""
        cfg = self.cfg
        itemsize = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                               ).element_size()
        proj = cfg.d_ff * cfg.d_model * itemsize * max(1, cfg.n_experts)
        n_all = 3 if cfg.ffn_kind == "glu" else 2
        if self.predictor is not None or (self.fast_kernels
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

    def expert_io_fraction(self) -> Optional[float]:
        """Fraction of the expert FFN weights a token's routing activates,
        top_k / n_experts; None for a family without experts. Exact under
        drop-free capacity (a dropped assignment only reads less)."""
        if not self.cfg.n_experts:
            return None
        return self.cfg.top_k / self.cfg.n_experts

    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix cache."""
        s = self.scheduler
        if not s.prefill_tokens_total:
            return 0.0
        return s.prefill_tokens_saved / s.prefill_tokens_total
