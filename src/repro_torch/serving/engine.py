"""Continuous-batching serving engine of the PyTorch port.

``ContinuousBatchingEngine(cfg, params, config=EngineConfig(...),
device="cuda")`` is the reference's engine (``serving/engine.py``) for its
plain greedy mode: requests are admitted and retired mid-decode by the
copied numpy scheduler, K/V lives in a paged block pool shared by the slot
batch, every step decodes one token per active slot with per-request
γ-window FFN masks, and admission runs either as whole-prompt prefill
(``prefill_chunk == 0``) or as one fixed-shape chunk per step. The shared
prompt-prefix cache and SLO preemption come with the scheduler.

PyTorch runs the step eagerly (no jit). ``fast_kernels`` follows the
device: on CUDA the steps run the hand-written kernels (kernels/*.py) and
``fast_kernels=False`` raises; on the CPU they run the reference's frozen
plain path, or with ``fast_kernels=True`` the kernel path's structure with
each wrapper's plain version. Not ported
yet, and raising NotImplementedError: speculative mode, predictor mode,
``mesh=``, ``obs=``, ``track_sparsity`` and sampled (temperature > 0)
requests.
"""
from __future__ import annotations

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
                         (config.predictor is not None, "predictor mode"),
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
        self.config = config
        self.cfg = cfg
        self.params = params
        self.fam = registry.get_family(cfg)
        self.fast_kernels = (self.device.type == "cuda"
                             or bool(config.fast_kernels))
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
        # per-(active slot, step) FFN weight-read fraction (γ-window reuse)
        self._dens_sum = 0.0
        self._dens_n = 0

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
        sched.record_io(active, dens_np)
        for i in active:
            self._dens_sum += float(dens_np[i])
            self._dens_n += 1
        sched.record(nxt_np, lp_np)

    def step(self) -> bool:
        """Retire, admit, advance prefill (one chunk in chunked mode), then
        decode one token per active slot. False when no work ran."""
        prefilled = self._admit()
        active = self.scheduler.active_indices()
        if active:
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
        """Fraction of FFN down-projection rows skipped by γ-window reuse,
        averaged over (active slot, step); 0.0 before any decode step."""
        if not self._dens_n:
            return 0.0
        return 1.0 - self._dens_sum / self._dens_n

    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix cache."""
        s = self.scheduler
        if not s.prefill_tokens_total:
            return 0.0
        return s.prefill_tokens_saved / s.prefill_tokens_total
