"""Fault-tolerant training loop (the reference's ``train/loop.py``).

* auto-resume from the latest checkpoint (params + optimizer + data-iterator
  state survive restarts); a checkpoint the reference's ``Trainer`` wrote
  resumes here too (the same tree, leaves and extras);
* SIGTERM/SIGINT → checkpoint-and-exit (preemption safe);
* non-finite steps skipped inside the step (train/step.py) and counted;
* straggler watchdog: per-step wall-time EMA; steps slower than
  `straggler_factor ×` EMA are logged/counted;
* periodic eval on held-out synthetic data.

Params are f32 masters on the trainer's device (CUDA unless
``device="cpu"``); checkpoints are written by the background writer
(``CheckpointManager(async_save=True)``). The final save blocks; where the
loop's last step is already on disk (just saved, or the step a run
resumed at and took no step past), it only waits for that write, where
the reference writes the same step again.
"""
from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import (DataConfig, IteratorState,
                                       PackedIterator, eval_batches)
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train.step import lm_loss, make_train_step
from repro_torch.tree import tree_map


@dataclasses.dataclass
class TrainerReport:
    steps: int
    losses: List[float]
    eval_losses: List[float]
    skipped_steps: int
    straggler_steps: int
    resumed_from: Optional[int]
    # the port's own: host seconds of each step's batch (made and copied
    # to the device) and of the step itself up to its loss on the host
    data_seconds: List[float] = dataclasses.field(default_factory=list)
    step_seconds: List[float] = dataclasses.field(default_factory=list)


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, dc: DataConfig,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 eval_every: int = 50, straggler_factor: float = 3.0,
                 log: Callable[[str], None] = print, device="cuda"):
        self.cfg, self.tc, self.dc = cfg, tc, dc
        self.device = cm.resolve_device(device)
        self.fam = registry.get_family(cfg)
        self.step_fn = make_train_step(cfg, tc)
        self.ckpt = (CheckpointManager(ckpt_dir, async_save=True)
                     if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.eval_every = eval_every
        self.straggler_factor = straggler_factor
        self.log = log
        self._stop = False
        self._eval = eval_batches(dc, 2)

    @contextlib.contextmanager
    def _signals(self):
        """SIGTERM/SIGINT -> checkpoint-and-exit while the block runs; the
        handlers they had are restored after it (so the process does not
        keep this trainer alive through them). Off the main thread Python
        cannot install a handler, and nothing changes."""
        def handler(signum, frame):
            self.log(f"[trainer] signal {signum}: checkpoint-and-exit")
            self._stop = True
        old = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                old[sig] = signal.signal(sig, handler)
        except ValueError:
            pass  # not in main thread (tests)
        try:
            yield
        finally:
            for sig, h in old.items():
                if h is not None:
                    signal.signal(sig, h)

    def _to_device(self, batch):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    @torch.no_grad()
    def eval_loss(self, params) -> float:
        losses = [float(lm_loss(params, self._to_device(b), self.cfg)[0])
                  for b in self._eval]
        return float(np.mean(losses))

    def run(self, n_steps: int, params=None, opt_state=None) -> TrainerReport:
        """Train to step ``n_steps``, resuming from the latest checkpoint
        if there is one (which then replaces ``params`` / ``opt_state``).
        SIGTERM/SIGINT during the run checkpoint and stop it. ``params``
        is rebound step by step in this one frame, so the caller's initial
        tree is freed after the first step (keep no other reference)."""
        with self._signals():
            cfg, tc, dc = self.cfg, self.tc, self.dc

            resumed_from = None
            start_step = 0
            it_state = None
            if params is None:
                params = self.fam.init_params(cfg, seed=tc.seed,
                                              device=self.device,
                                              dtype=torch.float32)
            if opt_state is None:
                opt_state = adamw.init_opt_state(params)
            if self.ckpt and self.ckpt.latest_step() is not None:
                tree, extras = self.ckpt.restore((params, opt_state))
                params, opt_state = tree_map(
                    lambda a, like: torch.as_tensor(a).to(like.device),
                    tree, (params, opt_state))
                start_step = int(extras["step"])
                resumed_from = start_step
                it_state = IteratorState.from_dict(extras["data"])
                self.log(f"[trainer] resumed from step {start_step}")

            it = PackedIterator(dc, it_state)
            losses: List[float] = []
            evals: List[float] = []
            data_s: List[float] = []
            step_s: List[float] = []
            skipped = 0
            stragglers = 0
            ema = None

            step = start_step
            on_disk = start_step if resumed_from is not None else None
            while step < n_steps and not self._stop:
                t_data = time.time()
                batch = self._to_device(next(it))
                t0 = time.time()
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.time() - t0
                data_s.append(t0 - t_data)
                step_s.append(dt)
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                if dt > self.straggler_factor * ema and step > start_step + 2:
                    stragglers += 1
                    self.log(f"[trainer] straggler step {step}: {dt:.2f}s vs ema {ema:.2f}s")
                if float(metrics["step_ok"]) == 0.0:
                    skipped += 1
                    self.log(f"[trainer] non-finite step {step} skipped")
                losses.append(loss)
                step += 1
                if self.ckpt and (step % self.ckpt_every == 0 or self._stop):
                    self.ckpt.save(step, (params, opt_state),
                                   extras={"step": step, "data": it.state().to_dict()})
                    on_disk = step
                if step % self.eval_every == 0:
                    ev = self.eval_loss(params)
                    evals.append(ev)
                    self.log(f"[trainer] step {step} loss {loss:.4f} eval {ev:.4f}")

            if self.ckpt and on_disk == step:
                self.ckpt.wait()  # this step is (being) written already
            elif self.ckpt:
                self.ckpt.save(step, (params, opt_state), block=True,
                               extras={"step": step, "data": it.state().to_dict()})
            self.params, self.opt_state = params, opt_state
            return TrainerReport(steps=step - start_step, losses=losses,
                                 eval_losses=evals, skipped_steps=skipped,
                                 straggler_steps=stragglers,
                                 resumed_from=resumed_from,
                                 data_seconds=data_s, step_seconds=step_s)
