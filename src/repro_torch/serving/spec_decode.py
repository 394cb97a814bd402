"""Speculative-decoding metrics + theory reporting (paper Sec. 5.2, App. C);
a copy of the reference's ``serving/spec_decode.py``.

The EXECUTION of sparse speculative decoding lives in the continuous-
batching engine: batched γ-token drafting (``draft_gamma_paged``), one-forward
window verification (models/transformer.py ``verify_window_paged``) and KV
rewind-on-reject are engine/scheduler concerns (serving/engine.py,
serving/scheduler.py). This module is the per-request reporting layer — it
turns the scheduler's raw accept/propose/target-call counts into the
paper's quantities:

* measured α — the per-proposal acceptance fraction, accepted_drafts /
  proposed_drafts. (NOT derived from tokens-per-target-call: a produced/n_t
  ratio folds the free correction token of every window into "acceptance"
  and overstates α.)
* Thm 1 speedup — sparse vs standard speculative verification at the
  measured aggregated window sparsity s_agg(γ);
* Thm 2 speedup — sparse speculative decoding vs plain autoregressive
  decoding at (α, s_agg(γ)).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import spec_theory
from repro_torch.serving.scheduler import RequestResult


@dataclasses.dataclass
class SpecResult:
    tokens: np.ndarray  # (n_new,)
    accept_rate: float  # measured alpha = accepted / proposed drafts
    n_target_calls: int  # verify windows + 1 prefill
    n_draft_calls: int  # drafted proposals submitted for verification
    target_call_reduction: float  # tokens produced per target call
    s_agg_window: float  # measured aggregated sparsity per gamma-window
    thm1_speedup: float  # sparse vs standard spec decoding (App. C)
    thm2_speedup: float  # sparse spec decoding vs autoregressive


def spec_metrics(result: RequestResult, *, gamma: int, c: float,
                 s_agg: float) -> SpecResult:
    """Per-request speculative metrics from an engine ``RequestResult``.

    gamma: the engine's draft length; c: draft/target cost ratio for the
    theory speedups; s_agg: measured aggregated window sparsity (e.g. the
    engine's ``s_agg_window()``).
    """
    alpha = result.accept_rate
    n_t = result.target_calls + 1  # prefill counts as one target call
    return SpecResult(
        tokens=result.tokens,
        accept_rate=alpha,
        n_target_calls=n_t,
        n_draft_calls=result.draft_proposed,
        target_call_reduction=len(result.tokens) / max(1, n_t),
        s_agg_window=s_agg,
        thm1_speedup=spec_theory.thm1_speedup(gamma, c, s_agg),
        thm2_speedup=spec_theory.thm2_speedup(gamma, c, s_agg, alpha),
    )
