"""Sampling head of the port's engine: ``SamplingParams`` (a copy of the
reference's) and its greedy branch.

Greedy rows take exactly the reference's greedy formula
(``sampling.py`` ``_sample_rows``): argmax over the first ``vocab``
logits in f32, and that token's ``log_softmax`` logprob. Requests with
temperature > 0 raise NotImplementedError: seeded sampling needs the
reference's threefry key schedule in torch, a later slice (ROADMAP.md,
"seeded sampling head").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature: 0 (default) = greedy decoding. > 0 would sample from the
        filtered, renormalised softmax of logits / temperature; the port
        raises NotImplementedError for it at submit.
    top_k: keep only the k highest-probability tokens (0 = off).
    top_p: nucleus sampling — keep the smallest prefix of the
        probability-sorted vocabulary whose cumulative mass reaches top_p
        (1.0 = off). Composes with top_k (intersection of both supports).
    seed: PRNG seed for this request's key schedule. None uses the
        engine's ``base_seed`` — identical unseeded requests then replay
        identical streams (full determinism is a feature of this repo;
        pass a fresh seed per request for varied completions).
    stop: stop sequences, each a tuple of token ids. Generation halts as
        soon as the produced stream ends with any of them (the stop tokens
        are included in the output); ``RequestResult.finish_reason``
        becomes "stop".
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    stop: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        # normalize stop to hashable nested tuples (callers pass lists)
        object.__setattr__(self, "stop",
                           tuple(tuple(int(t) for t in s) for s in self.stop))

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def require_greedy(sp: Optional[SamplingParams]) -> None:
    if sp is not None and not sp.is_greedy:
        raise NotImplementedError(
            "sampled decoding (temperature > 0) is not ported yet: it needs "
            "the threefry key schedule (ROADMAP.md, seeded sampling head)")


def greedy_head(logits: torch.Tensor, vocab: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., vocab_p) logits -> (next token (...,) int32, logprob (...,)
    f32): argmax over the first ``vocab`` entries in f32 (first maximum on
    ties, as jnp.argmax) and its log-softmax."""
    lv = logits[..., :vocab].float()
    nxt = torch.argmax(lv, dim=-1)
    lp = torch.gather(torch.log_softmax(lv, dim=-1), -1, nxt[..., None])[..., 0]
    return nxt.to(torch.int32), lp
