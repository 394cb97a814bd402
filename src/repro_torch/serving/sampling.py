"""Batched sampling head of the port's engine: the reference's
``serving/sampling.py`` in torch, with the threefry key schedule of
``serving/prng.py``.

One head serves every request in the slot batch, whatever its sampling
configuration: temperature / top-k / top-p arrive as per-slot tensors, so
a greedy request can sit next to a temperature-1.2 top-p-0.9 one in the
same step. Temperature-0 rows take the greedy branch, the formula the
engine always used (argmax + full log-softmax logprob).

Determinism (the serving contract, as the reference's): every sampled
request owns a key derived from ``(seed, request fingerprint)`` and never
from its uid, slot or admission order; the g-th generated token is drawn
with ``fold_in(request_key, g)``. Speculative mode drafts and verifies
with that same schedule, so acceptance keeps a proposal only while it
equals the target's own sample and the sampled stream equals the
autoregressive one for any draft.

Against the reference: keys and random bits are bit-equal; the Gumbel
noise and the top-p prefix mass are float sums that torch and XLA round
differently in the last bit, so a token can differ only where two
candidates' noisy logits lie within about 1e-6 of each other, or a
nucleus boundary's mass within about 2e-7 of ``top_p``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.serving import prng

# temperature floor for the sampling branch: rows at/below 0 take the greedy
# branch, so this only guards the discarded lane against inf/nan
_MIN_TEMP = 1e-6


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature: 0 (default) = greedy decoding. > 0 samples from the
        filtered, renormalised softmax of logits / temperature.
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


# ---------------------------------------------------------------------------
# request key schedule (host side)


def request_fingerprint(tokens, sp: SamplingParams) -> int:
    """Stable 64-bit fingerprint of WHAT is being sampled: the prompt and
    the distribution-shaping params. Deliberately excludes uid / slot /
    admission order (replay must not depend on co-scheduled traffic),
    ``max_new`` (a longer budget extends the stream instead of reshuffling
    it) and ``stop`` (stopping truncates, it does not change the
    distribution). blake2b, not ``hash()`` — python's is salted per
    process, which would break restart determinism."""
    h = hashlib.blake2b(digest_size=8)
    h.update(np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes())
    h.update(np.float64(sp.temperature).tobytes())
    h.update(np.int64(sp.top_k).tobytes())
    h.update(np.float64(sp.top_p).tobytes())
    return int.from_bytes(h.digest(), "little")


def request_prng_key(tokens, sp: SamplingParams,
                     base_seed: int = 0) -> np.ndarray:
    """The request's root PRNG key: the seed's key folded with the request
    fingerprint (two 31-bit folds). Returns a host (2,) uint32 array the
    scheduler stores per slot."""
    seed = sp.seed if sp.seed is not None else base_seed
    fp = request_fingerprint(tokens, sp)
    key = prng.seed_key(int(seed))
    key = prng.fold_in(key, fp & 0x7FFFFFFF)
    key = prng.fold_in(key, (fp >> 31) & 0x7FFFFFFF)
    return key.numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# per-position keys (on the step's device)


def position_keys(keys: torch.Tensor, gen: torch.Tensor) -> torch.Tensor:
    """Per-slot key for one generated index. keys (B, 2) request root keys
    (int64 words); gen (B,) generated-token indices -> (B, 2)."""
    return prng.fold_in(keys, gen)


def window_keys(keys: torch.Tensor, gen0: torch.Tensor, W: int
                ) -> torch.Tensor:
    """Keys for a W-token verify window: position j of slot b gets the key
    of generated index gen0[b] + j. Returns (B, W, 2)."""
    offs = torch.arange(W, dtype=torch.int64, device=keys.device)
    return prng.fold_in(keys[:, None, :], gen0.to(torch.int64)[:, None] + offs)


# ---------------------------------------------------------------------------
# the sampling head


def filter_logits(logits: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, temperature: torch.Tensor
                  ) -> torch.Tensor:
    """Temperature-scale then mask logits outside the top-k / top-p
    support with -inf. logits (B, V) f32; per-row top_k (B,) int
    (0 = off), top_p (B,) f32, temperature (B,) f32. The resulting rows
    renormalize over the surviving support (log_softmax of the output).

    Ties at the k-th / nucleus-boundary value keep every tied token (the
    support can only grow, never lose the argmax)."""
    V = logits.shape[-1]
    scaled = logits / torch.clamp(temperature, min=_MIN_TEMP)[:, None]
    svals = torch.sort(scaled, dim=-1, descending=True).values
    # top-k: threshold at the k-th largest value (k=0 -> keep everything)
    k = torch.where(top_k > 0, top_k, V).clamp(1, V).to(torch.int64)
    keep_k = scaled >= svals.gather(-1, (k - 1)[:, None])
    # top-p: smallest sorted prefix whose cumulative mass reaches top_p —
    # keep positions whose PRECEDING cumulative mass is < top_p (the first
    # position always survives, so the support is never empty)
    probs = torch.softmax(svals, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    n_keep = ((csum - probs) < top_p[:, None]).sum(-1)
    # top_p >= 1 must be EXACTLY off: f32 cumsum saturates at 1.0 once the
    # head holds all the mass, which would silently drop underflowed tail
    # tokens from the support
    n_keep = torch.where(top_p >= 1.0, V, n_keep)
    keep_p = scaled >= svals.gather(-1, (n_keep - 1)[:, None])
    return torch.where(keep_k & keep_p, scaled,
                       torch.full_like(scaled, -torch.inf))


def greedy_head(logits: torch.Tensor, vocab: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., vocab_p) logits -> (next token (...,) int32, logprob (...,)
    f32): argmax over the first ``vocab`` entries in f32 (first maximum on
    ties, as jnp.argmax) and its log-softmax."""
    lv = logits[..., :vocab].float()
    nxt = torch.argmax(lv, dim=-1)
    lp = torch.gather(torch.log_softmax(lv, dim=-1), -1, nxt[..., None])[..., 0]
    return nxt.to(torch.int32), lp


def _sample_rows(logits, vocab: int, temperature, top_k, top_p, keys):
    """(N, vocab_p) logits -> (next (N,) int32, logprob (N,) f32). Greedy
    rows are the greedy head's outputs; sampled rows report the logprob
    under the FILTERED, renormalised distribution."""
    greedy_nxt, greedy_lp = greedy_head(logits, vocab)
    lv = logits[..., :vocab].float()
    filt = filter_logits(lv, top_k, top_p, temperature)
    samp = prng.categorical(keys, filt)
    samp_lp = torch.gather(torch.log_softmax(filt, dim=-1), -1,
                           samp[:, None])[:, 0]
    g = temperature <= 0.0
    return (torch.where(g, greedy_nxt, samp.to(torch.int32)),
            torch.where(g, greedy_lp, samp_lp))


def sample_head(logits: torch.Tensor, vocab: int, temperature, top_k, top_p,
                keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The engine's sampling head. logits (..., vocab_p) with any leading
    batch shape (slot batch, or slot x window); temperature / top_k /
    top_p carry that same batch shape (callers broadcast the per-slot
    tensors over a window axis); keys (..., 2) per-position keys from
    ``position_keys`` / ``window_keys``. Nothing here syncs the host; a
    caller that knows every row is greedy can call ``greedy_head`` alone,
    with the same outputs. Returns (next_token (...,) int32, logprob
    (...,) f32)."""
    batch = logits.shape[:-1]
    n = int(np.prod(batch, dtype=np.int64))
    nxt, lp = _sample_rows(
        logits.reshape(n, logits.shape[-1]), vocab,
        torch.as_tensor(temperature).reshape(n),
        torch.as_tensor(top_k).reshape(n), torch.as_tensor(top_p).reshape(n),
        keys.reshape(n, 2))
    return nxt.reshape(batch), lp.reshape(batch)
