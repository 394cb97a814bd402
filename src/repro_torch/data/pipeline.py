"""Deterministic data pipeline: synthetic corpus + packing + shard-aware,
resumable host iterator — a numpy copy of the reference's
``data/pipeline.py``, kept apart so the port imports nothing of the JAX
package; for the same ``DataConfig`` its batches are bit-equal to the
reference's. It runs on the host; the trainer copies each batch to the
device.

The synthetic corpus is a mixture of Zipfian unigrams and Markov bigram
chains ("documents") so tiny models have real structure to learn — loss
decreases and relufied fine-tuning (paper Sec. 4) is demonstrable on CPU.
Documents are packed into fixed-length rows with EOS separators and a loss
mask. The iterator state is one integer (next doc id) per host shard →
checkpointable and elastic (rescaling hosts re-partitions the id space).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int = 256
    seq_len: int = 64
    batch_size: int = 8
    seed: int = 17
    eos_id: int = 0
    doc_len_min: int = 16
    doc_len_max: int = 96
    n_markov_states: int = 64
    host_index: int = 0
    host_count: int = 1


class SyntheticCorpus:
    """Deterministic doc generator: doc id -> token array (stateless)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        # Zipfian unigram base distribution (skip eos)
        ranks = np.arange(1, v)
        probs = 1.0 / ranks ** 1.1
        self.unigram = probs / probs.sum()
        # Markov transition matrix over a state subset -> strong structure
        m = cfg.n_markov_states
        trans = root.dirichlet(np.full(min(m, v - 1), 0.3), size=m)
        self.trans = trans
        self.state_tokens = root.choice(ranks, size=min(m, v - 1), replace=False)

    def doc(self, doc_id: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + doc_id) % 2**31)
        n = rng.randint(cfg.doc_len_min, cfg.doc_len_max + 1)
        m = self.trans.shape[0]
        state = rng.randint(m)
        out = np.empty((n,), np.int32)
        for i in range(n):
            if rng.rand() < 0.15:  # unigram noise
                out[i] = rng.choice(len(self.unigram), p=self.unigram) + 1
            else:
                state = rng.choice(m, p=self.trans[state])
                out[i] = self.state_tokens[state]
        return out


@dataclasses.dataclass
class IteratorState:
    next_doc: int

    def to_dict(self) -> Dict[str, int]:
        return {"next_doc": int(self.next_doc)}

    @staticmethod
    def from_dict(d) -> "IteratorState":
        return IteratorState(next_doc=int(d["next_doc"]))


class PackedIterator:
    """Packs documents into (batch, seq_len) rows with EOS separators.

    Host-sharded: host i consumes doc ids ≡ i (mod host_count). Resumable:
    state is the next doc id (plus a small carry buffer regenerated
    deterministically on restore).
    """

    def __init__(self, cfg: DataConfig, state: Optional[IteratorState] = None):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        start = state.next_doc if state else cfg.host_index
        # align to this host's residue class
        if start % cfg.host_count != cfg.host_index:
            start += (cfg.host_index - start) % cfg.host_count
        self.next_doc = start
        self._carry = np.zeros((0,), np.int32)

    def state(self) -> IteratorState:
        return IteratorState(next_doc=self.next_doc)

    def _fill_row(self) -> np.ndarray:
        cfg = self.cfg
        buf = self._carry
        while len(buf) < cfg.seq_len:
            doc = self.corpus.doc(self.next_doc)
            self.next_doc += cfg.host_count
            buf = np.concatenate([buf, doc, [cfg.eos_id]])
        self._carry = buf[cfg.seq_len:]
        return buf[: cfg.seq_len].astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rows = np.stack([self._fill_row() for _ in range(self.cfg.batch_size)])
        mask = (rows != self.cfg.eos_id).astype(np.float32)
        return {"tokens": rows, "loss_mask": mask}


def eval_batches(cfg: DataConfig, n: int, offset: int = 10_000_000):
    """Held-out batches (disjoint doc-id range)."""
    it = PackedIterator(dataclasses.replace(cfg),
                        IteratorState(next_doc=offset + cfg.host_index))
    return [next(it) for _ in range(n)]
