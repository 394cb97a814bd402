"""EngineConfig: the validated configuration surface of the port's
continuous-batching engine — a copy of the reference's dataclass (same
fields, defaults and ``validate()``). The historical keyword form
``ContinuousBatchingEngine(cfg, params, n_slots=4, ...)`` still works
through ``EngineConfig.from_legacy_kwargs``, which warns once per process
and maps the keywords one to one onto the fields.

``validate()`` owns every rule decidable from the config alone; rules that
need the model config, the device or the mesh stay in the engine (``mesh``
takes a ``repro_torch.launch.mesh.Mesh``; one with data > 1 raises
NotImplementedError there). ``obs`` takes a ``repro_torch.obs.EngineObs`` (None: the engine
makes an enabled one) and ``track_sparsity`` keeps a per-request
``AggregatedTracker``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

_LEGACY_KWARGS_WARNED = False


@dataclasses.dataclass
class EngineConfig:
    """Everything that shapes a ``ContinuousBatchingEngine`` besides the
    model config and params. Field semantics are documented on the engine
    class (they are the former constructor kwargs, names unchanged).

    Scheduling fields (SLO-aware scheduler):

    aging_steps: engine steps a queued request waits before its EFFECTIVE
        priority rises by one class. Aging bounds both starvation (a
        low-priority request eventually outranks the traffic passing it)
        and the admission skip-ahead (a stuck queue head that has waited
        ``aging_steps`` becomes a hard barrier — nothing may be admitted
        around it until it fits). 0 disables aging AND the barrier:
        admission is pure priority-then-FIFO with unbounded skip-ahead.
    preemption: allow admission to preempt a running slot whose RAW
        priority is strictly below the candidate's when no free slot /
        blocks remain. The preempted request keeps its generated prefix:
        its blocks are parked in the prefix trie (when enabled) and it
        re-enters the queue, resuming later via chunked prefill of the
        cold suffix — f32 greedy streams are byte-identical across a
        preempt/resume cycle (tests/test_torch_engine.py holds the port's
        streams to the reference engine's through one). With every
        request at the same priority (the default), preemption never
        triggers.
    fast_kernels: None follows the device (the hand-written kernels on
        CUDA, the plain path on the CPU); True on the CPU runs the kernel
        path with each kernel wrapper's plain version; False on CUDA
        raises.
    prefill_budget: cap on the TOTAL prompt tokens prefilled per engine
        step across all prefilling slots (chunked mode only) — trades
        admission latency (TTFT) against decode TPOT for already-running
        requests. 0 = unlimited (every prefilling slot advances one full
        chunk per step).
    """

    n_slots: int = 4
    block_size: int = 16
    max_blocks_per_seq: int = 8
    n_blocks: Optional[int] = None
    track_sparsity: bool = False
    draft_cfg: Any = None
    draft_params: Any = None
    gamma: int = 4
    predictor: Any = None
    predictor_telemetry: bool = True
    prefill_chunk: int = 0
    prefix_cache: bool = False
    warm_masks: bool = False
    mesh: Any = None
    base_seed: int = 0
    fast_kernels: Optional[bool] = None
    obs: Any = None
    # -- SLO-aware scheduling --
    prefill_budget: int = 0
    preemption: bool = True
    aging_steps: int = 32

    @property
    def resolved_n_blocks(self) -> int:
        """Pool size with the full-residency default applied."""
        if self.n_blocks is None:
            return 1 + self.n_slots * self.max_blocks_per_seq
        return self.n_blocks

    def validate(self) -> "EngineConfig":
        """Raise ValueError on any self-contained rule violation; returns
        self so ``EngineConfig(...).validate()`` chains."""
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.max_blocks_per_seq < 1:
            raise ValueError("max_blocks_per_seq must be >= 1")
        if self.resolved_n_blocks - 1 < self.max_blocks_per_seq:
            raise ValueError("pool smaller than one request's worst case")
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        if self.prefill_budget < 0:
            raise ValueError("prefill_budget must be >= 0")
        if self.aging_steps < 0:
            raise ValueError("aging_steps must be >= 0")
        if self.prefix_cache and not self.prefill_chunk:
            raise ValueError(
                "prefix_cache requires chunked prefill (prefill_chunk > 0): "
                "a cache hit prefills only the cold suffix, which resumes "
                "mid-prompt against cached blocks — the whole-prompt "
                "executable always starts at position 0")
        if self.warm_masks and not self.prefill_chunk:
            raise ValueError("warm_masks requires chunked prefill "
                             "(prefill_chunk > 0): the warm γ-mask is "
                             "harvested from the prefill chunks")
        if self.predictor is not None and self.draft_cfg is not None:
            raise ValueError("predictor and speculative modes are "
                             "mutually exclusive serving modes")
        if self.draft_cfg is not None and self.gamma < 1:
            raise ValueError("speculative mode needs gamma >= 1")
        if self.preemption and not self.prefill_chunk:
            # resume re-prefills the prompt+generated prefix from an
            # arbitrary mid-sequence position, which only the chunked
            # path can lower — whole-prompt prefill always starts at 0.
            # Allowed but inert: the engine downgrades to preemption=False
            # (the default-on knob must not break prefill_chunk=0 users).
            pass
        return self

    @staticmethod
    def from_legacy_kwargs(**kwargs) -> "EngineConfig":
        """Build an EngineConfig from the engine's old constructor keywords.
        Warns once per process; unknown names raise TypeError, as the old
        keyword signature did."""
        global _LEGACY_KWARGS_WARNED
        if not _LEGACY_KWARGS_WARNED:
            _LEGACY_KWARGS_WARNED = True
            warnings.warn(
                "ContinuousBatchingEngine(cfg, params, **kwargs) is "
                "deprecated: pass config=EngineConfig(...) instead "
                "(serving/config.py; field names match the old kwargs "
                "one to one)", DeprecationWarning, stacklevel=3)
        known = {f.name for f in dataclasses.fields(EngineConfig)}
        unknown = sorted(set(kwargs) - known)
        if unknown:
            raise TypeError(
                f"unexpected engine keyword(s) {unknown}; EngineConfig "
                f"fields are {sorted(known)}")
        return EngineConfig(**kwargs)
