"""Port engines built as twins of reference engines, for the port's tests
of observability and the serving front door: the same model config, the
same EngineConfig fields and the same weights (target, draft and
predictor probes, converted through numpy), on the CPU. One copy, shared
by tests/test_torch_obs.py, tests/test_torch_api.py and (the predictor
converter) tests/test_torch_predictor.py."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.predictor import predictors as tpred
from repro_torch.serving import ContinuousBatchingEngine, EngineConfig


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig.from_json(jcfg.to_json())


def port_params(jparams, tcfg: ModelConfig):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")


def port_predictor(pred) -> tpred.Predictor:
    """A reference predictor as the port's dataclass, params on the CPU."""
    params = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in pred.params.items()}
    if "w" in params:
        params["w"] = params["w"].to(getattr(torch, pred.probe_dtype))
    return tpred.Predictor(
        kind=pred.kind, params=params, n_tiles=pred.n_tiles,
        k_tiles=pred.k_tiles, tile=pred.tile,
        target_recall=pred.target_recall, probe_dtype=pred.probe_dtype,
        reports=[tpred.LayerReport(**dataclasses.asdict(r))
                 for r in pred.reports])


def port_twin(jeng, **overrides) -> ContinuousBatchingEngine:
    """The port's engine beside reference engine ``jeng``: its config's
    fields (``overrides`` replace some), with a fresh observability hub."""
    c = jeng.config
    kw = {f.name: getattr(c, f.name) for f in dataclasses.fields(EngineConfig)}
    kw.update(obs=None, mesh=None)
    if c.draft_cfg is not None:
        dcfg = port_cfg(c.draft_cfg)
        kw.update(draft_cfg=dcfg,
                  draft_params=port_params(jeng.draft_params, dcfg))
    if c.predictor is not None:
        kw["predictor"] = port_predictor(jeng.predictor)
    kw.update(overrides)
    tcfg = port_cfg(jeng.cfg)
    return ContinuousBatchingEngine(tcfg, port_params(jeng.params, tcfg),
                                    EngineConfig(**kw), device="cpu")
