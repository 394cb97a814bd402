"""Architecture-family registry of the port.

Uniform interface per family (duck-typed module), as in the reference:
  init_params(cfg, *, seed, device) -> params
  model_forward(params, batch, cfg, *, stats=NO_STATS, remat_policy="none")
      -> logits aligned with batch["tokens"] (b, s, vocab_p)
  init_cache(cfg, batch, max_len, device) -> cache dict
  model_prefill(params, batch, cfg, max_len, stats=NO_STATS)
      -> (logits_b, cache)
  model_decode(params, cache, token, pos, cfg, stats=NO_STATS)
      -> (logits, cache)

batch is a dict: {"tokens": (b, s) int} plus the modality stubs
"patches" (vlm) and "frames" (encdec); NO_STATS is ``common.NO_STATS``,
the shared inactive collector.

All six of the reference's families are ported. Dense and MoE declare
the paged-serving capabilities they serve, as the reference's do (MoE has
no predictor mode and cannot draft; it verifies a dense draft's windows).
Mamba, hybrid, encdec and vlm declare none, as in the reference: they
serve through the legacy ``ServeEngine``, and the continuous engine
raises the uniform ``ServingCaps.require`` error for them.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

from repro_torch.models.serving_protocol import ServingCaps, validate_caps

_FAMILIES: Dict[str, Any] = {}
_CAPS: Dict[str, ServingCaps] = {}


def register_family(name: str, module, caps: Iterable[str] = ()) -> None:
    caps = ServingCaps(caps)
    validate_caps(name, module, caps)
    _FAMILIES[name] = module
    _CAPS[name] = caps


def _name(cfg_or_name) -> str:
    return cfg_or_name if isinstance(cfg_or_name, str) else cfg_or_name.family


def get_family(cfg_or_name) -> Any:
    name = _name(cfg_or_name)
    if name not in _FAMILIES:
        _load_builtin(name)
    return _FAMILIES[name]


def serving_caps(cfg_or_name) -> ServingCaps:
    name = _name(cfg_or_name)
    if name not in _FAMILIES:
        _load_builtin(name)
    return _CAPS[name]


def _load_builtin(name: str) -> None:
    if name == "dense":
        from repro_torch.models import dense_family
        register_family("dense", dense_family,
                        caps=("paged_decode", "chunked_prefill",
                              "spec_verify", "spec_draft", "predictor"))
    elif name == "moe":
        from repro_torch.models import moe
        register_family("moe", moe, caps=("paged_decode", "chunked_prefill",
                                          "spec_verify"))
    elif name == "vlm":
        from repro_torch.models import vlm
        register_family("vlm", vlm)
    elif name == "mamba":
        from repro_torch.models import mamba
        register_family("mamba", mamba)
    elif name == "hybrid":
        from repro_torch.models import hybrid
        register_family("hybrid", hybrid)
    elif name == "encdec":
        from repro_torch.models import encdec
        register_family("encdec", encdec)
    else:
        raise KeyError(f"unknown model family {name!r}")
