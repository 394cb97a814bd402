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

batch is a dict: {"tokens": (b, s) int}; NO_STATS is ``common.NO_STATS``,
the shared inactive collector.

The dense and MoE families are ported; each declares the paged-serving
capabilities it serves, as the reference's do (MoE has no predictor mode
and cannot draft; it verifies a dense draft's windows). The reference's other
families are known by name with an empty capability set, so serving one
raises the uniform ``ServingCaps.require`` error, and asking for its module
raises NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

from repro_torch.models.serving_protocol import ServingCaps, validate_caps

_FAMILIES: Dict[str, Any] = {}
_CAPS: Dict[str, ServingCaps] = {}
_NOT_PORTED = ("mamba", "hybrid", "encdec", "vlm")


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
    if _FAMILIES[name] is None:
        raise NotImplementedError(f"model family {name!r} is not ported to "
                                  "PyTorch yet (ROADMAP.md)")
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
    elif name in _NOT_PORTED:
        _FAMILIES[name] = None
        _CAPS[name] = ServingCaps()
    else:
        raise KeyError(f"unknown model family {name!r}")
