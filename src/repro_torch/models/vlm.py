"""InternVL2 family (internvl2-1b), in PyTorch — the reference's
``models/vlm.py``: the InternLM2-style dense backbone behind a STUB ViT
frontend. Callers pass precomputed patch embeddings batch["patches"]
(b, n_vision_tokens, d_model), prepended to the token embeddings
(``transformer.forward(extra_embeds=)``). Relufication applies to the
backbone's FFNs exactly as for the dense family, and the decode step is
the dense one (static tile capacities through kernel 5 on the card;
γ-window masks through ``ffn_masks``).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as T

init_params = T.init_params


def prompt_token_offset(cfg: ModelConfig) -> int:
    """Serving-protocol hook: text decode positions start after the vision
    patch positions the prefill consumed."""
    return cfg.n_vision_tokens


def model_forward(params, batch, cfg: ModelConfig, *, stats=cm.NO_STATS,
                  remat_policy: str = "none"):
    """Logits of the token positions (b, s, vocab_p), after the patches."""
    logits = T.forward(params, batch["tokens"], cfg, stats=stats,
                       extra_embeds=batch["patches"],
                       block=cm.wrap_block(remat_policy, T.apply_block))
    return logits[:, batch["patches"].shape[1]:]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    return T.init_cache(cfg, batch, max_len, device=device)


def model_prefill(params, batch, cfg: ModelConfig, max_len: int,
                  stats=cm.NO_STATS):
    """Prompt = vision patches ++ tokens; the cache covers both."""
    return T.prefill(params, batch["tokens"], cfg, max_len, stats=stats,
                     extra_embeds=batch["patches"])


def model_decode(params, cache, token, pos, cfg: ModelConfig,
                 stats=cm.NO_STATS, ffn_masks=None):
    return T.decode_step(params, cache, token, pos, cfg, stats=stats,
                         ffn_masks=ffn_masks)
