"""Family-agnostic paged-serving protocol (the reference's
``models/serving_protocol.py``, in torch).

1. **Declared capabilities** (``ServingCaps``): each family registered in
   models/registry.py declares the paged-serving entry points it
   implements; the engine gates every mode on ``ServingCaps.require``,
   which raises one uniform error naming the missing capability.

2. **The shared paged-step skeleton**: embed -> per-layer loop carrying the
   paged K/V pool -> γ-window mask refresh -> final norm + logits.
   ``decode_step_core`` / ``window_step_core`` hold it once, parameterised
   by the family's per-layer block function. Where the reference scans
   over stacked layers, this is a Python loop over layer views.

Under a serving mesh the skeleton is unchanged: the masks it carries and
refreshes are the rank's d_ff slice (the FFN weights' split), and the
layer functions put the collectives in.

Family hook with a default: ``prompt_token_offset(cfg) -> int``, the extra
non-text positions a family prepends to the prompt; the legacy
``ServeEngine`` offsets decode positions by it. Default 0.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models import common as cm

# capability name -> module functions a family must define to declare it.
CAP_FUNCS: Dict[str, Tuple[str, ...]] = {
    "paged_decode": ("init_paged_cache", "model_prefill_paged",
                     "model_decode_paged"),
    "chunked_prefill": ("model_prefill_chunk_paged",),
    "spec_verify": ("model_verify_window_paged",),
    "spec_draft": ("model_draft_gamma_paged",),
    "predictor": ("model_decode_paged_predicted",),
}


class ServingCaps(frozenset):
    """A family's declared paged-serving capability set."""

    def require(self, cap: str, family: str) -> None:
        """Raise the uniform unsupported-capability ValueError unless this
        family declared ``cap``."""
        if cap not in CAP_FUNCS:
            raise KeyError(f"unknown serving capability {cap!r} "
                           f"(known: {sorted(CAP_FUNCS)})")
        if cap not in self:
            declared = ", ".join(sorted(self)) if self else "none"
            raise ValueError(
                f"family {family!r} does not support the {cap!r} serving "
                f"capability (declared capabilities: {declared})")


def validate_caps(name: str, module, caps: ServingCaps) -> None:
    """Registration-time check: every declared capability's functions exist
    on the family module."""
    for cap in caps:
        if cap not in CAP_FUNCS:
            raise ValueError(f"family {name!r} declares unknown serving "
                             f"capability {cap!r} (known: {sorted(CAP_FUNCS)})")
        missing = [f for f in CAP_FUNCS[cap] if not hasattr(module, f)]
        if missing:
            raise ValueError(f"family {name!r} declares capability {cap!r} "
                             f"but is missing {missing}")


def prompt_token_offset(fam, cfg) -> int:
    """The family's extra prompt-position offset (default 0). Families with
    non-text prefix positions (the reference's vlm vision patches) define
    ``prompt_token_offset(cfg)``; resolved here so engines stay free of
    per-family probes."""
    hook = getattr(fam, "prompt_token_offset", None)
    return 0 if hook is None else int(hook(cfg))


def refresh_union_masks(ffn_masks, act, refresh):
    """γ-window mask update: slots flagged ``refresh`` replace their mask
    row with this step's (union) activity, others keep theirs."""
    return torch.where(refresh[None, :, None], act, ffn_masks)


def _layer_slice(tree, li: int):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, li) for k, v in tree.items()}
    return tree[li]


def _run_layers(params, pages, cfg, x, layer_fn: Callable, ffn_masks,
                extra_xs: Tuple = ()):
    kp, vp = pages["k"], pages["v"]
    auxs = []
    for li in range(cfg.n_layers):
        extras = tuple(_layer_slice(e, li) for e in extra_xs)
        x, kp, vp, aux = layer_fn(cm.layer_params(params, li), li, x, kp, vp,
                                  ffn_masks[li], *extras)
        auxs.append(aux)
    return x, {"k": kp, "v": vp}, tuple(torch.stack(a) for a in zip(*auxs))


def decode_step_core(params, pages, token, pos, cfg, ffn_masks, refresh, *,
                     layer_fn: Callable, embed_fn: Callable,
                     logits_fn: Callable, extra_xs: Tuple = ()):
    """Single-token paged decode. token/pos/refresh (b,); ffn_masks
    (L, b, F). layer_fn(pl_i, li, x, k_pages, v_pages, ffn_mask, *extras)
    -> (x, k_pages, v_pages, aux) with aux led by the (b, F) activity;
    extras are layer li's slices of the stacked trees in ``extra_xs``.
    Returns (logits (b, vocab_p), pages, new_masks (L, b, F), aux stacked
    over layers)."""
    x = embed_fn(params, token[:, None], cfg, pos[:, None])[:, 0]
    x, pages, aux = _run_layers(params, pages, cfg, x, layer_fn, ffn_masks,
                                extra_xs)
    new_masks = refresh_union_masks(ffn_masks, aux[0], refresh)
    x = cm.apply_norm(params["final_norm"], x[:, None], cfg)[:, 0]
    return logits_fn(params, x, cfg), pages, new_masks, aux


def window_step_core(params, pages, tokens, pos0, wlen, cfg, ffn_masks,
                     refresh, *, layer_fn: Callable, embed_fn: Callable,
                     logits_fn: Callable):
    """W-token paged window step (chunked prefill; W == 1 is a decode
    step). tokens (b, W); pos0/wlen/refresh (b,). layer_fn also receives
    the window's write positions pos (b, W) and validity valid (b, W).
    Returns (logits (b, W, vocab_p), pages, new_masks (L, b, F), aux)."""
    b, W = tokens.shape
    pos = pos0[:, None] + torch.arange(W, dtype=pos0.dtype,
                                       device=pos0.device)[None, :]
    valid = torch.arange(W, device=wlen.device)[None, :] < wlen[:, None]
    x = embed_fn(params, tokens, cfg, pos)

    def wrapped(pl_i, li, x, kp, vp, fm):
        return layer_fn(pl_i, li, x, kp, vp, fm, pos, valid)

    x, pages, aux = _run_layers(params, pages, cfg, x, wrapped, ffn_masks)
    new_masks = refresh_union_masks(ffn_masks, aux[0], refresh)
    x = cm.apply_norm(params["final_norm"], x, cfg)
    return logits_fn(params, x, cfg), pages, new_masks, aux
