"""Registry adapter for the dense decoder family (batch-dict interface):
the registry's uniform interface (forward, the legacy contiguous-cache
prefill and decode) and the paged-serving entry points its declared
capabilities promise."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as T


init_params = T.init_params


def model_forward(params, batch, cfg: ModelConfig, *, stats=cm.NO_STATS,
                  remat_policy: str = "none"):
    return T.forward(params, batch["tokens"], cfg, stats=stats,
                     block=cm.wrap_block(remat_policy, T.apply_block))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    return T.init_cache(cfg, batch, max_len, device=device)


def model_prefill(params, batch, cfg: ModelConfig, max_len: int, stats=cm.NO_STATS):
    return T.prefill(params, batch["tokens"], cfg, max_len, stats=stats)


def model_decode(params, cache, token, pos, cfg: ModelConfig, stats=cm.NO_STATS,
                 ffn_masks=None):
    return T.decode_step(params, cache, token, pos, cfg, stats=stats,
                         ffn_masks=ffn_masks)


# -- continuous-batching (paged-cache) serving interface --------------------

def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     device="cuda"):
    return cm.init_paged_cache(cfg, n_blocks, block_size, device=device)


def model_prefill_paged(params, batch, cfg: ModelConfig, pages, blocks,
                        block_size: int, true_len=None):
    return T.prefill_paged(params, batch["tokens"], cfg, pages, blocks,
                           block_size=block_size, true_len=true_len)


def model_prefill_chunk_paged(params, batch, cfg: ModelConfig, pages, table,
                              pos0, clen, ffn_masks, refresh,
                              block_size: int, fast_kernels=None):
    return T.prefill_chunk_paged(params, pages, table, batch["tokens"], pos0,
                                 clen, cfg, ffn_masks, refresh,
                                 block_size=block_size,
                                 fast_kernels=fast_kernels)


def model_decode_paged(params, pages, table, token, pos, cfg: ModelConfig,
                       ffn_masks, refresh, block_size: int,
                       fast_kernels=None):
    return T.decode_step_paged(params, pages, table, token, pos, cfg,
                               ffn_masks, refresh, block_size=block_size,
                               fast_kernels=fast_kernels)


def model_decode_paged_predicted(params, pages, table, token, pos,
                                 cfg: ModelConfig, ffn_masks, refresh,
                                 pred_params, kind: str, tile: int,
                                 k_tiles: int, block_size: int,
                                 measure: bool = True, fast_kernels=None):
    return T.decode_step_paged_predicted(params, pages, table, token, pos,
                                         cfg, ffn_masks, refresh, pred_params,
                                         kind=kind, tile=tile,
                                         k_tiles=k_tiles,
                                         block_size=block_size,
                                         measure=measure,
                                         fast_kernels=fast_kernels)


def model_verify_window_paged(params, pages, table, tokens, pos0, wlen,
                              cfg: ModelConfig, ffn_masks, refresh,
                              block_size: int, fast_kernels=None):
    return T.verify_window_paged(params, pages, table, tokens, pos0, wlen,
                                 cfg, ffn_masks, refresh,
                                 block_size=block_size,
                                 fast_kernels=fast_kernels)


def model_draft_gamma_paged(params, pages, table, token, pos0, wlen,
                            cfg: ModelConfig, gamma: int, block_size: int,
                            next_fn=None, fast_kernels=None):
    return T.draft_gamma_paged(params, pages, table, token, pos0, wlen, cfg,
                               gamma=gamma, block_size=block_size,
                               next_fn=next_fn, fast_kernels=fast_kernels)
