"""Dense decoder-only transformer family, in PyTorch — the serving and
forward paths of the reference's ``models/transformer.py``: the full
forward with its per-layer statistics, the contiguous-cache prefill and
decode of the legacy ``ServeEngine``, and the paged continuous-batching
steps.

Parameters are a dict tree with the reference's names and layouts
(``wq (d, hp, hd)``, ``wo (hp, hd, d)``, ``wu (d, F)``, ``wd (F, d)``),
per-layer leaves stacked on a leading axis. Serving params are stored
once in the compute dtype on the device; training keeps f32 masters
(``init_params(..., dtype=torch.float32)``), which ``forward`` casts to
the compute dtype at its entry (``common.cast_params``), as the reference
casts its masters at every call. The values the model computes with are
the same.

Plain products (QKV, ``wo``, the dense up-projection, the logits) are
``torch.matmul``. Static tile capacities (``cfg.sparsity.enabled`` with
``input_tile_density`` / ``ffn_tile_density`` below 1) lower the decode
steps' QKV, up- and down-projections through
``common.maybe_sparse_matmul``, whose tile gather is kernel 5
(``sparse_matmul``) on CUDA tensors; the full forward (and so
whole-prompt prefill) stays dense, as in the reference. On CUDA tensors
the paged serving steps run the hand-written CUDA kernels the reference
runs as Pallas kernels (``kernel_path`` says when):
``paged_window_attention`` (decode and window attention),
``fused_sparse_ffn`` (W = 1 decode FFN over the γ-window tile list, and
the predictor FFN) and ``sparse_matmul_tokens`` (window-union
down-projection of chunked prefill); the last two only at densities 1, as
the reference gates them. The predictor FFN's unfused lowering
(``_ffn_decode_predicted(fused=False)``) runs ``sparse_up_matmul`` and
``sparse_matmul_tokens`` instead of the fused kernel. The contiguous
cache's attention is plain torch ops, as the reference's is XLA.

Under a serving mesh (``sharding.comm.serving``; the engine's ``mesh=``)
the paged steps and the whole-prompt forward run on one rank's blocks
(``common.ShardLayout``): its q slots and kv heads (``_qkv``,
``_attn_out``), its d_ff slice with tile lists in its own tile ids
(``_down_proj``, ``_ffn_out``, ``_pack_predicted``) and its vocabulary
rows (``embed_tokens``, ``logits_from``), with an all-reduce where the
split products meet — the same kernels at the rank's shapes. The legacy
contiguous-cache prefill and decode run under a mesh too, their cache
split over the model axis by sequence (``apply_attn_decode``), and the
full forward takes Megatron-SP residuals (``forward``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import activations as acts
from repro_torch.kernels import fused_decode as kfd
from repro_torch.kernels import sparse_matmul as ksm
from repro_torch.kernels.fused_ffn import tile_activity, window_tile_activity
from repro_torch.models import common as cm
from repro_torch.models import serving_protocol as sp
from repro_torch.predictor import predictors as preds
from repro_torch.sharding import comm

Params = Dict


def attn_geometry(cfg: ModelConfig) -> cm.HeadGeometry:
    return cm.HeadGeometry(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def densities(cfg: ModelConfig):
    """(input, ffn) static tile capacities of the decode steps: the
    configured ones when ``cfg.sparsity.enabled``, else (1.0, 1.0)."""
    s = cfg.sparsity
    return ((s.input_tile_density, s.ffn_tile_density) if s.enabled
            else (1.0, 1.0))


# ---------------------------------------------------------------------------
# init


def init_attn(cfg: ModelConfig, ini: cm.ParamInit,
              n: Optional[int] = None) -> Params:
    """An attention sublayer's params (``wq (d, hp, hd)``, ``wk``/``wv
    (d, kvp, hd)``, ``wo (hp, hd, d)``, biases, qk-norm scales), the real
    heads scattered into the padded layout with zero padded slots (MHA
    padding zeroes the padded K/V heads too); each leaf stacked over n
    layers (``ParamInit.stack``)."""
    g = attn_geometry(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    lead = () if n is None else (n,)

    def kv_proj():
        if g.kvp == g.n_kv:
            return ini.dense((d, g.kvp, hd), d)
        w = ini.full((d, g.kvp, hd), 0.0)
        w[:, :g.n_kv] = ini.dense((d, g.n_kv, hd), d)
        return w

    attn = {
        "wq": ini.stack(n, lambda: g.scatter_q(
            ini.dense((d, cfg.n_heads, hd), d), 1)),
        "wk": ini.stack(n, kv_proj),
        "wv": ini.stack(n, kv_proj),
        "wo": ini.stack(n, lambda: g.scatter_q(
            ini.dense((cfg.n_heads, hd, d), cfg.n_heads * hd), 0)),
    }
    if cfg.qkv_bias:
        attn["bq"] = ini.full(lead + (g.hp, hd), 0.0)
        attn["bk"] = ini.full(lead + (g.kvp, hd), 0.0)
        attn["bv"] = ini.full(lead + (g.kvp, hd), 0.0)
    if cfg.qk_norm:
        attn["q_norm"] = ini.full(lead + (hd,), 1.0)
        attn["k_norm"] = ini.full(lead + (hd,), 1.0)
    return attn


def init_ffn(cfg: ModelConfig, ini: cm.ParamInit, n: Optional[int] = None,
             d_ff: Optional[int] = None) -> Params:
    """The dense FFN's ``wu (d, F)``, ``wd (F, d)`` (and ``wg`` for a
    GLU), F = d_ff or cfg.d_ff, each stacked over n layers."""
    d, F = cfg.d_model, d_ff or cfg.d_ff
    ffn = {"wu": ini.stack(n, lambda: ini.dense((d, F), d)),
           "wd": ini.stack(n, lambda: ini.dense((F, d), F))}
    if cfg.ffn_kind == "glu":
        ffn["wg"] = ini.stack(n, lambda: ini.dense((d, F), d))
    return ffn


def init_block(cfg: ModelConfig, ini: cm.ParamInit, n: Optional[int] = None,
               ffn: Optional[Callable] = None) -> Params:
    """A decoder block's params {ln1, attn, ln2, <ffn>}, each leaf stacked
    over n layers. ``ffn(cfg, ini, n)`` -> (name, tree) builds the FFN
    subtree, by default the dense FFN under ``"ffn"``."""
    attn = init_attn(cfg, ini, n)
    ffn_name, ffn_tree = (ffn(cfg, ini, n) if ffn is not None
                          else ("ffn", init_ffn(cfg, ini, n)))
    return {"ln1": ini.norm(cfg, n), "attn": attn, "ln2": ini.norm(cfg, n),
            ffn_name: ffn_tree}


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None,
                ffn: Optional[Callable] = None) -> Params:
    """Random parameters made on ``device`` from a seeded torch.Generator,
    with the reference's scaling (``dense_init`` 1/sqrt(fan_in),
    ``embed_init`` 0.02) and head padding. Layer leaves are filled one layer
    at a time so a full-width model never holds a second f32 copy.
    ``ffn`` builds the layers' FFN subtree (``init_block``)."""
    device = cm.resolve_device(device)
    ini = cm.ParamInit(seed, device, dtype or compute_dtype(cfg))
    vp = cm.padded_vocab(cfg.vocab_size)
    layers = init_block(cfg, ini, cfg.n_layers, ffn)
    p = {"embed": ini.embed((vp, cfg.d_model)), "layers": layers,
         "final_norm": ini.norm(cfg)}
    if not cfg.tie_embeddings:
        p["unembed"] = ini.embed((vp, cfg.d_model))
    if not cfg.use_rope:
        p["pos_embed"] = ini.embed((cfg.max_seq_len, cfg.d_model))
    return p


# ---------------------------------------------------------------------------
# blocks


def _qkv(p, x, cfg: ModelConfig, positions, *,
         stats: cm.StatsCollector = cm.NO_STATS, decode: bool = False,
         whole_kv: bool = False):
    """x (b, s, d) -> q (b, s, hp, hd), k/v (b, s, kvp, hd); RoPE applied.
    ``decode`` applies the static input tile capacity (``densities``): one
    selection of the input's top d_model tiles for the three products.

    Under a serving mesh (``common.ShardLayout``) q holds the rank's q
    slots and k/v its kv heads: column-split weights give them directly;
    where ``wk``/``wv`` are row-split over d_model (GQA with fewer kv heads
    than ranks) each rank's product over its rows is a partial sum, summed
    over the ranks in f32 before the replicated biases are added once;
    below the input capacity 1 it gathers its rows' part of q's tile list
    (``common.rank_tiles``, kernel 5 on the card).

    Under autograd x enters each product split over the ranks through
    ``comm.copy_to_model``, so its gradient sums the ranks' partials; where
    the rank's q slots read part of a K/V computed whole (kv heads not
    split), K/V pass ``copy_to_model`` before the slice, and so do the
    qk-norm scales applied to split heads: every weight replicated over
    the ranks gets the whole gradient on each.

    ``whole_kv`` (serving under a mesh, no autograd): k/v hold every kv
    head, the heads of column-split ``wk``/``wv`` put together over the
    ranks (``comm.all_gather_last``): what the legacy contiguous cache
    keeps."""
    g = attn_geometry(cfg)
    stats.add_sparsity("qkv_in", x)
    b, s, d = x.shape
    hd = g.head_dim
    dens = densities(cfg)[0] if decode else 1.0
    lay = cm.shard_layout(cfg)
    x2 = x.reshape(b * s, d)
    xs = x2 if lay is None else comm.copy_to_model(x2)
    if lay is None or lay.kv_split != "embed":
        # q split and K/V whole on every rank: only q's input is a copy
        mixed = lay is not None and lay.q_split and lay.kv_split == "none"
        ws = [p[n].reshape(d, -1) for n in ("wq", "wk", "wv")]
        if mixed and xs is not x2:
            q = cm.maybe_sparse_matmul(xs, ws[0], cfg, dens)
            k, v = cm.maybe_sparse_matmuls(x2, ws[1:], cfg, dens)
        else:  # one selection for the three products
            whole = lay is None or not lay.q_split or mixed
            q, k, v = cm.maybe_sparse_matmuls(x2 if whole else xs, ws, cfg,
                                              dens)
        q, k, v = (y.reshape(b, s, -1, hd) for y in (q, k, v))
    else:
        q = cm.maybe_sparse_matmul(xs if lay.q_split else x2,
                                   p["wq"].reshape(d, -1), cfg,
                                   dens).reshape(b, s, -1, hd)
        d0, dl = lay.d
        xl = xs[:, d0:d0 + dl]
        ws = [p[n].reshape(dl, -1) for n in ("wk", "wv")]
        if dens >= 1.0:
            parts = [cm.partial_matmul(xl, w) for w in ws]
        else:
            # q's selection over the whole input, this rank's rows of it
            sel = cm.rank_tiles(*cm.static_tiles(x2, cfg, dens), d0, dl,
                                cfg.sparsity.tile_size)
            parts = [cm.gathered_matmul(xl, w, *sel, out_dtype=torch.float32)
                     for w in ws]
        k, v = (cm.reduce_partial(y, x.dtype).reshape(b, s, -1, hd)
                for y in parts)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q_split = lay is not None and lay.q_split
        k_split = lay is not None and lay.kv_split == "heads"
        q = cm.rms_norm_headdim(
            comm.copy_to_model(p["q_norm"]) if q_split else p["q_norm"], q)
        k = cm.rms_norm_headdim(
            comm.copy_to_model(p["k_norm"]) if k_split else p["k_norm"], k)
    if cfg.use_rope:
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
    if lay is not None and whole_kv:
        if lay.kv_split == "heads":
            k, v = (comm.all_gather_last(y.reshape(b, s, -1)).reshape(
                b, s, -1, hd) for y in (k, v))
        return q, k, v
    if lay is not None and lay.kv_split != "heads":
        # every kv head is here; keep those the rank's q slots read
        if lay.q_split:
            k, v = comm.copy_to_model(k), comm.copy_to_model(v)
        kv0, nkv = lay.kv
        k, v = k[:, :, kv0:kv0 + nkv], v[:, :, kv0:kv0 + nkv]
    return q, k, v


def _attn_out(p, o, cfg: ModelConfig):
    """o (b, s, hp, hd) -> (b, s, d), padded head slots masked. Under a
    serving mesh o holds the rank's q slots and ``wo`` their rows: the
    ranks' products are summed in f32, then cast once."""
    g = cm.local_heads(cfg)
    b, s = o.shape[:2]
    o = o * g.q_slot_mask(o.device, o.dtype)[None, None, :, None]
    o2 = o.reshape(b, s, g.hp * g.head_dim)
    w = p["wo"].reshape(g.hp * g.head_dim, -1)
    lay = cm.shard_layout(cfg)
    if lay is None or not lay.q_split:
        return cm.sublayer_whole(o2 @ w)
    return cm.sublayer_sum(cm.partial_matmul(o2, w), o.dtype)


def _down_proj(h, wd, cfg: ModelConfig, density: float):
    """The FFN's down-projection h (t, F) @ wd at the static capacity
    ``density`` (``common.maybe_sparse_matmul``). Where a serving mesh
    splits d_ff, h and wd hold the rank's units and the ranks' f32
    partials (``common.rows_partial``: below density 1 one device's
    selection, kernel 5 on the card) are summed, then cast once."""
    lay = cm.shard_layout(cfg)
    if lay is None or not lay.ffn_split:
        return cm.sublayer_whole(cm.maybe_sparse_matmul(h, wd, cfg, density))
    return cm.sublayer_sum(cm.rows_partial(h, wd, cfg, density, lay.ffn[0],
                                           cfg.d_ff, lay.tp), h.dtype)


def _ffn_out(y32, x, cfg: ModelConfig):
    """A kernel's f32 FFN output (t, d) in x's dtype: summed over the ranks
    first where a serving mesh splits d_ff."""
    lay = cm.shard_layout(cfg)
    if lay is not None and lay.ffn_split:
        return cm.reduce_partial(y32, x.dtype)
    return y32.to(x.dtype)


def post_norm(x, cfg: ModelConfig):
    """Relufication stage 2: ReLU after the normalization layer."""
    return torch.relu(x) if cfg.post_norm_relu else x


def _ffn_hidden(pf, x, cfg: ModelConfig, dens_in: float = 1.0,
                stats: cm.StatsCollector = cm.NO_STATS):
    """Hidden activation act(x @ Wg) [* (x @ Wu)], each product at the
    input tile capacity ``dens_in``; ``stats`` records the gate's
    pre-activation (``ffn_pre``)."""
    act_fn = acts.get(cfg.activation, shift=cfg.sparsity.shift)
    glu = cfg.ffn_kind == "glu"
    if glu:
        pre, up = cm.maybe_sparse_matmuls(x, [pf["wg"], pf["wu"]], cfg, dens_in)
    else:
        pre, = cm.maybe_sparse_matmuls(x, [pf["wu"]], cfg, dens_in)
    stats.add_preact("ffn_pre", pre)
    return act_fn(pre) * up if glu else act_fn(pre)


def apply_ffn(p, x, cfg: ModelConfig, *, stats: cm.StatsCollector = cm.NO_STATS,
              decode: bool = False, ffn_mask: Optional[torch.Tensor] = None):
    """x (tokens, d) -> (tokens, d). ``decode`` applies the static tile
    capacities (``densities``); ffn_mask (d_ff,) emulates γ-window weight
    reuse (only the window's loaded rows participate). An active ``stats``
    records ``up_in``, ``ffn_x`` (raw only), ``ffn_pre``, ``down_in`` and
    ``down_act`` (the (d_ff,) units active in any row)."""
    stats.add_sparsity("up_in", x)
    stats.add_raw("ffn_x", x)  # predictor-calibration capture
    dens_in, dens_ffn = densities(cfg) if decode else (1.0, 1.0)
    lay = cm.shard_layout(cfg)
    xin = comm.copy_to_model(x) if lay is not None and lay.ffn_split else x
    h = _ffn_hidden(p, xin, cfg, dens_in, stats)
    if ffn_mask is not None:
        h = h * ffn_mask.to(h.dtype)
    stats.add_sparsity("down_in", h)
    if stats.active:
        stats.add("down_act", (h != 0).any(0))
    return _down_proj(h, p["wd"], cfg, dens_ffn)


def apply_attn_full(p, x, cfg: ModelConfig, positions, *,
                    stats: cm.StatsCollector = cm.NO_STATS,
                    causal: bool = True):
    """Full-sequence attention (prefill / forward), causal unless asked
    (the encoder's is bidirectional). Returns (out (b, s, d), (k, v)
    (b, s, kvp, hd) for the cache). GQA K/V are replicated to 16 heads as
    the reference does (not under a serving mesh, where each rank groups
    its q slots by the kv heads it holds). Under ``common.cache_rows`` and
    a mesh the returned K/V are the rank's cache rows of every kv head."""
    g = cm.local_heads(cfg)
    b, s = x.shape[:2]
    rows = cm.cache_rows_active()
    lay = cm.shard_layout(cfg)
    if rows is None or lay is None:
        q, k, v = _qkv(p, x, cfg, positions, stats=stats)
        kv = (k, v)
    else:  # the cache's rows of every kv head; the attention reads its own
        q, k, v = _qkv(p, x, cfg, positions, stats=stats, whole_kv=True)
        kv = (cm.take_rows(k, rows), cm.take_rows(v, rows))
        kv0, nkv = lay.kv
        k, v = k[:, :, kv0:kv0 + nkv], v[:, :, kv0:kv0 + nkv]
    r = (1 if g.kvp % cm.TP == 0 or cm.shard_layout(cfg) is not None
         else cm.TP // g.kvp)
    if r > 1:
        k = k.repeat_interleave(r, dim=2)
        v = v.repeat_interleave(r, dim=2)
    kv_eff = g.kvp * r
    qg = q.reshape(b, s, kv_eff, g.hp // kv_eff, g.head_dim)
    o = cm.flash_attention(qg, k, v, causal=causal, window=cfg.sliding_window)
    return _attn_out(p, o.reshape(b, s, g.hp, g.head_dim), cfg), kv


def attn_sublayer(p, x, cfg: ModelConfig, positions,
                  stats: cm.StatsCollector = cm.NO_STATS,
                  causal: bool = True):
    """The attention half of a block: norm, (stage-2 ReLU), attention.
    Returns (the residual update (b, s, d), (k, v)). Under Megatron-SP
    residuals x and the update are the rank's d_model chunks
    (``common.sublayer_in`` / ``sublayer_sum``)."""
    h = post_norm(cm.apply_norm(p["ln1"], cm.sublayer_in(x), cfg), cfg)
    return apply_attn_full(p["attn"], h, cfg, positions, stats=stats,
                           causal=causal)


def ffn_sublayer(p, x, cfg: ModelConfig,
                 stats: cm.StatsCollector = cm.NO_STATS):
    """The FFN half of a block: norm, (stage-2 ReLU), the dense FFN over
    the b * s tokens. Returns the residual update (b, s, d) (the rank's
    d_model chunks under Megatron-SP residuals, as ``attn_sublayer``)."""
    h = post_norm(cm.apply_norm(p["ln2"], cm.sublayer_in(x), cfg), cfg)
    b, s, d = h.shape
    return apply_ffn(p["ffn"], h.reshape(b * s, d), cfg,
                     stats=stats).reshape(b, s, -1)


def apply_block(p, x, cfg: ModelConfig, positions,
                stats: cm.StatsCollector = cm.NO_STATS, sublayer=cm.call,
                causal: bool = True):
    """Full-sequence block: x + attention (causal unless asked), then +
    FFN. Returns (x, (k, v)). ``sublayer(fn, *args)`` runs each half
    (``common.wrap_block``'s "save_ars" policy checkpoints them apart)."""
    a, kv = sublayer(attn_sublayer, p, x, cfg, positions, stats, causal)
    x = x + a
    return x + sublayer(ffn_sublayer, p, x, cfg, stats), kv


def apply_attn_decode(p, x, cfg: ModelConfig, k_cache, v_cache, pos, *,
                      layer: int, stats: cm.StatsCollector = cm.NO_STATS):
    """One-token attention of ``layer`` against the contiguous head-major
    cache. x (b, d); pos (b,) write positions; k_cache / v_cache the
    stacked (L, b, kvp, S, hd) buffers. Every row's K/V is written IN PLACE
    at pos[0], as the reference's uniform-position ``dynamic_update_slice``
    writes it (a legacy batch shares its positions). A position past S - 1
    is an index error, where the reference clamps it silently
    (``ServeEngine.generate`` checks the bound on the host before it
    starts). The attention is plain
    torch ops, as the reference's ``decode_attention`` is XLA. Returns (out
    (b, d), k_cache, v_cache).

    Under a serving mesh the cache is sequence-sharded as
    ``rules.cache_pspec`` lays it out: every kv head, this rank's S / M
    positions s0 .. s0 + S / M - 1 (s0 = model index x S / M). The rank
    computes its q slots and every kv head (``_qkv(whole_kv=True)``: where
    ``wk``/``wv`` are split over d_model, the GQA case of fewer kv heads
    than ranks, the ranks' partial products summed), puts the q slots of
    every rank together (one all-gather), writes the new K/V where pos
    falls in its rows (a select, no host branch on the position), runs
    ``common.decode_attention`` over its rows (partials, one gather, the
    fold) and projects its own slots through its rows of ``wo``."""
    lay = cm.shard_layout(cfg)
    g = attn_geometry(cfg)
    b = x.shape[0]
    q, k, v = _qkv(p, x[:, None, :], cfg, pos[:, None], stats=stats,
                   decode=True, whole_kv=lay is not None)
    if lay is not None and lay.q_split:
        q = comm.all_gather_last(q.reshape(b, -1))
    q = q.reshape(b, g.kvp, g.group, g.head_dim)
    kl, vl = k_cache[layer], v_cache[layer]
    at = pos[:1].long()
    if lay is None:
        kl.index_copy_(2, at, k.transpose(1, 2).to(kl.dtype))  # (b, kvp, 1, hd)
        vl.index_copy_(2, at, v.transpose(1, 2).to(vl.dtype))
    else:
        rows = kl.shape[2]
        at = at - comm.active().coords["model"] * rows
        mine = (at >= 0) & (at < rows)
        at = at.clamp(0, rows - 1)
        for cache, new in ((kl, k), (vl, v)):
            cache.index_copy_(2, at, torch.where(
                mine, new.transpose(1, 2).to(cache.dtype),
                cache.index_select(2, at)))
    o = cm.decode_attention(q, kl, vl, pos, window=cfg.sliding_window)
    if lay is not None:
        q0, hq = lay.q
        o = o.reshape(b, g.hp, g.head_dim)[:, q0:q0 + hq]
    out = _attn_out(p, o.reshape(b, 1, -1, g.head_dim), cfg)[:, 0]
    return out, k_cache, v_cache


def apply_block_decode(p, x, cfg: ModelConfig, k_cache, v_cache, pos, *,
                       layer: int, stats: cm.StatsCollector = cm.NO_STATS,
                       ffn_mask=None):
    h = post_norm(cm.apply_norm(p["ln1"], x[:, None], cfg)[:, 0], cfg)
    a, k_cache, v_cache = apply_attn_decode(
        p["attn"], h, cfg, k_cache, v_cache, pos, stats=stats, layer=layer)
    x = x + a
    h = post_norm(cm.apply_norm(p["ln2"], x[:, None], cfg)[:, 0], cfg)
    f = apply_ffn(p["ffn"], h, cfg, stats=stats, decode=True,
                  ffn_mask=ffn_mask)
    return x + f, k_cache, v_cache


# ---------------------------------------------------------------------------
# whole model


def token_rows(emb, tokens, cfg: ModelConfig):
    """The embedding rows (..., d) of ``tokens``, in the embedding's dtype.
    Under a serving mesh the embedding holds the rank's vocabulary rows:
    each token's row comes from the rank that holds it, summed with the
    others' zeros (exact)."""
    lay = cm.shard_layout(cfg)
    if lay is None or not lay.vocab_split:
        return emb[tokens.long()]
    v0, vl = lay.vocab
    local = tokens.long() - v0
    mine = (local >= 0) & (local < vl)
    rows = torch.where(mine[..., None], emb[local.clamp(0, vl - 1)], 0.0)
    return comm.all_reduce_sum(rows).to(emb.dtype)


def embed_tokens(params, tokens, cfg: ModelConfig, positions):
    """Token (and learned position) embeddings in the compute dtype
    (``token_rows``)."""
    x = token_rows(params["embed"], tokens, cfg).to(compute_dtype(cfg))
    if not cfg.use_rope:
        x = x + params["pos_embed"][positions.long()].to(x.dtype)
    return x


def logits_from(params, x, cfg: ModelConfig):
    """Logits over the padded vocabulary, its padding masked. Under a
    serving mesh each rank computes its vocabulary shard's, and every rank
    gets them all (``comm.gather_last``), so the sampling head runs the
    same on every rank. Under the train mode (``comm.mode``) each rank
    keeps its shard's (b, s, vl) logits, rows ``ShardLayout.vocab``: the
    loss takes its log-sum-exp over the ranks (``train/fsdp.py``)."""
    u = params.get("unembed", params["embed"])
    lay = cm.shard_layout(cfg)
    if lay is None or not lay.vocab_split:
        out = x @ u.to(x.dtype).T
        mask = cm.vocab_logit_mask(cfg.vocab_size, u.shape[0], device=x.device)
        return out + mask.to(out.dtype)
    out = comm.copy_to_model(x) @ u.to(x.dtype).T
    v0, vl = lay.vocab
    vp = cm.padded_vocab(cfg.vocab_size)
    mask = cm.vocab_logit_mask(cfg.vocab_size, vp, device=x.device,
                               offset=v0, width=vl)
    if comm.mode() == "train":
        return out + mask.to(out.dtype)
    return comm.gather_last(out + mask.to(out.dtype), vp, v0)


def forward(params, tokens, cfg: ModelConfig, *, return_kv: bool = False,
            last_index: Optional[int] = None,
            stats: cm.StatsCollector = cm.NO_STATS,
            block: Optional[Callable] = None,
            extra_embeds: Optional[torch.Tensor] = None):
    """Full-sequence forward, dense at any tile capacity (as the
    reference's). tokens (b, s) -> logits (b, s, vocab_p). extra_embeds
    (b, n, d): modality-frontend stubs (vision patches) prepended to the
    token embeddings, positions running over the whole n + s sequence
    (the logits and K/V then cover it too). With
    ``return_kv``: (logits (b, 1, vocab_p) at ``last_index`` (default
    s - 1), (k, v) each (L, b, s, kvp, hd)). An active ``stats`` collects
    each layer's sites under ``layer{i}/`` (with ``raw=True`` also the FFN
    input, ``layer{i}/ffn_x`` (b * s, d)). ``block(p, x, cfg, positions,
    stats)`` -> (x, (k, v)) is the layer function (the reference's
    ``remat_block``), by default the dense ``apply_block``.

    f32 master params (training) are cast to the compute dtype first
    (``common.cast_params``; serving params pass through), and the stacked
    layer leaves are split once (``common.unstack_layers``), so a backward
    through the forward stacks each leaf's gradient once. A
    ``common.LayerSource`` in ``params["layers"]`` makes each layer's tree
    just before its block and releases it after (the FSDP step's per-layer
    gather).

    ``cfg.sp_residuals`` under a mesh whose model axis divides d_model
    (``common.sp_fits``): Megatron-SP residuals, the reference's residual
    constrained to "model" on d_model. The residual between blocks is
    this rank's d_model chunk (``comm.split_last`` after the embedding);
    each sublayer puts the whole residual together before its norm and
    hands back its chunk of the sum of the ranks' partials (one
    reduce-scatter where the unsplit step all-reduces,
    ``common.sublayer_sum``); the chunks are put together once more
    before the final norm. The function and its gradients are the
    unsplit step's; a remat block saves the chunk."""
    block = block or apply_block
    params = cm.cast_params(params, cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_tokens(params, tokens, cfg, positions)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        s = x.shape[1]
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    ks, vs = [], []
    layers = cm.unstack_layers(params["layers"], cfg.n_layers)
    sp = cm.sp_fits(cfg)
    with comm.sequence_parallel(sp):
        if sp:  # the residual between blocks: this rank's d_model chunk
            x = comm.split_last(x)
        for i in range(cfg.n_layers):
            sub = (cm.StatsCollector(True, raw=stats.raw) if stats.active
                   else stats)
            x, (k, v) = block(layers[i], x, cfg, positions, stats=sub)
            if isinstance(layers, cm.LayerSource):
                layers.release(i)
            if stats.active:
                for key, val in sub.stats.items():
                    stats.stats[f"layer{i}/{key}"] = val
            if return_kv:
                ks.append(k)
                vs.append(v)
        if sp:
            x = comm.all_gather_last(x, whole_grad=True)
    x = cm.apply_norm(params["final_norm"], x, cfg)
    if return_kv:
        li = s - 1 if last_index is None else int(last_index)
        return (logits_from(params, x[:, li:li + 1], cfg),
                (torch.stack(ks), torch.stack(vs)))
    return logits_from(params, x, cfg)


# ---------------------------------------------------------------------------
# legacy single-batch serving: contiguous head-major cache, uniform positions


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Zero cache {"k", "v"} each (L, batch, kvp, max_len, hd), head-major
    (the decode attention reads it untransposed). Under a mesh the rank's
    rows, as ``prefill`` makes them: max_len / M positions of every kv
    head."""
    device = cm.resolve_device(device)
    g = attn_geometry(cfg)
    dtype = dtype or compute_dtype(cfg)
    rows = cm.rank_cache_rows(max_len)
    shape = (cfg.n_layers, batch, g.kvp,
             max_len if rows is None else rows[1], g.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def finalize_prefill_cache(k, v, max_len: int):
    """The forward's (L, b, s, kvp, hd) K and V -> the head-major cache
    dict, zero-padded along the sequence to ``max_len``."""
    k = k.permute(0, 1, 3, 2, 4)  # -> (L, b, kvp, s, hd)
    v = v.permute(0, 1, 3, 2, 4)
    pad = max_len - k.shape[3]
    if pad > 0:
        zeros = k.new_zeros(k.shape[:3] + (pad,) + k.shape[4:])
        k = torch.cat([k, zeros], dim=3)
        v = torch.cat([v, zeros], dim=3)
    return {"k": k.contiguous(), "v": v.contiguous()}


def prefill(params, tokens, cfg: ModelConfig, max_len: int,
            stats: cm.StatsCollector = cm.NO_STATS,
            block: Optional[Callable] = None,
            extra_embeds: Optional[torch.Tensor] = None):
    """Run the whole prompt (dense; ``extra_embeds`` prepended as in
    ``forward``); returns (last-token logits (b, vocab_p), the cache at
    ``max_len``). Under a serving mesh the cache is this rank's rows of it
    (``apply_attn_decode``'s layout): max_len / M positions of every kv
    head."""
    rows = cm.rank_cache_rows(max_len)
    with cm.cache_rows(rows):
        logits, kv = forward(params, tokens, cfg, stats=stats,
                             return_kv=True, block=block,
                             extra_embeds=extra_embeds)
    return logits[:, -1], finalize_prefill_cache(
        *kv, max_len if rows is None else rows[1])


def decode_core(params, cache, token, pos, cfg: ModelConfig,
                layer_fn: Callable):
    """Embed -> the layers over the contiguous cache -> final norm and
    logits; ``layer_fn(p_i, i, x, k_cache, v_cache)`` -> (x, k_cache,
    v_cache) is the family's decode block. Returns (logits (b, vocab_p),
    cache)."""
    x = embed_tokens(params, token[:, None], cfg, pos[:, None])[:, 0]
    kc, vc = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        x, kc, vc = layer_fn(cm.layer_params(params, i), i, x, kc, vc)
    x = cm.apply_norm(params["final_norm"], x[:, None], cfg)[:, 0]
    return logits_from(params, x, cfg), {"k": kc, "v": vc}


def decode_step(params, cache, token, pos, cfg: ModelConfig,
                stats: cm.StatsCollector = cm.NO_STATS,
                ffn_masks: Optional[torch.Tensor] = None):
    """One legacy decode step. token (b,) int; pos (b,) write position
    (uniform: every row is written at pos[0]); the cache is updated in
    place. ffn_masks (L, d_ff): γ-window weight-reuse masks. An active
    ``stats`` collects each layer's sites under ``layer{i}/``. Returns
    (logits (b, vocab_p), cache)."""

    def layer_fn(p_i, i, x, kc, vc):
        sub = cm.StatsCollector(True) if stats.active else stats
        x, kc, vc = apply_block_decode(
            p_i, x, cfg, kc, vc, pos, stats=sub, layer=i,
            ffn_mask=None if ffn_masks is None else ffn_masks[i])
        if stats.active:
            for key, val in sub.stats.items():
                stats.stats[f"layer{i}/{key}"] = val
        return x, kc, vc

    return decode_core(params, cache, token, pos, cfg, layer_fn)


def prefill_paged(params, tokens, cfg: ModelConfig, pages, blocks, *,
                  block_size: int, true_len: Optional[int] = None,
                  block: Optional[Callable] = None):
    """Prefill one request's prompt into its pool blocks (in place).
    tokens (1, s), zero-padded past ``true_len``; blocks (nb,) with
    nb * block_size >= s; ``block`` the layer function (``forward``).
    Returns (last-token logits (1, vocab_p), pages)."""
    li = None if true_len is None else int(true_len) - 1
    logits, (k, v) = forward(params, tokens, cfg, return_kv=True,
                             last_index=li, block=block)
    cm.paged_write_prefill(pages["k"], k[:, 0], blocks, block_size)
    cm.paged_write_prefill(pages["v"], v[:, 0], blocks, block_size)
    return logits[:, -1], pages


# ---------------------------------------------------------------------------
# continuous-batching serving: paged cache + per-request γ-window masks


def kernel_path(fast_kernels: Optional[bool], x: torch.Tensor) -> bool:
    """Whether a serving step takes the kernel path. On CUDA tensors it
    always does, and ``fast_kernels=False`` raises: the plain versions never
    run on the card. On the CPU it does only for ``fast_kernels=True`` (the
    kernel path's tile lists with each wrapper's plain version)."""
    if x.is_cuda:
        if fast_kernels is False:
            raise ValueError("fast_kernels=False on CUDA tensors: on the card "
                             "the serving steps run the hand-written kernels")
        return True
    return bool(fast_kernels)


def apply_attn_window_paged(p, x, cfg: ModelConfig, k_pages, v_pages, table,
                            pos, valid, *, layer: int, block_size: int,
                            fast_kernels: Optional[bool] = None):
    """W-token windowed attention against the paged pool. x (b, W, d); pos
    (b, W) write positions; valid (b, W) — K/V of invalid tokens goes to
    the scratch block; table (b, nb). Causal within the window. K/V are
    written into the pool in place. Returns out (b, W, d)."""
    fast_kernels = kernel_path(fast_kernels, x)
    g = cm.local_heads(cfg)
    b, W, _ = x.shape
    q, k, v = _qkv(p, x, cfg, pos, decode=True)
    q = q.reshape(b, W, g.kvp, g.group, g.head_dim).contiguous()
    o = cm.paged_attend(q, k, v, k_pages, v_pages, layer, table, pos, valid,
                        block_size, cfg.sliding_window, fast_kernels)
    return _attn_out(p, o.reshape(b, W, g.hp, g.head_dim), cfg)


def apply_ffn_window(p, x, cfg: ModelConfig, *, mask, refresh, valid,
                     fast_kernels: Optional[bool] = None):
    """Decode FFN over a W-token window with per-request γ-window weight
    reuse. x (b, W, d); mask (b, F) bool; refresh (b,) bool; valid (b, W).
    Returns (out (b, W, d), act (b, F) window-union activity, scores
    (b, F // tile), density (b,), union_density (b,)).

    The kernel path (``kernel_path``) runs the down-projection through
    ``sparse_matmul_tokens`` over each slot's window-union tile list when
    both tile capacities are 1; below 1 the products take
    ``maybe_sparse_matmul``, as in the reference."""
    fast_kernels = kernel_path(fast_kernels, x)
    b, W, d = x.shape
    dens_in, dens_ffn = densities(cfg)
    h = _ffn_hidden(p, x.reshape(b * W, d), cfg, dens_in).reshape(b, W, -1)
    eff = mask | refresh[:, None]
    h = h * eff[:, None, :].to(h.dtype)
    hv = h * valid[:, :, None].to(h.dtype)
    act = (hv != 0).any(1)
    tile = cm.ffn_gather_tile(cfg)
    scores = window_tile_activity(hv, tile)
    density = eff.float().mean(-1)
    union_density = act.float().mean(-1)
    if fast_kernels and dens_in >= 1.0 and dens_ffn >= 1.0:
        n_tiles = h.shape[-1] // tile
        idx, nvalid = preds.pack_tile_indices(scores > 0, n_tiles)
        out = _ffn_out(ksm.sparse_matmul_tokens(
            h.reshape(b * W, -1).to(p["wd"].dtype), p["wd"],
            idx.repeat_interleave(W, 0), nvalid.repeat_interleave(W),
            tile=tile), x, cfg)
    else:
        out = _down_proj(h.reshape(b * W, -1), p["wd"], cfg, dens_ffn)
    return out.reshape(b, W, d), act, scores, density, union_density


def apply_block_window_paged(p, x, cfg: ModelConfig, k_pages, v_pages, table,
                             pos, valid, *, layer: int, block_size: int, mask,
                             refresh, fast_kernels: Optional[bool] = None):
    h = post_norm(cm.apply_norm(p["ln1"], x, cfg), cfg)
    x = x + apply_attn_window_paged(
        p["attn"], h, cfg, k_pages, v_pages, table, pos, valid, layer=layer,
        block_size=block_size, fast_kernels=fast_kernels)
    h = post_norm(cm.apply_norm(p["ln2"], x, cfg), cfg)
    f, act, scores, density, udens = apply_ffn_window(
        p["ffn"], h, cfg, mask=mask, refresh=refresh, valid=valid,
        fast_kernels=fast_kernels)
    return x + f, k_pages, v_pages, act, scores, density, udens


def verify_window_paged(params, pages, table, tokens, pos0, wlen,
                        cfg: ModelConfig, ffn_masks, refresh, *,
                        block_size: int, fast_kernels: Optional[bool] = None):
    """A W-token window per slot in one forward over the shared pool.
    tokens (b, W); pos0 (b,) write position of tokens[:, 0]; wlen (b,)
    valid window length (tokens past it write the scratch block);
    ffn_masks (L, b, F) bool; refresh (b,). Returns (logits (b, W,
    vocab_p), pages, new_masks (L, b, F), aux) with aux = (act, scores,
    density, union_density) stacked over layers."""

    def layer_fn(pl_i, li, x, kp, vp, fm, pos, valid):
        x, kp, vp, act, scores, density, udens = apply_block_window_paged(
            pl_i, x, cfg, kp, vp, table, pos, valid, layer=li,
            block_size=block_size, mask=fm, refresh=refresh,
            fast_kernels=fast_kernels)
        return x, kp, vp, (act, scores, density, udens)

    return sp.window_step_core(params, pages, tokens, pos0, wlen, cfg,
                               ffn_masks, refresh, layer_fn=layer_fn,
                               embed_fn=embed_tokens, logits_fn=logits_from)


def prefill_chunk_paged(params, pages, table, tokens, pos0, clen,
                        cfg: ModelConfig, ffn_masks, refresh, *,
                        block_size: int, fast_kernels: Optional[bool] = None):
    """One fixed-shape chunk of paged prefill, batched over slots: a
    W-token window step (``verify_window_paged``) whose tokens past clen
    are scratch-routed. On a request's final chunk, logits[i, clen_i - 1]
    seed its first generated token."""
    return verify_window_paged(params, pages, table, tokens, pos0, clen,
                               cfg, ffn_masks, refresh, block_size=block_size,
                               fast_kernels=fast_kernels)


def draft_gamma_paged(params, pages, table, token, pos0, wlen,
                      cfg: ModelConfig, *, gamma: int, block_size: int,
                      next_fn=None, fast_kernels: Optional[bool] = None):
    """Draft γ tokens per slot over the paged pool — the proposer half of
    speculative decoding, batched across slots, with no host sync inside
    the loop (the reference's ``lax.scan`` as a Python loop).

    token (b,) each slot's current (verified) token; pos0 (b,) its write
    position; wlen (b,) the slot's verification window length W_s — draft
    step g writes position pos0+g only while g < W_s (out-of-window and
    idle-slot writes go to the scratch block). The loop runs γ+1 steps so
    the final proposal's own K/V is already in the draft cache when every
    draft is accepted; the extra step's logits are discarded. Each step is
    ``verify_window_paged`` at W = 1 with zero masks and refresh on (the
    kernel path: ``paged_window_attention`` and ``sparse_matmul_tokens``).

    next_fn(logits (b, vocab_p), g) -> (b,) int32 selects each step's
    proposal (the engine's sampling head on the shared key schedule);
    None takes the greedy argmax.

    Returns (proposals (b, γ) int32, pages)."""
    b = token.shape[0]
    masks = torch.zeros((cfg.n_layers, b, cm.local_d_ff(cfg)),
                        dtype=torch.bool, device=token.device)
    refresh = torch.ones((b,), dtype=torch.bool, device=token.device)
    tok, props = token, []
    for g in range(gamma + 1):
        wl = (g < wlen).to(wlen.dtype)  # 0/1: write-enable as W_s
        logits, pages, _, _ = verify_window_paged(
            params, pages, table, tok[:, None], pos0 + g, wl, cfg, masks,
            refresh, block_size=block_size, fast_kernels=fast_kernels)
        if next_fn is None:
            tok = torch.argmax(logits[:, 0, : cfg.vocab_size].float(),
                               -1).to(torch.int32)
        else:
            tok = next_fn(logits[:, 0], g)
        props.append(tok)
    return torch.stack(props[:gamma], 1), pages


def _pack_predicted(eff_units, cfg: ModelConfig, tile: int, k_tiles: int):
    """The predicted units' tile lists of the predictor FFN: (idx, nvalid,
    cov_units (B, F) the units the lists gather, the lists' tile width,
    density (B,) the fraction of weight tiles read).

    Under a serving mesh that splits d_ff, eff_units holds the rank's
    units. When the predictor's tiles divide over the ranks the packing is
    model-axis-local: each rank packs its own ceil(k_tiles / TP) from its
    slice (the reference's ``pack_tile_indices(n_groups=TP)``; at full
    capacity the same tiles as one device). When they do not, the units
    are gathered, packed globally as on one device, and each rank lists
    the covered part of its slice at the tile width gcd(tile, its units),
    which no global tile straddles."""
    lay = cm.shard_layout(cfg)
    F = eff_units.shape[-1]
    if lay is not None and lay.ffn_split and (cfg.d_ff // tile) % lay.tp:
        f0, fl = lay.ffn
        full = comm.gather_last(eff_units.to(torch.uint8), cfg.d_ff, f0) > 0
        nt = cfg.d_ff // tile
        gidx, gnv = preds.pack_tile_indices(preds.units_to_tiles(full, tile),
                                            k_tiles)
        cov = preds.tiles_to_units(preds.covered_tiles(gidx, gnv, nt),
                                   tile)[:, f0:f0 + fl]
        tile = math.gcd(tile, fl)
        idx, nvalid = preds.pack_tile_indices(preds.units_to_tiles(cov, tile),
                                              fl // tile)
        # this rank's share of the gathered units; their mean over the
        # ranks is the global tile fraction gnv / nt
        return idx, nvalid, cov, tile, cov.float().mean(-1)
    n_tiles = F // tile
    k = k_tiles
    if lay is not None and lay.ffn_split:
        k = min(n_tiles, -(-min(k_tiles, cfg.d_ff // tile) // lay.tp))
    idx, nvalid = preds.pack_tile_indices(
        preds.units_to_tiles(eff_units, tile), k)
    cov = preds.tiles_to_units(preds.covered_tiles(idx, nvalid, n_tiles), tile)
    return idx, nvalid, cov, tile, nvalid.float() / n_tiles


def _ffn_decode_predicted(pf, h, cfg: ModelConfig, pred_l, *, kind: str,
                          tile: int, k_tiles: int, mask, refresh,
                          measure: bool = True, fused: bool):
    """Predictor-gathered decode FFN (predictor serving mode): the activity
    predictor names each token's active tiles BEFORE any FFN weight is read,
    and the up- and down-projections run as tile-gathered products over
    exactly those tiles.

    h (B, d) post-norm FFN input; pred_l this layer's predictor params;
    mask (B, F) / refresh (B,) the γ-window machinery: between refreshes the
    window's units are composed INTO the predicted set.

    ``fused`` picks the lowering (the reference picks it with
    ``fast_kernels``): True runs ``fused_sparse_ffn`` over the lists; False
    the unfused pair, ``sparse_up_matmul`` then the activation times the
    covered mask, then ``sparse_matmul_tokens``. In f32 the two give the
    same result bit for bit (same per-tile dots, same accumulation order).
    With bf16 weights both lowerings run the tensor-core routines
    (``csrc/up_tiles.cuh``, ``csrc/tile_group.cuh``) and agree within the
    bf16 tolerance; on an H100 (``chip_smoke.py``, PERF.md section 6) h
    came out bit-equal and y within 1.7e-6 of 4.3 at the kernel level, and
    f within 2.4e-4 (one bf16 ulp) served on OPT-6.7B layer 0. On CUDA
    tensors both launch the CUDA kernels.

    With ``measure`` a recall miss is counted: a dense gate pre-activation
    (telemetry only, never fed to the residual stream) re-reads the gate
    weight each step; measure=False returns zero counts.

    Under a serving mesh that splits d_ff, everything here is the rank's
    units (``_pack_predicted``): the counts, the density and f are its
    shares, which the engine sums (f here, the rest once a step).

    Returns (f (B, d), act (B, F), scores (B, F // gather tile),
             density (B,) fraction of weight tiles read (up AND down),
             n_active (B,) int32, n_miss (B,) int32)."""
    act_fn = acts.get(cfg.activation, shift=cfg.sparsity.shift)
    glu = cfg.ffn_kind == "glu"
    h = h.contiguous()
    unit_pred = preds.predict_units(kind, pred_l, h)  # (B, F)
    eff_units = unit_pred | (mask & ~refresh[:, None])
    idx, nvalid, cov_units, tile, density = _pack_predicted(
        eff_units, cfg, tile, k_tiles)
    n_tiles = eff_units.shape[-1] // tile
    gate_w = pf["wg"] if glu else pf["wu"]
    if fused:
        # cov_units is all ones inside every gathered tile, so the kernel
        # needs no unit mask; non-gathered tiles are exact zeros by omission
        f32, compact = kfd.fused_sparse_ffn(
            h, gate_w, pf["wd"], idx, nvalid, w_up=pf["wu"] if glu else None,
            activation=cfg.activation, shift=cfg.sparsity.shift, tile=tile)
        hh = kfd.scatter_compact(compact, idx, nvalid, n_tiles)
    else:
        pre = ksm.sparse_up_matmul(h, gate_w, idx, nvalid, tile=tile)
        # the covered mask keeps skipped tiles exactly zero even where
        # f(0) != 0 (a negative shifted-ReLU shift)
        hh = act_fn(pre) * cov_units.to(pre.dtype)
        if glu:
            hh = hh * ksm.sparse_up_matmul(h, pf["wu"], idx, nvalid, tile=tile)
        f32 = ksm.sparse_matmul_tokens(hh.to(pf["wd"].dtype), pf["wd"], idx,
                                       nvalid, tile=tile)
    f = _ffn_out(f32, h, cfg)
    act = hh != 0
    scores = tile_activity(hh, cm.ffn_gather_tile(cfg))
    if measure:
        thr = acts.firing_threshold(cfg.activation, cfg.sparsity.shift)
        true_act = (h @ gate_w).float() > thr  # telemetry only
        n_active = true_act.sum(-1, dtype=torch.int32)
        n_miss = (true_act & ~cov_units).sum(-1, dtype=torch.int32)
    else:
        n_active = torch.zeros(h.shape[0], dtype=torch.int32, device=h.device)
        n_miss = torch.zeros_like(n_active)
    return f, act, scores, density, n_active, n_miss


def apply_block_decode_paged(p, x, cfg: ModelConfig, k_pages, v_pages, table,
                             pos, *, layer: int, block_size: int, mask,
                             refresh, pred=None, pred_kind: Optional[str] = None,
                             pred_tile: int = 128, k_tiles: int = 0,
                             pred_measure: bool = True,
                             fast_kernels: Optional[bool] = None):
    """Single-token decode block over the paged pool (kept apart from the
    window block as the reference keeps it). On the kernel path
    (``kernel_path``) and at tile capacities 1 the FFN runs through
    ``fused_sparse_ffn`` over the γ-window mask's tile list, with the mask
    applied per unit inside the kernel; below 1 its products take
    ``maybe_sparse_matmul``, as in the reference.

    ``pred`` (a per-layer predictor-param slice; None = off) switches the
    FFN to the predictor-gathered path (``_ffn_decode_predicted``, fused on
    the kernel path), which appends (n_active, n_miss) recall telemetry to
    the return tuple."""
    fast_kernels = kernel_path(fast_kernels, x)
    g = cm.local_heads(cfg)
    h = post_norm(cm.apply_norm(p["ln1"], x[:, None], cfg)[:, 0], cfg)
    q, k, v = _qkv(p["attn"], h[:, None, :], cfg, pos[:, None], decode=True)
    q = q.reshape(q.shape[0], 1, g.kvp, g.group, g.head_dim).contiguous()
    o = cm.paged_attend(q, k, v, k_pages, v_pages, layer, table, pos[:, None],
                        None, block_size, cfg.sliding_window, fast_kernels)
    x = x + _attn_out(p["attn"], o.reshape(o.shape[0], 1, g.hp, g.head_dim),
                      cfg)[:, 0]

    h = post_norm(cm.apply_norm(p["ln2"], x[:, None], cfg)[:, 0], cfg)
    if pred is not None:
        f, act, scores, density, n_active, n_miss = _ffn_decode_predicted(
            p["ffn"], h, cfg, pred, kind=pred_kind, tile=pred_tile,
            k_tiles=k_tiles, mask=mask, refresh=refresh, measure=pred_measure,
            fused=fast_kernels)
        return x + f, k_pages, v_pages, act, scores, density, n_active, n_miss
    pf = p["ffn"]
    eff = mask | refresh[:, None]
    tile = cm.ffn_gather_tile(cfg)
    dens_in, dens_ffn = densities(cfg)
    if fast_kernels and dens_in >= 1.0 and dens_ffn >= 1.0:
        n_tiles = eff.shape[-1] // tile
        idx, nvalid = preds.pack_tile_indices(preds.units_to_tiles(eff, tile),
                                              n_tiles)
        glu = cfg.ffn_kind == "glu"
        f32, compact = kfd.fused_sparse_ffn(
            h.contiguous(), pf["wg"] if glu else pf["wu"], pf["wd"], idx,
            nvalid, w_up=pf["wu"] if glu else None, unit_mask=eff,
            activation=cfg.activation, shift=cfg.sparsity.shift, tile=tile)
        hh = kfd.scatter_compact(compact, idx, nvalid, n_tiles)
        f = _ffn_out(f32, h, cfg)
    else:
        hh = _ffn_hidden(pf, h, cfg, dens_in) * eff.to(h.dtype)
        f = _down_proj(hh, pf["wd"], cfg, dens_ffn)
    act = hh != 0
    scores = tile_activity(hh, tile)
    density = eff.float().mean(-1)
    return x + f, k_pages, v_pages, act, scores, density


def decode_step_paged(params, pages, table, token, pos, cfg: ModelConfig,
                      ffn_masks, refresh, *, block_size: int,
                      fast_kernels: Optional[bool] = None):
    """One continuous-batching decode step over the shared pool.
    token/pos/refresh (b,); table (b, nb); ffn_masks (L, b, F) bool.
    Returns (logits (b, vocab_p), pages, new_masks (L, b, F), aux) with
    aux = (act (L, b, F), scores (L, b, F // tile), density (L, b))."""

    def layer_fn(pl_i, li, x, kp, vp, fm):
        x, kp, vp, act, scores, density = apply_block_decode_paged(
            pl_i, x, cfg, kp, vp, table, pos, layer=li, block_size=block_size,
            mask=fm, refresh=refresh, fast_kernels=fast_kernels)
        return x, kp, vp, (act, scores, density)

    return sp.decode_step_core(params, pages, token, pos, cfg, ffn_masks,
                               refresh, layer_fn=layer_fn,
                               embed_fn=embed_tokens, logits_fn=logits_from)


def decode_step_paged_predicted(params, pages, table, token, pos,
                                cfg: ModelConfig, ffn_masks, refresh,
                                pred_params, *, kind: str, tile: int,
                                k_tiles: int, block_size: int,
                                measure: bool = True,
                                fast_kernels: Optional[bool] = None):
    """Predictor-mode continuous-batching decode step: ``decode_step_paged``
    with every layer's FFN tile-gathered over the predictor's per-token
    mask (``_ffn_decode_predicted``). pred_params is the stacked (leading
    layer axis) predictor dict; measure=False drops the recall probe.

    Returns (logits (b, vocab_p), pages, new_masks (L, b, F), aux) with
    aux = (act (L, b, F), scores (L, b, F // tile'), density (L, b) fraction
    of FFN weight tiles read, n_active (L, b), n_miss (L, b) recall
    telemetry; zeros when measure=False)."""

    def layer_fn(pl_i, li, x, kp, vp, fm, pred_l):
        x, kp, vp, act, scores, density, n_act, n_miss = \
            apply_block_decode_paged(
                pl_i, x, cfg, kp, vp, table, pos, layer=li,
                block_size=block_size, mask=fm, refresh=refresh, pred=pred_l,
                pred_kind=kind, pred_tile=tile, k_tiles=k_tiles,
                pred_measure=measure, fast_kernels=fast_kernels)
        return x, kp, vp, (act, scores, density, n_act, n_miss)

    return sp.decode_step_core(params, pages, token, pos, cfg, ffn_masks,
                               refresh, layer_fn=layer_fn,
                               embed_fn=embed_tokens, logits_fn=logits_from,
                               extra_xs=(pred_params,))
