"""Whisper-style encoder-decoder family (whisper-small), in PyTorch — the
reference's ``models/encdec.py``.

The conv frontend is a STUB: callers pass precomputed frame embeddings
batch["frames"] (b, n_audio_frames, d_model). The encoder is a
bidirectional transformer over the frames plus sinusoidal positions
(``transformer.apply_block(causal=False)``); the decoder block is causal
self-attention, cross-attention to the encoder output, and the FFN. The
legacy cache holds the decoder's self-attention K/V (``k``/``v``, at
max_len) and each layer's cross K/V over the frames (``xk``/``xv``),
head-major. Relufication applies to both stacks' FFNs (GELU -> ReLU) and
stage-2 post-norm ReLU; at static tile capacities the decode step's
self-attention q/k/v and FFN products gather their inputs' top tiles
(kernel 5 on the card), while the cross-attention query and both output
projections stay dense, as in the reference.

The frames are cast to the compute dtype at the encoder's entry (the
reference computes in the frames' own dtype; its callers pass the
compute dtype).

Under a mesh (``sharding.comm.serving``) the encoder blocks and the
decoder's self-attention and FFN are the transformer's, split as the
dense family's (padded q slots and kv heads, d_ff, the vocabulary); the
cross-attention takes the rank's heads (``common.local_heads``): its
query and K/V over the rank's columns, ``wo`` over its rows summed
(``transformer._attn_out``). The legacy cache's self-attention K/V are
sequence-sharded (``transformer.apply_attn_decode``), its cross K/V hold
the rank's kv heads.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as T
from repro_torch.sharding import comm


def sinusoid(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def init_dec_block(cfg: ModelConfig, ini: cm.ParamInit,
                   n: Optional[int] = None):
    attn = T.init_attn(cfg, ini, n)
    xattn = T.init_attn(cfg, ini, n)
    return {"ln1": ini.norm(cfg, n), "attn": attn, "lnx": ini.norm(cfg, n),
            "xattn": xattn, "ln2": ini.norm(cfg, n),
            "ffn": T.init_ffn(cfg, ini, n)}


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None):
    """Random parameters on ``device`` from a seeded torch.Generator: the
    encoder's dense blocks and the decoder's blocks, each stacked; learned
    decoder positions; the unembedding tied to the embedding."""
    device = cm.resolve_device(device)
    ini = cm.ParamInit(seed, device, dtype or T.compute_dtype(cfg))
    vp = cm.padded_vocab(cfg.vocab_size)
    enc = T.init_block(cfg, ini, cfg.n_encoder_layers)
    dec = init_dec_block(cfg, ini, cfg.n_layers)
    return {"embed": ini.embed((vp, cfg.d_model)),
            "pos_embed": ini.embed((cfg.max_seq_len, cfg.d_model)),
            "enc_layers": enc, "enc_norm": ini.norm(cfg),
            "dec_layers": dec, "final_norm": ini.norm(cfg)}


@functools.lru_cache(maxsize=None)
def _sinusoid_on(n: int, d: int, device: torch.device) -> torch.Tensor:
    # copied to the device once, not at every call
    return torch.from_numpy(sinusoid(n, d)).to(device)


def encode(params, frames, cfg: ModelConfig, *,
           stats: cm.StatsCollector = cm.NO_STATS, remat_policy: str = "none"):
    """frames (b, n_frames, d) stub embeddings -> the encoder output
    (b, n_frames, d) after ``enc_norm``. ``stats`` is shared by the layers
    (no prefix), as in the reference. A ``common.LayerSource`` in
    ``params["enc_layers"]`` gives each layer just before its block."""
    b, nf, d = frames.shape
    x = frames.to(T.compute_dtype(cfg))
    x = x + _sinusoid_on(nf, d, x.device).to(x.dtype)
    positions = torch.arange(nf, device=x.device).expand(b, nf)
    block = cm.wrap_block(remat_policy,
                          functools.partial(T.apply_block, causal=False))
    n = cfg.n_encoder_layers
    layers = cm.unstack_layers(params["enc_layers"], n)
    for i in range(n):
        x, _ = block(layers[i], x, cfg, positions, stats)
        cm.release_layer(layers, i)
    return cm.apply_norm(params["enc_norm"], x, cfg)


def _split_in(x, split: bool):
    """x entering products split over "model" (``comm.copy_to_model``: its
    gradient summed over the ranks) when ``split``."""
    return comm.copy_to_model(x) if split else x


def _cross_kv(p, enc_out, cfg: ModelConfig):
    """K/V (b, se, kvp, hd) from the encoder output with the cross-attention
    projections; under a mesh the rank's kv heads."""
    b, se, d = enc_out.shape
    g = cm.local_heads(cfg)
    lay = cm.shard_layout(cfg)
    x = _split_in(enc_out, lay is not None and lay.kv_split == "heads")
    k = (x @ p["wk"].reshape(d, -1)).reshape(b, se, g.kvp, g.head_dim)
    v = (x @ p["wv"].reshape(d, -1)).reshape(b, se, g.kvp, g.head_dim)
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def _cross_q(p, h, cfg: ModelConfig):
    """The cross-attention query (..., hp, hd) of decoder states h (..., d):
    a dense product, recording no statistics; under a mesh the rank's q
    slots."""
    g = cm.local_heads(cfg)
    lay = cm.shard_layout(cfg)
    x = _split_in(h, lay is not None and lay.q_split)
    q = (x @ p["wq"].reshape(h.shape[-1], -1)).reshape(
        h.shape[:-1] + (g.hp, g.head_dim))
    return q + p["bq"] if cfg.qkv_bias else q


def _cross_attend(p, h, kx, vx, cfg: ModelConfig):
    """h (b, s, d) decoder states; kx/vx (b, se, kvp, hd). Every query
    attends every frame."""
    g = cm.local_heads(cfg)
    b, s, _ = h.shape
    qg = _cross_q(p, h, cfg).reshape(b, s, g.kvp, g.group, g.head_dim)
    o = cm.flash_attention(qg, kx, vx, causal=False)
    return T._attn_out(p, o.reshape(b, s, g.hp, g.head_dim), cfg)


def apply_dec_block(p, x, cfg: ModelConfig, enc_out, positions,
                    stats: cm.StatsCollector = cm.NO_STATS, cross_kv=None):
    """Decoder block over x (b, s, d): causal self-attention, then
    cross-attention to enc_out, then the FFN. ``cross_kv`` is the block's
    ``_cross_kv`` of enc_out when the caller has it already. Returns
    (x, (k, v)) with the self-attention's K/V for the cache."""
    h = T.post_norm(cm.apply_norm(p["ln1"], x, cfg), cfg)
    a, kv = T.apply_attn_full(p["attn"], h, cfg, positions, stats=stats)
    x = x + a
    h = T.post_norm(cm.apply_norm(p["lnx"], x, cfg), cfg)
    kx, vx = cross_kv or _cross_kv(p["xattn"], enc_out, cfg)
    x = x + _cross_attend(p["xattn"], h, kx, vx, cfg)
    h = T.post_norm(cm.apply_norm(p["ln2"], x, cfg), cfg)
    b, s, d = h.shape
    x = x + T.apply_ffn(p["ffn"], h.reshape(b * s, d), cfg,
                        stats=stats).reshape(b, s, d)
    return x, kv


def _embed_dec(params, tokens, positions, dtype, cfg: ModelConfig):
    """Token plus learned position embeddings, in ``dtype`` (the token
    rows of a vocabulary split over "model": ``transformer.token_rows``)."""
    x = T.token_rows(params["embed"], tokens, cfg)
    return (x + params["pos_embed"][positions.long()]).to(dtype)


def model_forward(params, batch, cfg: ModelConfig, *, stats=cm.NO_STATS,
                  remat_policy: str = "none"):
    """Decoder logits (b, s, vocab_p) over batch["tokens"], attending
    batch["frames"]. The decoder block closes over the encoder output;
    ``torch.utils.checkpoint`` is non-reentrant under every remat policy,
    so the gradient reaches the encoder through it."""
    params = cm.cast_params(params, cfg)
    enc_out = encode(params, batch["frames"], cfg, stats=stats,
                     remat_policy=remat_policy)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed_dec(params, tokens, positions, enc_out.dtype, cfg)

    def dec(p, x_, cfg_, positions_, stats_, sublayer=cm.call):
        # the whole block is one sublayer: the reference names nothing in
        # it, so "save_ars" saves nothing there
        return sublayer(apply_dec_block, p, x_, cfg_, enc_out, positions_,
                        stats_)

    block = cm.wrap_block(remat_policy, dec)
    layers = cm.unstack_layers(params["dec_layers"], cfg.n_layers)
    for i in range(cfg.n_layers):
        x, _ = block(layers[i], x, cfg, positions, stats)
        cm.release_layer(layers, i)
    x = cm.apply_norm(params["final_norm"], x, cfg)
    return T.logits_from(params, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Zero {"k"/"v" (L, batch, kvp, max_len, hd), "xk"/"xv"
    (L, batch, kvp, n_audio_frames, hd)}, head-major. Under a mesh the
    rank's blocks, as ``model_prefill`` makes them: max_len / M positions
    of every kv head, the cross K/V of its kv heads."""
    device = cm.resolve_device(device)
    dtype = dtype or T.compute_dtype(cfg)
    g, gx = T.attn_geometry(cfg), cm.local_heads(cfg)
    L = cfg.n_layers
    rows = cm.rank_cache_rows(max_len)
    max_len = max_len if rows is None else rows[1]

    def zeros(kvp, s):
        return torch.zeros((L, batch, kvp, s, g.head_dim), dtype=dtype,
                           device=device)

    return {"k": zeros(g.kvp, max_len), "v": zeros(g.kvp, max_len),
            "xk": zeros(gx.kvp, cfg.n_audio_frames),
            "xv": zeros(gx.kvp, cfg.n_audio_frames)}


def model_prefill(params, batch, cfg: ModelConfig, max_len: int,
                  stats=cm.NO_STATS):
    """Encode the frames, run the prompt through the decoder; the cache
    holds the self-attention K/V (padded to max_len) and the cross K/V of
    every layer. Returns (last logits (b, vocab_p), cache). Under a mesh
    the rank's blocks (``init_cache``): the self-attention K/V its
    max_len / M positions of every kv head (``common.cache_rows``)."""
    params = cm.cast_params(params, cfg)
    enc_out = encode(params, batch["frames"], cfg, stats=stats)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed_dec(params, tokens, positions, enc_out.dtype, cfg)
    rows = cm.rank_cache_rows(max_len)
    ks, vs, xks, xvs = [], [], [], []
    with cm.cache_rows(rows):
        for p_i in cm.unstack_layers(params["dec_layers"], cfg.n_layers):
            kx, vx = _cross_kv(p_i["xattn"], enc_out, cfg)
            x, (k, v) = apply_dec_block(p_i, x, cfg, enc_out, positions,
                                        stats, cross_kv=(kx, vx))
            ks.append(k)
            vs.append(v)
            xks.append(kx)
            xvs.append(vx)
    x = cm.apply_norm(params["final_norm"], x, cfg)
    logits = T.logits_from(params, x[:, -1:], cfg)
    cache = T.finalize_prefill_cache(torch.stack(ks), torch.stack(vs),
                                     max_len if rows is None else rows[1])
    cache["xk"] = torch.stack(xks).permute(0, 1, 3, 2, 4).contiguous()
    cache["xv"] = torch.stack(xvs).permute(0, 1, 3, 2, 4).contiguous()
    return logits[:, -1], cache


def apply_dec_block_decode(p, x, cfg: ModelConfig, kc, vc, xk, xv, pos, *,
                           layer: int, stats: cm.StatsCollector = cm.NO_STATS):
    """One-token decoder block of ``layer``: self-attention against the
    contiguous cache (written in place), cross-attention over every frame
    (``decode_attention`` at position se - 1), the FFN at the static tile
    capacities. Returns (x, kc, vc). Under a mesh the cross-attention
    runs the rank's heads over its cross K/V (whole over the frames: the
    unsharded ``window_attention``)."""
    h = T.post_norm(cm.apply_norm(p["ln1"], x[:, None], cfg)[:, 0], cfg)
    a, kc, vc = T.apply_attn_decode(p["attn"], h, cfg, kc, vc, pos,
                                    stats=stats, layer=layer)
    x = x + a
    h = T.post_norm(cm.apply_norm(p["lnx"], x[:, None], cfg)[:, 0], cfg)
    g = cm.local_heads(cfg)
    q = _cross_q(p["xattn"], h, cfg)
    se = xk.shape[3]  # head-major (L, b, kvp, se, hd)
    last = torch.full((x.shape[0], 1), se - 1, dtype=torch.int32,
                      device=x.device)
    o = cm.window_attention(q.reshape(-1, 1, g.kvp, g.group, g.head_dim),
                            xk[layer], xv[layer], last)
    x = x + T._attn_out(p["xattn"], o.reshape(o.shape[0], 1, g.hp,
                                                g.head_dim), cfg)[:, 0]
    h = T.post_norm(cm.apply_norm(p["ln2"], x[:, None], cfg)[:, 0], cfg)
    x = x + T.apply_ffn(p["ffn"], h, cfg, stats=stats, decode=True)
    return x, kc, vc


def model_decode(params, cache, token, pos, cfg: ModelConfig,
                 stats=cm.NO_STATS):
    """One decode step; the self-attention cache is written in place. An
    active ``stats`` is shared by every layer with no ``layer{i}/``
    prefix, as in the reference. Returns (logits (b, vocab_p), cache)."""
    params = cm.cast_params(params, cfg)
    x = _embed_dec(params, token, pos, T.compute_dtype(cfg), cfg)
    kc, vc = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        p_i = cm.layer_params({"layers": params["dec_layers"]}, i)
        x, kc, vc = apply_dec_block_decode(p_i, x, cfg, kc, vc, cache["xk"],
                                           cache["xv"], pos, layer=i,
                                           stats=stats)
    x = cm.apply_norm(params["final_norm"], x[:, None], cfg)[:, 0]
    return T.logits_from(params, x, cfg), dict(cache, k=kc, v=vc)
