"""Zamba-2 hybrid family (zamba2-7b), in PyTorch — the reference's
``models/hybrid.py``: a Mamba-2 (SSD) backbone and ONE shared
attention+FFN block applied after every ``attn_every`` Mamba-2 layers (13
applications over 81 layers).

The full sequence runs the SSD chunked algorithm: within a chunk of Q
tokens an attention-like product with decay weights, across chunks a
recurrence over the chunk states. The reference writes its products as
three-operand einsums, which contract pairwise in an order its einsum
backend picks; here each is written as explicit pairwise products (an
elementwise product, then one batched matmul), so the order is fixed and
no (b, nc, Q, Q, nh, hd) tensor is built. Decode is the O(1) recurrence
on the (L, b, nh, st, hd) state and the conv ring buffer, updated in
place; the shared block decodes against its own contiguous K/V cache,
one slot per application.

Relufication: the shared block's FFN relufies as the dense family's; the
Mamba-2 gate (``act`` on z, also applied to the conv output) as
falcon-mamba's, sparsifying the out_proj input after the gated RMSNorm.
At static tile capacities the decode step's out_proj and the shared
block's q/k/v and FFN products gather their inputs' top tiles
(``common.maybe_sparse_matmul``, kernel 5 on the card).

Under a mesh (``sharding.comm.serving``) each rank holds the Mamba-2
heads ``common.ShardLayout.ssm_heads`` and their d_inner units
(``common.leaf_sharding``: ``in_proj``'s z, x and dt columns of its heads and
B, C whole; ``conv_*``, ``gnorm``, ``A_log``, ``D``, ``dt_bias`` and
``out_proj``'s rows of its heads). The SSD scan is per head, so it runs
on the rank's heads alone. B and C are computed whole on every rank,
their gradient summed over the ranks (``comm.copy_to_model``). The gated
RMSNorm's sum of squares over all of d_inner is one all-reduce of a
(tokens, 1) f32 partial (``common.model_sum``); ``out_proj`` over the
rank's rows is summed as the transformer's output projections are
(``common.sublayer_sum``). The shared block is the transformer's, split
as the dense family's; its legacy K/V cache is sequence-sharded
(``transformer.apply_attn_decode``), the SSM caches hold the rank's
heads.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as nnf

from repro_torch.configs.base import ModelConfig
from repro_torch.core import activations as acts
from repro_torch.models import common as cm
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.sharding import comm


def init_mamba2(cfg: ModelConfig, ini: cm.ParamInit, n: Optional[int] = None):
    d, di, st, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    nh = cfg.n_ssm_heads
    lead = () if n is None else (n,)
    return {
        "norm": ini.norm(cfg, n),
        "ssm": {
            # in_proj -> [z (di), x (di), B (st), C (st), dt (nh)]
            "in_proj": ini.stack(n, lambda: ini.dense(
                (d, 2 * di + 2 * st + nh), d)),
            "conv_w": ini.stack(n, lambda: ini.dense((k, di), k)),
            "conv_b": ini.full(lead + (di,), 0.0),
            "A_log": ini.full(lead + (nh,), 0.0),  # A = -exp(A_log) = -1
            "D": ini.full(lead + (nh,), 1.0),
            "dt_bias": ini.full(lead + (nh,), -4.6),
            "gnorm": ini.full(lead + (di,), 1.0),  # gated RMSNorm scale
            "out_proj": ini.stack(n, lambda: ini.dense((di, d), di)),
        },
    }


def _local(cfg: ModelConfig):
    """(d_inner units, heads) this rank holds: all of them without a
    mesh."""
    lay = cm.shard_layout(cfg)
    if lay is None:
        return cfg.d_inner, cfg.n_ssm_heads
    return lay.inner[1], lay.ssm_heads[1]


def _split_in_proj(p, h_in, cfg: ModelConfig):
    """in_proj -> (z, x, B, C, dt). Under a mesh z, x and dt are the rank's
    heads (its in_proj block packs [z | x | B | C | dt]) and B, C whole: a
    product of its own (no ``copy_to_model`` of h_in), whose gradient is
    summed over the ranks, since each rank's heads read all of it."""
    st = cfg.ssm_state
    di, nh = _local(cfg)
    w = p["in_proj"]
    if cm.shard_layout(cfg) is None:
        return (h_in @ w).split([di, di, st, st, nh], dim=-1)
    xs = comm.copy_to_model(h_in)
    z, x = (xs @ w[..., :2 * di]).split([di, di], dim=-1)
    B, C = comm.copy_to_model(h_in @ w[..., 2 * di:2 * di + 2 * st]).split(
        [st, st], dim=-1)
    return z, x, B, C, xs @ w[..., 2 * di + 2 * st:]


def _gated_out(p, y, z, cfg: ModelConfig, act, stats):
    """y, z (..., di): y * act(z), RMS-normalised (eps 1e-6) and scaled by
    gnorm, then the out_proj — at the static FFN tile capacity only at
    decode (2-D y), as the reference's. Under a mesh y and z are the
    rank's units: the mean square is the sum over the ranks' squares
    (one all-reduce of a (tokens, 1) f32 partial) over d_inner, and the
    ranks' out_proj partials are summed (``common.rows_partial``: one
    device's selection at the static capacity)."""
    stats.add_preact("gate_pre", z)
    g = y * act(z)
    gf = g.float()
    lay = cm.shard_layout(cfg)
    if lay is None:
        var = gf.square().mean(-1, keepdim=True)
    else:
        var = cm.model_sum(gf.square().sum(-1, keepdim=True)) / cfg.d_inner
    g = (gf * torch.rsqrt(var + 1e-6)).to(y.dtype) * p["gnorm"]
    stats.add_sparsity("down_in", g)
    dens = T.densities(cfg)[1] if g.dim() == 2 else 1.0
    g2 = g.reshape(-1, g.shape[-1])
    if lay is None:
        out = cm.maybe_sparse_matmul(g2, p["out_proj"], cfg, dens)
    else:
        out = cm.sublayer_sum(cm.rows_partial(
            g2, p["out_proj"], cfg, dens, lay.inner[0], cfg.d_inner,
            lay.tp), g.dtype)
    return out.reshape(g.shape[:-1] + (-1,))


def _ssd(p, x, cfg: ModelConfig, stats: cm.StatsCollector, record_in: bool):
    """The SSD chunked scan over x (b, s, d). Returns (x + out, the final
    state (b, nh, st, hd) f32, the pre-conv inputs (b, s, di)).
    ``record_in`` records the ``qkv_in`` site (the forward; prefill does
    not, as the reference's)."""
    b, s = x.shape[:2]
    st, hd = cfg.ssm_state, cfg.ssm_head_dim
    di, nh = _local(cfg)
    act = acts.get(cfg.activation, shift=cfg.sparsity.shift)
    Q = cm._largest_divisor_leq(s, cfg.ssm_chunk)
    nc = s // Q
    ps = p["ssm"]
    h_in = M._norm_in(p, cm.sublayer_in(x), cfg)
    if record_in:
        stats.add_sparsity("qkv_in", h_in)
    z, xs_raw, B, C, dt = _split_in_proj(ps, h_in, cfg)
    xs = act(M._causal_conv(xs_raw, ps["conv_w"], ps["conv_b"]))
    dt = nnf.softplus(dt + ps["dt_bias"]).float()  # (b, s, nh)
    A = -torch.exp(ps["A_log"].float())  # (nh,)

    xh = xs.reshape(b, nc, Q, nh, hd).float()
    Bc = B.reshape(b, nc, Q, st).float()
    Cc = C.reshape(b, nc, Q, st).float()
    dtc = dt.reshape(b, nc, Q, nh)
    cum = torch.cumsum((dt * A).reshape(b, nc, Q, nh), dim=2)

    # intra-chunk: y_i = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (b,c,i,j,h)
    tri = torch.tril(torch.ones((Q, Q), device=x.device))
    scores = Cc @ Bc.transpose(-1, -2)  # (b, c, i, j)
    w = scores[..., None] * decay * tri[None, None, :, :, None]
    wd = (w * dtc[:, :, None, :, :]).permute(0, 1, 4, 2, 3)  # (b,c,h,i,j)
    y_intra = (wd @ xh.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
    dec_out = torch.exp(cum[:, :, -1:, :] - cum)  # (b, c, j, h)
    u = ((dec_out * dtc)[..., None] * xh).reshape(b, nc, Q, nh * hd)
    S = (Bc.transpose(-1, -2) @ u).reshape(b, nc, st, nh, hd)
    S = S.permute(0, 1, 3, 2, 4)  # (b, c, h, n, p)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, c, h)
    H = torch.zeros((b, nh, st, hd), device=x.device)
    prefix = []
    for c in range(nc):  # the state BEFORE each chunk
        prefix.append(H)
        H = chunk_decay[:, c, :, None, None] * H + S[:, c]
    H_prefix = torch.stack(prefix, 1)  # (b, c, h, n, p)

    y_inter = (Cc[:, :, None] @ H_prefix).permute(0, 1, 3, 2, 4)  # (b,c,i,h,p)
    y_inter = torch.exp(cum)[..., None] * y_inter
    y = (y_intra + y_inter).to(x.dtype).reshape(b, s, nh, hd)
    y = y + ps["D"][None, None, :, None] * xs.reshape(b, s, nh, hd)
    out = _gated_out(ps, y.reshape(b, s, di), z, cfg, act, stats)
    return x + out, H, xs_raw


def _mamba2_block(p, x, cfg: ModelConfig, positions, stats):
    return _ssd(p, x, cfg, stats, record_in=True)[0]


def apply_mamba2_block(p, x, cfg: ModelConfig, positions,
                       stats: cm.StatsCollector = cm.NO_STATS,
                       sublayer=cm.call):
    """Full-sequence Mamba-2 block (a layer function under
    ``common.wrap_block``): x (b, s, d) -> (x, None). One sublayer:
    "save_ars" checkpoints it whole (the reference's names nothing in
    it)."""
    return sublayer(_mamba2_block, p, x, cfg, positions, stats), None


def apply_mamba2_decode(p, x, cfg: ModelConfig, ssm_state, conv_state, *,
                        layer: int, stats: cm.StatsCollector = cm.NO_STATS):
    """One-token SSD step of ``layer``. x (b, d); ssm_state
    (L, b, nh, st, hd); conv_state (L, b, k - 1, di), both written in
    place. Returns (x, ssm_state, conv_state)."""
    hd = cfg.ssm_head_dim
    di, nh = _local(cfg)
    act = acts.get(cfg.activation, shift=cfg.sparsity.shift)
    ps = p["ssm"]
    h_in = M._norm_in(p, x[:, None], cfg)[:, 0]
    z, xs, B, C, dt = _split_in_proj(ps, h_in, cfg)
    win = torch.cat([conv_state[layer], xs[:, None]], dim=1)  # (b, k, di)
    xs = act((win * ps["conv_w"]).sum(1) + ps["conv_b"])
    conv_state[layer] = win[:, 1:]
    dt = nnf.softplus(dt + ps["dt_bias"]).float()  # (b, nh)
    dec = torch.exp(dt * -torch.exp(ps["A_log"].float()))  # (b, nh)
    xh = xs.reshape(-1, nh, hd).float()
    upd = B.float()[:, None, :, None] * (dt[:, :, None] * xh)[:, :, None, :]
    h_new = dec[:, :, None, None] * ssm_state[layer].float() + upd
    ssm_state[layer] = h_new.to(ssm_state.dtype)
    y = (C.float()[:, None, None, :] @ h_new)[:, :, 0].to(x.dtype)  # (b,h,p)
    y = y + ps["D"][None, :, None] * xs.reshape(-1, nh, hd)
    out = _gated_out(ps, y.reshape(-1, di), z, cfg, act, stats)
    return x + out, ssm_state, conv_state


# ---------------------------------------------------------------------------
# hybrid assembly: segments of Mamba-2 layers + the shared block


def _segments(cfg: ModelConfig) -> List[Tuple[int, int, bool]]:
    """[(start, end, attn_after)]: Mamba-2 layers [start, end), then the
    shared block when the segment is a full ``attn_every``."""
    ae = cfg.attn_every or cfg.n_layers + 1
    out, i = [], 0
    while i < cfg.n_layers:
        j = min(i + ae, cfg.n_layers)
        out.append((i, j, j - i == ae))
        i = j
    return out


def n_attn_applications(cfg: ModelConfig) -> int:
    return sum(1 for (_, _, a) in _segments(cfg) if a)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None):
    """Random parameters on ``device`` from a seeded torch.Generator: the
    stacked Mamba-2 layers, ONE unstacked shared attention+FFN block
    (``shared``), untied embeddings."""
    device = cm.resolve_device(device)
    ini = cm.ParamInit(seed, device, dtype or T.compute_dtype(cfg))
    vp = cm.padded_vocab(cfg.vocab_size)
    layers = init_mamba2(cfg, ini, cfg.n_layers)
    embed = ini.embed((vp, cfg.d_model))
    shared = T.init_block(cfg, ini)
    return {"embed": embed, "layers": layers, "shared": shared,
            "final_norm": ini.norm(cfg),
            "unembed": ini.embed((vp, cfg.d_model))}


def model_forward(params, batch, cfg: ModelConfig, *, stats=cm.NO_STATS,
                  remat_policy: str = "none"):
    """Logits (b, s, vocab_p). An active ``stats`` is shared by every layer
    (no ``layer{i}/`` prefix), as in the reference. ``common.LayerSource``
    trees (the FSDP step's gathers) give each Mamba-2 layer just before
    its block (``params["layers"]``) and the shared block at each of its
    applications (``params["shared"]``, a source of one layer);
    ``cfg.sp_residuals`` under a mesh keeps the residual split over
    "model" between the blocks, as ``transformer.forward``."""
    params = cm.cast_params(params, cfg)
    x, positions = M._embed(params, batch["tokens"], cfg)
    mblock = cm.wrap_block(remat_policy, apply_mamba2_block)
    ablock = cm.wrap_block(remat_policy, T.apply_block)
    layers = cm.unstack_layers(params["layers"], cfg.n_layers)
    shared = params["shared"]
    sp = cm.sp_fits(cfg)
    with comm.sequence_parallel(sp):
        if sp:
            x = comm.split_last(x)
        for (i0, i1, attn_after) in _segments(cfg):
            for i in range(i0, i1):
                x, _ = mblock(layers[i], x, cfg, positions, stats)
                cm.release_layer(layers, i)
            if attn_after:
                p_sh = shared[0] if isinstance(shared, cm.LayerSource) \
                    else shared
                x, _ = ablock(p_sh, x, cfg, positions, stats)
                cm.release_layer(shared, 0)
        if sp:
            x = comm.all_gather_last(x, whole_grad=True)
    x = cm.apply_norm(params["final_norm"], x, cfg)
    return T.logits_from(params, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Zero {"ssm" (L, batch, nh, st, hd), "conv" (L, batch, k - 1, di),
    "k"/"v" (n_attn_applications, batch, kvp, max_len, hd) head-major}.
    Under a mesh the rank's blocks, as ``model_prefill`` makes them: its
    heads and their units, and max_len / M positions of the K/V."""
    device = cm.resolve_device(device)
    dtype = dtype or T.compute_dtype(cfg)
    L, st, k = cfg.n_layers, cfg.ssm_state, cfg.ssm_conv
    di, nh = _local(cfg)
    hd = cfg.ssm_head_dim
    g = T.attn_geometry(cfg)
    na = n_attn_applications(cfg)
    rows = cm.rank_cache_rows(max_len)
    max_len = max_len if rows is None else rows[1]

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"ssm": zeros(L, batch, nh, st, hd),
            "conv": zeros(L, batch, k - 1, di),
            "k": zeros(na, batch, g.kvp, max_len, g.head_dim),
            "v": zeros(na, batch, g.kvp, max_len, g.head_dim)}


def model_prefill(params, batch, cfg: ModelConfig, max_len: int,
                  stats=cm.NO_STATS):
    """The prompt through the SSD scans and the shared block; the cache
    holds each Mamba-2 layer's final state and conv tail and each
    application's K/V. Returns (last logits (b, vocab_p), cache). Under a
    mesh the rank's blocks (``init_cache``): the shared block's K/V are
    its max_len / M positions of every kv head (``common.cache_rows``),
    as ``transformer.apply_attn_decode`` reads them."""
    params = cm.cast_params(params, cfg)
    cdt = T.compute_dtype(cfg)
    x, positions = M._embed(params, batch["tokens"], cfg)
    layers = cm.unstack_layers(params["layers"], cfg.n_layers)
    rows = cm.rank_cache_rows(max_len)
    hs, tails, ks, vs = [], [], [], []
    for (i0, i1, attn_after) in _segments(cfg):
        for p_i in layers[i0:i1]:
            x, h_last, xs_raw = _ssd(p_i, x, cfg, stats, record_in=False)
            hs.append(h_last.to(cdt))
            tails.append(M.conv_tail(xs_raw, cfg.ssm_conv).to(cdt))
            del xs_raw  # freed before the next layer's scan
        if attn_after:
            with cm.cache_rows(rows):
                x, (k, v) = T.apply_block(params["shared"], x, cfg,
                                          positions, stats)
            ks.append(k)
            vs.append(v)
    x = cm.apply_norm(params["final_norm"], x, cfg)
    logits = T.logits_from(params, x[:, -1:], cfg)
    cache = {"ssm": torch.stack(hs), "conv": torch.stack(tails)}
    if ks:
        kv = T.finalize_prefill_cache(torch.stack(ks), torch.stack(vs),
                                      max_len if rows is None else rows[1])
        cache.update(k=kv["k"].to(cdt), v=kv["v"].to(cdt))
    else:
        empty = torch.zeros((0,), dtype=cdt, device=x.device)
        cache.update(k=empty, v=empty)
    return logits[:, -1], cache


def model_decode(params, cache, token, pos, cfg: ModelConfig,
                 stats=cm.NO_STATS):
    """One decode step; the cache is updated in place. The shared block
    decodes application ``a`` against K/V slot ``a``. An active ``stats`` is
    shared by every layer with no ``layer{i}/`` prefix, as in the
    reference (so the legacy engine finds no per-layer masks)."""
    params = cm.cast_params(params, cfg)
    x = T.embed_tokens(params, token[:, None], cfg, pos[:, None])[:, 0]
    ssm, conv, kc, vc = cache["ssm"], cache["conv"], cache["k"], cache["v"]
    attn_idx = 0
    for (i0, i1, attn_after) in _segments(cfg):
        for li in range(i0, i1):
            x, ssm, conv = apply_mamba2_decode(cm.layer_params(params, li), x,
                                               cfg, ssm, conv, layer=li,
                                               stats=stats)
        if attn_after:
            x, kc, vc = T.apply_block_decode(params["shared"], x, cfg, kc, vc,
                                             pos, stats=stats, layer=attn_idx)
            attn_idx += 1
    x = cm.apply_norm(params["final_norm"], x[:, None], cfg)[:, 0]
    return T.logits_from(params, x, cfg), {"ssm": ssm, "conv": conv,
                                           "k": kc, "v": vc}
