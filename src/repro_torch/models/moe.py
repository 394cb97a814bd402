"""Top-k Mixture-of-Experts family (Mixtral-8x22B, Phi-3.5-MoE), in
PyTorch — the forward, the legacy contiguous-cache steps and the paged
serving steps of the reference's ``models/moe.py``.

Grouped one-hot dispatch: t tokens are split into G groups of about
``cfg.moe_group_size``; in each group an expert takes cap = ceil(tg *
top_k * capacity_factor / E) tokens, assigned in priority order (every
token's k = 0 choice before any k = 1 choice). The dispatch and the expert
products are ``torch.einsum``, as the reference leaves them to XLA outside
any Pallas kernel. On CUDA tensors the serving steps run attention through
the ``paged_window_attention`` kernel (``transformer.kernel_path``), as the
dense family does; the reference's MoE step uses the same math in XLA.

``apply_moe_gathered`` is the grouped-gather lowering of the same FFN: the
router's top-k lists each token's experts' weight tiles
(``expert_tile_lists``), and the kernels ``expert_up_matmul`` and
``expert_down_matmul`` read only the routed experts' tiles. It is an entry
point of its own; the serving steps keep the dispatch einsums, as the
reference's do.

Under a serving mesh the experts are split over the ranks (the serve
rules' priority axis): the router's logits are gathered, every rank
routes every token the same way, runs its own experts on their slots and
combines them in f32, and the ranks' sums are summed (exact: a token's
output has top_k nonzero terms); the window's activity is OR-ed over the
ranks. Where the experts do not divide the model axis, d_ff is split
instead, as in the dense family.

Under a data split that cuts the batch (``comm.data_split``: each data row
of the mesh computes its own slots), the groups, the capacity and the
routing are those of the whole batch, as on one device: where a group's
tokens lie in one row, the row routes its groups alone; where a group
spans rows, the router logits are put together over the data axis, every
row routes every token the same way, and each row runs the groups its
tokens touch with the other rows' tokens left out (their expert slots
stay empty), so its tokens meet the capacity drops one device makes.

Exactness: under drop-free capacity (capacity_factor >= n_experts, so cap
>= tg * top_k) every token's experts take it whatever tokens share the
batch, and each expert slot holds an exact copy of one token's row. The
engine's slot-batched, zero-padded windows then route every token as a
batch of one would. With droppable capacity the paths stay correct, but a
token may be dropped in one batch shape and not in another.

Parameters follow the reference's tree: per layer ``ln1``, ``attn``,
``ln2`` and ``moe`` = {``router`` (d, E), ``wu``/``wg`` (E, d, F), ``wd``
(E, F, d)}, stacked on a leading layer axis.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as nnf

from repro_torch.configs.base import ModelConfig
from repro_torch.core import activations as acts
from repro_torch.kernels import sparse_matmul as ksm
from repro_torch.kernels.fused_ffn import window_tile_activity
from repro_torch.models import common as cm
from repro_torch.models import serving_protocol as sp
from repro_torch.models import transformer as T
from repro_torch.predictor import predictors as preds
from repro_torch.sharding import comm


def _init_moe(cfg: ModelConfig, ini: cm.ParamInit, n):
    d, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": ini.stack(n, lambda: ini.dense((d, E), d)),
         "wu": ini.stack(n, lambda: ini.dense((E, d, F), d)),
         "wd": ini.stack(n, lambda: ini.dense((E, F, d), F))}
    if cfg.ffn_kind == "glu":
        p["wg"] = ini.stack(n, lambda: ini.dense((E, d, F), d))
    return "moe", p


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None):
    """Random parameters on ``device`` from a seeded torch.Generator, with
    the reference's scaling; the experts stacked (E, d, F) / (E, F, d) and
    the layers on a leading axis (``transformer.init_params``)."""
    return T.init_params(cfg, seed=seed, device=device, dtype=dtype,
                         ffn=_init_moe)


# ---------------------------------------------------------------------------
# routing


def _route(p, x, cfg: ModelConfig,
           stats: cm.StatsCollector = cm.NO_STATS):
    """Top-k routing and grouped priority slot assignment for t tokens
    x (t, d), as the reference's ``_route``: the router logits' softmax in
    f32, the top k with ties to the lower expert index (``lax.top_k``; a
    stable descending sort here, as ``torch.topk`` promises no order), the
    gates renormalised over the k, then k = 0 claims capacity before k = 1.
    An active ``stats`` records ``moe_drop_frac`` (the share of the
    t * top_k assignments capacity dropped) and ``moe_load_cv`` (the
    coefficient of variation of the gate mass each (group, expert) takes).

    Returns (xg (G, tg, d), dispatch (G, tg, E, cap) bool, combine
    (G, tg, E, cap) f32, (G, tg, cap), (topi, topv) (G, tg, k), own) with
    own = (first, count): x's tokens among the G * tg rows (all of them but
    under a data split whose groups span the data rows, module note)."""
    t, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    split = comm.data_split()
    rows = split.size if split is not None and split.slots_split else 1
    t_all = t * rows  # the whole batch's tokens
    G = max(1, t_all // cfg.moe_group_size)
    while t_all % G:
        G -= 1
    tg = t_all // G
    cap = max(1, int(-(-tg * k * cfg.capacity_factor // E)))

    lay = cm.shard_layout(cfg)

    def router(x):
        if lay is None or lay.experts[1] == E:
            return (x @ p["router"]).float()
        # the router holds the rank's experts' columns: gather them all
        return comm.gather_last(comm.copy_to_model(x) @ p["router"], E,
                                lay.experts[0]).float()

    own = (0, t)
    if rows == 1 or t % tg == 0:  # whole groups: this row's alone
        G = t // tg
        xg = x.reshape(G, tg, d)
        logits = router(xg)
    else:
        # the groups of this row's tokens span rows: route every token
        t0 = split.index * t
        g0, g1 = t0 // tg, (t0 + t - 1) // tg + 1
        logits = comm.data_gather([router(x)])[0].reshape(t_all, E)
        logits = logits[g0 * tg:g1 * tg].reshape(g1 - g0, tg, E)
        own = (t0 - g0 * tg, t)
        G = g1 - g0
        xg = torch.zeros((G * tg, d), dtype=x.dtype, device=x.device)
        xg[own[0]:own[0] + t] = x
        xg = xg.reshape(G, tg, d)
    gates_all = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / topv.sum(-1, keepdim=True)

    dev = x.device
    dispatch = torch.zeros((G, tg, E, cap), dtype=torch.bool, device=dev)
    combine = torch.zeros((G, tg, E, cap), dtype=torch.float32, device=dev)
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev)
    for kk in range(k):
        oh = nnf.one_hot(topi[..., kk], E)  # (G, tg, E)
        pos = torch.cumsum(oh, 1) - oh + counts[:, None, :]  # slot index
        ok = (pos < cap) & (oh > 0)
        slot = nnf.one_hot(torch.where(ok, pos, cap), cap + 1)[..., :cap]
        sel = slot.float() * oh[..., None]  # (G, tg, E, cap)
        dispatch |= sel > 0
        combine = combine + sel * topv[..., kk][..., None, None]
        counts = counts + oh.sum(1)
    if own != (0, G * tg):  # the other rows' tokens take no slot here
        keep = torch.zeros(G * tg, dtype=torch.bool, device=dev)
        keep[own[0]:own[0] + own[1]] = True
        keep = keep.reshape(G, tg, 1, 1)
        dispatch = dispatch & keep
        combine = combine * keep
    if stats.active:
        stats.add("moe_drop_frac", 1.0 - dispatch.sum() / (G * tg * k))
        load = combine.sum((1, 3))  # (G, E)
        stats.add("moe_load_cv",
                  load.std(unbiased=False) / (load.mean() + 1e-9))
    return xg, dispatch, combine, (G, tg, cap), (topi, topv), own


def _own_tokens(y, own):
    """The rows of x's tokens in a (G, tg, ...) routing-group tensor, as
    (t, ...)."""
    return y.reshape((-1,) + tuple(y.shape[2:]))[own[0]:own[0] + own[1]]


def _split_ffn(cfg: ModelConfig) -> bool:
    """The experts' products are split over the active mesh (by expert or
    by d_ff): each rank's expert outputs are its part of the FFN's."""
    lay = cm.shard_layout(cfg)
    return lay is not None and (lay.experts[1] < cfg.n_experts
                                or lay.ffn_split)


def _local_experts(cfg: ModelConfig, dispatch, combine):
    """The routing tensors' slices of the experts this rank holds (all of
    them without a serving mesh, or where the rules replicate experts).
    Under autograd, where the experts' products are split, ``combine``
    passes ``comm.copy_to_model`` first: each rank's gradient of the gates
    comes from its part of the expert outputs, and the router replicated
    over the ranks takes their sum."""
    lay = cm.shard_layout(cfg)
    if _split_ffn(cfg):
        combine = comm.copy_to_model(combine)
    if lay is None or lay.experts[1] == cfg.n_experts:
        return dispatch, combine
    e0, el = lay.experts
    return dispatch[:, :, e0:e0 + el], combine[:, :, e0:e0 + el]


def _combine(cfg: ModelConfig, combine, ye, x):
    """The gate-weighted combine of the expert outputs ye (G, E, cap, d)
    into (G, tg, d) in x's dtype. Under a serving mesh each rank combines
    its experts in f32 and the ranks' sums are summed, then cast once: a
    token's output has top_k nonzero terms, so the sum is the one device's
    whatever rank holds each (x + 0 = x exactly)."""
    lay = cm.shard_layout(cfg)
    if lay is None or not (lay.experts[1] < cfg.n_experts or lay.ffn_split):
        return cm.sublayer_whole(
            torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), ye))
    y = torch.einsum("gtec,gecd->gtd", combine, ye.float())
    return cm.sublayer_sum(y, x.dtype)


def _expert_hidden(p, xe, cfg: ModelConfig,
                   stats: cm.StatsCollector = cm.NO_STATS):
    """act(xe @ Wg) [* (xe @ Wu)] per expert slot: xe (G, E, cap, d);
    ``stats`` records the gate's pre-activation (``moe_pre``)."""
    act_fn = acts.get(cfg.activation, shift=cfg.sparsity.shift)
    glu = cfg.ffn_kind == "glu"
    pre = torch.einsum("gecd,edf->gecf", xe, p["wg"] if glu else p["wu"])
    stats.add_preact("moe_pre", pre)
    if glu:
        return act_fn(pre) * torch.einsum("gecd,edf->gecf", xe, p["wu"])
    return act_fn(pre)


def apply_moe(p, x, cfg: ModelConfig,
              stats: cm.StatsCollector = cm.NO_STATS):
    """x (t, d) -> (t, d): top-k routing with capacity, the experts'
    FFNs on their slots, and the gate-weighted combine. An active ``stats``
    records the routing's sites, ``moe_pre`` and ``down_in`` (no
    ``down_act``: as in the reference, expert units feed no tracker)."""
    xg, dispatch, combine, _, _, _ = _route(p, x, cfg, stats)
    dispatch, combine = _local_experts(cfg, dispatch, combine)
    dd = dispatch.to(x.dtype)
    if _split_ffn(cfg):  # the experts' input; the router read xg whole
        xg = comm.copy_to_model(xg)
    xe = torch.einsum("gtec,gtd->gecd", dd, xg)
    h = _expert_hidden(p, xe, cfg, stats)
    stats.add_sparsity("down_in", h)
    ye = torch.einsum("gecf,efd->gecd", h, p["wd"])
    return _combine(cfg, combine, ye, x).reshape(x.shape[:-1] + (-1,))


def apply_moe_gathered(p, x, cfg: ModelConfig) -> torch.Tensor:
    """The grouped-gather lowering of ``apply_moe``: x (t, d) -> (t, d) in
    x's dtype, the same function through the expert gather kernels.

    ``_route`` decides the experts, gates and capacity drops. Each token's
    kept assignments, in routing order, list their experts' tiles
    (``expert_tile_lists`` with k_valid, tiles of ``ffn_gather_tile``);
    ``expert_up_matmul`` gives the compact hidden blocks, the activation
    and each assignment's gate apply in f32, and ``expert_down_matmul``
    sums the blocks against the routed experts' down-projection rows (an
    f32 compact, unrounded, against weights of any supported dtype). Only
    routed experts' weight tiles are read.

    It serves only as the expert gather kernels' entry point: no serving
    step calls it, as the reference's steps call no expert kernel. Whether
    the MoE step moves onto it waits on making those kernels fast (ROADMAP,
    kernel speed)."""
    t = x.shape[0]
    tile = cm.ffn_gather_tile(cfg)
    tpe = cfg.d_ff // tile
    _, dispatch, _, (_, _, cap), (topi, topv), _ = _route(p, x, cfg)
    topi, topv = topi.reshape(t, -1), topv.reshape(t, -1)
    kept = dispatch.reshape(t, cfg.n_experts, cap).any(-1).gather(1, topi)
    # kept assignments first, in routing order, so k_valid counts them
    order = torch.sort((~kept).to(torch.int8), dim=1, stable=True).indices
    topi = topi.gather(1, order)
    gates = (topv * kept).gather(1, order)
    idx, nvalid = ksm.expert_tile_lists(topi, tpe, kept.sum(1))
    act_fn = acts.get(cfg.activation, shift=cfg.sparsity.shift)
    xc = x.contiguous()
    glu = cfg.ffn_kind == "glu"
    h = act_fn(ksm.expert_up_matmul(xc, p["wg"] if glu else p["wu"], idx,
                                    nvalid, tile=tile))
    if glu:
        h = h * ksm.expert_up_matmul(xc, p["wu"], idx, nvalid, tile=tile)
    h = h * gates.repeat_interleave(tpe, 1)[:, :, None]
    return ksm.expert_down_matmul(h.contiguous(), p["wd"], idx,
                                  nvalid).to(x.dtype)


# ---------------------------------------------------------------------------
# blocks and the whole model


def moe_sublayer(p, x, cfg: ModelConfig,
                 stats: cm.StatsCollector = cm.NO_STATS):
    """The MoE half of a block: norm, (stage-2 ReLU), the MoE FFN over the
    b * s tokens. Returns the residual update (b, s, d) (the rank's
    d_model chunks under Megatron-SP residuals, as
    ``transformer.attn_sublayer``)."""
    h = T.post_norm(cm.apply_norm(p["ln2"], cm.sublayer_in(x), cfg), cfg)
    b, s, d = h.shape
    h = h.reshape(b * s, d)
    stats.add_raw("ffn_x", h)
    return apply_moe(p["moe"], h, cfg, stats).reshape(b, s, -1)


def apply_block(p, x, cfg: ModelConfig, positions,
                stats: cm.StatsCollector = cm.NO_STATS, sublayer=cm.call):
    """Full-sequence block (``transformer.forward``'s layer function):
    attention, then the MoE FFN over the b * s tokens. Returns (x, kv).
    ``sublayer`` runs each half, as in ``transformer.apply_block``."""
    a, kv = sublayer(T.attn_sublayer, p, x, cfg, positions, stats)
    x = x + a
    return x + sublayer(moe_sublayer, p, x, cfg, stats), kv


def apply_block_decode(p, x, cfg: ModelConfig, k_cache, v_cache, pos, *,
                       layer: int, stats: cm.StatsCollector = cm.NO_STATS):
    """One-token block over the contiguous cache: the dense family's
    attention (``transformer.apply_attn_decode``), then the MoE FFN."""
    h = T.post_norm(cm.apply_norm(p["ln1"], x[:, None], cfg)[:, 0], cfg)
    a, k_cache, v_cache = T.apply_attn_decode(
        p["attn"], h, cfg, k_cache, v_cache, pos, stats=stats, layer=layer)
    x = x + a
    h = T.post_norm(cm.apply_norm(p["ln2"], x[:, None], cfg)[:, 0], cfg)
    return x + apply_moe(p["moe"], h, cfg, stats), k_cache, v_cache


def model_forward(params, batch, cfg: ModelConfig, *, stats=cm.NO_STATS,
                  remat_policy: str = "none"):
    return T.forward(params, batch["tokens"], cfg, stats=stats,
                     block=cm.wrap_block(remat_policy, apply_block))


# ---------------------------------------------------------------------------
# legacy single-batch serving (the dense family's contiguous cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    return T.init_cache(cfg, batch, max_len, device=device)


def model_prefill(params, batch, cfg: ModelConfig, max_len: int, stats=cm.NO_STATS):
    return T.prefill(params, batch["tokens"], cfg, max_len, stats=stats,
                     block=apply_block)


def model_decode(params, cache, token, pos, cfg: ModelConfig, stats=cm.NO_STATS):
    """One legacy decode step (``transformer.decode_step``'s contract, no
    γ-window masks). An active ``stats`` is shared by every layer, as in
    the reference: each site keeps the last layer's value."""

    def layer_fn(p_i, i, x, kc, vc):
        return apply_block_decode(p_i, x, cfg, kc, vc, pos, stats=stats,
                                  layer=i)

    return T.decode_core(params, cache, token, pos, cfg, layer_fn)


# ---------------------------------------------------------------------------
# continuous-batching serving: the paged interface (capabilities
# paged_decode + chunked_prefill)
#
# Router top-k is structured activation sparsity at expert granularity: a
# token reads top_k / n_experts of the FFN weights before any within-expert
# γ-window masking applies, so the density telemetry composes both (density
# = expert fraction x within-expert effective density), and the engine's
# ``weight_io_bytes_per_step`` (density x the dense bytes of all experts)
# reports the activated-expert bytes.


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     device="cuda"):
    return cm.init_paged_cache(cfg, n_blocks, block_size, device=device)


def model_prefill_paged(params, batch, cfg: ModelConfig, pages, blocks,
                        block_size: int, true_len=None):
    """Whole-prompt prefill into freshly allocated pool blocks (the dense
    family's contract). The zero padding to a block multiple routes safely
    under drop-free capacity (module note)."""
    return T.prefill_paged(params, batch["tokens"], cfg, pages, blocks,
                           block_size=block_size, true_len=true_len,
                           block=apply_block)


def apply_moe_window(p, x, cfg: ModelConfig, *, mask, refresh, valid):
    """Decode MoE FFN over a W-token window with per-request γ-window reuse,
    batched over slots. x (b, W, d); mask (b, F) bool γ-window rows; refresh
    (b,); valid (b, W) real window tokens.

    Returns (out (b, W, d),
             act (b, F) within-expert activity unioned over valid tokens,
             scores (b, F // tile) window-union tile activity,
             density (b,) mean per-token fraction of expert FFN weights read
                 = routed-expert fraction x within-expert effective density,
             union_density (b,) fraction of the (E, F) expert-unit grid in
                 the window's read union)."""
    b, W, d = x.shape
    E, F = cfg.n_experts, mask.shape[-1]
    xg, dispatch, combine, (G, tg, _), _, own = _route(
        p, x.reshape(b * W, d), cfg)
    ldisp, lcomb = _local_experts(cfg, dispatch, combine)
    dd = ldisp.to(x.dtype)
    xe = torch.einsum("gtec,gtd->gecd", dd, xg)
    h = _expert_hidden(p, xe, cfg)

    # γ-window gate in expert-slot space: each slot's row is an exact copy of
    # its token's (drop-free), so gating here equals gating per token — and
    # is x1.0 (bit-exact) under refresh
    eff = mask | refresh[:, None]  # (b, F)
    eff_tok = torch.zeros((G * tg, F), dtype=h.dtype, device=h.device)
    eff_tok[own[0]:own[0] + own[1]] = eff[:, None, :].expand(
        b, W, F).reshape(b * W, F).to(h.dtype)
    h = h * torch.einsum("gtec,gtf->gecf", dd, eff_tok.reshape(G, tg, F))

    ye = torch.einsum("gecf,efd->gecd", h, p["wd"])
    out = _own_tokens(_combine(cfg, lcomb, ye, x), own).reshape(b, W, d)

    # telemetry: a token's within-expert activity unioned over its routed
    # experts (the slot-level γ-mask is shared across experts)
    ddf = ldisp.float()
    act_tok = torch.einsum("gtec,gecf->gtf", ddf, (h != 0).float())
    act_tok = (_own_tokens(act_tok, own).reshape(b, W, F) > 0) \
        & valid[:, :, None]
    act = act_tok.any(1)
    lay = cm.shard_layout(cfg)
    if lay is None or lay.experts[1] == E:
        scores = window_tile_activity(act_tok.float(), cm.ffn_gather_tile(cfg))
    else:
        # the other ranks' experts' activity: OR over the ranks, once a
        # layer; a tile's score is 1 where any of its units fired in the
        # window (the values window_tile_activity gives 0/1 activity)
        act = comm.any_reduce(act)
        tile = cm.ffn_gather_tile(cfg)
        scores = preds.units_to_tiles(act, tile).to(torch.float32)

    texp = _own_tokens(dispatch.any(3), own).reshape(b, W, E)  # its experts
    efrac = texp.float().mean(-1)  # (b, W)
    tok_density = efrac * eff.float().mean(-1)[:, None]
    vf = valid.float()
    density = (tok_density * vf).sum(1) / torch.clamp(vf.sum(1), min=1.0)
    read = (texp[:, :, :, None] & eff[:, None, None, :]
            & valid[:, :, None, None])  # (b, W, E, F)
    union_density = read.any(1).float().mean((1, 2))
    return out, act, scores, density, union_density


def apply_block_window_paged(p, x, cfg: ModelConfig, k_pages, v_pages, table,
                             pos, valid, *, layer: int, block_size: int, mask,
                             refresh, fast_kernels: Optional[bool] = None):
    h = T.post_norm(cm.apply_norm(p["ln1"], x, cfg), cfg)
    x = x + T.apply_attn_window_paged(
        p["attn"], h, cfg, k_pages, v_pages, table, pos, valid, layer=layer,
        block_size=block_size, fast_kernels=fast_kernels)
    h = T.post_norm(cm.apply_norm(p["ln2"], x, cfg), cfg)
    f, act, scores, density, udens = apply_moe_window(
        p["moe"], h, cfg, mask=mask, refresh=refresh, valid=valid)
    return x + f, k_pages, v_pages, act, scores, density, udens


def model_verify_window_paged(params, pages, table, tokens, pos0, wlen,
                              cfg: ModelConfig, ffn_masks, refresh,
                              block_size: int,
                              fast_kernels: Optional[bool] = None):
    """A W-token window per slot over the shared pool (the dense family's
    ``verify_window_paged`` contract; the aux densities are the
    expert-weighted fractions of ``apply_moe_window``). On CUDA tensors the
    attention runs the ``paged_window_attention`` kernel."""

    def layer_fn(pl_i, li, x, kp, vp, fm, pos, valid):
        x, kp, vp, act, scores, density, udens = apply_block_window_paged(
            pl_i, x, cfg, kp, vp, table, pos, valid, layer=li,
            block_size=block_size, mask=fm, refresh=refresh,
            fast_kernels=fast_kernels)
        return x, kp, vp, (act, scores, density, udens)

    return sp.window_step_core(params, pages, tokens, pos0, wlen, cfg,
                               ffn_masks, refresh, layer_fn=layer_fn,
                               embed_fn=T.embed_tokens,
                               logits_fn=T.logits_from)


def model_prefill_chunk_paged(params, batch, cfg: ModelConfig, pages, table,
                              pos0, clen, ffn_masks, refresh,
                              block_size: int,
                              fast_kernels: Optional[bool] = None):
    """One fixed-shape prefill chunk is a window step: chunk tokens write
    K/V at their own positions, tokens past clen go to the scratch block,
    and the window's union activity seeds the warm γ-mask."""
    return model_verify_window_paged(params, pages, table, batch["tokens"],
                                     pos0, clen, cfg, ffn_masks, refresh,
                                     block_size, fast_kernels=fast_kernels)


def model_decode_paged(params, pages, table, token, pos, cfg: ModelConfig,
                       ffn_masks, refresh, block_size: int,
                       fast_kernels: Optional[bool] = None):
    """Continuous-batching decode: the W = 1 window step, as in the
    reference (the MoE family has no separate decode lowering). Returns
    (logits (b, vocab_p), pages, new_masks, (act, scores, density))."""
    logits, pages, new_masks, (act, scores, density, _) = \
        model_verify_window_paged(params, pages, table, token[:, None], pos,
                                  torch.ones_like(pos), cfg, ffn_masks,
                                  refresh, block_size,
                                  fast_kernels=fast_kernels)
    return logits[:, 0], pages, new_masks, (act, scores, density)
