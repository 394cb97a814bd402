"""Mamba-1 family (falcon-mamba-7b), in PyTorch — the reference's
``models/mamba.py``: an attention-free selective SSM.

The full sequence (forward, prefill) runs the selective scan as a
log-depth doubling over the sequence (Hillis-Steele: ceil(log2 s) steps
of ``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)`` over (b, s, d_inner,
ssm_state) in f32), where the reference runs ``lax.associative_scan``:
the same recurrence, its f32 sums in another order. Decode is the O(1)
recurrence with the SSM state and a conv ring buffer of the last
``ssm_conv - 1`` pre-activation conv inputs in the cache, both updated in
place. The scans are plain torch ops, as the reference's are XLA.

Relufication: mamba has no FFN, but the gate non-linearity (SiLU on z)
plays its role: ``act`` applies to the conv output and to the gate, so
``relufy_stage1`` makes the out_proj input sparse, and at static tile
capacities the decode step's out_proj gathers its input's top tiles
(``common.maybe_sparse_matmul``, kernel 5 on the card). Stage 2 adds ReLU
after the block's norm.

Parameters: per layer ``norm`` and ``ssm`` = {``in_proj`` (d, 2 di),
``conv_w`` (k, di), ``conv_b``, ``x_proj`` (di, dt_rank + 2 st),
``dt_proj`` (dt_rank, di), ``dt_bias``, ``A_log`` (di, st), ``D``,
``out_proj`` (di, d)}, stacked on a leading layer axis.

Under a mesh (``sharding.comm.serving``: the legacy engine's ``mesh=``,
the FSDP step's train mode) each rank holds the d_inner units
``common.ShardLayout.inner`` of every SSM leaf (``common.leaf_sharding``:
``in_proj``'s x1 and z columns, ``conv_*``, ``x_proj``'s rows,
``dt_proj``'s columns, ``dt_bias``, ``A_log``'s rows, ``D``,
``out_proj``'s rows) and computes the conv and the selective scan, which
are elementwise in d_inner, on its units alone. ``x_proj`` over its rows
gives f32 partials of (dt_rank + 2 st) columns, summed over "model" once
a layer (``common.model_sum``: their gradient summed too, since every
rank's units read all of it); ``out_proj`` over its rows is a partial
sum too (``common.sublayer_sum``, Megatron-SP residuals included: the
block input is put together before the norm, ``common.sublayer_in``).
The caches hold the rank's units.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as nnf

from repro_torch.configs.base import ModelConfig
from repro_torch.core import activations as acts
from repro_torch.models import common as cm
from repro_torch.models import transformer as T
from repro_torch.sharding import comm


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def init_ssm(cfg: ModelConfig, ini: cm.ParamInit, n: Optional[int] = None):
    d, di, st, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dr = dt_rank(cfg)
    lead = () if n is None else (n,)
    A = torch.arange(1, st + 1, dtype=torch.float32, device=ini.device)
    return {
        "in_proj": ini.stack(n, lambda: ini.dense((d, 2 * di), d)),
        "conv_w": ini.stack(n, lambda: ini.dense((k, di), k)),
        "conv_b": ini.full(lead + (di,), 0.0),
        "x_proj": ini.stack(n, lambda: ini.dense((di, dr + 2 * st), di)),
        "dt_proj": ini.stack(n, lambda: ini.dense((dr, di), dr)),
        "dt_bias": ini.full(lead + (di,), -4.6),  # softplus^-1(0.01)
        "A_log": torch.log(A).expand(lead + (di, st)).to(ini.dtype).clone(),
        "D": ini.full(lead + (di,), 1.0),
        "out_proj": ini.stack(n, lambda: ini.dense((di, d), di)),
    }


def init_block(cfg: ModelConfig, ini: cm.ParamInit, n: Optional[int] = None):
    return {"norm": ini.norm(cfg, n), "ssm": init_ssm(cfg, ini, n)}


def _causal_conv(x, w, b):
    """Depthwise causal conv by k shifted adds. x (b, s, di); w (k, di)."""
    k = w.shape[0]
    out = x * w[k - 1]
    for i in range(1, k):
        shifted = nnf.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[k - 1 - i]
    return out + b


def _ssm_inputs(p, h_in, cfg: ModelConfig):
    """in_proj, split into the conv branch x1 and the gate z (under a mesh
    the rank's units of each: its in_proj block packs [x1 | z]); the
    gate's activation."""
    act = acts.get(cfg.activation, shift=cfg.sparsity.shift)
    if cm.shard_layout(cfg) is not None:
        h_in = comm.copy_to_model(h_in)
    x1, z = (h_in @ p["in_proj"]).chunk(2, dim=-1)
    return x1, z, act


def _norm_in(p, x, cfg: ModelConfig):
    h_in = cm.apply_norm(p["norm"], x, cfg)
    return torch.relu(h_in) if cfg.post_norm_relu else h_in  # stage 2


def _dt_B_C(p, x1, cfg: ModelConfig):
    """x_proj -> (dt (softplus over dt_proj), B, C) and A = -exp(A_log).
    Under a mesh x1 and x_proj's rows are the rank's units: the product is
    summed over the ranks in f32 and cast once (``common.model_sum``)."""
    dr, st = dt_rank(cfg), cfg.ssm_state
    if cm.shard_layout(cfg) is None:
        u = x1 @ p["x_proj"]
    else:
        u = cm.model_sum(cm.partial_matmul(x1, p["x_proj"])).to(x1.dtype)
    dtr, B, C = u.split([dr, st, st], dim=-1)
    dt = nnf.softplus(dtr @ p["dt_proj"] + p["dt_bias"])
    return dt, B, C, -torch.exp(p["A_log"].float())


def _out_proj(y, w, cfg: ModelConfig, density: float = 1.0):
    """y (t, di) @ out_proj at the static capacity ``density``
    (``common.maybe_sparse_matmul``); under a mesh the ranks' f32 partials
    over their units (``common.rows_partial``: one device's selection)
    summed (``common.sublayer_sum``)."""
    lay = cm.shard_layout(cfg)
    if lay is None:
        return cm.maybe_sparse_matmul(y, w, cfg, density)
    return cm.sublayer_sum(cm.rows_partial(y, w, cfg, density, lay.inner[0],
                                           cfg.d_inner, lay.tp), y.dtype)


def selective_scan(dA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    """h_t = dA_t h_{t-1} + dBx_t from h_{-1} = 0, over axis 1, for every
    t: a Hillis-Steele doubling (ceil(log2 s) steps). dA, dBx (b, s, ...)
    f32."""
    a, h = dA, dBx
    s, step = a.shape[1], 1
    while step < s:
        h = torch.cat([h[:, :step], a[:, step:] * h[:, :-step] + h[:, step:]], 1)
        if 2 * step < s:
            a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], 1)
        step *= 2
    return h


def _scan_block(p, x, cfg: ModelConfig, stats: cm.StatsCollector,
                record: bool):
    """The block's full-sequence math. Returns (out (b, s, d), hs
    (b, s, di, st) f32, x1 (b, s, di) the pre-activation conv inputs).
    ``record``: the forward's statistics (qkv_in, gate_pre, down_in);
    prefill records none, as the reference's."""
    b, s = x.shape[:2]
    ps = p["ssm"]
    h_in = _norm_in(p, cm.sublayer_in(x), cfg)
    if record:
        stats.add_sparsity("qkv_in", h_in)
    x1, z, act = _ssm_inputs(ps, h_in, cfg)
    x1c = act(_causal_conv(x1, ps["conv_w"], ps["conv_b"]))
    dt, B, C, A = _dt_B_C(ps, x1c, cfg)
    dA = torch.exp(dt.float()[..., None] * A)  # (b, s, di, st)
    dBx = (dt * x1c).float()[..., None] * B.float()[:, :, None, :]
    hs = selective_scan(dA, dBx)
    y = (hs.to(x1c.dtype) @ C[..., None])[..., 0] + ps["D"] * x1c
    g = act(z)
    if record:
        stats.add_preact("gate_pre", z)
    y = y * g
    if record:
        stats.add_sparsity("down_in", y)
    out = _out_proj(y.reshape(b * s, -1), ps["out_proj"], cfg)
    return x + out.reshape(b, s, -1), hs, x1


def _block(p, x, cfg: ModelConfig, positions, stats):
    return _scan_block(p, x, cfg, stats, record=True)[0]


def apply_block(p, x, cfg: ModelConfig, positions,
                stats: cm.StatsCollector = cm.NO_STATS, sublayer=cm.call):
    """Full-sequence block (the family's layer function under
    ``common.wrap_block``): x (b, s, d) -> (x, None). The block is one
    sublayer: "save_ars" checkpoints it whole, as the reference's names no
    ``attn_out`` / ``ffn_out`` in it and saves nothing there."""
    return sublayer(_block, p, x, cfg, positions, stats), None


def apply_block_decode(p, x, cfg: ModelConfig, ssm_state, conv_state, *,
                       layer: int, stats: cm.StatsCollector = cm.NO_STATS):
    """One-token step of ``layer``. x (b, d); ssm_state (L, b, di, st);
    conv_state (L, b, k - 1, di), both written in place. The out_proj runs
    at the static FFN tile capacity (kernel 5 on the card). Returns
    (x, ssm_state, conv_state)."""
    ps = p["ssm"]
    h_in = _norm_in(p, x[:, None], cfg)[:, 0]
    x1, z, act = _ssm_inputs(ps, h_in, cfg)
    win = torch.cat([conv_state[layer], x1[:, None]], dim=1)  # (b, k, di)
    x1 = act((win * ps["conv_w"]).sum(1) + ps["conv_b"])
    conv_state[layer] = win[:, 1:]
    dt, B, C, A = _dt_B_C(ps, x1, cfg)
    dA = torch.exp(dt.float()[..., None] * A)  # (b, di, st)
    dBx = (dt * x1).float()[..., None] * B.float()[:, None, :]
    h_new = dA * ssm_state[layer].float() + dBx
    ssm_state[layer] = h_new.to(ssm_state.dtype)
    y = (h_new.to(x1.dtype) @ C[..., None])[..., 0] + ps["D"] * x1
    stats.add_preact("gate_pre", z)
    y = y * act(z)
    stats.add_sparsity("down_in", y)
    out = _out_proj(y, ps["out_proj"], cfg, T.densities(cfg)[1])
    return x + out, ssm_state, conv_state


# ---------------------------------------------------------------------------
# family interface


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None):
    """Random parameters on ``device`` from a seeded torch.Generator, with
    the reference's scaling and SSM init (A = 1..st, dt_bias
    softplus^-1(0.01), D = 1); untied embeddings."""
    device = cm.resolve_device(device)
    ini = cm.ParamInit(seed, device, dtype or T.compute_dtype(cfg))
    vp = cm.padded_vocab(cfg.vocab_size)
    layers = init_block(cfg, ini, cfg.n_layers)
    return {"embed": ini.embed((vp, cfg.d_model)), "layers": layers,
            "final_norm": ini.norm(cfg),
            "unembed": ini.embed((vp, cfg.d_model))}


def _embed(params, tokens, cfg: ModelConfig):
    """Token embeddings (b, s, d) in the compute dtype, and the positions."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    return T.embed_tokens(params, tokens, cfg, positions), positions


def model_forward(params, batch, cfg: ModelConfig, *, stats=cm.NO_STATS,
                  remat_policy: str = "none"):
    """Logits (b, s, vocab_p). An active ``stats`` collects each layer's
    sites under ``layer{i}/``. A ``common.LayerSource`` in
    ``params["layers"]`` gives each layer just before its block (the FSDP
    step's gather); ``cfg.sp_residuals`` under a mesh keeps the residual
    split over "model" between the blocks, as ``transformer.forward``."""
    params = cm.cast_params(params, cfg)
    x, positions = _embed(params, batch["tokens"], cfg)
    block = cm.wrap_block(remat_policy, apply_block)
    layers = cm.unstack_layers(params["layers"], cfg.n_layers)
    sp = cm.sp_fits(cfg)
    with comm.sequence_parallel(sp):
        if sp:
            x = comm.split_last(x)
        for i in range(cfg.n_layers):
            sub = (cm.StatsCollector(True, raw=stats.raw) if stats.active
                   else stats)
            x, _ = block(layers[i], x, cfg, positions, sub)
            cm.release_layer(layers, i)
            if stats.active:
                for key, val in sub.stats.items():
                    stats.stats[f"layer{i}/{key}"] = val
        if sp:
            x = comm.all_gather_last(x, whole_grad=True)
    x = cm.apply_norm(params["final_norm"], x, cfg)
    return T.logits_from(params, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Zero {"ssm" (L, batch, di, st), "conv" (L, batch, k - 1, di)}: the
    recurrent state needs no max_len. Under a mesh di is the rank's
    units."""
    device = cm.resolve_device(device)
    dtype = dtype or T.compute_dtype(cfg)
    lay = cm.shard_layout(cfg)
    di = cfg.d_inner if lay is None else lay.inner[1]
    L, st, k = cfg.n_layers, cfg.ssm_state, cfg.ssm_conv
    return {"ssm": torch.zeros((L, batch, di, st), dtype=dtype, device=device),
            "conv": torch.zeros((L, batch, k - 1, di), dtype=dtype,
                                device=device)}


def conv_tail(x1: torch.Tensor, k: int) -> torch.Tensor:
    """A copy of the last k - 1 pre-activation conv inputs of x1
    (b, s, di), the decode ring buffer (a copy: a view would keep the
    whole sequence's x1 alive until the cache is built). A prompt shorter
    than k - 1 tokens raises: the reference stores a short tail there, on
    which its next decode step fails."""
    if x1.shape[1] < k - 1:
        raise ValueError(f"a prompt of {x1.shape[1]} tokens is shorter than "
                         f"the conv window's {k - 1} cached inputs")
    return x1[:, x1.shape[1] - (k - 1):].clone()


def model_prefill(params, batch, cfg: ModelConfig, max_len: int,
                  stats=cm.NO_STATS):
    """The prompt through the scan; the cache holds each layer's final
    SSM state and conv tail. Returns (last logits (b, vocab_p), cache).
    As in the reference, the out_proj is dense and no statistics are
    recorded."""
    params = cm.cast_params(params, cfg)
    cdt = T.compute_dtype(cfg)
    x, _ = _embed(params, batch["tokens"], cfg)
    hs, convs = [], []
    for p_i in cm.unstack_layers(params["layers"], cfg.n_layers):
        x, h, x1 = _scan_block(p_i, x, cfg, stats, record=False)
        # copies: a view of the last step would keep the layer's whole
        # (b, s, di, st) f32 scan alive
        hs.append(h[:, -1].to(cdt, copy=True))
        convs.append(conv_tail(x1, cfg.ssm_conv).to(cdt))
        del h, x1  # freed before the next layer's scan, not after it
    x = cm.apply_norm(params["final_norm"], x, cfg)
    logits = T.logits_from(params, x[:, -1:], cfg)
    return logits[:, -1], {"ssm": torch.stack(hs), "conv": torch.stack(convs)}


def model_decode(params, cache, token, pos, cfg: ModelConfig,
                 stats=cm.NO_STATS):
    """One decode step; the cache is updated in place. An active ``stats``
    is shared by every layer, as in the reference (each site keeps the last
    layer's value). Returns (logits (b, vocab_p), cache)."""
    params = cm.cast_params(params, cfg)
    x = T.embed_tokens(params, token[:, None], cfg, pos[:, None])[:, 0]
    ssm, conv = cache["ssm"], cache["conv"]
    for i in range(cfg.n_layers):
        x, ssm, conv = apply_block_decode(cm.layer_params(params, i), x, cfg,
                                          ssm, conv, layer=i, stats=stats)
    x = cm.apply_norm(params["final_norm"], x[:, None], cfg)[:, 0]
    return T.logits_from(params, x, cfg), {"ssm": ssm, "conv": conv}
