"""Analytic FLOPs / IO accounting (paper Table 1, Fig. 1c, App. B/E + the
roofline MODEL_FLOPS term) — a copy of the reference's ``core/flops.py``,
kept apart so the port imports nothing of the JAX package. The training
phase of ``chip_smoke.py`` reads ``model_flops`` for its MFU.

The paper counts MACs per token ("6.6G FLOPS" for OPT-6.7B is the forward
MAC count of the non-embedding weights). `macs_per_token` reproduces their
Table-1 numbers exactly when fed the measured sparsity levels; see
benchmarks/table1_flops.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class SparsityLevels:
    """Measured input sparsity per projection site (paper Table 1 columns)."""
    qkv: float = 0.0   # attention input sparsity (stage 2)
    up: float = 0.0    # FFN up/gate input sparsity (stage 2)
    down: float = 0.0  # down-projection input sparsity (stage 1, the big one)


def _attn_macs(cfg: ModelConfig, context: int) -> float:
    """Per-token attention score+value MACs at a given context length."""
    hd = cfg.resolved_head_dim
    ctx = min(context, cfg.sliding_window) if cfg.sliding_window else context
    return 2.0 * cfg.n_heads * hd * ctx


def macs_per_token(cfg: ModelConfig, sp: Optional[SparsityLevels] = None,
                   context: int = 0, include_unembed: bool = False) -> float:
    """Forward MACs per generated token (the paper's "FLOPS" metric)."""
    sp = sp or SparsityLevels()
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    total = 0.0
    n_attn_layers = cfg.n_layers
    if cfg.family == "hybrid" and cfg.attn_every:
        n_attn_layers = cfg.n_layers // cfg.attn_every

    if cfg.family in ("dense", "vlm", "moe", "encdec", "hybrid"):
        qkv = d * (H + 2 * K) * hd * (1.0 - sp.qkv)
        out = H * hd * d
        if cfg.ffn_kind == "glu":
            # gate computed for all rows (input sparsity only); the UP
            # projection is additionally skipped wherever relu(gate)==0
            # (its product with a zero gate is never needed) — this is how
            # the paper reaches 4.8 G for Llama stage 1.
            per_ffn_in = d * F * (1.0 - sp.up) * (1.0 + (1.0 - sp.down))
        else:
            per_ffn_in = d * F * (1.0 - sp.up)
        per_ffn_down = F * d * (1.0 - sp.down)
        if cfg.family == "moe":
            ffn = cfg.top_k * (per_ffn_in + per_ffn_down) + d * cfg.n_experts
        else:
            ffn = per_ffn_in + per_ffn_down
        attn = _attn_macs(cfg, context) if context else 0.0
        total += n_attn_layers * (qkv + out + attn)
        total += cfg.n_layers * ffn if cfg.family != "hybrid" else cfg.n_layers * 0.0

    if cfg.family in ("mamba", "hybrid"):
        di, st = cfg.d_inner, cfg.ssm_state
        in_proj = d * 2 * di * (1.0 - sp.qkv)
        conv = di * cfg.ssm_conv
        if cfg.family == "mamba":  # mamba1: x_proj -> (dt_rank, B, C)
            dt_rank = max(1, d // 16)
            proj = di * (dt_rank + 2 * st) + dt_rank * di
        else:  # mamba2 (SSD): B/C/dt from in_proj extension
            proj = di * 2 * st
        scan = 3.0 * di * st  # state update + output contraction
        out_p = di * d * (1.0 - sp.down)  # gate sparsity -> sparse out_proj
        n_ssm = cfg.n_layers
        total += n_ssm * (in_proj + conv + proj + scan + out_p)
        if cfg.family == "hybrid":  # shared attention block incl. its FFN
            per_ffn = (2 if cfg.ffn_kind == "glu" else 1) * d * F * (1.0 - sp.up) \
                + F * d * (1.0 - sp.down)
            total += n_attn_layers * per_ffn

    if include_unembed:
        total += d * cfg.vocab_size
    return total


def param_count(cfg: ModelConfig, active_only: bool = False) -> float:
    """Non-embedding parameter count (active experts only if requested)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    attn = d * (H + 2 * K) * hd + H * hd * d
    ffn1 = (3 if cfg.ffn_kind == "glu" else 2) * d * F
    n = 0.0
    if cfg.family in ("dense", "vlm"):
        n = cfg.n_layers * (attn + ffn1)
    elif cfg.family == "encdec":
        n = (cfg.n_layers + cfg.n_encoder_layers) * (attn + ffn1) \
            + cfg.n_layers * attn  # cross-attention
    elif cfg.family == "moe":
        e = cfg.top_k if active_only else cfg.n_experts
        n = cfg.n_layers * (attn + e * ffn1 + d * cfg.n_experts)
    elif cfg.family == "mamba":
        di, st = cfg.d_inner, cfg.ssm_state
        dt_rank = max(1, d // 16)
        per = d * 2 * di + di * cfg.ssm_conv + di * (dt_rank + 2 * st) \
            + dt_rank * di + di * st + di * d
        n = cfg.n_layers * per
    elif cfg.family == "hybrid":
        di, st = cfg.d_inner, cfg.ssm_state
        per = d * 2 * di + di * cfg.ssm_conv + di * 2 * st + di * d
        n = cfg.n_layers * per
        if cfg.attn_every:
            n += attn + ffn1  # ONE shared block
    return n


def embed_params(cfg: ModelConfig) -> float:
    mult = 1 if cfg.tie_embeddings else 2
    return mult * cfg.vocab_size * cfg.d_model


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global useful FLOPs for one step of this cell: 6·N·D train, 2·N·D
    serve (N = active non-embed params; D = tokens processed), plus exact
    attention-context FLOPs."""
    N = param_count(cfg, active_only=True)
    B, S = shape.global_batch, shape.seq_len
    n_attn = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
              else 0 if cfg.family == "mamba" else cfg.n_layers)
    # per-token attention MACs at average causal context S/2
    attn = 2.0 * n_attn * cfg.n_heads * cfg.resolved_head_dim * (S / 2)
    if shape.kind == "train":
        tokens = B * S
        return 6.0 * (N + attn) * tokens
    if shape.kind == "prefill":
        tokens = B * S
        return 2.0 * (N + attn) * tokens
    # decode: one token per sequence, full-context attention reads
    macs = macs_per_token(cfg, context=S, include_unembed=True)
    return 2.0 * macs * B


# ---------------------------------------------------------------------------
# paper Table 1 reproduction helpers


def table1_row(cfg: ModelConfig, sp: SparsityLevels) -> Dict[str, float]:
    """MACs/token in G, as the paper reports (no attention-context term —
    their per-token figure counts weight MACs only)."""
    g = macs_per_token(cfg, sp) / 1e9
    dense = macs_per_token(cfg, SparsityLevels()) / 1e9
    return {"gmacs": round(g, 2), "dense_gmacs": round(dense, 2),
            "saving": round(1.0 - g / dense, 3)}
