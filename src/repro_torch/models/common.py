"""Shared model components of the PyTorch port — the reference's
``models/common.py``: norms, RoPE, head padding, attention, the paged
cache, the paper's static-capacity tile gathers, the statistics collector,
and the training helpers (the f32 master cast ``cast_params``, the
per-layer split ``unstack_layers`` and the remat policies ``wrap_block``).

Layouts are the reference's, so tests compare like with like: attention
queries in the per-group padded layout ``(b, s, kvp, g, hd)``, caches
head-major, the paged pool ``(L, n_blocks, kvp, block_size, hd)``.

Where the reference returns a new array (``pages.at[...].set``), the paged
writes here update the pool IN PLACE (``index_put_`` through indexing
assignment) and return the same tensor: a production pool fills most of the
card and must never be copied per token.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import comm
from repro_torch.sharding import rules
from repro_torch.tree import flatten, unflatten

# ---------------------------------------------------------------------------
# init helpers (torch.Generator; the numbers differ from jax.random's)


def dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
               device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


class ParamInit:
    """A seeded parameter maker on ``device``: one torch.Generator whose
    draws follow the call order, with the reference's scaling. A family's
    init builds its tree leaf by leaf through it; ``stack(n, make)`` fills
    an (n, ...) layer-stacked leaf one layer at a time, so a full-width
    model never holds a second f32 copy. On the "meta" device it makes
    the leaves' shapes and dtypes only (no storage, no draws)."""

    def __init__(self, seed: int, device, dtype):
        self.device, self.dtype = device, dtype
        gen_device = "cpu" if torch.device(device).type == "meta" else device
        self.gen = torch.Generator(device=gen_device).manual_seed(seed)

    def dense(self, shape, fan_in: int) -> torch.Tensor:
        return dense_init(self.gen, shape, fan_in, self.dtype, self.device)

    def embed(self, shape) -> torch.Tensor:
        return embed_init(self.gen, shape, self.dtype, self.device)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def stack(self, n: Optional[int], make: Callable) -> torch.Tensor:
        """``make()`` drawn n times into one (n, ...) leaf; None: one
        unstacked ``make()``."""
        if n is None:
            return make()
        first = make()
        out = torch.empty((n,) + tuple(first.shape), dtype=first.dtype,
                          device=self.device)
        out[0] = first
        for i in range(1, n):
            out[i] = make()
        return out

    def norm(self, cfg: ModelConfig, n: Optional[int] = None) -> Dict:
        """A norm's params (scale ones, layernorm bias zeros), with an
        (n,) leading axis when n is given."""
        shape = ((n,) if n is not None else ()) + (cfg.d_model,)
        p = {"scale": self.full(shape, 1.0)}
        if cfg.norm_kind == "layernorm":
            p["bias"] = self.full(shape, 0.0)
        return p


# ---------------------------------------------------------------------------
# normalization


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # copied to the device once: a host-to-device copy per call would stall
    # the stream every layer
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)
    angles = positions[..., None].float() * freqs
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# padding geometry

TP = 16  # model-axis size of the reference's production mesh
VOCAB_MULTIPLE = 2048


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class HeadGeometry:
    """Padded GQA/MHA layout (the reference's ``HeadGeometry``): q heads are
    padded to a multiple of TP in a per-group layout; MHA pads kv heads
    alongside. Padded slots hold zero weights and are masked after
    attention, so the math is exactly GQA."""

    def __init__(self, n_heads: int, n_kv: int, head_dim: int, tp: int = TP):
        self.n_heads = n_heads
        self.head_dim = head_dim
        self.hp = round_up(n_heads, tp)
        if n_kv == n_heads:  # MHA: pad kv alongside q
            self.kvp = self.hp
            self.group = 1
            self.real_per_group = 1
        else:
            if self.hp % n_kv:
                raise ValueError(f"padded heads {self.hp} not divisible by "
                                 f"{n_kv} kv heads")
            self.kvp = n_kv
            self.group = self.hp // n_kv
            self.real_per_group = n_heads // n_kv
        self.n_kv = n_kv

    def q_slot_mask(self, device=None, dtype=torch.float32) -> torch.Tensor:
        """(hp,) 1 for real q-head slots in the per-group padded layout,
        made on ``device`` (no host-to-device copy in the step)."""
        j = torch.arange(self.hp, device=device)
        real = (j < self.n_heads) if self.group == 1 else (
            j % self.group < self.real_per_group)
        return real.to(dtype)

    def q_slot_index(self) -> np.ndarray:
        """Padded slot of each real head h = k*r + j -> k*g + j."""
        h = np.arange(self.n_heads)
        if self.group == 1:
            return h
        return (h // self.real_per_group) * self.group + h % self.real_per_group

    def scatter_q(self, w_real: torch.Tensor, axis: int) -> torch.Tensor:
        """Place a real-head-indexed tensor into the padded layout."""
        shape = list(w_real.shape)
        shape[axis] = self.hp
        out = w_real.new_zeros(shape)
        idx = torch.as_tensor(self.q_slot_index(), device=w_real.device)
        out.index_copy_(axis, idx, w_real)
        return out


def padded_vocab(vocab: int) -> int:
    return round_up(vocab, VOCAB_MULTIPLE)


def vocab_logit_mask(vocab: int, vocab_p: int, device=None,
                     offset: int = 0, width: Optional[int] = None
                     ) -> torch.Tensor:
    """0 for real vocabulary entries, -1e9 for the padding; with ``offset``
    / ``width`` the slice of one vocabulary shard."""
    ar = torch.arange(offset, offset + (vocab_p if width is None else width),
                      device=device)
    return torch.where(ar < vocab, 0.0, -1e9).float()


# ---------------------------------------------------------------------------
# tensor-parallel serving: what one rank of a (1, M) mesh holds


class LocalHeads:
    """One rank's share of a ``HeadGeometry`` (its duck type for the paged
    steps): ``hp`` q slots starting at global slot ``q0``, reading ``kvp``
    kv heads in groups of ``group`` slots, and the global slot mask's
    slice."""

    def __init__(self, g: HeadGeometry, q0: int, hp: int, kvp: int,
                 group: int):
        self.full, self.q0 = g, q0
        self.hp, self.kvp, self.group = hp, kvp, group
        self.head_dim = g.head_dim

    def q_slot_mask(self, device=None, dtype=torch.float32) -> torch.Tensor:
        return self.full.q_slot_mask(device, dtype)[self.q0:self.q0 + self.hp]


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where one rank of a (1, M) serving mesh sits in each split axis of a
    config's weights, read off the rules (``rules.param_pspec``) of the
    mode the weights were sharded in (``comm.mode``: "serve", or "train"
    for the FSDP step's model column, whose data-axis splits are gathered
    first): each pair is (first index, count) of the rank's block, the
    whole axis when the rule replicates it.

    q: padded q slots (``wq``'s heads, ``wo``'s rows). kv_split: how
    ``wk``/``wv`` are split — "heads" (column-split over kv heads, each
    rank's K/V its own heads), "embed" (row-split over d_model: K/V are
    summed over the ranks, the GQA case kvp < TP) or "none"; kv: the kv
    heads this rank's q slots read, the heads its paged pool keeps, with
    ``heads.group`` slots each (a rank whose slots are part of one group
    reads one head). Train mode never row-splits ``wk``/``wv``: where the
    kv heads do not divide M they are whole ("none"; their d_model rows go
    to "data"). d: d_model rows of row-split ``wk``/``wv``. vocab:
    embedding rows. ffn: d_ff units (``wu``/``wg`` columns, ``wd`` rows,
    the γ-masks). experts: MoE experts. inner: the SSM's d_inner units
    (Mamba-1's, or the units of Mamba-2's heads); ssm_heads: Mamba-2's
    heads. These two come from the family's blocks (``leaf_sharding``),
    not the rules: every SSM leaf is cut by the rank's units or heads."""

    tp: int
    q: tuple
    kv_split: str
    kv: tuple
    d: tuple
    vocab: tuple
    ffn: tuple
    experts: tuple
    d_ff: int
    vocab_size: int
    heads: LocalHeads = dataclasses.field(compare=False)
    inner: tuple = (0, 0)
    ssm_heads: tuple = (0, 0)

    @property
    def q_split(self) -> bool:
        return self.q[1] < self.heads.full.hp

    @property
    def vocab_split(self) -> bool:
        return self.vocab[1] < padded_vocab(self.vocab_size)

    @property
    def ffn_split(self) -> bool:
        """d_ff split over the ranks: FFN activity, masks and their
        statistics are per-rank slices."""
        return self.ffn[1] < self.d_ff


@functools.lru_cache(maxsize=None)
def _layout(cfg: ModelConfig, tp: int, rank: int,
            mode: str = "serve") -> ShardLayout:
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(shape={"data": 1, "model": tp},
                coords={"data": 0, "model": rank})
    g = HeadGeometry(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    L, d, hd = cfg.n_layers, cfg.d_model, g.head_dim

    def split(path, shape, dim):
        return rules.param_pspec(path, shape, mesh, mode)[dim] == "model"

    def block(n, is_split):
        return (rank * (n // tp), n // tp) if is_split else (0, n)

    q0, hq = block(g.hp, split("layers/attn/wq", (L, d, g.hp, hd), 2))
    kshape = (L, d, g.kvp, hd)
    kv_split = ("heads" if split("layers/attn/wk", kshape, 2) else
                "embed" if split("layers/attn/wk", kshape, 1) else "none")
    if kv_split == "heads":
        kv, group = block(g.kvp, True), g.group
    elif hq == g.hp:
        kv, group = (0, g.kvp), g.group
    elif hq % g.group == 0:
        kv, group = (q0 // g.group, hq // g.group), g.group
    elif g.group % hq == 0:
        kv, group = (q0 // g.group, 1), hq
    else:
        raise NotImplementedError(
            f"{cfg.name} at TP={tp}: {hq} q slots a rank straddle its "
            f"groups of {g.group} slots per kv head")
    vp = padded_vocab(cfg.vocab_size)
    inner, ssm_heads = _ssm_blocks(cfg, tp, rank)
    F = cfg.d_ff
    if cfg.n_experts:
        wshape = (L, cfg.n_experts, d, F)
        experts = block(cfg.n_experts, split("layers/moe/wu", wshape, 1))
        ffn = block(F, split("layers/moe/wu", wshape, 3))
    else:
        experts = (0, 0)
        ffn = block(F, bool(F) and split("layers/ffn/wu", (L, d, F), 2))
    return ShardLayout(
        tp=tp, q=(q0, hq), kv_split=kv_split, kv=kv,
        d=block(d, kv_split == "embed"),
        vocab=block(vp, split("embed", (vp, d), 0)),
        ffn=ffn, experts=experts, d_ff=F, vocab_size=cfg.vocab_size,
        heads=LocalHeads(g, q0, hq, kv[1], group), inner=inner,
        ssm_heads=ssm_heads)


def _ssm_blocks(cfg: ModelConfig, tp: int, rank: int):
    """(inner, ssm_heads) of ``ShardLayout``: Mamba-1 splits its d_inner
    units, Mamba-2 its heads (and their units) over the M ranks; a count
    that M does not divide raises. Other families: (0, 0) each."""
    if cfg.family == "mamba":
        di = cfg.d_inner
        if di % tp:
            raise NotImplementedError(
                f"{cfg.name} at TP={tp}: d_inner {di} does not split over "
                "the 'model' axis")
        return (rank * (di // tp), di // tp), (0, 0)
    if cfg.family == "hybrid":
        nh, hd = cfg.n_ssm_heads, cfg.ssm_head_dim
        if nh % tp:
            raise NotImplementedError(
                f"{cfg.name} at TP={tp}: {nh} SSM heads do not split over "
                "the 'model' axis")
        h0, hl = rank * (nh // tp), nh // tp
        return (h0 * hd, hl * hd), (h0, hl)
    return (0, 0), (0, 0)


# the SSM leaves a family splits apart from the rules: leaf name -> the
# dim, counted from the end, that holds the rank's d_inner units or
# Mamba-2 heads; an in_proj packs segments (``_packed_in_proj``)
_SSM_DIMS = {
    "mamba": {"in_proj": -1, "conv_w": -1, "conv_b": -1, "x_proj": -2,
              "dt_proj": -1, "dt_bias": -1, "A_log": -2, "D": -1,
              "out_proj": -2},
    "hybrid": {"in_proj": -1, "conv_w": -1, "conv_b": -1, "gnorm": -1,
               "A_log": -1, "D": -1, "dt_bias": -1, "out_proj": -2},
}


def _packed_in_proj(cfg: ModelConfig):
    """The (size, split) segments of an SSM ``in_proj``'s columns: Mamba-1
    packs [x1 | z], each split by the rank's units; Mamba-2 packs [z | x |
    B | C | dt], z, x and dt split by its heads, B and C whole on every
    rank."""
    di = cfg.d_inner
    if cfg.family == "mamba":
        return ((di, True), (di, True))
    st, nh = cfg.ssm_state, cfg.n_ssm_heads
    return ((di, True), (di, True), (st, False), (st, False), (nh, True))


def leaf_sharding(cfg: ModelConfig, path: str, shape, mesh,
                  mode: str) -> rules.Sharding:
    """The ``rules.Sharding`` of ``cfg``'s leaf at ``path`` (whole
    ``shape``) on ``mesh`` in the rules' ``mode``: the rules'
    ``param_pspec``, except a ``layers/ssm/*`` leaf of the Mamba-1 and
    Zamba-2 families, whose spec has "model" moved to the dim of the
    rank's units or heads (``_SSM_DIMS``; the rules' other axes, "data" in
    training, kept), ``in_proj`` packed. The rules stay the reference's:
    where they split these leaves otherwise (``ssm/in_proj`` as one column
    block, Mamba-1's ``A_log`` over its state dim) or not at all
    (``x_proj``, ``dt_proj``, ``gnorm``), GSPMD reshards what a hand-split
    forward cannot. A split that the model axis does not divide raises
    (``_ssm_blocks``)."""
    spec = rules.param_pspec(path, tuple(shape), mesh, mode)
    parts = path.split("/")
    dims = _SSM_DIMS.get(cfg.family, {})
    if len(parts) < 2 or parts[-2] != "ssm" or parts[-1] not in dims:
        return rules.Sharding(mesh, spec)
    _ssm_blocks(cfg, rules.tp_size(mesh), 0)
    spec = [None if a == "model" else a for a in spec]
    dim = len(shape) + dims[parts[-1]]
    assert spec[dim] is None, (path, spec)
    spec[dim] = "model"
    packed = (dim, _packed_in_proj(cfg)) if parts[-1] == "in_proj" else None
    return rules.Sharding(mesh, tuple(spec), packed)


def _map_paths(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` of each leaf of a dict tree, in its structure and
    order (``path``: the keys joined by "/")."""
    out = {}
    for key, leaf in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out[key] = (_map_paths(fn, leaf, path) if isinstance(leaf, dict)
                    else fn(path, leaf))
    return out


def params_shardings(cfg: ModelConfig, params, mesh, mode: str):
    """A tree of ``rules.Sharding`` in ``params``' structure: each leaf's
    ``leaf_sharding`` by its path and whole shape (the reference's
    ``rules.params_shardings``)."""
    return _map_paths(lambda path, leaf: leaf_sharding(
        cfg, path, leaf.shape, mesh, mode), params)


def shard_params(cfg: ModelConfig, params, mesh, mode: str = "serve",
                 device=None):
    """This rank's blocks of ``cfg``'s parameter tree (``leaf_sharding``),
    on ``device`` (default: each leaf's own). Leaf by leaf: a leaf's block
    is copied out (contiguous, on ``device``) before the next leaf is
    touched, so a tree held on the host reaches the card one block at a
    time, and the caller can free the full tree as the blocks come."""
    def block(path, leaf):
        out = leaf_sharding(cfg, path, leaf.shape, mesh, mode).block(leaf)
        return out.to(device or leaf.device, copy=True).contiguous()

    return _map_paths(block, params)


def shard_layout(cfg: ModelConfig) -> Optional[ShardLayout]:
    """This rank's ``ShardLayout`` of ``cfg`` under the active serving mesh
    (``comm.serving``); None when no mesh is active."""
    mesh = comm.active()
    if mesh is None:
        return None
    return _layout(cfg, mesh.shape["model"], mesh.coords["model"],
                   comm.mode())


def local_heads(cfg: ModelConfig):
    """The head layout the paged steps run: the config's ``HeadGeometry``,
    or this rank's ``LocalHeads`` under a mesh."""
    lay = shard_layout(cfg)
    if lay is None:
        return HeadGeometry(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    return lay.heads


def local_d_ff(cfg: ModelConfig) -> int:
    """The d_ff units this rank's FFN weights and γ-masks hold."""
    lay = shard_layout(cfg)
    return cfg.d_ff if lay is None else lay.ffn[1]


def partial_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result, unrounded: a rank's partial of a product
    whose contraction is split over the ranks, summed in f32 before the one
    cast, as a single-device product rounds once. x (..., k), w (k, n).
    Under autograd, the f32 product of the upcast operands (the same
    value: the products of two bf16 are exact in f32), which autograd
    differentiates."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and not grad:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.reshape(x.shape[:-1] + (w.shape[1],))


def reduce_partial(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The ranks' f32 partials ``y`` summed and cast once to ``dtype``."""
    return comm.all_reduce_sum(y).to(dtype)


def model_sum(y: torch.Tensor) -> torch.Tensor:
    """The f32 sum over the model axis of the ranks' partials ``y``, read
    by computations split over the ranks (each rank's own units or heads
    use all of it): under autograd its gradient is summed over the ranks
    too (``comm.copy_to_model`` after ``comm.all_reduce_sum``)."""
    return comm.copy_to_model(comm.all_reduce_sum(y))


def rows_partial(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig,
                 density: float, start: int, total: int,
                 tp: int) -> torch.Tensor:
    """This rank's f32 partial of a product whose ``total`` contracted
    units are split over the ``tp`` ranks: x (t, n) and w (n, D) hold the
    units [start, start + n). At density 1 ``partial_matmul``; below it
    the static capacity's selection is one device's (``static_plan`` over
    all ``total`` units): each rank selects alone when every group lies in
    one rank's slice, else from the tile scores put together over the
    ranks (``rank_tile_scores``); then it runs its part of the list
    (``rank_tiles``) through ``gathered_matmul``, kernel 5 on the card."""
    if density >= 1.0:
        return partial_matmul(x, w)
    tile, groups = static_plan(total, cfg)
    if groups % tp == 0:
        idx, mask = select_active_tiles(batch_tile_scores(x, tile), density,
                                        groups // tp)
        start = 0  # the list is over this rank's units already
    else:
        idx, mask = select_active_tiles(
            rank_tile_scores(x, tile, start, total), density, groups)
    return gathered_matmul(x, w, *rank_tiles(idx, mask, tile, start,
                                             x.shape[1],
                                             cfg.sparsity.tile_size),
                           out_dtype=torch.float32)


def sublayer_sum(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A sublayer's output from the ranks' f32 partials ``y`` (..., d),
    cast once to ``dtype``: their sum (``reduce_partial``), or under
    Megatron-SP residuals (``comm.sp_on``) this rank's d_model chunk of it
    (``comm.reduce_scatter_last``)."""
    if comm.sp_on():
        return comm.reduce_scatter_last(y).to(dtype)
    return reduce_partial(y, dtype)


def sublayer_whole(y: torch.Tensor) -> torch.Tensor:
    """A sublayer's output computed whole on every rank: under Megatron-SP
    residuals this rank's d_model chunk (``comm.split_last``), else y."""
    return comm.split_last(y) if comm.sp_on() else y


def sublayer_in(x: torch.Tensor) -> torch.Tensor:
    """A sublayer's input: under Megatron-SP residuals the whole residual
    put together from the ranks' d_model chunks (``comm.all_gather_last``;
    its backward takes this rank's chunk, since the sublayer's
    ``copy_to_model`` has summed the ranks' partial gradients already),
    else x."""
    return comm.all_gather_last(x, whole_grad=True) if comm.sp_on() else x


def sp_fits(cfg: ModelConfig) -> bool:
    """Whether ``cfg.sp_residuals`` splits the residual here: a model axis
    of more than one rank is active and divides d_model."""
    mesh = comm.active()
    return (cfg.sp_residuals and mesh is not None
            and cfg.d_model % mesh.shape["model"] == 0)


_CACHE = threading.local()


def rank_cache_rows(max_len: int):
    """This rank's rows (s0, length) of a legacy contiguous K/V cache of
    ``max_len`` positions under the active mesh: length = max_len / M
    positions from s0 = model index x length (``rules.cache_pspec``'s
    sequence split); None without a mesh. Raises where M does not divide
    max_len."""
    mesh = comm.active()
    if mesh is None:
        return None
    n = mesh.shape["model"]
    if max_len % n:
        raise ValueError(f"max_len {max_len} does not split over the {n} "
                         "ranks of the model axis")
    return mesh.coords["model"] * (max_len // n), max_len // n


@contextlib.contextmanager
def cache_rows(rows):
    """Run a full-sequence forward whose returned K/V are the legacy
    contiguous cache's rows ``rows`` = (s0, length) of this rank of a
    model axis (positions s0 .. s0 + length - 1, zero past the prompt)
    with every kv head: the sequence-sharded layout of
    ``rules.cache_pspec`` (``rank_cache_rows``; ``transformer.prefill``
    under a mesh). None: the forward runs as it would."""
    prev = getattr(_CACHE, "rows", None)
    _CACHE.rows = rows
    try:
        yield
    finally:
        _CACHE.rows = prev


def cache_rows_active():
    """(s0, length) of ``cache_rows``, or None."""
    return getattr(_CACHE, "rows", None)


def take_rows(t: torch.Tensor, rows) -> torch.Tensor:
    """t (b, s, ...)'s positions rows = (s0, length), zero-padded past s."""
    s0, length = rows
    part = t[:, s0:s0 + length]
    pad = length - part.shape[1]
    if pad > 0:
        part = torch.cat([part, part.new_zeros((t.shape[0], pad)
                                               + tuple(t.shape[2:]))], 1)
    return part


def _largest_divisor_leq(n: int, cap: int) -> int:
    for c in range(min(cap, n), 0, -1):
        if n % c == 0:
            return c
    return 1


# ---------------------------------------------------------------------------
# attention


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """x rounded to ``dtype`` (the reference scales q by ``jnp.asarray(x,
    q.dtype)``), as a Python number: multiplying by it copies nothing to
    the device, so a step stays capturable in a CUDA graph."""
    return torch.tensor(x, dtype=dtype).item()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Exact attention as an online softmax over kv chunks, in plain torch
    ops (the reference's ``common.flash_attention``, same chunking and
    rounding placement: q scaled in its dtype, logits and PV accumulated in
    f32). q (b, s, kvp, g, d); k/v (b, skv, kvp, d). Returns q's shape and
    dtype."""
    b, s, kvp, g, d = q.shape
    skv = k.shape[1]
    q_chunk = _largest_divisor_leq(s, min(q_chunk, s))
    kv_chunk = _largest_divisor_leq(skv, min(kv_chunk, skv))
    scale = _in_dtype(1.0 / math.sqrt(d), q.dtype)
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, s, q_chunk):
        cq = q_chunk
        qi = (q[:, q0:q0 + cq] * scale).float()
        q_pos = q0 + q_offset + torch.arange(cq, device=q.device)
        hi = min(skv, q0 + q_offset + cq) if causal else skv
        lo = max(0, q0 + q_offset - window + 1) if window else 0
        lo = (lo // kv_chunk) * kv_chunk
        hi = min(skv, round_up(max(hi, lo + 1), kv_chunk))
        m = torch.full((b, kvp, g, cq), -1e30, device=q.device)
        l = torch.zeros((b, kvp, g, cq), device=q.device)
        acc = torch.zeros((b, kvp, g, cq, d), device=q.device)
        for b0 in range(lo, hi, kv_chunk):
            kj = kf[:, b0:b0 + kv_chunk]
            vj = vf[:, b0:b0 + kv_chunk]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj)
            kpos = b0 + torch.arange(kv_chunk, device=q.device)
            mask = torch.ones((cq, kv_chunk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos[None, :] <= q_pos[:, None]
            if window:
                mask &= kpos[None, :] > q_pos[:, None] - window
            logits = torch.where(mask, logits, -1e30)
            mj = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - mj[..., None])
            corr = torch.exp(m - mj)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype).float(), vj)
            acc = acc * corr[..., None] + pv
            m = mj
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4))  # (b, cq, kvp, g, d)
    return torch.cat(outs, dim=1).to(q.dtype)


def window_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Grouped attention of a W-token window over a head-major cache,
    causal within the window through ``pos``. q (b, W, kvp, g, d);
    k/v_cache (b, kvp, S, d); pos (b, W). Rounding as the reference: q
    scaled in its dtype, cast to the cache dtype, f32 accumulation, output
    in q's dtype."""
    b, W, kvp, g, d = q.shape
    S = k_cache.shape[2]
    qs = (q * _in_dtype(1.0 / math.sqrt(d), q.dtype)).to(k_cache.dtype)
    logits = torch.einsum("bqhgd,bhsd->bhgqs", qs.float(), k_cache.float())
    ar = torch.arange(S, device=q.device)
    valid = ar[None, None, :] <= pos[:, :, None]
    if window:
        valid &= ar[None, None, :] > pos[:, :, None] - window
    logits = torch.where(valid[:, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bhsd->bqhgd", w.to(k_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, window: int = 0):
    """Single-step grouped attention — ``window_attention`` at W = 1.
    q (b, kvp, g, d); pos (b,).

    Under an active mesh (``comm.active``) the caches are sequence-sharded
    as ``rules.cache_pspec`` lays them out: this rank's rows of the batch
    (q, pos and the caches hold them: b over "data") and its slice of S
    over "model", positions s0 .. s0 + S_l - 1 with s0 = model index ×
    S_l. Each rank takes the partial softmax of its keys at their global
    positions (``decode_partial``: acc, m and l; m = -1e30 and l = 0 where
    none of its keys is valid), the model row's partials are put together
    in rank order (one gather) and folded (``fold_partials``: kernel 2f on
    CUDA tensors, its plain version on CPU tensors). The result is the
    unsharded one up to the order of the f32 sums and, below f32, the
    rounding of p to the cache dtype before the division (the fold
    divides once, the unsharded softmax before p @ v)."""
    mesh = comm.active()
    if mesh is None:
        return window_attention(q[:, None], k_cache, v_cache, pos[:, None],
                                window)[:, 0]
    from repro_torch.kernels import paged_attention as kpa
    s0 = mesh.coords["model"] * k_cache.shape[2]
    part = decode_partial(q, k_cache, v_cache, pos, s0, window)
    parts = comm.model_gather([part[:, None]], mesh)[0]
    return kpa.fold_partials(parts.contiguous(), (0, q.shape[0]),
                             q.dtype)[:, 0]


def decode_partial(q, k_cache, v_cache, pos, s0: int,
                   window: int = 0) -> torch.Tensor:
    """One rank's partial of ``decode_attention`` over a cache slice that
    holds positions s0 .. s0 + S_l - 1: q (b, kvp, g, d), k/v_cache (b,
    kvp, S_l, d), pos (b,) global. Returns (b, kvp, g, d + 2) f32: acc, m,
    l (the partial mode's layout, ``paged_window_attention_partial``),
    with ``window_attention``'s rounding placement (q scaled in its dtype
    and cast to the cache's, p cast to it before p @ v, f32 sums)."""
    b, kvp, g, d = q.shape
    S = k_cache.shape[2]
    qs = (q * _in_dtype(1.0 / math.sqrt(d), q.dtype)).to(k_cache.dtype)
    logits = torch.einsum("bhgd,bhsd->bhgs", qs.float(), k_cache.float())
    ar = s0 + torch.arange(S, device=q.device)
    valid = ar[None, :] <= pos[:, None]
    if window:
        valid &= ar[None, :] > pos[:, None] - window
    valid = valid[:, None, None]
    logits = torch.where(valid, logits, -1e30)
    m = logits.amax(-1)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(k_cache.dtype).float(),
                       v_cache.float())
    return torch.cat([acc, m[..., None], p.sum(-1)[..., None]], -1)


# ---------------------------------------------------------------------------
# paged (block-table) KV cache
#
# Block 0 is reserved as a scratch block: idle batch slots and block-table
# padding point at it, so writes from inactive slots land harmlessly there.

SCRATCH_BLOCK = 0


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype=None, device="cuda") -> Dict[str, torch.Tensor]:
    """Block pool (L, n_blocks, kvp, block_size, hd), head-major within a
    block, zero-initialised; under a serving mesh kvp is the rank's kv
    heads (``ShardLayout.kv``)."""
    g = local_heads(cfg)
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    shape = (cfg.n_layers, n_blocks, g.kvp, block_size, g.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_gather(pages_l: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One layer's pool (n_blocks, kvp, bs, hd) through the block table
    (b, nb) -> per-request contiguous (b, kvp, nb*bs, hd)."""
    b, nb = table.shape
    _, kvp, bs, hd = pages_l.shape
    gath = pages_l[table.long()]  # (b, nb, kvp, bs, hd)
    return gath.permute(0, 2, 1, 3, 4).reshape(b, kvp, nb * bs, hd)


def paged_write_window(pages: torch.Tensor, layer: int, table: torch.Tensor,
                       pos: torch.Tensor, val: torch.Tensor, block_size: int,
                       enable: Optional[torch.Tensor] = None,
                       blocks: Optional[tuple] = None) -> torch.Tensor:
    """Scatter a W-token window's K or V per request through the block
    table, IN PLACE. pages (L, n_blocks, kvp, bs, hd); table (b, nb); pos
    (b, W); val (b, W, kvp, hd); enable (b, W) bool — disabled tokens go to
    the scratch block. Returns ``pages`` itself.

    Idle slots and disabled tokens may write the same scratch position.
    Each such write carries the value of the last of them in (b, W) order,
    which a serial scatter (the CPU's, the reference's) leaves there: a
    CUDA scatter keeps any one of them, and what the idle rows then read
    reaches the live rows wherever the batch is coupled (the union of a
    static tile capacity).

    ``blocks`` (b0, n): the pool holds global blocks b0 .. b0 + n - 1 only
    (one data row's range; the table holds global ids). The writes to
    them land at their local block, the others nowhere: each is sent to
    the entry of this rank's last write, carrying its value (or, with no
    write of this rank in the call, to local entry (0, 0) carrying what
    it holds), so every write to an entry carries one value and the
    scatter needs no host sync."""
    nb = table.shape[1]
    blk = torch.gather(table.long(), 1,
                       torch.clamp(pos.long() // block_size, 0, nb - 1))
    if enable is not None:
        blk = torch.where(enable, blk, torch.full_like(blk, SCRATCH_BLOCK))
    off = pos.long() % block_size
    n = blk.numel()
    # write i is entry bs + i, a scratch write the entry of its offset; the
    # largest i in an entry is the value every write to it carries
    own = torch.arange(block_size, block_size + n, device=blk.device)
    tgt = torch.where((blk == SCRATCH_BLOCK).reshape(-1), off.reshape(-1), own)
    writer = own
    if blocks is not None:
        b0, nloc = blocks
        mine = ((blk >= b0) & (blk < b0 + nloc)).reshape(-1)
        writer = torch.where(mine, own, -1)  # only this rank's writes count
    src = torch.empty(block_size + n, dtype=torch.long, device=blk.device
                      ).scatter_reduce_(0, tgt, writer, "amax",
                                        include_self=False)[tgt] - block_size
    val = val.reshape((n,) + val.shape[2:])
    if blocks is None:
        pages[layer][blk, :, off, :] = val[src].reshape(
            blk.shape + val.shape[1:]).to(pages.dtype)
        return pages
    blk, off = blk.reshape(-1) - b0, off.reshape(-1)
    last = torch.where(mine, torch.arange(n, device=blk.device), -1).max()
    has, a = last >= 0, last.clamp(min=0)
    blk = torch.where(mine, blk, torch.where(has, blk[a], 0))
    off = torch.where(mine, off, torch.where(has, off[a], 0))
    v = val[torch.where(mine, src, src[a].clamp(min=0))].to(pages.dtype)
    v = torch.where(has, v, pages[layer][0, :, 0, :][None])
    pages[layer][blk, :, off, :] = v
    return pages


def paged_attend(q, k, v, k_pages, v_pages, layer: int, table, pos, valid,
                 block_size: int, window: int, kernels: bool) -> torch.Tensor:
    """One layer's paged attention step: the window's K/V written into the
    pool (in place), then its attention. q (b, W, kvp, g, hd); k, v (b, W,
    kvp, hd); table (b, nb); pos (b, W) write positions, causal within the
    window; valid (b, W) bool, None for all (invalid tokens write the
    scratch block). ``kernels``: kernel 2 (``paged_window_attention``,
    its partial mode and the fold; their plain versions on CPU tensors),
    else the reference's frozen gather (the partial mode's and the fold's
    plain versions on a split pool). Returns o (b, W, kvp, g, hd) in q's
    dtype.

    Under a data split (``comm.data_split``): where the split cuts the
    batch, q, the new K/V, the table, positions and validity of the data
    column's slots are put together first, in global slot order (one
    gather). Every row writes the window rows whose blocks it holds
    (``paged_write_window(blocks=)``; all of them with the pool whole).
    With the pool whole each row then attends its own slots as one device
    would; with the pool split each row attends every slot against its
    own pages (``paged_window_attention_partial``), the rows' partials are
    put together (a second gather) and each row folds its slots' in data
    order (``fold_partials``): q and (m, l, acc) cross the data axis, never
    the pages."""
    from repro_torch.kernels import paged_attention as kpa

    def attend(q, table, pos):
        kl, vl = k_pages[layer], v_pages[layer]
        if kernels:
            return kpa.paged_window_attention(q, kl, vl, table, pos,
                                              window=window)
        return window_attention(q, paged_gather(kl, table),
                                paged_gather(vl, table), pos, window=window)

    split = comm.data_split()
    if split is None:
        paged_write_window(k_pages, layer, table, pos, k, block_size, valid)
        paged_write_window(v_pages, layer, table, pos, v, block_size, valid)
        return attend(q, table, pos)
    s0, ns = split.slots
    q_own, table_own, pos_own = q, table, pos
    if split.slots_split:
        if valid is None:
            valid = torch.ones(pos.shape, dtype=torch.bool, device=pos.device)
        q, k, v, table, pos, valid = (
            t.reshape((-1,) + tuple(t.shape[2:])) for t in
            comm.data_gather([q, k, v, table, pos, valid]))
    blocks = split.blocks if split.pool_split else None
    paged_write_window(k_pages, layer, table, pos, k, block_size, valid,
                       blocks=blocks)
    paged_write_window(v_pages, layer, table, pos, v, block_size, valid,
                       blocks=blocks)
    if not split.pool_split:
        if not split.slots_split:
            return attend(q, table, pos)
        return attend(q_own, table_own, pos_own)
    partial, fold = ((kpa.paged_window_attention_partial, kpa.fold_partials)
                     if kernels else
                     (kpa.paged_window_attention_partial_plain,
                      kpa.fold_partials_plain))
    parts = partial(q.contiguous(), k_pages[layer], v_pages[layer],
                    table.contiguous(), pos.contiguous(), blocks=split.blocks,
                    window=window)
    return fold(comm.data_gather([parts])[0], (s0, ns), q.dtype)


def paged_write_prefill(pages: torch.Tensor, kv: torch.Tensor,
                        blocks: torch.Tensor, block_size: int) -> torch.Tensor:
    """Write a whole prompt's K or V into its blocks, IN PLACE. pages
    (L, n_blocks, kvp, bs, hd); kv (L, s, kvp, hd); blocks (nb,) with
    nb*bs >= s (the tail of the last block is zero-padded)."""
    L, s, kvp, hd = kv.shape
    nb = blocks.shape[0]
    pad = nb * block_size - s
    kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
    tiles = kv.reshape(L, nb, block_size, kvp, hd).permute(0, 1, 3, 2, 4)
    split = comm.data_split()
    if split is not None and split.pool_split:
        # a data row holds a range of the pool: the blocks of its range, at
        # their local ids (one host read of the request's block ids)
        b0, nloc = split.blocks
        keep = [(i, b - b0) for i, b in enumerate(blocks.tolist())
                if b0 <= b < b0 + nloc]
        if not keep:
            return pages
        i, local = (torch.tensor(c, device=pages.device) for c in zip(*keep))
        pages[:, local] = tiles[:, i].to(pages.dtype)
        return pages
    pages[:, blocks.long()] = tiles.to(pages.dtype)
    return pages


# ---------------------------------------------------------------------------
# the paper's mechanism: tile-level activation sparsity at a static capacity


def tile_scores(h: torch.Tensor, tile: int) -> torch.Tensor:
    """Per-tile activity score max |h| over each tile. h (..., F) ->
    (..., F // tile)."""
    F = h.shape[-1]
    return h.abs().reshape(h.shape[:-1] + (F // tile, tile)).amax(-1)


def _top_sorted(scores: torch.Tensor, k: int):
    """The top k of the last axis, ties to the lower index (``lax.top_k``):
    the first k of a stable descending sort, as ``torch.topk`` promises no
    order among equal scores and zero scores tie often."""
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def select_active_tiles(scores: torch.Tensor, density: float,
                        n_groups: int = 1):
    """Static-capacity top-k tile selection, batch union, group-balanced.
    scores (tokens, n_tiles) (their max over tokens is taken: co-batched
    rows change the selection) or (n_tiles,). Each of ``n_groups`` equal
    groups keeps k_g = max(1, ceil(density * group size)) tiles. Returns
    (idx (n_groups * k_g,) int32 global tile ids, descending score within
    each group; mask (n_groups * k_g,) in scores' dtype, 1 where the tile's
    score is above 0)."""
    if scores.dim() == 2:
        scores = scores.amax(0)
    n_tiles = scores.shape[-1]
    gsz = n_tiles // n_groups
    k_g = max(1, int(math.ceil(density * gsz)))
    top, idx_l = _top_sorted(scores.reshape(n_groups, gsz), k_g)
    idx = idx_l + (torch.arange(n_groups, device=scores.device) * gsz)[:, None]
    mask = (top > 0).to(scores.dtype)
    return idx.reshape(-1).to(torch.int32), mask.reshape(-1)


def gathered_matmul(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                    mask: torch.Tensor, tile: int, out_dtype=None
                    ) -> torch.Tensor:
    """y = x @ w over the selected F tiles only: x (t, F), w (F, D), idx
    (k,) tile ids, mask (k,) validity. Returns (t, D) in ``out_dtype``
    (default x's dtype), summed in f32.

    On CUDA tensors it is kernel 5 (``kernels.sparse_matmul.sparse_matmul``)
    with nvalid = mask.sum() kept on the device: ``select_active_tiles``
    lists the tiles with a score above 0 first, and a masked tile's x is all
    zero, so the kernel's sum over idx[:nvalid] is the reference's. On
    "meta" tensors (the dry run) it is kernel 5's wrapper too, one
    operator that the dry run counts at the kernel's own cost. On CPU tensors it is the reference's
    gather-and-matmul."""
    if x.is_cuda or x.is_meta:
        # imported here: the kernel module's own imports reach this module
        from repro_torch.kernels import sparse_matmul as ksm
        nvalid = mask.sum(dtype=torch.int32)
        return ksm.sparse_matmul(x.contiguous(), w.contiguous(), idx, nvalid,
                                 tile=tile).to(out_dtype or x.dtype)
    t, F = x.shape
    D = w.shape[1]
    k = idx.shape[0]
    il = idx.long()
    xg = x.reshape(t, F // tile, tile)[:, il] * mask[None, :, None].to(x.dtype)
    wg = w.reshape(F // tile, tile, D)[il]
    return (xg.reshape(t, k * tile).float()
            @ wg.reshape(k * tile, D).float()).to(out_dtype or x.dtype)


def pick_group_tile(F: int, n_groups: int) -> int:
    """Largest tile size dividing F/n_groups, aligned to 8 where possible,
    with at least ~4 tiles per group."""
    per = F // n_groups
    cap = max(64, per // 4)
    for t in range(cap, 7, -1):
        if per % t == 0 and t % 8 == 0:
            return t
    for t in range(cap, 0, -1):
        if per % t == 0:
            return t
    return per


def ffn_gather_tile(cfg: ModelConfig, d_ff: Optional[int] = None) -> int:
    """FFN weight-gather tile width over ``d_ff`` units (default: the units
    this rank holds, ``local_d_ff``): cfg.sparsity.tile_size when it
    divides them, else the aligned fallback (the reference's single source
    of truth for the serving steps' tile lists and scores)."""
    d_ff = local_d_ff(cfg) if d_ff is None else d_ff
    ts = cfg.sparsity.tile_size
    return ts if d_ff % ts == 0 else pick_group_tile(d_ff, 1)


def static_plan(F: int, cfg: ModelConfig, n_groups: int = 0):
    """(tile, groups) of the static-capacity selection over F units:
    ``n_groups`` (default cfg.sparsity.n_groups) groups of
    ``pick_group_tile`` tiles when above 1 and dividing F, else one group
    of cfg.sparsity.tile_size tiles."""
    n_groups = n_groups or cfg.sparsity.n_groups
    if n_groups > 1 and F % n_groups == 0:
        return pick_group_tile(F, n_groups), n_groups
    return cfg.sparsity.tile_size, 1


def batch_tile_scores(x: torch.Tensor, tile: int) -> torch.Tensor:
    """The (F // tile,) scores of x (t, F) over the batch's rows (the max
    over rows: co-batched rows change a static selection), over every row
    of the batch where a data split cuts it (``comm.data_max``), so each
    data row selects what one device selects."""
    return comm.data_max(tile_scores(x, tile).amax(0))


def static_tiles(x: torch.Tensor, cfg: ModelConfig, density: float,
                 n_groups: int = 0):
    """The tile selection ``maybe_sparse_matmuls`` makes for x (t, F) at
    ``density`` < 1, by ``static_plan``: (idx (k,) int32 tile ids, mask
    (k,), tile)."""
    tile, groups = static_plan(x.shape[1], cfg, n_groups)
    idx, mask = select_active_tiles(batch_tile_scores(x, tile), density,
                                    groups)
    return idx, mask, tile


def grouped_matmuls(x: torch.Tensor, ws, idx: torch.Tensor,
                    mask: torch.Tensor, tile: int, n_groups: int, most: int):
    """``[x @ w for w in ws]`` over one group-balanced selection (idx,
    mask) that ``select_active_tiles`` made at ``pick_group_tile``'s
    ``tile`` (the reference's ``grouped_sparse_matmul``: each group keeps
    its own top tiles, as each TP shard's gather stays local). On CUDA
    tensors each product is kernel 5 (``gathered_matmul``) over the list
    cut to tiles of at most ``most`` (``rank_tiles`` over all F units;
    cfg.sparsity.tile_size caps a group tile of thousands), the valid
    entries first: a masked tile's x is all zero, so the sum over the
    valid entries is the reference's (on "meta" tensors too). On CPU
    tensors it is the reference's gather and einsum over (group, tile)."""
    t, F = x.shape
    if x.is_cuda or x.is_meta:
        sel = rank_tiles(idx, mask, tile, 0, F, most)
        return [gathered_matmul(x, w, *sel) for w in ws]
    il = idx.long().reshape(n_groups, -1)  # (G, k_g)
    xg = (x.reshape(t, F // tile, tile)[:, il]
          * mask.reshape(n_groups, -1)[None, :, :, None])  # (t, G, k_g, tile)
    return [torch.einsum("tgkc,gkcd->td", xg.float(),
                         w.reshape(F // tile, tile, -1)[il].float()
                         ).to(x.dtype) for w in ws]


def maybe_sparse_matmul(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig,
                        density: float, n_groups: int = 0) -> torch.Tensor:
    """Dense x @ w at density 1, else the tile-gathered product at the
    static capacity ``density``: group-balanced (``grouped_matmuls``,
    kernel 5 on the card as on the mesh path) when ``n_groups`` (default
    cfg.sparsity.n_groups) is above 1 and divides F, else over the batch
    union's top tiles of cfg.sparsity.tile_size (``gathered_matmul``)."""
    return maybe_sparse_matmuls(x, (w,), cfg, density, n_groups)[0]


def maybe_sparse_matmuls(x: torch.Tensor, ws, cfg: ModelConfig,
                         density: float, n_groups: int = 0):
    """``[maybe_sparse_matmul(x, w, ...) for w in ws]`` with the tile
    selection, which depends on x alone, made once for all of them (the
    reference selects again for each product; the results are the same)."""
    if density >= 1.0:
        return [x @ w for w in ws]
    idx, mask, tile = static_tiles(x, cfg, density, n_groups)
    groups = static_plan(x.shape[1], cfg, n_groups)[1]
    if groups > 1:
        return grouped_matmuls(x, ws, idx, mask, tile, groups,
                               cfg.sparsity.tile_size)
    return [gathered_matmul(x, w, idx, mask, tile) for w in ws]


def rank_tile_scores(x: torch.Tensor, tile: int, start: int,
                     total: int) -> torch.Tensor:
    """The (total // tile,) tile scores of a product input split over the
    ranks, from this rank's units [start, start + x.shape[1]) of x: each
    rank scores its slice at the tile that also divides the slice bounds,
    the slices are put together over the ranks (``comm.gather_last``) and
    the maxima taken over each tile, exactly as one device scores it."""
    s = math.gcd(tile, math.gcd(x.shape[1], start))
    sub = batch_tile_scores(x, s)
    full = comm.gather_last(sub, total // s, start // s)
    return full.reshape(-1, tile // s).amax(-1)


def rank_tiles(idx: torch.Tensor, mask: torch.Tensor, tile: int, start: int,
               count: int, most: int = 0):
    """This rank's part of a tile list (idx, mask) over all units: the
    listed units in [start, start + count), as a list over those units at
    tile s = gcd(tile, count, start[, most]) (``most``: a tile the kernel
    takes, e.g. cfg.sparsity.tile_size under a group tile of thousands),
    the valid entries first in list order (``gathered_matmul`` reads
    kernel 5's idx[:mask.sum()]). Returns (idx (n,) int32, mask (n,), s),
    n at most count // s."""
    s = math.gcd(math.gcd(tile, most), math.gcd(count, start))
    r, lo, n = tile // s, start // s, count // s
    sub = (idx.long()[:, None] * r
           + torch.arange(r, device=idx.device)).reshape(-1)
    keep = (sub >= lo) & (sub < lo + n) & (mask > 0).repeat_interleave(r)
    order = torch.sort(keep.to(torch.uint8), descending=True,
                       stable=True).indices[:n]
    return ((sub[order] - lo).clamp(0, n - 1).to(torch.int32),
            keep[order].to(mask.dtype), s)


def site_sparsity(x: torch.Tensor) -> torch.Tensor:
    """Fraction of exact zeros in x, an f32 scalar on x's device."""
    return (x == 0).float().mean()


def layer_params(params, i: int):
    """Layer ``i`` of a parameter tree whose ``layers`` leaves are stacked on
    a leading axis (views, no copies)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return take(params["layers"])


class LayerSource:
    """Per-layer parameter trees made on demand, in place of a stacked
    ``layers`` tree: ``transformer.forward`` takes layer i (``source[i]``)
    just before the layer's block and calls ``release(i)`` when the block
    returns. The FSDP step's per-layer gather is one (``train/fsdp.py``)."""

    def __getitem__(self, i: int):
        raise NotImplementedError

    def release(self, i: int) -> None:
        pass


def unstack_layers(layers, n_layers: int):
    """The ``n_layers`` per-layer trees of a ``layers`` tree stacked on a
    leading axis (views, no copies), by one ``unbind`` a leaf. Under
    autograd its backward is one ``stack`` a leaf, where taking layer i
    of each leaf (``layer_params``) allocates a zero gradient of the whole
    stacked leaf for every layer. A ``LayerSource`` passes through."""
    if isinstance(layers, LayerSource):
        return layers
    if isinstance(layers, dict):
        subs = {k: unstack_layers(v, n_layers) for k, v in layers.items()}
        return [{k: subs[k][i] for k in subs} for i in range(n_layers)]
    return layers.unbind(0)


def release_layer(layers, i: int) -> None:
    """``layers.release(i)`` when ``layers`` is a ``LayerSource`` (the
    family's forward is done with layer i), else nothing."""
    if isinstance(layers, LayerSource):
        layers.release(i)


# ---------------------------------------------------------------------------
# training helpers: mixed precision and remat


def cast_params(params, cfg: ModelConfig):
    """Mixed precision: f32 master leaves cast to the compute dtype at the
    model's entry, differentiably, so their gradients come back in f32.
    Leaves already in another dtype (serving params, stored once in the
    compute dtype) pass through uncopied, as does a ``LayerSource`` (its
    layers come in the compute dtype)."""
    cdt = getattr(torch, cfg.compute_dtype)

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, LayerSource):
            return t
        return t.to(cdt) if t.dtype == torch.float32 else t

    return cast(params)


def call(fn: Callable, *args):
    """A block's sublayer run as is (``wrap_block``'s "save_ars" policy
    checkpoints each one instead)."""
    return fn(*args)


def _in_state(fn: Callable) -> Callable:
    """``fn`` run under the mesh state active now (``comm.snapshot``): a
    recompute in the backward may run on autograd's own thread, where the
    thread's state is not set, and must split as the forward did."""
    state = comm.snapshot()

    def run(*args):
        with comm.restored(state):
            return fn(*args)

    return run


def _checkpointed(fn: Callable, *args, **kw):
    """``ckpt.checkpoint`` of ``fn(*args)`` with the leaves of a dict
    argument (a layer's params) passed as inputs of their own: the
    checkpoint saves its tensor inputs through the active saved-tensor
    hooks (the FSDP step saves a gathered weight as a token there,
    ``train/fsdp.py``), where it would keep a dict as it is."""
    flat, parts = [], []
    for a in args:
        if isinstance(a, dict):
            leaves = flatten(a)
            parts.append(unflatten(a, list(range(len(leaves)))))
            flat += leaves
        else:
            parts.append(None)
            flat.append(a)

    def run(*flat_args):
        it = iter(flat_args)
        return fn(*[next(it) if part is None
                    else unflatten(part, [next(it) for _ in flatten(part)])
                    for part in parts])

    return ckpt.checkpoint(_in_state(run), *flat, use_reentrant=False, **kw)


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _products_saved():
    return ckpt.create_selective_checkpoint_contexts(_save_products)


REMAT_POLICIES = ("none", "minimal", "full", "save_ars")


def wrap_block(policy: str, block_fn: Callable) -> Callable:
    """A family's full-sequence layer function ``block_fn(p, x, cfg,
    positions, stats, sublayer=call) -> (x, kv)`` under a remat policy,
    through ``torch.utils.checkpoint`` (non-reentrant):

    - "none": no checkpointing; the backward keeps every activation;
    - "full": the whole block is recomputed in the backward from its
      input;
    - "minimal": selective checkpointing that keeps the outputs of the
      2-D products (``aten.mm``/``addmm``: every weight product, which
      ``torch.matmul`` folds to 2-D) and recomputes the rest, the
      reference's ``dots_with_no_batch_dims_saveable``;
    - "save_ars": the attention and FFN sublayers checkpointed apart, so
      the backward keeps the sublayers' inputs and outputs (the
      reference's saved ``attn_out`` / ``ffn_out``) and recomputes what
      lies inside each.

    All four give the same gradients. A recompute calls an active stats
    collector's ``add*`` again under the same keys with the same values,
    and, under a mesh, issues the block's forward collectives again, on
    every rank alike, in the mesh state of the forward."""
    if policy in (None, "none"):
        return block_fn
    if policy == "save_ars":
        def block(p, x, cfg, positions, stats=NO_STATS):
            return block_fn(p, x, cfg, positions, stats, sublayer=_checkpointed)
        return block
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; known: "
                         f"{REMAT_POLICIES}")
    kw = {"context_fn": _products_saved} if policy == "minimal" else {}

    def block(p, x, cfg, positions, stats=NO_STATS):
        return _checkpointed(block_fn, p, x, cfg, positions, stats, **kw)

    return block


def rms_norm_headdim(scale: torch.Tensor, x: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS-normalise the head_dim axis."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and absent — the port never runs
    on the CPU unasked. "meta" (shapes without storage) passes through."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain PyTorch versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device}")
    return device


class StatsCollector:
    """Per-site sparsity and pre-activation statistics during a forward or
    decode step (the reference's ``StatsCollector``). Inactive (the
    default) every ``add*`` is a no-op and computes nothing. The values
    stay on the device (scalars, or the (F,) ``down_act`` mask): reading
    them is the caller's fetch."""

    def __init__(self, active: bool = False, raw: bool = False):
        self.active = active
        self.raw = active and raw
        self.stats: Dict[str, torch.Tensor] = {}

    def add(self, name: str, value: torch.Tensor) -> None:
        if self.active:
            self.stats[name] = value

    def add_raw(self, name: str, x: torch.Tensor) -> None:
        """Capture a full activation tensor (calibration runs only): only
        when the collector was built with ``raw=True``."""
        if self.raw:
            self.stats[name] = x.detach()

    def add_sparsity(self, name: str, x: torch.Tensor) -> None:
        if self.active:
            self.stats[name] = site_sparsity(x.detach())

    def add_preact(self, name: str, x: torch.Tensor) -> None:
        if self.active:
            xf = x.detach().float()
            self.stats[name + "/mean"] = xf.mean()
            self.stats[name + "/std"] = xf.std(unbiased=False)
            self.stats[name + "/frac_neg"] = (xf < 0).float().mean()


NO_STATS = StatsCollector(False)  # the shared inactive collector
