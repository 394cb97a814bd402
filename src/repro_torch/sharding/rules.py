"""Logical-axis sharding rules of the port (the reference's
``sharding/rules.py``): the spec of every parameter, cache and activation
buffer is derived from its path name and shape, with the same divisibility
guard — a mesh axis is assigned to a dimension only when the dimension
divides the axis size, so where it does not (GQA kv heads of 2 on a 4-way
model axis, a d_ff that does not divide) the tensor is replicated.

A spec here is a tuple with one entry per dimension: None (not split), a
mesh axis name, or a tuple of two or more axis names (the data-parallel
axes of a pod mesh; a tuple of one is written as its name, as the
reference's PartitionSpec writes it). The functions take any mesh with
``shape`` (axis name -> size) and ``axis_names``:
``repro_torch.launch.mesh.Mesh``, or a stand-in in tests.

``Sharding(mesh, spec)`` is the port's ``NamedSharding``: where a leaf
lies on a mesh, which ``local_block`` cuts and ``full_from_blocks`` puts
back together. A model's trees are cut by ``models/common.py``
(``leaf_sharding``, ``params_shardings``, ``shard_params``: ``param_pspec``
of each leaf, the SSM leaves by their family's blocks). The serving engine
(``mesh=``) holds only a rank's blocks and runs the model steps on them,
with the collectives of ``sharding/comm.py`` where the sharded products
meet; the checkpoint manager saves and restores sharded trees by their
``Sharding`` trees (``checkpoint/manager.py``), and the FSDP train step
lays its state out by the train mode's (``train/fsdp.py``).

Not ported, by design: ``constrain``, ``use_mesh``, ``set_mesh``,
``get_mesh``, ``constrain_params_tree`` and ``predictor_shardings``. They
are GSPMD layout hints, which have no counterpart in explicit SPMD: each
rank of the port holds ordinary local tensors, and the collectives are
written where GSPMD would insert them (models/transformer.py,
models/moe.py, train/fsdp.py).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import torch

Spec = Tuple[Any, ...]


def _spec(entries) -> Spec:
    """A spec tuple, each one-name tuple written as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def tp_size(mesh) -> int:
    """Tensor-parallel degree of a mesh (1 when mesh is None or has no
    "model" axis): the 1/TP of the engine's per-device weight-I/O
    accounting."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return int(mesh.shape["model"])


# (regex on the '/'-joined param path) -> logical axes of the trailing
# dims; leading stacked-layer dims are found by the ndim surplus and mapped
# to None
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"pos_embed$", ("seq_weights", "embed")),
    (r"(embed|unembed)$", ("vocab", "embed")),
    (r"attn.*/(wq)$", ("embed", "heads", "head_dim")),
    (r"attn.*/(wk|wv)$", ("embed_kv", "kv_heads", "head_dim")),
    (r"attn.*/wo$", ("heads", "head_dim", "embed")),
    (r"attn.*/(bq)$", ("heads", "head_dim")),
    (r"attn.*/(bk|bv)$", ("kv_heads", "head_dim")),
    (r"(q_norm|k_norm)$", ("head_dim",)),
    (r"ffn/(wu|wg)$", ("embed", "ffn")),
    (r"ffn/wd$", ("ffn", "embed")),
    (r"moe/router$", ("embed", "experts")),
    (r"moe/(wu|wg)$", ("experts", "embed_heavy", "ffn")),
    (r"moe/wd$", ("experts", "ffn", "embed_heavy")),
    # mamba
    (r"ssm/in_proj$", ("embed", "inner_all")),
    (r"ssm/out_proj$", ("inner", "embed")),
    (r"ssm/conv_w$", ("conv_k", "inner")),
    (r"ssm/(conv_b|A_log|D|dt_bias|gate_b)$", ("inner_vec",)),
    (r"ssm/(x_proj|dt_proj_w|B_proj|C_proj|dt_proj)$",
     ("inner_or_embed", "proj_out")),
    (r"ssm/norm/scale$", ("inner_vec",)),
    # norms / scalars: replicated
    (r"(ln\d*|norm\d*|final_norm|pre_norm|post_norm|input_norm)(/|$)", ()),
    (r"(scale|bias)$", ()),
)


def _logical_axes_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            lead = ndim - len(axes)
            assert lead >= 0, (path, ndim, axes)
            return (None,) * lead + tuple(axes)
    return (None,) * ndim  # unknown -> replicated (safe default)


# logical axis -> mesh axis, per mode. "embed" is the FSDP axis in training.
_MESH_MAP = {
    "train": {
        "vocab": "model", "embed": "data", "embed_kv": "data",
        "embed_heavy": "dp",  # resolves to ("pod","data") on a 2-pod mesh
        "heads": "model", "kv_heads": "model", "head_dim": None,
        "ffn": "model", "experts": None, "seq_weights": None,
        "inner": "model", "inner_all": "model", "inner_vec": "model",
        "inner_or_embed": None, "proj_out": None, "conv_k": None,
    },
    "serve": {
        "vocab": "model", "embed": None, "embed_kv": "model",
        "embed_heavy": "dp",
        "heads": "model", "kv_heads": "model", "head_dim": None,
        "ffn": "model", "experts": "model", "seq_weights": None,
        "inner": "model", "inner_all": "model", "inner_vec": "model",
        "inner_or_embed": None, "proj_out": None, "conv_k": None,
    },
}

# logical axes assigned BEFORE the trailing-first loop: the expert dim wins
# "model" over the same weight's trailing ffn dim, so each device holds
# whole experts; it falls through to the loop when it does not divide
_PRIORITY_AXES = ("experts",)


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_size(mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= mesh.shape[a]
    return out


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return False
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= mesh.shape[a]
    return dim % size == 0 and dim >= size


def param_pspec(path: str, shape: Tuple[int, ...], mesh, mode: str) -> Spec:
    """The spec of the parameter at ``path`` ('/'-joined tree keys) of
    ``shape``: its logical axes (``_PARAM_RULES``) mapped through the mode's
    ``_MESH_MAP``, the priority axes first, then trailing dims first, each
    mesh axis used once and only where ``_fits``."""
    axes = _logical_axes_for(path, len(shape))
    mm = _MESH_MAP[mode]
    out, used = [None] * len(shape), set()

    def assign(i):
        ax = axes[i]
        mesh_ax = mm.get(ax) if ax else None
        if mesh_ax == "dp":  # dynamic: all data-parallel axes of this mesh
            mesh_ax = dp_axes(mesh)
        flat = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        if (mesh_ax is not None and not (set(flat) & used)
                and _fits(shape[i], mesh, mesh_ax)):
            out[i] = mesh_ax
            used.update(flat)

    for i in range(len(shape)):
        if axes[i] in _PRIORITY_AXES:
            assign(i)
    # for MHA the (padded) kv-head dim takes "model"; for GQA (kv < TP) it
    # falls through and the embed dim takes it instead
    for i in reversed(range(len(shape))):
        if axes[i] not in _PRIORITY_AXES:
            assign(i)
    return _spec(out)


def predictor_pspec(name: str, shape: Tuple[int, ...], mesh) -> Spec:
    """A stacked predictor leaf (``predictor.Predictor.params``): probe
    weights whose trailing axis is d_ff ("w" for sign, "b" for lowrank)
    split it over "model", so each rank probes its own d_ff slice; taus
    and the low-rank input factors are replicated."""
    out = [None] * len(shape)
    if name.rsplit("/", 1)[-1] in ("w", "b") and len(shape) >= 2 \
            and _fits(shape[-1], mesh, "model"):
        out[-1] = "model"
    return tuple(out)


# ---------------------------------------------------------------------------
# activation / buffer specs


def batch_pspec(batch_size: int, mesh, extra_dims: int = 1) -> Spec:
    dp = dp_axes(mesh)
    if _fits(batch_size, mesh, dp):
        return _spec((dp,)) + (None,) * extra_dims
    if _fits(batch_size, mesh, "data"):
        return ("data",) + (None,) * extra_dims
    return (None,) * (extra_dims + 1)


def cache_pspec(shape: Tuple[int, ...], mesh) -> Spec:
    """Contiguous KV cache, head-major (L, b, kvp, S, hd): batch over DP,
    seq over "model"."""
    L, b, kvp, S, hd = shape
    dp = dp_axes(mesh)
    baxis = dp if _fits(b, mesh, dp) else ("data" if _fits(b, mesh, "data")
                                          else None)
    saxis = "model" if _fits(S, mesh, "model") else None
    return _spec((None, baxis, None, saxis, None))


def paged_cache_pspec(shape: Tuple[int, ...], mesh) -> Spec:
    """Paged KV block pool (L, n_blocks, kvp, bs, hd): blocks over "data",
    kv heads over "model"; either replicated where it does not divide (GQA
    kvp = 2 on a 4-way model axis). Where the kv heads are replicated, a
    rank of the port keeps only the heads its query slots read
    (``common.ShardLayout``)."""
    L, nb, kvp, bs, hd = shape
    baxis = "data" if _fits(nb, mesh, "data") else None
    haxis = "model" if _fits(kvp, mesh, "model") else None
    return (None, baxis, haxis, None, None)


def serve_masks_pspec(shape: Tuple[int, ...], mesh) -> Spec:
    """Per-slot γ-window FFN masks (L, n_slots, d_ff) or (n_slots, d_ff):
    d_ff over "model", so the union-mask updates stay on each rank's d_ff
    slice; slots over "data" when they fit."""
    faxis = "model" if _fits(shape[-1], mesh, "model") else None
    saxis = "data" if _fits(shape[-2], mesh, "data") else None
    return (None,) * (len(shape) - 2) + (saxis, faxis)


@dataclasses.dataclass(frozen=True)
class DataSplit:
    """Where one row of a (D, M) serving mesh sits on the data axis, by the
    guards of ``serve_masks_pspec`` (slots) and ``paged_cache_pspec``
    (pool blocks): each pair is (first, count), the whole axis where it
    does not divide D. Row ``index`` computes the model step for its slots
    and holds its global blocks as local blocks 0 .. count - 1; the
    scratch block (global block 0) lies on row 0."""

    size: int
    index: int
    slots: Tuple[int, int]
    blocks: Tuple[int, int]
    n_slots: int
    n_blocks: int

    @property
    def slots_split(self) -> bool:
        """Each row computes its own slots (else every row computes all)."""
        return self.slots[1] < self.n_slots

    @property
    def pool_split(self) -> bool:
        """Each row holds its own pool blocks (else every row holds all)."""
        return self.blocks[1] < self.n_blocks

    def whole_batch(self) -> "DataSplit":
        """The same pool split with every row computing every slot (a call
        whose batch does not divide the data axis, such as the one-request
        whole-prompt prefill)."""
        return dataclasses.replace(self, slots=(0, self.n_slots))


def data_split(mesh, n_slots: int, n_blocks: int) -> Optional[DataSplit]:
    """This rank's ``DataSplit`` of a serving engine's ``n_slots`` slots
    and ``n_blocks`` pool blocks on ``mesh``; None without a data axis
    above 1."""
    if mesh is None or "data" not in mesh.axis_names \
            or mesh.shape["data"] == 1:
        return None
    n, d = mesh.shape["data"], mesh.coords["data"]

    def block(total, spec):
        return (d * (total // n), total // n) if spec == "data" else (0, total)

    return DataSplit(
        size=n, index=d,
        slots=block(n_slots, serve_masks_pspec((n_slots, 1), mesh)[0]),
        blocks=block(n_blocks, paged_cache_pspec((1, n_blocks, 1, 1, 1),
                                                 mesh)[1]),
        n_slots=n_slots, n_blocks=n_blocks)


def ssm_cache_pspec(shape: Tuple[int, ...], mesh) -> Spec:
    """SSM state (L, b, inner, state) / conv state (L, b, k, inner)."""
    dp = dp_axes(mesh)
    out = [None]
    b = shape[1]
    out.append(dp if _fits(b, mesh, dp)
               else ("data" if _fits(b, mesh, "data") else None))
    for dim in shape[2:]:
        out.append("model" if ("model" not in out and _fits(dim, mesh, "model")
                               and dim >= 1024) else None)
    return _spec(out)


def logits_pspec(batch_size: int, mesh, with_seq: bool) -> Spec:
    bp = batch_pspec(batch_size, mesh, extra_dims=0)
    baxis = bp[0] if len(bp) else None
    if with_seq:
        return (baxis, None, "model")
    return (baxis, "model")


# ---------------------------------------------------------------------------
# one rank's blocks


def axis_block(mesh, axis) -> Tuple[int, int]:
    """(index, count): this rank's block along a spec entry ``axis`` (an
    axis name or a tuple of them, major first) and the number of blocks."""
    return _index(axis, mesh.shape, mesh.coords)


def local_block(t: torch.Tensor, spec: Spec, mesh,
                packed=None) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: every split dim narrowed
    to the rank's equal share (a view). ``packed`` (dim, ((size, split),
    ...)): dim ``dim`` is a concatenation of segments of those sizes, and
    the rank's block of it is each split segment's share and each other
    segment whole, concatenated in order (a copy)."""
    if packed is not None:
        dim, segs = packed
        index, count = axis_block(mesh, spec[dim])
        parts, at = [], 0
        for size, split in segs:
            n = size // count if split else size
            parts.append(t.narrow(dim, at + (index * n if split else 0), n))
            at += size
        t = torch.cat(parts, dim)
        spec = spec[:dim] + (None,) + spec[dim + 1:]
    for dim, axis in enumerate(spec):
        if axis is not None:
            index, count = axis_block(mesh, axis)
            size = t.shape[dim] // count
            t = t.narrow(dim, index * size, size)
    return t


def _index(axis, mesh_shape, coords) -> Tuple[int, int]:
    """(index, count) of the block at ``coords`` along a spec entry
    ``axis`` (an axis name or a tuple of them, major first)."""
    index, count = 0, 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        index = index * mesh_shape[a] + coords[a]
        count *= mesh_shape[a]
    return index, count


def block_slices(spec: Spec, shape: Tuple[int, ...], mesh_shape,
                 coords) -> Tuple[slice, ...]:
    """The index of the block of a ``shape`` leaf under ``spec`` that the
    rank at ``coords`` (axis name -> index) of a mesh of ``mesh_shape``
    holds."""
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            out.append(slice(None))
            continue
        index, count = _index(axis, mesh_shape, coords)
        size = shape[dim] // count
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def full_from_blocks(blocks: torch.Tensor, spec: Spec, mesh,
                     shape: Tuple[int, ...], packed=None) -> torch.Tensor:
    """The whole ``shape`` leaf from every rank's block under ``spec``,
    ``blocks`` (world, *block shape) in rank order (the mesh's axes major
    first: on a (data, model) mesh rank r at data index r // model, model
    index r % model): each block placed at its index (a block replicated
    over an axis is the same on every rank of it); a ``packed`` dim
    (``local_block``) segment by segment, in the leaf's own order."""
    out = blocks.new_empty(shape)
    names = tuple(getattr(mesh, "axis_names", ("data", "model")))
    for r in range(blocks.shape[0]):
        coords, rest = {}, r
        for a in reversed(names):
            coords[a], rest = rest % mesh.shape[a], rest // mesh.shape[a]
        if packed is None:
            out[block_slices(spec, shape, mesh.shape, coords)] = blocks[r]
            continue
        dim, segs = packed
        where = list(block_slices(spec[:dim] + (None,) + spec[dim + 1:],
                                  shape, mesh.shape, coords))
        index, count = _index(spec[dim], mesh.shape, coords)
        at = local = 0
        for size, split in segs:
            n = size // count if split else size
            g0 = at + (index * n if split else 0)
            where[dim] = slice(g0, g0 + n)
            out[tuple(where)] = blocks[r].narrow(dim, local, n)
            at, local = at + size, local + n
    return out


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf lies on ``mesh``: ``spec`` (one entry a dim, as
    ``param_pspec`` gives it; () for a 0-d leaf). The port's
    ``NamedSharding``: a rank holds ``local_block(leaf, spec, mesh,
    packed)``. ``packed`` (dim, ((size, split), ...)): a leaf whose dim
    ``dim`` packs segments that split apart (an SSM ``in_proj``,
    ``models/common.py::leaf_sharding``)."""

    mesh: Any = dataclasses.field(compare=False)
    spec: Spec = ()
    packed: Optional[tuple] = None

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``t`` (a view, or a copy
        of a packed leaf)."""
        return local_block(t, self.spec, self.mesh, self.packed)

    def block_shape(self, shape) -> Tuple[int, ...]:
        """The shape of a rank's block of a whole ``shape`` leaf."""
        out = list(shape)
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            count = axis_block(self.mesh, axis)[1]
            if self.packed is not None and dim == self.packed[0]:
                out[dim] = sum(n // count if split else n
                               for n, split in self.packed[1])
            else:
                out[dim] //= count
        return tuple(out)

    def full_shape(self, block_shape) -> Tuple[int, ...]:
        """The whole leaf's shape of a rank's ``block_shape``."""
        shape = list(block_shape)
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            if self.packed is not None and dim == self.packed[0]:
                shape[dim] = sum(n for n, _ in self.packed[1])
            else:
                shape[dim] *= axis_block(self.mesh, axis)[1]
        return tuple(shape)

    def full(self, blocks: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's block (``full_from_blocks``;
        ``blocks`` (world, *block shape) in rank order)."""
        return full_from_blocks(blocks, self.spec, self.mesh,
                                self.full_shape(blocks.shape[1:]),
                                self.packed)


def shard_predictor_params(params, mesh, device=None):
    """This rank's blocks of a stacked predictor dict (``predictor_pspec``):
    the probe's d_ff slice."""
    return {k: local_block(v, predictor_pspec(k, tuple(v.shape), mesh),
                           mesh).to(device or v.device, copy=True).contiguous()
            for k, v in params.items()}
