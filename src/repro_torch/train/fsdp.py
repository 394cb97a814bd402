"""The FSDP + TP train step on a (data, model) or (pod, data, model) mesh:
the reference's ``launch/specs.py::build_train`` (``make_train_step``
under the rules' train-mode shardings), in explicit collectives over
``torch.distributed`` ranks (``sharding/comm.py``).

Layout. Every leaf of the params and of both AdamW moments is the rank's
block under ``rules.param_pspec(path, shape, mesh, "train")``: "embed"
over "data" (FSDP; on a pod mesh within the pod, replicated over "pod"),
the MoE experts' d_model ("embed_heavy") over ("pod", "data") on a pod
mesh, ffn, heads, kv_heads and vocab over "model"; where a dim does not
divide its axis, the leaf is replicated over that axis. A leaf's data
group is the data column of its split: within the rank's pod for "data"
(the mesh's ``shard_group``: D ranks), over pod × data for ("pod",
"data") (its ``data_group``: P·D ranks, (pod, data) order); a group of
one rank splits nothing. The
SSM leaves of the Mamba-1 and Zamba-2 families take the family's blocks
over "model" instead (``common.leaf_sharding``: the rank's d_inner
units or heads; the rules' "data" entries kept).
``OptState.step`` is replicated. ``shard_train_state`` cuts whole params
to these blocks and starts the moments at their size; ``state_shardings``
says where each leaf lies (the checkpoint manager's ``shardings=``).

A step (``make_fsdp_train_step``):

1. gathers the leaves outside the layers (the embedding, the head, the
   final norm) that are split over "data" into the rank's model column,
   once a step: one all_gather of one flat buffer over each data group
   (module note, Layout) that has such leaves, in the compute dtype (the
   forward casts the f32 masters to it at its entry, so it computes with
   the same values), the column then held in f32 so that its gradients
   come back in f32;
2. cuts the global batch into ``tc.num_microbatches`` slices as
   ``train/step.py`` does (``microbatch_rows``). The data rows, over pod ×
   data, split each slice's rows where they divide them. A slice of fewer
   rows than that, which "data" divides, splits over "data" within each
   pod, and every pod computes the same rows: the layout the reference's
   compiled step takes there (its ``build_train`` on 8 forced CPU devices
   at (2, 2, 2), 2 rows a slice: the scan's slice all-gathers the batch
   over "pod", each device holding one row, the pods' copies alike; the
   loss's masked sum and the layer gradients' sums then run over "data"
   within the pod, GSPMD using "pod" for other dims of the products).
   Such a slice's reductions count its rows once: the loss's sum and
   count run over the pod's data column, the gradients of the leaves
   split over "data" or replicated are summed within the pod and not
   over the pods, and those of the leaves split over pod × data, whose
   reduce-scatter sums the pods' alike copies, are divided by the pod
   count;
3. runs each slice's forward and backward under the mesh's model axis in
   the train mode (``comm.serving(mesh, rows, "train")``: the serving
   path's tensor parallelism, whose collectives autograd differentiates).
   The loss (``fsdp_loss``) is the masked mean over the whole slice: the
   masked sum and the count are summed over the slice's data rows before
   the division, in the graph. The logits stay split over the vocabulary, and the
   log-sum-exp runs over the model ranks (the maximum, then the sum of
   exp and the target logit in one all-reduce): the function of
   ``train/step.py::lm_loss`` with its per-element roundings (the maximum
   subtracted in the compute dtype, exp in f32), its sums in another
   order. No rank holds the whole (b, s, vocab) logits;
4. gathers each layer's leaves split over "data" where the layer runs,
   as the reference's compiled step does (its forward and its backward
   layer loops each gather the layer's leaves in their body): the
   family's forward (``transformer.forward``, and the Mamba, hybrid and
   enc-dec ``model_forward``s) takes layer i of each stack (``STACKS``:
   the layers, Whisper's encoder and decoder stacks, and Zamba-2's
   shared block, a stack of one that each of its applications takes)
   from that stack's ``_Layers`` just before its block (one all_gather
   of the layer's blocks in the compute dtype over each of its data
   groups, ``_GatherLayer``) and releases it when the block returns. The
   slice's
   saved-tensor hooks keep a token in the graph where a gathered weight
   would be saved (a remat policy's checkpoint saves its inputs there
   too), so the backward gathers the layer again at its first use; the
   backward of ``_GatherLayer``, which runs once the layer's gradients
   are all in, reduces them over each data group (one reduce_scatter a
   group, in f32; the pod's column's sum then summed over the pods, one
   all-reduce, ``comm.pod_sum``; the pod × data reduce-scatter sums over
   the pods itself), adds them into the rank's f32 block gradients, which
   persist over the slices as the reference's scan adds sharded
   gradients, and drops the layer. No more than a layer's column is
   gathered at a time (``GAUGE``). After the last slice, the step-long
   columns' f32 gradients are reduced to the rank's blocks as a layer's
   are, those of the leaves replicated over "data" summed (one
   all-reduce), and all are divided by the slice count as the
   reference's mean divides. With L layers (layer applications, over
   every stack), nmb slices and a data axis of more than one rank, with
   g the data groups among each layer's split leaves (2 for an MoE layer
   on a pod mesh, else 1), a step issues, counted on the data axis of
   ``comm.STATS``: 1 + 2·g·L·nmb all_gathers, g·L·nmb + 1
   reduce_scatters, nmb all-reduces of the loss's sum and count, one of
   the replicated leaves and, on a pod mesh whose slices split over pod
   × data, L·nmb + 1 pod sums (``STATS.pod_count``; none where every pod
   computes the same rows). On a pod mesh of one data row a pod only the
   experts' pod × data column is gathered (2·L·nmb all_gathers, L·nmb
   reduce_scatters, no pod sum);
5. clips by the global norm with each element counted once: a rank adds
   a leaf's squares only where it is the leaf's first holder along each
   axis the spec replicates it over, then one sum over the mesh;
6. runs the schedule and AdamW on the blocks; ``skip_nonfinite`` decides
   on the global loss and norm, alike on every rank.

Metrics {"loss", "grad_norm", "lr", "step_ok"} are 0-d f32 tensors on the
mesh's device, equal on every rank. The step runs none of the ten
kernels, as the reference's runs none. It trains every family; an MoE
routing group that would span the rows a rank holds raises.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.optim import adamw, schedules
from repro_torch.sharding import comm, rules
from repro_torch.tree import flatten, tree_map, unflatten

# the subtrees of layers a forward takes one at a time: stacked on a
# leading layer axis, except "shared" (Zamba-2's one shared block, taken
# at each of its applications)
STACKS = ("layers", "enc_layers", "dec_layers", "shared")


def param_shapes(cfg: ModelConfig):
    """The whole parameter tree's shapes (f32 leaves on the "meta" device:
    no storage)."""
    return registry.get_family(cfg).init_params(cfg, device="meta",
                                                dtype=torch.float32)


def state_shardings(cfg: ModelConfig, mesh) -> Tuple[Dict, adamw.OptState]:
    """(params, OptState) trees of ``rules.Sharding``: the train mode's
    spec of every leaf, the optimizer step replicated."""
    ps = cm.params_shardings(cfg, param_shapes(cfg), mesh, "train")
    return ps, adamw.OptState(step=rules.Sharding(mesh, ()), m=ps, v=ps)


def shard_train_state(params, mesh, cfg: ModelConfig
                      ) -> Tuple[Dict, adamw.OptState]:
    """This rank's blocks of ``cfg``'s whole ``params`` under the train
    mode's specs (``common.shard_params``), on the mesh's device (leaf by
    leaf: a block is copied out before the next leaf is touched), and a
    fresh optimizer state of the blocks' size. A trained state moves
    between meshes through the checkpoint (``CheckpointManager.save`` /
    ``restore`` with ``shardings=``)."""
    blocks = cm.shard_params(cfg, params, mesh, "train", device=mesh.device)
    return blocks, adamw.init_opt_state(blocks)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One leaf's layout on this rank: the shape of its block, the dim
    split over its data group (None: replicated over "data", or a group
    of one rank), the stack it belongs to (``STACKS``, None outside them:
    the step gathers a stack's leaves layer by layer, the other split
    leaves once a step), whether that stack is stacked on dim 0, whether
    this rank counts the leaf's squares in the global norm (it is the
    leaf's first holder along each axis the spec replicates it over), and
    its data group (``comm.axis_size``'s "shard": over "data" within the
    pod; "data": over pod × data)."""

    block: tuple
    data_dim: Optional[int]
    counted: bool
    layer: Optional[str]
    stacked: bool = True
    group: str = "shard"

    def one_layer(self) -> "_Leaf":
        """A layer leaf's layout at one layer (its stacked dim 0 taken)."""
        if not self.stacked:
            return self
        return dataclasses.replace(self, block=self.block[1:],
                                   data_dim=self.data_dim - 1)


# a spec entry split over data -> its data group (``comm.axis_size``)
_GROUPS = {"data": "shard", ("pod", "data"): "data"}


def _layout(cfg: ModelConfig, mesh) -> List[_Leaf]:
    first = {a: mesh.coords[a] == 0 for a in mesh.axis_names}
    shapes = param_shapes(cfg)
    stack_of = flatten({k: tree_map(lambda _, k=k: k if k in STACKS
                                    else "", v)
                        for k, v in shapes.items()})
    out = []
    for shape, sh, stack in zip(flatten(shapes),
                                flatten(state_shardings(cfg, mesh)[0]),
                                stack_of):
        dim, group = None, "shard"
        for i, a in enumerate(sh.spec):
            if a in _GROUPS:
                dim, group = i, _GROUPS[a]
            elif a not in (None, "model"):
                raise NotImplementedError(
                    f"spec {sh.spec}: the step takes 'data', ('pod', "
                    "'data') and 'model' entries only")
        held = {n for a in sh.spec if a
                for n in (a if isinstance(a, tuple) else (a,))}
        out.append(_Leaf(sh.block_shape(shape.shape),
                         dim if comm.axis_size(mesh, group) > 1 else None,
                         all(a in held or first[a] for a in first),
                         stack or None, stack != "shared", group))
    return out


def layer_column_bytes(cfg: ModelConfig, mesh) -> int:
    """The bytes of one layer's gathered column on a rank of ``mesh``: its
    leaves split over a data group, whole along it, in the compute dtype
    (0 where every data group is one rank: nothing is gathered); the
    largest over the stacks (``STACKS``)."""
    size = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                       ).element_size()
    per = {}
    for l in _layout(cfg, mesh):
        if l.layer and l.data_dim is not None:
            per[l.layer] = per.get(l.layer, 0) + math.prod(
                l.one_layer().block) * comm.axis_size(mesh, l.group) * size
    return max(per.values(), default=0)


def _columns(every: torch.Tensor, leaves: List[_Leaf]) -> List[torch.Tensor]:
    """The leaves' columns in one gathered buffer (``comm.data_all_gather``:
    row j holds the group's row j's blocks, in ``leaves``' order)."""
    out, at = [], 0
    for l in leaves:
        n = math.prod(l.block)
        out.append(torch.cat([row[at:at + n].view(l.block) for row in every],
                             dim=l.data_dim))
        at += n
    return out


def _row_chunks(cols: List[torch.Tensor], leaves: List[_Leaf], D: int
                ) -> torch.Tensor:
    """The columns laid out flat as D equal chunks, chunk j the group's
    row j's blocks in ``leaves``' order (what ``comm.data_reduce_scatter``
    hands row j)."""
    return torch.cat([c.narrow(l.data_dim, j * l.block[l.data_dim],
                               l.block[l.data_dim]).reshape(-1)
                      for j in range(D) for c, l in zip(cols, leaves)])


def _by_group(leaves: List[_Leaf]) -> Dict[str, List[int]]:
    """The indices of ``leaves`` in each data group, in order."""
    out: Dict[str, List[int]] = {}
    for k, l in enumerate(leaves):
        out.setdefault(l.group, []).append(k)
    return out


def _gather(blocks: List[torch.Tensor], leaves: List[_Leaf], cdt, mesh,
            sizes: Optional[List[int]] = None) -> List[torch.Tensor]:
    """The columns of the split ``leaves`` from this rank's ``blocks``: one
    all_gather of a flat buffer in ``cdt`` over each data group, in
    ``leaves``' order; each buffer's bytes appended to ``sizes``."""
    out = [None] * len(leaves)
    for group, ks in _by_group(leaves).items():
        every = comm.data_all_gather(torch.cat(
            [blocks[k].reshape(-1) for k in ks]).to(cdt), mesh, group)
        if sizes is not None:
            sizes.append(every.numel() * every.element_size())
        for k, c in zip(ks, _columns(every, [leaves[k] for k in ks])):
            out[k] = c
    return out


def _reduce(cols: List[torch.Tensor], leaves: List[_Leaf], mesh,
            repeated: bool) -> List[torch.Tensor]:
    """This rank's f32 blocks of the split ``leaves``' summed gradients
    from its column gradients ``cols``: one reduce_scatter over each data
    group; the pod's column's sum then summed over the pods, or, where
    every pod computed the same rows (``repeated``), the pod × data sum
    divided by the pod count (module note, step 2)."""
    out = [None] * len(leaves)
    for group, ks in _by_group(leaves).items():
        mine = comm.data_reduce_scatter(_row_chunks(
            [cols[k] for k in ks], [leaves[k] for k in ks],
            comm.axis_size(mesh, group)).float(), mesh, group)
        if group == "shard" and not repeated:
            mine = comm.pod_sum(mine, mesh)
        elif group == "data" and repeated:
            mine = mine / comm.axis_size(mesh, "pod")
        for k, piece in zip(ks, _cut(mine, [leaves[k].block for k in ks])):
            out[k] = piece
    return out


def _cut(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    """``flat`` cut into views of ``shapes``, in order."""
    out, at = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[at:at + n].view(shape))
        at += n
    return out


class _Gauge:
    """The per-layer gather on this rank: ``live`` the bytes of gathered
    layer columns alive now (a column counts until its last reference
    dies, the step's own or any other), ``peak`` the most since
    ``reset()``, ``gathers`` each layer gather's payload bytes since then
    and ``reductions`` the layer reductions since then. The FSDP step
    resets it at its start."""

    def __init__(self):
        self.live = 0
        self.reset()

    def reset(self) -> None:
        self.peak = self.live
        self.gathers: List[int] = []
        self.reductions = 0

    def hold(self, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._drop, n)

    def _drop(self, n: int) -> None:
        self.live -= n


GAUGE = _Gauge()


def _address(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _GatherLayer(torch.autograd.Function):
    """Layer i's gathered columns (``_Layers.gather``); backward: their
    gradients reduced into the rank's f32 blocks (``_Layers.reduce``).
    ``anchor``, an empty tensor that requires grad, puts the node in the
    graph."""

    @staticmethod
    def forward(ctx, layers: "_Layers", i: int, anchor):
        ctx.layers, ctx.i = layers, i
        return tuple(layers.gather(i))

    @staticmethod
    def backward(ctx, *grads):
        ctx.layers.reduce(ctx.i, list(grads))
        return None, None, None


class _Layers(cm.LayerSource):
    """One slice's stack of layers for the family's forward (step 4 of the
    module note): layer i's tree in the compute dtype, its leaves split
    over "data" gathered (``_GatherLayer``), the others the rank's f32
    blocks (``whole``, requiring grad) cast. ``_hooks`` are the slice's
    saved-tensor hooks; the gathered columns are held in ``live`` from
    their gather to ``release`` and nowhere else in the step."""

    def __init__(self, template, split_mask: List[bool], blocks, whole,
                 grads, leaves: List[_Leaf], cdt, mesh, repeated: bool):
        self.template = template  # the layer tree, leaves numbered
        self.split_mask = split_mask
        self.blocks = blocks  # the split leaves' f32 blocks (L, ...)
        self.whole = [w.unbind(0) for w in whole]
        self.grads = grads  # the split leaves' f32 block gradients (L, ...)
        self.leaves = leaves  # the split leaves at one layer
        self.cdt, self.mesh, self.repeated = cdt, mesh, repeated
        self.live: Dict[int, List[torch.Tensor]] = {}
        self.where: Dict[int, Tuple[int, int]] = {}
        self.anchor = (torch.empty(0, device=blocks[0].device,
                                   requires_grad=True) if blocks else None)

    def __getitem__(self, i: int):
        split = iter(_GatherLayer.apply(self, i, self.anchor)
                     if self.blocks else ())
        whole = iter([w[i].to(self.cdt) for w in self.whole])
        return unflatten(self.template, [next(split) if s else next(whole)
                                         for s in self.split_mask])

    def gather(self, i: int) -> List[torch.Tensor]:
        cols = _gather([b[i] for b in self.blocks], self.leaves, self.cdt,
                       self.mesh, GAUGE.gathers)
        for k, c in enumerate(cols):
            self.where[_address(c)] = (i, k)
            GAUGE.hold(c)
        self.live[i] = cols
        return cols

    def reduce(self, i: int, grads: List[torch.Tensor]) -> None:
        for g, piece in zip(self.grads, _reduce(grads, self.leaves,
                                                self.mesh, self.repeated)):
            g[i] += piece
        GAUGE.reductions += 1
        self.release(i)

    def release(self, i: int) -> None:
        for c in self.live.pop(i, ()):
            self.where.pop(_address(c), None)



def _hooks(sources: List[_Layers]):
    """The slice's saved-tensor hooks over its stacks' ``_Layers``: a
    gathered column is saved as a token (its stack, layer, leaf and view),
    which the backward gathers again at its first use."""
    def pack(t: torch.Tensor):
        for n, src in enumerate(sources):
            at = src.where.get(_address(t))
            if at is not None:
                return (n, at, t.size(), t.stride(), t.storage_offset())
        return t

    def unpack(saved):
        if isinstance(saved, torch.Tensor):
            return saved
        n, (i, k), size, stride, offset = saved
        src = sources[n]
        cols = src.live.get(i) or src.gather(i)
        return cols[k].as_strided(size, stride, offset)

    return pack, unpack


def microbatch_rows(b: int, nmb: int, shape: Dict[str, int]
                    ) -> Tuple[int, bool]:
    """How the step lays out the slices of a global batch of ``b`` rows in
    ``nmb`` microbatches on a mesh of ``shape`` (axis -> size; module
    note, step 2): (the data rows a slice's rows split over, whether every
    pod computes the same rows). Raises ValueError for any other cut."""
    pods, D = shape.get("pod", 1), shape["data"]
    b_mb = b // nmb
    if b % nmb == 0 and b_mb % (pods * D) == 0:
        return pods * D, False
    if b % nmb == 0 and pods > 1 and b_mb < pods * D and b_mb % D == 0:
        return D, True
    if pods == 1:
        raise ValueError(f"batch {b} does not cut into {nmb} microbatches "
                         f"split over {D} data rows")
    raise ValueError(
        f"batch {b} in {nmb} microbatches: {b / nmb:g} rows a microbatch "
        f"split over neither the {pods * D} data rows of ('pod', 'data') "
        f"nor, fewer than those, the {D} rows of 'data' within each of "
        f"the {pods} pods")


def _check_groups(cfg: ModelConfig, rows: int, seq: int, mine: int) -> None:
    """An MoE slice's routing groups (``moe._route``: of the slice's whole
    batch of ``rows`` rows) must each lie in the ``mine`` rows a rank
    holds."""
    t_all = rows * seq
    G = max(1, t_all // cfg.moe_group_size)
    while t_all % G:
        G -= 1
    if (mine * seq) % (t_all // G):
        raise NotImplementedError(
            f"{cfg.name}: routing groups of {t_all // G} tokens span the "
            f"{mine * seq} tokens a rank holds; the FSDP step routes each "
            "rank's groups alone")


def fsdp_loss(params, batch, cfg: ModelConfig, mesh,
              remat_policy: str = "none", rows: str = "data") -> torch.Tensor:
    """The next-token cross-entropy of the whole slice whose rows this
    rank holds (``batch``), under the active train-mode mesh: the masked
    sum of the rows' nll over every data row of the group ``rows``
    (``comm.axis_size``: "data", or "shard" where every pod computes the
    same rows) divided by their count (``batch["loss_mask"]`` (b, s), all
    ones without it). The logits of a
    vocabulary split over "model" stay split: the log-sum-exp takes the
    maximum over the ranks (no gradient: it cancels), then the sum of exp
    and the target logit (held by one rank) in one all-reduce."""
    logits = registry.get_family(cfg).model_forward(
        params, batch, cfg, remat_policy=remat_policy)
    tgt = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1]
    lay = cm.shard_layout(cfg)
    if lay is None or not lay.vocab_split:
        m = lg.amax(-1)
        shifted = (lg - m[..., None]).float()
        lse = m.float() + torch.log(torch.exp(shifted).sum(-1))
        tl = lg.gather(-1, tgt[..., None])[..., 0].float()
    else:
        v0, vl = lay.vocab
        m = comm.all_reduce_max(lg.detach().amax(-1)).to(lg.dtype)
        shifted = (lg - m[..., None]).float()
        local = tgt - v0
        mine = (local >= 0) & (local < vl)
        tl = torch.where(mine, lg.gather(-1, local.clamp(0, vl - 1)[..., None])
                         [..., 0].float(), 0.0)
        se, tl = comm.all_reduce_sum(torch.stack([torch.exp(shifted).sum(-1),
                                                  tl]))
        lse = m.float() + torch.log(se)
    nll = lse - tl
    mask = batch.get("loss_mask")
    w = mask[:, 1:].float() if mask is not None else torch.ones_like(nll)
    tot = comm.all_reduce_sum(torch.stack([(nll * w).sum(), w.sum()]), mesh,
                              axis=rows)
    return tot[0] / torch.clamp(tot[1], min=1.0)


def _stacked(t: torch.Tensor, stack: str) -> torch.Tensor:
    """A stack's leaf with its layer axis: the unstacked "shared" block's
    leaves as a stack of one (a view)."""
    return t.unsqueeze(0) if stack == "shared" else t


def make_fsdp_grads(cfg: ModelConfig, tc: TrainConfig, mesh):
    """Returns grads(params, batch) -> (loss, grads): steps 1 to 4 of the
    module note on this rank of ``mesh``: the mean of the microbatches'
    losses (equal on every rank) and the rank's f32 blocks of the mean
    gradient, unclipped, in ``params``' structure. The leaves outside the
    layers are gathered once, each layer's where it runs, forward and
    backward (``_Layers``); ``GAUGE`` is reset at the start. params: the
    rank's f32 blocks (``shard_train_state``); batch: the global batch
    (every rank passes the same)."""
    leaves = _layout(cfg, mesh)
    entry = [i for i, l in enumerate(leaves)
             if not l.layer and l.data_dim is not None]
    whole = [i for i, l in enumerate(leaves) if l.data_dim is None]
    stacks = {}  # name -> (its leaves, those split over "data")
    for i, l in enumerate(leaves):
        if l.layer:
            stacks.setdefault(l.layer, ([], []))[0].append(i)
            if l.data_dim is not None:
                stacks[l.layer][1].append(i)
    cdt = getattr(torch, cfg.compute_dtype)

    def entry_columns(blocks) -> List[torch.Tensor]:
        return [c.float() for c in _gather(
            [blocks[i] for i in entry], [leaves[i] for i in entry], cdt,
            mesh)] if entry else []

    def reduce_step_long(col_grads, repeated: bool
                         ) -> Dict[int, torch.Tensor]:
        out = {}
        if entry:
            out.update(zip(entry, _reduce(
                [col_grads[i] for i in entry], [leaves[i] for i in entry],
                mesh, repeated)))
        if whole:
            out.update(zip(whole, _cut(
                comm.data_sum(torch.cat([col_grads[i].reshape(-1)
                                         for i in whole]), mesh,
                              "shard" if repeated else "data"),
                [leaves[i].block for i in whole])))
        return out

    def loss_and_grads(params, batch):
        blocks = flatten(params)
        for b, l in zip(blocks, leaves):
            if tuple(b.shape) != l.block or b.dtype != torch.float32:
                raise ValueError(
                    f"a param block {tuple(b.shape)} {b.dtype}: the step "
                    f"takes this rank's f32 blocks {l.block} "
                    "(shard_train_state)")
        b = batch["tokens"].shape[0]
        nmb = max(1, tc.num_microbatches)
        rows_n, repeated = microbatch_rows(b, nmb, mesh.shape)
        # this rank's row of a slice: its index over pod x data
        # (rules.dp_axes), or over "data" alone where the pods repeat it
        row = rules.axis_block(mesh, "data" if repeated
                               else rules.dp_axes(mesh))[0]
        b_mb = b // nmb
        bl = b_mb // rows_n
        if cfg.n_experts and rows_n > 1:
            _check_groups(cfg, b_mb, batch["tokens"].shape[1], bl)
        GAUGE.reset()
        col = [None] * len(blocks)
        for i, c in zip(entry, entry_columns([p.detach() for p in blocks])):
            col[i] = c.requires_grad_(True)
        for i in whole:
            col[i] = blocks[i].detach().requires_grad_(True)
        layer_grads = {name: [torch.zeros_like(_stacked(blocks[i], name))
                              for i in split]
                       for name, (_, split) in stacks.items()}
        tree = unflatten(params, col)
        rows = (rules.DataSplit(size=rows_n, index=row,
                                slots=(row * bl, bl), blocks=(0, 1),
                                n_slots=b_mb, n_blocks=1)
                if rows_n > 1 else None)
        l_sum = torch.zeros((), dtype=torch.float32,
                            device=batch["tokens"].device)
        for i in range(nmb):
            lo = i * b_mb + row * bl
            mb = {k: v[lo:lo + bl] for k, v in batch.items()}
            with comm.serving(mesh, rows, mode="train"), \
                    torch.enable_grad():
                sources = []
                for name, (layer, split) in stacks.items():
                    src = _Layers(
                        unflatten(params[name], list(range(len(layer)))),
                        [j in split for j in layer],
                        [_stacked(blocks[j].detach(), name) for j in split],
                        [_stacked(col[j], name) for j in layer
                         if j not in split],
                        layer_grads[name],
                        [leaves[j].one_layer() for j in split], cdt, mesh,
                        repeated)
                    tree[name] = src
                    sources.append(src)
                with torch.autograd.graph.saved_tensors_hooks(
                        *_hooks(sources)):
                    loss_i = fsdp_loss(tree, mb, cfg, mesh, tc.remat_policy,
                                       "shard" if repeated else "data")
                loss_i.backward()
            l_sum = l_sum + loss_i.detach()
        del tree, sources
        reduced = reduce_step_long(
            [None if c is None else torch.zeros_like(c) if c.grad is None
             else c.grad for c in col], repeated)
        del col
        for name, (_, split) in stacks.items():
            reduced.update(zip(split, [g if name != "shared" else g[0]
                                       for g in layer_grads[name]]))
        grads = [reduced[i] for i in range(len(blocks))]
        if nmb > 1:
            grads = [g / nmb for g in grads]
        return l_sum / nmb, unflatten(params, grads)

    return loss_and_grads


def make_fsdp_train_step(cfg: ModelConfig, tc: TrainConfig, mesh):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics) on this rank of ``mesh`` (``launch.mesh.Mesh``): params and
    opt_state are the rank's blocks (``shard_train_state``; f32 masters),
    batch the global batch on the mesh's device (every rank passes the
    same), metrics as the module note says. The collectives are
    ``comm``'s, counted in ``comm.STATS`` by axis; ``GAUGE`` holds the
    step's layer gathers. ``tc.zero_stage`` is not read (the reference
    reads it nowhere either)."""
    loss_and_grads = make_fsdp_grads(cfg, tc, mesh)
    counted = [l.counted for l in _layout(cfg, mesh)]
    world = mesh.size

    def global_norm(grads) -> torch.Tensor:
        total = torch.zeros(1, dtype=torch.float32, device=grads[0].device)
        for g, c in zip(grads, counted):
            if c:
                total = total + g.float().square().sum()
        if world > 1:
            total = comm.world_sum(total, mesh)
        return torch.sqrt(total[0])

    def step(params, opt_state: adamw.OptState, batch):
        loss, grads = loss_and_grads(params, batch)
        grads = flatten(grads)
        gnorm = global_norm(grads)
        scale = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = unflatten(params, [g * scale for g in grads])
        lr = schedules.learning_rate(opt_state.step, tc)
        new_params, new_opt = adamw.adamw_update(grads, opt_state, params,
                                                 lr, tc)
        del grads
        if tc.skip_nonfinite:
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)

            def keep(new, old):  # into the new tensor: no second copy
                return torch.where(ok, new, old, out=new)

            new_params = tree_map(keep, new_params, params)
            new_opt = tree_map(keep, new_opt, opt_state)
        else:
            ok = torch.ones((), dtype=torch.bool, device=loss.device)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm,
                                     "lr": lr, "step_ok": ok.float()}

    return step
