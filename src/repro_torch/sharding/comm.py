"""Collectives of the port's sharded serving, and the ranks that run them.

Ranks: ``spawn(fn, world, timeout=...)`` starts ``world`` processes, each
joining one ``torch.distributed`` world (``init_ranks``) through a file
store in a fresh temporary directory, so concurrent groups never meet, and
calls ``fn(rank, world, *args)`` there. The whole group runs under one
timeout: a collective that one rank never reaches would block the others
forever, so on the timeout, or when any rank fails, every rank is killed
and ``spawn`` raises.

Backend rule: NCCL when every rank has a card of its own, gloo when ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU. It
picks the transport by the cards present; no compute leaves the device
(gloo stages a CUDA tensor's reduction through host memory).

Model-axis collectives are ``all_reduce`` over the model axis of the
active mesh (``serving(mesh)``, set by the engine around its model calls):

* ``all_reduce_sum``: partial products summed in f32 — the caller casts
  once after the sum, as a single-device product rounds once;
* ``gather_last``: a rank's slice of the last axis placed in a zero
  buffer of the full width and summed, exact (every position is one
  rank's value plus zeros) — the vocabulary's logits, the router's, and
  the FFN activity where it is read whole;
* ``any_reduce``: a boolean OR.

With no active mesh, or a model axis of one, each is the identity.

Under autograd (the train step, ``train/fsdp.py``) the model-axis
collectives are ``torch.autograd.Function``s whose forwards are the
values above, bit for bit, so serving does not move:

* ``all_reduce_sum`` (reduce): backward the identity — the replicated sum's
  gradient is whole on every rank and enters each partial once;
* ``copy_to_model`` (copy, Megatron's "copy to the model-parallel
  region"): forward the identity, backward the all-reduce of the
  gradient over "model" — where a replicated activation enters weights
  split over "model" (the input of ``wq``/``wk``/``wv``, ``wu``/``wg``,
  the unembedding and a split MoE router), each rank's gradient of it is
  a partial;
* ``gather_last``: backward the rank's slice of the gradient.

Each always goes through its Function; with no gradient asked for (the
serving paths run under ``torch.inference_mode``) autograd records
nothing.
``all_reduce_max`` is the vocabulary-parallel loss's maximum (no
gradient).

The model calls read the active state through ``active``, ``data_split``
and ``mode`` ("serve", or "train" for the FSDP step's train-mode layout,
``models/common.py::shard_layout``). The state is per thread; a block that
autograd recomputes in the backward (remat) re-enters the state it ran
under (``snapshot`` / ``restored``), and a Function's backward keeps its
mesh from the forward, since autograd may run both on a thread of its
own.

Data-axis collectives run over the active data split (``serving(mesh,
data)``, a ``rules.DataSplit``): ``data_gather`` puts the tensors of every
row of the rank's data column together in data-index order (one
``all_gather`` of their bytes, exact), ``data_max`` takes the maximum
over the rows (the batch union of a static tile selection), and
``world_sum`` sums over every rank of the mesh (the step's per-slot
values, once a step). ``data_gather`` and ``data_sum`` (an all-reduce
over the data column) also take a mesh of their own: the DDP train
step's gradient mean. ``check_same``: every rank of the mesh holds the
same host value (a checksum of the sampled tokens, once a step); a
mismatch raises.

The FSDP step's data-axis collectives each take one flat buffer, for
the leaves outside the layers once a step and for each layer where it
runs (``train/fsdp.py``): ``data_all_gather`` (every row's buffer, in
data-index order) and ``data_reduce_scatter`` (the sum over the data
column, this row's equal chunk), over the data column within the pod
("shard") or, for a leaf split over pod × data, over the whole data
column ("data"); ``pod_sum`` sums over the pods;
``all_reduce_sum(x, mesh, "data")`` is the loss's masked sum and count
over the data column (or "shard", where every pod computes the same
rows), in the graph autograd differentiates (backward the identity).
``axis_size`` gives each group's ranks. ``model_gather`` puts
tensors of every rank of the model row together (the sequence-sharded decode
attention's partial softmaxes); ``gather_to_first`` a tensor of every
rank of the mesh on its rank 0 (the sharded checkpoint's save).

Megatron-SP residuals (``models/transformer.py::forward`` under
``cfg.sp_residuals``, ``sequence_parallel`` / ``sp_on``) split the
residual's last axis over "model": ``reduce_scatter_last`` (a sublayer's
partial sums, this rank's chunk; backward the all-gather) and
``all_gather_last`` (the chunks put together; backward the
reduce-scatter, or with ``whole_grad`` the rank's chunk of a gradient
that is whole on every rank) are each the other's backward;
``split_last`` takes a replicated tensor's chunk (backward the
all-gather).

``STATS`` counts the collectives of each axis and the host time spent in
them, and each kind's wire bytes (``WIRE_MULT``): what the dry run
(``launch/dryrun.py``) reads on its "fake" world, where the collectives
move nothing.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import queue as queue_mod
import shutil
import tempfile
import threading
import time
import traceback
from typing import Callable

import numpy as np
import torch

_LOCAL = threading.local()


class _Stats:
    """Collectives issued since ``reset()``, the host seconds spent in them
    (for a CUDA tensor under gloo this includes waiting for the card to
    reach the call) and their payload bytes (what the rank hands the call:
    the reduced tensor, or the gathered pieces of every rank):
    ``count`` / ``seconds`` / ``bytes`` over the model axis, ``data_*``
    over the data axis (any of its groups: within the pod, over pod ×
    data, or over the pods), ``pod_*`` those of them over the pod group
    alone (``pod_sum``), ``world_*`` over the whole mesh. ``kinds`` counts
    them by kind ("all-reduce", "all-gather", "reduce-scatter", "gather")
    and ``wire`` sums each kind's wire bytes a rank: the result's bytes
    times the kind's ring multiplier (``WIRE_MULT``, the reference's
    ``dryrun._COLL_MULT``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        for prefix in ("", "data_", "pod_", "world_"):
            setattr(self, prefix + "count", 0)
            setattr(self, prefix + "seconds", 0.0)
            setattr(self, prefix + "bytes", 0)
        self.kinds = {}
        self.wire = {}

    def add(self, axis: str, seconds: float, nbytes: int = 0,
            kind: str = "all-reduce", result_bytes: int = 0) -> None:
        prefixes = {"model": ("",), "world": ("world_",),
                    "pod": ("data_", "pod_")}.get(axis, ("data_",))
        for prefix in prefixes:
            for key, value in (("count", 1), ("seconds", seconds),
                               ("bytes", nbytes)):
                setattr(self, prefix + key,
                        getattr(self, prefix + key) + value)
        self.kinds[kind] = self.kinds.get(kind, 0) + 1
        self.wire[kind] = (self.wire.get(kind, 0)
                           + WIRE_MULT[kind] * result_bytes)

    def by_axis(self) -> dict:
        """{axis: {"count", "payload_bytes"}} for "model", "data", "pod"
        (a part of "data") and "world"."""
        return {axis: {"count": getattr(self, p + "count"),
                       "payload_bytes": getattr(self, p + "bytes")}
                for axis, p in (("model", ""), ("data", "data_"),
                                ("pod", "pod_"), ("world", "world_"))}


# wire bytes a rank per result byte, by collective kind (ring algorithms)
WIRE_MULT = {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
             "gather": 1}

STATS = _Stats()


def backend_for(device, world: int) -> str:
    """"nccl" when ``device`` is a card and every one of the ``world`` ranks
    has a card of its own; "gloo" otherwise (ranks sharing a card, or the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int) -> torch.device:
    """The card of ``rank``: cuda:(rank mod the cards present). Raises when
    CUDA is absent — the port never runs on the CPU unasked."""
    from repro_torch.models.common import resolve_device
    resolve_device("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_ranks(rank: int, world: int, init_method: str, device,
               timeout_s: float = 300.0) -> str:
    """Join the ``world``-rank torch.distributed world as ``rank`` through
    ``init_method`` (a ``file://`` store or ``tcp://localhost:<port>``),
    with the backend of ``backend_for(device, world)``; a collective that
    waits longer than ``timeout_s`` fails. Returns the backend."""
    import torch.distributed as dist
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(device, world)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return backend


def _child(fn, rank, world, init_method, device, timeout_s, args, results):
    import torch.distributed as dist
    try:
        dev = torch.device(device) if device != "cuda" else rank_device(rank)
        if dev.type == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_ranks(rank, world, init_method, dev, timeout_s)
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, timeout: float, args=(),
          device="cuda") -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` fresh processes joined in
    one torch.distributed world; ``device`` "cuda" puts rank r on
    ``rank_device(r)``, "cpu" on the CPU. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function). Returns the ranks' results in rank
    order. Raises when a rank fails (with its traceback) or when the group
    has not finished within ``timeout`` seconds; either way every rank
    still running is killed first."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_method = "file://" + os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world, init_method, device, timeout,
                               args, results))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    got, error = {}, None
    try:
        for p in procs:
            p.start()
        while len(got) < world and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = (f"rank group of {world} timed out after {timeout} s "
                         f"({sorted(got)} finished)")
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    error = f"ranks {dead} died without a result"
                continue
            if ok:
                got[rank] = out
            else:
                error = f"rank {rank} failed:\n{out}"
    except BaseException as e:
        error = error or f"starting the rank group failed: {e!r}"
        raise
    finally:
        for p in (p for p in procs if p.pid is not None):
            if p.is_alive() and not error:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    if error:
        raise RuntimeError(error)
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# the active mesh


@contextlib.contextmanager
def serving(mesh, data=None, mode: str = "serve"):
    """Run the block's model calls split over ``mesh``'s model axis (None,
    or a model axis of one: unsplit) and, with ``data`` (a
    ``rules.DataSplit``), over its data axis: the rank's slots and pool
    blocks (or, in training, its rows of the batch). ``mode``: the rules'
    mode the weights were sharded in, "serve" or "train". Per thread; the
    previous state comes back on exit, so a sharded engine never leaks its
    mesh into another engine's steps."""
    from repro_torch.sharding.rules import tp_size
    if mode not in ("serve", "train"):
        raise ValueError(f"mode {mode!r}: 'serve' or 'train'")
    with restored((mesh if tp_size(mesh) > 1 else None,
                   None if data is None else (data, mesh), mode, False)):
        yield


def snapshot() -> tuple:
    """The active state of this thread (mesh, data split, mode, sequence
    parallel)."""
    return (getattr(_LOCAL, "mesh", None), getattr(_LOCAL, "data", None),
            getattr(_LOCAL, "mode", "serve"), getattr(_LOCAL, "sp", False))


@contextlib.contextmanager
def restored(state: tuple):
    """Run the block under ``state`` (a ``snapshot``), on any thread; the
    previous state comes back on exit."""
    prev = snapshot()
    _LOCAL.mesh, _LOCAL.data, _LOCAL.mode, _LOCAL.sp = state
    try:
        yield
    finally:
        _LOCAL.mesh, _LOCAL.data, _LOCAL.mode, _LOCAL.sp = prev


@contextlib.contextmanager
def sequence_parallel(on: bool = True):
    """Run the block with Megatron-SP residuals (``sp_on``) when ``on`` and
    a model axis is active; the previous setting comes back on exit."""
    mesh, data, mode, _ = snapshot()
    with restored((mesh, data, mode, bool(on) and mesh is not None)):
        yield


def sp_on() -> bool:
    """Whether the full-sequence blocks keep their residual split over the
    model axis on d_model (``models/transformer.py::forward`` under
    ``cfg.sp_residuals``)."""
    return getattr(_LOCAL, "sp", False)


def active():
    """The mesh the current model calls split over, or None."""
    return getattr(_LOCAL, "mesh", None)


def mode() -> str:
    """The rules' mode of the active mesh's weights: "serve" or "train"."""
    return getattr(_LOCAL, "mode", "serve")


def data_split():
    """The data split (``rules.DataSplit``) the current model calls run
    under, or None."""
    d = getattr(_LOCAL, "data", None)
    return None if d is None else d[0]


def axis_size(mesh, axis: str) -> int:
    """The ranks of this rank's group ``axis`` of ``mesh``: "model" (its
    model row), "data" (its data column: over pod × data on a pod mesh,
    ``rules.dp_axes``), "shard" (the data column within its pod: the
    data column on a mesh without pods), "pod" (its peers in the other
    pods) or "world"."""
    pods = mesh.shape.get("pod", 1)
    return {"model": mesh.shape["model"], "data": pods * mesh.shape["data"],
            "shard": mesh.shape["data"], "pod": pods,
            "world": math.prod(mesh.shape.values())}[axis]


def _group(mesh, axis: str):
    """The process group of ``axis`` (``axis_size``) on ``mesh``; "shard"
    is the data group on a mesh without pods."""
    return {"model": mesh.group, "data": mesh.data_group,
            "shard": getattr(mesh, "shard_group", None) or mesh.data_group,
            "world": mesh.world_group,
            "pod": getattr(mesh, "pod_group", None)}[axis]


def _all_reduce(t: torch.Tensor, mesh, op=None, axis: str = "model"
                ) -> torch.Tensor:
    import torch.distributed as dist
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=_group(mesh, axis))
    n = t.numel() * t.element_size()
    STATS.add(axis, time.perf_counter() - t0, n, "all-reduce", n)
    return t


class _ReduceSum(torch.autograd.Function):
    """Forward: the f32 sum of each rank's x over ``axis``. Backward: the
    identity, cast to x's dtype."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.dtype = x.dtype
        return _all_reduce(x.to(torch.float32, copy=True), mesh, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient summed over the model
    axis in f32, cast back once."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.to(torch.float32, copy=True),
                           ctx.mesh).to(g.dtype), None


class _GatherLast(torch.autograd.Function):
    """Forward: the ranks' slices of the last axis in a zero-padded f32
    sum. Backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, total, offset, mesh):
        ctx.dtype, ctx.at = x.dtype, (offset, x.shape[-1])
        buf = x.new_zeros(x.shape[:-1] + (total,), dtype=torch.float32)
        buf[..., offset:offset + x.shape[-1]] = x
        return _all_reduce(buf, mesh).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        offset, width = ctx.at
        return g[..., offset:offset + width].to(ctx.dtype), None, None, None


def all_reduce_sum(x: torch.Tensor, mesh=None,
                   axis: str = "model") -> torch.Tensor:
    """The sum over ``mesh``'s group ``axis`` ("model", "data" or "shard":
    ``axis_size``) of each rank's partial ``x``, in f32 (a new tensor;
    ``x`` is not changed); the mesh defaults to the active one. Without a
    mesh, or with a group of one rank: x in f32. Under autograd its
    backward is the identity."""
    mesh = mesh or active()
    if mesh is None or axis_size(mesh, axis) == 1:
        return x.to(torch.float32, copy=True)
    return _ReduceSum.apply(x, mesh, axis)


def copy_to_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x``, replicated over the model axis, entering products split over
    it: the identity, whose backward sums the ranks' partial gradients
    (one all-reduce). Without an active mesh, x itself."""
    mesh = mesh or active()
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def all_reduce_max(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the model axis, in f32 (a new
    tensor, no gradient)."""
    import torch.distributed as dist
    mesh = mesh or active()
    y = x.detach().to(torch.float32, copy=True)
    return y if mesh is None else _all_reduce(y, mesh, op=dist.ReduceOp.MAX)


def any_reduce(mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """The OR over the model axis of each rank's boolean ``mask``."""
    mesh = mesh or active()
    if mesh is None:
        return mask
    return _all_reduce(mask.to(torch.uint8), mesh) > 0


def gather_last(x: torch.Tensor, total: int, offset: int,
                mesh=None) -> torch.Tensor:
    """Every rank's slice of the last axis (this rank's at ``offset``) put
    together into the full width ``total``, in x's dtype: a zero-padded f32
    sum, exact."""
    mesh = mesh or active()
    return x if mesh is None else _GatherLast.apply(x, total, offset, mesh)


def _all_gather_into(out, src, group) -> None:
    """The ranks' ``src`` along dim 0 of ``out`` (``all_gather_single``
    where torch has it, else ``all_gather_into_tensor``)."""
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    fn(out, src, group=group)


def _reduce_scatter_into(out, src, group) -> None:
    """The sum of the ranks' ``src``, this rank's dim-0 chunk into ``out``
    (``reduce_scatter_single`` where torch has it, else
    ``reduce_scatter_tensor``)."""
    import torch.distributed as dist
    fn = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    fn(out, src, group=group)


def _reduce_scatter_last(x: torch.Tensor, mesh) -> torch.Tensor:
    import torch.distributed as dist
    n = mesh.shape["model"]
    src = x.movedim(-1, 0).contiguous()  # rank r's chunk: rows r·D/n ..
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    t0 = time.perf_counter()
    _reduce_scatter_into(out, src, group=mesh.group)
    STATS.add("model", time.perf_counter() - t0,
              src.numel() * src.element_size(), "reduce-scatter",
              out.numel() * out.element_size())
    return out.movedim(0, -1)


def _all_gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    import torch.distributed as dist
    n = mesh.shape["model"]
    src = x.movedim(-1, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    t0 = time.perf_counter()
    _all_gather_into(out, src, group=mesh.group)
    nbytes = out.numel() * out.element_size()
    STATS.add("model", time.perf_counter() - t0, nbytes, "all-gather",
              nbytes)
    return out.movedim(0, -1)


def _slice_last(x: torch.Tensor, mesh) -> torch.Tensor:
    width = x.shape[-1] // mesh.shape["model"]
    return x.narrow(-1, mesh.coords["model"] * width, width)


class _ReduceScatterLast(torch.autograd.Function):
    """Forward: the sum over the model axis of each rank's x (..., D), this
    rank's D / M chunk of the last axis. Backward: the all-gather of the
    chunks' gradients (every rank's partial enters the sum once)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _reduce_scatter_last(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.mesh), None


class _AllGatherLast(torch.autograd.Function):
    """Forward: every rank's chunk of the last axis put together, in rank
    order. Backward: with ``whole`` False the reduce-scatter of the
    gradient (each rank's use of the whole tensor gave a partial of it);
    with ``whole`` True this rank's chunk of it (the consumers summed
    their partials already, e.g. through ``copy_to_model``, so every rank
    holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, whole):
        ctx.mesh, ctx.whole = mesh, whole
        return _all_gather_last(x, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.whole:
            return _slice_last(g, ctx.mesh), None, None
        return _reduce_scatter_last(g, ctx.mesh), None, None


class _SplitLast(torch.autograd.Function):
    """Forward: this rank's chunk of the last axis of a replicated x.
    Backward: the all-gather of the chunks' gradients (the whole gradient
    on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _slice_last(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.mesh), None


def reduce_scatter_last(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The sum over the model axis of each rank's partial ``x`` (..., D),
    this rank's chunk of D (the Megatron-SP sublayer output: half an
    all-reduce). Backward: ``all_gather_last`` of the gradient. Without
    a mesh, x."""
    mesh = mesh or active()
    return x if mesh is None else _ReduceScatterLast.apply(x, mesh)


def all_gather_last(x: torch.Tensor, mesh=None,
                    whole_grad: bool = False) -> torch.Tensor:
    """Every rank's chunk of the last axis put together (the other half of
    an all-reduce). Backward: ``reduce_scatter_last`` of the gradient, or
    with ``whole_grad`` (every rank's gradient of the result is already
    the whole one) this rank's chunk of it. Without a mesh, x."""
    mesh = mesh or active()
    return x if mesh is None else _AllGatherLast.apply(x, mesh, whole_grad)


def split_last(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """This rank's chunk of the last axis of a replicated ``x`` (a view).
    Backward: the all-gather of the gradient. Without a mesh, x."""
    mesh = mesh or active()
    return x if mesh is None else _SplitLast.apply(x, mesh)


def _pieces(tensors):
    """Each tensor's bytes, padded to a multiple of 8 so that every piece
    of the packed buffer starts aligned for any dtype."""
    out = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % 8
        out.append(torch.nn.functional.pad(b, (0, pad)) if pad else b)
    return out


def _gather(tensors, n: int, group, axis: str) -> list:
    """Each of ``tensors`` from the n ranks of ``group``, in rank order:
    (n, *shape) tensors. One all_gather of the packed bytes, exact."""
    import torch.distributed as dist
    if n == 1:
        return [t[None] for t in tensors]
    pieces = _pieces(tensors)
    buf = torch.cat(pieces)
    parts = [torch.empty_like(buf) for _ in range(n)]
    t0 = time.perf_counter()
    dist.all_gather(parts, buf, group=group)
    STATS.add(axis, time.perf_counter() - t0, n * buf.numel(), "all-gather",
              n * buf.numel())
    every = torch.stack(parts)
    out, at = [], 0
    for t, piece in zip(tensors, pieces):
        nbytes = t.numel() * t.element_size()
        out.append(every[:, at:at + nbytes].contiguous().view(t.dtype)
                   .reshape((n,) + tuple(t.shape)))
        at += piece.numel()
    return out


def data_gather(tensors, mesh=None) -> list:
    """Each of ``tensors`` (this rank's) from every row of its data column
    of ``mesh`` (default: the active data split's), in data-index order:
    a list of (D, *shape) tensors of the same dtypes. One all_gather of
    the packed bytes, exact."""
    mesh = mesh or _LOCAL.data[1]
    return _gather(tensors, mesh.shape["data"], mesh.data_group, "data")


def model_gather(tensors, mesh=None) -> list:
    """Each of ``tensors`` from every rank of this rank's model row of
    ``mesh`` (default: the active one), in model-index order: (M, *shape)
    tensors. One all_gather, exact."""
    mesh = mesh or active()
    return _gather(tensors, mesh.shape["model"], mesh.group, "model")


def gather_to_first(t: torch.Tensor, mesh):
    """``t`` from every rank of ``mesh`` on its rank 0, in rank order:
    (world, *shape) there, None on the others. One gather, exact."""
    import torch.distributed as dist
    world = axis_size(mesh, "world")
    if world == 1:
        return t[None]
    t = t.contiguous()
    out = t.new_empty((world,) + tuple(t.shape)) if mesh.rank == 0 else None
    t0 = time.perf_counter()
    dist.gather(t, None if out is None else list(out.unbind(0)), dst=0,
                group=mesh.world_group)
    n = t.numel() * t.element_size() * (world if out is not None else 1)
    STATS.add("world", time.perf_counter() - t0, n, "gather", n)
    return out


def data_all_gather(flat: torch.Tensor, mesh, axis: str = "shard"
                    ) -> torch.Tensor:
    """Every row's 1-D ``flat`` of this rank's data column within its pod
    (``axis`` "shard"), or over pod × data ("data": the rows in
    (pod, data) order), in that order: (n, len), one all_gather into one
    buffer."""
    import torch.distributed as dist
    n = axis_size(mesh, axis)
    if n == 1:
        return flat[None]
    out = flat.new_empty((n,) + tuple(flat.shape))
    t0 = time.perf_counter()
    dist.all_gather(list(out.unbind(0)), flat.contiguous(),
                    group=_group(mesh, axis))
    n = out.numel() * out.element_size()
    STATS.add("data", time.perf_counter() - t0, n, "all-gather", n)
    return out


def data_reduce_scatter(flat: torch.Tensor, mesh, axis: str = "shard"
                        ) -> torch.Tensor:
    """The sum over the data column within the rank's pod (``axis``
    "shard"), or over pod × data ("data"), of every row's 1-D ``flat`` (n
    equal chunks, chunk j for row j in ``data_all_gather``'s order): this
    row's chunk, one reduce_scatter."""
    n = axis_size(mesh, axis)
    if n == 1:
        return flat
    out = flat.new_empty(flat.numel() // n)
    t0 = time.perf_counter()
    _reduce_scatter_into(out, flat.contiguous(), group=_group(mesh, axis))
    STATS.add("data", time.perf_counter() - t0,
              flat.numel() * flat.element_size(), "reduce-scatter",
              out.numel() * out.element_size())
    return out


def pod_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the pods (in place; counted on the data axis),
    or x on a mesh without a "pod" axis above one."""
    if "pod" not in mesh.axis_names or mesh.shape["pod"] == 1:
        return x
    return _all_reduce(x, mesh, axis="pod")


def data_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the rows of the data axis when
    the active split cuts the batch (the rows hold different slots), else
    x."""
    split = data_split()
    if split is None or not split.slots_split:
        return x
    return data_gather([x])[0].amax(0)


def data_sum(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the rows of ``mesh``'s data column (over pod ×
    data on a pod mesh; ``axis`` "shard": within the rank's pod), in
    place."""
    return x if axis_size(mesh, axis) == 1 else _all_reduce(x, mesh,
                                                            axis=axis)


def world_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``mesh`` (in place)."""
    return _all_reduce(x, mesh, axis="world")


def token_checksum(tokens) -> int:
    """A position-weighted checksum of sampled token ids (host values)."""
    t = np.asarray(tokens, np.int64).reshape(-1)
    w = np.arange(1, t.size + 1, dtype=np.int64)
    return int((t * w).sum() % (2 ** 61 - 1))


def _one_rank(mesh) -> bool:
    return mesh is None or axis_size(mesh, "world") == 1


def check_same(value: int, mesh, what: str = "sampled tokens") -> None:
    """Raise unless every rank of the mesh passed the same ``value`` (one
    all-reduce of (value, -value) under MAX over the whole mesh)."""
    import torch.distributed as dist
    if _one_rank(mesh):
        return
    t = torch.tensor([value, -value], dtype=torch.int64, device=mesh.device)
    _all_reduce(t, mesh, op=dist.ReduceOp.MAX, axis="world")
    hi, lo = int(t[0]), -int(t[1])
    if hi != value or lo != value:
        raise RuntimeError(f"ranks disagree on the {what}: checksums range "
                           f"over [{lo}, {hi}], this rank {value}")


def barrier(mesh=None) -> None:
    """Wait for every rank of the mesh (a one-element all-reduce, so it
    works on any backend and device)."""
    mesh = mesh or active()
    if not _one_rank(mesh):
        _all_reduce(torch.zeros(1, device=mesh.device), mesh, axis="world")
