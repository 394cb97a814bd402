"""What one step computes, moves and holds, counted as its ops dispatch:
the port's counterpart of the reference's ``launch/hlo_cost.py``, which
derives the same terms from XLA's compiled HLO text.

``OpCost`` is a ``TorchDispatchMode``. Run a step under it, on "meta"
tensors (shapes only: no memory, no card; ``launch/dryrun.py``) or on
real ones, and it records:

* ``flops``: every op's FLOPs by the formulas of torch's
  ``FlopCounterMode`` (``torch.utils.flop_counter.flop_registry``), the
  same count a ``FlopCounterMode`` of the step gives. A Python loop runs
  each layer's ops once per layer, so no trip count is needed, where the
  reference scales its loop bodies by their trip counts;
* ``bytes``: the HBM bytes the ops move, each op's operand and output
  bytes. Views and allocations are free (no data moves). An in-place
  write into part of a buffer (``index_copy_``, ``index_put_``,
  ``scatter_``, ``copy_`` into a view) counts the slice it writes, read
  and written, as ``hlo_cost`` counts a dynamic-update-slice; a gather
  (``index``, ``embedding``, ``index_select``, ``gather``) reads the rows
  it outputs, not its whole table. A collective counts its tensor read
  and written; its wire bytes are ``comm.STATS``'s;
* ``peak``: the most live storage bytes. Every storage the step's ops
  make, and every tensor handed to ``hold`` (the step's arguments), is
  tracked by a weak reference to its ``UntypedStorage`` (the way
  ``torch.distributed._tools.mem_tracker`` tracks storages): its bytes,
  rounded up to the CUDA caching allocator's 512-byte blocks (the
  deployment's allocator), count from its first sight until its last
  reference dies. ``live`` is the bytes alive now;
* the top-N op profile (``profile``): each op's calls, bytes and FLOPs.

A kernel wrapper on meta tensors takes its plain version, so a step on
meta tensors is counted as the plain PyTorch ops, as the reference's HLO
counts XLA's ops and not its Pallas kernels; except kernel 5
(``kernels/sparse_matmul.py::sparse_matmul``, the static tile capacities'
gather), which reaches the dispatcher as one operator
(``repro_torch::sparse_matmul``). ``KERNEL_COSTS`` counts such an operator
by the kernel's own bytes and FLOPs, the formula of its bound
(``sparse_matmul_cost``), so a sparse cell counts the weight tiles the
kernel reads and not a plain gather's copy of them. That is a model at
the bound, not a measurement: the kernel on the card takes longer than
its bound. ``OpCost.kernels`` holds each such kernel's calls, bytes and
FLOPs.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

BLOCK = 512  # the CUDA caching allocator rounds each block up to this

_FREE = {"empty", "empty_strided", "empty_like", "new_empty", "_unsafe_view",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "set_", "resize_", "_to_copy_meta"}
_SLICE_WRITES = {"index_copy_", "index_put_", "_index_put_impl_",
                 "scatter_", "masked_scatter_", "slice_scatter",
                 "select_scatter"}
_GATHERS = {"index", "embedding", "index_select", "gather"}


def sparse_matmul_cost(T: int, D: int, K: int, nvalid: int, tile: int,
                       x_itemsize: int, w_itemsize: int) -> tuple:
    """Kernel 5's own work, its bound's formula: (HBM bytes, FLOPs). Bytes:
    the nvalid listed tiles of w (tile x D each) once, x's selected
    columns (T x nvalid x tile), the list (K int32) and nvalid, the (T, D)
    f32 output; FLOPs: 2·T·nvalid·tile·D."""
    return (nvalid * tile * D * w_itemsize + T * nvalid * tile * x_itemsize
            + K * 4 + 4 + T * D * 4, 2.0 * T * nvalid * tile * D)


def _sparse_matmul_op_cost(x, w, idx, nvalid, tile) -> tuple:
    # every listed slot counted valid (nvalid = K): a static capacity
    # lists the tiles whose score is above 0, which no meta tensor can say
    K = idx.shape[0]
    return sparse_matmul_cost(x.shape[0], w.shape[1], K, K, tile,
                              x.element_size(), w.element_size())


# a kernel's operator (its schema name) -> (HBM bytes, FLOPs) of a call
# from its arguments
KERNEL_COSTS = {"repro_torch::sparse_matmul": _sparse_matmul_op_cost}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class OpCost(TorchDispatchMode):
    """The cost of the ops run under it (module note)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.ops: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
        self.kernels: Dict[str, list] = {}
        self._seen = WeakIdKeyDictionary()

    def _charge(self, name: str, nbytes: float, flops: float) -> None:
        """Count one call of kernel ``name`` at its own ``nbytes`` HBM
        bytes and ``flops`` (in the totals, the op profile and
        ``kernels``)."""
        self.flops += flops
        self.bytes += nbytes
        for table in (self.ops, self.kernels):
            rec = table.setdefault(name, [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += nbytes
            rec[2] += flops

    # -- storage tracking ---------------------------------------------------
    @staticmethod
    def _size(st) -> int:
        return -(-st.nbytes() // BLOCK) * BLOCK

    def _drop(self, n: int) -> None:
        self.live -= n

    def hold(self, tree) -> int:
        """Track the storages of ``tree``'s tensors (the step's arguments)
        as live; returns their bytes (rounded as ``peak`` is)."""
        added = 0
        for t in _tensors(tree):
            added += self._track(t)
        return added

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = self._size(st)
        self._seen[st] = n
        weakref.finalize(st, self._drop, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    # -- counting -------------------------------------------------------------
    def _op_bytes(self, func, name: str, args, kwargs, out) -> float:
        if name in _FREE or getattr(func, "is_view", False):
            return 0.0
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func.namespace in ("c10d", "_c10d_functional"):
            return 2.0 * sum(_nbytes(t) for t in ins)
        if name in _SLICE_WRITES:
            # the written rows: the source (or values) operand, read and
            # written; the index read
            src = [t for t in ins[1:]]
            return 2.0 * max((_nbytes(t) for t in src), default=0) + sum(
                _nbytes(t) for t in src if t.dtype in (torch.int32,
                                                       torch.int64))
        if name in _GATHERS:
            idx = sum(_nbytes(t) for t in ins
                      if t.dtype in (torch.int32, torch.int64, torch.bool))
            return 2.0 * sum(_nbytes(t) for t in outs) + idx
        if name == "copy_":
            return 2.0 * _nbytes(ins[1] if len(ins) > 1 else ins[0])
        if name in ("zeros", "ones", "full", "fill_", "zero_", "zeros_like",
                    "ones_like", "full_like", "arange", "scalar_tensor"):
            return float(sum(_nbytes(t) for t in outs))
        if name.endswith("_") and outs:
            # in place: self read and written once, the other operands read
            return float(sum(_nbytes(t) for t in ins) + _nbytes(ins[0]))
        return float(sum(_nbytes(t) for t in ins)
                     + sum(_nbytes(t) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        cost = KERNEL_COSTS.get(func.name())
        if cost is not None:
            out = func(*args, **kwargs)
            self._charge(packet.__name__, *cost(*args, **kwargs))
            for t in _tensors(out):
                self._track(t)
            return out
        if func is not torch.ops.prim.device.default:
            # a composite op (matmul, einsum under inference_mode) is
            # counted as the ops it decomposes into, as FlopCounterMode
            # counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = packet.__name__
        f = 0.0
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
        b = self._op_bytes(func, name, args, kwargs, out)
        self.flops += f
        self.bytes += b
        rec = self.ops[name]
        rec[0] += 1
        rec[1] += b
        rec[2] += f
        for t in _tensors(out):
            self._track(t)
        return out

    def profile(self, n: int = 20) -> List[str]:
        """The n ops that moved the most bytes: calls, MB, GFLOP."""
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:n]
        return [f"{b / 1e6:10.1f} MB {f / 1e9:9.2f} GF {c:7d}x  {name}"
                for name, (c, b, f) in top]
