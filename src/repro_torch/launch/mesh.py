"""Serving meshes of the port (the reference's ``launch/mesh.py``): a
``("data", "model")`` grid over the ranks of an initialised
``torch.distributed`` world, one rank a process.

Rank r sits at data index r // model and model index r % model; the ranks
of one data index form that row's model-axis process group, over which the
tensor-parallel collectives of ``sharding/comm.py`` run; the ranks of one
model index form that column's data-axis group (ranks {d * model + m}),
over which the data-axis gathers run; and the world group spans the
mesh.

``make_production_mesh`` is the reference's production mesh over an
initialised world of 256 ranks, (16, 16) ("data", "model"), or 512,
(2, 16, 16) ("pod", "data", "model"): the dry run (``launch/dryrun.py``)
builds it on rank 0 of a ``"fake"`` world, whose collectives move
nothing. On a pod mesh rank r sits at pod r // (data·model), data index
(r // model) mod data and model index r mod model; its data group is the
ranks of its model index over pod × data in (pod, data) order
(``rules.dp_axes``: the batch splits over both, and the train rules
split the MoE experts' d_model over both, so the FSDP step gathers and
reduce-scatters those leaves there), its model group the model row of its
(pod, data), its shard group the data column of its model index within
its pod (the FSDP step gathers and reduce-scatters the leaves split over
"data" there) and its pod group its peers of the same (data, model)
index in the other pods. Every rank builds every group, in the same
order.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

AXES = ("data", "model")


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (data, model) mesh: the axis sizes
    (``shape``), its coordinates on them (``coords``), the process groups
    of its model-axis row (``group``), its data-axis column
    (``data_group``) and the whole mesh (``world_group``) — each None when
    it is the whole world, or a world of one — and the device its tensors
    live on."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    group: Any = None
    device: Optional[torch.device] = None
    axis_names: Tuple[str, ...] = AXES
    data_group: Any = None
    world_group: Any = None
    # a pod mesh's groups: the data column within the rank's pod (what
    # the train rules split "embed" over), and the rank's peers in the
    # other pods (same data and model index)
    shard_group: Any = None
    pod_group: Any = None

    @property
    def rank(self) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + self.coords[a]
        return r

    @property
    def size(self) -> int:
        """The ranks of the mesh."""
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    def model_row(self) -> "Mesh":
        """This rank's model-axis row as a (1, model) mesh: what the
        weights are split over (the data axis replicates them)."""
        return dataclasses.replace(
            self, shape={"data": 1, "model": self.shape["model"]},
            coords={"data": 0, "model": self.coords["model"]},
            data_group=None, world_group=self.group, axis_names=AXES)


def world() -> Tuple[int, int]:
    """(rank, world size) of the initialised torch.distributed world, or
    (0, 1) when none is."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_host_mesh(data: int = 1, model: int = 1, *, strict: bool = False,
                   device=None) -> Mesh:
    """A (data, model) mesh over the ranks of the initialised world (one
    rank when no world is initialised).

    When fewer ranks exist than ``data * model`` the shape is clamped, with
    a warning that says "degenerating"; ``strict=True`` (the launcher's
    ``--mesh``) raises instead: an unsatisfiable mesh is an operator error,
    not a fallback. Ranks past the clamped grid get no mesh (ValueError).
    ``device``: where this rank's tensors live (default: the model-axis
    group's device, ``comm.rank_device``)."""
    import torch.distributed as dist
    rank, n = world()
    data_eff = min(data, n)
    model_eff = min(model, max(1, n // data_eff))
    if (data_eff, model_eff) != (data, model):
        msg = (f"mesh shape ({data}, {model}) needs {data * model} ranks "
               f"but only {n} exist; degenerating to "
               f"({data_eff}, {model_eff})")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
    if rank >= data_eff * model_eff:
        raise ValueError(f"rank {rank} lies outside the ({data_eff}, "
                         f"{model_eff}) mesh")
    group = data_group = world_group = None
    # every rank builds every group, in the same order, as new_group requires
    if n > 1 and model_eff < n:
        for d in range(data_eff):
            g = dist.new_group(list(range(d * model_eff, (d + 1) * model_eff)))
            if d == rank // model_eff:
                group = g
    if n > 1 and data_eff < n:
        for m in range(model_eff):
            g = dist.new_group(list(range(m, data_eff * model_eff, model_eff)))
            if m == rank % model_eff:
                data_group = g
    if n > data_eff * model_eff:
        world_group = dist.new_group(list(range(data_eff * model_eff)))
    if device is None:
        from repro_torch.sharding import comm
        device = comm.rank_device(rank)
    return Mesh(shape={"data": data_eff, "model": model_eff},
                coords={"data": rank // model_eff, "model": rank % model_eff},
                group=group, device=torch.device(device),
                data_group=data_group, world_group=world_group)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh over the initialised world: (16,
    16) ("data", "model") on 256 ranks, or with ``multi_pod`` (2, 16, 16)
    ("pod", "data", "model") on 512 (module note for the rank order and
    the groups). Raises unless the world has exactly that many ranks.
    ``device``: where this rank's tensors live ("meta" in the dry run;
    default the rank's card)."""
    return make_pod_mesh(2 if multi_pod else 0, 16, 16, device=device)


def make_pod_mesh(pods: int, data: int, model: int, *, device=None) -> Mesh:
    """A (data, model) mesh, or with ``pods`` > 0 a (pods, data, model)
    ("pod", "data", "model") one, over an initialised world of exactly
    its size (``make_production_mesh``'s layout at any size)."""
    import torch.distributed as dist
    shape = ({"pod": pods, "data": data, "model": model} if pods
             else {"data": data, "model": model})
    names = tuple(shape)
    rank, n = world()
    size = 1
    for v in shape.values():
        size *= v
    if n != size:
        raise ValueError(f"the mesh {tuple(shape.values())} needs a world "
                         f"of {size} ranks, not {n}")
    M, rows = shape["model"], size // shape["model"]
    group = data_group = None
    for r in range(rows):  # model rows: M consecutive ranks
        g = dist.new_group(list(range(r * M, (r + 1) * M)))
        if r == rank // M:
            group = g
    for m in range(M):  # data columns over pod x data
        g = dist.new_group(list(range(m, size, M)))
        if m == rank % M:
            data_group = g
    coords, r = {}, rank
    for a in reversed(names):
        coords[a] = r % shape[a]
        r //= shape[a]
    shard_group = pod_group = None
    if pods:
        D = shape["data"]
        for p in range(pods):
            for m in range(M):
                g = dist.new_group([(p * D + d) * M + m for d in range(D)])
                if (p, m) == (coords["pod"], coords["model"]):
                    shard_group = g
        for d in range(D):
            for m in range(M):
                g = dist.new_group([(p * D + d) * M + m for p in range(pods)])
                if (d, m) == (coords["data"], coords["model"]):
                    pod_group = g
    if device is None:
        from repro_torch.sharding import comm
        device = comm.rank_device(rank)
    return Mesh(shape=shape, coords=coords, group=group,
                device=torch.device(device), axis_names=names,
                data_group=data_group, shard_group=shard_group,
                pod_group=pod_group)
