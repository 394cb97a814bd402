"""Production dry run: one rank of the production world runs each
(arch × shape × mesh) cell's real step on "meta" tensors, and the cell's
roofline terms come from what that rank computes, moves and holds (the
reference's ``launch/dryrun.py``, which compiles each cell with XLA and
reads the compiled HLO).

Usage (the CPU; nothing is allocated on any device):
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all          # every cell, a process each
  python -m repro_torch.launch.dryrun --all --multi-pod

How a cell runs (``run_cell``):

1. a torch.distributed world of 256 ranks ((16, 16)) or 512 ((2, 16,
   16)) under torch's "fake" backend (``FakeStore``): this process is
   rank 0, and its collectives return at once, moving nothing;
2. ``launch.mesh.make_production_mesh`` over it (``--mesh D,M`` takes
   another (data, model) grid, e.g. 1,1 for one card, and ``--mesh
   P,D,M`` a (pod, data, model) one, named ``PxDxM``);
3. ``launch.specs.build_cell``: rank 0's step and its arguments on
   "meta", the deployed dtypes and layouts;
4. the step runs once under ``launch.op_cost.OpCost`` (FLOPs, HBM bytes,
   peak live storage, the op profile), its collectives counted by
   ``sharding.comm.STATS`` (counts and payload bytes by axis, wire bytes
   by kind with the ring multipliers).

A train cell's microbatch of fewer rows than the data rows over pod ×
data (DeepSeek-67B's and zamba2-7b's train_4k on (2, 16, 16): 16 rows a
microbatch against 32) is counted in the layout the step takes there and
the reference's compiled step takes too (``train/fsdp.py`` module note,
step 2): its rows split over "data" within each pod, every pod computing
the same rows, their reductions summed within the pod.

No kernel runs: on meta tensors every kernel wrapper takes its plain
version, as the reference's HLO counts XLA's ops and not its kernels;
but kernel 5, the static tile capacities' gather, is counted by its own
bytes and FLOPs (``op_cost``), so a sparse cell counts the weight tiles
it reads. The record's ``kernels`` holds each such kernel's calls, bytes
and FLOPs.

Hardware model, per H100 SXM (each with its source): 989.4e12 bf16 dense
FLOP/s (NVIDIA H100 datasheet, SXM), 3.35e12 B/s HBM3 (datasheet, SXM),
50e9 B/s wire per GPU (one 400 Gb/s NDR InfiniBand port a GPU: both
16-wide axes cross 8-GPU nodes), 80 GB of HBM. Terms per chip per step:
t_compute = FLOPs / peak, t_memory = bytes / HBM rate, t_collective =
wire bytes / wire rate. The reference's f32 compile and its ×0.5 bytes
scale are not copied: the step runs in its deployed dtypes
(``dtype_scale`` 1.0).

Outputs one JSON record per cell (stdout for one cell; appended to
``--out``, by default build/dryrun_results.jsonl, with --all, one process
a cell, a failed cell recorded with its error).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

PEAK_FLOPS = 989.4e12  # H100 SXM, bf16 dense, datasheet
HBM_BW = 3.35e12  # H100 SXM HBM3, datasheet
WIRE_BW = 50e9  # 400 Gb/s NDR InfiniBand, one port a GPU
HBM_BYTES = 80e9  # H100 80GB

DEFAULT_OUT = os.path.join("build", "dryrun_results.jsonl")
CELL_TIMEOUT_S = 3600.0


def fake_world(n: int) -> None:
    """Make this process rank 0 of an n-rank world under torch's "fake"
    backend (collectives move nothing), in place of any world it had."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def cell_config(arch: str, sparse: float = 0.0, sp: bool = False,
                ngroups: int = 1, layers: int = 0, relufy_stage: int = 0):
    """The cell's ``ModelConfig``: relufied to ``relufy_stage``
    (``core.relufication``); for a sparse variant relufied (stage 2) with
    static tile capacities ``sparse`` (FFN) and min(1, 3·sparse) (inputs);
    Megatron-SP residuals with ``sp``; cut to ``layers`` when given."""
    from repro_torch.configs import get_config
    from repro_torch.core import relufication
    cfg = get_config(arch)
    if relufy_stage == 1:
        cfg = relufication.relufy_stage1(cfg)
    elif relufy_stage == 2:
        cfg = relufication.relufy_stage2(cfg)
    if sparse > 0:
        cfg = cfg.replace(activation="relu", post_norm_relu=True)
        cfg = cfg.replace_sparsity(enabled=True, ffn_tile_density=sparse,
                                   input_tile_density=min(1.0, sparse * 3.0),
                                   n_groups=ngroups)
    if sp:
        cfg = cfg.replace(sp_residuals=True)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    return cfg


def _counts(stats, cost, arg_bytes: int) -> dict:
    """The counted quantities of one run, flat: {name: number}."""
    out = {"flops": cost.flops, "bytes": cost.bytes, "arg": arg_bytes,
           "peak": cost.peak}
    for k, v in stats.wire.items():
        out["wire/" + k] = v
    for k, v in stats.kinds.items():
        out["count/" + k] = v
    for axis, d in stats.by_axis().items():
        for k, v in d.items():
            out[f"axis/{axis}/{k}"] = v
    for name, (calls, nbytes, flops) in cost.kernels.items():
        for k, v in (("launches", calls), ("bytes", nbytes),
                     ("flops", flops)):
            out[f"kernel/{name}/{k}"] = v
    return out


def _measure(cfg, shape, mesh_fn, n_chips: int, remat: str, profile: int,
             run: bool = True):
    """One run of the cell's step on rank 0 of a fresh fake world:
    (counts, profile lines); without ``run`` only the arguments are built
    and counted (``counts["arg"]``)."""
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.sharding import comm

    fake_world(n_chips)
    try:
        mesh = mesh_fn()
        tc = TrainConfig(num_microbatches=shape.num_microbatches,
                         remat_policy=remat)
        step, args = specs_lib.build_cell(cfg, shape, mesh, tc=tc)
        cost = OpCost()
        arg_bytes = cost.hold(args)
        comm.STATS.reset()
        if run:
            with cost:
                out = step(*args)
            del out
        del args
        counts = _counts(comm.STATS, cost, arg_bytes)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return counts, cost.profile(profile) if profile else []


def _fit(runs: dict, L: int, m: int, every: int = 0) -> dict:
    """The counts at L layers and m microbatches from runs at L in {1, 2}
    and, for a train cell of 3 or more microbatches, m in {2, 3} (from two
    on the step also divides its gradients by m): every count but the
    peak is A0 + A1·L + m·(B0 + B1·L), exact for a step whose layers and
    microbatches run the same ops on the same shapes (the trip-count
    scaling of the reference's HLO cost model); the peak, reached inside
    one microbatch, and the temporaries above the arguments, linear in L
    from the runs at the largest m. ``every`` (Zamba-2's ``attn_every``):
    a block applied after each full ``every`` layers adds its own counts
    (S0 + m·S1) L // every times, read off runs at L = ``every`` too."""
    ms = sorted({k[1] for k in runs})
    out = {}
    for key in sorted({key for run in runs.values() for key in run}):
        def q(l, mm):
            return runs[(l, mm)].get(key, 0)

        def extra(mm):  # one application of the every-th block
            if not every:
                return 0
            return q(every, mm) - (q(1, mm) + (every - 1) * (q(2, mm)
                                                             - q(1, mm)))
        if key in ("peak", "temp") or len(ms) == 1:
            mm = ms[-1]
            out[key] = (q(1, mm) + (L - 1) * (q(2, mm) - q(1, mm))
                        + (L // every if every else 0) * extra(mm))
            continue
        m0, m1 = ms
        per_m = [(q(1, m1) - q(1, m0)) / (m1 - m0),
                 (q(2, m1) - q(2, m0)) / (m1 - m0)]  # B0 + B1·l at l = 1, 2
        b1 = per_m[1] - per_m[0]
        b0 = per_m[0] - b1
        fixed = [q(1, m0) - m0 * per_m[0], q(2, m0) - m0 * per_m[1]]
        a1 = fixed[1] - fixed[0]
        a0 = fixed[0] - a1
        out[key] = a0 + a1 * L + m * (b0 + b1 * L)
        if every:
            s1 = (extra(m1) - extra(m0)) / (m1 - m0)
            out[key] += (L // every) * (extra(m0) + (m - m0) * s1)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             sparse: float = 0.0, microbatches: int = 0, profile: int = 0,
             sp: bool = False, ngroups: int = 1, remat: str = "minimal",
             mesh_shape=None, batch: int = 0, layers: int = 0,
             cfg=None, extrapolate: bool = True, seq: int = 0,
             relufy_stage: int = 0) -> dict:
    """One cell's record (module note). ``mesh_shape`` (data, model), or
    (pod, data, model), takes another grid than the production one;
    ``batch`` and ``layers`` cut the
    global batch and the depth, ``seq`` sets the sequence length;
    ``relufy_stage`` relufies the arch (``cell_config``), and ``cfg``
    replaces the arch's config (the launchers' relufied one).

    With ``extrapolate`` a cell deeper than 2 layers (or a train cell of
    more than 2 microbatches) runs at 1 and 2 layers (and 2 and 3
    microbatches) and its counts are fitted to the whole cell (``_fit``):
    a step of L layers and m microbatches dispatches L·m copies of the
    same layer ops, which on meta tensors cost host time and nothing else.
    ``extrapolate=False`` runs the whole cell. The fake world is taken
    down after each run."""
    from repro_torch.configs import SHAPES
    from repro_torch.core import flops as flops_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train.fsdp import microbatch_rows

    if cfg is None:
        cfg = cell_config(arch, sparse, sp, ngroups, layers, relufy_stage)
    shape = SHAPES[shape_name]
    if seq:
        shape = dataclasses.replace(shape, seq_len=seq)
    if microbatches:
        shape = dataclasses.replace(shape, num_microbatches=microbatches)
    if batch:
        shape = dataclasses.replace(shape, global_batch=batch)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)

        def mesh_fn():
            return mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                 device="meta")
    elif len(mesh_shape) == 3:
        def mesh_fn():
            return mesh_lib.make_pod_mesh(*mesh_shape, device="meta")
    else:
        def mesh_fn():
            return mesh_lib.make_host_mesh(*mesh_shape, strict=True,
                                           device="meta")
    n_chips = math.prod(mesh_shape)
    mesh_name = "x".join(str(n) for n in mesh_shape)
    L, m = cfg.n_layers, shape.num_microbatches
    train = shape.kind == "train"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "sparse": sparse, "microbatches": m, "sp_residuals": sp,
           "n_groups": ngroups, "remat": remat,
           "global_batch": shape.global_batch, "seq_len": shape.seq_len,
           "n_layers": L,
           "dtype_scale": 1.0}
    if train:
        # the step's own rule, in the cell's numbers (a fitted run's
        # batch is cut to its microbatches)
        microbatch_rows(shape.global_batch, m, dict(zip(
            ("pod", "data", "model")[-len(mesh_shape):], mesh_shape)))
    t0 = time.time()
    every = cfg.attn_every if cfg.family == "hybrid" else 0
    # a shared block every 1 or 2 layers is in the runs at 1 and 2 layers
    fit = (extrapolate and not 0 < every <= 2
           and (L > max(2, every) or (train and m > 2)))
    if not fit:
        counts, prof = _measure(cfg, shape, mesh_fn, n_chips, remat, profile)
    else:
        runs, ms = {}, (2, 3) if train and m > 2 else (m,)
        layers_run = (1, 2) + ((every,) if every else ())
        for mm in ms:
            for ll in layers_run:
                sh = dataclasses.replace(
                    shape, num_microbatches=mm,
                    global_batch=shape.global_batch // m * mm)
                runs[(ll, mm)], prof = _measure(
                    cfg.replace(n_layers=ll), sh, mesh_fn, n_chips, remat,
                    profile)
                runs[(ll, mm)]["temp"] = (runs[(ll, mm)]["peak"]
                                          - runs[(ll, mm)]["arg"])
        counts = _fit(runs, L, m, every)
        # the arguments at full size are built and counted, not fitted
        # (each leaf's bytes round up to the allocator's blocks)
        counts["arg"] = _measure(cfg, shape, mesh_fn, n_chips, remat, 0,
                                 run=False)[0]["arg"]
        counts["peak"] = counts["arg"] + counts.pop("temp")
        rec["extrapolated_from"] = {"layers": list(layers_run),
                                    "microbatches": list(ms)}
    wire = sum(v for k, v in counts.items() if k.startswith("wire/"))
    flops, nbytes, peak = counts["flops"], counts["bytes"], counts["peak"]
    rec.update(
        flops_per_chip=flops,
        bytes_per_chip=nbytes,
        wire_bytes_per_chip=wire,
        collectives={k[5:]: v for k, v in counts.items()
                     if k.startswith("wire/") and v},
        collective_counts={k[6:]: int(v) for k, v in counts.items()
                           if k.startswith("count/") and v},
        collectives_by_axis={
            axis: {k: int(counts.get(f"axis/{axis}/{k}", 0))
                   for k in ("count", "payload_bytes")}
            for axis in ("model", "data", "pod", "world")},
        kernels={name: {k: counts.get(f"kernel/{name}/{k}", 0)
                        for k in ("launches", "bytes", "flops")}
                 for name in sorted({k.split("/")[1] for k in counts
                                     if k.startswith("kernel/")})},
        peak_bytes_per_chip=int(peak),
        arg_bytes=int(counts["arg"]),
        temp_bytes=int(peak - counts["arg"]),
        fits=peak <= HBM_BYTES,
        t_compute=flops / PEAK_FLOPS,
        t_memory=nbytes / HBM_BW,
        t_collective=wire / WIRE_BW,
        n_chips=n_chips,
    )
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    rec["roofline_fraction"] = round(
        max(terms.values()) / max(sum(terms.values()), 1e-30), 4)
    try:
        mf = flops_lib.model_flops(cfg, shape)
        rec["model_flops_per_chip"] = mf / n_chips
        rec["useful_flops_ratio"] = round((mf / n_chips) / max(flops, 1.0),
                                          4)
    except Exception as e:  # noqa: BLE001 — the accounting is best-effort
        rec["model_flops_error"] = str(e)
    if profile:
        rec["profile"] = prof
    rec["host_s"] = round(time.time() - t0, 2)
    return rec


def cell_command(cell: dict, extra=()) -> list:
    """The command line of one cell of ``cells.cell_plan`` (or of a dict
    with the same keys)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", cell["arch"], "--shape", cell["shape"]]
    if cell.get("multi_pod"):
        cmd.append("--multi-pod")
    if cell.get("sparse"):
        cmd += ["--sparse", str(cell["sparse"])]
    if cell.get("microbatches"):
        cmd += ["--microbatches", str(cell["microbatches"])]
    if cell.get("sp"):
        cmd.append("--sp")
    if cell.get("remat"):
        cmd += ["--remat", cell["remat"]]
    return cmd + list(extra)


def run_subprocess(cell: dict, extra=(), timeout: float = CELL_TIMEOUT_S
                   ) -> dict:
    """One cell in a process of its own: its record, or the cell with its
    error (the end of its stderr) and its seconds."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    t0 = time.time()
    try:
        r = subprocess.run(cell_command(cell, extra), capture_output=True,
                           text=True, env=env, timeout=timeout)
        ok, text = r.returncode == 0, r.stdout if r.returncode == 0 else (
            r.stderr or r.stdout)
    except subprocess.TimeoutExpired:
        ok, text = False, f"timed out after {timeout} s"
    dt = round(time.time() - t0, 1)
    if ok:
        rec = json.loads(text[text.index("{"):])
        rec["wall_s"] = dt
        return rec
    return {**cell, "error": text[-2000:], "wall_s": dt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sparse", type=float, default=0.0,
                    help="ffn tile density for the relufied sparse variant")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--sp", action="store_true",
                    help="Megatron-SP-style sharded residuals")
    ap.add_argument("--ngroups", type=int, default=1,
                    help="shard-local grouped sparse selection")
    ap.add_argument("--remat", default="minimal",
                    choices=["none", "minimal", "full", "save_ars"])
    ap.add_argument("--mesh", default=None, metavar="[POD,]DATA,MODEL",
                    help="another (data, model) or (pod, data, model) grid "
                         "than the production mesh, e.g. 1,1 for one card")
    ap.add_argument("--batch", type=int, default=0,
                    help="cut the global batch to this")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    ap.add_argument("--seq", type=int, default=0,
                    help="set the sequence length (the cache's, in decode)")
    ap.add_argument("--relufy-stage", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--profile", type=int, default=0)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        mesh_shape = (tuple(int(x) for x in args.mesh.split(","))
                      if args.mesh else None)
        rec = run_cell(args.arch, args.shape, args.multi_pod, args.sparse,
                       args.microbatches, args.profile, args.sp,
                       args.ngroups, args.remat, mesh_shape, args.batch,
                       args.layers, seq=args.seq, relufy_stage=args.relufy_stage)
        print(json.dumps(rec, indent=2))
        return 0

    from repro_torch.launch.cells import cell_plan
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    t_all = time.time()
    for cell in cell_plan(multi_pod=args.multi_pod):
        rec = run_subprocess(cell)
        tag = "OK " if "error" not in rec else "ERR"
        print(f"[{tag}] {cell['arch']}/{cell['shape']}"
              f"/{'2x16x16' if cell.get('multi_pod') else '16x16'}"
              f" sparse={cell.get('sparse', 0)} {rec['wall_s']:.1f}s",
              flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    print(f"--all: {time.time() - t_all:.1f} s of host time", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
