"""Rank groups for the port's sharded-serving tests: gloo ranks on the CPU,
spawned through ``repro_torch.sharding.comm.spawn`` (a file store in a
fresh directory, one timeout for the whole group, every rank killed when
it runs out).

``serve_cases(rank, world, cases, data=1)`` runs in each rank: every case
serves its prompts through the port's engine on a (data, world / data)
mesh and returns what the tests compare, as plain Python and numpy values.
A case is a dict of numpy values only (params as nested dicts of arrays),
so it pickles to the ranks without shared memory. ``drive`` is the
request schedule a case submits, the same for the port's engine and the
reference's."""
from __future__ import annotations

import numpy as np
import torch

GEOM = dict(n_slots=2, block_size=8, max_blocks_per_seq=6)
PROMPTS = ((1, 9), (2, 5), (3, 13))  # (seed, length)
REUSE = (4, 0, 4)
MAX_NEW = 8


def prompts(vocab: int):
    return [np.random.RandomState(s).randint(0, vocab, n).astype(np.int32)
            for s, n in PROMPTS]


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def drive(eng, vocab: int, case, sampling_cls):
    """Submit the case's requests to ``eng`` (either package's engine, the
    same API) and run them; returns (uids, results). The default: the three
    ``prompts`` with ``REUSE``, greedy, or with ``case["sampled"]`` the
    first and last sampled (``sampling_cls``, the engine's package's
    SamplingParams). ``case["preempt"]``: two priority-0 requests decode,
    then a priority-2 one arrives that the pool cannot hold beside them,
    so one is preempted and resumes later, into other blocks.
    ``case["prefix"]``: every prompt starts with the same 8 tokens (one
    full block: prefix-cache hits). ``case["cancel"]``: a fourth request
    queues behind the three; after three steps the second is cancelled
    mid-stream and the fourth in the queue."""
    ps = prompts(vocab)
    if case.get("prefix"):
        head = np.random.RandomState(8).randint(0, vocab, 8).astype(np.int32)
        ps = [np.concatenate([head, p]) for p in ps]
    if case.get("preempt"):
        uids = [eng.submit(p, 12, reuse_window=4, priority=0, slo_ms=1e6)
                for p in ps[:2]]
        while True:  # until both decode with a few tokens out
            eng.step()
            slots = [s for s in eng.scheduler.slots if s is not None]
            if len(slots) == 2 and all(not s.prefilling and len(s.out) >= 3
                                       for s in slots):
                break
        uids.append(eng.submit(ps[2], 4, priority=2, slo_ms=1e6))
        return uids, eng.run()
    sampling = [None] * len(ps)
    if case.get("sampled"):
        sampling[0] = sampling_cls(temperature=0.8, top_k=20, seed=3)
        sampling[-1] = sampling_cls(temperature=1.1, top_p=0.9, seed=5)
    uids = [eng.submit(p, MAX_NEW, reuse_window=r, sampling=s)
            for p, r, s in zip(ps, REUSE, sampling)]
    if case.get("cancel"):
        uids.append(eng.submit(ps[0][::-1].copy(), MAX_NEW, reuse_window=2))
        for _ in range(3):
            eng.step()
        assert eng.cancel(uids[1])  # mid-stream
        assert eng.cancel(uids[3])  # still queued
    return uids, eng.run()


def outcome(eng, uids, res) -> dict:
    """The per-request values the data-axis tests compare, from either
    package's engine (a request withdrawn from the queue has an empty
    "cancelled" result), and each tracker's curve, aggregated sparsity
    and used mask."""
    rs = [res[u] for u in uids]
    return dict(
        tokens=[np.asarray(r.tokens).tolist() for r in rs],
        logprobs=[np.asarray(r.logprobs) for r in rs],
        finish=[r.finish_reason for r in rs],
        draft_accepted=[r.draft_accepted for r in rs],
        pred_misses=[r.pred_misses for r in rs],
        preemptions=[r.preemptions for r in rs],
        cached=[r.cached_prompt_tokens for r in rs],
        trackers={int(u): (list(t.curve), float(t.aggregated_sparsity()),
                           np.asarray(t.used))
                  for u, t in sorted(eng.trackers.items())},
        metrics=eng.metrics_snapshot())


def engine_kwargs(case) -> dict:
    """The case's EngineConfig fields, its numpy trees made torch."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.predictor import predictors as tpred
    kw = dict(GEOM, prefill_chunk=case.get("chunk", 0),
              fast_kernels=case.get("fast"))
    kw.update(case.get("geom", {}))
    if "draft" in case:
        dcfg_json, dparams = case["draft"]
        kw.update(draft_cfg=ModelConfig.from_json(dcfg_json),
                  draft_params=to_torch(dparams), gamma=4)
    if "predictor" in case:
        fields = dict(case["predictor"])
        params = to_torch(fields.pop("params"))
        if "w" in params:  # numpy holds no bf16: cast to the probe dtype
            params["w"] = params["w"].to(getattr(torch, fields["probe_dtype"]))
        kw["predictor"] = tpred.Predictor(params=params, **fields)
    return kw


def serve(cfg, params, kw, mesh=None, case=None) -> dict:
    """One case through the port's engine: streams, logprobs, metrics and
    the per-request counters the tests compare."""
    from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                     SamplingParams)
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(mesh=mesh, **kw),
                                   device="cpu")
    uids, res = drive(eng, cfg.vocab_size, case or {}, SamplingParams)
    return dict(
        outcome(eng, uids, res),
        pool_blocks=eng.pages["k"].shape[1],
        bytes_per_device=eng.weight_io_bytes_per_step(),
        bytes_total=eng.weight_io_bytes_per_step(per_device=False),
        tp=eng.tp, ffn_tp=eng.ffn_tp,
        # the engine keeps its own Predictor; the caller's still probes
        # all of d_ff
        predictor_unchanged=(
            kw.get("predictor") is None
            or (eng.predictor is not kw["predictor"]
                and _probe(kw["predictor"].params).shape[-1] == cfg.d_ff)))


def _probe(params):
    """A predictor's d_ff-wide probe leaf: "w" (sign) or "b" (low-rank)."""
    return params["w"] if "w" in params else params["b"]


def serve_cases(rank: int, world: int, cases, data: int = 1) -> dict:
    """Every case on this rank of a (data, world / data) mesh; {case id:
    result}."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import comm
    torch.set_num_threads(1)
    mesh = make_host_mesh(data, world // data, strict=True, device="cpu")
    out = {}
    for cid, case in cases.items():
        cfg = ModelConfig.from_json(case["cfg"])
        comm.STATS.reset()
        out[cid] = serve(cfg, to_torch(case["params"]), engine_kwargs(case),
                         mesh, case)
        out[cid]["all_reduces"] = comm.STATS.count
        out[cid]["data_collectives"] = comm.STATS.data_count
        out[cid]["world_collectives"] = comm.STATS.world_count
    if data > 1 and world > data:
        case = next(iter(cases.values()))
        out["model_disagree"] = model_ranks_disagree(
            ModelConfig.from_json(case["cfg"]), to_torch(case["params"]),
            mesh)
    try:  # ranks that offer different checksums must raise
        comm.check_same(100 + rank, mesh)
        out["disagree"] = "no error"
    except RuntimeError as e:
        out["disagree"] = str(e)
    return out


# -- rank functions for the group's own checks -------------------------------


def model_ranks_disagree(cfg, params, mesh) -> str:
    """Serve one request with the slots split over the data axis while the
    model ranks past the first add 1 to the tokens they sampled: the step
    must raise on every rank. Returns the error's text ("no error" when
    none was raised)."""
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    eng = ContinuousBatchingEngine(cfg, params,
                                   EngineConfig(mesh=mesh, **GEOM),
                                   device="cpu")
    assert eng.data.slots_split
    if mesh.coords["model"] > 0:
        rows_of = eng._step_rows

        def skewed(rows):
            (tokens, how), *rest = rows
            return rows_of([(tokens + 1, how)] + rest)
        eng._step_rows = skewed
    eng.submit(prompts(cfg.vocab_size)[0], 4)
    try:
        eng.run()
    except RuntimeError as e:
        return str(e)
    return "no error"


def one_rank_fails(rank: int, world: int) -> None:
    """Rank 1 raises; the others wait in a collective it never joins."""
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.all_reduce(torch.ones(1))


def one_rank_hangs(rank: int, world: int) -> None:
    """Rank 1 never reaches the collective the others wait in."""
    import time
    import torch.distributed as dist
    if rank == 1:
        time.sleep(3600)
    dist.all_reduce(torch.ones(1))


# -- the data-parallel train step --------------------------------------------


def ddp_steps(rank: int, world: int, ref: dict, compression: str,
              steps: int) -> dict:
    """The port's DDP step on this rank of a (world, 1) mesh from the
    reference run's initial params (numpy, the reference's tree) over its
    global batches: each step's metrics, and the params after the last."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.optim import compression as tcomp
    from repro_torch.train.ddp import make_ddp_train_step
    from repro_torch.tree import flatten
    torch.set_num_threads(1)
    cfg = get_config("tiny-relu").replace(compute_dtype="float32")
    mesh = make_host_mesh(world, 1, strict=True, device="cpu")
    tc = TrainConfig(learning_rate=5e-3, total_steps=6, warmup_steps=1,
                     schedule="constant", grad_compression=compression)
    params = params_from_jax(ref["params"], cfg, device="cpu",
                             dtype=torch.float32)
    opt, ef = adamw.init_opt_state(params), tcomp.init_ef_state(params)
    step = make_ddp_train_step(cfg, tc, mesh)
    rows = []
    for batch in ref["batches"][:steps]:
        params, opt, ef, m = step(params, opt, ef,
                                  {k: torch.as_tensor(v)
                                   for k, v in batch.items()})
        rows.append({k: float(v) for k, v in m.items()})
    return dict(metrics=rows,
                params=[p.detach().numpy().copy() for p in flatten(params)])


# -- the FSDP + TP train step, sharded checkpoints, seq-sharded decode -------


def _full(tree, shardings) -> list:
    """Every leaf of a tree of rank blocks put together in full on rank 0
    (one gather a split leaf), as numpy, in flatten order (on the other
    ranks the split leaves are None)."""
    from repro_torch.sharding import comm
    from repro_torch.tree import flatten
    out = []
    for leaf, s in zip(flatten(tree), flatten(shardings)):
        if any(a is not None for a in s.spec):
            blocks = comm.gather_to_first(leaf, s.mesh)
            leaf = None if blocks is None else s.full(blocks)
        out.append(None if leaf is None else leaf.detach().numpy().copy())
    return out


def fsdp_case_state(case, mesh, state=None):
    """(cfg, TrainConfig, the rank's params and OptState blocks) of a case:
    the whole f32 params from ``case["params"]`` (the reference's numpy
    tree, ``convert.params_from_jax``) or made from seed 0, a fresh
    optimizer state, cut to the train specs; or, with ``case["resume"]``
    = (directory, step), that step's checkpoint restored onto the mesh; or
    ``state`` = (params, (step, m, v)) of the reference, as numpy."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.models import common as cm
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.train import fsdp
    cfg = ModelConfig.from_json(case["cfg"])
    tc = TrainConfig(**case["tc"])
    if "resume" in case:
        directory, step = case["resume"]
        shardings = fsdp.state_shardings(cfg, mesh)
        (pb, ob), _ = CheckpointManager(directory).restore(
            shardings, step, shardings=shardings)
        return cfg, tc, pb, ob

    def whole(tree):
        return params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)

    if state is not None:
        p, (t, m, v) = state
        pb, _ = fsdp.shard_train_state(whole(p), mesh, cfg)
        ob = adamw.OptState(step=torch.as_tensor(np.array(t)),
                            m=cm.shard_params(cfg, whole(m), mesh, "train"),
                            v=cm.shard_params(cfg, whole(v), mesh, "train"))
        return cfg, tc, pb, ob
    params = (whole(case["params"]) if "params" in case else
              registry.get_family(cfg).init_params(
                  cfg, seed=0, device="cpu", dtype=torch.float32))
    pb, ob = fsdp.shard_train_state(params, mesh, cfg)
    return cfg, tc, pb, ob


def fsdp_steps(rank: int, world: int, data: int, case) -> dict:
    """The port's FSDP step on this rank of a (data, world / data) mesh
    over ``case["batches"]``: each step's metrics, the rank's block shapes
    (params, m, v) before the first step, the whole params after each step
    (rank 0; None elsewhere), and with ``case["save_after"]`` = (directory,
    step) the state saved sharded after that step. With ``case["states"]``
    (the reference's state before each step, numpy) each step also runs
    from that state: its metrics are ``forced``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import fsdp
    from repro_torch.tree import flatten
    torch.set_num_threads(1)
    mesh = make_host_mesh(data, world // data, strict=True, device="cpu")
    cfg, tc, params, opt = fsdp_case_state(case, mesh)
    shardings = fsdp.state_shardings(cfg, mesh)
    out = dict(shapes=[[tuple(x.shape) for x in flatten(t)]
                       for t in (params, opt.m, opt.v)],
               metrics=[], params=[])
    step = fsdp.make_fsdp_train_step(cfg, tc, mesh)
    for i, batch in enumerate(case["batches"]):
        params, opt, m = step(params, opt, {k: torch.as_tensor(v)
                                            for k, v in batch.items()})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        full = _full(params, shardings[0])
        out["params"].append(full if rank == 0 else None)
        if case.get("save_after", (None, -1))[1] == i + 1:
            CheckpointManager(case["save_after"][0]).save(
                i + 1, (params, opt), shardings=shardings)
    out["forced"], out["forced_params"] = [], []
    for state, batch in zip(case.get("states", ()), case["batches"]):
        _, _, p, o = fsdp_case_state(case, mesh, state)
        p, _, m = step(p, o, {k: torch.as_tensor(v) for k, v in batch.items()})
        out["forced"].append({k: float(v) for k, v in m.items()})
        full = _full(p, shardings[0])
        out["forced_params"].append(full if rank == 0 else None)
    return out


def fsdp_grads(rank: int, world: int, data: int, cases) -> list:
    """For each case, the FSDP step's loss and mean gradient on
    ``case["batches"][0]``, the gradient put together in full (rank 0;
    None elsewhere)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import fsdp
    torch.set_num_threads(1)
    mesh = make_host_mesh(data, world // data, strict=True, device="cpu")
    out = []
    for case in cases:
        cfg, tc, params, _ = fsdp_case_state(case, mesh)
        loss, grads = fsdp.make_fsdp_grads(cfg, tc, mesh)(
            params, {k: torch.as_tensor(v)
                     for k, v in case["batches"][0].items()})
        full = _full(grads, fsdp.state_shardings(cfg, mesh)[0])
        out.append(dict(loss=float(loss), grads=full if rank == 0 else None))
    return out


def fsdp_schedule(rank: int, world: int, data: int, cases) -> list:
    """For each case, the FSDP step's per-layer gather on this rank:
    ``make_fsdp_grads``' loss and mean gradient on ``case["batches"][0]``
    (in full on rank 0; None elsewhere), then one train step on that
    batch with what it issued read from ``comm.STATS`` (the data axis'
    count and payload bytes) and ``fsdp.GAUGE`` (each layer gather's
    payload, the layer reductions, the peak and what is left alive), and
    ``fsdp.layer_column_bytes``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import comm
    from repro_torch.train import fsdp
    torch.set_num_threads(1)
    mesh = make_host_mesh(data, world // data, strict=True, device="cpu")
    out = []
    for case in cases:
        cfg, tc, params, opt = fsdp_case_state(case, mesh)
        batch = {k: torch.as_tensor(v) for k, v in case["batches"][0].items()}
        loss, grads = fsdp.make_fsdp_grads(cfg, tc, mesh)(params, batch)
        full = _full(grads, fsdp.state_shardings(cfg, mesh)[0])
        step = fsdp.make_fsdp_train_step(cfg, tc, mesh)
        comm.STATS.reset()
        _, _, metrics = step(params, opt, batch)
        g = fsdp.GAUGE
        out.append(dict(loss=float(loss), grads=full if rank == 0 else None,
                        step_loss=float(metrics["loss"]),
                        data_count=comm.STATS.data_count,
                        data_bytes=comm.STATS.data_bytes,
                        gathers=list(g.gathers), reductions=g.reductions,
                        peak=g.peak, live=g.live,
                        column_bytes=fsdp.layer_column_bytes(cfg, mesh)))
    return out


def collective_grads(rank: int, world: int, ops, seed: int) -> dict:
    """{op: ``collective_grad``} for each of ``ops``, on meshes (1, world)
    and (world, 1) of this rank."""
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    meshes = {axis: make_host_mesh(world if axis == "data" else 1,
                                   1 if axis == "data" else world,
                                   strict=True, device="cpu")
              for axis in ("model", "data")}
    return {op: collective_grad(
        rank, world, op, seed,
        meshes["data" if op.startswith("data") else "model"]) for op in ops}


def collective_grad(rank: int, world: int, op: str, seed: int,
                    mesh) -> dict:
    """One autograd collective of ``comm`` on this rank of ``mesh``, from
    inputs every rank draws alike from ``seed``: the forward's value and
    the gradient of sum(y * c) with respect to this rank's input (every
    rank the same objective; for "copy" each rank adds its own
    product's)."""
    from repro_torch.sharding import comm
    rng = np.random.RandomState(seed)
    xs = torch.as_tensor(rng.randn(world, 3, 4).astype(np.float32))
    c = torch.as_tensor(rng.randn(3, 5 * world).astype(np.float32))
    ws = torch.as_tensor(rng.randn(world, 4, 5).astype(np.float32))
    if op == "data_all_gather":
        return dict(y=comm.data_all_gather(xs[rank].reshape(-1), mesh).numpy())
    if op == "data_reduce_scatter":
        return dict(y=comm.data_reduce_scatter(xs[rank].reshape(-1),
                                               mesh).numpy())
    x = xs[0 if op == "copy" else rank].clone().requires_grad_(True)
    with comm.serving(mesh, mode="train"):
        if op == "reduce":
            y = comm.all_reduce_sum(x)
            loss = (y * c[:, :4]).sum()
        elif op == "copy":
            y = comm.copy_to_model(x) @ ws[rank]
            loss = (y * c[:, 5 * rank:5 * rank + 5]).sum()
        elif op == "gather_last":
            y = comm.gather_last(x, 4 * world, 4 * rank)
            loss = (y * c[:, :4 * world]).sum()
        else:  # data_reduce
            y = comm.all_reduce_sum(x, mesh, axis="data")
            loss = (y * c[:, :4]).sum()
        loss.backward()
    return dict(y=y.detach().numpy(), grad=x.grad.numpy())


def elastic_save(rank: int, world: int, saves, w) -> None:
    """The reference's elastic case, saving side: rank r of a (world, 1)
    mesh holds rows r of ``w`` split over "data" and saves step 5 into
    each (directory, async_save) of ``saves`` (with ``async_save``,
    written in the background; the rank then changes its block in place
    before ``wait()``, which the step must not see)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules
    mesh = make_host_mesh(world, 1, strict=True, device="cpu")
    sh = {"w": rules.Sharding(mesh, ("data", None))}
    for directory, async_save in saves:
        block = sh["w"].block(torch.as_tensor(w)).clone()
        mgr = CheckpointManager(directory, async_save=async_save)
        mgr.save(5, {"w": block}, extras={"step": 5}, shardings=sh)
        block.fill_(-1.0)
        mgr.wait()


def elastic_restore(rank: int, world: int, restores) -> list:
    """The restoring side, for each (directory, spec) of ``restores``:
    this rank's block of "w" under ``spec`` on a (world, 1) mesh, and the
    extras."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules
    mesh = make_host_mesh(world, 1, strict=True, device="cpu")
    out = []
    for directory, spec in restores:
        got, extras = CheckpointManager(directory).restore(
            {"w": 0}, shardings={"w": rules.Sharding(mesh, tuple(spec))})
        out.append(dict(w=got["w"].numpy(), extras=extras,
                        device=str(got["w"].device)))
    return out


def restore_state(rank: int, world: int, data: int, case) -> list:
    """The rank's blocks (params, then OptState) of a train state restored
    from ``case["resume"]`` onto a (data, world / data) mesh, as numpy in
    flatten order."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import flatten
    mesh = make_host_mesh(data, world // data, strict=True, device="cpu")
    _, _, params, opt = fsdp_case_state(case, mesh)
    return [x.numpy().copy() for x in flatten((params, opt))]


def seq_decode(rank: int, world: int, data: int, cases) -> list:
    """For each (q, k, v, pos, window) of ``cases``, ``decode_attention``
    over a sequence-sharded cache on this rank of a (data, world / data)
    mesh: its rows of the batch (b over "data") and its slice of S (over
    "model"), the whole inputs given. Returns its rows of each output."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common as cm
    from repro_torch.sharding import comm, rules
    torch.set_num_threads(1)
    mesh = make_host_mesh(data, world // data, strict=True, device="cpu")
    out = []
    for q, k, v, pos, window in cases:
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        spec = rules.cache_pspec((1,) + tuple(k.shape), mesh)[1:]
        assert spec == ("data", None, "model", None), spec
        rows = rules.local_block(torch.as_tensor(q), spec[:1], mesh)
        with comm.serving(mesh):
            out.append(cm.decode_attention(
                rows, rules.local_block(k, spec, mesh),
                rules.local_block(v, spec, mesh),
                rules.local_block(torch.as_tensor(pos), spec[:1], mesh),
                window).numpy())
    return out


# -- the production cell plan (tests/test_torch_plan.py) ----------------------


def plan_cells(rank: int, world: int, cells) -> list:
    """Each cell (cfg json, shape name, batch, seq, microbatches) run for
    real on this rank of a (2, world / 2) mesh: ``launch.specs``'s step on
    zero-filled CPU arguments. Returns per cell the step's FLOPs
    (FlopCounterMode), the collectives by axis (``comm.STATS``) and the
    rank's state bytes (its arguments, counted as the dry run counts
    them)."""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import SHAPES, TrainConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.sharding import comm
    torch.set_num_threads(1)
    mesh = make_host_mesh(2, world // 2, strict=True, device="cpu")
    out = []
    for cfg_json, shape_name, batch, seq, mb in cells:
        cfg = ModelConfig.from_json(cfg_json)
        shape = dataclasses.replace(SHAPES[shape_name], global_batch=batch,
                                    seq_len=seq, num_microbatches=mb)
        step, args = specs.build_cell(cfg, shape, mesh, TrainConfig(
            num_microbatches=mb, remat_policy="minimal"), device="cpu")
        state = OpCost().hold(args)
        comm.STATS.reset()
        with FlopCounterMode(display=False) as fc:
            step(*args)
        out.append(dict(flops=fc.get_total_flops(), state=state,
                        axes=comm.STATS.by_axis()))
    return out


def legacy_generate(rank: int, world: int, case) -> tuple:
    """The legacy ``ServeEngine.generate`` of ``case`` (cfg json, numpy
    params, tokens or a numpy batch dict (Whisper's frames beside the
    tokens), max_new) on a (1, world) mesh: (tokens, logprobs)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.engine import ServeEngine
    torch.set_num_threads(1)
    cfg_json, params, toks, max_new = case
    mesh = make_host_mesh(1, world, strict=True, device="cpu")
    eng = ServeEngine(ModelConfig.from_json(cfg_json), to_torch(params),
                      max_len=32, device="cpu", mesh=mesh)
    r = eng.generate(toks if isinstance(toks, dict) else {"tokens": toks},
                     max_new)
    return r.tokens, r.logprobs


def grad_blocks(grads, cfg, mesh) -> dict:
    """This rank's gradient blocks as numpy, in flatten order, with each
    leaf's train spec and the rank's mesh geometry (what a test needs to
    cut the same block out of a whole gradient)."""
    from repro_torch.train import fsdp
    from repro_torch.tree import flatten
    shardings = flatten(fsdp.state_shardings(cfg, mesh)[0])
    return dict(grads=[g.detach().numpy().copy() for g in flatten(grads)],
                specs=[s.spec for s in shardings],
                packed=[s.packed for s in shardings],
                shape=dict(mesh.shape), coords=dict(mesh.coords),
                axes=tuple(mesh.axis_names))


def sp_grads(rank: int, world: int, cases) -> list:
    """For each (cfg json, the reference's numpy params, tokens, remat) the
    FSDP step's loss and mean gradient on a (2, world / 2) mesh without and
    with ``sp_residuals``: [(loss, grad_blocks, loss_sp, grad_blocks_sp,
    model collectives by kind with SP)]."""
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import comm
    from repro_torch.train import fsdp
    torch.set_num_threads(1)
    mesh = make_host_mesh(2, world // 2, strict=True, device="cpu")
    out = []
    for cfg_json, params, toks, remat in cases:
        base = ModelConfig.from_json(cfg_json)
        tc = TrainConfig(num_microbatches=2, remat_policy=remat)
        row = []
        for sp in (False, True):
            cfg = base.replace(sp_residuals=sp)
            blocks, _ = fsdp.shard_train_state(params_from_jax(
                params, cfg, device="cpu", dtype=torch.float32), mesh, cfg)
            comm.STATS.reset()
            loss, grads = fsdp.make_fsdp_grads(cfg, tc, mesh)(
                blocks, {"tokens": torch.from_numpy(toks)})
            row += [float(loss), grad_blocks(grads, cfg, mesh)]
        row.append(dict(comm.STATS.kinds))
        out.append(tuple(row))
    return out


def pod_step(rank: int, world: int, case, pods: int) -> dict:
    """``case`` (cfg json, the reference's numpy params, tokens) on a
    (pods, world / (2·pods), 2) pod mesh: ``pod_steps`` of it at 2
    microbatches."""
    cfg_json, params, toks = case
    return pod_steps(rank, world, [(cfg_json, params, {"tokens": toks}, 2)],
                     pods)[0]


def pod_steps(rank: int, world: int, cases, pods: int) -> list:
    """Each (cfg json, the reference's numpy params, a numpy batch,
    microbatches) on one (pods, world / (2·pods), 2) pod mesh: the FSDP
    step's loss and mean gradient (``grad_blocks``), then one train step's
    metrics and its data- and pod-axis collectives."""
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.sharding import comm
    from repro_torch.train import fsdp
    torch.set_num_threads(1)
    mesh = make_pod_mesh(pods, world // (2 * pods), 2, device="cpu")
    out = []
    for cfg_json, params, batch, nmb in cases:
        cfg = ModelConfig.from_json(cfg_json)
        tc = TrainConfig(num_microbatches=nmb, remat_policy="minimal")
        blocks, opt = fsdp.shard_train_state(params_from_jax(
            params, cfg, device="cpu", dtype=torch.float32), mesh, cfg)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, grads = fsdp.make_fsdp_grads(cfg, tc, mesh)(blocks, batch)
        got = dict(grad_loss=float(loss), **grad_blocks(grads, cfg, mesh))
        comm.STATS.reset()
        _, _, m = fsdp.make_fsdp_train_step(cfg, tc, mesh)(blocks, opt,
                                                            batch)
        out.append(dict(got, data=comm.STATS.data_count,
                        pod=comm.STATS.pod_count,
                        **{k: float(v) for k, v in m.items()}))
    return out


def sp_collectives(rank: int, world: int, seed: int) -> dict:
    """The model-axis last-axis collectives of Megatron-SP on a (1, world)
    mesh, from inputs every rank draws alike from ``seed``: {op: (y, the
    gradient of this rank's objective sum(y * c) summed over the ranks,
    with respect to its input)}. xs (world, 3, 2·world): each rank's
    input; cs (world, 3, 2·world): each rank's weights."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import comm
    torch.set_num_threads(1)
    mesh = make_host_mesh(1, world, strict=True, device="cpu")
    rng = np.random.RandomState(seed)
    n = 2 * world
    xs = torch.as_tensor(rng.randn(world, 3, n).astype(np.float32))
    cs = torch.as_tensor(rng.randn(world, 3, n).astype(np.float32))
    out = {}
    for op in ("reduce_scatter_last", "all_gather_last", "all_gather_whole",
               "split_last"):
        x = (xs[rank] if op in ("reduce_scatter_last", "split_last")
             else xs[rank][:, 2 * rank:2 * rank + 2])
        x = x.clone().requires_grad_(True)
        with comm.serving(mesh, mode="train"):
            if op == "reduce_scatter_last":
                y = comm.reduce_scatter_last(x)
                c = cs[0][:, 2 * rank:2 * rank + 2]
            elif op == "split_last":
                y = comm.split_last(x)
                c = cs[0][:, 2 * rank:2 * rank + 2]
            else:
                y = comm.all_gather_last(x, whole_grad=op.endswith("whole"))
                c = cs[0] if op.endswith("whole") else cs[rank]
            (y * c).sum().backward()
        out[op] = (y.detach().numpy(), x.grad.numpy())
    return out


def legacy_generates(rank: int, world: int, cases) -> list:
    """``legacy_generate`` of each case on this rank."""
    return [legacy_generate(rank, world, case) for case in cases]


def split_grads(rank: int, world: int, data: int, cases) -> list:
    """For each (cfg json, the reference's numpy params, a numpy batch,
    remat) the FSDP step's loss and mean gradient over 2 microbatches on
    a (data, world / data) mesh: [(loss, ``grad_blocks``)]."""
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import fsdp
    torch.set_num_threads(1)
    mesh = make_host_mesh(data, world // data, strict=True, device="cpu")
    out = []
    for cfg_json, params, batch, remat in cases:
        cfg = ModelConfig.from_json(cfg_json)
        blocks, _ = fsdp.shard_train_state(params_from_jax(
            params, cfg, device="cpu", dtype=torch.float32), mesh, cfg)
        loss, grads = fsdp.make_fsdp_grads(
            cfg, TrainConfig(num_microbatches=2, remat_policy=remat), mesh)(
            blocks, {k: torch.from_numpy(v) for k, v in batch.items()})
        out.append((float(loss), grad_blocks(grads, cfg, mesh)))
    return out


def split_family_checks(rank: int, world: int, legacy, grads) -> dict:
    """One rank group for a family test file: ``legacy_generate`` of each
    of ``legacy`` on (1, world), then ``split_grads`` of ``grads`` on (2,
    world / 2) (None: skipped)."""
    out = dict(legacy=[legacy_generate(rank, world, c) for c in legacy])
    if grads:
        out["grads"] = split_grads(rank, world, 2, grads)
    return out


def group(fn, world: int, args, timeout: float = 240.0):
    """Start ``comm.spawn(fn, world, args=args)`` on the CPU in a thread;
    returns a getter of its result (or raises what the group raised), so
    a test module's fixture starts its rank group and computes the
    reference's side while the ranks run."""
    import threading

    from repro_torch.sharding import comm
    box, done = {}, threading.Event()

    def run():
        try:
            box["out"] = comm.spawn(fn, world, timeout=timeout, args=args,
                                    device="cpu")
        except Exception as e:  # noqa: BLE001 — raised in the tests
            box["out"] = e
        done.set()

    threading.Thread(target=run, daemon=True).start()

    def get():
        assert done.wait(timeout=2 * timeout)
        if isinstance(box["out"], Exception):
            raise box["out"]
        return box["out"]
    return get

