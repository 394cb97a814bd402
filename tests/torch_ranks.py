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
    so one is preempted and resumes later, into other blocks."""
    ps = prompts(vocab)
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
    return uids, eng.run()


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
        pool_blocks=eng.pages["k"].shape[1],
        preemptions=[res[u].preemptions for u in uids],
        tokens=[res[u].tokens.tolist() for u in uids],
        logprobs=[np.asarray(res[u].logprobs) for u in uids],
        draft_accepted=[res[u].draft_accepted for u in uids],
        pred_misses=[res[u].pred_misses for u in uids],
        metrics=eng.metrics_snapshot(),
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
