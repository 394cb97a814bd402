"""Rank groups for the port's sharded-serving tests: gloo ranks on the CPU,
spawned through ``repro_torch.sharding.comm.spawn`` (a file store in a
fresh directory, one timeout for the whole group, every rank killed when
it runs out).

``serve_cases(rank, world, cases)`` runs in each rank: every case serves
its prompts through the port's engine on a (1, world) mesh and returns
what the tests compare, as plain Python and numpy values. A case is a dict
of numpy values only (params as nested dicts of arrays), so it pickles to
the ranks without shared memory."""
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


def engine_kwargs(case) -> dict:
    """The case's EngineConfig fields, its numpy trees made torch."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.predictor import predictors as tpred
    kw = dict(GEOM, prefill_chunk=case.get("chunk", 0),
              fast_kernels=case.get("fast"))
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


def serve(cfg, params, kw, mesh=None) -> dict:
    """One case through the port's engine: streams, logprobs, metrics and
    the per-request counters the tests compare."""
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(mesh=mesh, **kw),
                                   device="cpu")
    uids = [eng.submit(p, MAX_NEW, reuse_window=r)
            for p, r in zip(prompts(cfg.vocab_size), REUSE)]
    res = eng.run()
    return dict(
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
                and kw["predictor"].params["w"].shape[-1] == cfg.d_ff)))


def serve_cases(rank: int, world: int, cases) -> dict:
    """Every case on this rank of a (1, world) mesh; {case id: result}."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import comm
    torch.set_num_threads(1)
    mesh = make_host_mesh(1, world, strict=True, device="cpu")
    out = {}
    for cid, case in cases.items():
        cfg = ModelConfig.from_json(case["cfg"])
        comm.STATS.reset()
        out[cid] = serve(cfg, to_torch(case["params"]), engine_kwargs(case),
                         mesh)
        out[cid]["all_reduces"] = comm.STATS.count
    try:  # ranks that offer different checksums must raise
        comm.check_same(100 + rank, mesh)
        out["disagree"] = "no error"
    except RuntimeError as e:
        out["disagree"] = str(e)
    return out


# -- rank functions for the group's own checks -------------------------------


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
