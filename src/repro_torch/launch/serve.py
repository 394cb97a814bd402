"""Serving launcher of the port: the smoke paths of the reference's
``launch/serve.py`` (the legacy single-batch ``ServeEngine`` and the
continuous-batching engine), with the same report lines.

  python -m repro_torch.launch.serve --arch qwen3-4b --smoke --tokens 32
  python -m repro_torch.launch.serve --arch qwen3-4b --smoke \\
      --sparse-density 0.5 --reuse-window 3   # static tile capacities
  python -m repro_torch.launch.serve --arch tiny-relu --smoke --continuous
  python -m repro_torch.launch.serve --arch tiny-relu --smoke --speculative
  python -m repro_torch.launch.serve --arch tiny-relu --smoke \\
      --predictor sign --target-recall 0.99                # predictor mode
  python -m repro_torch.launch.serve --arch tiny-relu --smoke \\
      --prefill-chunk 16 --prefix-cache   # chunked prefill + prefix reuse
  python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke \\
      --continuous   # MoE through the engine: routed experts as sparsity
  python -m repro_torch.launch.serve --arch tiny-relu --smoke \\
      --continuous --mesh 1,2   # tensor-parallel sharded serving, 2 ranks
  python -m repro_torch.launch.serve --arch tiny-relu --smoke \\
      --continuous --mesh 2,4   # and the pool split over 2 data rows

The engine runs on CUDA unless ``--device cpu`` is given; with no CUDA and
no ``--device cpu`` it raises. ``--sparse-density d > 0`` relufies the
model (stage 2) and serves it at static tile capacities d (FFN) and
min(1, 3 d) (inputs), on both engines.

``--mesh DATA,MODEL`` serves the continuous engine over DATA x MODEL
torch.distributed ranks (``EngineConfig(mesh=)``): the weights
tensor-parallel over MODEL, the slots and the paged pool's blocks split
over DATA where they divide it. Launched
under a torch.distributed launcher (``WORLD_SIZE`` set) the command joins
that world, whose size must hold the mesh (``make_host_mesh(strict=True)``
raises otherwise); launched alone it spawns the ranks itself
(``sharding.comm.spawn``, NCCL when each rank has a card of its own, gloo
when they share one or run on the CPU). Rank 0 prints the report.

Without ``--smoke`` the reference compiles the serving step for its pod
mesh. The port builds it as a dry run, asked for with ``--dry-run``: the
legacy prefill or decode step of the arch at full size (``--shape``,
default decode_32k; ``--sparse-density`` its relufied static-capacity
variant) on rank 0 of the 256-rank (16, 16) world (512-rank (2, 16, 16)
with ``--multi-pod``), on "meta" tensors (``launch/dryrun.py``), and
prints the rank's memory account and the cell's record:

  python -m repro_torch.launch.serve --arch qwen3-4b --dry-run \
      --sparse-density 0.6

The
mamba, hybrid, encdec and vlm archs (falcon-mamba-7b, zamba2-7b, whisper-small, internvl2-1b) serve
on the legacy engine only, with zero stub patches / frames in the compute
dtype; the continuous engine raises for them, as the reference's does.

  python -m repro_torch.launch.serve --arch falcon-mamba-7b --smoke
"""
from __future__ import annotations

import argparse


# seconds the ranks --mesh spawns may take before all are killed
MESH_TIMEOUT_S = 600.0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--sparse-density", type=float, default=0.0,
                    help="FFN tile density; 0 = dense serving")
    ap.add_argument("--reuse-window", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--continuous", action="store_true",
                    help="smoke the continuous-batching paged-cache engine "
                         "(any family declaring the 'paged_decode' serving "
                         "capability: dense + moe)")
    ap.add_argument("--speculative", action="store_true",
                    help="smoke the engine's speculative mode: a 1-layer "
                         "draft proposes γ tokens per slot, the target "
                         "verifies each window in one forward (implies "
                         "--continuous)")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft length γ for --speculative")
    ap.add_argument("--predictor", choices=["none", "sign", "lowrank"],
                    default="none",
                    help="predictor serving mode: skip up+down projection "
                         "weight reads for neurons a calibrated activity "
                         "predictor marks inactive (implies --continuous; "
                         "relufies soft-activation archs first)")
    ap.add_argument("--target-recall", type=float, default=0.99,
                    help="calibration recall target for --predictor")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: admit prompts one fixed-size "
                         "chunk per engine step, interleaved with decode "
                         "(0 = whole-prompt prefill; implies --continuous)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse KV blocks across requests sharing a "
                         "block-aligned prompt prefix (the smoke workload "
                         "then shares a system prompt; implies "
                         "--prefill-chunk 16 unless set)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve the continuous-batching engine on a "
                         "(data, model) mesh of torch.distributed ranks: "
                         "weights tensor-parallel over 'model' by the "
                         "serve-mode rules, slots and pool blocks over "
                         "'data' (implies --continuous; raises when the "
                         "world cannot hold the shape)")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--dry-run", action="store_true",
                    help="without --smoke: build the production serving "
                         "step on 'meta' tensors and print its memory "
                         "account")
    ap.add_argument("--shape", default="decode_32k",
                    choices=["prefill_32k", "decode_32k", "long_500k"],
                    help="the dry run's cell")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the dry run on the (2, 16, 16) mesh")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when CUDA is absent) or cpu")
    return ap


def main(argv=None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.prefix_cache and args.prefill_chunk == 0:
        args.prefill_chunk = 16
    if (args.speculative or args.predictor != "none" or args.prefill_chunk
            or args.mesh):
        args.continuous = True
    if args.speculative and args.predictor != "none":
        ap.error("--speculative and --predictor are mutually exclusive "
                 "serving modes")
    if args.continuous and not args.smoke:
        ap.error("--continuous requires --smoke")
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = tuple(int(x) for x in args.mesh.split(","))
            assert len(mesh_shape) == 2 and min(mesh_shape) >= 1
        except (ValueError, AssertionError):
            ap.error(f"--mesh expects DATA,MODEL (two positive ints), "
                     f"got {args.mesh!r}")
    if not args.smoke:
        _pod_dry_run(args)
        return
    if mesh_shape is not None:
        _serve_on_mesh(args, mesh_shape)
        return
    _serve(args)


def _pod_dry_run(args) -> None:
    """The production serving step as a dry run (module note)."""
    import json

    from repro_torch.launch import dryrun
    from repro_torch.launch.train import memory_line
    if not args.dry_run:
        raise NotImplementedError(
            "the pod-mesh path (no --smoke) runs on a pod of 256 (or 512) "
            "cards, which the port does not drive (ROADMAP.md); it builds "
            "the step as a dry run on 'meta' tensors with --dry-run")
    rec = dryrun.run_cell(args.arch, args.shape, args.multi_pod,
                          sparse=args.sparse_density)
    print(memory_line(f"{args.shape} step", rec))
    print(json.dumps(rec))


def _serve_on_mesh(args, mesh_shape) -> None:
    """The continuous smoke on a (data, model) mesh of ranks: joining the
    launcher's world when there is one, else spawning the ranks."""
    import os

    from repro_torch.sharding import comm

    if "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        device = (comm.rank_device(int(os.environ.get("LOCAL_RANK", rank)))
                  if args.device == "cuda" else args.device)
        comm.init_ranks(rank, world, "env://", device)
        try:
            _mesh_rank(rank, world, args, mesh_shape)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
        return
    world = mesh_shape[0] * mesh_shape[1]
    if args.device == "cuda":  # one build, before the ranks load it
        from repro_torch.kernels import runtime as rt
        rt.build()
    comm.spawn(_mesh_rank, world, timeout=MESH_TIMEOUT_S,
               args=(args, mesh_shape), device=args.device)


def _mesh_rank(rank: int, world: int, args, mesh_shape) -> None:
    from repro_torch.launch.mesh import make_host_mesh

    device = None if args.device == "cuda" else args.device
    mesh = make_host_mesh(*mesh_shape, strict=True, device=device)
    _serve(args, mesh)


def _serve(args, mesh=None) -> None:
    """The smoke run of ``args``; under a mesh only its rank 0 prints."""
    import numpy as np
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.core import relufication
    from repro_torch.launch.serve_api import smoke_predictor
    from repro_torch.models import common as cm
    from repro_torch.models import registry
    from repro_torch.obs import format_statusz
    from repro_torch.serving import (ContinuousBatchingEngine, EngineConfig,
                                     ServeEngine)
    from repro_torch.serving.spec_decode import spec_metrics

    device = cm.resolve_device(args.device) if mesh is None else mesh.device
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    cfg = smoke_config(args.arch)
    if args.sparse_density > 0:
        cfg = relufication.relufy_stage2(cfg)
        cfg = relufication.enable_sparse_serving(
            cfg, args.sparse_density, min(1.0, args.sparse_density * 3),
            reuse_window=args.reuse_window)
    if not args.continuous:
        params = registry.get_family(cfg).init_params(cfg, seed=0,
                                                      device=device)
        eng = ServeEngine(cfg, params, max_len=64 + args.tokens,
                          track_sparsity=True, device=device)
        batch = {"tokens": np.random.RandomState(1).randint(
            0, cfg.vocab_size, (2, 8))}
        cdt = getattr(torch, cfg.compute_dtype)
        if cfg.family == "vlm":  # the stub frontends' embeddings
            batch["patches"] = torch.zeros(
                (2, cfg.n_vision_tokens, cfg.d_model), dtype=cdt)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (2, cfg.n_audio_frames, cfg.d_model), dtype=cdt)
        res = eng.generate(batch, max_new=args.tokens,
                           reuse_window=args.reuse_window)
        agg = (res.aggregated.aggregated_sparsity()
               if res.aggregated is not None else float("nan"))
        say(f"generated {res.tokens.shape} tokens; aggregated FFN sparsity "
            f"{agg:.3f}")
        return
    if args.predictor != "none":
        from repro_torch.core.activations import is_sparse_activation
        if not is_sparse_activation(cfg.activation):
            cfg = relufication.relufy_stage1(cfg)
        cfg = cfg.replace_sparsity(predictor=args.predictor,
                                   predictor_recall=args.target_recall)
    fam = registry.get_family(cfg)
    params = fam.init_params(cfg, seed=0, device=device)
    rng = np.random.RandomState(1)
    lengths = (8, 13, 21)
    if args.prefix_cache:
        # shared system prompt (two full 16-token blocks): request 1
        # prefills it cold, every later admission maps it from the trie
        system = rng.randint(0, cfg.vocab_size, 32)
        prompts = [np.concatenate([system,
                                   rng.randint(0, cfg.vocab_size, s)])
                   for s in lengths]
    else:
        prompts = [rng.randint(0, cfg.vocab_size, s) for s in lengths]
    max_bps = -(-(max(len(p) for p in prompts) + args.tokens) // 16)
    spec_kw = {}
    if args.prefill_chunk:
        spec_kw.update(prefill_chunk=args.prefill_chunk,
                       prefix_cache=args.prefix_cache)
    if args.speculative:
        dcfg = cfg.replace(name=f"{cfg.name}-draft", n_layers=1)
        spec_kw.update(draft_cfg=dcfg,
                       draft_params=fam.init_params(dcfg, seed=2,
                                                    device=device),
                       gamma=args.gamma)
    if args.predictor != "none":
        spec_kw.update(predictor=smoke_predictor(params, cfg, device))
    if mesh is not None:
        # a pool the data axis divides: each data row holds its blocks
        n_blocks = 1 + 2 * max_bps
        spec_kw["n_blocks"] = n_blocks + -n_blocks % mesh.shape["data"]
    eng = ContinuousBatchingEngine(cfg, params, config=EngineConfig(
        n_slots=2, block_size=16, max_blocks_per_seq=max_bps,
        track_sparsity=True, mesh=mesh, **spec_kw), device=device)
    uids = [eng.submit(p, args.tokens, reuse_window=args.reuse_window)
            for p in prompts]
    res = eng.run()
    aggs = [eng.trackers[u].aggregated_sparsity() for u in uids]
    say(f"continuous batching served {len(uids)} requests "
        f"({sum(len(res[u].tokens) for u in uids)} tokens); "
        f"per-request aggregated FFN sparsity "
        f"{', '.join(f'{a:.3f}' for a in aggs)}; "
        f"weight I/O saved {eng.weight_io_saved():.1%}")
    if cfg.n_experts:
        say(f"moe routing: {cfg.top_k}/{cfg.n_experts} experts per "
            f"token (expert I/O fraction "
            f"{eng.expert_io_fraction():.3f}); activated-expert FFN "
            f"weight read {eng.weight_io_bytes_per_step():.0f} B/step")
    if mesh is not None:
        say(f"sharded serving on mesh {dict(eng.mesh.shape)}: "
            f"TP={eng.tp}; per-device FFN weight read "
            f"{eng.weight_io_bytes_per_step():.0f} B/step "
            f"(= {eng.weight_io_bytes_per_step(per_device=False):.0f} "
            f"B total x 1/{eng.ffn_tp})")
        if eng.data is not None:
            say(f"data axis: a rank holds {eng.pages['k'].shape[1]} of "
                f"{eng.data.n_blocks} pool blocks and computes "
                f"{eng.data.slots[1]} of {eng.data.n_slots} slots")
    if args.prefix_cache:
        say(f"prefix cache: hit rate {eng.prefix_hit_rate():.1%}; "
            f"prefill tokens saved {eng.prefill_tokens_saved()} "
            f"(chunked prefill, chunk={args.prefill_chunk})")
    if args.predictor != "none":
        say(f"predictor={args.predictor} "
            f"(target recall {args.target_recall}): "
            f"tile density {eng.predictor_density():.3f}; "
            f"realized recall {eng.predictor_recall():.4f}; "
            f"up+down weight I/O saved {eng.weight_io_saved():.1%}; "
            f"per-request misses "
            f"{', '.join(str(res[u].pred_misses) for u in uids)}")
    if args.speculative:
        ms = [spec_metrics(res[u], gamma=args.gamma, c=0.1,
                           s_agg=eng.s_agg_window()) for u in uids]
        say(f"speculative gamma={args.gamma}: "
            f"alpha={np.mean([m.accept_rate for m in ms]):.3f}; "
            f"target-call reduction "
            f"{np.mean([m.target_call_reduction for m in ms]):.2f}x; "
            f"window s_agg={eng.s_agg_window():.3f}; "
            f"Thm1 sparse-verify speedup "
            f"{np.mean([m.thm1_speedup for m in ms]):.3f}x")
    say("-- final observability snapshot --")
    say(format_statusz(eng), end="")


if __name__ == "__main__":
    main()
