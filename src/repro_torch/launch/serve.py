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

The engine runs on CUDA unless ``--device cpu`` is given; with no CUDA and
no ``--device cpu`` it raises. ``--sparse-density d > 0`` relufies the
model (stage 2) and serves it at static tile capacities d (FFN) and
min(1, 3 d) (inputs), on both engines. Not ported, raising
NotImplementedError (ROADMAP.md): ``--mesh`` (sharded serving) and the
pod-mesh compile path (no ``--smoke``). The mamba, hybrid, encdec and
vlm archs (falcon-mamba-7b, zamba2-7b, whisper-small, internvl2-1b) serve
on the legacy engine only, with zero stub patches / frames in the compute
dtype; the continuous engine raises for them, as the reference's does.

  python -m repro_torch.launch.serve --arch falcon-mamba-7b --smoke
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
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
                    help="sharded serving: not ported (raises)")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when CUDA is absent) or cpu")
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
    if args.mesh:
        raise NotImplementedError("--mesh (sharded serving) is not ported "
                                  "to PyTorch yet (ROADMAP.md)")
    if not args.smoke:
        raise NotImplementedError("the pod-mesh compile path (no --smoke) "
                                  "is not ported to PyTorch (ROADMAP.md)")

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

    device = cm.resolve_device(args.device)
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
        print(f"generated {res.tokens.shape} tokens; aggregated FFN sparsity "
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
    eng = ContinuousBatchingEngine(cfg, params, config=EngineConfig(
        n_slots=2, block_size=16, max_blocks_per_seq=max_bps,
        track_sparsity=True, **spec_kw), device=device)
    uids = [eng.submit(p, args.tokens, reuse_window=args.reuse_window)
            for p in prompts]
    res = eng.run()
    aggs = [eng.trackers[u].aggregated_sparsity() for u in uids]
    print(f"continuous batching served {len(uids)} requests "
          f"({sum(len(res[u].tokens) for u in uids)} tokens); "
          f"per-request aggregated FFN sparsity "
          f"{', '.join(f'{a:.3f}' for a in aggs)}; "
          f"weight I/O saved {eng.weight_io_saved():.1%}")
    if cfg.n_experts:
        print(f"moe routing: {cfg.top_k}/{cfg.n_experts} experts per "
              f"token (expert I/O fraction "
              f"{eng.expert_io_fraction():.3f}); activated-expert FFN "
              f"weight read {eng.weight_io_bytes_per_step():.0f} B/step")
    if args.prefix_cache:
        print(f"prefix cache: hit rate {eng.prefix_hit_rate():.1%}; "
              f"prefill tokens saved {eng.prefill_tokens_saved()} "
              f"(chunked prefill, chunk={args.prefill_chunk})")
    if args.predictor != "none":
        print(f"predictor={args.predictor} "
              f"(target recall {args.target_recall}): "
              f"tile density {eng.predictor_density():.3f}; "
              f"realized recall {eng.predictor_recall():.4f}; "
              f"up+down weight I/O saved {eng.weight_io_saved():.1%}; "
              f"per-request misses "
              f"{', '.join(str(res[u].pred_misses) for u in uids)}")
    if args.speculative:
        ms = [spec_metrics(res[u], gamma=args.gamma, c=0.1,
                           s_agg=eng.s_agg_window()) for u in uids]
        print(f"speculative gamma={args.gamma}: "
              f"alpha={np.mean([m.accept_rate for m in ms]):.3f}; "
              f"target-call reduction "
              f"{np.mean([m.target_call_reduction for m in ms]):.2f}x; "
              f"window s_agg={eng.s_agg_window():.3f}; "
              f"Thm1 sparse-verify speedup "
              f"{np.mean([m.thm1_speedup for m in ms]):.3f}x")
    print("-- final observability snapshot --")
    print(format_statusz(eng), end="")


if __name__ == "__main__":
    main()
