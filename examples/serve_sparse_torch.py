"""Serve a small relufied model with the PyTorch port's continuous
batching: mixed-length requests admitted/retired mid-decode over a paged
KV cache, per-request aggregated-sparsity tracking, γ-window weight
reuse, sparse speculative decoding, and predictor serving (paper Sec. 5),
on a model the port's Trainer has just trained.

The model is the reference example's (d_model 96, d_ff 384, 3 layers;
the draft d_model 48, d_ff 192) with heads of 16: 6 heads for the target
and 3 for the draft, where the reference has 4 heads of 24 and of 12.
The card's bf16 attention kernel takes head dims 16, 32, 64, 80 and 128.
The trainer's f32 masters are stored once in the compute dtype for
serving (``cast_params``), as the port's engine serves them.

    PYTHONPATH=src python examples/serve_sparse_torch.py [--device cpu]
    PYTHONPATH=src python examples/serve_sparse_torch.py \
        --predictor lowrank --target-recall 0.95
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import TrainConfig
from repro_torch.core import spec_theory
from repro_torch.data.pipeline import DataConfig, eval_batches
from repro_torch.models.common import cast_params
from repro_torch.predictor import calibrate
from repro_torch.serving import ContinuousBatchingEngine
from repro_torch.serving.spec_decode import spec_metrics
from repro_torch.train.loop import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--predictor", choices=["none", "sign", "lowrank"],
                    default="sign",
                    help="predictor serving demo kind (none skips it)")
    ap.add_argument("--target-recall", type=float, default=0.99)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train-steps", type=int, default=100)
    ap.add_argument("--draft-steps", type=int, default=80)
    args = ap.parse_args(argv)
    dev = args.device
    cfg = ModelConfig(name="srv", family="dense", n_layers=3, d_model=96,
                      n_heads=6, n_kv_heads=6, d_ff=384, vocab_size=256,
                      max_seq_len=256, activation="relu", ffn_kind="glu")
    dc = DataConfig(vocab_size=256, seq_len=64, batch_size=8)
    print("training a small ReLU model...")
    tr = Trainer(cfg, TrainConfig(learning_rate=5e-3,
                                  total_steps=args.train_steps,
                                  warmup_steps=10), dc, log=lambda *_: None,
                 device=dev)
    tr.run(args.train_steps)
    params = cast_params(tr.params, cfg)

    # mixed-length requests through the continuous-batching engine: 6
    # requests over 4 slots, so admission/retirement happens mid-decode
    data = eval_batches(dc, 1)[0]["tokens"]
    prompts = [np.asarray(data[i, : 8 + 6 * i], np.int32) for i in range(6)]
    eng = ContinuousBatchingEngine(cfg, params, n_slots=4, block_size=16,
                                   max_blocks_per_seq=6, track_sparsity=True,
                                   device=dev)
    uids = [eng.submit(p, max_new=32) for p in prompts]
    t0 = time.time()
    res = eng.run()
    dt = time.time() - t0
    n_tok = sum(len(res[u].tokens) for u in uids)
    agg = eng.trackers[uids[0]]
    print(f"served {len(uids)} mixed-length requests ({n_tok} tokens) in "
          f"{dt:.2f}s ({n_tok / dt:.0f} tok/s); request 0: "
          f"per-token FFN sparsity {agg.mean_token_sparsity():.3f}, "
          f"aggregated over its window {agg.aggregated_sparsity():.3f} "
          f"(random baseline {agg.random_baseline():.2e})")

    # γ-window weight reuse (paper Fig. 7c): same requests, masked decode
    eng_g = ContinuousBatchingEngine(cfg, params, n_slots=4, block_size=16,
                                     max_blocks_per_seq=6, device=dev)
    uids_g = [eng_g.submit(p, max_new=32, reuse_window=8) for p in prompts]
    res_g = eng_g.run()
    nll_g = -np.mean(np.concatenate([res_g[u].logprobs for u in uids_g]))
    nll_0 = -np.mean(np.concatenate([res[u].logprobs for u in uids]))
    print(f"reuse γ=8: NLL {nll_g:.4f} vs fresh {nll_0:.4f} "
          f"(small gap = Fig. 7c); down-proj weight I/O saved "
          f"{eng_g.weight_io_saved():.1%}")

    # sparse speculative decoding THROUGH the engine: the draft proposes
    # γ tokens per slot, the target verifies each slot's whole window in one
    # forward using the window's aggregated-active FFN rows (Sec. 5.2)
    dcfg = cfg.replace(name="srv-draft", n_layers=1, d_model=48, d_ff=192,
                       n_heads=3, n_kv_heads=3, head_dim=16)
    dtr = Trainer(dcfg, TrainConfig(learning_rate=5e-3,
                                    total_steps=args.draft_steps,
                                    warmup_steps=10), dc, log=lambda *_: None,
                  device=dev)
    dtr.run(args.draft_steps)
    eng_s = ContinuousBatchingEngine(cfg, params, n_slots=4, block_size=16,
                                     max_blocks_per_seq=6, draft_cfg=dcfg,
                                     draft_params=cast_params(dtr.params,
                                                              dcfg),
                                     gamma=4, device=dev)
    uids_s = [eng_s.submit(p, max_new=16) for p in prompts]
    res_s = eng_s.run()
    ms = [spec_metrics(res_s[u], gamma=4, c=0.1,
                       s_agg=eng_s.s_agg_window()) for u in uids_s]
    alpha = float(np.mean([m.accept_rate for m in ms]))
    print(f"speculative serving: {sum(m.n_target_calls for m in ms)} target "
          f"calls for {sum(len(m.tokens) for m in ms)} tokens across "
          f"{len(uids_s)} requests (alpha={alpha:.3f}); "
          f"window s_agg={eng_s.s_agg_window():.3f}; "
          f"Thm-1 sparse-over-standard speedup {ms[0].thm1_speedup:.3f}x")
    g_star, sp = spec_theory.optimal_gamma(0.1, alpha,
                                           lambda g: eng_s.s_agg_window())
    print(f"optimal gamma for this (c, alpha): {g_star} (speedup {sp:.2f}x)")

    # predictor serving (the third mode): a calibrated activity predictor
    # names each token's active FFN rows BEFORE the weights are read, so the
    # engine gathers only those rows for BOTH the up- and down-projections
    # (tile=1 = the paper's exact row-skipping)
    out = {"tokens": n_tok, "nll": float(nll_0), "nll_reuse": float(nll_g),
           "io_saved_reuse": eng_g.weight_io_saved(), "alpha": alpha,
           "s_agg": eng_s.s_agg_window()}
    if args.predictor != "none":
        pred = calibrate(params, cfg,
                         {"tokens": torch.as_tensor(data, device=dev)},
                         kind=args.predictor,
                         target_recall=args.target_recall, tile=1)
        eng_p = ContinuousBatchingEngine(cfg, params, n_slots=4,
                                         block_size=16, max_blocks_per_seq=6,
                                         predictor=pred, device=dev)
        uids_p = [eng_p.submit(p, max_new=32) for p in prompts]
        res_p = eng_p.run()
        nll_p = -np.mean(np.concatenate([res_p[u].logprobs
                                         for u in uids_p]))
        print(f"predictor serving ({args.predictor}): tile density "
              f"{eng_p.predictor_density():.3f} -> up+down weight I/O saved "
              f"{eng_p.weight_io_saved():.1%} at realized recall "
              f"{eng_p.predictor_recall():.4f} "
              f"(target {args.target_recall}); "
              f"NLL {nll_p:.4f} vs dense {nll_0:.4f}")
        out.update(predictor_density=eng_p.predictor_density(),
                   predictor_recall=eng_p.predictor_recall(),
                   nll_predictor=float(nll_p))
    print("serve_sparse OK")
    return out


if __name__ == "__main__":
    main()
