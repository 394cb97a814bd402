"""Training launcher of the port: the smoke path of the reference's
``launch/train.py`` — relufication surgery on the config, then the
``Trainer`` (AdamW, remat, async checkpoints, resume).

  python -m repro_torch.launch.train --arch qwen3-4b --smoke --steps 20
  python -m repro_torch.launch.train --arch tiny-relu --smoke --steps 20 \\
      --relufy-stage 2 --ckpt build/train_ckpt --device cpu

It trains on CUDA unless ``--device cpu`` is given; with no CUDA and no
``--device cpu`` it raises. Without ``--smoke`` the reference compiles the
sharded step for its pod mesh; the port has no mesh, so that path raises
NotImplementedError (ROADMAP.md), as ``launch/serve.py`` does.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--relufy-stage", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--shifted-relu", type=float, default=None,
                    help="use ReLU(x - b) with this shift")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config on one device")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1.5e-5)  # paper's FT recipe
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if not args.smoke:
        raise NotImplementedError("the pod-mesh compile path (no --smoke) "
                                  "is not ported to PyTorch (ROADMAP.md)")

    from repro_torch.configs import TrainConfig, smoke_config
    from repro_torch.core import relufication
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.loop import Trainer

    cfg = smoke_config(args.arch)
    if args.relufy_stage == 1:
        cfg = relufication.relufy_stage1(cfg)
    elif args.relufy_stage == 2:
        cfg = relufication.relufy_stage2(cfg)
    if args.shifted_relu is not None:
        cfg = relufication.shifted_relufy(cfg, args.shifted_relu)

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4)
    tc = TrainConfig(learning_rate=5e-3, total_steps=args.steps,
                     warmup_steps=5, num_microbatches=1)
    tr = Trainer(cfg, tc, dc, ckpt_dir=args.ckpt, device=args.device)
    rep = tr.run(args.steps)
    print(f"done: {rep.steps} steps, final loss {rep.losses[-1]:.4f}, "
          f"skipped {rep.skipped_steps}, stragglers {rep.straggler_steps}")


if __name__ == "__main__":
    main()
