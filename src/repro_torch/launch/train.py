"""Training launcher of the port: the smoke path of the reference's
``launch/train.py`` — relufication surgery on the config, then the
``Trainer`` (AdamW, remat, async checkpoints, resume).

  python -m repro_torch.launch.train --arch qwen3-4b --smoke --steps 20
  python -m repro_torch.launch.train --arch tiny-relu --smoke --steps 20 \\
      --relufy-stage 2 --ckpt build/train_ckpt --device cpu

It trains on CUDA unless ``--device cpu`` is given; with no CUDA and no
``--device cpu`` it raises.

Without ``--smoke`` the reference compiles the sharded step for its pod
mesh and prints the compiled memory analysis. The port builds that step
(the FSDP + TP step of ``train/fsdp.py``, the arch at full size, the
shape's batch) as a dry run, asked for with ``--dry-run``: rank 0 of a
256-rank (16, 16) world, or 512-rank (2, 16, 16) with ``--multi-pod``,
runs one step on "meta" tensors (``launch/dryrun.py``; no device memory)
and the launcher prints the rank's memory account and the cell's record:

  python -m repro_torch.launch.train --arch qwen3-4b --dry-run
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
    ap.add_argument("--dry-run", action="store_true",
                    help="without --smoke: build the production step on "
                         "'meta' tensors and print its memory account")
    args = ap.parse_args(argv)

    from repro_torch.configs import TrainConfig, get_config, smoke_config
    from repro_torch.core import relufication
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.loop import Trainer

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.relufy_stage == 1:
        cfg = relufication.relufy_stage1(cfg)
    elif args.relufy_stage == 2:
        cfg = relufication.relufy_stage2(cfg)
    if args.shifted_relu is not None:
        cfg = relufication.shifted_relufy(cfg, args.shifted_relu)
    if not args.smoke:
        _pod_dry_run(args, cfg)
        return

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4)
    tc = TrainConfig(learning_rate=5e-3, total_steps=args.steps,
                     warmup_steps=5, num_microbatches=1)
    tr = Trainer(cfg, tc, dc, ckpt_dir=args.ckpt, device=args.device)
    rep = tr.run(args.steps)
    print(f"done: {rep.steps} steps, final loss {rep.losses[-1]:.4f}, "
          f"skipped {rep.skipped_steps}, stragglers {rep.straggler_steps}")


def _pod_dry_run(args, cfg) -> None:
    """The production step of ``cfg`` as a dry run (module note)."""
    import json

    from repro_torch.launch import dryrun
    if not args.dry_run:
        raise NotImplementedError(
            "the pod-mesh path (no --smoke) runs on a pod of 256 (or 512) "
            "cards, which the port does not drive (ROADMAP.md); it builds "
            "the step as a dry run on 'meta' tensors with --dry-run")
    rec = dryrun.run_cell(args.arch, args.shape, args.multi_pod,
                          microbatches=args.microbatches, cfg=cfg)
    print(memory_line("train step", rec))
    print(json.dumps(rec))


def memory_line(what: str, rec: dict) -> str:
    """The rank's memory account of a dry-run record, the counterpart of
    the reference's printed ``compiled.memory_analysis()``."""
    return (f"{what} built for mesh {rec['mesh']} (rank 0 of "
            f"{rec['n_chips']}, on meta) - memory: arguments "
            f"{rec['arg_bytes']} B, temporaries {rec['temp_bytes']} B, peak "
            f"{rec['peak_bytes_per_chip']} B, fits in 80 GB: {rec['fits']}")


if __name__ == "__main__":
    main()
