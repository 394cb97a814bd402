"""End-to-end relufication with the PyTorch port (paper Sec. 4,
Figs. 4/6):

  1. pretrain a SiLU (SwiGLU) model from scratch,
  2. stage-1 surgery: swap SiLU -> ReLU, fine-tune, watch recovery,
  3. stage-2 surgery: insert post-norm ReLU, fine-tune,
  4. report sparsity + FLOPs saving at each stage.

The reference example's ``--preset pod`` only prints a production command
for a TPU pod mesh; the port has no such command (its ``launch/train.py``
runs ``--smoke`` only), so this example has no presets.

    PYTHONPATH=src python examples/train_relufication_torch.py --steps 120
"""
import argparse

import torch

from repro_torch.configs import TrainConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core import flops as fl
from repro_torch.core import relufication
from repro_torch.core.sparsity import measure_site_sparsity
from repro_torch.data.pipeline import DataConfig, eval_batches
from repro_torch.models.common import resolve_device
from repro_torch.train.loop import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--finetune-steps", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ModelConfig(name="ex-base", family="dense", n_layers=4, d_model=96,
                      n_heads=4, n_kv_heads=4, d_ff=384, vocab_size=256,
                      max_seq_len=128, activation="silu", ffn_kind="glu")
    dc = DataConfig(vocab_size=256, seq_len=64, batch_size=8)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in eval_batches(dc, 1)[0].items()}

    def fit(cfg, steps, init=None, lr=5e-3, tag=""):
        tc = TrainConfig(learning_rate=lr, total_steps=steps, warmup_steps=10,
                         schedule="cosine")
        tr = Trainer(cfg, tc, dc, log=lambda *_: None, device=dev)
        rep = tr.run(steps, params=init)
        nll = tr.eval_loss(tr.params)
        sp = measure_site_sparsity(tr.params, batch, cfg)
        print(f"[{tag}] steps={rep.steps} train_loss={rep.losses[-1]:.4f} "
              f"eval_nll={nll:.4f} down_sparsity={sp.get('mean/down', 0):.3f} "
              f"qkv_sparsity={sp.get('mean/qkv', 0):.3f}")
        return tr.params, nll, sp

    print("== 1. pretrain (SiLU/SwiGLU) ==")
    base, base_nll, _ = fit(cfg, args.steps, tag="pretrain")

    print("== 2. stage-1 relufication + fine-tune ==")
    cfg1 = relufication.relufy_stage1(cfg)
    p1, s1_nll, sp1 = fit(cfg1, args.finetune_steps, init=base, lr=2e-3,
                          tag="stage1")

    print("== 3. stage-2 relufication + fine-tune ==")
    cfg2 = relufication.relufy_stage2(cfg)
    p2, s2_nll, sp2 = fit(cfg2, args.finetune_steps, init=p1, lr=2e-3,
                          tag="stage2")

    print("== 4. FLOPs accounting (paper Table 1 style) ==")
    macs = {}
    for tag, c, sp in (("dense", cfg, {}), ("stage1", cfg1, sp1),
                       ("stage2", cfg2, sp2)):
        lv = fl.SparsityLevels(qkv=sp.get("mean/qkv", 0),
                               up=sp.get("mean/up", 0),
                               down=sp.get("mean/down", 0))
        macs[tag] = m = fl.macs_per_token(c, lv) / 1e6
        print(f"  {tag:8s}: {m:8.3f} MMACs/token")
    print(f"quality: base {base_nll:.4f} -> s1 {s1_nll:.4f} -> s2 {s2_nll:.4f}"
          " (paper: recovers to within a few % after brief fine-tuning)")
    print("train_relufication OK")
    return {"nll": [base_nll, s1_nll, s2_nll], "macs": macs,
            "sparsity": {"stage1": sp1, "stage2": sp2}}


if __name__ == "__main__":
    main()
