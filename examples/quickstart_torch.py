"""Quickstart with the PyTorch port: build a tiny relufied model, measure
activation sparsity, and run the sparse FFN hot path on the card (the
fused up-projection + ReLU kernel and the tile-gathered down-projection
kernel) against the same call on CPU tensors (their plain versions).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import flops as fl
from repro_torch.core import relufication
from repro_torch.core.sparsity import measure_site_sparsity
from repro_torch.kernels import ops
from repro_torch.models import registry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. a llama-style tiny model, relufied stage 2 (paper Sec. 4)
    cfg = get_config("tiny")  # SwiGLU/SiLU
    cfg = relufication.relufy_stage2(cfg)
    print(f"config: {cfg.name} activation={cfg.activation} "
          f"post_norm_relu={cfg.post_norm_relu}")

    fam = registry.get_family(cfg)
    params = fam.init_params(cfg, seed=0, device=args.device)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 32))
    batch = {"tokens": torch.as_tensor(tokens, device=args.device)}

    # 2. measure per-site sparsity (paper Table 1 columns)
    sp = measure_site_sparsity(params, batch, cfg)
    print(f"sparsity: down={sp.get('mean/down', 0):.3f} "
          f"up={sp.get('mean/up', 0):.3f} qkv={sp.get('mean/qkv', 0):.3f}")

    # 3. FLOPs accounting (the paper's efficiency metric)
    levels = fl.SparsityLevels(qkv=sp.get("mean/qkv", 0),
                               up=sp.get("mean/up", 0),
                               down=sp.get("mean/down", 0))
    dense = fl.macs_per_token(cfg) / 1e6
    sparse = fl.macs_per_token(cfg, levels) / 1e6
    print(f"MACs/token: dense {dense:.2f}M -> sparse {sparse:.2f}M "
          f"({1 - sparse / dense:.1%} saved)")

    # 4. the sparse-FFN hot path on the device, against its plain versions
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(4, 128), dtype=torch.float32)
    wu = torch.as_tensor(rng.randn(128, 1024) / 11.3, dtype=torch.float32)
    wd = torch.as_tensor(rng.randn(1024, 128) / 32.0, dtype=torch.float32)
    y, h, idx, nvalid = ops.sparse_ffn_apply(x, wu, wd, density=0.25,
                                             device=args.device)
    y_ref, *_ = ops.sparse_ffn_apply(x, wu, wd, density=0.25, device="cpu")
    err = float((y.cpu() - y_ref).abs().max())
    print(f"sparse FFN on {y.device.type}: {int(nvalid)}/"
          f"{h.shape[1] // 128} tiles active, "
          f"max|device - plain| = {err:.2e}")
    print("quickstart OK")
    return {"sparsity": sp, "macs_dense": dense, "macs_sparse": sparse,
            "nvalid": int(nvalid), "max_abs_err": err}


if __name__ == "__main__":
    main()
