"""Roofline reports (the reference's ``launch/roofline.py``): the dry-run
table and the serving bytes-per-step gate.

    python -m repro_torch.launch.roofline build/dryrun_results.jsonl [--md]
        The dry-run table over ``launch/dryrun.py``'s records: per cell
        the three terms (modeled from the H100 constants of
        ``launch/dryrun.py``, not measured), the bottleneck, the model
        FLOPs over the counted FLOPs, the peak GB a chip and whether it
        fits in 80 GB. A record with an error shows as ERROR. A sparse
        cell's bytes are kernel 5's own (``launch/op_cost.py``).

    python -m repro_torch.launch.roofline --serving [--check [--tol 0.15]]
        [--config tiny-relu] [--device cpu]

Serves a few requests through the tiny continuous-batching engine on the
kernel path (``fast_kernels=True``: the hand-written kernels on the card,
each wrapper's plain version on the CPU), in autoregressive and predictor
modes, and reports per mode three independent figures for the FFN weight
bytes one decode step reads:

  measured  the engine's own density-accounted
            ``weight_io_bytes_per_step()`` (telemetry of the served
            requests);
  modeled   the fused kernel's geometry (``fused_decode.
            modeled_weight_bytes``: gathered tiles x projections x tile
            footprint) at the measured density;
  counted   the down-projection operand bytes of every matmul of one
            frozen decode step (``decode_step_paged(fast_kernels=False)``)
            that reads a (d_ff, d_model) view of the down-projection
            leaf, counted by a ``TorchDispatchMode`` on "meta" tensors
            (shapes only, no memory, no card), times the mode's
            projections: the anchor for what a dense step reads, where the
            reference counts the dots of its compiled HLO.

``--serving --check`` turns the report into a gate: modeled / measured within
``--tol`` (default 15%) and counted / measured within ``--tol``; exits 1
on a violation. ``t_mem(H100)`` is the modeled bytes over the H100 SXM's
HBM3 rate (``H100_HBM_BYTES_PER_S``, its datasheet figure).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, datasheet

# the reference's serving geometry and requests
GEOM = dict(n_slots=2, block_size=8, max_blocks_per_seq=6)
PROMPTS = ((1, 9), (2, 5), (3, 13))  # (numpy seed, prompt length)
CALIB_SEED = 7

_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.matmul.default}


def fmt_t(x: float) -> str:
    if x >= 1.0:
        return f"{x:8.2f}s "
    if x >= 1e-3:
        return f"{x * 1e3:8.2f}ms"
    return f"{x * 1e6:8.1f}us"


HBM_GB = 80.0  # H100 80GB


def load(path: str) -> List[Dict]:
    """The JSON records of a ``launch/dryrun.py`` results file."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def table(recs: List[Dict], md: bool = False) -> str:
    """The dry-run table (module note); ``md`` as a markdown table. A
    sparse cell's bytes count kernel 5's own (``launch/op_cost.py``)."""
    hdr = ("cell", "mesh", "sparse", "t_compute", "t_memory", "t_coll",
           "bound", "MF/counted", "peak_GB", "fit", "step_est")
    rows = [hdr]

    def density(r):
        return str(r.get("sparse") or "-")

    for r in recs:
        cell = f"{r['arch']}/{r['shape']}"
        mesh = r.get("mesh", "2x16x16" if r.get("multi_pod") else "16x16")
        if "error" in r:
            rows.append((cell, mesh, density(r),
                         "ERROR", "", "", "", "", "", "", ""))
            continue
        peak = r["peak_bytes_per_chip"] / 1e9
        step = max(r["t_compute"], r["t_memory"], r["t_collective"])
        rows.append((
            cell, mesh, density(r),
            fmt_t(r["t_compute"]), fmt_t(r["t_memory"]),
            fmt_t(r["t_collective"]), r["bottleneck"][:4],
            f"{r.get('useful_flops_ratio', 0):.2f}",
            f"{peak:.1f}", "Y" if peak <= HBM_GB else "OVER", fmt_t(step)))
    widths = [max(len(str(row[i])) for row in rows) for i in range(len(hdr))]
    sep = " | " if md else "  "
    lines = []
    for j, row in enumerate(rows):
        line = sep.join(str(c).ljust(w) for c, w in zip(row, widths))
        lines.append(("| " + line + " |") if md else line)
        if md and j == 0:
            lines.append("|" + "|".join("-" * (w + 2) for w in widths) + "|")
    return "\n".join(lines)


def _itemsize(cfg) -> int:
    return torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                       ).element_size()


def measured_density(engine) -> float:
    """The engine's mean FFN weight-read fraction per (active slot, step);
    1.0 before any decode step."""
    return 1.0 if not engine._dens_n else engine._dens_sum / engine._dens_n


def kernel_bytes_per_step(engine) -> float:
    """Per-device FFN weight bytes one decode step reads through the fused
    kernel path, modeled from the kernel's geometry alone
    (``fused_decode.modeled_weight_bytes``) at the engine's measured
    density: mean gathered tiles a step x projections touching each tile
    x the (tile x d_model) tile footprint x layers, split by the FFN's
    effective TP. Independent of the engine's own accounting: the gate
    compares the two."""
    from repro_torch.kernels import fused_decode as kfd
    from repro_torch.models import common as cm

    cfg = engine.cfg
    n_proj = 3 if cfg.ffn_kind == "glu" else 2
    if engine.predictor is not None:
        tile, n_tiles = engine.predictor.tile, engine.predictor.n_tiles
    else:
        tile = cm.ffn_gather_tile(cfg)
        n_tiles = cfg.d_ff // tile
    per_layer = kfd.modeled_weight_bytes(measured_density(engine) * n_tiles,
                                         tile, cfg.d_model, _itemsize(cfg),
                                         n_proj)
    return cfg.n_layers * per_layer / engine.ffn_tp


class _DownProjBytes(TorchDispatchMode):
    """Adds up the bytes of every matmul operand that is a (d_ff, d_model)
    view of one leaf's storage. Storage, not shape alone: another weight
    (e.g. the attention output projection) can have the same shape."""

    def __init__(self, leaf: torch.Tensor):
        super().__init__()
        self.storage = leaf.untyped_storage()._cdata
        self.shape = tuple(leaf.shape[1:])
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MATMULS:
            for a in args:
                if (isinstance(a, torch.Tensor)
                        and tuple(a.shape) == self.shape
                        and a.untyped_storage()._cdata == self.storage):
                    self.bytes += a.numel() * a.element_size()
        return func(*args, **(kwargs or {}))


def counted_decode_ffn_bytes(engine_or_cfg, n_proj: int = 1) -> float:
    """Down-projection weight bytes one frozen decode step reads: one
    ``decode_step_paged(..., fast_kernels=False)`` of an engine's geometry
    (or, for a config, the reference's: 2 slots, blocks of 8, 6 a
    sequence) on zero inputs, run on "meta" tensors of the engine's
    parameter shapes and dtypes (or the config's, in its compute dtype),
    under ``_DownProjBytes`` over the stacked down-projection leaf.
    ``n_proj`` scales the one counted projection to the serving mode's
    skippable scope."""
    from repro_torch.models import registry
    from repro_torch.tree import tree_map

    if hasattr(engine_or_cfg, "scheduler"):
        eng = engine_or_cfg
        cfg = eng.cfg
        n, nb = eng.scheduler.n_slots, eng.scheduler.max_blocks_per_seq
        bs = eng.block_size
        params = tree_map(lambda t: torch.empty_like(t, device="meta"),
                          eng.params)
    else:
        cfg = engine_or_cfg
        n, nb, bs = (GEOM["n_slots"], GEOM["max_blocks_per_seq"],
                     GEOM["block_size"])
        params = None
    fam = registry.get_family(cfg)
    if params is None:
        params = fam.init_params(cfg, device="meta",
                                 dtype=getattr(torch, cfg.compute_dtype))
    meta = torch.device("meta")
    pages = fam.init_paged_cache(cfg, 1 + n * nb, bs, device=meta)
    zi = torch.zeros((n,), dtype=torch.int32, device=meta)
    masks = torch.zeros((cfg.n_layers, n, cfg.d_ff), dtype=torch.bool,
                        device=meta)
    mode = _DownProjBytes(params["layers"]["ffn"]["wd"])
    with torch.inference_mode(), mode:
        fam.model_decode_paged(
            params, pages, torch.zeros((n, nb), dtype=torch.int32,
                                       device=meta),
            zi, zi, cfg, masks, torch.ones((n,), dtype=torch.bool,
                                           device=meta),
            block_size=bs, fast_kernels=False)
    return float(n_proj * mode.bytes)


def serve_record(mode: str, name: str, eng, counted: float) -> Dict:
    """One mode's record: the three bytes-per-step figures of an engine
    that has served, and the H100 memory-roofline time of the modeled
    bytes."""
    measured = eng.weight_io_bytes_per_step()
    modeled = kernel_bytes_per_step(eng)
    return {"mode": mode, "config": name, "density": measured_density(eng),
            "measured_bytes": measured, "modeled_bytes": modeled,
            "counted_bytes": counted,
            "ratio": modeled / measured if measured else float("inf"),
            "t_memory_h100": modeled / H100_HBM_BYTES_PER_S}


def serving_records(name: str = "tiny-relu", max_new: int = 8, *,
                    params=None, calib_tokens=None, device="cuda"
                    ) -> List[Dict]:
    """Serve the reference's three requests through the tiny engine on the
    kernel path, in autoregressive and predictor modes (a sign predictor
    at tile 1, recall 1.0), at f32; return one record per mode.
    ``params`` (default: the family's seeded init) and ``calib_tokens``
    ((4, 32) token ids, default from numpy seed 7) let a caller serve the
    reference's own weights and calibration batch."""
    from repro_torch.configs import get_config
    from repro_torch.models import common as cm
    from repro_torch.models import registry
    from repro_torch.predictor import calibrate_from_config
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    dev = cm.resolve_device(device)
    cfg = get_config(name).replace(compute_dtype="float32")
    if params is None:
        params = registry.get_family(cfg).init_params(cfg, seed=0,
                                                      device=dev)
    prompts = [np.random.RandomState(s).randint(
                   0, cfg.vocab_size, ln).astype(np.int32)
               for s, ln in PROMPTS]

    def run(cfg_, **kw):
        eng = ContinuousBatchingEngine(
            cfg_, params, EngineConfig(fast_kernels=True, **GEOM, **kw),
            device=dev)
        for p in prompts:
            eng.submit(p, max_new)
        eng.run()
        return eng

    n_proj = 3 if cfg.ffn_kind == "glu" else 2
    dense = counted_decode_ffn_bytes(cfg, n_proj)
    # autoregressive: the kernel path gathers gate/up AND down over the
    # γ-mask tile list; the dense anchor shares its scope only at density
    # 1.0, which these requests (no reuse window) serve at
    recs = [serve_record("ar", name, run(cfg), dense)]
    # predictor: modeled bytes follow the measured tile density exactly
    # (nvalid is tile-granular); the dense anchor scaled by that density
    cfgp = cfg.replace_sparsity(predictor="sign", predictor_recall=1.0)
    if calib_tokens is None:
        calib_tokens = np.random.RandomState(CALIB_SEED).randint(
            0, cfgp.vocab_size, (4, 32))
    calib = {"tokens": torch.as_tensor(np.array(calib_tokens),
                                       dtype=torch.int64, device=dev)}
    pred = calibrate_from_config(params, cfgp, calib, tile=1)
    eng = run(cfgp, predictor=pred)
    recs.append(serve_record("predictor", name, eng,
                             eng.predictor_density() * dense))
    return recs


def serving_table(recs: List[Dict]) -> str:
    hdr = ("mode", "config", "density", "measured", "modeled", "counted",
           "model/meas", "t_mem(H100)")
    rows = [hdr]
    for r in recs:
        rows.append((r["mode"], r["config"], f"{r['density']:.3f}",
                     f"{r['measured_bytes']:.0f}",
                     f"{r['modeled_bytes']:.0f}",
                     f"{r['counted_bytes']:.0f}", f"{r['ratio']:.3f}",
                     fmt_t(r["t_memory_h100"])))
    widths = [max(len(str(row[i])) for row in rows) for i in range(len(hdr))]
    return "\n".join("  ".join(str(c).ljust(w) for c, w in zip(row, widths))
                     for row in rows)


def check_serving(recs: List[Dict], tol: float = 0.15) -> List[str]:
    """The gate: kernel-modeled bytes a step within ``tol`` of the
    engine's measured accounting, and the dense-anchored counted bytes
    within ``tol`` of measured. Returns violation strings (empty = pass);
    the reference's texts, its HLO count named as the count it stands
    for."""
    out = []
    for r in recs:
        if abs(r["ratio"] - 1.0) > tol:
            out.append(f"{r['mode']}: kernel-modeled bytes/step "
                       f"{r['modeled_bytes']:.0f} vs measured "
                       f"{r['measured_bytes']:.0f} (ratio {r['ratio']:.3f} "
                       f"outside 1±{tol})")
        cr = (r["counted_bytes"] / r["measured_bytes"] if r["measured_bytes"]
              else float("inf"))
        if abs(cr - 1.0) > tol:
            out.append(f"{r['mode']}: counted bytes/step "
                       f"{r['counted_bytes']:.0f} vs measured "
                       f"{r['measured_bytes']:.0f} (ratio {cr:.3f} "
                       f"outside 1±{tol})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path", nargs="?", default=None,
                    help="launch/dryrun.py's records: print the dry-run "
                         "table")
    ap.add_argument("--md", action="store_true",
                    help="the dry-run table in markdown")
    ap.add_argument("--serving", action="store_true",
                    help="serving decode bytes-per-step roofline "
                         "(kernel path)")
    ap.add_argument("--check", action="store_true",
                    help="with --serving: exit nonzero unless modeled / "
                         "measured / counted bytes-per-step agree within "
                         "--tol")
    ap.add_argument("--tol", type=float, default=0.15)
    ap.add_argument("--config", default="tiny-relu")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.path is not None:
        print(table(load(args.path), md=args.md))
        return 0
    if not (args.serving or args.check):
        ap.error("a dry-run records path, or --serving [--check]")
    recs = serving_records(args.config, device=args.device)
    print(serving_table(recs))
    if args.check:
        bad = check_serving(recs, args.tol)
        for v in bad:
            print("VIOLATION:", v, file=sys.stderr)
        if bad:
            return 1
        print(f"roofline check OK (tol {args.tol})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
