#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # every phase, one card
    python3 chip_smoke.py --phases kernels  # device, build + a subset

Phases, in order (any failure exits non-zero and prints no result line;
device and build always run):

1. device   the card's name and power limit (nvidia-smi) and CUDA version;
            TF32 off for f32 matmuls and convolutions.
2. build    nvcc builds every kernel of src/repro_torch/csrc (one process
            per source, all at once); prints the build seconds.
3. kernels  each of the ten hand-written kernels against its plain PyTorch
            version on the card, at the path shapes in f32 and bf16 (OPT-6.7B
            layer 0's widths; Mixtral-8x22B layer 0's stacked experts with
            its router's lists for the expert gathers) plus small edge cases
            (GLU, GQA, shifts, nvalid = 0, duplicate pads, tied scores, lists
            in score order, k_valid padding, windows straddling blocks, f32
            blocks against bf16 weights, f32 x against bf16 weights at the
            f32 tolerance); times the kernel per call (CUDA events, median of
            25 runs after warm-up: host time included) and on the card (one
            call captured in a CUDA graph and replayed), the plain version,
            and one PyTorch library call computing the same function (both
            ways), and works out the card's bound. Kernel 2 (bf16: pages
            cut into runs, tensor cores) is also timed at long contexts
            (OPT-6.7B at 1536 to 2048 tokens, Mixtral-8x22B over its 4096
            window at W = 1 and 16), the OPT 16-token chunk and the
            speculative serve's verify window (8 slots x W = 5), against
            SDPA on K and V expanded to the query heads; kernel 3 also at
            that verify window (40 rows, one union list a slot); kernel 1 (bf16:
            the up-projection routine with the activation, GLU and mask
            in its epilogue, then the tile-grouped down gather) also with
            a GLU at OPT-6.7B width, and at T = 128 and 1, and by parts
            (its down half in 1 to 8 runs of tile ids; each half alone);
            kernel 5 (the
            shared-list tile groups) at T = 8 beside T = 128, and on the
            card at 32 and at 64 columns a block; both also
            two calls bit for bit and one under the sync check (below).
            The tile-grouped routine
            of kernels 1, 3 and 10 (bf16 weights) also at 25% window
            lists, one row per list, T = 4096, repeated tiles, all tokens on
            two experts and k_valid drops; the up-projection routine of
            kernels 1, 4, 6, 7, 8 and 9 (bf16) at repeated and padded tiles,
            d = 72, 25% and full lists, one row, T = 4096, all-inactive
            shifts, all tokens on two experts and k_valid drops (f32 also
            with d split over blocks at small T);
            for both, two calls must agree bit for bit and a third runs
            under torch.cuda.set_sync_debug_mode("error"). The unfused
            predictor pair (sparse_up_matmul, sparse_matmul_tokens) is held
            against fused_sparse_ffn on the same lists (f32: bit for bit),
            and the expert chain
            (up, SiLU GLU, gates, down) against the per-expert dense
            product.
4. parity   f32 engine streams of tiny-opt and tiny-relu on the card
            (kernels) equal the CPU streams (plain versions) token for token,
            logprobs within 1e-5: plain mode, and predictor mode with a sign
            predictor at recall 1.0; the fused and unfused predictor FFN
            agree on the card; sampled traffic (seeded top-k and top-p,
            unseeded, greedy) in plain (whole-prompt, chunked) and
            predictor mode; the speculative engine with a 1-layer random
            draft, greedy and sampled, whole-prompt and chunked; on the
            card the spec stream equals the AR stream, and the target as
            its own draft prints its accept rate; the key schedule, random
            bits and uniform on the card bit-equal to the CPU's; tiny-moe
            (drop-free) in whole-prompt and chunked mode.
5. api      the serving front door and observability. tiny-relu at f32 on
            the card in plain, spec and predictor mode: AsyncServingEngine
            streams equal the same engine's offline engine.run() (greedy
            logprobs bit for bit), streams with the obs hub off equal those
            with it on, track_sparsity trackers equal the CPU engine's, and
            every step raises as many synchronizing-op warnings
            (set_sync_debug_mode("warn")) with the hub on as off. Then
            launch.serve_smoke_client --mode plain against a real server
            process on the card. Then OPT-6.7B (32 layers, bf16) behind
            ApiServer in this process, counted: the serve phase's 8
            requests (4 sampled) as 8 concurrent SSE clients plus one that
            disconnects mid-stream; every stream equals an offline
            engine.run() of the same requests on the same engine; client
            TTFT and TPOT, the hub's percentiles, the step phases (admit,
            prefill, dispatch, host_sync, sample) of decode and chunk steps,
            the hub's own time, HTTP against offline tokens/s.
6. serve    each path of the port at full width, bf16, random weights from a
            seed, with the launch counts set to 0 before it and read after it
            (every kernel of the path must launch); each run prints its
            step-phase means (decode and chunk steps apart) and its
            engine's metrics_snapshot(). OPT-6.7B, 32 layers: the
            engine in plain mode (chunked prefill, γ-window reuse) and in
            predictor mode (sign predictor, bf16 probe), 8 requests each,
            then 8 more through each engine under torch.profiler (device
            time by kernel, and the busy share of that run's wall time); the
            unfused predictor FFN on one layer for 8 tokens;
            ops.sparse_ffn_apply at T = 8 and 128, density 0.25; the
            per-token and window score kernels on layer 0. Sampled serving:
            the plain engine with 4 of the 8 requests sampled, twice, the
            second time submitted in a shuffled order (the streams must be
            identical), and the sampling head alone at B = 8 over the
            vocabulary. Speculative serving: OPT-6.7B verifying an OPT-1.3B
            draft (24 layers, full width), γ = 4, greedy and sampled
            (step ms, tokens/s, α, s_agg, weight bytes a step, peak
            memory). Then, OPT-6.7B
            freed, Mixtral-8x22B with 4 of its 56 layers: the engine in
            plain mode with the same geometry and requests (and a profiled
            batch), and the grouped-gather MoE FFN on layer 0 at T = 8 and
            128, timed per call and on the card beside the dispatch
            einsums.

The line before the last is the kernels JSON object; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity
# f32: only the order of the f32 sums differs from the plain version
TOL_F32 = 1e-5
# bf16 inputs, f32 accumulation: products are exact, but bf16 roundings of
# intermediates (h before the down-projection, p before P@V, the output)
# can fall on either side when the f32 sums differ in their last bits
TOL_BF16 = 1e-2
PHASES = ("kernels", "parity", "api", "serve")  # device and build always run


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing and checks


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card (CUDA events per run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


_SIDE_STREAM = []  # device_ms's stream, made at first use


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one fn() call: the call captured once in a
    CUDA graph and replayed reps times between two CUDA events, so the
    host's time between the launches, which a call of a few small kernels
    can spend more of than the card, is left out (the graph's own launch
    gaps stay in). fn must not sync the host. Every call warms up and
    captures on one side stream: torch keeps a cuBLAS workspace for each
    stream a product ran on, which would otherwise add to the peak memory
    of the serve phase."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def timings(fn, plain=None, lib=None) -> dict:
    """The kernel's time per call (time_ms: host included) and on the card
    (device_ms); the plain version's time; the library call's, both ways."""
    out = dict(ms=time_ms(fn), device_ms=device_ms(fn))
    if plain is not None:
        out["plain_ms"] = time_ms(plain)
    if lib is not None:
        out.update(library_ms=time_ms(lib), library_device_ms=device_ms(lib))
    return out


def compare(name: str, got, want, dtype) -> float:
    """Max |got - want| over the outputs; fails beyond the dtype's
    tolerance relative to max |want|."""
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    err, scale = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            fail(f"{name}: non-finite kernel output")
        err = max(err, (g - w).abs().max().item() if g.numel() else 0.0)
        scale = max(scale, w.abs().max().item() if w.numel() else 0.0)
    if err > tol * max(scale, 1e-30):
        fail(f"{name}: max|diff| {err:.3e} > {tol} x max|ref| {scale:.3e}")
    log(f"  ok {name}: max|diff| {err:.3e} (max|ref| {scale:.3e}, tol {tol})")
    return err


def same_bits(name: str, fn) -> None:
    """Two calls of fn give the same bits, and a third one runs under
    torch.cuda.set_sync_debug_mode("error"): a device-to-host sync fails."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name}: two calls differ, max|diff| "
             f"{(a - b).abs().max().item():.3e}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        fail(f"{name}: the call syncs the host ({e})")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"  ok {name}: two calls bit-identical, no host sync")


def bound(n_bytes: float, flops: float, dtype) -> tuple:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels


def fused_ffn_parts(x, wg, wd, idx, nvalid, mask, want) -> dict:
    """fused_sparse_ffn's bf16 route by parts, on the card, through the C
    entry points (not counted as launches): the whole kernel with the down
    half's tile ids in 1, 2, 4 and 8 runs (the wrapper takes
    fused_decode.down_runs), each held against the plain version (want);
    the up half alone (sparse_up_matmul's kernel on the same lists: the
    same routine without the activation and mask, and without that
    wrapper's scatter); the down half alone (expert_down_matmul's bf16
    entry over the one matrix, in the wrapper's runs)."""
    from repro_torch.kernels import fused_decode as kfd
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels import sparse_matmul as ksm

    T, d = x.shape
    F, D, K = wg.shape[1], wd.shape[1], idx.shape[1]
    n_tiles, dev = F // 128, x.device
    bits = torch.empty((-(-n_tiles // 32), T), dtype=torch.int32, device=dev)
    hb = torch.empty((T, K, 128), dtype=torch.bfloat16, device=dev)
    h = torch.empty((T, K, 128), dtype=torch.float32, device=dev)
    y = torch.empty((T, D), dtype=torch.float32, device=dev)
    runs = torch.empty(T, dtype=torch.int64, device=dev)
    P = torch.empty((8 * T, D), dtype=torch.float32, device=dev)
    mk = mask.to(torch.float32)
    fused = rt.entry("fused_sparse_ffn", "fused_sparse_ffn_tc", kfd._TC_ARGS)

    def whole(n):  # relu: ACT_RELU = 0
        return fused(rt.ptr(x), rt.ptr(wg), None, rt.ptr(wd), rt.ptr(mk),
                     rt.ptr(idx), rt.ptr(nvalid), rt.ptr(bits), rt.ptr(hb),
                     rt.ptr(runs), rt.ptr(P), rt.ptr(h), rt.ptr(y), T, d, F, D,
                     K, n, -(-n_tiles // n), 0, 0.0, rt.stream_ptr(dev))

    by_runs = {}
    for n in (1, 2, 4, 8):
        rt.check(whole(n), "fused_sparse_ffn")
        torch.cuda.synchronize()
        compare(f"fused_sparse_ffn OPT-6.7B T=8 MLP+mask bf16, {n} runs",
                [y, h], want, torch.bfloat16)
        by_runs[str(n)] = device_ms(lambda: whole(n))
    up = rt.entry("sparse_up_matmul", "sparse_up_matmul",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    n, R = kfd.down_runs(T, D, n_tiles)
    down = rt.entry("expert_down_matmul", "expert_down_matmul_tc",
                    ksm._TC_ARGS + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    parts = dict(
        device_ms_by_runs=by_runs, runs_picked=n,
        up_half_device_ms=device_ms(lambda: up(
            rt.ptr(x), rt.ptr(wg), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(bits),
            rt.ptr(h), T, d, F, K, 128, 1, rt.stream_ptr(dev))),
        down_half_device_ms=device_ms(lambda: down(
            rt.ptr(hb), rt.ptr(wd), rt.ptr(idx), rt.ptr(nvalid), rt.ptr(runs),
            rt.ptr(P), rt.ptr(y), T, K, 128, D, n, R, 1, F,
            rt.stream_ptr(dev))))
    log("  fused_sparse_ffn OPT-6.7B T=8 MLP+mask bf16 by parts "
        + json.dumps(parts))
    return parts



def kernel_phase(dev) -> dict:
    from repro_torch.kernels import fused_decode as kfd
    from repro_torch.kernels import fused_ffn as kff
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels import sparse_matmul as ksm
    from repro_torch.models.common import paged_gather
    from repro_torch.predictor import predictors as preds

    rng = np.random.RandomState(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    def tile_lists(tile_mask):
        idx, nvalid = preds.pack_tile_indices(t(tile_mask, torch.bool),
                                              tile_mask.shape[1])
        return idx, nvalid

    results = {}

    # -- fused_sparse_ffn ---------------------------------------------------
    def ffn_case(name, T, d, F, tile, dtype, *, glu, masked, activation="relu",
                 shift=0.0, tile_mask=None, unit_p=0.5, lists=None):
        n_tiles = F // tile
        x = t(rng.randn(T, d), dtype)
        wg = t(rng.randn(d, F) / np.sqrt(d), dtype)
        wu = t(rng.randn(d, F) / np.sqrt(d), dtype) if glu else None
        wd = t(rng.randn(F, d) / np.sqrt(F), dtype)
        if tile_mask is None:
            tile_mask = np.ones((T, n_tiles), bool)
        idx, nvalid = (tile_lists(tile_mask) if lists is None else
                       (t(lists[0], torch.int32), t(lists[1], torch.int32)))
        mask = t(rng.rand(T, F) < unit_p, torch.bool) if masked else None
        kw = dict(w_up=wu, unit_mask=mask, activation=activation, shift=shift,
                  tile=tile)
        got = kfd.fused_sparse_ffn(x, wg, wd, idx, nvalid, **kw)
        want = kfd.fused_sparse_ffn_plain(x, wg, wd, idx, nvalid, **kw)
        torch.cuda.synchronize()
        err = compare(f"fused_sparse_ffn {name}", got, want, dtype)
        empty = nvalid == 0
        if got[0][empty].abs().sum().item() or got[1][empty].abs().sum().item():
            fail(f"fused_sparse_ffn {name}: an nvalid == 0 row is not zero")
        return err, (x, wg, wu, wd, idx, nvalid, mask, kw)

    # tiny edge rows: a full list; one tile padded with duplicates of it;
    # nvalid == 0 (exact zeros); one tile at index 0
    edges = np.array([[True, True], [False, True], [False, False],
                      [True, False]])
    for dtype in (torch.float32, torch.bfloat16):
        for act, shift in (("relu", 0.0), ("gelu", 0.0), ("silu", 0.0),
                           ("beta=8", 0.0), ("shifted_relu", 0.25),
                           ("fatrelu:0.1", 0.0)):
            for glu in (False, True):
                for masked in (False, True):
                    ffn_case(f"tiny {act} glu={glu} mask={masked} {dtype}",
                             4, 64, 256, 128, dtype, glu=glu, masked=masked,
                             activation=act, shift=shift, tile_mask=edges)
    # repeated valid tiles, pads repeating the first tile, unsorted lists,
    # nvalid == 0; d = 72 (not a multiple of the routine's 64 rows a stage)
    rep_lists = ([[1, 1, 0, 1], [3, 3, 3, 3], [2, 0, 2, 3], [0, 1, 2, 3]],
                 [4, 1, 3, 0])
    for dtype in (torch.float32, torch.bfloat16):
        for glu in (False, True):
            for masked in (False, True):
                ffn_case(f"repeated tiles d=72 glu={glu} mask={masked} {dtype}",
                         4, 72, 512, 128, dtype, glu=glu, masked=masked,
                         lists=rep_lists)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype], args = ffn_case(f"OPT-6.7B decode T=8 MLP+mask {dtype}",
                                     8, 4096, 16384, 128, dtype, glu=False,
                                     masked=True)
    # bf16 at the other row counts (several row chunks and runs; one row),
    # and the GLU at OPT width, timed below
    for name, T_, p in (("T=128 25% lists", 128, 0.25), ("T=1 one row", 1, 0.97)):
        ffn_case(f"OPT-6.7B {name} MLP+mask bf16", T_, 4096, 16384, 128,
                 torch.bfloat16, glu=False, masked=True,
                 tile_mask=rng.rand(T_, 128) < p)
    err_glu, glu_args = ffn_case("OPT-6.7B decode T=8 GLU+mask bf16", 8, 4096,
                                 16384, 128, torch.bfloat16, glu=True,
                                 masked=True)
    x, wg, wu, wd, idx, nvalid, mask, kw = args  # bf16, the main path's type
    same_bits("fused_sparse_ffn OPT-6.7B T=8 MLP+mask bf16",
              lambda: kfd.fused_sparse_ffn(x, wg, wd, idx, nvalid, **kw)[0])
    T, d, F = 8, 4096, 16384
    nv = nvalid.cpu().numpy()
    n_tiles_distinct = int(preds.covered_tiles(idx, nvalid, F // 128).any(0).sum())
    w_bytes = n_tiles_distinct * 128 * d * 2 * 2  # gate + down tiles, bf16
    io = T * d * 2 + T * F * 4 + idx.numel() * 4 + T * 4 + T * d * 4 + T * 128 * 128 * 4
    flops = float(nv.sum()) * 128 * (2 * d + 2 * d)
    b_ms, b_by = bound(w_bytes + io, flops, torch.bfloat16)
    maskb = mask.to(torch.bfloat16)

    def lib_ffn():  # dense chain at full density, the yardstick
        return (torch.relu(x @ wg) * maskb) @ wd

    results["fused_sparse_ffn"] = dict(
        name="fused_sparse_ffn", route="cuda",
        source="src/repro_torch/csrc/fused_sparse_ffn.cu",
        replaces="src/repro/kernels/fused_decode.py:98",
        max_abs_err=errs[torch.bfloat16],
        **timings(lambda: kfd.fused_sparse_ffn(x, wg, wd, idx, nvalid, **kw),
                  lambda: kfd.fused_sparse_ffn_plain(x, wg, wd, idx, nvalid,
                                                     **kw), lib_ffn),
        bound_ms=b_ms, bound_by=b_by,
        shape="T=8 d=4096 F=16384 tile=128 K=128 MLP+mask bf16",
        max_abs_err_f32=errs[torch.float32])
    results["fused_sparse_ffn"].update(fused_ffn_parts(
        x, wg, wd, idx, nvalid, mask,
        want=kfd.fused_sparse_ffn_plain(x, wg, wd, idx, nvalid, **kw)))
    # the GLU at OPT width: gate, up and down tiles
    gx, gwg, gwu, gwd, gidx, gnv, gmask, gkw = glu_args
    g_ms, g_by = bound(w_bytes * 3 // 2 + io, flops * 3 / 2, torch.bfloat16)
    results["fused_sparse_ffn"]["at T=8 GLU+mask"] = dict(
        max_abs_err=err_glu, bound_ms=g_ms, bound_by=g_by,
        **timings(lambda: kfd.fused_sparse_ffn(gx, gwg, gwd, gidx, gnv, **gkw),
                  lib=lambda: (torch.relu(gx @ gwg) * (gx @ gwu)
                               * gmask.to(torch.bfloat16)) @ gwd))
    log("  fused_sparse_ffn OPT-6.7B T=8 GLU+mask bf16 " + json.dumps(
        results["fused_sparse_ffn"]["at T=8 GLU+mask"]))
    del glu_args, gx, gwg, gwu, gwd, gidx, gnv, gmask, gkw

    # -- paged_window_attention ---------------------------------------------
    def attn_case(name, b, W, kvp, g, hd, bs, nb, n_blocks, dtype, window=0,
                  min_end=None):
        q = t(rng.randn(b, W, kvp, g, hd), dtype)
        kp = t(rng.randn(n_blocks, kvp, bs, hd), dtype)
        vp = t(rng.randn(n_blocks, kvp, bs, hd), dtype)
        # each slot owns distinct blocks; past its length the table pads
        # with the scratch block 0, as the engine's tables do
        perm = rng.permutation(np.arange(1, n_blocks))[: b * nb].reshape(b, nb)
        end = rng.randint(min_end or W, nb * bs + 1, size=b)  # tokens written
        table = np.where(np.arange(nb)[None, :] * bs < end[:, None], perm, 0)
        pos = end[:, None] - W + np.arange(W)[None, :]
        table, pos = t(table, torch.int32), t(pos, torch.int32)
        got = kpa.paged_window_attention(q, kp, vp, table, pos, window=window)
        want = kpa.paged_window_attention_plain(q, kp, vp, table, pos,
                                                window=window)
        torch.cuda.synchronize()
        return compare(f"paged_window_attention {name}", [got], [want],
                       dtype), (q, kp, vp, table, pos, end)

    for dtype in (torch.float32, torch.bfloat16):
        attn_case(f"tiny GQA W=5 window=5 {dtype}", 3, 5, 2, 8, 16, 8, 4, 16,
                  dtype, window=5)
        attn_case(f"tiny GQA W=1 {dtype}", 3, 1, 2, 8, 16, 8, 4, 16, dtype)
        attn_case(f"OPT-6.7B chunk W=16 {dtype}", 8, 16, 32, 1, 128, 16, 16,
                  129, dtype)
        # Mixtral-8x22B's geometry on the MoE serve path: 8 kv heads x 6
        # query heads, R = 96 rows per block at W = 16 (bf16: six m16 tiles,
        # one a consumer warp, the pages cut into runs); then its 4096-token
        # sliding window over 4352 to 5120 cached tokens, so the window
        # masks and skips leading blocks
        for W in (16, 1):
            attn_case(f"Mixtral-8x22B W={W} {dtype}", 8, W, 8, 6, 128, 16, 16,
                      129, dtype, window=4096)
            attn_case(f"Mixtral-8x22B W={W} window=4096 masking {dtype}", 8,
                      W, 8, 6, 128, 16, 320, 8 * 320 + 1, dtype, window=4096,
                      min_end=4352)
        # a 5-token verify window (R = 30: two m16 tiles, bf16 splits the
        # keys two ways) and R = 192 (bf16: two row groups of six tiles)
        attn_case(f"Mixtral-8x22B W=5 {dtype}", 8, 5, 8, 6, 128, 16, 16, 129,
                  dtype, window=4096)
        attn_case(f"GQA W=32 g=6 window=100 {dtype}", 2, 32, 2, 6, 128, 16, 20,
                  50, dtype, window=100)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype], args = attn_case(f"OPT-6.7B decode W=1 {dtype}", 8, 1, 32,
                                      1, 128, 16, 16, 129, dtype)
    # bf16 rows timed beside the decode row: long contexts (OPT-6.7B at
    # 1536 to 2048 tokens, 269 MB of K and V in the pool; Mixtral-8x22B
    # over its 4096 window) and the two 16-token prefill chunks
    attn_timed = {"OPT-6.7B decode W=1": (args, 0)}
    for name, shape, window, min_end in (
            ("OPT-6.7B decode W=1 at 1536-2048 tokens",
             (8, 1, 32, 1, 128, 16, 128, 1025), 0, 1536),
            ("Mixtral-8x22B decode W=1 window=4096 at 4352-5120 tokens",
             (8, 1, 8, 6, 128, 16, 320, 8 * 320 + 1), 4096, 4352),
            ("Mixtral-8x22B W=16 window=4096 at 4352-5120 tokens",
             (8, 16, 8, 6, 128, 16, 320, 8 * 320 + 1), 4096, 4352),
            ("OPT-6.7B chunk W=16", (8, 16, 32, 1, 128, 16, 16, 129), 0,
             None),
            # the speculative serve's verify window: 8 slots x γ+1 = 5
            # rows over up to 256 cached tokens
            ("OPT-6.7B verify W=5", (8, 5, 32, 1, 128, 16, 16, 129), 0,
             None),
            # its OPT-1.3B draft (32 heads x 64): each W = 1 draft step
            # and each 16-token prefill chunk the draft writes
            ("OPT-1.3B draft W=1", (8, 1, 32, 1, 64, 16, 16, 129), 0, None),
            ("OPT-1.3B draft chunk W=16", (8, 16, 32, 1, 64, 16, 16, 129), 0,
             None)):
        err, a_ = attn_case(f"{name} {torch.bfloat16}", *shape, torch.bfloat16,
                            window=window, min_end=min_end)
        attn_timed[name] = (a_, window)
        errs[name] = err
    for name in ("OPT-6.7B decode W=1",
                 "Mixtral-8x22B decode W=1 window=4096 at 4352-5120 tokens",
                 "Mixtral-8x22B W=16 window=4096 at 4352-5120 tokens"):
        (q, kp, vp, table, pos, _), window = attn_timed[name]
        same_bits(f"paged_window_attention {name}",
                  lambda: kpa.paged_window_attention(q, kp, vp, table, pos,
                                                     window=window))

    def attn_row(q, kp, vp, table, pos, end, window):
        """bound (bytes: each needed page of K and V once, q, the output,
        table and pos; operations: 4 hd per valid (row, key)), and the
        kernel's, the plain version's and SDPA's times (SDPA over the
        gathered cache, K and V expanded to the query heads before
        timing, a boolean mask)"""
        b, W, kvp, g, hd = q.shape
        bs, nb = kp.shape[2], table.shape[1]
        pos_np = pos.cpu().numpy()
        pages, valid = 0, 0
        for t_ in range(b):
            lo, hi = kpa.needed_pages(pos_np[t_].tolist(), window, bs, nb)
            pages += max(0, hi - lo + 1)
            for p in pos_np[t_]:
                valid += max(0, min(p + 1, window) if window else p + 1)
        n_bytes = (pages * kvp * bs * hd * 2 * 2 + q.numel() * 2 * 2
                   + table.numel() * 4 + pos.numel() * 4)
        b_ms, b_by = bound(n_bytes, 4.0 * valid * g * kvp * hd,
                           torch.bfloat16)
        kg = paged_gather(kp, table).repeat_interleave(g, dim=1)
        vg = paged_gather(vp, table).repeat_interleave(g, dim=1)
        keys = torch.arange(kg.shape[2], device=dev)[None, None, :]
        am = keys <= pos[:, :, None]
        if window:
            am &= keys > pos[:, :, None] - window
        am = am[:, None]                                     # (b, 1, W, S)
        qh = q.permute(0, 2, 3, 1, 4).reshape(b, kvp * g, W, hd)

        def lib_attn():  # SDPA over the gathered cache, the yardstick
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kg, vg, attn_mask=am)

        return dict(**timings(
            lambda: kpa.paged_window_attention(q, kp, vp, table, pos,
                                               window=window),
            lambda: kpa.paged_window_attention_plain(q, kp, vp, table, pos,
                                                     window=window),
            lib_attn), bound_ms=b_ms, bound_by=b_by,
            splits=kpa.attention_splits(b, kvp, nb, W * g, hd, bs,
                                        kpa._sm_count(dev)))

    attn_at = {}
    for name, (a_, window) in attn_timed.items():
        attn_at[name] = dict(max_abs_err=errs.get(name, errs[torch.bfloat16]),
                             **attn_row(*a_, window))
    del attn_timed
    results["paged_window_attention"] = dict(
        name="paged_window_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:87",
        **attn_at.pop("OPT-6.7B decode W=1"),
        shape="b=8 W=1 kvp=32 g=1 hd=128 bs=16 nb=16 bf16",
        max_abs_err_f32=errs[torch.float32],
        **{f"at {k}": v for k, v in attn_at.items()})

    # -- sparse_matmul_tokens -----------------------------------------------
    def smm_case(name, T, F, D, tile, dtype, tile_mask, rows_per_list=1):
        x = t(rng.randn(T, F) * (rng.rand(T, F) < 0.5), dtype)
        w = t(rng.randn(F, D) / np.sqrt(F), dtype)
        idx, nvalid = tile_lists(tile_mask)
        idx = idx.repeat_interleave(rows_per_list, 0).contiguous()
        nvalid = nvalid.repeat_interleave(rows_per_list).contiguous()
        got = ksm.sparse_matmul_tokens(x, w, idx, nvalid, tile=tile)
        want = ksm.sparse_matmul_tokens_plain(x, w, idx, nvalid, tile=tile)
        torch.cuda.synchronize()
        if got[nvalid == 0].abs().sum().item():
            fail(f"sparse_matmul_tokens {name}: an nvalid == 0 row is not zero")
        return compare(f"sparse_matmul_tokens {name}", [got], [want],
                       dtype), (x, w, idx, nvalid)

    for dtype in (torch.float32, torch.bfloat16):
        smm_case(f"tiny edges {dtype}", 4, 256, 64, 128, dtype, edges)
        # 16 row groups x 64 column groups fill the grid: the whole list is
        # one run, written to y with no run scratch
        smm_case(f"one run T=256 D=4096 {dtype}", 256, 512, 4096, 128, dtype,
                 rng.rand(256, 4) < 0.6)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype], args = smm_case(
            f"OPT-6.7B chunk 8x16 rows {dtype}", 128, 16384, 4096, 128, dtype,
            rng.rand(8, 128) < 0.97, rows_per_list=16)
    main_args = args
    # the tile-grouped routine (bf16 weights): windows whose 25% lists
    # differ; one row per list at T = 8; 16 slots x 256-token chunks;
    # repeated tiles, pads repeating the first tile and unsorted lists
    extra = {}
    for name, T_, n_lists, p, F_, D_ in (
            ("T=128 8x16 rows 25% lists", 128, 8, 0.25, 16384, 4096),
            ("T=8 one row per list", 8, 8, 0.97, 16384, 4096),
            # the speculative serve: OPT-6.7B's verify window (8 slots x 5
            # rows, one union list a slot) and a step of the OPT-1.3B draft
            ("T=40 verify 8x5 rows", 40, 8, 0.97, 16384, 4096),
            ("OPT-1.3B draft T=8 one row per list", 8, 8, 0.97, 8192, 2048),
            ("T=4096 16x256 rows", 4096, 16, 0.97, 16384, 4096)):
        model = "" if name.startswith("OPT") else "OPT-6.7B "
        err, args = smm_case(f"{model}{name} {torch.bfloat16}", T_, F_, D_,
                             128, torch.bfloat16,
                             rng.rand(n_lists, F_ // 128) < p,
                             rows_per_list=T_ // n_lists)
        extra[name] = (err, args)
    # an f32 x is multiplied unrounded whatever the weights' type (three
    # bf16 terms against bf16 weights), so it is held at the f32 tolerance
    rep_idx = [[1, 1, 0, 1], [3, 3, 3, 3], [2, 0, 2, 3], [0, 1, 2, 3]]
    for dtype in (torch.float32, torch.bfloat16):
        for xd in {torch.float32, dtype}:
            xr = t(rng.randn(4, 512), xd)
            wr = t(rng.randn(512, 64) / 16.0, dtype)
            ir, nr = t(rep_idx, torch.int32), t([4, 1, 3, 0], torch.int32)
            compare(f"sparse_matmul_tokens repeated tiles (x {xd}, w {dtype})",
                    [ksm.sparse_matmul_tokens(xr, wr, ir, nr)],
                    [ksm.sparse_matmul_tokens_plain(xr, wr, ir, nr)], xd)
    x, w, idx, nvalid = main_args
    xf = x.float()
    compare("sparse_matmul_tokens OPT-6.7B chunk 8x16 rows (x f32, w bf16)",
            [ksm.sparse_matmul_tokens(xf, w, idx, nvalid)],
            [ksm.sparse_matmul_tokens_plain(xf, w, idx, nvalid)], torch.float32)
    same_bits("sparse_matmul_tokens T=128", lambda: ksm.sparse_matmul_tokens(
        x, w, idx, nvalid))
    nv = nvalid.cpu().numpy()
    distinct = int(preds.covered_tiles(idx, nvalid, 128).any(0).sum())
    n_bytes = (x.numel() * 2 + distinct * 128 * 4096 * 2 + idx.numel() * 4
               + nv.size * 4 + 128 * 4096 * 4)
    flops = float(nv.sum()) * 128 * 4096 * 2
    b_ms, b_by = bound(n_bytes, flops, torch.bfloat16)
    at = {}
    for name, (err, (xa, wa, ia, na)) in extra.items():
        na_np = na.cpu().numpy()
        Fa, Da = wa.shape
        da = int(preds.covered_tiles(ia, na, Fa // 128).any(0).sum())
        ba = bound(xa.numel() * 2 + da * 128 * Da * 2 + ia.numel() * 4
                   + na_np.size * 4 + xa.shape[0] * Da * 4,
                   float(na_np.sum()) * 128 * Da * 2, torch.bfloat16)
        plain = None
        if "verify" in name or "draft" in name:
            plain = lambda: ksm.sparse_matmul_tokens_plain(  # noqa: E731
                xa, wa, ia, na)
        at[name] = dict(max_abs_err=err, **timings(
            lambda: ksm.sparse_matmul_tokens(xa, wa, ia, na), plain,
            lib=lambda: xa @ wa), bound_ms=ba[0], bound_by=ba[1])
    del extra
    results["sparse_matmul_tokens"] = dict(
        name="sparse_matmul_tokens", route="cuda",
        source="src/repro_torch/csrc/sparse_matmul_tokens.cu",
        replaces="src/repro/kernels/sparse_matmul.py:125",
        max_abs_err=errs[torch.bfloat16],
        **timings(lambda: ksm.sparse_matmul_tokens(x, w, idx, nvalid),
                  lambda: ksm.sparse_matmul_tokens_plain(x, w, idx, nvalid),
                  lambda: x @ w),
        bound_ms=b_ms, bound_by=b_by,
        shape="T=128 (8 slots x 16) F=16384 D=4096 tile=128 K=128 bf16",
        max_abs_err_f32=errs[torch.float32],
        **{f"at {k}": v for k, v in at.items()})
    # -- sparse_up_matmul ---------------------------------------------------
    def up_case(name, T, d, F, tile, dtype, tile_mask=None, lists=None):
        x = t(rng.randn(T, d), dtype)
        w = t(rng.randn(d, F) / np.sqrt(d), dtype)
        idx, nvalid = (tile_lists(tile_mask) if lists is None else
                       (t(lists[0], torch.int32), t(lists[1], torch.int32)))
        got = ksm.sparse_up_matmul(x, w, idx, nvalid, tile=tile)
        want = ksm.sparse_up_matmul_plain(x, w, idx, nvalid, tile=tile)
        torch.cuda.synchronize()
        cov = preds.tiles_to_units(preds.covered_tiles(idx, nvalid, F // tile),
                                   tile)
        if got[~cov].abs().sum().item():
            fail(f"sparse_up_matmul {name}: an unlisted tile is not zero")
        return compare(f"sparse_up_matmul {name}", [got], [want],
                       dtype), (x, w, idx, nvalid)

    def up_bound(x, w, idx, nvalid):
        """bytes: x, the listed tiles of w once, the lists, and the (T, F)
        f32 result written once; the listed slots' operations"""
        T_, d_ = x.shape
        nv_ = nvalid.cpu().numpy()
        distinct_ = int(preds.covered_tiles(idx, nvalid, 128).any(0).sum())
        return bound(x.numel() * 2 + distinct_ * 128 * d_ * 2 + idx.numel() * 4
                     + nv_.size * 4 + T_ * w.shape[1] * 4,
                     float(nv_.sum()) * 128 * d_ * 2, torch.bfloat16)

    # repeated valid tiles, pads repeating the first tile, unsorted lists,
    # nvalid == 0 (rep_lists; bf16 at tile 128: the tensor-core routine;
    # bf16 at tile 64 and f32: ffn_up)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        up_case(f"tiny edges {dtype}", 4, 64, 256, 128, dtype, edges)
        up_case(f"repeated tiles {dtype}", 4, 64, 512, 128, dtype,
                lists=rep_lists)
        up_case(f"OPT-6.7B T=8 25% lists {dtype}", 8, 4096, 16384, 128, dtype,
                rng.rand(8, 128) < 0.25)
        errs[dtype], args = up_case(f"OPT-6.7B T=8 full lists {dtype}", 8,
                                    4096, 16384, 128, dtype,
                                    np.ones((8, 128), bool))
    up_case("tile 64 repeated tiles bf16", 4, 64, 512, 64, torch.bfloat16,
            lists=rep_lists)
    up_extra = {}
    for name, T_, p in (("T=8 25% lists", 8, 0.25),
                        ("T=1 one row", 1, 0.97),
                        ("T=128 25% lists", 128, 0.25),
                        ("T=4096 97% lists", 4096, 0.97)):
        up_extra[name] = up_case(f"OPT-6.7B {name} {torch.bfloat16}", T_, 4096,
                                 16384, 128, torch.bfloat16,
                                 rng.rand(T_, 128) < p)
    x, w, idx, nvalid = args
    same_bits("sparse_up_matmul T=8 full lists",
              lambda: ksm.sparse_up_matmul(x, w, idx, nvalid))
    b_ms, b_by = up_bound(x, w, idx, nvalid)
    up_at = {}
    for name, (err, (xa, wa, ia, na)) in up_extra.items():
        ba = up_bound(xa, wa, ia, na)
        up_at[name] = dict(max_abs_err=err, **timings(
            lambda: ksm.sparse_up_matmul(xa, wa, ia, na), lib=lambda: xa @ wa),
            bound_ms=ba[0], bound_by=ba[1])
    del up_extra
    results["sparse_up_matmul"] = dict(
        name="sparse_up_matmul", route="cuda",
        source="src/repro_torch/csrc/sparse_up_matmul.cu",
        replaces="src/repro/kernels/sparse_matmul.py:177",
        max_abs_err=errs[torch.bfloat16],
        **timings(lambda: ksm.sparse_up_matmul(x, w, idx, nvalid),
                  lambda: ksm.sparse_up_matmul_plain(x, w, idx, nvalid),
                  lambda: x @ w),
        bound_ms=b_ms, bound_by=b_by,
        shape="T=8 d=4096 F=16384 tile=128 K=128 full lists bf16",
        max_abs_err_f32=errs[torch.float32],
        **{f"at {k}": v for k, v in up_at.items()})

    # the unfused pair (sparse_up_matmul, then sparse_matmul_tokens) against
    # fused_sparse_ffn on the same lists: in f32 the same up-dots and the
    # same gather, so bit-equality (checked); in bf16 the pair and the fused
    # kernel run the same two tensor-core routines (up_tiles.cuh,
    # tile_group.cuh), the fused kernel's down half over runs of tile ids
    # summed by run_sum: TOL_BF16, the difference logged
    for dtype in (torch.float32, torch.bfloat16):
        xx = t(rng.randn(8, 4096), dtype)
        wg = t(rng.randn(4096, 16384) / 64.0, dtype)
        wd = t(rng.randn(16384, 4096) / 128.0, dtype)
        for frac in (1.0, 0.25):
            li, ln = tile_lists(rng.rand(8, 128) < frac)
            yf, comp = kfd.fused_sparse_ffn(xx, wg, wd, li, ln, tile=128)
            hf = kfd.scatter_compact(comp, li, ln, 128)
            cov = preds.tiles_to_units(preds.covered_tiles(li, ln, 128), 128)
            hu = torch.relu(ksm.sparse_up_matmul(xx, wg, li, ln)) * cov.float()
            yu = ksm.sparse_matmul_tokens(hu.to(dtype), wd, li, ln)
            torch.cuda.synchronize()
            dh = (hf - hu).abs().max().item()
            dy = (yf - yu).abs().max().item()
            compare(f"unfused vs fused FFN, {frac:.0%} lists {dtype}",
                    [hu, yu], [hf, yf], dtype)
            log(f"  unfused vs fused {frac:.0%} {dtype}: bit-equal "
                f"{dh == 0 and dy == 0} (max|dh| {dh:.3e}, max|dy| {dy:.3e})")
            if dtype == torch.float32 and (dh or dy):
                fail(f"unfused vs fused FFN, {frac:.0%} lists f32: not bit-equal")
            results["sparse_up_matmul"].setdefault("fused_unfused_max_diff", {})[
                f"{frac:.2f} {dtype}"] = max(dh, dy)

    # -- fused_up_relu ------------------------------------------------------
    def relu_case(name, T, d, F, dtype, shift):
        x = t(rng.randn(T, d), dtype)
        wu = t(rng.randn(d, F) / np.sqrt(d), dtype)
        got = kff.fused_up_relu(x, wu, shift)
        want = kff.fused_up_relu_plain(x, wu, shift)
        torch.cuda.synchronize()
        if shift > 50 and (got[0].abs().sum().item() or got[1].abs().sum().item()):
            fail(f"fused_up_relu {name}: an all-inactive case is not zero")
        return compare(f"fused_up_relu {name}", got, want, dtype), (x, wu)

    # bf16 runs the tensor-core routine, every block over all of d; f32 runs
    # the CUDA-core kernel, which splits d over blocks at small T (T = 8 and
    # 40 here) and sums the ranges in a second launch
    shapes = {}
    for dtype in (torch.float32, torch.bfloat16):
        relu_case(f"tiny {dtype}", 4, 64, 256, dtype, 0.0)
        relu_case(f"tiny shift=0.25 {dtype}", 5, 64, 384, dtype, 0.25)
        relu_case(f"tiny all-zero (tied scores) {dtype}", 3, 64, 256, dtype,
                  100.0)
        relu_case(f"T=40 shift=0.1 {dtype}", 40, 4096, 1024, dtype, 0.1)
        for T in (8, 128):
            shapes[T, dtype] = relu_case(f"OPT-6.7B T={T} {dtype}", T, 4096,
                                         16384, dtype, 0.0)
    for T in (8, 128):
        relu_case(f"OPT-6.7B T={T} all-zero shift=100 bf16", T, 4096, 16384,
                  torch.bfloat16, 100.0)
    shapes[4096, torch.bfloat16] = relu_case("OPT-6.7B T=4096 bf16", 4096,
                                             4096, 16384, torch.bfloat16, 0.0)
    relu_times = {}
    for T in (8, 128, 4096):
        err, (x, wu) = shapes[T, torch.bfloat16]
        same_bits(f"fused_up_relu T={T}", lambda: torch.cat(
            [v.reshape(-1) for v in kff.fused_up_relu(x, wu)]))
        n_bytes = x.numel() * 2 + wu.numel() * 2 + T * 16384 * 4 + 128 * 4
        b_ms, b_by = bound(n_bytes, 2.0 * T * 4096 * 16384, torch.bfloat16)
        relu_times[T] = dict(
            max_abs_err=err,
            **timings(lambda: kff.fused_up_relu(x, wu),
                      lambda: kff.fused_up_relu_plain(x, wu),
                      lambda: torch.relu(x @ wu - 0.0)),
            bound_ms=b_ms, bound_by=b_by)
    del shapes[4096, torch.bfloat16]
    results["fused_up_relu"] = dict(
        name="fused_up_relu", route="cuda",
        source="src/repro_torch/csrc/fused_up_relu.cu",
        replaces="src/repro/kernels/fused_ffn.py:81",
        **relu_times[128], shape="T=128 d=4096 F=16384 bf16",
        max_abs_err_f32=shapes[128, torch.float32][0],
        at_T8=relu_times[8], at_T4096=relu_times[4096])

    # -- sparse_matmul (one list in score order) ----------------------------
    def shared_case(name, T, F, D, dtype, idx, nvalid):
        x = t(rng.randn(T, F) * (rng.rand(T, F) < 0.5), dtype)
        w = t(rng.randn(F, D) / np.sqrt(F), dtype)
        idx, nvalid = t(idx, torch.int32), t(nvalid, torch.int32).reshape(())
        got = ksm.sparse_matmul(x, w, idx, nvalid)
        want = ksm.sparse_matmul_plain(x, w, idx, nvalid)
        torch.cuda.synchronize()
        if int(nvalid) == 0 and got.abs().sum().item():
            fail(f"sparse_matmul {name}: nvalid == 0 is not zero")
        return compare(f"sparse_matmul {name}", [got], [want],
                       dtype), (x, w, idx, nvalid)

    order = rng.permutation(128)  # a score order: not ascending
    for dtype in (torch.float32, torch.bfloat16):
        shared_case(f"tiny [1, 0] {dtype}", 4, 256, 64, dtype, [1, 0], 2)
        shared_case(f"tiny nvalid=0 {dtype}", 4, 256, 64, dtype, [1, 0], 0)
        shared_case(f"tiny duplicate pads {dtype}", 4, 256, 64, dtype,
                    [1, 1, 1], 1)
        # a tile listed twice counts twice; T = 100 ends in a part chunk
        shared_case(f"repeated valid tiles T=100 {dtype}", 100, 768, 64, dtype,
                    [3, 1, 3, 0, 3, 5], 5)
        shared_case(f"OPT-6.7B T=128 K=32 nvalid=20 {dtype}", 128, 16384,
                    4096, dtype, order[:32], 20)
        shared_case(f"OPT-6.7B T=1 K=32 score order {dtype}", 1, 16384, 4096,
                    dtype, order[:32], 32)
        errs[dtype], args = shared_case(
            f"OPT-6.7B T=128 K=32 score order {dtype}", 128, 16384, 4096,
            dtype, order[:32], 32)
    _, args8 = shared_case(f"OPT-6.7B T=8 K=32 score order {torch.bfloat16}",
                           8, 16384, 4096, torch.bfloat16, order[:32], 32)
    x, w, idx, nvalid = args
    # an f32 x against bf16 weights is multiplied unrounded: f32 tolerance
    for name, xf, wb, ib, nb in (
            ("tiny duplicate pads", t(rng.randn(4, 256)),
             t(rng.randn(256, 64) / 16.0, torch.bfloat16),
             t([1, 1, 1], torch.int32), t(1, torch.int32)),
            ("repeated valid tiles T=100", t(rng.randn(100, 768)),
             t(rng.randn(768, 64) / 16.0, torch.bfloat16),
             t([3, 1, 3, 0, 3, 5], torch.int32), t(5, torch.int32)),
            ("OPT-6.7B T=128 K=32 score order", x.float(), w, idx, nvalid)):
        compare(f"sparse_matmul {name} (x f32, w bf16)",
                [ksm.sparse_matmul(xf, wb, ib, nb)],
                [ksm.sparse_matmul_plain(xf, wb, ib, nb)], torch.float32)
    def shared_list(xa, wa, ia, na, columns):
        """sparse_matmul's bf16 entry point with ``columns`` a block (the
        wrapper takes shared_list_columns(T)); not counted as a launch"""
        y = torch.empty((xa.shape[0], wa.shape[1]), dtype=torch.float32,
                        device=dev)
        fn = rt.entry("sparse_matmul", "sparse_matmul_tc",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        rt.check(fn(rt.ptr(xa), rt.ptr(wa), rt.ptr(ia), rt.ptr(na), rt.ptr(y),
                    xa.shape[0], xa.shape[1], wa.shape[1], ia.shape[0], 128,
                    columns, rt.DTYPE_CODES[xa.dtype], rt.stream_ptr(dev)),
                 "sparse_matmul")
        return y

    sm_rows = {}
    for T_, (xa, wa, ia, na) in ((128, args), (8, args8)):
        same_bits(f"sparse_matmul T={T_}",
                  lambda: ksm.sparse_matmul(xa, wa, ia, na))
        # both block widths, checked and timed on the card: the wrapper's
        # choice by T is the faster one where chip_smoke times it
        by_columns = {}
        for columns in (32, 64):
            compare(f"sparse_matmul T={T_} at {columns} columns a block",
                    [shared_list(xa, wa, ia, na, columns)],
                    [ksm.sparse_matmul_plain(xa, wa, ia, na)], torch.bfloat16)
            by_columns[columns] = device_ms(
                lambda: shared_list(xa, wa, ia, na, columns))
        nv = int(na)
        n_bytes = (T_ * nv * 128 * 2 + nv * 128 * 4096 * 2 + ia.numel() * 4
                   + 4 + T_ * 4096 * 4)
        b_ms, b_by = bound(n_bytes, 2.0 * T_ * nv * 128 * 4096, torch.bfloat16)
        sm_rows[T_] = dict(
            **timings(lambda: ksm.sparse_matmul(xa, wa, ia, na),
                      lambda: ksm.sparse_matmul_plain(xa, wa, ia, na),
                      lambda: xa @ wa),
            bound_ms=b_ms, bound_by=b_by,
            columns_per_block=ksm.shared_list_columns(T_),
            device_ms_by_columns=by_columns)
    results["sparse_matmul"] = dict(
        name="sparse_matmul", route="cuda",
        source="src/repro_torch/csrc/sparse_matmul.cu",
        replaces="src/repro/kernels/sparse_matmul.py:79",
        max_abs_err=errs[torch.bfloat16],
        **sm_rows[128],
        shape="T=128 F=16384 D=4096 K=32 (density 0.25) score order bf16",
        max_abs_err_f32=errs[torch.float32], at_T8=sm_rows[8])

    # select_tiles_static on the card: tied scores keep ascending order
    sc = np.zeros(128, np.float32)
    sc[[5, 9, 77]] = [2.0, 3.0, 2.0]
    got_i, got_n = kops.select_tiles_static(t(sc), 0.25)
    want_i, want_n = kops.select_tiles_static(torch.as_tensor(sc), 0.25)
    if (got_i.cpu().tolist() != want_i.tolist()
            or int(got_n) != int(want_n)):
        fail(f"select_tiles_static on the card {got_i.tolist()} / "
             f"{int(got_n)} != CPU {want_i.tolist()} / {int(want_n)}")
    log(f"  ok select_tiles_static tied scores: {got_i.cpu().tolist()[:6]}..."
        f" nvalid {int(got_n)}")

    results.update(score_kernel_rows(dev, rng))
    results.update(expert_kernel_rows(dev, rng))
    for r in results.values():
        log("  kernel " + json.dumps(r))
    return results


def score_kernel_rows(dev, rng, d: int = 4096, F: int = 16384) -> dict:
    """fused_up_relu_tokens and fused_up_relu_window against their plain
    versions: small edge cases (shifts, W = 1, windows whose rows straddle
    row blocks and d ranges, an all-inactive shift) and OPT-6.7B layer 0's
    wu shape (d = 4096, F = 16384) at T = 8 and 128 tokens, windows of W = 4
    and 16 over 8 slots; two calls bit-identical and no host sync. Returns
    their two rows of the kernels line (bf16 at T = 128 / W = 16; the
    smaller shape beside it)."""
    from repro_torch.kernels import fused_ffn as kff

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    kinds = {"fused_up_relu_tokens": (kff.fused_up_relu_tokens,
                                      kff.fused_up_relu_tokens_plain),
             "fused_up_relu_window": (kff.fused_up_relu_window,
                                      kff.fused_up_relu_window_plain)}

    def case(kind, name, shape, F, dtype, shift=0.0, wu=None):
        fn, plain = kinds[kind]
        x = t(rng.randn(*shape), dtype)
        if wu is None:
            wu = t(rng.randn(shape[-1], F) / np.sqrt(shape[-1]), dtype)
        got, want = fn(x, wu, shift), plain(x, wu, shift)
        torch.cuda.synchronize()
        return compare(f"{kind} {name}", got, want, dtype), (x, wu)

    big = {}
    for dtype in (torch.float32, torch.bfloat16):
        case("fused_up_relu_tokens", f"tiny shift=0.25 {dtype}", (5, 64), 384,
             dtype, 0.25)
        # at d = 4096 the f32 kernel cuts d into ranges, summed and folded by
        # its finishing launch; bf16 blocks cover all of d
        case("fused_up_relu_tokens", f"T=40 d=4096 {dtype}", (40, 4096), 1024,
             dtype, 0.1)
        case("fused_up_relu_window", f"tiny W=1 {dtype}", (4, 1, 64), 256,
             dtype)
        # 7-row windows straddle the 64-row blocks (in-block fold) and, at
        # d = 4096 in f32, the d ranges
        case("fused_up_relu_window", f"B=3 W=7 shift=0.25 {dtype}", (3, 7, 64),
             256, dtype, 0.25)
        case("fused_up_relu_window", f"B=5 W=7 d=4096 {dtype}", (5, 7, 4096),
             1024, dtype)
        for kind, shape in (("fused_up_relu_tokens", (8, d)),
                            ("fused_up_relu_window", (8, 4, d))):
            _, (xz, wz) = case(kind, f"all-zero shift=100 {dtype}", shape, F,
                               dtype, 100.0)
            out = kinds[kind][0](xz, wz, 100.0)
            if out[0].abs().sum().item() or out[1].abs().sum().item():
                fail(f"{kind}: an all-inactive case is not zero")
        gen = torch.Generator(device=dev).manual_seed(1)
        wu = (torch.randn(d, F, device=dev, generator=gen)
              / np.sqrt(d)).to(dtype)
        for T in (8, 128):
            big["fused_up_relu_tokens", T, dtype] = case(
                "fused_up_relu_tokens", f"OPT-6.7B T={T} {dtype}", (T, d), F,
                dtype, wu=wu)
        for W in (4, 16):
            big["fused_up_relu_window", W, dtype] = case(
                "fused_up_relu_window", f"OPT-6.7B B=8 W={W} {dtype}",
                (8, W, d), F, dtype, wu=wu)

    rows = {}
    for kind, sizes, key in (("fused_up_relu_tokens", (128, 8), "T"),
                             ("fused_up_relu_window", (16, 4), "W")):
        fn, plain = kinds[kind]
        timed = {}
        for n in sizes:
            err, (x, wu) = big[kind, n, torch.bfloat16]
            T = x.numel() // d
            n_groups = T if kind.endswith("tokens") else x.shape[0]
            n_bytes = (x.numel() * 2 + wu.numel() * 2 + T * F * 4
                       + n_groups * F // 128 * 4)
            b_ms, b_by = bound(n_bytes, 2.0 * T * d * F, torch.bfloat16)
            x2 = x.reshape(T, d)

            def lib():  # the dense product, ReLU and the scores' amax
                h = torch.relu(x2 @ wu - 0.0)
                return h, h.reshape(n_groups, -1, F // 128, 128).amax(
                    dim=(1, 3))

            same_bits(f"{kind} {key}={n}", lambda: torch.cat(
                [v.reshape(-1) for v in fn(x, wu)]))

            timed[n] = dict(
                max_abs_err=err,
                **timings(lambda: fn(x, wu), lambda: plain(x, wu), lib),
                bound_ms=b_ms, bound_by=b_by,
                max_abs_err_f32=big[kind, n, torch.float32][0])
        main, small = sizes
        rows[kind] = dict(
            name=kind, route="cuda",
            source="src/repro_torch/csrc/fused_up_relu.cu",
            replaces={"fused_up_relu_tokens": "src/repro/kernels/fused_ffn.py:111",
                      "fused_up_relu_window": "src/repro/kernels/fused_ffn.py:145"}[kind],
            **timed[main],
            shape=(f"T=128 d={d} F={F} bf16" if key == "T"
                   else f"B=8 W=16 d={d} F={F} bf16"),
            **{f"at_{key}{small}": timed[small]})
    return rows


def dense_expert_chain(pm, x, cfg):
    """The grouped-gather MoE FFN's function as per-expert dense f32
    products (the reference test's check): for every expert, the tokens
    whose kept assignments route to it, act(x @ Wg) * (x @ Wu) @ Wd, times
    the assignment's gate, summed."""
    from repro_torch.core import activations as acts
    from repro_torch.models import moe

    t = x.shape[0]
    _, dispatch, _, (_, _, cap), (topi, topv) = moe._route(pm, x, cfg)
    topi, topv = topi.reshape(t, -1), topv.reshape(t, -1)
    kept = dispatch.reshape(t, cfg.n_experts, cap).any(-1).gather(1, topi)
    act_fn = acts.get(cfg.activation, shift=cfg.sparsity.shift)
    xf = x.float()
    y = torch.zeros((t, cfg.d_model), dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        gate = (topv * (kept & (topi == e))).sum(1)  # (t,)
        h = act_fn(xf @ pm["wg"][e].float()) * (xf @ pm["wu"][e].float())
        y += gate[:, None] * (h @ pm["wd"][e].float())
    return y


def expert_kernel_rows(dev, rng, cfg=None) -> dict:
    """expert_up_matmul and expert_down_matmul against their plain versions:
    tiny edge cases (k_valid padding, a token with no live expert, the
    three type pairs), then Mixtral-8x22B layer 0's stacked experts (E = 8,
    d = 6144, F = 16384, tile 128, K = 256) made from a seed, with the
    lists of that layer's own router on T = 8 and 128 tokens, in f32 and
    bf16; the chain up -> SiLU GLU -> gates -> down against the per-expert
    dense product at full width. Returns their two rows (T = 128, main
    path's types: bf16 x and w for the up gather, f32 blocks with bf16 w
    for the down gather)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import sparse_matmul as ksm
    from repro_torch.models import moe

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    # tiny edges: E = 4, d = 64, F = 256, tile 128 (tpe 2), k_valid padding;
    # d = 72, not a multiple of the up routine's 64 rows a stage: each
    # expert's slab reads zeros past d, not the next expert's rows
    topi = np.stack([rng.permutation(4)[:2] for _ in range(6)])
    kv = t([2, 2, 1, 0, 2, 1], torch.int32)
    idx, nv = ksm.expert_tile_lists(t(topi, torch.int32), 2, kv)
    for dtype in (torch.float32, torch.bfloat16):
        x72 = t(rng.randn(6, 72), dtype)
        w72 = t(rng.randn(4, 72, 256) / 8.0, dtype)
        compare(f"expert_up_matmul tiny d=72 {dtype}",
                [ksm.expert_up_matmul(x72, w72, idx, nv)],
                [ksm.expert_up_matmul_plain(x72, w72, idx, nv)], dtype)
        x = t(rng.randn(6, 64), dtype)
        wu = t(rng.randn(4, 64, 256) / 8.0, dtype)
        wd = t(rng.randn(4, 256, 64) / 16.0, dtype)
        c = ksm.expert_up_matmul(x, wu, idx, nv)
        compare(f"expert_up_matmul tiny k_valid {dtype}", [c],
                [ksm.expert_up_matmul_plain(x, wu, idx, nv)], dtype)
        if c[3].abs().sum().item():
            fail("expert_up_matmul: a token with no live expert is not zero")
        for cd in {torch.float32, dtype}:
            cc = c.to(cd).contiguous()
            # f32 blocks are multiplied unrounded: f32 tolerance even
            # against bf16 weights
            compare(f"expert_down_matmul tiny ({cd}, {dtype})",
                    [ksm.expert_down_matmul(cc, wd, idx, nv)],
                    [ksm.expert_down_matmul_plain(cc, wd, idx, nv)], cd)

    # repeated tiles (tile 1 of token 0 twice, token 1's only tile 3 times),
    # pads repeating the first tile, an unsorted list, nvalid == 0
    ir = t([[1, 1, 0, 5], [3, 3, 3, 3], [7, 2, 6, 2], [4, 0, 4, 4]], torch.int32)
    nr = t([4, 3, 3, 0], torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        wd = t(rng.randn(4, 256, 64) / 16.0, dtype)
        for cd in {torch.float32, dtype}:
            cc = t(rng.randn(4, 4, 128), cd)
            compare(f"expert_down_matmul repeated tiles ({cd}, {dtype})",
                    [ksm.expert_down_matmul(cc, wd, ir, nr)],
                    [ksm.expert_down_matmul_plain(cc, wd, ir, nr)], cd)

    cfg = cfg or get_config("mixtral-8x22b").replace(
        n_layers=1, compute_dtype="bfloat16")
    pm = {k: v[0] for k, v in moe.init_params(
        cfg, seed=0, device=dev)["layers"]["moe"].items()}
    E, d, F, tile = cfg.n_experts, cfg.d_model, cfg.d_ff, 128
    tpe = F // tile
    w32 = {k: pm[k].float() for k in ("wu", "wd")}
    timed = {"expert_up_matmul": {}, "expert_down_matmul": {}}
    for T in (8, 128):
        x = t(rng.randn(T, d), torch.bfloat16)
        _, _, _, _, (topi, _) = moe._route(pm, x, cfg)
        idx, nv = ksm.expert_tile_lists(topi.reshape(T, -1), tpe)
        K = idx.shape[1]
        errs = {}
        for dtype, w in ((torch.float32, w32), (torch.bfloat16, pm)):
            xx = x.to(dtype)
            c = ksm.expert_up_matmul(xx, w["wu"], idx, nv)
            errs["up", dtype] = compare(
                f"expert_up_matmul Mixtral-8x22B T={T} {dtype}", [c],
                [ksm.expert_up_matmul_plain(xx, w["wu"], idx, nv)], dtype)
            errs["down", dtype] = compare(
                f"expert_down_matmul Mixtral-8x22B T={T} (f32, {dtype})",
                [ksm.expert_down_matmul(c, w["wd"], idx, nv)],
                [ksm.expert_down_matmul_plain(c, w["wd"], idx, nv)],
                torch.float32)
        cb = c.to(torch.bfloat16)
        compare(f"expert_down_matmul Mixtral-8x22B T={T} (bf16, bf16)",
                [ksm.expert_down_matmul(cb, pm["wd"], idx, nv)],
                [ksm.expert_down_matmul_plain(cb, pm["wd"], idx, nv)],
                torch.bfloat16)
        compare(f"grouped-gather MoE FFN vs per-expert dense, Mixtral-8x22B "
                f"T={T}", [moe.apply_moe_gathered(pm, x, cfg)],
                [dense_expert_chain(pm, x, cfg)], torch.bfloat16)

        live = torch.arange(K, device=dev)[None, :] < nv[:, None]
        distinct = int(torch.unique(idx[live]).numel())
        w_bytes = distinct * tile * d * 2
        flops = 2.0 * float(nv.sum()) * tile * d
        list_bytes = idx.numel() * 4 + T * 4
        b_up = bound(T * d * 2 + w_bytes + list_bytes + T * K * tile * 4,
                     flops, torch.bfloat16)
        b_down = bound(T * K * tile * 4 + w_bytes + list_bytes + T * d * 4,
                       flops, torch.bfloat16)
        hd = torch.randn(T, E, F, device=dev, dtype=torch.bfloat16)
        timed["expert_up_matmul"][T] = dict(
            max_abs_err=errs["up", torch.bfloat16],
            max_abs_err_f32=errs["up", torch.float32],
            **timings(lambda: ksm.expert_up_matmul(x, pm["wu"], idx, nv),
                      lambda: ksm.expert_up_matmul_plain(x, pm["wu"], idx, nv),
                      lambda: torch.einsum("td,edf->tef", x, pm["wu"])),
            bound_ms=b_up[0], bound_by=b_up[1],
            distinct_tiles=distinct, K=K)
        idx_main, nv_main = idx, nv
        timed["expert_down_matmul"][T] = dict(
            max_abs_err=errs["down", torch.bfloat16],
            max_abs_err_f32=errs["down", torch.float32],
            **timings(lambda: ksm.expert_down_matmul(c, pm["wd"], idx, nv),
                      lambda: ksm.expert_down_matmul_plain(c, pm["wd"], idx,
                                                           nv),
                      lambda: torch.einsum("tef,efd->td", hd, pm["wd"])),
            bound_ms=b_down[0], bound_by=b_down[1],
            distinct_tiles=distinct, K=K)
    # at full width: every token routed to experts 0 and 1 (two runs of
    # T / 64 chunks each), and capacity drops (k_valid of 0, 1 or 2)
    T = 128
    topi = t(np.stack([rng.permutation(2) for _ in range(T)]), torch.int32)
    for name, kv in (("all tokens on experts 0, 1", None),
                     ("k_valid drops", t(rng.randint(0, 3, T), torch.int32))):
        if kv is not None:
            topi = t(np.stack([rng.permutation(E)[:2] for _ in range(T)]),
                     torch.int32)
        idx, nv = ksm.expert_tile_lists(topi, tpe, kv)
        xr = t(rng.randn(T, d), torch.bfloat16)
        cu = ksm.expert_up_matmul(xr, pm["wu"], idx, nv)
        compare(f"expert_up_matmul Mixtral-8x22B {name} bf16", [cu],
                [ksm.expert_up_matmul_plain(xr, pm["wu"], idx, nv)],
                torch.bfloat16)
        if kv is not None and cu[kv == 0].abs().sum().item():
            fail("expert_up_matmul: a token with no live expert is not zero")
        for cd in (torch.float32, torch.bfloat16):
            cc = t(rng.randn(T, idx.shape[1], tile) / 8.0, cd)
            compare(f"expert_down_matmul Mixtral-8x22B {name} ({cd}, bf16)",
                    [ksm.expert_down_matmul(cc, pm["wd"], idx, nv)],
                    [ksm.expert_down_matmul_plain(cc, pm["wd"], idx, nv)], cd)
    same_bits("expert_down_matmul T=128 (f32, bf16)",
              lambda: ksm.expert_down_matmul(c, pm["wd"], idx_main, nv_main))
    same_bits("expert_up_matmul T=128 bf16",
              lambda: ksm.expert_up_matmul(x, pm["wu"], idx_main, nv_main))
    rows = {}
    K = cfg.top_k * tpe
    for kind, line, shape in (
            ("expert_up_matmul", 266, f"x bf16 (T, {d}), w bf16 ({E}, {d}, {F})"),
            ("expert_down_matmul", 317,
             f"compact f32 (T, {K}, {tile}), w bf16 ({E}, {F}, {d})")):
        rows[kind] = dict(
            name=kind, route="cuda", source=f"src/repro_torch/csrc/{kind}.cu",
            replaces=f"src/repro/kernels/sparse_matmul.py:{line}",
            **timed[kind][128],
            shape=f"T=128 top-{cfg.top_k} of {E}, K={K}; {shape}",
            at_T8=timed[kind][8])
    return rows


# ---------------------------------------------------------------------------
# phase 4: f32 engine parity, card vs CPU


def serve_streams(cfg, params, device, prompts, chunk, predictor=None,
                  sampling=None, reuse=4, **spec):
    """Serve ``prompts`` (10 new tokens each, γ-window reuse ``reuse``)
    through a fresh engine; ``sampling`` gives each request its
    SamplingParams (None: greedy), ``spec`` the speculative fields of
    EngineConfig (draft_cfg, draft_params, gamma), where reuse is ignored.
    Returns (streams, logprobs, engine)."""
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    eng = ContinuousBatchingEngine(
        cfg, params, EngineConfig(n_slots=4, block_size=8,
                                  max_blocks_per_seq=6, prefill_chunk=chunk,
                                  predictor=predictor, base_seed=3, **spec),
        device=device)
    sampling = sampling or [None] * len(prompts)
    uids = [eng.submit(p, 10, reuse_window=reuse, sampling=sp)
            for p, sp in zip(prompts, sampling)]
    res = eng.run()
    return ([res[u].tokens.tolist() for u in uids],
            np.concatenate([res[u].logprobs for u in uids]), eng)


def parity_sampling(n: int):
    """The parity phase's sampled traffic over ``n`` requests: seeded top-k,
    seeded top-p, unseeded (the engine's base_seed) and greedy in turn."""
    from repro_torch.serving import SamplingParams
    kinds = [SamplingParams(temperature=0.9, top_k=40, seed=11),
             SamplingParams(temperature=1.2, top_p=0.9, seed=12),
             SamplingParams(temperature=0.8), None]
    return [kinds[i % 4] for i in range(n)]


def same_streams(what: str, got, want) -> float:
    """Fails unless the (streams, logprobs) pairs agree (the card's against
    the CPU's, or two paths on the card): tokens exactly, logprobs within
    1e-5; returns the largest logprob difference."""
    if got[0] != want[0]:
        fail(f"{what}: streams {got[0]} != {want[0]}")
    d = float(np.max(np.abs(got[1] - want[1])))
    if d > 1e-5:
        fail(f"{what}: logprobs differ by {d:.3e}")
    return d


def key_schedule_parity(dev) -> None:
    """The key schedule, random bits and uniform on the card are bit-equal
    to the CPU's (integer and bit operations only)."""
    from repro_torch.serving import prng
    from repro_torch.serving import sampling as smp

    g = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 2 ** 32, (8, 2), generator=g, dtype=torch.int64)
    gen = torch.randint(0, 1000, (8,), generator=g, dtype=torch.int64)
    for what, fn in (
            ("position_keys", lambda k, n: smp.position_keys(k, n)),
            ("window_keys W=5", lambda k, n: smp.window_keys(k, n, 5)),
            ("random_bits32 V=50272",
             lambda k, n: prng.random_bits32(smp.position_keys(k, n), 50272)),
            ("uniform V=50272",
             lambda k, n: prng.uniform(smp.position_keys(k, n), 50272))):
        want = fn(keys, gen)
        got = fn(keys.to(dev), gen.to(dev)).cpu()
        if not torch.equal(got.view(torch.int32) if got.is_floating_point()
                           else got,
                           want.view(torch.int32) if want.is_floating_point()
                           else want):
            fail(f"{what}: the card's bits differ from the CPU's")
    log("  ok key schedule, random bits and uniform: card bit-equal to CPU")


def sampled_spec_parity(dev, cfg, p_cpu, p_dev, prompts, pred_cpu, pred_dev
                        ) -> None:
    """Sampled and speculative f32 streams of one tiny config, card against
    CPU: sampled traffic in plain (whole-prompt, chunked) and predictor
    mode; the speculative engine with the 1-layer random draft
    (launch/serve_api.py's) on greedy and sampled traffic, whole-prompt and
    chunked; then, on the card, the spec stream against the AR stream and
    the target as its own draft."""
    from repro_torch.serving import SamplingParams

    sampled = parity_sampling(len(prompts))
    for chunk, pc, pd in ((0, None, None), (4, None, None),
                          (4, pred_cpu, pred_dev)):
        mode = "predictor" if pc is not None else "plain"
        want = serve_streams(cfg, p_cpu, "cpu", prompts, chunk, pc, sampled)
        got = serve_streams(cfg, p_dev, dev, prompts, chunk, pd, sampled)
        d = same_streams(f"{cfg.name} sampled {mode} chunk={chunk}", got,
                         want)
        log(f"  ok parity {cfg.name} sampled {mode} prefill_chunk={chunk}: "
            f"{sum(map(len, got[0]))} tokens identical, max|dlogprob| "
            f"{d:.2e}")
    dcfg = cfg.replace(name=f"{cfg.name}-draft", n_layers=1)
    d_cpu = numpy_params(dcfg, seed=2)
    d_dev = _to(d_cpu, dev)
    greedy = [None, SamplingParams(stop=((7,),))] + [None] * (len(prompts) - 2)
    # the AR stream a spec engine must reproduce: dense decode (a verify
    # window is its own γ-window)
    ar = serve_streams(cfg, p_dev, dev, prompts, 4, sampling=sampled, reuse=0)
    for traffic, sps in (("greedy", greedy), ("sampled", sampled)):
        for chunk in (0, 4):
            want = serve_streams(cfg, p_cpu, "cpu", prompts, chunk,
                                 sampling=sps, draft_cfg=dcfg,
                                 draft_params=d_cpu, gamma=4)
            got = serve_streams(cfg, p_dev, dev, prompts, chunk, sampling=sps,
                                draft_cfg=dcfg, draft_params=d_dev, gamma=4)
            what = f"{cfg.name} spec {traffic} chunk={chunk}"
            d = same_streams(what, got, want)
            if abs(got[2].s_agg_window() - want[2].s_agg_window()) > 1e-6:
                fail(f"{what}: s_agg {got[2].s_agg_window()} != CPU "
                     f"{want[2].s_agg_window()}")
            log(f"  ok parity {what}: {sum(map(len, got[0]))} tokens "
                f"identical, max|dlogprob| {d:.2e}, s_agg "
                f"{got[2].s_agg_window():.4f}")
            if traffic == "sampled" and chunk == 4:
                d = same_streams(f"{cfg.name} card spec vs card AR", got, ar)
                log(f"  ok {cfg.name} card spec stream = card AR stream "
                    f"(max|dlogprob| {d:.2e})")
    got = serve_streams(cfg, p_dev, dev, prompts, 4, sampling=sampled,
                        draft_cfg=cfg, draft_params=p_dev, gamma=4)
    d = same_streams(f"{cfg.name} card spec (target as draft) vs AR", got, ar)
    res = got[2].scheduler.results
    alpha = (sum(r.draft_accepted for r in res.values())
             / max(1, sum(r.draft_proposed for r in res.values())))
    log(f"  {cfg.name} target as its own draft on the card: accept rate "
        f"{alpha:.4f}, stream = AR stream (max|dlogprob| {d:.2e})")


def numpy_params(cfg, seed: int):
    """Random f32 params drawn from a numpy seed, in the port's layout: each
    weight leaf of the family's ``init_params`` tree is redrawn at its own
    scale, with padded head slots kept at zero and constant leaves (norms)
    kept."""
    from repro_torch.models import registry

    rng = np.random.RandomState(seed)

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        a = t.numpy()
        if a.std() == 0:
            return t
        new = rng.standard_normal(a.shape) * a.std()
        return torch.from_numpy(np.where(a == 0, 0.0, new).astype(np.float32))

    return draw(registry.get_family(cfg).init_params(cfg, device="cpu"))


def parity_phase(dev) -> None:
    """f32 greedy streams, card (kernels) against CPU (plain versions),
    token for token and logprobs within 1e-5: plain mode at whole-prompt
    and chunked prefill, and predictor mode with a sign predictor
    calibrated at recall 1.0 (f32 probe, tile 1: the reference tests'
    exact row-skipping, a tile every kernel takes). The CPU engine runs
    the predictor FFN's unfused lowering, the card the fused kernel. Then
    both lowerings of one predicted FFN layer on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.predictor import calibrate

    for name in ("tiny-opt", "tiny-relu"):
        cfg = get_config(name).replace(compute_dtype="float32")
        p_cpu = numpy_params(cfg, seed=0)
        p_dev = _to(p_cpu, dev)
        prompts = [np.random.RandomState(s).randint(0, cfg.vocab_size, n)
                   for s, n in ((1, 9), (2, 5), (3, 13), (4, 21), (5, 3))]
        toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (4, 24))
        pred_cpu = calibrate(p_cpu, cfg, {"tokens": torch.as_tensor(toks)},
                             kind="sign", probe_dtype="float32",
                             target_recall=1.0, tile=1)
        pred_dev = dataclasses.replace(pred_cpu, params=_to(pred_cpu.params,
                                                            dev))
        for chunk, pc, pd in ((0, None, None), (4, None, None),
                              (4, pred_cpu, pred_dev)):
            mode = "predictor" if pc is not None else "plain"
            want, lp_want, e_cpu = serve_streams(cfg, p_cpu, "cpu", prompts,
                                                 chunk, pc)
            got, lp_got, eng = serve_streams(cfg, p_dev, dev, prompts, chunk,
                                             pd)
            if not eng.fast_kernels:
                fail("engine on the card did not take the kernel path")
            d = same_streams(f"{name} {mode} chunk={chunk}", (got, lp_got),
                             (want, lp_want))
            extra = ""
            if pc is not None:
                if eng.predictor_recall() != 1.0 or e_cpu.predictor_recall() != 1.0:
                    fail(f"{name}: recall-1.0 predictor missed units")
                if abs(eng.predictor_density() - e_cpu.predictor_density()) > 1e-9:
                    fail(f"{name}: predictor density {eng.predictor_density()} "
                         f"!= CPU {e_cpu.predictor_density()}")
                extra = (f", predictor density {eng.predictor_density():.4f}"
                         f" recall {eng.predictor_recall()}")
            log(f"  ok parity {name} {mode} prefill_chunk={chunk}: "
                f"{sum(map(len, got))} tokens identical, max|dlogprob| "
                f"{d:.2e}{extra}")

        rng = np.random.RandomState(4)
        pf = {k: v[1] for k, v in p_dev["layers"]["ffn"].items()}
        pred_l = {k: v[1] for k, v in pred_dev.params.items()}
        h = torch.as_tensor(rng.randn(5, cfg.d_model), dtype=torch.float32,
                            device=dev)
        kw = dict(kind="sign", tile=1, k_tiles=cfg.d_ff,
                  mask=torch.as_tensor(rng.rand(5, cfg.d_ff) < 0.3, device=dev),
                  refresh=torch.tensor([True, False, False, True, False],
                                       device=dev))
        a = T._ffn_decode_predicted(pf, h, cfg, pred_l, fused=False, **kw)
        b = T._ffn_decode_predicted(pf, h, cfg, pred_l, fused=True, **kw)
        torch.cuda.synchronize()
        df = (a[0] - b[0]).abs().max().item()
        if df > TOL_F32 * b[0].abs().max().item() or not torch.equal(a[1], b[1]):
            fail(f"{name}: fused and unfused predictor FFN differ "
                 f"(max|df| {df:.3e})")
        log(f"  ok fused vs unfused predictor FFN {name}: f bit-equal "
            f"{df == 0}, act equal")
        sampled_spec_parity(dev, cfg, p_cpu, p_dev, prompts, pred_cpu,
                            pred_dev)
    key_schedule_parity(dev)

    # tiny-moe (drop-free capacity): plain mode, whole-prompt and chunked
    cfg = get_config("tiny-moe").replace(compute_dtype="float32")
    p_cpu = numpy_params(cfg, seed=0)
    p_dev = _to(p_cpu, dev)
    prompts = [np.random.RandomState(s).randint(0, cfg.vocab_size, n)
               for s, n in ((1, 9), (2, 5), (3, 13), (4, 21), (5, 3))]
    for chunk in (0, 4):
        want, lp_want, e_cpu = serve_streams(cfg, p_cpu, "cpu", prompts, chunk)
        got, lp_got, eng = serve_streams(cfg, p_dev, dev, prompts, chunk)
        if not eng.fast_kernels:
            fail("MoE engine on the card did not take the kernel path")
        d = same_streams(f"tiny-moe chunk={chunk}", (got, lp_got),
                         (want, lp_want))
        if abs(eng.weight_io_bytes_per_step()
               - e_cpu.weight_io_bytes_per_step()) > 1e-9 * e_cpu.weight_io_bytes_per_step():
            fail(f"tiny-moe chunk={chunk}: weight I/O "
                 f"{eng.weight_io_bytes_per_step()} != CPU "
                 f"{e_cpu.weight_io_bytes_per_step()}")
        log(f"  ok parity tiny-moe plain prefill_chunk={chunk}: "
            f"{sum(map(len, got))} tokens identical, max|dlogprob| {d:.2e}, "
            f"expert I/O fraction {eng.expert_io_fraction()}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 5: the serving front door and observability


def api_phase(dev, counters, cfg=None) -> dict:
    """The async engine, the HTTP/SSE server and the observability hub on
    the card: f32 parity on tiny-relu (``api_parity``), the smoke client
    against a real server process (``api_smoke_process``), then OPT-6.7B
    at full width behind the HTTP server in this process
    (``api_full_width``, counted). Returns that run's launches."""
    api_parity(dev)
    api_smoke_process(dev)
    return api_full_width(dev, counters, cfg)


def _collect_stream(api, prompt, max_new, sampling=None, reuse_window=0):
    """(tokens, logprobs) of one request streamed through ``api``."""
    async def run():
        tokens, lps = [], []
        async for ev in api.stream(prompt, max_new, sampling=sampling,
                                   reuse_window=reuse_window):
            if not ev.finished:
                tokens.append(ev.token)
                lps.append(ev.logprob)
        return tokens, lps
    return run()


def count_syncs(eng, prompts, dev) -> list:
    """Serve ``prompts`` (10 new tokens each) through ``eng`` step by step
    under ``torch.cuda.set_sync_debug_mode("warn")``; per step, the
    synchronizing-op warnings it raised, and the device-to-host fetches
    (``Tensor.cpu``, ``.item``, ``.tolist`` on a tensor of ``dev``) it
    made. Returns [(warnings, fetches), ...]."""
    import warnings

    for p in prompts:
        eng.submit(p, 10, reuse_window=4)
    fetches = [0]
    patched = {name: getattr(torch.Tensor, name)
               for name in ("cpu", "item", "tolist")}

    def counting(fn):
        def run(t, *a, **k):
            if t.device.type == dev.type:
                fetches[0] += 1
            return fn(t, *a, **k)
        return run

    counts = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, fn in patched.items():
            setattr(torch.Tensor, name, counting(fn))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            while eng.scheduler.has_work():
                n0, f0 = len(caught), fetches[0]
                if not eng.step():
                    break
                counts.append((sum("synchroniz" in str(w.message)
                                   for w in caught[n0:]), fetches[0] - f0))
        finally:
            torch.cuda.set_sync_debug_mode("default")
            for name, fn in patched.items():
                setattr(torch.Tensor, name, fn)
    return counts


def api_parity(dev) -> None:
    """tiny-relu at f32 on the card, in plain, spec (1-layer random draft,
    γ = 2) and predictor mode (sign, recall 1.0, tile 1), chunked prefill,
    greedy and sampled traffic (``parity_sampling``):

    - ``AsyncServingEngine`` streams equal the same card engine's offline
      ``engine.run()``: tokens exactly, greedy logprobs bit for bit;
    - an engine with ``EngineObs.disabled()`` serves the same streams;
    - ``track_sparsity`` trackers on the card equal the CPU engine's;
    - observability adds no sync: with the hub on and off, every step of
      the same workload raises the same count of synchronizing-op
      warnings (``count_syncs``; if the card raised none at all, the
      count of device-to-host fetches decides, and the line says so)."""
    import asyncio
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.obs import EngineObs
    from repro_torch.predictor import calibrate
    from repro_torch.serving import (AsyncServingEngine,
                                     ContinuousBatchingEngine, EngineConfig)

    cfg = get_config("tiny-relu").replace(compute_dtype="float32")
    dcfg = cfg.replace(name="tiny-relu-draft", n_layers=1)
    p_cpu, d_cpu = numpy_params(cfg, seed=0), numpy_params(dcfg, seed=2)
    params = {"cpu": p_cpu, dev.type: _to(p_cpu, dev)}
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (4, 24))
    pred = calibrate(p_cpu, cfg, {"tokens": torch.as_tensor(toks)},
                     kind="sign", probe_dtype="float32", target_recall=1.0,
                     tile=1)
    modes = {
        "plain": lambda d: {},
        "spec": lambda d: dict(draft_cfg=dcfg, draft_params=_to(d_cpu, d),
                               gamma=2),
        "predictor": lambda d: dict(predictor=dataclasses.replace(
            pred, params=_to(pred.params, d))),
    }
    prompts = [np.random.RandomState(s).randint(0, cfg.vocab_size, n)
               for s, n in ((1, 9), (2, 5), (3, 13), (4, 21), (5, 3))]
    sampling = parity_sampling(len(prompts))

    def engine(device, mode, **extra):
        device = torch.device(device)
        return ContinuousBatchingEngine(
            cfg, params[device.type], EngineConfig(
                n_slots=4, block_size=8, max_blocks_per_seq=6,
                prefill_chunk=4, base_seed=3, **modes[mode](device),
                **extra), device=device)

    def offline(eng):
        uids = [eng.submit(p, 10, reuse_window=4, sampling=sp)
                for p, sp in zip(prompts, sampling)]
        res = eng.run()
        return ([res[u].tokens.tolist() for u in uids],
                [res[u].logprobs for u in uids])

    async def streamed(eng):
        async with AsyncServingEngine(eng) as api:
            return await asyncio.gather(*[
                _collect_stream(api, p, 10, sp, reuse_window=4)
                for p, sp in zip(prompts, sampling)])

    for mode in modes:
        eng = engine(dev, mode)
        want, want_lp = offline(eng)
        got = asyncio.run(asyncio.wait_for(streamed(eng), 600))
        for i, (tokens, lps) in enumerate(got):
            if tokens != want[i]:
                fail(f"api {mode}: request {i} streamed {tokens} != "
                     f"offline engine.run() {want[i]}")
            greedy = sampling[i] is None
            if greedy and not np.array_equal(np.float32(lps), want_lp[i]):
                fail(f"api {mode}: greedy request {i} logprobs differ from "
                     f"engine.run()'s")
        d_sampled = max(float(np.abs(np.float32(lps) - want_lp[i]).max())
                        for i, (_, lps) in enumerate(got) if sampling[i])
        off = offline(engine(dev, mode, obs=EngineObs.disabled()))
        if off[0] != want or not all(map(np.array_equal, off[1], want_lp)):
            fail(f"api {mode}: streams with observability off differ")
        t_cpu, t_dev = (engine(d, mode, track_sparsity=True)
                        for d in ("cpu", dev))
        offline(t_cpu)
        offline(t_dev)
        if sorted(t_cpu.trackers) != sorted(t_dev.trackers):
            fail(f"api {mode}: tracked requests differ card vs CPU")
        flips = sum(int((t_cpu.trackers[u].used
                         != t_dev.trackers[u].used).sum())
                    for u in t_cpu.trackers)
        dcurve = max(float(np.abs(np.subtract(t_cpu.trackers[u].curve,
                                              t_dev.trackers[u].curve)).max())
                     for u in t_cpu.trackers)
        if flips or dcurve > 1e-6:
            fail(f"api {mode}: trackers card vs CPU: {flips} units differ, "
                 f"max|dcurve| {dcurve:.2e}")
        on_n = count_syncs(engine(dev, mode), prompts, dev)
        off_n = count_syncs(engine(dev, mode, obs=EngineObs.disabled()),
                            prompts, dev)
        by = "sync-debug warnings"
        if not any(w for w, _ in on_n + off_n):
            by = "device-to-host fetches (no sync-debug warning raised)"
            on_n, off_n = ([(f, f) for _, f in c] for c in (on_n, off_n))
        if [w for w, _ in on_n] != [w for w, _ in off_n]:
            fail(f"api {mode}: {by} a step with obs on {on_n} != off "
                 f"{off_n}")
        log("  ok api " + json.dumps(dict(
            mode=mode, requests=len(prompts),
            streams_equal_engine_run=True, greedy_logprobs_bit_equal=True,
            sampled_max_abs_dlogprob=d_sampled,
            obs_off_streams_identical=True,
            trackers_equal_cpu=len(t_cpu.trackers),
            syncs_per_step_counted_by=by,
            syncs_per_step_obs_on=[w for w, _ in on_n],
            syncs_per_step_obs_off=[w for w, _ in off_n],
            fetches_per_step_obs_on=[f for _, f in on_n])))


def api_smoke_process(dev) -> None:
    """``python -m repro_torch.launch.serve_smoke_client --mode plain``
    on ``dev``: the real server process, 8 SSE clients (one disconnecting
    mid-stream), greedy streams against the offline run, /metrics against
    the clients. Its logs go under build/api_smoke/; the client and the
    server it starts run in a session of their own, killed on timeout."""
    import os
    import signal

    out = ROOT / "build" / "api_smoke"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_smoke_client",
         "--mode", "plain", "--device", dev.type,
         "--log", str(out / "api_smoke_server.log"),
         "--metrics-out", str(out / "api_smoke_metrics.prom")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail("serve_smoke_client did not finish within 600 s")
    if proc.returncode != 0 or "serve-smoke PASS" not in text:
        fail(f"serve_smoke_client --device {dev.type} failed "
             f"(rc {proc.returncode}):\n{text[-3000:]}")
    log(f"  ok {text.strip().splitlines()[-1]} "
        f"({time.perf_counter() - t0:.1f} s with its server process)")


def _quantiles(xs) -> dict:
    return dict(median=float(np.median(xs)), p99=float(np.percentile(xs, 99)))


def api_full_width(dev, counters, cfg=None) -> dict:
    """OPT-6.7B (32 layers, bf16, random weights from a seed) behind
    ``ApiServer`` on port 0 in this process, with the serve phase's
    geometry (8 slots, block 16, 16 blocks a sequence, chunks of 16).
    First an offline ``engine.run()`` of the serve phase's 8 requests (4
    sampled) on the engine; then, the hub reset, the same 8 requests as 8
    concurrent SSE clients plus a ninth that disconnects after 3 tokens,
    counted (kernels 1-3 must launch); then the offline run again, whose
    time is compared (the first one pays the engine's first steps). Every
    completed stream must equal the offline run's. Prints client-side TTFT and TPOT (exact
    median and p99), the hub's p50 and p99 (bucket edges), each step
    phase's mean for decode and chunk steps apart, the hub's own time as
    a share of step time, /metrics against the clients, and HTTP against
    offline tokens/s. Returns the launches."""
    import asyncio

    from repro_torch.configs import get_config
    from repro_torch.launch.serve_api import ApiServer
    from repro_torch.launch.serve_smoke_client import http_get, stream_client
    from repro_torch.models import transformer as T
    from repro_torch.obs import parse_prometheus
    from repro_torch.serving import (AsyncServingEngine,
                                     ContinuousBatchingEngine, EngineConfig)

    cfg = cfg or get_config("opt-6.7b").replace(compute_dtype="bfloat16")
    params = T.init_params(cfg, seed=0, device=dev)
    eng = ContinuousBatchingEngine(
        cfg, params, EngineConfig(n_slots=8, block_size=16,
                                  max_blocks_per_seq=16, prefill_chunk=16),
        device=dev)
    sampling = serve_sampling()

    def offline():
        _, _, uids = submit_requests(eng, cfg, 0, sampling)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        return ([res[uids[i]].tokens.tolist() for i in range(8)],
                time.perf_counter() - t0)

    want, offline_cold_s = offline()

    bodies = []
    for p, sp in zip(serve_prompts(cfg, 0), sampling):
        b = {"prompt": p.tolist(), "max_new": 16, "reuse_window": 4}
        if sp is not None:
            b.update(temperature=sp.temperature, top_k=sp.top_k,
                     top_p=sp.top_p, seed=sp.seed)
        bodies.append(b)
    extra = np.random.RandomState(9).randint(0, cfg.vocab_size, 40)
    bodies.append({"prompt": extra.tolist(), "max_new": 16})
    eng.obs.reset()
    rows = phase_capture(eng)
    times = [[] for _ in bodies]

    async def http_run():
        async with AsyncServingEngine(eng) as api:
            server = ApiServer(api, mode="plain")
            await server.start(port=0)
            try:
                t0 = time.perf_counter()
                outs = await asyncio.gather(*[
                    stream_client(server.port, b, times=times[i],
                                  disconnect_after=3 if i == 8 else None)
                    for i, b in enumerate(bodies)])
                wall = time.perf_counter() - t0
                # the server cancels the ninth request when a write to its
                # closed socket fails, a step or two after the client left
                for _ in range(600):
                    _, metrics = await http_get(server.port, "/metrics")
                    if 'reason="cancelled"' in metrics:
                        break
                    await asyncio.sleep(0.05)
                _, statusz = await http_get(server.port, "/statusz")
                return outs, wall, metrics, statusz
            finally:
                await server.aclose()

    (outs, wall, metrics, statusz), launches = counted(
        "api serving (OPT-6.7B over HTTP/SSE)", counters,
        ("fused_sparse_ffn", "paged_window_attention", "sparse_matmul_tokens"),
        lambda: asyncio.run(asyncio.wait_for(http_run(), 900)))
    obs = eng.obs
    hub = {name: {q: (None if obs.quantile(f"repro_{name}_seconds", q) is None
                      else obs.quantile(f"repro_{name}_seconds", q) * 1e3)
                  for q in (0.5, 0.99)}
           for name in ("request_ttft", "request_tpot", "api_ttft",
                        "engine_step")}
    phases, self_share = phase_means(rows), obs_self_time_share(obs)
    snapshot = eng.metrics_snapshot()
    again, offline_s = offline()
    if again != want:
        fail("api OPT-6.7B: a second offline run changed the streams")
    for i, (tokens, final) in enumerate(outs[:8]):
        if final is None or tokens != want[i] or final["tokens"] != want[i]:
            fail(f"api OPT-6.7B: client {i} streamed {tokens} != offline "
                 f"engine.run() {want[i]}")
    if outs[8][1] is not None or len(outs[8][0]) != 3:
        fail("api OPT-6.7B: the disconnecting client was not cut at 3 "
             "tokens")
    m = parse_prometheus(metrics)
    reasons = {lab: v for (name, lab), v in m.items()
               if name == "repro_requests_finished_total"}
    if (m.get(("repro_requests_submitted_total", "")) != 9
            or sum(reasons.values()) != 9
            or reasons.get('reason="cancelled"') != 1):
        fail(f"api OPT-6.7B: /metrics counts {reasons}")
    if "repro serving engine" not in statusz:
        fail("api OPT-6.7B: /statusz did not render")
    n_tokens = sum(len(t) for t in want)
    ttft = [(ts[1] - ts[0]) * 1e3 for ts in times[:8]]
    tpot = [(ts[-1] - ts[1]) * 1e3 / (len(ts) - 2) for ts in times[:8]]
    log("  api " + json.dumps(dict(
        model=cfg.name, layers=cfg.n_layers, dtype=str(cfg.compute_dtype),
        clients=len(bodies), sampled=sum(sp is not None for sp in sampling),
        streams_equal_offline=8, disconnected_after_tokens=3,
        client_ttft_ms=_quantiles(ttft), client_tpot_ms=_quantiles(tpot),
        hub_ms_p50_p99_bucket_edges=hub,
        phase_ms_mean=phases, obs_self_time_share=self_share,
        http_tokens_per_s=n_tokens / wall, http_wall_s=wall,
        offline_tokens_per_s=n_tokens / offline_s, offline_wall_s=offline_s,
        offline_first_run_tokens_per_s=n_tokens / offline_cold_s,
        metrics_generated_tokens=m.get(("repro_generated_tokens_total", "")),
        metrics_snapshot=snapshot, launches=launches)))
    del eng, params
    # the disconnected client's BrokenPipeError traceback holds the server,
    # and through it the engine, in a reference cycle: free it now
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: OPT-6.7B at full width


def timed_steps(eng) -> dict:
    """Step the engine until its work is done, timing each step on the host
    clock with the card synchronised at both ends. Steps that ran a prefill
    chunk (or admitted) count as prefill, the rest as decode."""
    out = {"prefill": [], "decode": [], "decode_tokens": 0}
    sched = eng.scheduler

    def emitted():  # slots' tokens so far, retired requests' included
        return (sum(len(s.out) for s in sched.slots if s is not None)
                + sum(len(r.tokens) for r in sched.results.values()))

    while sched.has_work():
        prefilling = bool(sched.prefill_indices()) or bool(len(sched.queue))
        before = emitted()
        torch.cuda.synchronize()
        a = time.perf_counter()
        if not eng.step():
            break
        torch.cuda.synchronize()
        ms = (time.perf_counter() - a) * 1e3
        if prefilling:
            out["prefill"].append(ms)
        else:
            out["decode"].append(ms)
            # tokens the step emitted: one a slot, more under speculation
            out["decode_tokens"] += emitted() - before
    return out


def counted(path: str, counters, expect, fn):
    """Run one path of the port with every kernel's launch count set to 0
    just before and read just after; fails unless each kernel in
    ``expect`` launched. Returns (fn's result, {kernel: launches})."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    for name in expect:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")
    log(f"  launches on the {path} path: {json.dumps(launches)}")
    return out, launches


def serve_sampling():
    """The serve phase's sampled traffic over its 8 requests: requests 0, 2,
    4 and 6 seeded, top-k 50 and top-p 0.9 in turn; the rest greedy."""
    from repro_torch.serving import SamplingParams
    return [(SamplingParams(temperature=0.8, top_k=50, seed=100 + i)
             if i % 4 == 0 else
             SamplingParams(temperature=1.0, top_p=0.9, seed=100 + i))
            if i % 2 == 0 else None for i in range(8)]


def serve_prompts(cfg, seed: int) -> list:
    """The serve phase's 8 prompts of 16 to 64 tokens from ``seed``."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, n)
            for n in rng.randint(16, 65, size=8)]


def submit_requests(eng, cfg, seed: int, sampling=None, order=None):
    """The serve phase's 8 requests (``serve_prompts``, 16 new tokens each,
    γ = 4) submitted to ``eng``. ``sampling`` gives each request its
    SamplingParams (None: greedy); ``order`` permutes the order of
    submission. Returns (prompt lengths, sampling, {request: uid})."""
    prompts = serve_prompts(cfg, seed)
    lens = np.array([len(p) for p in prompts])
    sampling = sampling or [None] * 8
    uids = {}
    for i in (order if order is not None else range(8)):
        uids[i] = eng.submit(prompts[i], 16, reuse_window=4,
                             sampling=sampling[i])
    return lens, sampling, uids


def serve_run(eng, cfg, seed: int, sampling=None, order=None) -> dict:
    """``submit_requests``' requests through ``eng`` to completion, with
    step timings and peak memory. The streams, by request, come back under
    "_streams". In speculative mode every step after admission is a spec
    step, and the decode tokens/s counts the tokens the steps emitted."""
    dev = eng.device
    lens, sampling, uids = submit_requests(eng, cfg, seed, sampling, order)
    torch.cuda.reset_peak_memory_stats(dev)
    phases = phase_capture(eng)
    steps = timed_steps(eng)
    prefill_ms, decode_ms = steps["prefill"], steps["decode"]
    res = eng.run()
    for u in uids.values():
        r = res[u]
        if len(r.tokens) != 16:
            fail(f"request {u} finished with {len(r.tokens)} tokens, not 16")
        if not np.isfinite(r.logprobs).all():
            fail(f"request {u} has non-finite logprobs")
    return dict(model=cfg.name, layers=cfg.n_layers, dtype="bfloat16",
                prompt_lens=lens.tolist(), max_new=16, n_slots=8,
                sampled=sum(sp is not None and not sp.is_greedy
                            for sp in sampling),
                prefill_steps=len(prefill_ms),
                prefill_step_ms_median=float(np.median(prefill_ms)),
                decode_steps=len(decode_ms),
                decode_step_ms_median=float(np.median(decode_ms)),
                decode_tokens_per_s=steps["decode_tokens"] / (sum(decode_ms) / 1e3),
                peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                weight_io_saved=eng.weight_io_saved(),
                phase_ms_mean=phase_means(phases),
                obs_self_time_share=obs_self_time_share(eng.obs),
                metrics_snapshot=eng.metrics_snapshot(),
                _streams=[res[uids[i]].tokens.tolist() for i in range(8)],
                _logprobs=np.concatenate([res[uids[i]].logprobs
                                          for i in range(8)]))


def phase_capture(eng) -> dict:
    """Record the step-phase times (ms) of each step that did work from
    then on, through the engine's observability hub (its ``step_end``,
    which receives the step's trace): steps that ran a prefill chunk under
    "chunk", the rest under "decode". Returns the dict it fills."""
    rows = {"chunk": [], "decode": []}
    step_end = eng.obs.step_end

    def capture(st, **kw):
        if kw["worked"]:
            row = {k: v * 1e3 for k, v in st.phases.items()}
            row["step"] = (time.perf_counter() - st.t0) * 1e3
            rows["chunk" if "prefill" in st.phases else "decode"].append(row)
        step_end(st, **kw)

    eng.obs.step_end = capture
    return rows


def phase_means(rows: dict) -> dict:
    """Each phase's mean ms over ``phase_capture``'s steps of a kind (a
    phase a step did not run counts 0), with the step count."""
    out = {}
    for kind, rs in rows.items():
        if rs:
            keys = sorted({k for r in rs for k in r})
            out[kind] = dict(steps=len(rs), **{
                k: float(np.mean([r.get(k, 0.0) for r in rs])) for k in keys})
    return out


def obs_self_time_share(obs) -> float:
    """The hub's own time over the summed step time it recorded."""
    step = obs.h_step.snapshot()["series"].get("", {}).get("sum", 0.0)
    return obs.self_time_s / step if step else float("nan")


def log_serve(out: dict, **extra) -> None:
    """One serve run's figures as a JSON line (streams left out)."""
    log("  serve " + json.dumps({k: v for k, v in dict(out, **extra).items()
                                 if not k.startswith("_")}))


def serve_phase(dev, counters) -> dict:
    """Every path of the port at full width, each counted on its own: at
    OPT-6.7B the plain engine, the predictor engine, the unfused predictor
    FFN on one layer, ops.sparse_ffn_apply and the per-token / window score
    kernels' entry points; then, with OPT-6.7B freed, the MoE paths at
    Mixtral-8x22B (``moe_serve``). Returns the launches of each kernel
    summed over the paths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_ffn as kff
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparse_matmul as ksm
    from repro_torch.models import transformer as T
    from repro_torch.predictor import sign_predictor
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    cfg = get_config("opt-6.7b").replace(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  params initialised in {time.perf_counter() - t0:.1f} s")
    geom = dict(n_slots=8, block_size=16, max_blocks_per_seq=16,
                prefill_chunk=16)
    total = {name: 0 for name in counters}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # -- plain mode: chunked prefill, γ-window reuse ------------------------
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(**geom),
                                   device=dev)
    out, launches = counted(
        "plain serving", counters,
        ("fused_sparse_ffn", "paged_window_attention", "sparse_matmul_tokens"),
        lambda: serve_run(eng, cfg, seed=0))
    add(launches)
    log_serve(out, mode="plain", launches=launches)
    profile_run(eng, cfg, dev, {"prefill": out["prefill_step_ms_median"],
                                "decode": out["decode_step_ms_median"]},
                "plain")
    del eng
    sampled_serve(dev, counters, add, cfg, params, geom, out)

    # -- predictor mode: the sign predictor at a bf16 probe ------------------
    pred = sign_predictor(params, cfg, probe_dtype="bfloat16")
    eng = ContinuousBatchingEngine(cfg, params,
                                   EngineConfig(predictor=pred, **geom),
                                   device=dev)
    out, launches = counted(
        "predictor serving", counters,
        ("fused_sparse_ffn", "paged_window_attention", "sparse_matmul_tokens"),
        lambda: serve_run(eng, cfg, seed=2))
    add(launches)
    out.update(mode="predictor", predictor=pred.describe(),
               predictor_density=eng.predictor_density(),
               predictor_recall=eng.predictor_recall(),
               weight_io_bytes_per_step=eng.weight_io_bytes_per_step(),
               launches=launches)
    log_serve(out)
    if eng.predictor_recall() != 1.0:
        fail(f"sign predictor at the compute dtype missed units: recall "
             f"{eng.predictor_recall()}")
    profile_run(eng, cfg, dev, {"prefill": out["prefill_step_ms_median"],
                                "decode": out["decode_step_ms_median"]},
                "predictor")
    del eng

    # -- the unfused predictor FFN on one full-width layer, 8 tokens ---------
    rng = np.random.RandomState(3)
    pf = {k: v[0] for k, v in params["layers"]["ffn"].items()}
    pred_l = {k: v[0] for k, v in pred.params.items()}
    h = torch.as_tensor(rng.randn(8, cfg.d_model), dtype=torch.bfloat16,
                        device=dev)
    mask = torch.as_tensor(rng.rand(8, cfg.d_ff) < 0.5, device=dev)
    refresh = torch.tensor([True] * 4 + [False] * 4, device=dev)
    kw = dict(kind="sign", tile=128, k_tiles=cfg.d_ff // 128, mask=mask,
              refresh=refresh)
    unfused, launches = counted(
        "unfused predictor FFN", counters,
        ("sparse_up_matmul", "sparse_matmul_tokens"),
        lambda: T._ffn_decode_predicted(pf, h, cfg, pred_l, fused=False, **kw))
    add(launches)
    fused = T._ffn_decode_predicted(pf, h, cfg, pred_l, fused=True, **kw)
    torch.cuda.synchronize()
    df = (unfused[0].float() - fused[0].float()).abs().max().item()
    same_act = torch.equal(unfused[1], fused[1])
    if not same_act or df > TOL_BF16 * fused[0].float().abs().max().item():
        fail(f"unfused vs fused predictor FFN: max|df| {df:.3e}, "
             f"act equal {same_act}")
    log("  unfused predictor FFN " + json.dumps(dict(
        tokens=8, layer=0, max_abs_diff_f_vs_fused=df, act_equal=same_act,
        bit_equal=bool(df == 0 and same_act),
        tile_density=float(unfused[3].mean()),
        unfused_ms=time_ms(lambda: T._ffn_decode_predicted(
            pf, h, cfg, pred_l, fused=False, **kw), reps=10),
        fused_ms=time_ms(lambda: T._ffn_decode_predicted(
            pf, h, cfg, pred_l, fused=True, **kw), reps=10))))

    # -- ops.sparse_ffn_apply at T = 8 and 128, density 0.25 ------------------
    wu, wd = pf["wu"], pf["wd"]
    xs = {T_: torch.as_tensor(rng.randn(T_, cfg.d_model), dtype=torch.bfloat16,
                              device=dev) for T_ in (8, 128)}
    outs, launches = counted(
        "sparse_ffn_apply", counters, ("fused_up_relu", "sparse_matmul"),
        lambda: {T_: kops.sparse_ffn_apply(x, wu, wd, density=0.25, device=dev)
                 for T_, x in xs.items()})
    add(launches)
    for T_, (y, hk, idx, nvalid) in outs.items():
        x = xs[T_]
        # each step checked on the inputs it was given (an f32 rounding at
        # the ReLU edge may move a score, and with it the tile list)
        _, scores = kff.fused_up_relu(x, wu)
        compare(f"sparse_ffn_apply T={T_} h", [hk],
                [kff.fused_up_relu_plain(x, wu)[0]], torch.bfloat16)
        want_i, want_n = kops.select_tiles_static(scores.cpu(), 0.25)
        if idx.cpu().tolist() != want_i.tolist() or int(nvalid) != int(want_n):
            fail(f"sparse_ffn_apply T={T_}: tile list differs from the "
                 f"selection on the CPU")
        compare(f"sparse_ffn_apply T={T_} y", [y],
                [ksm.sparse_matmul_plain(hk.to(x.dtype), wd, idx, nvalid)],
                torch.bfloat16)
        log(f"  sparse_ffn_apply T={T_}: nvalid {int(nvalid)} of "
            f"{idx.numel()} listed tiles, "
            f"{time_ms(lambda: kops.sparse_ffn_apply(x, wu, wd, device=dev), reps=10):.4f} ms")

    # -- the per-token and window score kernels' entry points, layer 0's wu --
    x8 = xs[8]
    x_win = xs[128].reshape(8, 16, cfg.d_model)
    outs, launches = counted(
        "per-token / window scores", counters,
        ("fused_up_relu_tokens", "fused_up_relu_window"),
        lambda: (kff.fused_up_relu_tokens(x8, wu),
                 kff.fused_up_relu_window(x_win, wu)))
    add(launches)
    compare("fused_up_relu_tokens entry point T=8", outs[0],
            kff.fused_up_relu_tokens_plain(x8, wu), torch.bfloat16)
    compare("fused_up_relu_window entry point B=8 W=16", outs[1],
            kff.fused_up_relu_window_plain(x_win, wu), torch.bfloat16)
    del pred, pf, pred_l, wu, wd, xs, x8, x_win, outs, unfused, fused
    torch.cuda.empty_cache()
    spec_serve(dev, counters, add, cfg, params, geom)
    del params
    torch.cuda.empty_cache()

    moe_serve(dev, counters, add)
    log(f"  launches summed over the paths: {json.dumps(total)}")
    return total


def sampled_serve(dev, counters, add, cfg, params, geom, greedy: dict
                  ) -> None:
    """The plain engine on the serve phase's requests with 4 of 8 sampled
    (``serve_sampling``), twice, the second time submitted in a shuffled
    order: the streams must be identical (the keys hang off seed and
    prompt, never the slot or the admission order). Then the greedy
    requests once more, so the two sampled runs sit between two greedy
    ones (``greedy``, run before, and this one), whose streams must be
    identical too; step times and tokens/s of all four. Then the sampling
    head alone at B = 8 over the vocabulary, per call and on the card."""
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    from repro_torch.serving import sampling as smp

    runs = []
    for sampling, order in ((serve_sampling(), None),
                            (serve_sampling(), [5, 2, 7, 0, 3, 6, 1, 4]),
                            (None, None)):
        eng = ContinuousBatchingEngine(cfg, params, EngineConfig(**geom),
                                       device=dev)
        out, launches = counted(
            "sampled plain serving" if sampling else "plain serving again",
            counters, ("fused_sparse_ffn", "paged_window_attention",
                       "sparse_matmul_tokens"),
            lambda: serve_run(eng, cfg, seed=0, sampling=sampling,
                              order=order))
        add(launches)
        runs.append(dict(out, launches=launches))
        del eng
    a, b, again = runs
    if a["_streams"] != b["_streams"] or not np.array_equal(a["_logprobs"],
                                                            b["_logprobs"]):
        fail("sampled serving: shuffled admission changed the streams")
    if again["_streams"] != greedy["_streams"]:
        fail("plain serving: a second greedy run changed the streams")
    if a["_streams"] == greedy["_streams"]:
        fail("sampled serving: the sampled requests kept the greedy streams")
    changed = sum(x != y for x, y in zip(a["_streams"], greedy["_streams"]))
    log_serve(a, mode="plain sampled",
              replay_identical_under_shuffled_admission=True,
              streams_differing_from_greedy=changed,
              shuffled_decode_step_ms_median=b["decode_step_ms_median"],
              shuffled_decode_tokens_per_s=b["decode_tokens_per_s"],
              greedy_decode_step_ms_median=greedy["decode_step_ms_median"],
              greedy_decode_tokens_per_s=greedy["decode_tokens_per_s"],
              greedy_again_decode_step_ms_median=again[
                  "decode_step_ms_median"],
              greedy_again_decode_tokens_per_s=again["decode_tokens_per_s"])

    step_breakdown(dev, cfg, params, geom)

    rng = np.random.RandomState(6)
    B, V = 8, cfg.vocab_size
    logits = torch.as_tensor(rng.randn(B, V) * 3, dtype=torch.bfloat16,
                             device=dev)
    sps = serve_sampling()
    temps = torch.tensor([sp.temperature if sp else 0.0 for sp in sps],
                         device=dev)
    tks = torch.tensor([sp.top_k if sp else 0 for sp in sps], device=dev)
    tps = torch.tensor([sp.top_p if sp else 1.0 for sp in sps], device=dev)
    keys = torch.as_tensor(np.stack([
        smp.request_prng_key([i], sp) if sp else np.zeros(2, np.uint32)
        for i, sp in enumerate(sps)]).astype(np.int64), device=dev)
    head = lambda: smp.sample_head(logits, V, temps, tks, tps, keys)  # noqa: E731
    greedy_head = lambda: smp.greedy_head(logits, V)  # noqa: E731
    want = smp.sample_head(logits.cpu(), V, temps.cpu(), tks.cpu(),
                           tps.cpu(), keys.cpu())
    got = head()
    if got[0].cpu().tolist() != want[0].tolist():
        fail(f"sample_head B={B} V={V}: card tokens {got[0].tolist()} != "
             f"CPU {want[0].tolist()}")
    same_bits(f"sample_head B={B} V={V} tokens", lambda: head()[0])
    log("  sample_head " + json.dumps(dict(
        B=B, V=V, sampled_rows=int((temps > 0).sum()),
        tokens_equal_cpu=True,
        max_abs_dlogprob=(got[1].cpu() - want[1]).abs().max().item(),
        ms=time_ms(head), device_ms=device_ms(head),
        greedy_only_ms=time_ms(greedy_head),
        greedy_only_device_ms=device_ms(greedy_head))))


def step_breakdown(dev, cfg, params, geom) -> None:
    """Where a sampled plain step's time goes beside a greedy one's, on the
    serve phase's requests (``serve_sampling`` against all greedy), prefill
    and decode steps apart. Two passes a traffic, each on a fresh engine:

    - fenced: the card synchronised around each part of the step, so a
      part's time holds its host and its card work: "sampling state"
      (``_sampling``: the scheduler's arrays and their host-to-device
      copies), "model" (the family's model call), "head" (every
      ``_Sampling.head`` call: two in a chunk step that also decodes),
      "record" (the scheduler's record), and "rest" (the step's other
      arrays and copies, the fetch, retirement and admission). Means a
      step, so the parts add up to the step.
    - host profile: cProfile over the same steps with no fences; each
      watched function's cumulative host time a step (a function that
      waits on the card holds that wait) and the functions with the most
      own host time. The profiler slows the host: its step means are
      printed beside."""
    import cProfile
    import pstats
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    from repro_torch.serving import engine as E

    def fence(fn, part, bucket):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            bucket[part] = (bucket.get(part, 0.0)
                            + (time.perf_counter() - t0) * 1e3)
            return r
        return run

    class FencedFamily:
        def __init__(self, fam, bucket):
            self._fam, self._bucket = fam, bucket

        def __getattr__(self, name):
            f = getattr(self._fam, name)
            return (fence(f, "model", self._bucket)
                    if name.startswith("model_") else f)

    def drive(eng, run_step):
        """Step ``eng`` to the end; run_step(kind, eng.step) runs a step."""
        sched = eng.scheduler
        while sched.has_work():
            kind = ("prefill" if sched.prefill_indices() or len(sched.queue)
                    else "decode")
            if not run_step(kind, eng.step):
                break

    watch = {  # name: (file, function)
        "sampling state": ("engine.py", "_sampling"),
        "model": ("dense_family.py", "model_"),
        "head": ("engine.py", "head"),
        "sample_head": ("sampling.py", "sample_head"),
        "filter_logits": ("sampling.py", "filter_logits"),
        "  sort": ("~", "<built-in method torch.sort>"),
        "  cumsum": ("~", "<built-in method torch.cumsum>"),
        "position_keys": ("sampling.py", "position_keys"),
        "categorical": ("prng.py", "categorical"),
        "  threefry2x32": ("prng.py", "threefry2x32"),
        "greedy_head": ("sampling.py", "greedy_head"),
        "fetch (.cpu())": ("~", "<method 'cpu' of 'torch._C.TensorBase' "
                                "objects>"),
        "record": ("scheduler.py", "record"),
        "record_prefill": ("scheduler.py", "record_prefill"),
    }
    head = E._Sampling.head
    for traffic, sampling in (("greedy", None), ("sampled", serve_sampling())):
        # -- fenced pass --------------------------------------------------
        eng = ContinuousBatchingEngine(cfg, params, EngineConfig(**geom),
                                       device=dev)
        submit_requests(eng, cfg, 0, sampling)
        bucket, rows = {}, {"prefill": [], "decode": []}
        eng._sampling = fence(eng._sampling, "sampling state", bucket)
        eng.fam = FencedFamily(eng.fam, bucket)
        sched = eng.scheduler
        for name in ("record", "record_prefill"):
            setattr(sched, name, fence(getattr(sched, name), "record",
                                       bucket))

        def fenced_step(kind, step):
            bucket.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = step()
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            rows[kind].append(dict(bucket, step=total,
                                   rest=total - sum(bucket.values())))
            return ok

        E._Sampling.head = fence(head, "head", bucket)
        try:
            drive(eng, fenced_step)
        finally:
            E._Sampling.head = head
        del eng
        # -- host profile -------------------------------------------------
        eng = ContinuousBatchingEngine(cfg, params, EngineConfig(**geom),
                                       device=dev)
        submit_requests(eng, cfg, 0, sampling)
        profs = {k: cProfile.Profile() for k in rows}
        walls = {k: [] for k in rows}

        def profiled_step(kind, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            profs[kind].enable()
            ok = step()
            torch.cuda.synchronize()
            profs[kind].disable()
            walls[kind].append((time.perf_counter() - t0) * 1e3)
            return ok

        drive(eng, profiled_step)
        del eng
        for kind in ("prefill", "decode"):
            n = len(rows[kind])
            parts = ("sampling state", "model", "head", "record", "rest",
                     "step")
            fenced = {p: float(np.mean([r.get(p, 0.0) for r in rows[kind]]))
                      for p in parts}
            stats = pstats.Stats(profs[kind]).stats
            m = len(walls[kind])
            host, calls = {}, {}
            for label, (file, fn) in watch.items():
                hits = [v for (f, _, name), v in stats.items()
                        if f.endswith(file) and (name == fn or (
                            fn.endswith("_") and name.startswith(fn)))]
                host[label.strip()] = sum(v[3] for v in hits) * 1e3 / m
                calls[label.strip()] = sum(v[1] for v in hits) / m
            top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
            log("  step breakdown " + json.dumps(dict(
                traffic=traffic, kind=kind, steps=n,
                fenced_ms_mean=fenced,
                host_profile_ms_per_step=host,
                host_profile_calls_per_step=calls,
                profiled_step_ms_mean=float(np.mean(walls[kind])),
                top_own_host_ms_per_step=[
                    [f"{Path(f).name}:{ln}({name})", v[2] * 1e3 / m]
                    for (f, ln, name), v in top])))


def spec_serve(dev, counters, add, cfg, params, geom, dcfg=None) -> None:
    """The speculative engine at full width: OPT-6.7B verifying the
    windows of an OPT-1.3B draft (24 layers, the same vocabulary), γ = 4,
    on the serve phase's requests, greedy and with 4 of 8 sampled. Each
    run is counted: the draft's W = 1 steps and the verify windows run
    kernels 2 and 3. With random weights α and s_agg are about 0 (printed,
    not gated)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    dcfg = dcfg or get_config("opt-1.3b").replace(compute_dtype="bfloat16")
    dparams = T.init_params(dcfg, seed=1, device=dev)
    for traffic, sampling in (("greedy", None), ("sampled", serve_sampling())):
        eng = ContinuousBatchingEngine(
            cfg, params, EngineConfig(draft_cfg=dcfg, draft_params=dparams,
                                      gamma=4, **geom), device=dev)
        out, launches = counted(
            f"speculative serving ({traffic})", counters,
            ("paged_window_attention", "sparse_matmul_tokens"),
            lambda: serve_run(eng, cfg, seed=0, sampling=sampling))
        add(launches)
        res = eng.scheduler.results
        prop = sum(r.draft_proposed for r in res.values())
        acc = sum(r.draft_accepted for r in res.values())
        log_serve(out, mode=f"spec {traffic}", draft=dcfg.name,
                  draft_layers=dcfg.n_layers, gamma=4,
                  spec_step_ms_median=out["decode_step_ms_median"],
                  alpha=acc / max(1, prop), draft_proposed=prop,
                  draft_accepted=acc, s_agg_window=eng.s_agg_window(),
                  weight_io_bytes_per_step=eng.weight_io_bytes_per_step(),
                  launches=launches)
        if traffic == "greedy":
            profile_run(eng, cfg, dev,
                        {"prefill": out["prefill_step_ms_median"],
                         "decode": out["decode_step_ms_median"]}, "spec")
        del eng
    del dparams


def moe_serve(dev, counters, add, cfg=None) -> None:
    """Mixtral-8x22B at full width (d = 6144, 48 / 8 heads x 128, 8 experts
    top-2, d_ff = 16384, SiLU GLU, RMSNorm, RoPE, sliding window 4096), 4
    of its 56 layers, bf16, random weights from a seed: the engine in plain
    mode with the OPT-6.7B run's geometry and requests (its attention
    through paged_window_attention), a profiled second batch, then the
    grouped-gather MoE FFN on layer 0 at T = 8 and 128 tokens (the expert
    gather kernels), held against the per-expert dense product."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    cfg = cfg or get_config("mixtral-8x22b").replace(
        n_layers=4, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    params = moe.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"  Mixtral-8x22B (4 of 56 layers) initialised in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB on the card")
    eng = ContinuousBatchingEngine(
        cfg, params, EngineConfig(n_slots=8, block_size=16,
                                  max_blocks_per_seq=16, prefill_chunk=16),
        device=dev)
    out, launches = counted("MoE serving", counters,
                            ("paged_window_attention",),
                            lambda: serve_run(eng, cfg, seed=4))
    add(launches)
    out.update(mode="moe plain", expert_io_fraction=eng.expert_io_fraction(),
               weight_io_bytes_per_step=eng.weight_io_bytes_per_step(),
               launches=launches)
    log_serve(out)
    profile_run(eng, cfg, dev, {"prefill": out["prefill_step_ms_median"],
                                "decode": out["decode_step_ms_median"]},
                "moe plain")
    del eng

    rng = np.random.RandomState(5)
    pm = {k: v[0] for k, v in params["layers"]["moe"].items()}
    xs = {T_: torch.as_tensor(rng.randn(T_, cfg.d_model), dtype=torch.bfloat16,
                              device=dev) for T_ in (8, 128)}
    outs, launches = counted(
        "grouped-gather MoE FFN", counters,
        ("expert_up_matmul", "expert_down_matmul"),
        lambda: {T_: moe.apply_moe_gathered(pm, x, cfg) for T_, x in xs.items()})
    add(launches)
    for T_, y in outs.items():
        x = xs[T_]
        compare(f"grouped-gather MoE FFN T={T_} vs per-expert dense", [y],
                [dense_expert_chain(pm, x, cfg)], torch.bfloat16)
        gathered = lambda: moe.apply_moe_gathered(pm, x, cfg)  # noqa: E731
        einsum = lambda: moe.apply_moe(pm, x, cfg)  # noqa: E731
        log("  grouped-gather MoE FFN " + json.dumps(dict(
            tokens=T_, layer=0,
            gathered_ms=time_ms(gathered, reps=10),
            dispatch_einsum_ms=time_ms(einsum, reps=10),
            gathered_device_ms=device_ms(gathered),
            dispatch_einsum_device_ms=device_ms(einsum))))


def profile_run(eng, cfg, dev, unprofiled: dict, mode: str) -> None:
    """A second batch of 8 requests through the same engine under
    torch.profiler (device activity only): device time by kernel, and the
    device's busy share of the wall time of THAT run — busy time is the
    union of the device intervals the profiler recorded, wall time the
    host clock around the same steps. The profiler slows the host, so this
    share is a lower bound of the unprofiled run's; the profiled step
    medians are printed beside the unprofiled ones (``unprofiled``) to show
    by how much."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # CUPTI start-up cost
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
    rng = np.random.RandomState(1)
    for n in rng.randint(16, 65, size=8):
        eng.submit(rng.randint(0, cfg.vocab_size, n), 16, reuse_window=4)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps = timed_steps(eng)
    wall_ms = sum(steps["prefill"]) + sum(steps["decode"])
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "device_time", None)
            if t is None:
                t = e.cuda_time
            by_name[e.name] = by_name.get(e.name, 0.0) + t / 1e3
            spans.append((e.time_range.start, e.time_range.end))
    busy = 0.0  # union of device intervals, ms
    end = float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += (b - max(a, end)) / 1e3
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log("  profile " + json.dumps({
        "mode": mode,
        "steps": len(steps["prefill"]) + len(steps["decode"]),
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms,
        "kernel_time_sum_ms": sum(by_name.values()),
        "prefill_step_ms_median": float(np.median(steps["prefill"])),
        "decode_step_ms_median": float(np.median(steps["decode"])),
        "unprofiled_prefill_step_ms_median": unprofiled["prefill"],
        "unprofiled_decode_step_ms_median": unprofiled["decode"],
        "top_kernels_ms": [[n[:80], ms] for n, ms in top]}))


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    phases = ap.parse_args(argv).phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import fused_decode as kfd
    from repro_torch.kernels import fused_ffn as kff
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import runtime as rt
    from repro_torch.kernels import sparse_matmul as ksm

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(f"[build] {rt.build():.1f} s")
    results = {}
    if "kernels" in phases:
        log("[kernels]")
        results = kernel_phase(dev)
    if "parity" in phases:
        log("[parity]")
        parity_phase(dev)
    counters = {"fused_sparse_ffn": kfd.fused_sparse_ffn,
                "paged_window_attention": kpa.paged_window_attention,
                "sparse_matmul_tokens": ksm.sparse_matmul_tokens,
                "sparse_up_matmul": ksm.sparse_up_matmul,
                "fused_up_relu": kff.fused_up_relu,
                "sparse_matmul": ksm.sparse_matmul,
                "fused_up_relu_tokens": kff.fused_up_relu_tokens,
                "fused_up_relu_window": kff.fused_up_relu_window,
                "expert_up_matmul": ksm.expert_up_matmul,
                "expert_down_matmul": ksm.expert_down_matmul}
    launches = {name: 0 for name in counters}
    for phase, run in (("api", api_phase), ("serve", serve_phase)):
        if phase in phases:
            log(f"[{phase}]")
            for name, n in run(dev, counters).items():
                launches[name] += n
    if {"api", "serve"} & set(phases):
        for r in results.values():
            r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms")
    line = {"kernels": [{k: r.get(k) for k in keys} for r in results.values()]}
    log(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
