#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # every phase, one card
    python3 chip_smoke.py --phases kernels  # device, build + a subset

Phases, in order (any failure exits non-zero and prints no result line;
device and build always run). Each logs its seconds as "[phase] took";
the first whole run with the examples phase (a slow host, NVIDIA H100
80GB HBM3, 700.00 W; 1078.2 s in all) took: build 22.6, kernels 157.3,
parity 19.3, api 41.4, serve 203.8, examples 19.1, families 63.5, train
93.6, sharded 113.6, data 171.3, fsdp 172.5. After it the sharded and the
data phase's full-width runs went into one rank group each, the data
phase's OPT-6.7B to 8 layers, the train phase to 8 Trainer steps and the
DDP run to 3 + 3 steps. The next whole run (816.8 s) took: build 16.1,
kernels 155.6, parity 17.1, api 34.0, serve 142.9, examples 11.5,
families 43.0, train 83.9, sharded 51.9, data 106.9, fsdp 153.9. With the
gate's no-reuse AR serve and the examples' kernel calls held against
their plain versions (832 s): build 17.5, kernels 150.0, parity 18.4, api
32.9, serve 159.1, examples 12.9, families 49.4, train 82.7, sharded
54.6, data 110.8, fsdp 133.3. With the zoo and plan phases (984.6 s):
build 17.2, kernels 161.1, parity 20.5, api 42.1, serve 172.9, examples
15.8, families 54.8, zoo 31.7, train 78.6, sharded 65.7, data 110.2,
fsdp 164.8, plan 49.2.

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
            shared-list tile groups) at the legacy decode's static-capacity
            shape (OPT-6.7B wd, T = 4, the batch union's top 32 of 128
            tiles, as gathered_matmul passes them; also through
            gathered_matmul against its CPU gather) beside T = 128 and
            T = 8, and on the card at 32 and at 64 columns a block; all also
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
            (drop-free) in whole-prompt and chunked mode. Static tile
            capacities and the legacy ServeEngine (track_sparsity on):
            tiny-relu and tiny-moe generate dense with γ = 3, at
            enable_sparse_serving(cfg, 0.5, 1.0), at (0.5, 0.75) with a
            tile of 16, and there with n_groups = 2 (the one-device
            group-balanced selection, its list cut to tiles of 16 by
            common.rank_tiles: kernel 5 must launch in that case), then
            the continuous engine at (0.5, 1.0), whole and chunked;
            kernel 5 (behind gathered_matmul) must launch.
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
            time by kernel, and the busy share of that run's wall time),
            of ``PROFILE_NEW`` = 4 new tokens a request: a run mostly of
            prefill steps, whose busy share does not compare with one
            taken at 16 new tokens a request.
            The serving roofline gate (launch/roofline.py): its AR
            record from a new plain engine that serves the reference's
            three prompts with no reuse window (counted), its predictor
            record from the predictor run; then its ``roofline`` line:
            per mode the measured, modeled and counted FFN weight bytes a
            decode step (the count: one frozen decode step's
            down-projection matmuls on "meta" tensors of the engine's
            shapes, x 2 projections; dense in AR mode, x the predictor's
            tile density in predictor mode), the density, t_mem(H100) at
            3.35 TB/s, and the card's name and power limit; the run fails
            on any check_serving violation at tol 0.15. Then the unfused predictor FFN on one layer for 8 tokens;
            ops.sparse_ffn_apply at T = 8 and 128, density 0.25; the
            per-token and window score kernels on layer 0. Sampled serving:
            the plain engine with 4 of the 8 requests sampled, twice, the
            second time submitted in a shuffled order (the streams must be
            identical), and the sampling head alone at B = 8 over the
            vocabulary. Speculative serving: OPT-6.7B verifying an OPT-1.3B
            draft (24 layers, full width), γ = 4, greedy and sampled
            (step ms, tokens/s, α, s_agg, weight bytes a step, peak
            memory). The legacy ServeEngine at OPT-6.7B (4 prompts of 32
            tokens, 16 new): dense, γ = 4 with track_sparsity, and
            --sparse-density 0.25 (relufy_stage2, capacities 0.25 / 0.75:
            kernel 5 on q, k, v, wu and wd), each with its decode step
            ms, tokens/s, peak memory, modeled weight bytes a layer and
            kernel 5's launches. Then, OPT-6.7B
            freed, Mixtral-8x22B with 4 of its 56 layers: the engine in
            plain mode with the same geometry and requests (and a profiled
            batch), and the grouped-gather MoE FFN on layer 0 at T = 8 and
            128, timed per call and on the card beside the dispatch
            einsums.
7. examples the three port examples' main() on the card, counted:
            examples/quickstart_torch.py (kernels 6 and 5 against the same
            call on CPU tensors, within TOL_F32), serve_sparse_torch.py
            (trains its model for 30 steps and the draft for 20, then
            serves it in plain, γ-reuse, speculative and predictor mode:
            kernels 1, 2 and 3) and train_relufication_torch.py (30 + 20
            + 20 Trainer steps; no kernel); then launch.roofline --serving
            --check at tiny-relu f32 on the card. The first call of each
            shape of kernels 1, 2 and 3 in these runs (bf16 at d_model 96
            and head dim 16, the tile-1 predictor's kernel 1, f32 at
            tiny-relu) is kept and, after the runs, held against its
            plain version on the same inputs (TOL_BF16 / TOL_F32).
8. families the four other model families through the legacy ServeEngine
            (their registry entries declare no paged serving), with the
            launch counts set to 0 before each run and read after it.
            f32 parity: the smoke configs of falcon-mamba-7b (Mamba-1),
            zamba2-7b (Mamba-2 + a shared attention block), whisper-small
            (encoder-decoder, stub frames) and internvl2-1b (stub vision
            patches), seeded params, 4 prompts x 8 new tokens, card
            against CPU, dense and relufied to stage 2 at static
            capacities 0.5 / 0.75 with a tile of 16 (kernel 5 must launch
            as often as the decode steps' gathered products count). Full
            width and depth, bf16, random weights from a seed: each model
            (64, 81 + 13 shared, 12 + 12, 24 layers; 1500 stub frames, 256
            stub patches) with 4 prompts of 32 tokens and 16 new, dense and
            relufied at 0.25 / 0.75: prefill ms, decode step ms ((generate -
            prefill) / 16), tokens/s, peak GiB, one decode step per call
            and on the card, the modeled weight bytes of a step, and kernel
            5's launches (16 x the gathered products of a step; none in
            the dense run). Then kernel 5 at the four gathered
            down-projections (T = 4, the top tiles at 0.25): timed per
            call and on the card against its bound, the plain version and
            x @ w.
9. zoo      the five assigned configs (Qwen3-4B, Qwen2-7B, StarCoder2-15B,
            DeepSeek-67B, Phi-3.5-MoE) relufied to stage 2 (ReLU FFN, ReLU
            after every norm), one model on the card at a time, with the
            launch counts set to 0 before each run and read after it.
            Kernels 1-3 at each config's shapes, f32 and bf16, against
            their plain versions (kernel 2 at the served head layout,
            decode W = 1 and a 16-token chunk, and at Qwen2-7B's real
            ratio g = 7 beside its padded g = 8; kernel 1 at T = 8 with
            the config's GLU or MLP and a unit mask, full and half-density
            lists; kernel 3 at 8 slots x 16 rows over (d_ff, d_model); the
            MoE config kernel 2 only), the bf16 rows timed per call and on
            the card beside the bound, the plain version and the library
            call. f32 parity at full width, 2 layers (DeepSeek-67B and
            Phi-3.5-MoE 1), the vocabulary cut to 4096, constant leaves
            (norms, biases) moved off their constants: 3 requests of 24 /
            17 / 9 tokens x 6 new, γ = 2, 16-token chunks, card (kernels)
            against CPU (plain versions) on the same params: tokens
            exactly, logprobs within 1e-4. bf16 serving at full width,
            random weights: Qwen3-4B at 36 layers, Qwen2-7B at 28,
            StarCoder2-15B, DeepSeek-67B and Phi-3.5-MoE at 8 (capacity
            1.25 as registered), the serve phase's 8 requests with γ = 4
            on every other one, 8 slots, blocks of 16, 16-token chunks: a
            dense config must launch kernels 1, 2 and 3, the MoE kernel 2,
            and nothing else; tokens in the vocabulary, logprobs finite;
            step ms, tokens/s, peak GiB, weight bytes a step, launches,
            and Phi's moe_drop_frac over the prompts' whole-prompt forward.
10. train   relufication training and the forward statistics, with the
            launch counts set to 0 before and read after (the path runs
            none of the ten kernels: its forward is dense and the
            reference has no backward kernel, so every count must stay
            0). f32 parity: tiny-relu, tiny-moe and tiny relufied to stage
            2, 3 train steps (2 microbatches, "minimal" remat) card against
            CPU on the same numpy params and batches (loss, grad_norm, lr,
            step_ok; params within 2 lr N, median 1e-6), and a fourth card
            step under set_sync_debug_mode("error"). Full width: llama-7b
            relufied to stage 2, 2 of its 32 layers (0.67 B params; cut
            from 4 for the whole script's time), f32
            masters and bf16 compute, 8 x 1024 tokens of the synthetic
            corpus (vocab 32000), 6 Trainer steps (cut from 12, then 8)
            with async checkpoints every 3: finite losses, none skipped,
            the last 3 below the first; a second Trainer on a copy
            holding only the step-3 checkpoint restores that step's state
            (eval loss equal) and runs to 6, its losses within 1e-2 of the
            first run's; measure_site_sparsity before and after (qkv and up
            sparse), calibrate_shift(0.9) and the shifted model's down
            sparsity. Prints the step's and the host data's median ms,
            tokens/s, peak GiB and MFU (model_flops over 989 TFLOP/s).
11. sharded tensor-parallel serving, ranks sharing the card: each group of
            ranks (sharding/comm.py spawn, one timeout for the group; the
            backend rule picks gloo, since NCCL refuses two ranks on one
            device) builds nothing (the build phase did). f32 parity: the
            CPU tests' cases (tiny-relu / tiny-opt plain whole and
            chunked, spec with a 1-layer draft, sign predictor at tile 1,
            tiny-moe whole and chunked, tiny-relu at static capacities
            0.5 / 0.75, which must launch kernel 5 on every rank) at 2
            ranks, and tiny-relu plain at 4 (its 2 kv heads do not divide
            the model axis; the other cases at 4 are the CPU tests') against the
            one-card engine and the CPU: tokens
            exactly, logprobs within 1e-5, metrics within 1e-9,
            per-device weight bytes the one-card figure / ffn_tp and
            their total over the ranks the one-card figure. Full width,
            bf16, one group of 2 ranks for the three (one group each
            before): OPT-6.7B (4 layers, cut from 8 for the whole
            script's time), Mixtral-8x22B (4 layers) and OPT-6.7B (4
            layers) at static capacities 0.25 / 0.75 (kernel 5 must
            launch on every rank), the serve
            phase's 8 greedy requests: the ranks' streams identical, the
            first prefill's last-position logits within
            TOL_SHARD_LOGITS of the one-card engine's; per rank the
            launches (added to the kernels line), step ms, tokens/s,
            peak GiB, modeled per-device FFN bytes and all-reduces a
            step (count and host ms); kernels 1-3 against their plain
            versions at the rank's shapes on its layer 0. The Mamba-1,
            Zamba-2 and Whisper smoke configs split over "model" through
            the legacy ServeEngine (dense and at static capacities 0.25 /
            0.75, tile 16; f32): the one-card streams against the CPU's
            and the 2 ranks' against the one-card's (tokens exactly,
            logprobs within 1e-5; kernel 5 on every rank in the static
            cases). In the same group of 2 ranks, falcon-mamba-7b (2
            layers), zamba2-7b (6 layers and one shared-block
            application) and whisper-small (2 encoder and 2 decoder
            layers) at full width, bf16, dense and at 0.25 / 0.75
            (``SPLIT_FULL``): 4 prompts of 32 tokens, 16 new; the ranks'
            streams identical, the first prefill's logits and those of
            one decode step after it within TOL_SHARD_LOGITS of one
            card's engine on the same seeded tree, kernel 5 launched 16 x
            ``kernel5_per_step`` times on each rank in the static run
            (kernel 2f, the sequence-sharded attention's fold, 16 x
            ``fold_per_step``) and its first call of each shape held
            against its plain version there; per rank the decode step ms, peak GiB and
            kernel 5's launches.
12. data    the data axis, ranks sharing the card over gloo. Kernel 2's
            partial mode (each data row's pages of a split pool, the
            partial softmax (acc, m, l) instead of o) and its fold: bf16
            at OPT-6.7B decode (8 slots, 32 kv heads x 128, 1536 to 2048
            tokens, the pool's blocks cut in two) and at the full-width
            runs' own shapes (8 slots over 130 blocks: Mixtral decode,
            split into S > 1 page runs, Mixtral and OPT-6.7B 16-token
            chunks), f32 at the parity
            shapes; each half's partials against the plain version, the
            fold of the two against the whole-pool kernel call; timed per
            call and on the card against the bound, the plain version and
            SDPA over the half's keys. f32 parity on (2, 1) and (2, 2)
            meshes (2 and 4 ranks): tiny-relu plain, chunked, static 0.5 /
            0.75, speculative, sign predictor, and tiny-moe at capacity
            1.0 with routing groups of 3 (it drops tokens; a decode
            group spans both rows), 4 slots and 26 pool blocks: streams,
            logprobs and metrics equal the one-device CPU engine's (the
            weight bytes a step the one-card engine's / ffn_tp: their
            scope follows the path), every rank holds 13 blocks and
            launches the partial mode. Full
            width at (2, 1), bf16, one group of 2 ranks for both: OPT-6.7B
            (8 layers, cut from 32, then 16, for the whole script's
            time) and Mixtral-8x22B (4 layers), the serve
            phase's 8 greedy requests, 130 pool
            blocks: the first prefill's logits within TOL_SHARD_LOGITS
            of one card's, argmax equal; one decode step of the 8 slots
            over pages in both halves of the pool (the partial mode, the
            fold and the gathers), each rank's slots' logits within
            TOL_SHARD_LOGITS of one card's; per rank step ms, tokens/s, peak GiB, the pool blocks it holds
            (65), collectives a step by axis with their host ms, launches.
            DDP: llama-7b relufied to stage 2, 2 of 32 layers, 8 x 1024
            tokens a step cut 4 x 1024 a rank, 2 steps uncompressed (step
            1's loss and grad norm within TOL_DDP of one card's
            make_train_step over the same batch in 2 microbatches, the
            same function), then 2 with int8 error feedback (finite,
            falling losses); step ms, collective ms, peak GiB and the
            bytes a rank puts on the wire a step.
13. fsdp    the FSDP + TP train step (train/fsdp.py) and the
            sequence-sharded decode attention, ranks sharing the card over
            gloo, with the launch counts set to 0 before and read after in
            each rank. llama-7b relufied to stage 2, 2 of 32 layers, full
            width (0.67 B params), f32 masters and bf16 compute, on a
            (2, 2) mesh: 3 steps of 8 x 1024 tokens of the synthetic
            corpus in 2 microbatches, "minimal" remat; step 1's loss and
            grad norm within TOL_DDP of one card's make_train_step over
            the same batch, and each rank's param and first-moment blocks
            after step 1 held against the same blocks of that step's
            (saved whole under build/fsdp_one_card/, deleted after, and
            restored through the train specs): at most TOL_FSDP_FLIPS of
            the params more than lr apart (an Adam step moves each by
            about lr·sign(g), so there the gradients' signs differ), none
            more than 2·lr, the first moment within TOL_FSDP_M relative;
            the state saved sharded after step 2
            (checkpoint/manager.py, under build/fsdp_ckpt/, deleted
            after) and restored onto a (1, 2) mesh in a new 2-rank group,
            whose step 3 loss is the (2, 2) run's within TOL_DDP; the
            train path launches no kernel. The step gathers each layer
            where it runs, forward and backward (train/fsdp.py, step 4):
            fsdp.GAUGE's peak (the gathered layer columns alive at once)
            must stay within two layers' columns. Per rank: step ms,
            collectives a step by axis (count, host ms, payload bytes),
            the layer gathers and reductions a step, the gauge's peak
            beside one layer's column, the state's GiB (params + m + v
            blocks) and the peak GiB. The same 4 ranks then build two pod
            meshes (no new rank group) and take one step on each from
            seeded params (FSDP_POD_ROWS, FSDP_POD_MOE): (b) llama-7b as
            above on (2, 2, 1) ("pod", "data", "model"), the same batch
            in 4 microbatches of 2 rows, fewer than the 4 data rows of
            pod × data (the rows split over "data", both pods computing
            them): loss and grad norm within TOL_DDP of one card's step
            at 4 microbatches;
            (a) Phi-3.5-MoE at 1 of its 32 layers, full width (d_model
            4096, 16 experts, d_ff 6400, vocab 32064), f32 masters and
            bf16 compute, on (2, 1, 2): its experts' d_model split over
            pod × data (2 ranks), 4 x 1024 tokens in 2 microbatches of
            2 rows, one a data row; loss within TOL_DDP of one card's
            step, its grad norm and its blocks after the step against
            one card's as above within TOL_FSDP_MOE (bf16 routing ties;
            saved whole under build/fsdp_pod_one_card/, deleted after),
            no kernel launched, the gauge within two layers' columns;
            collectives a step by axis (the pod sums apart), the
            gauge's peak and the peak GiB a rank logged.
            One card's references run before the ranks start. Then, in the
            (1, 2) group, common.decode_attention over a cache whose
            sequence is split over its 2 model ranks, at OPT-6.7B decode
            (8 rows, 32 heads x
            128, S = 2048, bf16; positions in either half and on the
            boundary): within one bf16 ulp of the unsharded call (the
            ulp of each head's output vector's largest |value|), kernel
            2f (the fold) launched; its ms against the unsharded call's.
14. plan    the production cell plan (launch/dryrun.py: one rank of the
            production world runs the cell's step on "meta" tensors)
            held against the card. After (a)'s step on the card its four
            dry runs run side by side, each in a process of its own
            (``launch.dryrun.run_subprocess``):
            (a) qwen3-4b decode_32k, relufied at the sparse cell's 0.60
            FFN tile density, full width and all 36 layers, global batch
            4, mesh (1, 1): on the card the same step (random bf16 weights
            from a seed, a zero cache of 32768 positions) — the weight +
            cache + input bytes the plan holds against
            torch.cuda.memory_allocated after set-up (equal), its planned
            peak against max_memory_allocated over a step (within
            TOL_PLAN_PEAK), the step's temporaries (that peak over the
            held bytes) against the plan's temp_bytes (within
            TOL_PLAN_TEMP of them), the step's ms (CUDA events) against the
            plan's largest t-term (the fraction printed), kernel 5
            counted on the path and its first call held against its
            plain version, and the bytes its 36 launches must move
            (``launch.op_cost.sparse_matmul_cost`` of each call,
            nvalid read off the card) equal to the bytes the dry run
            charges kernel 5 (its record's ``kernels``); (b) the fsdp
            phase's own cell (llama-7b stage
            2, 2 layers, (2, 2), 8 x 1024 tokens in 2 microbatches): the
            collective counts and payload bytes by axis equal to what
            that phase's rank 0 counted in its step 1 (without the fsdp
            phase, its data axis against PR 28's 17 collectives and
            4043390992 bytes); (pod) the fsdp phase's Phi-3.5-MoE cell
            on (2, 1, 2): its data- and pod-axis collective counts and
            payload bytes equal to what that phase's rank 0 counted in
            its step (without the fsdp phase, against POD_MOE_STEP, the
            first card reading); (c) the rows of qwen3-4b train_4k and
            decode_32k (sparse 0.60) on (16, 16) (launch/roofline.py's
            dry-run table).

The line before the last is the kernels JSON object; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity
# f32: only the order of the f32 sums differs from the plain version
TOL_F32 = 1e-5
# bf16 inputs, f32 accumulation: products are exact, but bf16 roundings of
# intermediates (h before the down-projection, p before P@V, the output)
# can fall on either side when the f32 sums differ in their last bits
TOL_BF16 = 1e-2
PHASES = ("kernels", "parity", "api", "serve", "examples", "families",
          "zoo", "train", "sharded", "data", "fsdp",
          "plan")  # device, build always


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else "nvidia-smi failed")


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


def compare(name: str, got, want, dtype, quiet: bool = False) -> float:
    """Max |got - want| over the outputs; fails beyond the dtype's
    tolerance relative to max |want|; logs the pass unless ``quiet``."""
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
    if not quiet:
        log(f"  ok {name}: max|diff| {err:.3e} (max|ref| {scale:.3e}, "
            f"tol {tol})")
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
    from repro_torch.launch.roofline import H100_HBM_BYTES_PER_S
    t_b = n_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def attn_row(q, kp, vp, table, pos, window) -> dict:
    """paged_window_attention's bound (bytes: each needed page of K and V
    once, q, the output, table and pos; operations: 4 hd per valid (row,
    key)), and the kernel's, the plain version's and SDPA's times (SDPA
    over the gathered cache, K and V expanded to the query heads before
    timing, a boolean mask), with the kernel's page runs S."""
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models.common import paged_gather

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
    b_ms, b_by = bound(n_bytes, 4.0 * valid * g * kvp * hd, torch.bfloat16)
    kg = paged_gather(kp, table).repeat_interleave(g, dim=1)
    vg = paged_gather(vp, table).repeat_interleave(g, dim=1)
    keys = torch.arange(kg.shape[2], device=q.device)[None, None, :]
    am = keys <= pos[:, :, None]
    if window:
        am &= keys > pos[:, :, None] - window
    am = am[:, None]                                         # (b, 1, W, S)
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
                                    kpa._sm_count(q.device)))


def ffn_bound(x, F: int, idx, nvalid, n_proj: int) -> tuple:
    """fused_sparse_ffn's bound in bf16 at tile 128 (bytes: the distinct
    listed tiles of its n_proj matrices once, x, the (T, F) f32 unit mask,
    the lists, y and the compact h; operations: the valid slots')."""
    from repro_torch.predictor import predictors as preds
    T, d = x.shape
    nv = nvalid.cpu().numpy()
    distinct = int(preds.covered_tiles(idx, nvalid, F // 128).any(0).sum())
    io = (T * d * 2 + T * F * 4 + idx.numel() * 4 + T * 4 + T * d * 4
          + T * idx.shape[1] * 128 * 4)
    return bound(distinct * 128 * d * 2 * n_proj + io,
                 float(nv.sum()) * 128 * 2 * d * n_proj, torch.bfloat16)


def gather_bound(x, w, idx, nvalid) -> tuple:
    """sparse_matmul_tokens' bound in bf16 at tile 128 (bytes: x, the
    distinct listed tiles of w once, the lists and the (T, D) f32 output;
    operations: the valid slots')."""
    from repro_torch.predictor import predictors as preds
    T, F = x.shape
    D = w.shape[1]
    nv = nvalid.cpu().numpy()
    distinct = int(preds.covered_tiles(idx, nvalid, F // 128).any(0).sum())
    return bound(x.numel() * 2 + distinct * 128 * D * 2 + idx.numel() * 4
                 + nv.size * 4 + T * D * 4, float(nv.sum()) * 128 * D * 2,
                 torch.bfloat16)


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
    from repro_torch.models import common as cm
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
    b_ms, b_by = ffn_bound(x, 16384, idx, nvalid, 2)  # gate + down tiles
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
    g_ms, g_by = ffn_bound(gx, 16384, gidx, gnv, 3)
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

    attn_at = {}
    for name, (a_, window) in attn_timed.items():
        attn_at[name] = dict(max_abs_err=errs.get(name, errs[torch.bfloat16]),
                             **attn_row(*a_[:5], window))
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
    b_ms, b_by = gather_bound(x, w, idx, nvalid)
    at = {}
    for name, (err, (xa, wa, ia, na)) in extra.items():
        ba = gather_bound(xa, wa, ia, na)
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
    # the legacy decode's down-projection at static capacity 0.25 (the
    # served shape): OPT-6.7B wd, 4 rows of relu activations, the batch
    # union's top 32 of 128 tiles with nvalid = mask.sum(), as
    # common.gathered_matmul passes them
    h4 = torch.relu(t(rng.randn(4, 16384), torch.bfloat16))
    w4 = t(rng.randn(16384, 4096) / 128.0, torch.bfloat16)
    i4, m4 = cm.select_active_tiles(cm.tile_scores(h4, 128), 0.25)
    n4 = m4.sum(dtype=torch.int32)
    args4 = (h4, w4, i4, n4)
    err4 = compare("sparse_matmul legacy decode T=4 K=32 of 128 bf16",
                   [ksm.sparse_matmul(*args4)],
                   [ksm.sparse_matmul_plain(*args4)], torch.bfloat16)
    compare("gathered_matmul legacy decode T=4 (kernel 5) vs the CPU gather",
            [cm.gathered_matmul(h4, w4, i4, m4, 128)],
            [cm.gathered_matmul(h4.cpu(), w4.cpu(), i4.cpu(), m4.cpu(),
                                128).to(dev)],
            torch.bfloat16)
    # the same decode's input-side gathers at static input capacity 0.75:
    # one selection over 4 relu(norm) rows, the top 24 of the 32 d_model
    # tiles, shared by the q, k and v products (D = 4096) and by wu
    # (D = 16384); all but the wd launches of the served static run
    xi = torch.relu(t(rng.randn(4, 4096), torch.bfloat16))
    ii, mi = cm.select_active_tiles(cm.tile_scores(xi, 128), 0.75)
    ni = mi.sum(dtype=torch.int32)
    if int(ni) != 24:
        fail(f"legacy decode input selection: nvalid {int(ni)} != 24")
    inputs_rows = {}
    for what, D_ in (("qkv", 4096), ("wu", 16384)):
        wi = t(rng.randn(4096, D_) / 64.0, torch.bfloat16)
        a_ = (xi, wi, ii, ni)
        err_i = compare(f"sparse_matmul legacy decode {what} T=4 K=24 of 32 "
                        f"D={D_} bf16", [ksm.sparse_matmul(*a_)],
                        [ksm.sparse_matmul_plain(*a_)], torch.bfloat16)
        compare(f"gathered_matmul legacy decode {what} D={D_} (kernel 5) vs "
                f"the CPU gather", [cm.gathered_matmul(xi, wi, ii, mi, 128)],
                [cm.gathered_matmul(xi.cpu(), wi.cpu(), ii.cpu(), mi.cpu(),
                                    128).to(dev)], torch.bfloat16)
        same_bits(f"sparse_matmul {what} D={D_}",
                  lambda: ksm.sparse_matmul(*a_))
        n_bytes = 4 * 24 * 128 * 2 + 24 * 128 * D_ * 2 + 24 * 4 + 4 + 4 * D_ * 4
        b_ms, b_by = bound(n_bytes, 2.0 * 4 * 24 * 128 * D_, torch.bfloat16)
        inputs_rows[what] = dict(
            max_abs_err=err_i, shape=f"T=4 F=4096 D={D_}, 24 of 32 tiles "
                                     f"(density 0.75) bf16",
            **timings(lambda: ksm.sparse_matmul(*a_),
                      lambda: ksm.sparse_matmul_plain(*a_),
                      lambda: xi @ wi),
            bound_ms=b_ms, bound_by=b_by)
        del wi, a_
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
    for T_, (xa, wa, ia, na) in ((4, args4), (128, args), (8, args8)):
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
        max_abs_err=err4, **sm_rows[4],
        shape="legacy decode T=4 F=16384 D=4096, 32 of 128 tiles "
              "(density 0.25) bf16",
        max_abs_err_f32=errs[torch.float32],
        at_T128=dict(sm_rows[128], max_abs_err=errs[torch.bfloat16]),
        at_T8=sm_rows[8], at_legacy_qkv=inputs_rows["qkv"],
        at_legacy_wu=inputs_rows["wu"])

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
    _, dispatch, _, (_, _, cap), (topi, topv), _ = moe._route(pm, x, cfg)
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
        _, _, _, _, (topi, _), _ = moe._route(pm, x, cfg)
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


def same_streams(what: str, got, want, tol: float = 1e-5) -> float:
    """Fails unless the (streams, logprobs) pairs agree (the card's against
    the CPU's, or two paths on the card): tokens exactly, logprobs within
    ``tol``; returns the largest logprob difference."""
    if got[0] != want[0]:
        fail(f"{what}: streams {got[0]} != {want[0]}")
    d = float(np.max(np.abs(got[1] - want[1])))
    if d > tol:
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
    static_parity(dev)


def legacy_generate(cfg, params, device, toks, reuse: int):
    """``ServeEngine.generate`` of 12 tokens over the (b, s) batch ``toks``
    with ``track_sparsity`` (every step a stats step) and γ = ``reuse``."""
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, params, max_len=48, track_sparsity=True,
                      device=device)
    return eng.generate({"tokens": toks}, max_new=12, reuse_window=reuse)


GROUPED = "static 0.5 / 0.75, tile 16, 2 groups"


def static_parity(dev) -> None:
    """The legacy ServeEngine and static tile capacities, f32 greedy, card
    (kernel 5 behind gathered_matmul) against CPU (the plain gather), on
    tiny-relu and tiny-moe: ``generate`` dense with γ = 3, at
    ``enable_sparse_serving(cfg, 0.5, 1.0)`` (the FFN down-projection keeps
    1 of 2 tiles; tiny-moe's experts have no capacity, so only its
    attention runs there) and at (0.5, 0.75) with a tile of 16 (QKV inputs
    gathered too, so tiny-moe reaches kernel 5), and there with
    ``n_groups=2`` (``GROUPED``: the group-balanced selection, its list
    cut to tiles of 16 by ``common.rank_tiles`` and run through kernel 5,
    which must launch in it); then the continuous engine at (0.5, 1.0),
    whole-prompt and chunked. Tokens exactly, logprobs within 1e-5; fails
    unless kernel 5 launched."""
    from repro_torch.configs import get_config
    from repro_torch.core import relufication as rf
    from repro_torch.kernels import sparse_matmul as ksm

    n0 = ksm.sparse_matmul.launches
    for name in ("tiny-relu", "tiny-moe"):
        base = get_config(name).replace(compute_dtype="float32")
        p_cpu = numpy_params(base, seed=0)
        p_dev = _to(p_cpu, dev)
        toks = np.random.RandomState(6).randint(0, base.vocab_size, (3, 10))
        half = rf.enable_sparse_serving(base, 0.5, 1.0)
        for what, cfg, reuse in (
                ("dense, reuse_window=3", base, 3),
                ("static 0.5 / 1.0", half, 0),
                ("static 0.5 / 0.75, tile 16", rf.enable_sparse_serving(
                    base.replace_sparsity(tile_size=16), 0.5, 0.75), 0),
                (GROUPED, rf.enable_sparse_serving(
                    base.replace_sparsity(tile_size=16, n_groups=2), 0.5,
                    0.75), 0)):
            k0 = ksm.sparse_matmul.launches
            want = legacy_generate(cfg, p_cpu, "cpu", toks, reuse)
            got = legacy_generate(cfg, p_dev, dev, toks, reuse)
            if what == GROUPED and ksm.sparse_matmul.launches == k0:
                fail(f"legacy {name} {what}: the group-balanced selection "
                     f"never launched kernel 5")
            d = same_streams(f"legacy {name} {what}",
                             (got.tokens.tolist(), got.logprobs),
                             (want.tokens.tolist(), want.logprobs))
            sites = {k: abs(v - want.site_sparsity[k])
                     for k, v in got.site_sparsity.items()}
            log(f"  ok parity legacy {name} {what}: {got.tokens.size} tokens "
                f"identical, max|dlogprob| {d:.2e}, kernel 5 launches "
                f"{ksm.sparse_matmul.launches - k0}, max|dsite sparsity| "
                f"{max(sites.values()):.2e}")
        prompts = [np.random.RandomState(s).randint(0, base.vocab_size, n)
                   for s, n in ((1, 9), (2, 5), (3, 13))]
        for chunk in (0, 4):
            k0 = ksm.sparse_matmul.launches
            want, lp_want, _ = serve_streams(half, p_cpu, "cpu", prompts, chunk)
            got, lp_got, _ = serve_streams(half, p_dev, dev, prompts, chunk)
            d = same_streams(f"continuous {name} static 0.5 / 1.0 "
                             f"chunk={chunk}", (got, lp_got), (want, lp_want))
            log(f"  ok parity continuous {name} static 0.5 / 1.0 "
                f"prefill_chunk={chunk}: {sum(map(len, got))} tokens "
                f"identical, max|dlogprob| {d:.2e}, kernel 5 launches "
                f"{ksm.sparse_matmul.launches - k0}")
    if ksm.sparse_matmul.launches == n0:
        fail("static capacities on the card never launched kernel 5")

    grouped_product_check(dev)


def grouped_product_check(dev) -> None:
    """One group-balanced static product on the card (kernel 5 over the
    ``rank_tiles`` list) against the reference's gather and einsum on the
    same inputs on the CPU: OPT-6.7B's down-projection (F = 16384 in 4
    groups of 1024-unit tiles, cut to 128) at T = 4, density 0.25, bf16
    (TOL_BF16); each of the 4 rows has a third of its tiles all zero."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import sparse_matmul as ksm
    from repro_torch.models import common as cm

    cfg = get_config("opt-6.7b").replace_sparsity(n_groups=4)
    rng = np.random.RandomState(11)
    F, D = cfg.d_ff, cfg.d_model
    x = rng.randn(4, F).astype(np.float32) * (rng.rand(4, F) < 0.5)
    x.reshape(4, F // 128, 128)[:, rng.rand(F // 128) < 1 / 3] = 0.0
    x = torch.as_tensor(x, dtype=torch.bfloat16)
    w = torch.as_tensor(rng.randn(F, D) / 128.0, dtype=torch.bfloat16)
    want = cm.maybe_sparse_matmul(x, w, cfg, 0.25)
    n0 = ksm.sparse_matmul.launches
    got = cm.maybe_sparse_matmul(x.to(dev), w.to(dev), cfg, 0.25)
    torch.cuda.synchronize()
    if ksm.sparse_matmul.launches != n0 + 1:
        fail("the grouped static product did not launch kernel 5 once")
    compare("grouped static product OPT-6.7B wd T=4, 4 groups, 0.25",
            [got.cpu()], [want], torch.bfloat16)


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
    ``expect`` launched; logs the launches and fn's seconds. Returns (fn's
    result, {kernel: launches})."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    for name in expect:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {path} path")
    log(f"  launches on the {path} path ({secs:.1f} s): "
        f"{json.dumps(launches)}")
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


def submit_requests(eng, cfg, seed: int, sampling=None, order=None,
                    reuse=None):
    """The serve phase's 8 requests (``serve_prompts``, 16 new tokens each,
    γ = 4) submitted to ``eng``. ``sampling`` gives each request its
    SamplingParams (None: greedy); ``order`` permutes the order of
    submission; ``reuse`` gives each request its γ (None: 4 for all).
    Returns (prompt lengths, sampling, {request: uid})."""
    prompts = serve_prompts(cfg, seed)
    lens = np.array([len(p) for p in prompts])
    sampling = sampling or [None] * 8
    reuse = reuse or [4] * 8
    uids = {}
    for i in (order if order is not None else range(8)):
        uids[i] = eng.submit(prompts[i], 16, reuse_window=reuse[i],
                             sampling=sampling[i])
    return lens, sampling, uids


def serve_run(eng, cfg, seed: int, sampling=None, order=None,
              reuse=None) -> dict:
    """``submit_requests``' requests through ``eng`` to completion, with
    step timings and peak memory. The streams, by request, come back under
    "_streams". In speculative mode every step after admission is a spec
    step, and the decode tokens/s counts the tokens the steps emitted."""
    dev = eng.device
    lens, sampling, uids = submit_requests(eng, cfg, seed, sampling, order,
                                           reuse)
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


def roofline_record(mode: str, eng) -> dict:
    """The serving roofline gate's record (launch/roofline.py) of a served
    full-width engine: measured and modeled FFN weight bytes a decode
    step, and the count of one frozen decode step's down-projection
    matmul operands on "meta" tensors of the engine's shapes (no card
    memory) times the mode's projections. As in the reference, the count
    is the anchor as it stands in AR mode, whose engine served with no
    reuse window (``roofline_ar_serve``: the engine's own accounting must
    come to a dense step), and is scaled by the predictor's tile density
    in predictor mode, where the gate checks geometry and scale only."""
    from repro_torch.launch import roofline as rl
    cfg = eng.cfg
    t0 = time.perf_counter()
    dense = rl.counted_decode_ffn_bytes(eng, 3 if cfg.ffn_kind == "glu" else 2)
    rec = rl.serve_record(mode, cfg.name, eng, dense if mode == "ar"
                          else eng.predictor_density() * dense)
    rec.update(layers=cfg.n_layers, dtype=cfg.compute_dtype,
               counted_dense_bytes=dense,
               count_s=time.perf_counter() - t0)
    return rec


def roofline_ar_serve(dev, counters, add, cfg, params, geom) -> dict:
    """The gate's AR record: the reference's three prompts
    (``launch.roofline.PROMPTS``), 8 new tokens each, no reuse window,
    through a new plain engine of ``geom``, counted."""
    from repro_torch.launch import roofline as rl
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(**geom),
                                   device=dev)
    for s, n in rl.PROMPTS:
        eng.submit(np.random.RandomState(s).randint(0, cfg.vocab_size, n), 8)
    _, launches = counted("roofline AR serving (no reuse)", counters,
                          ("fused_sparse_ffn", "paged_window_attention"),
                          eng.run)
    add(launches)
    return roofline_record("ar", eng)


def roofline_gate(recs, tol: float = 0.15) -> None:
    """One ``roofline`` line (the records, t_mem(H100), the card); fails on
    any violation of ``check_serving`` at ``tol``."""
    from repro_torch.launch import roofline as rl
    log("  roofline " + json.dumps(dict(card=card_name(), tol=tol,
                                        records=recs)))
    bad = rl.check_serving(recs, tol)
    if bad:
        fail("roofline gate: " + "; ".join(bad))
    log(f"  ok roofline gate at tol {tol}: modeled and counted within "
        f"1±{tol} of measured in {len(recs)} modes")


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
    roofline = [roofline_ar_serve(dev, counters, add, cfg, params, geom)]
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
    roofline.append(roofline_record("predictor", eng))
    roofline_gate(roofline)
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
    legacy_serve(dev, counters, add, cfg, params)
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


def legacy_weight_bytes(cfg, dens_in: float, dens_ffn: float) -> float:
    """Modeled weight bytes a layer reads in a legacy decode step at static
    tile capacities (dens_in, dens_ffn), as the reference's
    apply_attn_decode and apply_ffn gather: q, k, v, wu (and wg) read their
    top ceil(dens_in * n) of the n input tiles, wd its top
    ceil(dens_ffn * n) hidden tiles, wo all of its rows."""
    import math

    from repro_torch.models.transformer import attn_geometry

    g, tile = attn_geometry(cfg), cfg.sparsity.tile_size
    item = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)).element_size()

    def rows(n, dens):  # the rows of a product over n input units read
        return n if dens >= 1.0 else max(1, math.ceil(dens * (n // tile))) * tile

    n_up = 2 if cfg.ffn_kind == "glu" else 1
    cols_in = (g.hp + 2 * g.kvp) * g.head_dim + n_up * cfg.d_ff
    return item * (rows(cfg.d_model, dens_in) * cols_in
                   + g.hp * g.head_dim * cfg.d_model
                   + rows(cfg.d_ff, dens_ffn) * cfg.d_model)


def legacy_serve(dev, counters, add, cfg, params) -> None:
    """The legacy single-batch ServeEngine at OPT-6.7B full width (32
    layers, bf16), 4 prompts of 32 tokens, 16 new tokens: dense; γ = 4
    with track_sparsity (every step a stats step); and --sparse-density
    0.25 (relufy_stage2, then enable_sparse_serving(cfg, 0.25, 0.75): q,
    k, v and wu gather 24 of 32 input tiles, wd 32 of 128 hidden tiles,
    all through kernel 5). Each run is warmed once, then counted and timed:
    the decode step is (generate - prefill) / 16 on the host clock with
    the card synchronised; tokens/s, peak memory, the modeled weight bytes
    a layer and kernel 5's launches are printed, and one decode step
    without statistics alone: per call (time_ms) and on the card
    (device_ms, a CUDA graph replay)."""
    from repro_torch.core import relufication as rf
    from repro_torch.serving import ServeEngine

    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (4, 32))
    static = rf.enable_sparse_serving(rf.relufy_stage2(cfg), 0.25, 0.75)
    for what, c, reuse, track, expect in (
            ("dense", cfg, 0, False, ()),
            ("reuse_window=4, track_sparsity", cfg, 4, True, ()),
            ("static 0.25 / 0.75", static, 0, False, ("sparse_matmul",))):
        eng = ServeEngine(c, params, max_len=48, track_sparsity=track,
                          device=dev)
        batch = {"tokens": toks}

        def gen():
            return eng.generate(batch, max_new=16, reuse_window=reuse)

        gen()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        a = time.perf_counter()
        res, launches = counted(f"legacy serve {what}", counters, expect, gen)
        gen_ms = (time.perf_counter() - a) * 1e3
        add(launches)
        a = time.perf_counter()
        with torch.inference_mode():
            _, cache = eng.prefill(batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - a) * 1e3
        with torch.inference_mode():  # one plain decode step, fenced alone
            tok = torch.as_tensor(res.tokens[:, 0], device=dev)
            pos = torch.full((4,), 32, dtype=torch.int32, device=dev)
            step = lambda: eng.decode(cache, tok, pos)  # noqa: E731
            call_ms, card_ms = time_ms(step, reps=10), device_ms(step)
        if (res.tokens.shape != (4, 16) or res.tokens.min() < 0
                or res.tokens.max() >= c.vocab_size
                or not np.isfinite(res.logprobs).all()
                or (res.logprobs > 0).any()):
            fail(f"legacy serve {what}: bad tokens or logprobs")
        step_ms = (gen_ms - prefill_ms) / 16
        dens_in, dens_ffn = ((0.75, 0.25) if c.sparsity.enabled
                             else (1.0, 1.0))
        out = dict(mode=f"legacy {what}", batch=4, prompt=32, new_tokens=16,
                   generate_ms=gen_ms, prefill_ms=prefill_ms,
                   decode_step_ms=step_ms, decode_tokens_per_s=4e3 / step_ms,
                   decode_call_ms=call_ms, decode_device_ms=card_ms,
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                   modeled_weight_mb_per_layer=legacy_weight_bytes(
                       c, dens_in, dens_ffn) / 1e6,
                   kernel5_launches=launches["sparse_matmul"])
        if track:
            if not 0.0 <= res.aggregated.aggregated_sparsity() <= 1.0:
                fail("legacy serve: aggregated sparsity out of [0, 1]")
            out.update(site_sparsity=res.site_sparsity,
                       aggregated_sparsity=res.aggregated.aggregated_sparsity())
        log("  serve " + json.dumps(out))
        del eng


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


def device_times(prof):
    """(busy ms: the union of the device intervals a torch.profiler run
    recorded, {kernel name: device ms})."""
    from torch.autograd import DeviceType

    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "device_time", None)
            if t is None:
                t = e.cuda_time
            by_name[e.name] = by_name.get(e.name, 0.0) + t / 1e3
            spans.append((e.time_range.start, e.time_range.end))
    busy = 0.0
    end = float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += (b - max(a, end)) / 1e3
            end = b
    return busy, by_name


# new tokens a request of the profiled batch (cut from 16, where parsing
# the profiler's events made most of the serve phase: 197.8 s with 16,
# 109.3 s with 4 on an H100). Its busy share and device time by kernel
# are those of a run mostly of prefill steps, not comparable with
# readings taken at 16
PROFILE_NEW = 4


def profile_run(eng, cfg, dev, unprofiled: dict, mode: str) -> None:
    """A second batch of 8 requests (``PROFILE_NEW`` new tokens each, so
    mostly prefill steps: the share does not compare with a batch of 16
    new tokens a request) through the same engine under torch.profiler
    (device activity only):
    device time by kernel, and the device's busy share of the wall time of THAT run — busy time is the
    union of the device intervals the profiler recorded, wall time the
    host clock around the same steps. The profiler slows the host, so this
    share is a lower bound of the unprofiled run's; the profiled step
    medians are printed beside the unprofiled ones (``unprofiled``) to show
    by how much."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # CUPTI start-up cost
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
    rng = np.random.RandomState(1)
    for n in rng.randint(16, 65, size=8):
        eng.submit(rng.randint(0, cfg.vocab_size, n), PROFILE_NEW,
                   reuse_window=4)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps = timed_steps(eng)
    wall_ms = sum(steps["prefill"]) + sum(steps["decode"])
    busy, by_name = device_times(prof)
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


# ---------------------------------------------------------------------------
# phase 7: the port's examples

EXAMPLE_RUNS = (
    ("quickstart", [], ("fused_up_relu", "sparse_matmul")),
    ("serve_sparse", ["--train-steps", "30", "--draft-steps", "20"],
     ("fused_sparse_ffn", "paged_window_attention", "sparse_matmul_tokens")),
    ("train_relufication", ["--steps", "30", "--finetune-steps", "20"], ()),
)


def _floats(tree):
    """The float leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _floats(v)
    elif isinstance(tree, float):
        yield tree


def load_example(name: str):
    """``examples/<name>_torch.py``'s ``main``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


# the kernels the examples' serving reaches: (module, wrapper); each
# wrapper's plain version is ``<wrapper>_plain`` with the same arguments
EXAMPLE_HELD = (("fused_decode", "fused_sparse_ffn"),
                ("paged_attention", "paged_window_attention"),
                ("sparse_matmul", "sparse_matmul_tokens"))


def _signature(args, kwargs) -> tuple:
    """A call's shapes and dtypes, and its other arguments."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return tuple(v.shape), str(v.dtype)
        return repr(v)
    return (tuple(one(a) for a in args),
            tuple(sorted((k, one(v)) for k, v in kwargs.items())))


class _Keeping:
    """A kernel wrapper that keeps its first call of each ``_signature`` in
    ``calls`` (tensors cloned before the call), then calls the wrapper.
    Attributes are the wrapper's: it counts ``launches`` on itself through
    its module's name, which this object takes while it stands there."""

    def __init__(self, fn, key, calls):
        object.__setattr__(self, "_own", (fn, key, calls))

    def __call__(self, *args, **kwargs):
        fn, key, calls = self._own
        k = key + (_signature(args, kwargs),)
        if k not in calls:
            calls[k] = (tuple(a.clone() if isinstance(a, torch.Tensor) else a
                              for a in args),
                        {n: v.clone() if isinstance(v, torch.Tensor) else v
                         for n, v in kwargs.items()})
        return fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._own[0], name)

    def __setattr__(self, name, value):
        setattr(self._own[0], name, value)


class _Recording(_Keeping):
    """A kernel wrapper that appends every call's (args, kwargs) to its
    list (the tensors themselves, not copies), then calls the wrapper."""

    def __call__(self, *args, **kwargs):
        fn, _, calls = self._own
        calls.append((args, kwargs))
        return fn(*args, **kwargs)


@contextlib.contextmanager
def first_calls(held=EXAMPLE_HELD):
    """While open, each wrapper of ``held`` stands in its kernels module
    (where the models look it up) as a ``_Keeping``; yields
    {(module, wrapper, signature): (args, kwargs)}. The wrapper runs and
    counts its launches as before."""
    import importlib
    calls, saved = {}, []
    for m, name in held:
        mod = importlib.import_module(f"repro_torch.kernels.{m}")
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, _Keeping(fn, (mod.__name__, name), calls))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_first_calls(calls) -> dict:
    """Each call ``first_calls`` kept, through its kernel and its plain
    version on the same inputs (TOL_F32 for f32 inputs, else TOL_BF16;
    these launches are not counted on any path). Returns, by wrapper, the
    calls held, their dtypes and first arguments' shapes, and the largest
    error relative to max |plain|."""
    import importlib
    out = {}
    for (m, name, sig), (args, kwargs) in calls.items():
        mod = importlib.import_module(m)
        got = getattr(mod, name)(*args, **kwargs)
        want = getattr(mod, f"{name}_plain")(*args, **kwargs)
        got, want = ([got], [want]) if isinstance(got, torch.Tensor) else (
            got, want)
        dtype = args[0].dtype
        err = compare(f"example call {name} {sig[0]}", got, want, dtype,
                      quiet=True)
        scale = max(w.float().abs().max().item() for w in want if w.numel())
        row = out.setdefault(name, dict(calls=0, max_rel_err=0.0,
                                        dtypes=[], first_arg=[]))
        row["calls"] += 1
        row["first_arg"].append(list(sig[0][0][0]))
        row["max_rel_err"] = max(row["max_rel_err"], err / max(scale, 1e-30))
        if str(dtype) not in row["dtypes"]:
            row["dtypes"].append(str(dtype))
    return out


def examples_phase(dev, counters) -> dict:
    """The three port examples' ``main`` on the card at the step counts of
    ``EXAMPLE_RUNS`` (the reference example's 100 / 80 and 120 / 80 cut),
    each counted: the quickstart (kernels 6 and 5 against the same call on
    CPU tensors, within TOL_F32), serve_sparse (a model its Trainer just
    trained, served in plain, γ-reuse, speculative and predictor mode:
    kernels 1, 2 and 3; finite NLLs, predictor recall reported) and
    train_relufication (three Trainer runs; no kernel). Then the gate's
    own command, ``launch.roofline --serving --check``, at tiny-relu f32
    on the card. Returns the launches summed over the runs."""
    from repro_torch.launch import roofline as rl

    total = {name: 0 for name in counters}
    with first_calls() as calls:
        examples_runs(dev, counters, total, rl)
    held = check_first_calls(calls)
    for name in ("fused_sparse_ffn", "paged_window_attention",
                 "sparse_matmul_tokens"):
        if name not in held or "torch.bfloat16" not in held[name]["dtypes"]:
            fail(f"examples: no bf16 call of {name} was held against its "
                 f"plain version")
    log("  ok examples' kernel calls against their plain versions "
        + json.dumps(held))
    log(f"  launches summed over the examples: {json.dumps(total)}")
    return total


def examples_runs(dev, counters, total, rl) -> None:
    """``examples_phase``'s runs, their launches added to ``total``."""
    for name, argv, expect in EXAMPLE_RUNS:
        main_fn = load_example(name)
        t0 = time.perf_counter()
        out, launches = counted(f"example {name}", counters, expect,
                                lambda: main_fn(argv + ["--device", str(dev)]))
        secs = time.perf_counter() - t0
        for k, v in launches.items():
            total[k] += v
        if name == "quickstart" and not out["max_abs_err"] <= TOL_F32:
            fail(f"quickstart: sparse FFN on the card differs from the "
                 f"plain versions by {out['max_abs_err']:.3e}")
        if not all(np.isfinite(v) for v in _floats(out)):
            fail(f"example {name}: a non-finite figure in {out}")
        log(f"  example {name} " + json.dumps(dict(
            argv=argv, seconds=secs,
            **{k: v for k, v in out.items() if k != "sparsity"})))
    t0 = time.perf_counter()
    rc, launches = counted("roofline --serving --check (tiny-relu)", counters,
                           ("fused_sparse_ffn", "paged_window_attention"),
                           lambda: rl.main(["--serving", "--check",
                                            "--device", str(dev)]))
    for k, v in launches.items():
        total[k] += v
    if rc != 0:
        fail(f"launch.roofline --serving --check exited {rc} on the card")
    log(f"  ok roofline --serving --check on the card "
        f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 9: training (relufication fine-tuning) and the forward statistics

# params after N steps, card against CPU: an Adam update is close to
# lr * sign(g), so an entry whose gradient is near zero may move by up to
# 2 lr in one and not the other; the median entry stays within 1e-6
TRAIN_MEDIAN_TOL = 1e-6
# grad_norm after the first step, relative: one tiny-moe expert
# pre-activation can sit inside the f32 rounding of zero, where relu'
# differs (the CPU tests' tolerance)
TRAIN_GRAD_NORM_TOL = {"tiny-moe": 1e-3}


def train_parity(dev, steps: int = 3) -> None:
    """f32 training, card against CPU, on the same numpy params and batches:
    ``steps`` steps of ``make_train_step`` with 2 microbatches and the
    "minimal" remat policy. Loss, lr and step_ok within 1e-5, grad_norm
    within 1e-5 (relative; after the first step tiny-moe's 1e-3), the
    params within max |d| <= 2 lr N and median |d| <= 1e-6. One more card
    step runs under set_sync_debug_mode("error"): the step syncs the host
    nowhere."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import relufication as rf
    from repro_torch.data.pipeline import DataConfig, PackedIterator
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import flatten, tree_map

    lr = 1e-3
    tc = TrainConfig(learning_rate=lr, warmup_steps=2, total_steps=10,
                     num_microbatches=2, remat_policy="minimal")
    f32 = dict(compute_dtype="float32")
    models = {"tiny-relu": get_config("tiny-relu").replace(**f32),
              "tiny-moe": get_config("tiny-moe").replace(**f32),
              "tiny-stage2": rf.relufy_stage2(get_config("tiny").replace(**f32))}
    for i, (name, cfg) in enumerate(models.items()):
        p_cpu = numpy_params(cfg, seed=20 + i)
        p_dev = tree_map(lambda t: t.to(dev), p_cpu)
        o_cpu, o_dev = adamw.init_opt_state(p_cpu), adamw.init_opt_state(p_dev)
        fn = make_train_step(cfg, tc)
        it = PackedIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                       batch_size=4, seed=3 + i))
        for k in range(steps):
            batch = {key: torch.as_tensor(v) for key, v in next(it).items()}
            bd = {key: v.to(dev) for key, v in batch.items()}
            p_cpu, o_cpu, m_cpu = fn(p_cpu, o_cpu, batch)
            p_dev, o_dev, m_dev = fn(p_dev, o_dev, bd)
            for key in ("loss", "grad_norm", "lr", "step_ok"):
                want, got = float(m_cpu[key]), float(m_dev[key])
                tol = (TRAIN_GRAD_NORM_TOL.get(name, TOL_F32)
                       if key == "grad_norm" and k else TOL_F32)
                if not abs(got - want) <= tol * max(1.0, abs(want)):
                    fail(f"train parity {name} step {k + 1} {key}: card "
                         f"{got!r} vs CPU {want!r} (tol {tol})")
        # one more card step: no host sync anywhere in it
        bd = {key: torch.as_tensor(v, device=dev) for key, v in next(it).items()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(p_dev, o_dev, bd)
        except RuntimeError as e:
            fail(f"train step {name}: syncs the host ({e})")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        diffs = torch.cat([(a.cpu() - b).abs().reshape(-1) for a, b in
                           zip(flatten((p_dev, o_dev.m)), flatten((p_cpu, o_cpu.m)))])
        worst, median = diffs.max().item(), diffs.median().item()
        if worst > 2 * lr * steps or median > TRAIN_MEDIAN_TOL:
            fail(f"train parity {name}: params/moments max|d| {worst:.3e} "
                 f"(limit {2 * lr * steps:.1e}), median {median:.3e} "
                 f"(limit {TRAIN_MEDIAN_TOL})")
        log(f"  ok train parity {name}: {steps} steps, loss {float(m_dev['loss']):.6f}"
            f" (CPU {float(m_cpu['loss']):.6f}), params max|d| {worst:.3e},"
            f" median {median:.3e}; no host sync in a step")


def site_line(sp: dict) -> str:
    return ", ".join(f"{k} {sp[k]:.4f}" for k in ("mean/qkv", "mean/up",
                                                  "mean/down") if k in sp)


def train_full_width(dev, cfg=None, dc=None, steps: int = 6,
                     ckpt_every: int = 3) -> None:
    """llama-7b relufied to stage 2 at 2 of its 32 layers (d 4096, 32
    heads x 128, d_ff 11008, vocab 32000 padded to 32768, untied): f32
    masters, bf16 compute, ``steps`` steps of the Trainer with async
    checkpoints every ``ckpt_every`` steps. Checks: finite losses, no step
    skipped, the mean of the last 3 losses below the first. A second
    Trainer on a copy holding only the step-``ckpt_every`` checkpoint:
    the restored state's eval loss within 1e-5 (relative) of the first
    run's eval at that step (the same weights, the same held-out rows);
    then it runs on to ``steps``, its optimizer step there and each loss
    within 1e-2 (relative) of the first run's. The stage-2 sites qkv and
    up sparse before and after; calibrate_shift(0.9) finite, and
    shifted_relufy with it raising the down-projection's input sparsity.
    Prints step ms (median, data and step apart), tokens/s, peak GiB, MFU,
    a profile of two steps and the sparsity sites."""
    import shutil

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.core import flops
    from repro_torch.core import relufication as rf
    from repro_torch.core.sparsity import measure_site_sparsity
    from repro_torch.data.pipeline import DataConfig, eval_batches
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import Trainer
    from repro_torch.tree import flatten

    # 2 layers: the checkpoints' I/O is most of the phase's time
    cfg = cfg or rf.relufy_stage2(get_config("llama-7b")).replace(
        n_layers=2, compute_dtype="bfloat16")
    dc = dc or DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                          batch_size=8)
    tc = TrainConfig(num_microbatches=2, remat_policy="minimal",
                     learning_rate=1e-4, warmup_steps=2)
    start = time.perf_counter()

    def stamp(msg: str) -> None:  # seconds since the part began
        log(f"  [{time.perf_counter() - start:.1f} s] {msg}")

    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    log(f"  checkpoints under {root}: {shutil.disk_usage(root).free / 2**30:.0f}"
        " GiB free")
    first, second = root / "first", root / "second"
    quiet = dict(eval_every=ckpt_every, ckpt_every=ckpt_every, device=dev,
                 log=lambda m: log("  " + m))
    evb = {k: torch.as_tensor(v, device=dev)
           for k, v in eval_batches(dc, 1)[0].items()}
    params = [T.init_params(cfg, seed=tc.seed, device=dev,
                            dtype=torch.float32)]
    n = sum(p.numel() for p in flatten(params[0]))
    sp0 = measure_site_sparsity(params[0], evb, cfg)
    stamp(f"llama-7b stage 2, {cfg.n_layers} layers: {n / 1e9:.3f} B params"
          f" (f32 masters); sites before: {site_line(sp0)}")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cfg, tc, dc, ckpt_dir=str(first), **quiet)
        rep = tr.run(steps, params=params.pop())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = rep.losses
        if not np.isfinite(losses).all() or rep.skipped_steps:
            fail(f"train: losses {losses}, skipped {rep.skipped_steps}")
        if not np.mean(losses[-3:]) < losses[0]:
            fail(f"train: the loss did not fall: {losses}")
        step_ms = float(np.median(rep.step_seconds[1:])) * 1e3
        data_ms = float(np.median(rep.data_seconds[1:])) * 1e3
        tokens = dc.batch_size * dc.seq_len
        mf = flops.model_flops(cfg, ShapeConfig("train", "train", dc.seq_len,
                                                dc.batch_size))
        mfu = mf / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
        stamp(f"first run: {steps} steps in {wall:.1f} s; losses "
              f"{[round(x, 4) for x in losses]}; eval {rep.eval_losses}")
        log(f"  train step ms (median of steps 2-{steps}): step {step_ms:.1f}, "
            f"host data {data_ms:.1f}; tokens/s {tokens / (step_ms / 1e3):.0f} "
            f"(step alone), {tokens / ((step_ms + data_ms) / 1e3):.0f} (with "
            f"data); model_flops {mf:.4e}, MFU {mfu:.4f} of 989 TFLOP/s; "
            f"peak {peak:.2f} GiB; stragglers {rep.straggler_steps}; by step "
            f"(ms, data / step): {[(round(d * 1e3, 1), round(t * 1e3, 1)) for d, t in zip(rep.data_seconds, rep.step_seconds)]}")
        profile_train_step(tr, evb, step_ms)
        sp1 = measure_site_sparsity(tr.params, evb, cfg)
        shift = rf.calibrate_shift(tr.params, evb, cfg, target_sparsity=0.9)
        sp2 = measure_site_sparsity(tr.params, evb,
                                    rf.shifted_relufy(cfg, shift))
        stamp(f"sites after: {site_line(sp1)}; calibrate_shift(0.9) = "
              f"{shift:.6f}; shifted: {site_line(sp2)}")
        for when, sp in (("before", sp0), ("after", sp1)):
            if not (sp["mean/qkv"] > 0 and sp["mean/up"] > 0):
                fail(f"train: stage-2 sites not sparse {when}: {sp}")
        if not (np.isfinite(shift) and sp2["mean/down"] > sp1["mean/down"]):
            fail(f"train: shift {shift} gave down {sp2['mean/down']} vs "
                 f"{sp1['mean/down']}")
        eval_at = rep.eval_losses[0]
        del tr
        gc.collect()
        torch.cuda.empty_cache()

        # resume: only the step-ckpt_every checkpoint, hard-linked
        name = f"step_{ckpt_every:010d}"
        shutil.copytree(first / name, second / name, copy_function=os.link)
        shutil.rmtree(first)
        tr = Trainer(cfg, tc, dc, ckpt_dir=str(second), **quiet)
        tr.run(ckpt_every)  # restores, takes no step
        held = tr.eval_loss(tr.params)
        stamp(f"restored step {ckpt_every} in a second Trainer")
        if not abs(held - eval_at) <= TOL_F32 * abs(eval_at):
            fail(f"train resume: eval of the restored step {ckpt_every} "
                 f"{held!r} vs the first run's {eval_at!r}")
        rep2 = tr.run(steps)
        if (rep2.resumed_from, rep2.steps, int(tr.opt_state.step)) != (
                ckpt_every, steps - ckpt_every, steps):
            fail(f"train resume: from {rep2.resumed_from}, {rep2.steps} "
                 f"steps, optimizer step {int(tr.opt_state.step)}")
        # steps 7-12 against the first run's, each within TOL_BF16 of it
        # (relative): bf16 products, the embedding gradient's atomic adds
        # in another order, and other rows (the restarted iterator begins
        # at the next document: the reference drops the packed remainder)
        gap = np.abs(np.subtract(rep2.losses, losses[ckpt_every:]))
        if not (np.isfinite(rep2.losses).all() and
                (gap <= TOL_BF16 * np.abs(losses[ckpt_every:])).all()):
            fail(f"train resume: losses {rep2.losses} vs {losses[ckpt_every:]}"
                 f" (tol {TOL_BF16}, relative)")
        stamp(f"ok resume: step {ckpt_every} eval loss {held!r}, the first "
              f"run's {eval_at!r}; steps {ckpt_every + 1}-{steps} losses "
              f"{[round(x, 4) for x in rep2.losses]}, max |d| {gap.max():.4f}"
              f" to the first run's (tol {TOL_BF16}, relative)")
        del tr
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def profile_train_step(tr, batch, unprofiled_ms: float, n: int = 2) -> None:
    """``n`` more train steps from the trainer's state on ``batch`` (their
    results dropped) under torch.profiler: the device's busy share of
    their wall time and the device time by kernel. The profiler slows
    the host, so the share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):  # CUPTI start-up cost
        tr.step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tr.step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, by_name = device_times(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    log("  profile " + json.dumps({
        "mode": "train", "steps": n, "wall_ms": wall_ms,
        "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
        "kernel_time_sum_ms": sum(by_name.values()),
        "unprofiled_step_ms_median": unprofiled_ms,
        "top_kernels_ms": [[k[:80], ms] for k, ms in top]}))


# ---------------------------------------------------------------------------
# phase 8: the other model families through the legacy ServeEngine

FAMILY_ARCHS = ("falcon-mamba-7b", "zamba2-7b", "whisper-small",
                "internvl2-1b")


def family_batch(cfg, b: int, s: int, seed: int, dev=None) -> dict:
    """Tokens (b, s) and the family's stub input (vision patches / audio
    frames, normal * 0.02 in the compute dtype) from a numpy seed; on
    ``dev`` when given, else numpy."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (b, s))}
    n = {"vlm": cfg.n_vision_tokens, "encdec": cfg.n_audio_frames}.get(
        cfg.family)
    if n:
        stub = (rng.standard_normal((b, n, cfg.d_model)) * 0.02).astype(
            np.float32)
        out["patches" if cfg.family == "vlm" else "frames"] = stub
    if dev is None:
        return out
    cdt = getattr(torch, cfg.compute_dtype)
    return {k: torch.as_tensor(v, device=dev).to(
        cdt if v.dtype == np.float32 else torch.int64)
        for k, v in out.items()}


def kernel5_per_step(cfg) -> int:
    """kernel 5's launches in one legacy decode step at capacities below 1:
    mamba's out_proj a layer; an attention block's q, k, v, the up
    projection(s) and wd (the cross-attention query and the output
    projections stay dense); the hybrid's Mamba-2 out_proj a layer and the
    shared block at each application."""
    from repro_torch.models import hybrid

    block = 3 + (3 if cfg.ffn_kind == "glu" else 2)
    return {"mamba": cfg.n_layers,
            "hybrid": cfg.n_layers + hybrid.n_attn_applications(cfg) * block,
            "encdec": cfg.n_layers * block,
            "vlm": cfg.n_layers * block}[cfg.family]


def family_weight_bytes(cfg, dens_in: float, dens_ffn: float) -> float:
    """Modeled weight bytes one legacy decode step reads at static tile
    capacities (dens_in, dens_ffn): every matrix the step multiplies by
    (norms, biases and per-channel vectors left out) and the unembedding;
    a gathered product reads only its selected input rows
    (``legacy_weight_bytes`` for an attention block). The hybrid reads its
    shared block once per application; the encoder-decoder's decoder adds
    the cross-attention query and output (its cross K/V are cached)."""
    import math

    from repro_torch.models import common as cm
    from repro_torch.models import hybrid
    from repro_torch.models import mamba
    from repro_torch.models.transformer import attn_geometry

    item = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)).element_size()
    tile, d, L = cfg.sparsity.tile_size, cfg.d_model, cfg.n_layers

    def rows(n, dens):
        return n if dens >= 1.0 else max(1, math.ceil(dens * (n // tile))) * tile

    unembed = item * cm.padded_vocab(cfg.vocab_size) * d
    di, st, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    if cfg.family == "mamba":
        dr = mamba.dt_rank(cfg)
        layer = (d * 2 * di + k * di + di * (dr + 2 * st) + dr * di + di * st
                 + rows(di, dens_ffn) * d)
        return item * L * layer + unembed
    block = legacy_weight_bytes(cfg, dens_in, dens_ffn)
    if cfg.family == "hybrid":
        layer = (d * (2 * di + 2 * st + cfg.n_ssm_heads) + k * di
                 + rows(di, dens_ffn) * d)
        return (item * L * layer + hybrid.n_attn_applications(cfg) * block
                + unembed)
    if cfg.family == "encdec":
        g = attn_geometry(cfg)
        return L * (block + item * 2 * g.hp * g.head_dim * d) + unembed
    return L * block + unembed


def gathered_products(cfg, params) -> list:
    """The products a legacy decode step gathers at static capacities, read
    off the params' shapes: (name, input width F, output width D, side),
    side "in" for a product over the block's normed input (q, k, v and the
    up projection(s), at the input tile capacity) and "ffn" for the down
    projection or out_proj (at the FFN tile capacity)."""
    def attn_block(pre, p):
        a, f = p["attn"], p["ffn"]
        out = [(pre + n, a[n].shape[-3], a[n].shape[-2] * a[n].shape[-1],
                "in") for n in ("wq", "wk", "wv")]
        out += [(pre + n, f[n].shape[-2], f[n].shape[-1],
                 "ffn" if n == "wd" else "in")
                for n in ("wg", "wu", "wd") if n in f]
        return out

    name = cfg.name + " "
    if cfg.family in ("mamba", "hybrid"):
        w = params["layers"]["ssm"]["out_proj"]
        out = [(name + "out_proj", w.shape[-2], w.shape[-1], "ffn")]
        if cfg.family == "hybrid":
            out += attn_block(name + "shared ", params["shared"])
        return out
    return attn_block(name, params["dec_layers" if cfg.family == "encdec"
                                   else "layers"])


def family_generate(cfg, params, device, batch, max_new: int):
    from repro_torch.serving import ServeEngine
    off = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    eng = ServeEngine(cfg, params, max_len=off + batch["tokens"].shape[1]
                      + max_new, device=device)
    return eng.generate(batch, max_new=max_new)


def families_parity(dev, counters) -> None:
    """f32 greedy streams of the four families' smoke configs (seeded
    params, the same on both), card against CPU: 4 prompts x 8 new tokens
    with their stub patches / frames, dense and relufied to stage 2 at
    static capacities 0.5 / 0.75 with a tile of 16. Tokens exactly,
    logprobs within 1e-5. The card's run is counted: the static run must
    launch kernel 5 8 x ``kernel5_per_step`` times and no other kernel,
    the dense run none."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import relufication as rf
    from repro_torch.models import registry

    for arch in FAMILY_ARCHS:
        base = smoke_config(arch).replace(compute_dtype="float32")
        p_cpu = registry.get_family(base).init_params(base, seed=0,
                                                      device="cpu")
        p_dev = _to(p_cpu, dev)
        batch = family_batch(base, 4, 10, seed=7)
        static = rf.enable_sparse_serving(
            rf.relufy_stage2(base).replace_sparsity(tile_size=16), 0.5, 0.75)
        for what, cfg in (("dense", base),
                          ("stage 2, static 0.5 / 0.75, tile 16", static)):
            want = family_generate(cfg, p_cpu, "cpu", batch, 8)
            expect = 8 * kernel5_per_step(cfg) if cfg.sparsity.enabled else 0
            got, launches = counted(
                f"{cfg.name} f32 {what}", counters,
                ("sparse_matmul",) if expect else (),
                lambda: family_generate(cfg, p_dev, dev, batch, 8))
            if launches["sparse_matmul"] != expect or any(
                    n for k, n in launches.items() if k != "sparse_matmul"):
                fail(f"{cfg.name} {what}: launches {launches}, expected "
                     f"kernel 5 x {expect} and no other kernel")
            d = same_streams(f"{cfg.name} {what}",
                             (got.tokens.tolist(), got.logprobs),
                             (want.tokens.tolist(), want.logprobs))
            log(f"  ok parity {cfg.name} {what}: {got.tokens.size} tokens "
                f"identical, max|dlogprob| {d:.2e}, kernel 5 launches "
                f"{launches['sparse_matmul']}")


def family_serve(dev, counters, add, cfg) -> list:
    """One family at full width, bf16, random weights from a seed: 4
    prompts of 32 tokens (with 256 stub patches or 1500 stub frames) and
    16 new tokens through the legacy ServeEngine, dense and relufied to
    stage 2 at static capacities 0.25 / 0.75. Each run is warmed once,
    then counted (kernel 5 must launch 16 x ``kernel5_per_step`` times in
    the static run and never in the dense one) and timed as
    ``legacy_serve`` times OPT-6.7B. Returns ``gathered_products``."""
    from repro_torch.core import relufication as rf
    from repro_torch.models import registry
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import flatten

    fam = registry.get_family(cfg)
    t0 = time.perf_counter()
    params = fam.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flatten(params))
    log(f"  {cfg.name}: {n_params / 1e9:.3f} B params "
        f"({n_params * 2 / 2 ** 30:.2f} GiB bf16), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    products = gathered_products(cfg, params)
    log(f"  {cfg.name}: kernel 5's products at static capacities (F -> "
        f"D): " + ", ".join(f"{n} {f} -> {d_}" for n, f, d_, _ in products))
    batch = family_batch(cfg, 4, 32, seed=8, dev=dev)
    off = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    static = rf.enable_sparse_serving(rf.relufy_stage2(cfg), 0.25, 0.75)
    for what, c in (("dense", cfg), ("static 0.25 / 0.75", static)):
        expect = 16 * kernel5_per_step(c) if c.sparsity.enabled else 0
        eng = ServeEngine(c, params, max_len=off + 48, device=dev)

        def gen():
            return eng.generate(batch, max_new=16)

        a = time.perf_counter()
        gen()  # warm-up
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - a) * 1e3
        torch.cuda.reset_peak_memory_stats(dev)
        a = time.perf_counter()
        res, launches = counted(f"{cfg.name} legacy {what}", counters,
                                ("sparse_matmul",) if expect else (), gen)
        gen_ms = (time.perf_counter() - a) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        add(launches)
        if launches["sparse_matmul"] != expect or any(
                n for k, n in launches.items() if k != "sparse_matmul"):
            fail(f"{cfg.name} {what}: launches {launches}, expected kernel 5 "
                 f"x {expect} and no other kernel")
        a = time.perf_counter()
        with torch.inference_mode():
            _, cache = eng.prefill(batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - a) * 1e3
        with torch.inference_mode():  # one decode step alone
            tok = torch.as_tensor(res.tokens[:, 0], device=dev)
            pos = torch.full((4,), off + 32, dtype=torch.int32, device=dev)
            step = lambda: eng.decode(cache, tok, pos)  # noqa: E731
            call_ms, card_ms = time_ms(step, reps=10), device_ms(step)
        if (res.tokens.shape != (4, 16) or res.tokens.min() < 0
                or res.tokens.max() >= c.vocab_size
                or not np.isfinite(res.logprobs).all()
                or (res.logprobs > 0).any()):
            fail(f"{cfg.name} {what}: bad tokens or logprobs")
        step_ms = (gen_ms - prefill_ms) / 16
        dens_in, dens_ffn = ((0.75, 0.25) if c.sparsity.enabled
                             else (1.0, 1.0))
        log("  serve " + json.dumps(dict(
            mode=f"{cfg.name} legacy {what}", layers=cfg.n_layers,
            batch=4, prompt=32, stub_positions=off or (
                cfg.n_audio_frames if cfg.family == "encdec" else 0),
            new_tokens=16, first_generate_ms=first_ms, generate_ms=gen_ms,
            prefill_ms=prefill_ms, decode_step_ms=step_ms,
            decode_tokens_per_s=4e3 / step_ms, decode_call_ms=call_ms,
            decode_device_ms=card_ms,
            peak_gib_generate=peak,
            modeled_weight_gb_per_step=family_weight_bytes(
                c, dens_in, dens_ffn) / 1e9,
            kernel5_launches=launches["sparse_matmul"],
            kernel5_per_step=expect // 16)))
        del eng, cache
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return products


def kernel5_family_rows(dev, products) -> None:
    """Kernel 5 at every product the families' static decode gathers
    (``gathered_products``), one check a distinct (F, D, side): T = 4 relu
    rows, the top tiles select_active_tiles keeps at 0.75 on the input
    side and at 0.25 for a down projection / out_proj, bf16, against the
    plain version. The down-projection shapes are then timed per call and
    on the card beside the plain version and x @ w (all tiles), with their
    bytes bound."""
    from repro_torch.kernels import sparse_matmul as ksm
    from repro_torch.models import common as cm

    shapes = {}
    for name, F_, D_, side in products:
        shapes.setdefault((F_, D_, side), []).append(name)
    rng = np.random.RandomState(9)
    for (F_, D_, side), names in shapes.items():
        dens = 0.25 if side == "ffn" else 0.75
        name = " / ".join(names)
        h = torch.relu(torch.as_tensor(rng.standard_normal((4, F_)),
                                       dtype=torch.bfloat16, device=dev))
        w = torch.as_tensor(rng.standard_normal((F_, D_)) / np.sqrt(F_),
                            dtype=torch.bfloat16, device=dev)
        idx, mask = cm.select_active_tiles(cm.tile_scores(h, 128), dens)
        nv = mask.sum(dtype=torch.int32)
        args = (h, w, idx, nv)
        err = compare(f"sparse_matmul {name} T=4 F={F_} D={D_} K="
                      f"{idx.numel()} of {F_ // 128} (density {dens})",
                      [ksm.sparse_matmul(*args)],
                      [ksm.sparse_matmul_plain(*args)], torch.bfloat16)
        if side != "ffn":
            continue
        k = int(nv)
        n_bytes = 4 * k * 128 * 2 + k * 128 * D_ * 2 + idx.numel() * 4 + 4 \
            + 4 * D_ * 4
        b_ms, b_by = bound(n_bytes, 2.0 * 4 * k * 128 * D_, torch.bfloat16)
        row = dict(shape=f"{name} T=4 F={F_} D={D_}, {k} of {F_ // 128} "
                         f"tiles (density 0.25) bf16", max_abs_err=err,
                   **timings(lambda: ksm.sparse_matmul(*args),
                             lambda: ksm.sparse_matmul_plain(*args),
                             lambda: h @ w),
                   bound_ms=b_ms, bound_by=b_by)
        row["card_over_bound"] = row["device_ms"] / b_ms
        log("  kernel5 " + json.dumps(row))
    log(f"  kernel 5 checked at {len(shapes)} shapes of the families' "
        f"{len(products)} gathered products")


def families_phase(dev, counters) -> dict:
    """Phase 7: the mamba, hybrid, encdec and vlm families through the
    legacy ServeEngine: f32 card = CPU parity at smoke size, then each
    model at full width and depth (``family_serve``), then kernel 5 at
    every shape their static decode gathers. Returns the launches summed
    over the full-width runs."""
    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.empty_cache()
    total = {name: 0 for name in counters}

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    t0 = time.perf_counter()
    families_parity(dev, counters)
    log(f"  parity took {time.perf_counter() - t0:.1f} s")
    products = []
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        products += family_serve(dev, counters, add, get_config(arch).replace(
            compute_dtype="bfloat16"))
        log(f"  {arch} took {time.perf_counter() - t0:.1f} s")
    kernel5_family_rows(dev, products)
    log(f"  launches summed over the full-width runs: {json.dumps(total)}")
    return total


# ---------------------------------------------------------------------------
# phase 9: the assigned model zoo relufied, through the paged engine


ZOO_ARCHS = ("qwen3-4b", "qwen2-7b", "starcoder2-15b", "deepseek-67b",
             "phi3.5-moe-42b-a6.6b")
# layers of the bf16 full-width serve: the whole model where the phase's
# time allows, else 8 (DeepSeek-67B's 95 layers, 134 GB, cannot fit)
ZOO_SERVE_LAYERS = {"qwen3-4b": 36, "qwen2-7b": 28, "starcoder2-15b": 8,
                    "deepseek-67b": 8, "phi3.5-moe-42b-a6.6b": 8}
# layers of the f32 card = CPU parity (its vocabulary cut to ZOO_VOCAB)
ZOO_PARITY_LAYERS = {"qwen3-4b": 2, "qwen2-7b": 2, "starcoder2-15b": 2,
                     "deepseek-67b": 1, "phi3.5-moe-42b-a6.6b": 1}
ZOO_VOCAB = 4096
ZOO_PARITY_TOL = 1e-4  # f32 logprobs, card against CPU, at full width
ZOO_PARITY_BUDGET_S = 25.0
# the engine's geometry for both runs: 16-token prefill chunks (kernel 3),
# W = 1 decode (kernels 1 and 2)
ZOO_GEOM = dict(n_slots=8, block_size=16, max_blocks_per_seq=16,
                prefill_chunk=16)
ZOO_PARITY_GEOM = dict(n_slots=4, block_size=16, max_blocks_per_seq=4,
                       prefill_chunk=16)
ZOO_DENSE_KERNELS = ("fused_sparse_ffn", "paged_window_attention",
                     "sparse_matmul_tokens")


def zoo_config(arch: str, n_layers: int, dtype: str, vocab=None):
    """The registered config relufied to stage 2 (ReLU FFN and ReLU after
    every norm: the paper's Sec. 4 surgery) at ``n_layers`` and the compute
    dtype, its vocabulary cut to ``vocab`` when given."""
    from repro_torch.configs import get_config
    from repro_torch.core import relufication as rf
    cfg = rf.relufy_stage2(get_config(arch)).replace(n_layers=n_layers,
                                                     compute_dtype=dtype)
    return cfg.replace(vocab_size=vocab) if vocab else cfg


def zoo_kernel_rows(dev, cfg, seed: int = 0) -> dict:
    """Kernels 1, 2 and 3 at ``cfg``'s own shapes (served geometry: q heads
    padded as the model pads them), random inputs drawn on the card, each
    against its plain version in f32 and bf16; the bf16 main rows timed
    per call and on the card beside the bound, the plain version and the
    library call. Kernel 1: T = 8 decode rows, the config's GLU or MLP
    relufied (ReLU), a unit mask, all tiles and half-density lists.
    Kernel 2: 8 slots, decode W = 1 and a 16-token chunk at (kvp, g, hd),
    blocks of 16, 16 a slot, the config's sliding window; where the
    padding changes the group (Qwen2: 28 heads over 4 kv heads, 7 real in
    8 slots), also the real ratio. Kernel 3: a chunk's rows, 8 slots x 16
    rows with a list a slot, at (F, d). An MoE config runs kernel 2 only.
    Returns {kernel: {case: row}}."""
    from repro_torch.kernels import fused_decode as kfd
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import sparse_matmul as ksm
    from repro_torch.models import common as cm
    from repro_torch.predictor import predictors as preds

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    name = cfg.name
    rows = {}
    g = cm.HeadGeometry(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    groups = [(g.kvp, g.group, "served")]
    if g.real_per_group != g.group:
        groups.append((g.kvp, g.real_per_group, "real ratio"))
    window = cfg.sliding_window or 0
    b, bs, nb, n_blocks = 8, 16, 16, 129
    for kvp, grp, what in groups:
        for W in (1, 16):
            for dtype in (torch.float32, torch.bfloat16):
                q = randn(b, W, kvp, grp, g.head_dim, dtype=dtype)
                kp = randn(n_blocks, kvp, bs, g.head_dim, dtype=dtype)
                vp = randn(n_blocks, kvp, bs, g.head_dim, dtype=dtype)
                perm = torch.randperm(n_blocks - 1, generator=gen,
                                      device=dev)[:b * nb] + 1
                end = torch.randint(W, nb * bs + 1, (b,), generator=gen,
                                    device=dev)
                table = torch.where(
                    torch.arange(nb, device=dev)[None] * bs < end[:, None],
                    perm.reshape(b, nb), 0).to(torch.int32)
                pos = (end[:, None] - W + torch.arange(W, device=dev)[None]
                       ).to(torch.int32)
                args = (q, kp, vp, table, pos)
                case = (f"{name} {what} W={W} kvp={kvp} g={grp} "
                        f"hd={g.head_dim}")
                err = compare(f"paged_window_attention {case} {dtype}",
                              [kpa.paged_window_attention(*args,
                                                          window=window)],
                              [kpa.paged_window_attention_plain(
                                  *args, window=window)], dtype)
                if dtype == torch.bfloat16:
                    rows.setdefault("paged_window_attention", {})[case] = \
                        dict(max_abs_err=err, **attn_row(*args, window))
                del q, kp, vp, args
    if cfg.family != "dense":
        return rows

    d, F = cfg.d_model, cfg.d_ff
    n_tiles, glu = F // 128, cfg.ffn_kind == "glu"
    n_proj = 3 if glu else 2
    for dtype in (torch.float32, torch.bfloat16):
        x = randn(8, d, dtype=dtype)
        wg = randn(d, F, scale=d ** -0.5, dtype=dtype)
        wu = randn(d, F, scale=d ** -0.5, dtype=dtype) if glu else None
        wd = randn(F, d, scale=F ** -0.5, dtype=dtype)
        mask = rand(8, F) < 0.5
        for dens in (1.0, 0.5):
            tm = (torch.ones((8, n_tiles), dtype=torch.bool, device=dev)
                  if dens == 1.0 else rand(8, n_tiles) < dens)
            idx, nvalid = preds.pack_tile_indices(tm, n_tiles)
            kw = dict(w_up=wu, unit_mask=mask, activation=cfg.activation,
                      tile=128)
            case = (f"{name} T=8 d={d} F={F} {'GLU' if glu else 'MLP'}+mask "
                    f"{dens:.0%} lists")
            got = kfd.fused_sparse_ffn(x, wg, wd, idx, nvalid, **kw)
            err = compare(f"fused_sparse_ffn {case} {dtype}", got,
                          kfd.fused_sparse_ffn_plain(x, wg, wd, idx, nvalid,
                                                     **kw), dtype)
            if dtype != torch.bfloat16:
                continue
            b_ms, b_by = ffn_bound(x, F, idx, nvalid, n_proj)
            maskb = mask.to(torch.bfloat16)

            def lib_ffn():  # the dense chain, the yardstick
                h = torch.relu(x @ wg)
                return ((h * (x @ wu) if glu else h) * maskb) @ wd

            rows.setdefault("fused_sparse_ffn", {})[case] = dict(
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **timings(
                    lambda: kfd.fused_sparse_ffn(x, wg, wd, idx, nvalid, **kw),
                    lambda: kfd.fused_sparse_ffn_plain(x, wg, wd, idx, nvalid,
                                                       **kw), lib_ffn))
        del x, wg, wu, wd
    for dtype in (torch.float32, torch.bfloat16):
        T = 8 * 16
        x = (randn(T, F) * (rand(T, F) < 0.5)).to(dtype)
        w = randn(F, d, scale=F ** -0.5, dtype=dtype)
        idx, nvalid = preds.pack_tile_indices(rand(8, n_tiles) < 0.97, n_tiles)
        idx = idx.repeat_interleave(16, 0).contiguous()
        nvalid = nvalid.repeat_interleave(16).contiguous()
        case = f"{name} chunk 8x16 rows F={F} D={d} 97% lists"
        err = compare(f"sparse_matmul_tokens {case} {dtype}",
                      [ksm.sparse_matmul_tokens(x, w, idx, nvalid)],
                      [ksm.sparse_matmul_tokens_plain(x, w, idx, nvalid)],
                      dtype)
        if dtype == torch.bfloat16:
            b_ms, b_by = gather_bound(x, w, idx, nvalid)
            rows.setdefault("sparse_matmul_tokens", {})[case] = dict(
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **timings(
                    lambda: ksm.sparse_matmul_tokens(x, w, idx, nvalid),
                    lambda: ksm.sparse_matmul_tokens_plain(x, w, idx, nvalid),
                    lambda: x @ w))
        del x, w
    return rows


def zoo_params(cfg, dev):
    """Seeded params of ``cfg`` on ``dev``; every constant leaf (norm
    scales and biases, QKV biases, qk-norm scales) then moved off its
    constant by 0.1 N(0, 1), so the f32 parity reads them too."""
    from repro_torch.models import registry
    params = registry.get_family(cfg).init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif v.is_floating_point() and v.numel() and bool(
                    (v == v.reshape(-1)[0]).all()):
                v.add_(0.1 * torch.randn(v.shape, generator=gen, device=dev,
                                         dtype=v.dtype))
    perturb(params)
    return params


def zoo_parity(dev, counters, add, arch: str) -> None:
    """f32 greedy streams of ``arch`` relufied to stage 2 at full width,
    shallow (ZOO_PARITY_LAYERS, the vocabulary cut to ZOO_VOCAB), card
    (kernels, counted) against CPU (plain versions) on the same params
    (made on the card, copied to the CPU): 3 requests of 24 / 17 / 9
    tokens x 6 new, γ = 2, 16-token prefill chunks. Tokens exactly,
    logprobs within ZOO_PARITY_TOL."""
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig

    t0 = time.perf_counter()
    n = ZOO_PARITY_LAYERS[arch]
    cfg = zoo_config(arch, n, "float32", ZOO_VOCAB)
    p_dev = zoo_params(cfg, dev)
    p_cpu = _to(p_dev, "cpu")
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, m) for m in (24, 17, 9)]

    def serve(params, device):
        eng = ContinuousBatchingEngine(cfg, params,
                                       EngineConfig(**ZOO_PARITY_GEOM),
                                       device=device)
        uids = [eng.submit(p, 6, reuse_window=2) for p in prompts]
        res = eng.run()
        return ([res[u].tokens.tolist() for u in uids],
                np.concatenate([res[u].logprobs for u in uids]))

    expect = (ZOO_DENSE_KERNELS if cfg.family == "dense"
              else ("paged_window_attention",))
    got, launches = counted(f"{arch} f32 parity ({n} layers)", counters,
                            expect, lambda: serve(p_dev, dev))
    add(launches)
    del p_dev
    want = serve(p_cpu, "cpu")
    d = same_streams(f"{arch} f32 full width, {n} layers", got, want,
                     ZOO_PARITY_TOL)
    secs = time.perf_counter() - t0
    log(f"  ok parity {arch} relufied stage 2, {n} layers, vocab "
        f"{cfg.vocab_size}, f32: {sum(map(len, got[0]))} tokens identical, "
        f"max|dlogprob| {d:.2e} ({secs:.1f} s"
        f"{'' if secs <= ZOO_PARITY_BUDGET_S else ', over its 25 s budget'})")
    del p_cpu
    gc.collect()
    torch.cuda.empty_cache()


def zoo_serve(dev, counters, add, arch: str) -> dict:
    """``arch`` relufied to stage 2 at full width, bf16, ZOO_SERVE_LAYERS
    deep, random weights from a seed, through the engine: the serve
    phase's 8 requests (16 new tokens each, γ = 4 on every other one)
    with 16-token prefill chunks, counted. A dense config must launch
    kernels 1, 2 and 3, an MoE kernel 2, and no other kernel; tokens in
    the vocabulary, logprobs finite. Logs the step ms, tokens/s, peak,
    weight bytes a step and launches; for an MoE the share of its routed
    assignments the capacity drops (``moe_drop_frac``) over the 8 prompts'
    whole-prompt forward. Returns the serve's figures."""
    from repro_torch.models import registry
    from repro_torch.models import common as cm
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    from repro_torch.tree import flatten

    n = ZOO_SERVE_LAYERS[arch]
    cfg = zoo_config(arch, n, "bfloat16")
    t0 = time.perf_counter()
    params = registry.get_family(cfg).init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flatten(params))
    log(f"  {arch} relufied stage 2, {n} layers: {n_params / 1e9:.3f} B "
        f"params ({n_params * 2 / 2 ** 30:.2f} GiB bf16), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ContinuousBatchingEngine(cfg, params, EngineConfig(**ZOO_GEOM),
                                   device=dev)
    expect = (ZOO_DENSE_KERNELS if cfg.family == "dense"
              else ("paged_window_attention",))
    out, launches = counted(f"{arch} bf16 serving ({n} layers)", counters,
                            expect, lambda: serve_run(
                                eng, cfg, seed=4, reuse=[4, 0] * 4))
    add(launches)
    extra = sorted(k for k, v in launches.items() if v and k not in expect)
    if extra:
        fail(f"{arch} serving launched other kernels: {extra}")
    toks = np.concatenate([np.asarray(s) for s in out["_streams"]])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{arch}: a token out of the vocabulary")
    out.update(mode=f"{arch} zoo relufied stage 2", params_b=n_params / 1e9,
               weight_io_bytes_per_step=eng.weight_io_bytes_per_step(),
               launches=launches)
    if cfg.family == "moe":
        prompts = serve_prompts(cfg, seed=4)
        stats = cm.StatsCollector(True)
        with torch.inference_mode():
            for p in prompts:
                registry.get_family(cfg).model_forward(
                    params, {"tokens": torch.as_tensor(p[None], device=dev)},
                    cfg, stats=stats)
        drops = [float(v) for k, v in stats.stats.items()
                 if k.endswith("moe_drop_frac")]
        out.update(moe_drop_frac=float(np.mean(drops)),
                   moe_drop_frac_max=float(np.max(drops)),
                   capacity_factor=cfg.capacity_factor,
                   expert_io_fraction=eng.expert_io_fraction())
    log_serve(out)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_phase(dev, counters) -> dict:
    """Phase 9: the five assigned configs (Qwen3-4B, Qwen2-7B,
    StarCoder2-15B, DeepSeek-67B, Phi-3.5-MoE) relufied to stage 2: (a)
    kernels 1-3 at each one's shapes (``zoo_kernel_rows``), (b) f32 card =
    CPU streams at full width, shallow (``zoo_parity``), (c) bf16 serving
    at full width (``zoo_serve``), one model on the card at a time.
    Returns the launches summed over (b) and (c)."""
    gc.collect()
    torch.cuda.empty_cache()
    total = {name: 0 for name in counters}

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    for arch in ZOO_ARCHS:
        t0 = time.perf_counter()
        cfg = zoo_config(arch, 1, "bfloat16")
        for kernel, rows in zoo_kernel_rows(dev, cfg).items():
            for case, row in rows.items():
                log("  zoo kernel " + json.dumps(dict(
                    kernel=kernel, case=case,
                    card_over_bound=row["device_ms"] / row["bound_ms"],
                    **row)))
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        zoo_parity(dev, counters, add, arch)
        t2 = time.perf_counter()
        zoo_serve(dev, counters, add, arch)
        log(f"  {arch} took {time.perf_counter() - t0:.1f} s (kernels "
            f"{t1 - t0:.1f}, parity {t2 - t1:.1f}, serve "
            f"{time.perf_counter() - t2:.1f})")
    log(f"  launches summed over the zoo's runs: {json.dumps(total)}")
    return total


def train_phase(dev, counters) -> dict:
    """Phase 8: f32 card = CPU parity of the train step, then the
    full-width relufication run. The path runs none of the ten kernels
    (training's forward is dense and the reference has no backward
    kernel): the counts must stay 0."""
    gc.collect()
    torch.cuda.empty_cache()
    _, launches = counted("train", counters, (),
                          lambda: (train_parity(dev), train_full_width(dev)))
    if any(launches.values()):
        fail(f"the train path launched kernels: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: tensor-parallel sharded serving, ranks sharing the card


# (arch, mode, prefill chunk) of the f32 parity cases
SHARD_CASES = (("tiny-relu", "plain", 0), ("tiny-relu", "plain", 4),
               ("tiny-opt", "plain", 0), ("tiny-opt", "plain", 4),
               ("tiny-relu", "spec", 0), ("tiny-opt", "spec", 0),
               ("tiny-relu", "predictor", 0), ("tiny-opt", "predictor", 0),
               ("tiny-moe", "plain", 0), ("tiny-moe", "plain", 4),
               ("tiny-relu", "static", 0))
# (world, cases): TP = 2 over every case; TP = 4 over tiny-relu plain
# alone, the card's one case whose kv heads (2) do not divide the model
# axis (wk / wv row-parallel, the partial K/V all-reduced, kernel 2 on a
# kv-head range). The CPU tests hold every case at TP = 4 and 8 against
# the reference; the other TP = 4 cases (44 s of the card's time) gave
# their time to the data phase
SHARD_WORLDS = ((2, SHARD_CASES), (4, (("tiny-relu", "plain", 0),)))
# the first prefill's last-position logits, TP = 2 against one card, bf16:
# max |diff| over max |single-device logit| (PERF.md states it before the
# run that tests it)
TOL_SHARD_LOGITS = 3e-2
# the split families at full width, TP = 2 against one card in f32: the
# first prefill's and one decode step's logits, max |diff| over max
# |logit|. In bf16 a static capacity's selection can flip between two
# tiles whose scores one ulp apart round the other way on the ranks
# (zamba2-7b's shared FFN, 2 layers on the CPU: tiles 78 and 89 at a
# margin of 0.0156), which moves the logits by a few percent; in f32 no
# such tie was seen, so there every mode is held
TOL_SPLIT_F32 = 1e-4
SHARD_GEOM = dict(n_slots=8, block_size=16, max_blocks_per_seq=16,
                  prefill_chunk=16)


def kernel_counters() -> dict:
    """Every kernel wrapper by name (its ``launches`` counts the launches)."""
    from repro_torch.kernels import fused_decode as kfd
    from repro_torch.kernels import fused_ffn as kff
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import sparse_matmul as ksm
    return {"fused_sparse_ffn": kfd.fused_sparse_ffn,
            "paged_window_attention": kpa.paged_window_attention,
            "paged_window_attention_partial":
                kpa.paged_window_attention_partial,
            "paged_attention_fold": kpa.fold_partials,
            "sparse_matmul_tokens": ksm.sparse_matmul_tokens,
            "sparse_up_matmul": ksm.sparse_up_matmul,
            "fused_up_relu": kff.fused_up_relu,
            "sparse_matmul": ksm.sparse_matmul,
            "fused_up_relu_tokens": kff.fused_up_relu_tokens,
            "fused_up_relu_window": kff.fused_up_relu_window,
            "expert_up_matmul": ksm.expert_up_matmul,
            "expert_down_matmul": ksm.expert_down_matmul}


def shard_case(case, device):
    """(cfg, params, EngineConfig fields, prompts) of an f32 parity case on
    ``device``: numpy-seeded weights (target seed 0, 1-layer draft seed 2),
    a sign predictor at an f32 probe and tile 1; static capacities 0.5
    (FFN) / 0.75 (inputs) at tile 16 and the config's one group (at TP = 4
    tiny-relu's K/V rows split over d_model)."""
    from repro_torch.configs import get_config
    from repro_torch.core import relufication as rf
    from repro_torch.predictor import sign_predictor
    arch, mode, chunk = case
    cfg = get_config(arch).replace(compute_dtype="float32")
    if mode == "static":
        cfg = rf.enable_sparse_serving(cfg.replace_sparsity(tile_size=16),
                                       0.5, 0.75)
    params = _to(numpy_params(cfg, seed=0), device)
    kw = dict(prefill_chunk=chunk)
    if mode == "spec":
        dcfg = cfg.replace(name=f"{arch}-draft", n_layers=1)
        kw.update(draft_cfg=dcfg, gamma=4,
                  draft_params=_to(numpy_params(dcfg, seed=2), device))
    if mode == "predictor":
        kw["predictor"] = sign_predictor(params, cfg, probe_dtype="float32",
                                         tile=1)
    prompts = [np.random.RandomState(s).randint(0, cfg.vocab_size, n)
               for s, n in ((1, 9), (2, 5), (3, 13), (4, 21), (5, 3))]
    return cfg, params, kw, prompts


def shard_streams(case, device, mesh=None) -> dict:
    """An f32 parity case through a fresh engine (on ``mesh`` when given):
    streams, logprobs and the metrics, with what it read and the launches
    of kernel 5 (``sparse_matmul``) in its run."""
    from repro_torch.kernels import sparse_matmul as ksm
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    cfg, params, kw, prompts = shard_case(case, device)
    eng = ContinuousBatchingEngine(
        cfg, params, EngineConfig(n_slots=4, block_size=8,
                                  max_blocks_per_seq=6, mesh=mesh, **kw),
        device=device)
    if device.type == "cuda" and not eng.fast_kernels:
        fail(f"{case}: the engine on the card did not take the kernel path")
    uids = [eng.submit(p, 10, reuse_window=4) for p in prompts]
    k0 = ksm.sparse_matmul.launches
    res = eng.run()
    return dict(kernel5=ksm.sparse_matmul.launches - k0,
                tokens=[res[u].tokens.tolist() for u in uids],
                logprobs=np.concatenate([res[u].logprobs for u in uids]),
                accepted=[res[u].draft_accepted for u in uids],
                misses=[res[u].pred_misses for u in uids],
                metrics=eng.metrics_snapshot(), ffn_tp=eng.ffn_tp,
                total=eng.weight_io_bytes_per_step(per_device=False))


# (arch, mode) of the legacy f32 parity cases split over "model": the
# Mamba-1, Zamba-2 and Whisper smoke configs, dense and relufied to stage
# 2 at static capacities 0.25 / 0.75 (tile 16: the smoke d_model 64 is
# under the default 128)
SPLIT_ARCHS = ("falcon-mamba-7b", "zamba2-7b", "whisper-small")
SPLIT_LEGACY = tuple((a, m) for a in SPLIT_ARCHS for m in ("dense",
                                                           "static"))
# the full-width legacy runs on 2 ranks: each arch's depth (zamba2-7b's 6
# layers hold one application of its shared block, attn_every = 6)
SPLIT_FULL = {"falcon-mamba-7b": dict(n_layers=2),
              "zamba2-7b": dict(n_layers=6),
              "whisper-small": dict(n_layers=2, n_encoder_layers=2)}


def split_legacy_stream(case, device, mesh=None) -> dict:
    """A ``SPLIT_LEGACY`` case through the legacy ServeEngine on ``device``
    (on ``mesh`` when given): numpy-seeded f32 weights, 2 prompts of 8
    tokens (Whisper's frames beside them), 8 new tokens; the streams,
    logprobs and kernel 5's launches in the run."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import relufication as rf
    from repro_torch.kernels import sparse_matmul as ksm
    from repro_torch.serving import ServeEngine
    arch, mode = case
    cfg = smoke_config(arch).replace(compute_dtype="float32")
    if mode == "static":
        cfg = rf.enable_sparse_serving(
            rf.relufy_stage2(cfg).replace_sparsity(tile_size=16), 0.25, 0.75)
    eng = ServeEngine(cfg, _to(numpy_params(cfg, seed=0), device),
                      max_len=32, device=device, mesh=mesh)
    batch = family_batch(cfg, 2, 8, seed=5, dev=device)
    k0 = ksm.sparse_matmul.launches
    r = eng.generate(batch, max_new=8)
    return dict(kernel5=ksm.sparse_matmul.launches - k0,
                tokens=r.tokens.tolist(), logprobs=r.logprobs)


def rank_mesh(world: int, device_type: str):
    """This rank's (1, world) mesh, on its card (or the CPU, rehearsing)."""
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(1, world, strict=True,
                          device=None if device_type == "cuda" else "cpu")


def sharded_parity_rank(rank: int, world: int, device_type: str,
                        cases, legacy=()) -> dict:
    """One rank of the f32 parity group: ``cases`` through the continuous
    engine and ``legacy`` (``SPLIT_LEGACY`` cases) through the legacy
    one, on a (1, world) mesh."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = rank_mesh(world, device_type)
    out = {case: shard_streams(case, mesh.device, mesh) for case in cases}
    out.update({("legacy",) + case: split_legacy_stream(case, mesh.device,
                                                        mesh)
                for case in legacy})
    return out


def sharded_parity(dev) -> None:
    """The f32 cases of SHARD_WORLDS on (1, world) ranks on the card
    against the single-device card engine and the CPU engine: tokens
    exactly, logprobs
    within 1e-5, the metrics within 1e-9 (weight bytes per device = the
    single-device figure / ffn_tp, the total over the ranks its figure),
    speculative acceptance and predictor misses equal, on every rank; the
    static case launches kernel 5 on every rank."""
    from repro_torch.sharding import comm
    want = {}
    for case in SHARD_CASES:
        one = shard_streams(case, dev)
        cpu = shard_streams(case, torch.device("cpu"))
        same_streams(f"{case} card vs CPU", (one["tokens"], one["logprobs"]),
                     (cpu["tokens"], cpu["logprobs"]))
        want[case] = one
    for case in SPLIT_LEGACY:
        one = split_legacy_stream(case, dev)
        cpu = split_legacy_stream(case, torch.device("cpu"))
        same_streams(f"{case} legacy card vs CPU",
                     (one["tokens"], one["logprobs"]),
                     (cpu["tokens"], cpu["logprobs"]))
        want[("legacy",) + case] = one
    for world, cases in SHARD_WORLDS:
        t0 = time.perf_counter()
        legacy = SPLIT_LEGACY if world == 2 else ()
        ranks = comm.spawn(sharded_parity_rank, world, timeout=420,
                           args=(dev.type, cases, legacy), device=dev.type)
        for rank, got in enumerate(ranks):
            for case in legacy:
                key = ("legacy",) + case
                g = got[key]
                what = f"{case} legacy TP={world} rank {rank}"
                d = same_streams(what, (g["tokens"], g["logprobs"]),
                                 (want[key]["tokens"], want[key]["logprobs"]))
                if case[1] == "static" and g["kernel5"] <= 0:
                    fail(f"{what}: kernel 5 was not launched on the rank")
            for case in cases:
                g, w = got[case], want[case]
                what = f"{case} TP={world} rank {rank}"
                d = same_streams(what, (g["tokens"], g["logprobs"]),
                                 (w["tokens"], w["logprobs"]))
                if g["ffn_tp"] != world:
                    fail(f"{what}: ffn_tp {g['ffn_tp']}")
                if abs(g["total"] - w["total"]) > 1e-9 * max(1, w["total"]):
                    fail(f"{what}: FFN bytes over the ranks {g['total']} != "
                         f"the one-card engine's {w['total']}")
                if case[1] == "static" and g["kernel5"] <= 0:
                    fail(f"{what}: kernel 5 was not launched on the rank")
                for k, v in w["metrics"].items():
                    v = v / world if k == "weight_io_bytes_per_step" else v
                    got_k = g["metrics"].get(k, np.inf)
                    if abs(got_k - v) > 1e-9 * max(1, abs(v)):
                        fail(f"{what}: {k} {got_k} != {v}")
                if (g["accepted"], g["misses"]) != (w["accepted"],
                                                    w["misses"]):
                    fail(f"{what}: acceptance / misses differ")
        log(f"  ok sharded f32 parity TP={world}: {len(cases)} cases and "
            f"{len(legacy)} legacy split-family cases x {world} ranks equal "
            f"the one-card engine and the CPU (last max|dlogprob| {d:.2e}); "
            f"{time.perf_counter() - t0:.1f} s")


def first_prefill_logits(eng, cfg, prompt) -> torch.Tensor:
    """The whole-prompt prefill of ``prompt`` through ``eng``'s model and
    params (its mesh, if any) into the first blocks of its pool: the last
    position's logits over the real vocabulary, f32, on the host."""
    from repro_torch.sharding import comm
    bs = eng.block_size
    s = len(prompt)
    nb = -(-s // bs)
    toks = np.zeros((1, nb * bs), np.int64)
    toks[0, :s] = prompt
    blocks = torch.arange(1, nb + 1, dtype=torch.int32, device=eng.device)
    data = eng.data.whole_batch() if eng.data is not None else None
    with torch.inference_mode(), comm.serving(eng.mesh, data):
        last, _ = eng.fam.model_prefill_paged(
            eng.params, {"tokens": torch.as_tensor(toks, device=eng.device)},
            cfg, eng.pages, blocks, bs, true_len=s)
    return last[0, :cfg.vocab_size].float().cpu()


def first_decode_logits(eng, cfg, prompts):
    """Slot i's prompt prefilled whole (``model_prefill_paged``, every data
    row keeping the blocks it holds) into pages that alternate between the
    two halves of the pool (page j at global block 1 + 3 i + j // 2 for
    even j, n_blocks // 2 + 3 i + j // 2 for odd j), then one decode step
    of every slot (its prompt's last token at the next position) through
    ``eng``'s model on its mesh and data split: (s0, the logits of the
    slots s0 .. this rank computes over the real vocabulary, f32, on the
    host). Needs prompts of at most 5 pages and at most 21 slots."""
    from repro_torch.sharding import comm
    bs, n = eng.block_size, len(prompts)
    half = eng.scheduler.allocator.n_blocks // 2
    table = np.zeros((n, eng.scheduler.max_blocks_per_seq), np.int32)
    tokens = np.array([p[-1] for p in prompts], np.int32)
    pos = np.array([len(p) for p in prompts], np.int32)
    data = eng.data
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            nb = -(-(len(p) + 1) // bs)
            table[i, :nb] = [(1 if j % 2 == 0 else half) + 3 * i + j // 2
                             for j in range(nb)]
            toks = np.zeros((1, -(-len(p) // bs) * bs), np.int64)
            toks[0, :len(p)] = p
            with comm.serving(eng.mesh, data and data.whole_batch()):
                eng.fam.model_prefill_paged(
                    eng.params, {"tokens": eng._tensor(toks)}, cfg,
                    eng.pages, eng._tensor(table[i, :toks.shape[1] // bs]),
                    bs, true_len=len(p))
        own = eng._own
        with comm.serving(eng.mesh, data):
            logits = eng.fam.model_decode_paged(
                eng.params, eng.pages, eng._tensor(table[own]),
                eng._tensor(tokens[own]), eng._tensor(pos[own]), cfg,
                eng.masks, torch.ones(eng._n_own, dtype=torch.bool,
                                      device=eng.device),
                bs, fast_kernels=eng.fast_kernels)[0]
    return own.start, logits[:, :cfg.vocab_size].float().cpu()


def shard_kernel_checks(eng, cfg, dev) -> None:
    """Kernels 1 to 3 against their plain versions at this rank's shapes on
    its layer-0 weights and pool: the decode FFN over tile lists of its
    d_ff slice, the W = 1 attention over its kv heads, the window-union
    down-projection."""
    from repro_torch.kernels import fused_decode as kfd
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import sparse_matmul as ksm
    from repro_torch.models import common as cm
    from repro_torch.predictor import predictors as preds
    from repro_torch.sharding import comm
    rng = np.random.RandomState(9)
    bf = torch.bfloat16
    with comm.serving(eng.mesh):
        g, lay = cm.local_heads(cfg), cm.shard_layout(cfg)
        tile = cm.ffn_gather_tile(cfg)
    rank = eng.mesh.coords["model"]
    kp, vp = eng.pages["k"][0], eng.pages["v"][0]
    b, nb = 8, 4
    table = torch.as_tensor(rng.randint(1, kp.shape[0], (b, nb)),
                            dtype=torch.int32, device=dev)
    pos = torch.as_tensor(rng.randint(1, nb * eng.block_size, b),
                          dtype=torch.int32, device=dev)
    q = torch.as_tensor(rng.randn(b, 1, g.kvp, g.group, g.head_dim),
                        dtype=bf, device=dev)
    args = (q, kp, vp, table, pos[:, None])
    compare(f"rank {rank} kernel 2 q {tuple(q.shape)} pages "
            f"{tuple(kp.shape)}",
            [kpa.paged_window_attention(*args, window=cfg.sliding_window)],
            [kpa.paged_window_attention_plain(*args,
                                              window=cfg.sliding_window)], bf)
    if "ffn" not in eng.params["layers"]:
        return
    pf = {k: v[0] for k, v in eng.params["layers"]["ffn"].items()}
    fl = lay.ffn[1]
    x = torch.as_tensor(rng.randn(b, cfg.d_model), dtype=bf, device=dev)
    mask = torch.as_tensor(rng.rand(b, fl) < 0.5, device=dev)
    idx, nvalid = preds.pack_tile_indices(preds.units_to_tiles(mask, tile),
                                          fl // tile)
    glu = cfg.ffn_kind == "glu"
    args = (x, pf["wg"] if glu else pf["wu"], pf["wd"], idx, nvalid)
    kw = dict(w_up=pf["wu"] if glu else None, unit_mask=mask,
              activation=cfg.activation, tile=tile)
    compare(f"rank {rank} kernel 1 d {cfg.d_model} F {fl} tile {tile}",
            kfd.fused_sparse_ffn(*args, **kw),
            kfd.fused_sparse_ffn_plain(*args, **kw), bf)
    h = torch.as_tensor(rng.randn(b * 5, fl) * (rng.rand(b * 5, fl) < 0.3),
                        dtype=bf, device=dev)
    hidx, hnv = preds.pack_tile_indices(
        preds.units_to_tiles(h != 0, tile), fl // tile)
    args = (h, pf["wd"], hidx, hnv)
    compare(f"rank {rank} kernel 3 x {tuple(h.shape)} w "
            f"{tuple(pf['wd'].shape)}",
            [ksm.sparse_matmul_tokens(*args, tile=tile)],
            [ksm.sparse_matmul_tokens_plain(*args, tile=tile)], bf)


def sharded_full_rank(rank: int, world: int, cases, device_type: str,
                      legacy=()) -> dict:
    """One rank of full-width bf16 models on a (1, world) mesh sharing the
    card, one (cfg, seed) case after the other in one rank group: the
    ranks build the seeded tree one after the other (at most one whole
    tree on the card), each keeping its blocks; then the first prefill's
    logits, the serve run of ``serve_run`` with every kernel counted from
    0 and the all-reduces counted, and kernels 1 to 3 at this rank's
    shapes; the engine is freed before the next case. Then each config
    of ``legacy`` through the legacy engine (``split_full_case``).
    Returns {"engine": [...], "legacy": [...]}."""
    mesh = rank_mesh(world, device_type)
    return dict(engine=[sharded_full_case(rank, world, mesh, cfg, seed)
                        for cfg, seed in cases],
                legacy=[split_full_case(rank, world, mesh, cfg)
                        for cfg in legacy])


def fold_per_step(cfg) -> int:
    """Kernel 2f's launches in one legacy decode step under a model axis:
    each self-attention over the sequence-sharded cache folds the ranks'
    partials once (``common.decode_attention``); the hybrid's shared block
    at each application, the enc-dec decoder's self-attention a layer (its
    cross-attention reads its own heads' whole cache: no fold), none in
    Mamba-1."""
    from repro_torch.models import hybrid
    return {"mamba": 0, "hybrid": hybrid.n_attn_applications(cfg),
            "encdec": cfg.n_layers}[cfg.family]


def split_first_logits(eng, c, dev, hold: bool = False):
    """Through the legacy engine ``eng`` (its mesh, if any): the whole
    prefill of ``split_full_case``'s 4 prompts of 32 tokens, then one
    decode step of their last tokens at position 32. Returns (the last
    logits of each over the real vocabulary, f32, on the host, as a pair;
    with ``hold``, kernel 5's first calls in the decode step as
    ``first_calls`` keeps them, else {})."""
    batch = family_batch(c, 4, 32, seed=8, dev=dev)
    pos = torch.full((4,), 32, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        last, cache = eng.prefill(batch)
        with (first_calls((("sparse_matmul", "sparse_matmul"),)) if hold
              else contextlib.nullcontext({})) as calls:
            step, _ = eng.decode(cache, batch["tokens"][:, -1], pos)
    V = c.vocab_size
    return (last[:, :V].float().cpu().numpy(),
            step[:, :V].float().cpu().numpy()), calls


def split_engines(cfg, dev, mesh=None, rank: int = 0,
                  world: int = 1) -> list:
    """[(mode, config, legacy engine)] of the seeded ``cfg`` tree, dense
    and relufied to stage 2 at static capacities 0.25 / 0.75, on ``mesh``
    when given: its ranks build the tree one after the other (at most one
    whole tree on the card), each engine keeping the rank's blocks."""
    from repro_torch.core import relufication as rf
    from repro_torch.models import registry
    from repro_torch.serving import ServeEngine
    from repro_torch.sharding import comm
    static = rf.enable_sparse_serving(rf.relufy_stage2(cfg), 0.25, 0.75)
    engines = []
    for r in range(world):
        if r == rank:
            params = registry.get_family(cfg).init_params(cfg, seed=0,
                                                          device=dev)
            engines = [(what, c, ServeEngine(c, params, max_len=64,
                                             device=dev, mesh=mesh))
                       for what, c in (("dense", cfg),
                                       ("static 0.25 / 0.75", static))]
            del params
            gc.collect()
            torch.cuda.empty_cache()
        if mesh is not None:
            comm.barrier(mesh)
    return engines


def split_logits(cfg, dev, mesh=None, rank: int = 0, world: int = 1):
    """``split_first_logits`` of each of ``split_engines``' engines, in
    the config's bf16 and in f32: {dtype name: [(prefill, decode) a
    mode]}. The engines are freed before it returns."""
    out = {}
    for dt in ("bfloat16", "float32"):
        engines = split_engines(cfg.replace(compute_dtype=dt), dev, mesh,
                                rank, world)
        out[dt] = [split_first_logits(eng, c, dev)[0]
                   for _, c, eng in engines]
        del engines
        gc.collect()
        torch.cuda.empty_cache()
    return out


def split_full_case(rank: int, world: int, mesh, cfg) -> list:
    """One split-family config at full width through the legacy engine on
    this rank's mesh, dense and at static capacities 0.25 / 0.75 (stage
    2): the ranks build the seeded tree one after the other, each engine
    keeping its blocks; 4 prompts of 32 tokens and 16 new, warmed once,
    then counted (kernel 5 16 x ``kernel5_per_step`` times in the static
    run, never in the dense one; kernel 2f 16 x ``fold_per_step``; no
    other kernel) and timed as
    ``family_serve`` times one card; kernel 5's first call of each shape
    in a static decode step (``split_first_logits``) held against its
    plain version. Then the logits of ``split_logits`` in bf16 and f32,
    on the first row. Returns a row per mode."""
    from repro_torch.sharding import comm
    dev = mesh.device
    engines = split_engines(cfg, dev, mesh, rank, world)
    counters = kernel_counters()
    rows = []
    for what, c, eng in engines:
        batch = family_batch(c, 4, 32, seed=8, dev=dev)
        expect = 16 * kernel5_per_step(c) if c.sparsity.enabled else 0
        folds = 16 * fold_per_step(c)

        def gen():
            return eng.generate(batch, max_new=16)

        gen()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        a = time.perf_counter()
        res, launches = counted(
            f"rank {rank} sharded legacy {cfg.name} {what}", counters,
            (("sparse_matmul",) if expect else ())
            + (("paged_attention_fold",) if folds else ()), gen)
        gen_ms = (time.perf_counter() - a) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        want = dict.fromkeys(launches, 0)
        want.update(sparse_matmul=expect, paged_attention_fold=folds)
        if launches != want:
            fail(f"rank {rank} {cfg.name} {what}: launches {launches}, "
                 f"expected kernel 5 x {expect}, kernel 2f x {folds} and "
                 "no other kernel")
        a = time.perf_counter()
        with torch.inference_mode():
            _, cache = eng.prefill(batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - a) * 1e3
        del cache
        held = {}
        if expect:
            held = check_first_calls(split_first_logits(eng, c, dev,
                                                        hold=True)[1])
        if (res.tokens.shape != (4, 16) or res.tokens.min() < 0
                or res.tokens.max() >= c.vocab_size
                or not np.isfinite(res.logprobs).all()):
            fail(f"rank {rank} {cfg.name} {what}: bad tokens or logprobs")
        rows.append(dict(
            rank=rank, model=cfg.name, mode=what, layers=cfg.n_layers,
            tokens=res.tokens.tolist(), launches=launches,
            generate_ms=gen_ms, prefill_ms=prefill_ms,
            decode_step_ms=(gen_ms - prefill_ms) / 16, peak_gib=peak,
            kernel5_launches=launches["sparse_matmul"],
            fold_launches=launches["paged_attention_fold"],
            kernel5_vs_plain=held))
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    rows[0]["logits"] = split_logits(cfg, dev, mesh, rank, world)
    comm.barrier(mesh)
    return rows


def split_logits_check(cfg, rank: int, got: dict, want: dict) -> None:
    """A rank's ``split_logits`` against one card's, each as max |diff|
    over max |one card's logit|: in f32 every mode's prefill and decode
    within TOL_SPLIT_F32; in bf16 within TOL_SHARD_LOGITS but for the
    static decode, which is printed (``TOL_SPLIT_F32``'s note)."""
    out = {}
    for dt in ("float32", "bfloat16"):
        for what, g2, w2 in zip(("dense", "static"), got[dt], want[dt]):
            for step, g, w in zip(("prefill", "decode"), g2, w2):
                err = float(np.abs(g - w).max())
                scale = float(np.abs(w).max())
                tol = (TOL_SPLIT_F32 if dt == "float32" else
                       None if (what, step) == ("static", "decode")
                       else TOL_SHARD_LOGITS)
                name = f"{cfg.name} {dt} {what} {step} rank {rank}"
                if not np.isfinite(g).all():
                    fail(f"{name}: logits not finite")
                if tol is not None and err > tol * scale:
                    fail(f"{name}: first logits max|diff| {err:.3e} > "
                         f"{tol} x {scale:.3e}")
                out[f"{dt} {what} {step}"] = dict(
                    max_abs_diff=err, rel=err / scale,
                    argmax_equal=bool((g.argmax(-1) == w.argmax(-1)).all()),
                    held=tol)
    log("  sharded legacy logits " + json.dumps(dict(
        model=cfg.name, rank=rank, tp=2, against_one_card=out)))


def sharded_full_case(rank: int, world: int, mesh, cfg, seed: int) -> dict:
    """One case of ``sharded_full_rank`` on this rank's mesh."""
    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    from repro_torch.sharding import comm
    dev = mesh.device
    eng = None
    for r in range(world):
        if r == rank:
            params = registry.get_family(cfg).init_params(cfg, seed=0,
                                                          device=dev)
            eng = ContinuousBatchingEngine(
                cfg, params, EngineConfig(mesh=mesh, **SHARD_GEOM), device=dev)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        comm.barrier(mesh)
    held = torch.cuda.memory_allocated(dev) / 2 ** 30
    logits = first_prefill_logits(eng, cfg, serve_prompts(cfg, seed)[0])
    counters = kernel_counters()
    comm.STATS.reset()
    static = T.densities(cfg) != (1.0, 1.0)
    out, launches = counted(
        f"rank {rank} sharded {cfg.name}{' static' if static else ''}",
        counters, ("paged_window_attention",) + (("sparse_matmul",) if static
                                                 else ()),
        lambda: serve_run(eng, cfg, seed=seed))
    n_ar, ar_s = comm.STATS.count, comm.STATS.seconds
    steps = out["prefill_steps"] + out["decode_steps"]
    shard_kernel_checks(eng, cfg, dev)
    res = dict(
        rank=rank, params_gib=held, launches=launches,
        streams=out.pop("_streams"), logprobs=out.pop("_logprobs"),
        logits=logits.numpy(), serve=out,
        ffn_bytes_per_device=eng.weight_io_bytes_per_step(),
        ffn_bytes_total=eng.weight_io_bytes_per_step(per_device=False),
        ffn_tp=eng.ffn_tp, all_reduces_per_step=n_ar / steps,
        all_reduce_ms_per_step=ar_s * 1e3 / steps)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    comm.barrier(mesh)
    return res


def sharded_full_width(dev, counters, add, cases, legacy=()) -> None:
    """Each (cfg, seed) of ``cases`` (full width, bf16), plain greedy with
    the serve phase's 8 requests, on 2 ranks sharing the card, the cases
    one after the other in one rank group: the ranks agree on every
    token; the first prefill's last-position logits are within
    TOL_SHARD_LOGITS of the one-card engine's; per rank the launches
    (added to the kernels line), step times, tokens/s, peak memory,
    modeled per-device FFN bytes and the all-reduces a step."""
    from repro_torch.models import registry
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    from repro_torch.sharding import comm
    wants = []
    for cfg, seed in cases:
        params = registry.get_family(cfg).init_params(cfg, seed=0, device=dev)
        eng = ContinuousBatchingEngine(cfg, params, EngineConfig(**SHARD_GEOM),
                                       device=dev)
        wants.append(first_prefill_logits(eng, cfg,
                                          serve_prompts(cfg, seed)[0]))
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    legacy_wants = [split_logits(cfg, dev) for cfg in legacy]
    t0 = time.perf_counter()
    per_rank = comm.spawn(sharded_full_rank, 2, timeout=900,
                          args=(list(cases), dev.type, list(legacy)),
                          device=dev.type)
    log(f"  the {len(cases)} full-width cases and {len(legacy)} legacy "
        f"split-family configs at TP=2 took "
        f"{time.perf_counter() - t0:.1f} s in one group of 2 ranks")
    for i, cfg in enumerate(legacy):
        for j in range(2):  # dense, static
            ranks = [rr["legacy"][i][j] for rr in per_rank]
            if any(r["tokens"] != ranks[0]["tokens"] for r in ranks):
                fail(f"{cfg.name} {ranks[0]['mode']}: the ranks' streams "
                     "differ")
            for r in ranks:
                add(r["launches"])
                log("  sharded legacy " + json.dumps(dict(
                    {k: v for k, v in r.items()
                     if k not in ("tokens", "launches", "logits")}, tp=2,
                    backend=comm.backend_for(dev, 2))))
        for rr in per_rank:
            split_logits_check(cfg, rr["legacy"][i][0]["rank"],
                               rr["legacy"][i][0]["logits"], legacy_wants[i])
        log(f"  {cfg.name} ({cfg.n_layers} layers) legacy at TP=2: streams "
            f"of the 2 ranks identical; first prefill and decode logits "
            f"within {TOL_SPLIT_F32} of one card's in f32, and within "
            f"{TOL_SHARD_LOGITS} in bf16 (the static decode printed)")
    for i, ((cfg, _), want) in enumerate(zip(cases, wants)):
        arch = cfg.name
        ranks = [rr["engine"][i] for rr in per_rank]
        for r in ranks[1:]:
            if r["streams"] != ranks[0]["streams"]:
                fail(f"{arch}: rank {r['rank']}'s streams differ from rank "
                     f"0's")
        for r in ranks:
            got = torch.from_numpy(r["logits"])
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if (not np.isfinite(r["logprobs"]).all()
                    or err > TOL_SHARD_LOGITS * scale):
                fail(f"{arch} rank {r['rank']}: first prefill logits max|diff| "
                     f"{err:.3e} > {TOL_SHARD_LOGITS} x {scale:.3e}")
            add(r["launches"])
            log("  sharded " + json.dumps(dict(
                r["serve"], model=arch, layers=cfg.n_layers, tp=2,
                rank=r["rank"],
                static_densities=[cfg.sparsity.input_tile_density,
                                  cfg.sparsity.ffn_tile_density]
                if cfg.sparsity.enabled else None,
                backend=comm.backend_for(dev, 2),
                first_prefill_logits_max_abs_diff=err,
                first_prefill_logits_max_abs=scale,
                argmax_equal=bool(got.argmax() == want.argmax()),
                params_gib_per_rank=r["params_gib"],
                ffn_bytes_per_device=r["ffn_bytes_per_device"],
                ffn_bytes_total=r["ffn_bytes_total"], ffn_tp=r["ffn_tp"],
                all_reduces_per_step=r["all_reduces_per_step"],
                all_reduce_ms_per_step=r["all_reduce_ms_per_step"],
                launches=r["launches"])))
        log(f"  {arch} ({cfg.n_layers} layers) at TP=2: streams of the 2 "
            f"ranks identical")


def sharded_phase(dev, counters) -> dict:
    """Phase 9: tensor-parallel serving with ranks sharing the one card
    (``comm.backend_for``: gloo, since NCCL refuses two ranks on one
    device). f32 parity at TP = 2, and at TP = 4 in one case
    (``sharded_parity``; at TP = 2 also the Mamba-1, Zamba-2 and Whisper
    smoke configs through the legacy engine), then, in one group of 2
    ranks (``sharded_full_width``), OPT-6.7B (4 layers) and Mixtral-8x22B
    (4 of 56 layers) at full width and TP = 2, and OPT-6.7B (4 layers) at
    the legacy phase's static capacities 0.25 (FFN) / 0.75 (inputs),
    where every rank must launch kernel 5; then the three split families
    at full width through the legacy engine (``SPLIT_FULL``). Returns the
    ranks' launches, summed."""
    from repro_torch.sharding import comm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  backend for 2 ranks on this card: {comm.backend_for(dev, 2)}")
    total = {name: 0 for name in counters}

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    t0 = time.perf_counter()
    sharded_parity(dev)
    log(f"  parity took {time.perf_counter() - t0:.1f} s")
    from repro_torch.configs import get_config
    from repro_torch.core import relufication as rf
    # 4 of OPT-6.7B's 32 layers: the serve phase serves all 32
    opt = get_config("opt-6.7b").replace(compute_dtype="bfloat16", n_layers=4)
    sharded_full_width(dev, counters, add, [
        (opt, 0),
        (get_config("mixtral-8x22b").replace(n_layers=4,
                                             compute_dtype="bfloat16"), 4),
        (rf.enable_sparse_serving(opt, 0.25, 0.75), 0)],
        [get_config(a).replace(compute_dtype="bfloat16", **kw)
         for a, kw in SPLIT_FULL.items()])
    for name in ("fused_sparse_ffn", "paged_window_attention",
                 "sparse_matmul_tokens", "sparse_matmul"):
        if total[name] <= 0:
            fail(f"kernel {name} was not launched on the sharded path")
    log(f"  launches summed over the ranks: {json.dumps(total)}")
    return total


# ---------------------------------------------------------------------------
# phase 11: the data axis, ranks sharing the card


# the partial mode's rows of the kernels line, filled by data_phase
DATA_KERNEL_ROWS = {}
# (arch, mode, prefill chunk) of the f32 data-axis parity cases ("drops":
# tiny-moe at capacity 1.0 with routing groups of 3 tokens)
DATA_CASES = (("tiny-relu", "plain", 0), ("tiny-relu", "plain", 4),
              ("tiny-relu", "static", 4), ("tiny-relu", "spec", 0),
              ("tiny-relu", "predictor", 0), ("tiny-moe", "drops", 0),
              ("tiny-moe", "drops", 4))
DATA_MESHES = ((2, 1), (2, 2))
DATA_POOL = 26  # 4 slots x 6 blocks + scratch, rounded up to even
DATA_FULL_POOL = 130  # SHARD_GEOM's 8 x 16 + scratch, rounded up to even
# DDP step 1 against one card's 2-microbatch step (the same function: the
# mean of two half-batch losses and gradients), relative: the two runs
# differ only in where the halves' sum is taken
TOL_DDP = 1e-4
# FSDP blocks after step 1 against one card's, bf16 compute: the share of
# params whose gradient's sign differs (Adam's first step moves them 2·lr
# apart), and the first moment's relative error over a rank's blocks.
# Read on the H100 at llama-7b stage 2, 2 layers, (2, 2): 2.9-3.1e-4 and
# 2.8-2.9e-3 a rank; the limits are about 3x. A reduce-scatter that
# hands a rank another data row's chunk gives m_rel near sqrt(2) (two
# unrelated gradients of one size), a step that skips the clip
# 1 - 1/||g|| (0.96 there).
TOL_FSDP_FLIPS = 1e-3
TOL_FSDP_M = 1e-2
# The fsdp phase's pod MoE case (Phi-3.5-MoE, 1 layer, (2, 1, 2), bf16
# compute) against one card's step: the grad norm (relative), the flip
# share and m_rel. bf16 rounds the ranks' router inputs otherwise than
# one card's (the attention's sums over "model" in another order), so a
# token near a tie between two experts goes to another one, whose whole
# weight gradient then moves; read on an H100 80GB HBM3 at 700 W (the
# case's first run, rank 0): 1.2e-4, 1.36e-3, 9.0e-3, the limits about
# 3x. The same case at narrow widths on the CPU reads 0, 0 and 4e-7 in
# f32 and 2.7e-6, 7e-4 and 7e-3 in bf16: the split itself is exact.
TOL_FSDP_MOE = dict(grad_norm=5e-4, flips=4e-3, m_rel=3e-2)


def partial_parts_check(name, got, want, dtype) -> float:
    """The partial mode's (acc, m, l) rows against the plain version's: m
    equal where no key is on the rank (-1e30), else each of acc, m, l
    within the dtype's tolerance of its largest value."""
    hd = got.shape[-1] - 2
    gm, wm = got[..., hd], want[..., hd]
    empty = wm <= -1e29
    if not torch.equal(gm <= -1e29, empty):
        fail(f"{name}: rows with no key on the rank differ")
    err = compare(f"{name} (acc, l)", [got[..., :hd], got[..., hd + 1]],
                  [want[..., :hd], want[..., hd + 1]], dtype)
    return max(err, compare(f"{name} m", [gm[~empty]], [wm[~empty]], dtype))


def partial_case(name, dev, rng, b, W, kvp, g, hd, bs, nb, n_blocks, dtype,
                 min_end=None):
    """A pool of ``n_blocks`` cut in two halves (two data rows' local
    pools), each slot's pages drawn over the whole pool: each half's
    partial attention against its plain version, and the fold of the two
    against the whole-pool kernel call. Returns (max err, the arguments,
    the halves' (lo, n))."""
    from repro_torch.kernels import paged_attention as kpa

    def t(a, dt):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    q = t(rng.randn(b, W, kvp, g, hd), dtype)
    kp = t(rng.randn(n_blocks, kvp, bs, hd), dtype)
    vp = t(rng.randn(n_blocks, kvp, bs, hd), dtype)
    perm = rng.permutation(np.arange(1, n_blocks))[: b * nb].reshape(b, nb)
    end = rng.randint(min_end or W, nb * bs + 1, size=b)
    table = np.where(np.arange(nb)[None, :] * bs < end[:, None], perm, 0)
    table[0, :] = perm[0] % (n_blocks // 2)  # slot 0: the first half only
    pos = end[:, None] - W + np.arange(W)[None, :]
    table, pos = t(table, torch.int32), t(pos, torch.int32)
    halves = ((0, n_blocks // 2), (n_blocks // 2, n_blocks - n_blocks // 2))
    parts, err = [], 0.0
    for lo, n in halves:
        args = (q, kp[lo:lo + n], vp[lo:lo + n], table, pos)
        got = kpa.paged_window_attention_partial(*args, blocks=(lo, n))
        want = kpa.paged_window_attention_partial_plain(*args, blocks=(lo, n))
        torch.cuda.synchronize()
        err = max(err, partial_parts_check(
            f"partial {name} blocks {lo}+{n}", got, want, dtype))
        parts.append(got)
    folded = kpa.fold_partials(torch.stack(parts), (0, b), dtype)
    whole = kpa.paged_window_attention(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    err = max(err, compare(f"fold {name} vs the whole-pool kernel",
                           [folded], [whole], dtype))
    return err, (q, kp, vp, table, pos), halves, parts


def partial_kernel_rows(dev, kvp: int = 32, nb: int = 128,
                        n_blocks: int = 1026) -> dict:
    """Kernel 2's partial mode and its fold: f32 at the parity shapes
    (tiny-relu / tiny-opt geometry, W = 1 and 5), bf16 at the data phase's
    Mixtral decode and chunk and OPT-6.7B chunk shapes and at OPT-6.7B
    decode over two halves of the pool; the OPT decode's second half's
    call timed (per
    call and on the card) with its bound, the plain version and SDPA over
    the half's keys (K and V gathered and expanded before timing, a
    boolean mask; it returns o, not the partials), and the fold of the
    two halves."""
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models.common import paged_gather
    rng = np.random.RandomState(25)
    errs = {}
    for W in (1, 5):
        errs[f"f32 W={W}"] = partial_case(
            f"tiny f32 W={W}", dev, rng, 4, W, 2, 2, 16, 8, 6, 26,
            torch.float32)[0]
        errs[f"f32 MHA W={W}"] = partial_case(
            f"tiny-opt f32 W={W}", dev, rng, 4, W, 4, 1, 16, 8, 6, 26,
            torch.float32)[0]
    # bf16 at the data phase's other shapes (b = 8 slots gathered, nb =
    # 16 pages, DATA_FULL_POOL blocks): Mixtral decode (split into S > 1
    # runs, so the partials go through the split kernel's merge), the
    # 16-token chunk steps of Mixtral (S > 1) and OPT-6.7B
    splits, bf_errs = {}, {}
    for what, W, kv, g in (("Mixtral decode", 1, 8, 6),
                           ("Mixtral chunk", 16, 8, 6),
                           ("OPT-6.7B chunk", 16, 32, 1)):
        splits[what] = kpa.attention_splits(8, kv, 16, W * g, 128, 16,
                                            kpa._sm_count(dev))
        bf_errs[what] = partial_case(
            f"{what} bf16 W={W} S={splits[what]}", dev, rng, 8, W, kv, g,
            128, 16, 16, DATA_FULL_POOL, torch.bfloat16)[0]
    if splits["Mixtral decode"] <= 1:
        fail(f"the Mixtral decode case ran unsplit ({splits}): it is there "
             f"to check the split kernel's partials")
    err, (q, kp, vp, table, pos), halves, parts = partial_case(
        "OPT-6.7B decode bf16 at 1536-2048 tokens", dev, rng, 8, 1, kvp, 1,
        128, 16, nb, n_blocks, torch.bfloat16, min_end=nb * 12)
    err = max([err] + list(bf_errs.values()))
    b, W, kvp, g, hd = q.shape
    bs, nb = kp.shape[2], table.shape[1]
    lo, n = halves[1]
    k2, v2 = kp[lo:lo + n], vp[lo:lo + n]
    tab = table.cpu().numpy()
    mine = (tab >= lo) & (tab < lo + n)
    pos_np = pos.cpu().numpy()
    pages = valid = 0
    for t_ in range(b):
        lo_p, hi_p = kpa.needed_pages(pos_np[t_].tolist(), 0, bs, nb)
        for j in range(lo_p, hi_p + 1):
            if mine[t_, j]:
                pages += 1
                valid += sum(max(0, min(bs, p + 1 - j * bs))
                             for p in pos_np[t_])
    n_bytes = (pages * kvp * bs * hd * 2 * 2 + q.numel() * 2
               + table.numel() * 4 + pos.numel() * 4
               + b * W * kvp * g * (hd + 2) * 4)
    b_ms, b_by = bound(n_bytes, 4.0 * valid * g * kvp * hd, torch.bfloat16)
    local = torch.where(torch.as_tensor(mine, device=dev), table - lo, 0)
    keymask = torch.as_tensor(mine, device=dev).repeat_interleave(bs, 1)
    kg = paged_gather(k2, local).repeat_interleave(g, dim=1)
    vg = paged_gather(v2, local).repeat_interleave(g, dim=1)
    keys = torch.arange(kg.shape[2], device=dev)[None, None, :]
    am = ((keys <= pos[:, :, None]) & keymask[:, None, :])[:, None]
    qh = q.permute(0, 2, 3, 1, 4).reshape(b, kvp * g, W, hd)
    args = (q, k2, v2, table, pos)
    same_bits("paged_window_attention_partial OPT-6.7B decode",
              lambda: kpa.paged_window_attention_partial(*args,
                                                         blocks=(lo, n)))
    row = dict(
        name="paged_window_attention_partial", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:87",
        max_abs_err=err, max_abs_err_f32=max(errs.values()),
        shape=f"b=8 W=1 kvp={kvp} g=1 hd=128 bs=16 nb={nb}, pool blocks "
              f"{lo}..{lo + n - 1} of {n_blocks}, bf16",
        pages_on_rank=pages, bound_ms=b_ms, bound_by=b_by,
        splits=kpa.attention_splits(b, kvp, nb, W * g, hd, bs,
                                    kpa._sm_count(dev)),
        max_abs_err_bf16=bf_errs, splits_checked=splits,
        **timings(lambda: kpa.paged_window_attention_partial(
                      *args, blocks=(lo, n)),
                  lambda: kpa.paged_window_attention_partial_plain(
                      *args, blocks=(lo, n)),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      qh, kg, vg, attn_mask=am)))
    stacked = torch.stack(parts)
    f_bytes = stacked.numel() * 4 + q.numel() * 2
    f_ms, f_by = bound(f_bytes, 8.0 * stacked.numel(), torch.float32)
    fold = dict(
        name="paged_attention_fold", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:87",
        max_abs_err=err,
        shape=f"D=2 partials of b=8 W=1 kvp={kvp} g=1 hd=128",
        bound_ms=f_ms, bound_by=f_by, library_ms=None,
        **timings(lambda: kpa.fold_partials(stacked, (0, b), torch.bfloat16),
                  lambda: kpa.fold_partials_plain(stacked, (0, b),
                                                  torch.bfloat16)))
    log("  partial mode " + json.dumps(row))
    log("  fold " + json.dumps(fold))
    log(f"  ok partial mode f32 {json.dumps(errs)}")
    return {"paged_window_attention_partial": row,
            "paged_attention_fold": fold}


def data_case(case, device):
    """``shard_case`` with the data phase's modes: "drops" is tiny-moe at
    capacity 1.0 and routing groups of 3 tokens."""
    from repro_torch.configs import get_config
    arch, mode, chunk = case
    if mode != "drops":
        return shard_case(case, device)
    cfg = get_config(arch).replace(compute_dtype="float32",
                                   capacity_factor=1.0, moe_group_size=3)
    params = _to(numpy_params(cfg, seed=0), device)
    prompts = [np.random.RandomState(s).randint(0, cfg.vocab_size, n)
               for s, n in ((1, 9), (2, 5), (3, 13), (4, 21), (5, 3))]
    return cfg, params, dict(prefill_chunk=chunk), prompts


def data_streams(case, device, mesh=None) -> dict:
    """An f32 data-axis case through a fresh engine of 4 slots and
    DATA_POOL blocks (on ``mesh`` when given): streams, logprobs, metrics,
    the pool blocks it holds and its launches of the partial mode."""
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    cfg, params, kw, prompts = data_case(case, device)
    eng = ContinuousBatchingEngine(
        cfg, params, EngineConfig(n_slots=4, block_size=8,
                                  max_blocks_per_seq=6, n_blocks=DATA_POOL,
                                  mesh=mesh, **kw), device=device)
    uids = [eng.submit(p, 10, reuse_window=4) for p in prompts]
    n0 = kpa.paged_window_attention_partial.launches
    res = eng.run()
    return dict(partial=kpa.paged_window_attention_partial.launches - n0,
                tokens=[res[u].tokens.tolist() for u in uids],
                logprobs=np.concatenate([res[u].logprobs for u in uids]),
                accepted=[res[u].draft_accepted for u in uids],
                misses=[res[u].pred_misses for u in uids],
                metrics=eng.metrics_snapshot(), ffn_tp=eng.ffn_tp,
                blocks=eng.pages["k"].shape[1])


def data_parity_rank(rank: int, world: int, data: int,
                     device_type: str) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data, world // data, strict=True,
                          device=None if device_type == "cuda" else "cpu")
    return {case: data_streams(case, mesh.device, mesh)
            for case in DATA_CASES}


def data_parity(dev) -> None:
    """The f32 cases on (2, 1) and (2, 2) meshes on the card against the
    one-device CPU engine: tokens exactly, logprobs within 1e-5, the
    metrics within 1e-9, acceptance and misses equal; the weight bytes a
    step, whose scope depends on the path (the kernel path counts every
    projection, ROADMAP section C), against the one-device engine on the
    card, a rank's the figure / ffn_tp. Every rank holds DATA_POOL / 2
    blocks and launched the partial mode."""
    from repro_torch.sharding import comm
    want = {case: data_streams(case, torch.device("cpu"))
            for case in DATA_CASES}
    for case, w in want.items():
        w["metrics"]["weight_io_bytes_per_step"] = data_streams(
            case, dev)["metrics"]["weight_io_bytes_per_step"]
    for data, model in DATA_MESHES:
        t0 = time.perf_counter()
        ranks = comm.spawn(data_parity_rank, data * model, timeout=420,
                           args=(data, dev.type), device=dev.type)
        d = 0.0
        for rank, got in enumerate(ranks):
            for case, w in want.items():
                g = got[case]
                what = f"{case} mesh ({data}, {model}) rank {rank}"
                d = max(d, same_streams(what, (g["tokens"], g["logprobs"]),
                                        (w["tokens"], w["logprobs"])))
                if g["blocks"] != DATA_POOL // data:
                    fail(f"{what}: holds {g['blocks']} pool blocks")
                if g["partial"] <= 0:
                    fail(f"{what}: the partial mode was not launched")
                for k, v in w["metrics"].items():
                    v = v / g["ffn_tp"] if k == "weight_io_bytes_per_step" \
                        else v
                    got_k = g["metrics"].get(k, np.inf)
                    if abs(got_k - v) > 1e-9 * max(1, abs(v)):
                        fail(f"{what}: {k} {got_k} != {v}")
                if (g["accepted"], g["misses"]) != (w["accepted"],
                                                    w["misses"]):
                    fail(f"{what}: acceptance / misses differ")
        log(f"  ok data-axis f32 parity on ({data}, {model}): "
            f"{len(DATA_CASES)} cases x {data * model} ranks equal the CPU "
            f"engine (max|dlogprob| {d:.2e}); partial launches a rank "
            f"{[sum(r[c]['partial'] for c in DATA_CASES) for r in ranks]}; "
            f"{time.perf_counter() - t0:.1f} s")


def data_full_rank(rank: int, world: int, cases,
                   device_type: str) -> list:
    """One rank of full-width bf16 models on a (world, 1) mesh sharing
    the card, one (cfg, seed) case after the other in one rank group:
    the ranks build the seeded tree one after the other, each keeping its
    pool blocks; then the first prefill's logits, one decode step's and
    the serve run with every kernel counted from 0 and the collectives
    counted by axis; the engine is freed before the next case."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, 1, strict=True,
                          device=None if device_type == "cuda" else "cpu")
    return [data_full_case(rank, world, mesh, cfg, seed)
            for cfg, seed in cases]


def data_full_case(rank: int, world: int, mesh, cfg, seed: int) -> dict:
    """One case of ``data_full_rank`` on this rank's mesh."""
    from repro_torch.models import registry
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    from repro_torch.sharding import comm
    dev = mesh.device
    eng = None
    for r in range(world):
        if r == rank:
            params = registry.get_family(cfg).init_params(cfg, seed=0,
                                                          device=dev)
            eng = ContinuousBatchingEngine(
                cfg, params, EngineConfig(mesh=mesh, n_blocks=DATA_FULL_POOL,
                                          **SHARD_GEOM), device=dev)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        comm.barrier(mesh)
    logits = first_prefill_logits(eng, cfg, serve_prompts(cfg, seed)[0])
    s0, decode = first_decode_logits(eng, cfg, serve_prompts(cfg, seed))
    counters = kernel_counters()
    comm.STATS.reset()
    out, launches = counted(
        f"rank {rank} data axis {cfg.name}", counters,
        ("paged_window_attention_partial", "paged_attention_fold"),
        lambda: serve_run(eng, cfg, seed=seed))
    out.pop("_streams")
    st = comm.STATS
    steps = out["prefill_steps"] + out["decode_steps"]
    res = dict(
        rank=rank, launches=launches, logprobs=out.pop("_logprobs"),
        logits=logits.numpy(), serve=out, decode_s0=s0, decode_logits=decode.numpy(),
        pool_blocks=eng.pages["k"].shape[1],
        slots=list(eng.data.slots),
        per_step={axis: dict(count=n / steps, host_ms=sec * 1e3 / steps)
                  for axis, n, sec in (
                      ("data", st.data_count, st.data_seconds),
                      ("world", st.world_count, st.world_seconds),
                      ("model", st.count, st.seconds))})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    comm.barrier(mesh)
    return res


def data_full_width(dev, add, cases) -> None:
    """Each (cfg, seed) of ``cases`` (full width, bf16), the serve phase's
    8 greedy requests, on 2 ranks of a (2, 1) mesh sharing the card, the
    cases one after the other in one rank group: the first prefill's
    last-position logits within TOL_SHARD_LOGITS of one card's with the
    argmax equal; one decode step of the 8 slots over pages in both halves
    of the pool (``first_decode_logits``: kernel 2's partial mode, the
    fold, the data-axis gathers), each rank's slots' logits within
    TOL_SHARD_LOGITS of one card's (the argmax agreement printed); each
    rank holds half of the DATA_FULL_POOL blocks."""
    from repro_torch.models import registry
    from repro_torch.serving import ContinuousBatchingEngine, EngineConfig
    from repro_torch.sharding import comm
    wants = []
    for cfg, seed in cases:
        params = registry.get_family(cfg).init_params(cfg, seed=0, device=dev)
        eng = ContinuousBatchingEngine(cfg, params, EngineConfig(
            n_blocks=DATA_FULL_POOL, **SHARD_GEOM), device=dev)
        want = first_prefill_logits(eng, cfg, serve_prompts(cfg, seed)[0])
        _, want_dec = first_decode_logits(eng, cfg, serve_prompts(cfg, seed))
        wants.append((want, want_dec))
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_rank = comm.spawn(data_full_rank, 2, timeout=900,
                          args=(list(cases), dev.type), device=dev.type)
    log(f"  the {len(cases)} full-width cases on (2, 1) took "
        f"{time.perf_counter() - t0:.1f} s in one group of 2 ranks")
    for i, ((cfg, _), (want, want_dec)) in enumerate(zip(cases, wants)):
        ranks = [rr[i] for rr in per_rank]
        for r in ranks:
            got = torch.from_numpy(r["decode_logits"])
            ref = want_dec[r["decode_s0"]:r["decode_s0"] + got.shape[0]]
            dec_err = (got - ref).abs().max().item()
            dec_scale = ref.abs().max().item()
            if (not torch.isfinite(got).all()
                    or dec_err > TOL_SHARD_LOGITS * dec_scale):
                fail(f"{cfg.name} rank {r['rank']}: decode step logits of "
                     f"slots {r['decode_s0']}.. max|diff| {dec_err:.3e} "
                     f"(tolerance {TOL_SHARD_LOGITS} x {dec_scale:.3e})")
            r["decode_check"] = dict(
                slots=[r["decode_s0"], r["decode_s0"] + got.shape[0]],
                max_abs_diff=dec_err, max_abs=dec_scale,
                argmax_equal=int((got.argmax(-1) == ref.argmax(-1)).sum()))
        for r in ranks:
            got = torch.from_numpy(r["logits"])
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            argmax = bool(got.argmax() == want.argmax())
            if (not np.isfinite(r["logprobs"]).all()
                    or err > TOL_SHARD_LOGITS * scale or not argmax):
                fail(f"{cfg.name} rank {r['rank']}: first prefill logits "
                     f"max|diff| {err:.3e} (tolerance {TOL_SHARD_LOGITS} x "
                     f"{scale:.3e}), argmax equal {argmax}")
            if r["pool_blocks"] != DATA_FULL_POOL // 2:
                fail(f"{cfg.name} rank {r['rank']}: holds {r['pool_blocks']} "
                     f"pool blocks, not {DATA_FULL_POOL // 2}")
            add(r["launches"])
            log("  data " + json.dumps(dict(
                r["serve"], model=cfg.name, layers=cfg.n_layers, mesh=[2, 1],
                rank=r["rank"], slots=r["slots"], pool_blocks=r["pool_blocks"],
                of_pool_blocks=DATA_FULL_POOL,
                first_prefill_logits_max_abs_diff=err,
                first_prefill_logits_max_abs=scale, argmax_equal=argmax,
                decode_step_logits=r["decode_check"],
                collectives_per_step=r["per_step"], launches=r["launches"])))


_ONE_CARD_STEP1 = {}  # (config, batch) -> one card's step 1


def one_card_step1(dev, cfg, tc, batch, keep: bool = True) -> tuple:
    """One card's make_train_step over ``batch`` from params of seed
    ``tc.seed``: the reference the DDP and FSDP steps are held to (the
    same config, TrainConfig and batch in both phases, so it is computed
    once; without ``keep`` it is not kept). Returns (step 1's loss and
    grad norm, the params and the first moment after it, on the host)."""
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_map
    key = (cfg.to_json(), repr(tc), batch["tokens"].tobytes())
    if key not in _ONE_CARD_STEP1:
        params = registry.get_family(cfg).init_params(
            cfg, seed=tc.seed, device=dev, dtype=torch.float32)
        params, opt, one = make_train_step(cfg, tc)(
            params, adamw.init_opt_state(params),
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        host = tree_map(lambda t: t.to("cpu"), (params, opt.m))
        _ONE_CARD_STEP1[key] = ({k: float(one[k]) for k in ("loss",
                                                            "grad_norm")},
                                host)
        del params, opt, one
        gc.collect()
        torch.cuda.empty_cache()
    return _ONE_CARD_STEP1[key] if keep else _ONE_CARD_STEP1.pop(key)


def ddp_rank(rank: int, world: int, cfg, batch, device_type: str) -> dict:
    """One rank of the DDP run: 2 uncompressed steps, then 2 with int8
    error feedback from the same initial params, each timed with the card
    synchronised; the collectives and their host time (``comm.STATS``,
    data axis) and the peak memory."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, compression
    from repro_torch.sharding import comm
    from repro_torch.train.ddp import make_ddp_train_step
    from repro_torch.tree import flatten
    mesh = make_host_mesh(world, 1, strict=True,
                          device=None if device_type == "cuda" else "cpu")
    dev = mesh.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    out = {}
    for comp in ("none", "int8_ef"):
        tc = TrainConfig(remat_policy="minimal", learning_rate=1e-4,
                         warmup_steps=2, grad_compression=comp)
        params = T.init_params(cfg, seed=tc.seed, device=dev,
                               dtype=torch.float32)
        n = sum(p.numel() for p in flatten(params))
        opt, ef = adamw.init_opt_state(params), compression.init_ef_state(
            params)
        if comp == "none":
            ef = {}  # the uncompressed step leaves it untouched
        step = make_ddp_train_step(cfg, tc, mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        rows, ms, coll, n_coll = [], [], [], []
        for _ in range(2):
            comm.STATS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, ef, m = step(params, opt, ef, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            coll.append(comm.STATS.data_seconds * 1e3)
            n_coll.append(comm.STATS.data_count)
            rows.append({k: float(v) for k, v in m.items()})
        n_leaves = len(flatten(params))
        out[comp] = dict(
            metrics=rows, step_ms=ms, collective_ms=coll,
            collectives=n_coll,
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            params=n,
            wire_bytes=(4 * (n + 1) if comp == "none"
                        else n + 4 * (n_leaves + 1)))
        del params, opt, ef
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ddp_full_width(dev, cfg=None, dc=None) -> None:
    """llama-7b relufied to stage 2 at 2 of its 32 layers, f32 masters and
    bf16 compute, one 8 x 1024 batch of the synthetic corpus: one card's
    make_train_step (2 microbatches) for its step-1 loss and grad norm,
    then the DDP step on 2 ranks sharing the card (4 x 1024 a rank)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import relufication as rf
    from repro_torch.data.pipeline import DataConfig, PackedIterator
    from repro_torch.sharding import comm
    cfg = cfg or rf.relufy_stage2(get_config("llama-7b")).replace(
        n_layers=2, compute_dtype="bfloat16")
    dc = dc or DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                          batch_size=8)
    batch = next(PackedIterator(dc))
    tc = TrainConfig(remat_policy="minimal", learning_rate=1e-4,
                     warmup_steps=2, num_microbatches=2)
    want = one_card_step1(dev, cfg, tc, batch)[0]
    t0 = time.perf_counter()
    ranks = comm.spawn(ddp_rank, 2, timeout=600,
                       args=(cfg, batch, dev.type), device=dev.type)
    for r, got in enumerate(ranks):
        first = got["none"]["metrics"][0]
        for k, v in want.items():
            if abs(first[k] - v) > TOL_DDP * max(1.0, abs(v)):
                fail(f"DDP rank {r} step 1 {k} {first[k]} != one card's {v}")
        for comp in ("none", "int8_ef"):
            losses = [m["loss"] for m in got[comp]["metrics"]]
            if not np.isfinite(losses).all():
                fail(f"DDP rank {r} {comp}: non-finite losses {losses}")
            if comp == "int8_ef" and not losses[-1] < losses[0]:
                fail(f"DDP rank {r} int8_ef: losses do not fall {losses}")
            log("  ddp " + json.dumps(dict(
                got[comp], rank=r, compression=comp, layers=cfg.n_layers,
                tokens_a_rank=4 * 1024, one_card_step1=want)))
    log(f"  DDP on 2 ranks took {time.perf_counter() - t0:.1f} s")


def data_phase(dev, counters) -> dict:
    """Phase 10: the data axis (``rules.DataSplit``) with ranks sharing the
    card over gloo: the partial mode's kernel rows, f32 parity on (2, 1)
    and (2, 2), OPT-6.7B (8 layers) and Mixtral-8x22B (4 layers) at full
    width on (2, 1) in one rank group, then the DDP step. Returns the ranks' launches,
    summed."""
    gc.collect()
    torch.cuda.empty_cache()
    total = {name: 0 for name in counters}

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    t0 = time.perf_counter()
    DATA_KERNEL_ROWS.update(partial_kernel_rows(dev))
    log(f"  partial mode rows took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    data_parity(dev)
    log(f"  parity took {time.perf_counter() - t0:.1f} s")
    from repro_torch.configs import get_config
    data_full_width(dev, add, [
        (get_config("opt-6.7b").replace(compute_dtype="bfloat16",
                                        n_layers=8), 0),
        (get_config("mixtral-8x22b").replace(n_layers=4,
                                             compute_dtype="bfloat16"), 4)])
    t0 = time.perf_counter()
    ddp_full_width(dev)
    log(f"  ddp took {time.perf_counter() - t0:.1f} s")
    for name in ("fused_sparse_ffn", "paged_window_attention_partial",
                 "paged_attention_fold", "sparse_matmul_tokens"):
        if total[name] <= 0:
            fail(f"kernel {name} was not launched on the data-axis path")
    log(f"  launches summed over the ranks: {json.dumps(total)}")
    return total


# ---------------------------------------------------------------------------
# phase 12: the FSDP + TP train step and the sequence-sharded decode


def _stats() -> dict:
    """``comm.STATS`` by axis: count, host ms and payload bytes."""
    from repro_torch.sharding import comm
    st = comm.STATS
    return {axis: dict(count=getattr(st, p + "count"),
                       host_ms=getattr(st, p + "seconds") * 1e3,
                       payload_bytes=getattr(st, p + "bytes"))
            for axis, p in (("model", ""), ("data", "data_"),
                            ("pod", "pod_"), ("world", "world_"))}


def step1_vs_one_card(params, opt, lr: float, ref: str, shardings) -> dict:
    """This rank's param and first-moment blocks after step 1 against the
    same blocks of one card's (saved whole in ``ref``, restored through
    ``shardings``). One Adam step moves a param by about lr·sign(g) (the
    first step's update is g / (|g| + eps)), so a param whose gradient's
    sign differs is 2·lr apart: ``flips`` counts the elements more than lr
    apart, ``param_max`` is the largest difference over lr, and ``m_rel``
    the first moment's relative error (its norm over the rank's blocks):
    a block handed to another rank, a wrong clip or a wrong update shows
    in these, where the loss and norm before the update cannot."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.tree import flatten
    t0 = time.perf_counter()
    (rp, rm), _ = CheckpointManager(ref).restore(
        (shardings, shardings), 1, shardings=(shardings, shardings))
    flips, n, worst, dm, mm = 0, 0, 0.0, 0.0, 0.0
    for a, b in zip(flatten(params), flatten(rp)):
        d = (a - b).abs()
        flips += int((d > lr).sum())
        n += d.numel()
        worst = max(worst, float(d.max()) / lr)
    for a, b in zip(flatten(opt.m), flatten(rm)):
        dm += float((a - b).double().square().sum())
        mm += float(b.double().square().sum())
    return dict(flips=flips, elements=n, flip_share=flips / n,
                param_max_over_lr=worst, m_rel=(dm / mm) ** 0.5,
                seconds=time.perf_counter() - t0)


def fsdp_rank(rank: int, world: int, data: int, cfg, batches,
              device_type: str, ckpt: str, resume: bool, ref=None,
              pod=()) -> dict:
    """One rank of the FSDP run on a (data, world / data) mesh: from seeded
    params (or, with ``resume``, the step-2 checkpoint in ``ckpt``), one
    step per batch, each timed with the card synchronised, its
    collectives read from ``comm.STATS``, its peak memory; without
    ``resume`` the state is saved sharded after step 2, and with ``ref``
    its blocks after step 1 are held against one card's
    (``step1_vs_one_card``). The kernels' launch counts are set to 0
    first and returned. With ``resume`` (a (1, M) mesh) the rank then
    frees the state and runs ``seq_decode_rank`` ("decode"); with ``pod``
    it frees the state and runs ``fsdp_pod_case`` of each ("pod")."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding import comm
    from repro_torch.train import fsdp
    from repro_torch.tree import flatten
    started = time.time()
    mesh = make_host_mesh(data, world // data, strict=True,
                          device=None if device_type == "cuda" else "cpu")
    dev = mesh.device
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    tc = TrainConfig(**FSDP_TC, num_microbatches=2)
    shardings = fsdp.state_shardings(cfg, mesh)
    t0 = time.perf_counter()
    if resume:
        (params, opt), _ = CheckpointManager(ckpt).restore(
            shardings, 2, shardings=shardings)
    else:
        whole = T.init_params(cfg, seed=tc.seed, device=dev,
                              dtype=torch.float32)
        params, opt = fsdp.shard_train_state(whole, mesh, cfg)
        del whole
    gc.collect()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    state_gib = sum(x.numel() * x.element_size() for x in
                    flatten((params, opt.m, opt.v))) / 2 ** 30
    step = fsdp.make_fsdp_train_step(cfg, tc, mesh)
    rows, ms, coll, save_s, peak, vs_one = [], [], [], None, 0.0, None
    gauge = []
    for i, b in enumerate(batches):
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        comm.STATS.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        coll.append(_stats())
        gauge.append(dict(peak_bytes=fsdp.GAUGE.peak,
                          live_bytes=fsdp.GAUGE.live,
                          layer_gathers=len(fsdp.GAUGE.gathers),
                          layer_gather_bytes=sum(fsdp.GAUGE.gathers),
                          layer_reductions=fsdp.GAUGE.reductions))
        rows.append({k: float(v) for k, v in m.items()})
        if ref is not None and i == 0:
            vs_one = step1_vs_one_card(params, opt, rows[0]["lr"], ref,
                                       shardings[0])
            gc.collect()
            torch.cuda.empty_cache()
        if not resume and i == 1:
            t0 = time.perf_counter()
            CheckpointManager(ckpt).save(2, (params, opt),
                                         shardings=shardings)
            save_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    decode, pods = None, []
    if resume or pod:
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
    if resume:
        decode = seq_decode_rank(rank, world, device_type, mesh)
    for case in pod:
        pods.append(fsdp_pod_case(case, device_type))
    return dict(mesh=[data, world // data], metrics=rows, step_ms=ms,
                proc_start=os.stat(f"/proc/{os.getpid()}").st_ctime,
                started=started, ended=time.time(), decode=decode, pod=pods,
                collectives=coll, setup_s=setup_s, save_s=save_s,
                state_gib=state_gib, peak_gib=peak, launches=launches,
                step1_vs_one_card=vs_one, gauge=gauge,
                column_bytes=fsdp.layer_column_bytes(cfg, mesh))


def fsdp_pod_case(case: dict, device_type: str) -> dict:
    """One FSDP step of ``case`` (``fsdp_pod_inputs``) on a pod mesh of
    this group's ranks (every rank builds its groups), from params of seed
    ``FSDP_TC``'s: its metrics, ms (the card synchronised), collectives by
    axis, peak GiB, state GiB, the gauge against one layer's column, the
    kernels' launches in the step and, with ``case["ref"]``, its blocks
    after the step against one card's (``step1_vs_one_card``)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import registry
    from repro_torch.sharding import comm
    from repro_torch.train import fsdp
    from repro_torch.tree import flatten
    cfg = case["cfg"]
    mesh = make_pod_mesh(*case["mesh"],
                         device=None if device_type == "cuda" else "cpu")
    dev = mesh.device
    tc = TrainConfig(**FSDP_TC, num_microbatches=case["microbatches"])
    t0 = time.perf_counter()
    whole = registry.get_family(cfg).init_params(cfg, seed=tc.seed,
                                                 device=dev,
                                                 dtype=torch.float32)
    params, opt = fsdp.shard_train_state(whole, mesh, cfg)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    state_gib = sum(x.numel() * x.element_size() for x in
                    flatten((params, opt.m, opt.v))) / 2 ** 30
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in case["batch"].items()}
    step = fsdp.make_fsdp_train_step(cfg, tc, mesh)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    comm.STATS.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = dict(name=case["name"], mesh=list(case["mesh"]),
               microbatches=case["microbatches"],
               metrics={k: float(v) for k, v in m.items()}, step_ms=ms,
               collectives=_stats(), setup_s=setup_s, state_gib=state_gib,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               launches={n: c.launches for n, c in counters.items()},
               gauge_peak=fsdp.GAUGE.peak,
               layer_gathers=len(fsdp.GAUGE.gathers),
               layer_gather_bytes=sum(fsdp.GAUGE.gathers),
               column_bytes=fsdp.layer_column_bytes(cfg, mesh))
    if case.get("ref"):
        out["step1_vs_one_card"] = step1_vs_one_card(
            params, opt, out["metrics"]["lr"], case["ref"],
            fsdp.state_shardings(cfg, mesh)[0])
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def seq_decode_rank(rank: int, world: int, device_type: str, mesh,
                    b: int = 8, heads: int = 32, hd: int = 128,
                    S: int = 2048) -> dict:
    """One model rank of the sequence-sharded decode at OPT-6.7B decode
    shapes, bf16, on ``mesh`` (1, world): every rank draws the same q,
    caches and positions from one seed, keeps its slice of S and runs
    ``decode_attention`` under the mesh (partials, one gather, the fold),
    then the unsharded call on the whole caches. Returns the error in bf16 ulps of the
    unsharded result (the ulp of each head's output vector's largest
    |value|: the fold rounds p to bf16 before it divides, the unsharded
    call after, so an output near zero can differ by many of its own
    ulps), the fold's launches in the sharded call and both calls' ms."""
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models import common as cm
    from repro_torch.sharding import comm
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16
    q = torch.randn((b, heads, 1, hd), generator=gen, device=dev).to(bf)
    k = torch.randn((b, heads, S, hd), generator=gen, device=dev).to(bf)
    v = torch.randn((b, heads, S, hd), generator=gen, device=dev).to(bf)
    half = S // mesh.shape["model"]
    # rows in the first half only, on the boundary, and in the second
    pos = torch.tensor([5, S // 3, half - 1, half, half + 1, S - S // 6,
                        S - 2, S - 1][:b], dtype=torch.int32, device=dev)
    lo = mesh.coords["model"] * half
    kl, vl = (t[:, :, lo:lo + half].contiguous() for t in (k, v))
    kpa.fold_partials.launches = 0
    with comm.serving(mesh):
        got = cm.decode_attention(q, kl, vl, pos)
    torch.cuda.synchronize()
    launches = kpa.fold_partials.launches
    want = cm.window_attention(q[:, None], k, v, pos[:, None])[:, 0]
    wf = want.float()
    top = wf.abs().amax(-1, keepdim=True).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    err_ulps = float(((got.float() - wf).abs() / ulp).max())
    with comm.serving(mesh):
        sharded_ms = time_ms(lambda: cm.decode_attention(q, kl, vl, pos),
                             reps=10, warmup=2)
    whole_ms = time_ms(lambda: cm.window_attention(q[:, None], k, v,
                                                   pos[:, None]),
                       reps=10, warmup=2)
    return dict(err_ulps=err_ulps, finite=bool(torch.isfinite(got).all()),
                fold_launches=launches, sharded_ms=sharded_ms,
                unsharded_ms=whole_ms, shape=[b, heads, S, hd])


# the fsdp phase's train settings (every case; the microbatches its own)
FSDP_TC = dict(remat_policy="minimal", learning_rate=1e-4, warmup_steps=2)
# its pod cases on the (2, 2) group's 4 ranks (the module note's fsdp
# phase): (a) an MoE config at full width, its experts split over pod x
# data; (b) the phase's llama-7b with microbatches of fewer rows than the
# data rows of pod x data. mesh: (pod, data, model)
FSDP_POD_MOE = dict(name="moe", arch="phi3.5-moe-42b-a6.6b", layers=1,
                    mesh=(2, 1, 2), batch=4, seq=1024, microbatches=2)
FSDP_POD_ROWS = dict(name="rows", mesh=(2, 2, 1), microbatches=4)


def fsdp_pod_inputs(dev, cfg, batch, moe_cfg=None) -> tuple:
    """The fsdp phase's pod cases for ``fsdp_pod_case``: (b) ``cfg`` on
    FSDP_POD_ROWS's mesh over ``batch`` in its microbatches; (a)
    FSDP_POD_MOE's config (``moe_cfg`` replaces it) over a batch of the
    synthetic corpus. One card's step of each first (``one_card_step1``,
    not kept). Returns (the cases, {name: one card's loss and grad norm},
    {name: one card's params and first moment on the host}: (a)'s, which
    the caller saves where the case's ``ref`` says)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import DataConfig, PackedIterator
    a = FSDP_POD_MOE
    moe_cfg = moe_cfg or get_config(a["arch"]).replace(
        n_layers=a["layers"], compute_dtype="bfloat16")
    moe_batch = next(PackedIterator(DataConfig(
        vocab_size=moe_cfg.vocab_size, seq_len=a["seq"],
        batch_size=a["batch"])))
    cases, want, states = [], {}, {}
    for case, c, b, ref in (
            (FSDP_POD_ROWS, cfg, batch, None),
            (a, moe_cfg, moe_batch,
             str(ROOT / "build" / "fsdp_pod_one_card"))):
        tc = TrainConfig(**FSDP_TC, num_microbatches=case["microbatches"])
        t0 = time.perf_counter()
        want[case["name"]], state = one_card_step1(dev, c, tc, b,
                                                   keep=False)
        log(f"  pod case {case['name']}: one card's step took "
            f"{time.perf_counter() - t0:.1f} s")
        if ref:
            states[case["name"]] = state
        del state
        cases.append(dict(name=case["name"], cfg=c, batch=b,
                          mesh=case["mesh"],
                          microbatches=case["microbatches"], ref=ref))
    return cases, want, states


def fsdp_pod_check(r: int, got: dict, want: dict) -> None:
    """Rank ``r``'s pod case (``fsdp_pod_case``) against one card's step:
    logged first, then loss and grad norm within TOL_DDP (the MoE case's
    grad norm within TOL_FSDP_MOE), no kernel launched, the gauge within
    two layers' columns and, where the blocks were held, within
    TOL_FSDP_MOE's flips and m_rel."""
    name = got["name"]
    c = got["collectives"]
    log(f"  fsdp pod {name} rank {r} on {tuple(got['mesh'])} in "
        f"{got['microbatches']} microbatches: peak {got['peak_gib']:.3f} "
        f"GiB (state {got['state_gib']:.3f}), gauge peak "
        f"{got['gauge_peak'] / 2 ** 30:.3f} GiB (one layer's column "
        f"{got['column_bytes'] / 2 ** 30:.3f} GiB), step "
        f"{got['step_ms']:.1f} ms, collectives (count, host ms, bytes) "
        + ", ".join(f"{ax} ({c[ax]['count']}, {c[ax]['host_ms']:.1f}, "
                    f"{c[ax]['payload_bytes']})"
                    for ax in ("model", "data", "pod", "world")))
    log("  fsdp pod " + json.dumps(dict(got, rank=r, one_card_step1=want)))
    if any(got["launches"].values()):
        fail(f"FSDP pod {name} rank {r} launched kernels: {got['launches']}")
    first = got["metrics"]
    if not np.isfinite([first["loss"], first["grad_norm"]]).all():
        fail(f"FSDP pod {name} rank {r}: non-finite metrics {first}")
    moe = name == FSDP_POD_MOE["name"]
    for k, v in want.items():
        tol = TOL_FSDP_MOE[k] if moe and k == "grad_norm" else TOL_DDP
        if abs(first[k] - v) > tol * max(1.0, abs(v)):
            fail(f"FSDP pod {name} rank {r} step 1 {k} {first[k]} != one "
                 f"card's {v} (tolerance {tol})")
    if got["gauge_peak"] > 2 * got["column_bytes"]:
        fail(f"FSDP pod {name} rank {r}: {got['gauge_peak']} bytes of "
             "gathered layers alive at once, over two layers' columns "
             f"({got['column_bytes']} bytes each)")
    vs = got.get("step1_vs_one_card")
    if vs is not None and (vs["flip_share"] > TOL_FSDP_MOE["flips"]
                           or vs["param_max_over_lr"] > 2.0 + 1e-3
                           or vs["m_rel"] > TOL_FSDP_MOE["m_rel"]):
        fail(f"FSDP pod {name} rank {r}: its blocks after step 1 are not "
             f"one card's: {vs}")


def fsdp_full_width(dev, cfg=None, dc=None, moe_cfg=None) -> list:
    """llama-7b relufied to stage 2 at 2 of its 32 layers on a (2, 2) mesh
    of ranks sharing the card: one card's make_train_step for step 1's
    loss and grad norm, then 3 FSDP steps, saved after step 2, then the
    pod cases (``fsdp_pod_inputs``; ``moe_cfg`` replaces (a)'s config) on
    the same ranks, then step 3 again on a (1, 2) mesh restored from that
    save. The train steps must launch no kernel. Returns the (1, 2)
    ranks' decode results (``seq_decode_rank``)."""
    import shutil
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import relufication as rf
    from repro_torch.data.pipeline import DataConfig, PackedIterator
    from repro_torch.sharding import comm
    cfg = cfg or rf.relufy_stage2(get_config("llama-7b")).replace(
        n_layers=2, compute_dtype="bfloat16")
    dc = dc or DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                          batch_size=8)
    it = PackedIterator(dc)
    batches = [next(it) for _ in range(3)]
    tc = TrainConfig(**FSDP_TC, num_microbatches=2)
    want, one_state = one_card_step1(dev, cfg, tc, batches[0])
    ckpt = str(ROOT / "build" / "fsdp_ckpt")
    ref = str(ROOT / "build" / "fsdp_one_card")
    pod_cases, pod_want, pod_states = fsdp_pod_inputs(dev, cfg, batches[0],
                                                      moe_cfg)
    refs = [ckpt, ref] + [c["ref"] for c in pod_cases if c["ref"]]
    for d in refs:
        shutil.rmtree(d, ignore_errors=True)

    def group(world, data, batches, resume):
        t0 = time.time()
        out = comm.spawn(fsdp_rank, world, timeout=600,
                         args=(data, cfg, batches, dev.type, ckpt, resume,
                               None if resume else ref,
                               () if resume else pod_cases),
                         device=dev.type)
        t1 = time.time()
        log(f"  ({data}, {world // data}) took {t1 - t0:.1f} s: the "
            f"processes began after "
            f"{max(r['proc_start'] for r in out) - t0:.1f} s, the step "
            f"function after {max(r['started'] for r in out) - t0:.1f} s, "
            f"the group ended {t1 - max(r['ended'] for r in out):.1f} s "
            "after the last rank returned")
        return out

    try:
        t0 = time.perf_counter()
        CheckpointManager(ref).save(1, one_state)
        for c in pod_cases:
            if c["ref"]:
                CheckpointManager(c["ref"]).save(1, pod_states.pop(c["name"]))
        log(f"  one card's step-1 params and first moments saved in "
            f"{time.perf_counter() - t0:.1f} s")
        ranks = group(4, 2, batches, False)
        resumed = group(2, 1, batches[2:], True)
    finally:
        for d in refs:
            shutil.rmtree(d, ignore_errors=True)
    PLAN_INPUTS["fsdp_step1"] = ranks[0]["collectives"][0]
    PLAN_INPUTS["fsdp_pod_moe"] = next(
        p["collectives"] for p in ranks[0]["pod"]
        if p["name"] == FSDP_POD_MOE["name"])
    pods = [got.pop("pod") for got in ranks]
    step3 = ranks[0]["metrics"][2]
    for r, got in enumerate(ranks + resumed):
        first = got["metrics"][0]
        if any(got["launches"].values()):
            fail(f"FSDP rank {r} launched kernels: {got['launches']}")
        losses = [m["loss"] for m in got["metrics"]]
        if not np.isfinite(losses).all():
            fail(f"FSDP rank {r}: non-finite losses {losses}")
        gauge_peak = max(g["peak_bytes"] for g in got["gauge"])
        if gauge_peak > 2 * got["column_bytes"]:
            fail(f"FSDP rank {r}: {gauge_peak} bytes of gathered layers "
                 f"alive at once, over two layers' columns "
                 f"({got['column_bytes']} bytes each)")
        log(f"  fsdp rank {r % 4} on {tuple(got['mesh'])}: peak "
            f"{got['peak_gib']:.3f} GiB, gauge peak "
            f"{gauge_peak / 2 ** 30:.3f} GiB (one layer's column "
            f"{got['column_bytes'] / 2 ** 30:.3f} GiB), step ms "
            f"{[round(t, 1) for t in got['step_ms']]}, data collectives a "
            "step (count, host ms, bytes) "
            f"{[(c['data']['count'], round(c['data']['host_ms'], 1), c['data']['payload_bytes']) for c in got['collectives']]}")
        if r < 4:
            for k, v in want.items():
                if abs(first[k] - v) > TOL_DDP * max(1.0, abs(v)):
                    fail(f"FSDP rank {r} step 1 {k} {first[k]} != one "
                         f"card's {v}")
            vs = got["step1_vs_one_card"]
            if (vs["flip_share"] > TOL_FSDP_FLIPS
                    or vs["param_max_over_lr"] > 2.0 + 1e-3
                    or vs["m_rel"] > TOL_FSDP_M):
                fail(f"FSDP rank {r}: its blocks after step 1 are not one "
                     f"card's: {vs}")
        elif abs(first["loss"] - step3["loss"]) > TOL_DDP * abs(
                step3["loss"]):
            fail(f"FSDP resumed on (1, 2), rank {r - 4}: step 3 loss "
                 f"{first['loss']} != the (2, 2) run's {step3['loss']}")
        log("  fsdp " + json.dumps(dict(got, rank=r % 4, layers=cfg.n_layers,
                                        one_card_step1=want)))
    for r, cases in enumerate(pods):
        for p in cases:
            fsdp_pod_check(r, p, pod_want[p["name"]])
    return [r["decode"] for r in resumed]


def fsdp_phase(dev, counters) -> dict:
    """Phase 12: the FSDP + TP train step on (2, 2) and its resume on
    (1, 2), whose ranks then run the sequence-sharded decode. Returns the
    ranks' launches, summed (the fold's, from the decode)."""
    gc.collect()
    torch.cuda.empty_cache()
    total = {name: 0 for name in counters}
    t0 = time.perf_counter()
    ranks = fsdp_full_width(dev)
    log(f"  took {time.perf_counter() - t0:.1f} s")
    for r, got in enumerate(ranks):
        if not got["finite"] or got["err_ulps"] > 1.0:
            fail(f"seq-sharded decode rank {r}: {got['err_ulps']} bf16 ulps "
                 "from the unsharded call")
        if got["fold_launches"] <= 0:
            fail("kernel paged_attention_fold was not launched by the "
                 "sequence-sharded decode")
        total["paged_attention_fold"] += got["fold_launches"]
        log("  seq-sharded decode " + json.dumps(dict(got, rank=r)))
    log(f"  launches summed over the ranks: {json.dumps(total)}")
    return total


# what the plan phase holds its dry runs against, from earlier phases
PLAN_INPUTS = {}
TOL_PLAN_PEAK = 0.10
# (a)'s temporaries (peak over held bytes) against the plan's temp_bytes
# (PR 30's card: 17408 B apart in 587767296 B)
TOL_PLAN_TEMP = 0.05
# the fsdp phase's data collectives a step, as PR 28 recorded them
PR28_DATA_STEP = (17, 4043390992)
# its pod MoE case's (FSDP_POD_MOE) data- and pod-axis collectives a step
# on the card: {axis: (count, payload bytes)}, as first read there
POD_MOE_STEP = {"data": (9, 10687447056), "pod": (0, 0)}
# (a): the arch, its sparse cell's FFN tile density, the global batch,
# the cache's positions and the layers (0: all)
PLAN_A = dict(arch="qwen3-4b", sparse=0.6, batch=4, seq=32768, layers=0)
# each dry run: (the cell, ``launch.dryrun``'s arguments beyond it)
PLAN_CELLS = {
    "a": (dict(arch=PLAN_A["arch"], shape="decode_32k",
               sparse=PLAN_A["sparse"]),
          ["--mesh", "1,1", "--batch", str(PLAN_A["batch"]), "--seq",
           str(PLAN_A["seq"]), "--layers", str(PLAN_A["layers"])]),
    "b": (dict(arch="llama-7b", shape="train_4k", microbatches=2,
               remat="minimal"),
          ["--relufy-stage", "2", "--layers", "2", "--mesh", "2,2",
           "--batch", "8", "--seq", "1024"]),
    "pod": (dict(arch=FSDP_POD_MOE["arch"], shape="train_4k",
                 microbatches=FSDP_POD_MOE["microbatches"], remat="minimal"),
            ["--layers", str(FSDP_POD_MOE["layers"]), "--mesh",
             ",".join(map(str, FSDP_POD_MOE["mesh"])), "--batch",
             str(FSDP_POD_MOE["batch"]), "--seq", str(FSDP_POD_MOE["seq"])]),
    "c_train": (dict(arch="qwen3-4b", shape="train_4k", microbatches=8), []),
    "c_decode": (dict(arch="qwen3-4b", shape="decode_32k", sparse=0.6), []),
}


def dry_run_records(timeout: float = 240.0) -> dict:
    """Every ``PLAN_CELLS`` dry run, each in a process of its own on the
    CPU (a fake world), all at once: {name: record}; fails when one fails
    or outlasts ``timeout``."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.launch import dryrun
    with ThreadPoolExecutor(len(PLAN_CELLS)) as pool:
        futs = {name: pool.submit(dryrun.run_subprocess, cell, extra,
                                  timeout)
                for name, (cell, extra) in PLAN_CELLS.items()}
        out = {name: f.result() for name, f in futs.items()}
    for name, rec in out.items():
        if "error" in rec:
            fail(f"the dry run of plan cell {name} failed:\n{rec['error']}")
    return out


def kernel5_bound_bytes(step) -> tuple:
    """``step()`` with kernel 5's wrapper recording each call: (its calls,
    the bytes they must move by ``sparse_matmul_cost``, nvalid read off
    the card after the step)."""
    from repro_torch.kernels import sparse_matmul as ksm
    from repro_torch.launch.op_cost import sparse_matmul_cost
    fn, seen = ksm.sparse_matmul, []
    ksm.sparse_matmul = _Recording(fn, (), seen)
    try:
        step()
    finally:
        ksm.sparse_matmul = fn
    total = 0
    for (x, w, idx, nvalid), kw in seen:
        total += sparse_matmul_cost(
            x.shape[0], w.shape[1], idx.shape[0], int(nvalid),
            kw.get("tile", 128), x.element_size(), w.element_size())[0]
    return len(seen), total


def plan_card(dev, counters):
    """(a)'s step on the card: returns its measured figures and the
    path's launches (kernel 5 counted, its first call then held against
    its plain version)."""
    from repro_torch.launch.dryrun import cell_config
    from repro_torch.models import transformer as T
    cfg = cell_config(PLAN_A["arch"], sparse=PLAN_A["sparse"],
                      layers=PLAN_A["layers"])
    B, S = PLAN_A["batch"], PLAN_A["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    # cuBLAS's workspace comes from the caching allocator on a process's
    # first matmul: the library's, outside the plan, so it is made before
    # the base reading (without earlier phases it is the step's 32 MiB)
    before = torch.cuda.memory_allocated(dev)
    x = torch.ones((16, 16), device=dev, dtype=torch.bfloat16)
    (torch.nn.functional.linear(x, x, x[0]) + x @ x).sum().item()
    del x
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    workspace = base - before
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    cache = T.init_cache(cfg, B, S, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    token = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                          device=dev, dtype=torch.int32)
    pos = torch.full((B,), S // 2, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated(dev) - base

    def step():
        with torch.inference_mode():
            return T.decode_step(params, cache, token, pos, cfg)[0]

    torch.cuda.reset_peak_memory_stats(dev)
    logits, launches = counted("plan (a) qwen3-4b decode", counters,
                               ["sparse_matmul"], step)
    peak = torch.cuda.max_memory_allocated(dev) - base
    if not torch.isfinite(logits[:, :cfg.vocab_size].float()).all():
        fail("plan (a): non-finite logits")
    del logits
    ms = time_ms(step, reps=5, warmup=1)
    with first_calls((("sparse_matmul", "sparse_matmul"),)) as calls:
        step()
    held_calls = check_first_calls(calls)
    k5_calls, k5_bytes = kernel5_bound_bytes(step)
    out = dict(held_bytes=held, peak_bytes=peak, step_ms=ms,
               setup_s=setup_s, kernel5_vs_plain=held_calls,
               workspace_bytes=workspace, kernel5_calls=k5_calls,
               kernel5_bound_bytes=k5_bytes)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def plan_phase(dev, counters) -> dict:
    """Phase 14: the production cell plan against the card (module note).
    Returns the launches of (a)'s counted step."""
    from repro_torch.launch.roofline import table
    card, launches = plan_card(dev, counters)
    t0 = time.perf_counter()
    recs = dry_run_records()
    log(f"  plan dry runs: {time.perf_counter() - t0:.1f} s, side by side")
    a = recs["a"]
    log("  plan (a) " + json.dumps(dict(card, planned_arg_bytes=a[
        "arg_bytes"], planned_peak_bytes=a["peak_bytes_per_chip"],
        planned_temp_bytes=a["temp_bytes"], t_compute=a["t_compute"],
        t_memory=a["t_memory"], t_collective=a["t_collective"],
        dry_run_host_s=a["host_s"])))
    if card["held_bytes"] != a["arg_bytes"]:
        fail(f"plan (a): the card holds {card['held_bytes']} B of weights, "
             f"cache and inputs after set-up, the plan {a['arg_bytes']} B")
    peak_ratio = card["peak_bytes"] / a["peak_bytes_per_chip"]
    if abs(peak_ratio - 1.0) > TOL_PLAN_PEAK:
        fail(f"plan (a): the step's peak {card['peak_bytes']} B is "
             f"{peak_ratio:.4f} x the planned {a['peak_bytes_per_chip']} B")
    temp = card["peak_bytes"] - card["held_bytes"]
    temp_err = abs(temp - a["temp_bytes"]) / a["temp_bytes"]
    if temp_err > TOL_PLAN_TEMP:
        fail(f"plan (a): the step's temporaries {temp} B (peak over held) "
             f"are {temp_err:.4f} off the planned {a['temp_bytes']} B")
    k5 = a["kernels"]["sparse_matmul"]
    log(f"  plan (a) kernel 5: the dry run charges {k5['bytes']:.0f} B over "
        f"{k5['launches']:.0f} launches; the card's {card['kernel5_calls']} "
        f"calls must move {card['kernel5_bound_bytes']} B by the bound's "
        "formula")
    if (k5["bytes"] != card["kernel5_bound_bytes"]
            or k5["launches"] != card["kernel5_calls"]):
        fail("plan (a): the dry run's kernel 5 bytes differ from its "
             "bound's bytes on the card")
    t_max = max(a["t_compute"], a["t_memory"], a["t_collective"])
    log(f"  plan (a) memory: held {card['held_bytes']} B = planned "
        f"{a['arg_bytes']} B; peak {card['peak_bytes']} B vs planned "
        f"{a['peak_bytes_per_chip']} B (ratio {peak_ratio:.4f}, tol "
        f"{TOL_PLAN_PEAK}); temporaries {temp} B vs planned "
        f"{a['temp_bytes']} B ({temp - a['temp_bytes']:+d} B, "
        f"{temp_err:.6f} of the plan, tol {TOL_PLAN_TEMP}); "
        f"step {card['step_ms']:.3f} ms vs the plan's "
        f"largest term ({a['bottleneck']}) {t_max * 1e3:.3f} ms: the plan "
        f"is {t_max * 1e3 / card['step_ms']:.4f} of the measured step")
    b = recs["b"]["collectives_by_axis"]
    got = PLAN_INPUTS.get("fsdp_step1")
    if got is None:
        want = {"data": dict(count=PR28_DATA_STEP[0],
                             payload_bytes=PR28_DATA_STEP[1])}
        log("  plan (b): the fsdp phase did not run; its data axis is held "
            "against PR 28's recorded 17 collectives and 4043390992 B")
    else:
        want = {ax: dict(count=got[ax]["count"],
                         payload_bytes=got[ax]["payload_bytes"])
                for ax in ("model", "data", "world")}
    for ax, w in want.items():
        if b[ax] != w:
            fail(f"plan (b): the dry run counts {b[ax]} over {ax}, the "
                 f"fsdp phase's rank 0 {w}")
    log("  plan (b) collectives a step by axis, dry run "
        f"{json.dumps(b)} = the card's rank 0 {json.dumps(want)}")
    pod = recs["pod"]["collectives_by_axis"]
    got = PLAN_INPUTS.get("fsdp_pod_moe")
    if got is None:
        want = {ax: dict(count=n, payload_bytes=nb)
                for ax, (n, nb) in POD_MOE_STEP.items()}
        log("  plan (pod): the fsdp phase did not run; held against its "
            f"first card reading {json.dumps(want)}")
    else:
        want = {ax: dict(count=got[ax]["count"],
                         payload_bytes=got[ax]["payload_bytes"])
                for ax in ("data", "pod")}
    for ax, w in want.items():
        if pod[ax] != w:
            fail(f"plan (pod): the dry run counts {pod[ax]} over {ax}, the "
                 f"fsdp phase's pod MoE case on rank 0 {w}")
    log(f"  plan (pod) {FSDP_POD_MOE['arch']} train_4k on "
        f"{FSDP_POD_MOE['mesh']}, collectives a step by axis: dry run "
        f"{json.dumps(pod)}; the card's rank 0 {json.dumps(want)}")
    for name in ("c_train", "c_decode"):
        r = recs[name]
        if "error" in r or not r.get("fits"):
            fail(f"plan (c) {name}: {r.get('error') or 'does not fit'}")
    log("  plan (c) rows on (16, 16), modeled from the H100 constants:\n"
        + table([recs["c_train"], recs["c_decode"]]))
    for name in ("c_train", "c_decode"):
        log(f"  plan (c) {name} " + json.dumps(
            {k: v for k, v in recs[name].items() if k != "profile"}))
    return launches


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
    from repro_torch.kernels import runtime as rt

    dev = torch.device("cuda", 0)
    card = card_name()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = time.perf_counter()
    log(f"[build] {rt.build():.1f} s")
    results = {}
    if "kernels" in phases:
        log("[kernels]")
        t0 = time.perf_counter()
        results = kernel_phase(dev)
        log(f"[kernels] took {time.perf_counter() - t0:.1f} s")
    if "parity" in phases:
        log("[parity]")
        t0 = time.perf_counter()
        parity_phase(dev)
        log(f"[parity] took {time.perf_counter() - t0:.1f} s")
    counters = kernel_counters()
    launches = {name: 0 for name in counters}
    for phase, run in (("api", api_phase), ("serve", serve_phase),
                       ("examples", examples_phase),
                       ("families", families_phase), ("zoo", zoo_phase),
                       ("train", train_phase),
                       ("sharded", sharded_phase), ("data", data_phase),
                       ("fsdp", fsdp_phase), ("plan", plan_phase)):
        if phase in phases:
            log(f"[{phase}]")
            t0 = time.perf_counter()
            for name, n in run(dev, counters).items():
                launches[name] += n
            log(f"[{phase}] took {time.perf_counter() - t0:.1f} s")
    results.update(DATA_KERNEL_ROWS)
    if {"api", "serve", "examples", "families", "zoo", "sharded", "data",
            "fsdp", "plan"} & set(phases):
        for r in results.values():
            r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms")
    line = {"kernels": [{k: r.get(k) for k in keys} for r in results.values()]}
    log(f"[all] {time.perf_counter() - start:.1f} s")
    log(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
