#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):

  1. device  -- the card's name, the device count and nvidia-smi's name and
                power limit; no CUDA device is a failure;
  2. build   -- nvcc builds every kernel source in the checkout;
  3. kernels -- each of the seventeen kernels against its plain torch version on
                the card, at the full-width main-path shapes of Qwen3-0.6B (serving:
                batch 4, prompt 256; training: batch 8, sequence 128;
                continuous decode: 8 slots over a paged pool), of
                phi3.5-moe-42b (its projections, read-out and attention)
                and of mamba2-130m (its projections and read-out; the SSD
                scan at serving, 96 groups x 4 chunks of 256, and training,
                192 groups with the entering states; the diag form
                flattened), of phi3-mini-3.8b (its prefill and training
                attention at head dim 96), starcoder2-15b (its biased gelu
                up projection), recurrentgemma-9b (lin_y with its bias and
                gelu, the GeGLU gate, the 256,000-column read-out),
                grok-1-314b (its gelu gate at the 8 x 6144 x 32,768 expert
                bank), internvl2-1b (its projector's bias + gelu GEMM, its
                d 64 prefill and training attention) and
                seamless-m4t-large-v2 (its relu up projection; non-causal
                flash at d 64: the encoder over 1,000 frames, the
                cross-attention of a 256-token prefill and of a decode
                step's one query row, and in training the encoder over 512
                frames and cross-attention of 128 tokens, forward and
                backward)
                and ragged cases, with errors, kernel / plain /
                library times (CUDA events) and the bound; the GEMM rows
                also on cases that drive each route of gemm.cu (every
                epilogue, C_in, batches of 3, K < 32, decode rows 1-16
                with K split over a cluster, rows past a palette edge, a
                192-row table, operands TMA cannot read), each row naming
                its route and split (a main-path bf16 row off routes A and
                B fails), the decode rows (M <= 16) also their device time
                and their time after an L2 flush (CUDA graphs, beside the
                library's); the GEMM backward's fused recompute
                (gemm_act_bwd) at the training rows of qwen3-0.6b's and
                phi3-mini's gates (phi3-mini's at 8 x 4,096) and of
                starcoder2's biased gelu up projection (fp32 output), and
                on routes B and C, against its fp32 form, each row naming
                its route; the flash forwards (fused and dense) on the
                main-path shapes and on cases that drive each route of
                flash_fwd.cu (ragged causal and non-causal bf16, heads of
                very different magnitude, d 36: route C, fp32), each row
                naming its route (a main-path bf16 row off route A fails)
                and its device time beside SDPA's (CUDA graphs); the
                forward also in its LSE form, the flash backward (the
                training shapes, route A's ragged and clamped edges in bf16,
                d 36 on route C, fp32; each row naming its route, a
                main-path row off route A failing, and its device time
                beside SDPA's autograd backward), the paged decode
                (each row naming its route, a bf16 row off route A or the
                fp32 row off B failing, with its device time warm and after
                an L2 flush beside SDPA's over the gathered pages, and the
                share of elements not bit-equal to the plain version),
                the SSD scan, its backward and the intra-chunk ladder
                (each row naming its route, a main-path row off route A
                failing, two runs bit-equal, with its device time beside
                the composition's, or its autograd backward's; every SSD
                bound prices fp32 operands as bf16 hi + lo tensor-core
                products, the earlier fp32 CUDA-core figure beside it), and
                the three grouped-GEMM kernels at phi3.5-moe-42b's expert
                shapes (4096 capacity rows at prefill and training, 512 at
                decode) and on ragged cases with an empty expert, whose dW
                must be exactly zero, the backward on its three routes
                (each row naming its route, a main-path row off route A
                failing, two runs bit-equal, dX rows past the groups' sum
                exactly zero, also with NaN in x and dY there, its device
                time beside the composition's, its bound pricing the fp32
                cotangent as bf16 hi + lo tensor-core products, the earlier
                fp32 CUDA-core figure beside it), the forwards also on cases that drive
                the wgmma tile (every epilogue, every pinned (bm, bn),
                groups of 1-65 rows, K 24 and 200, route C, NaN past the
                groups' sum), each row naming its route (a main-path row
                off route A fails), the decode rows also their device time
                (CUDA graphs, beside torch.bmm's) and on pinned bm 16 and
                64 tiles; then the transpose (fig89's panel and
                Qwen3's tied table on route A, route A at every other
                element size, a ragged batch read from a padded view
                holding NaN among them, and route B on a view TMA cannot
                address: bit-exact, each row naming its route, a main-path
                row off route A failing, with its device time warm and
                L2-cold beside the library's), the quantized GEMM (Qwen3's seven
                projection shapes at decode and prefill rows under W8A16,
                int8 and fp8), paged decode over KV-int8 pools (as the
                bf16 decode rows) and the
                quantized grouped GEMM (phi3.5-moe's expert shapes, int8),
                each quantized row naming its route (a main-path row off
                routes A and B fails) and the decode rows their device time
                and their time after an L2 flush (CUDA graphs, beside the
                library's);
     gemm_transpose -- §IV-C: gemm(a, b, layout="nt") against the two passes
                gemm(a, transpose(b)) at fig89's shape and Qwen3's tied
                read-out; one transpose launch a two-pass call;
  4. serve   -- full-width Qwen3-0.6B (seeded random weights) through
                ``generate`` on the engine backend, fused="auto": batch 4,
                prompt 256, 16 new tokens; launch counts must equal what
                the model's structure implies; prefill logits against the
                torch backend;
  5. serve_off -- the same prefill plus decode steps under fused="off",
                which runs the region GEMM and the dense-grid flash kernel;
  6. profile -- torch.profiler over two full-width decode steps: wall time
                against device time, and the kernels that take it;
     prefill_profile -- the same over one full-width prefill (batch 4 x
                256);
     continuous -- full-width Qwen3-0.6B through ``run_continuous``: a
                Poisson trace of 12 requests (prompts 96-256, 16-48 new
                tokens) over 8 slots and a 96-page pool of 16-token pages,
                which forces evictions; every request finishes, the pool's
                invariants hold, one flash_decode launch per layer per
                decode step, GEMM and flash launches as the prefills and
                steps imply (the engine's run counted alone); then, outside
                the count, the static-path oracle, one decode step's
                logits against the static dense path's, and a profile of
                two decode steps;
     continuous_warm -- the same model and trace twice: a cold run with
                autotune on (a tuning cache in a temporary directory, the
                descriptor manifest saved), then, every cache dropped, a
                warm run through run_continuous(warm_start=manifest)
                preloading that cache; gated: the warm serving phase times
                nothing and misses no plan, no autotune candidate and no
                warmup build failed, the warmup served from the cache as
                many plans as the cold run autotuned, and the greedy tokens
                of both runs are bit-identical; printed: both runs'
                latency and tokens/s, the read-out's autotuned lowerings,
                calibrate(H100_SXM)'s probes beside the pinned constants
                and a refit of the cold cache with the misranks before and
                after;
     continuous_quant -- the same model quantized W8A16 in place
                (quantize_model) with KV-int8 pools (PageSpec(kv_quant=
                "int8")) on the same trace: every request finishes, every
                projection runs gemm_quant and every decode layer
                flash_decode_int8; one decode step's logits engine vs
                torch; the share of tokens equal to the wide run printed;
     reduced -- reduced_config(qwen3-0.6b) in fp32: engine and torch give
                identical greedy tokens, and a continuous run with an
                eviction gives the static path's tokens; reduced_config(
                mamba2-130m) in fp32: engine and torch greedy tokens equal;
  7. train   -- full-width Qwen3-0.6B training (seeded random fp32 masters,
                bf16 compute; batch 8, sequence 128, AdamW with warmup_cosine,
                the synthetic bigram stream): loss and gradients of one batch
                under the engine and the torch backends, within stated
                bounds; 4 steps through run_with_restarts with checkpoints
                every 2 steps and no restart allowed, finite losses and
                exact launch counts per step (the fused recomputes of
                the GEMM backward among them); the step-2 checkpoint restored and stepped again, equal
                to the run's steps 3 and 4 within stated tolerances; a
                profile of one more step;
  8. serve_ssm -- full-width mamba2-130m (seeded random weights, bf16) through
                ``generate``: batch 4, prompt 1000 (padded to 4 chunks of
                256, so the carried state crosses 3 seams), 16 new tokens;
                one ssd_scan_fused launch per layer in the prefill and none
                in decode, 49 GEMM calls a forward; prefill logits against
                the torch backend; prefill-then-one-decode-step logits
                against the full forward's last position;
     serve_ssm_off -- the same prefill under fused="off": one ssd_chunk_diag
                launch per layer, logits against fused="auto", and
                layer 0's scan operands through both lowerings;
     serve_ssm_prefill_profile -- torch.profiler over one full-width mamba2
                prefill (batch 4 x 1000): wall against device, the busy
                share and the kernels that take it;
     continuous_ssm -- the same model through continuous batching: 12
                requests at 0.5 a tick, prompts of 128-1024 tokens, 16-48
                new tokens, 8 slots over 160 pages of 16, which evicts;
                gated as continuous (one ssd_scan_fused a layer an
                admission, 49 GEMM calls a forward, no flash launch), the
                first paged step's logits against the static dense path,
                and an all-inactive step leaving every slot's state
                bit-equal;
     train_ssm -- full-width mamba2-130m training as phase 7 at batch 8 x
                1024 (four chunks a row, so the reverse walk crosses seams):
                one ssd_scan_fused (with states) and one ssd_scan_bwd launch
                per layer a step;
  9. serve_moe -- phi3.5-moe-42b at full width (d 4096, 16 experts of d_ff
                6400, top-2) cut to 4 of its 32 layers (fp32 masters), as
                serve: three grouped_fused launches a layer a forward, the
                routings that differ between the backends counted, and
                layer 0's MoE input through both backends' moe_apply;
     serve_moe_off -- the same under fused="off": grouped_padded only;
     continuous_moe -- the same model through continuous batching on the
                continuous phase's trace and pool: gated as continuous
                (three grouped_fused a layer a forward, four projections a
                layer and the read-out on the GEMM kernels), the first
                paged step's logits against the static dense path with
                its routing replayed; identical_requests and the
                free-routing gap printed;
     serve_moe_quant -- the same under use(quant="int8"): three
                grouped_quant launches a layer a forward, logits against the
                torch backend (wide einsums, routing replayed), the gap to
                the wide logits printed;
     train_moe -- the same widths at 2 layers, 4 steps of 8 x 128 through
                run_with_restarts, no checkpoint: four grouped_fused (the
                gate's pre-activation recomputed) and three grouped_bwd
                launches a layer a step;
     gemm_routes -- the GEMM routes every phase took: route C (operands
                TMA cannot read) on the main path fails;
     grouped_routes -- the same for the grouped forwards;
     flash_routes -- the same for the flash forwards and backwards: a route
                other than A on the main path (a forward, a train or
                train_moe backward, a main-path flash_bwd_fused row) fails;
     quant_routes -- the routes of gemm_quant and grouped_quant in every
                phase: a quantized call of continuous_quant or
                serve_moe_quant, or a main-path quant kernel row, off
                routes A and B (route C or fp32) fails;
     decode_routes -- the routes of flash_decode and flash_decode_int8 in
                every phase: a decode call of continuous or
                continuous_quant off route A (the cluster-split walk on
                TMA page loads) fails;
     ssd_routes -- the routes of ssd_scan_bwd in every phase: a train_ssm
                backward off route A (a cluster of blocks a group, wgmma
                products) fails, and so does a run whose kernel rows never
                took route B;
     ssd_fwd_routes -- the same for ssd_scan_fused and ssd_chunk_diag: a
                serve_ssm or train_ssm scan or a serve_ssm_off diag call
                off route A fails, and so does a run whose kernel rows
                never took route B;
     grouped_bwd_routes -- the routes of grouped_bwd in every phase: a
                train_moe backward off route A (TMA ring, wgmma, the fp32
                cotangent split into bf16 hi + lo) fails, and so does a run
                whose kernel rows never took route C or fp32;
     transpose_routes -- the routes of the transpose in every phase: a
                gemm_transpose call off route A (a persistent TMA ring, the
                output tile stored whole) fails, and so does a run whose
                kernel rows never took route B;
 10. serve_qwen2p5 / serve_phi3_mini / serve_starcoder2 / serve_grok --
                qwen2.5-3b (36 layers), phi3-mini-3.8b (32), starcoder2-15b
                (24 of its 40: fp32 masters) and grok-1-314b (2 of its 64)
                at their published widths, every bias and norm leaf drawn
                from a seeded generator, as serve: launch counts from each
                model's structure (starcoder2's two MLP GEMMs a layer,
                phi3-mini's read-out of 32,064 as two region launches, no
                flash launch for grok, whose attention softcap keeps
                attention in plain torch), prefill logits against the torch
                backend (grok with the engine's routing replayed), block
                0's input against the table (times sqrt(d) under grok's
                embed_scale), logits within the final softcap, a profile of
                two decode steps each;
     train_qwen2p5 / train_phi3_mini / train_starcoder2 -- as train at 36,
                8 and 2 layers, with drawn bias and norm leaves and no
                checkpoint (13-37 GB a checkpoint: two would pass what the
                card's machine lets a run write);
 11. serve_rg -- recurrentgemma-9b (RG-LRU and sliding-window attention
                layers) at full width and depth (38 layers, 41.8 GB of fp32
                masters) as serve_qwen2p5: five GEMMs a "rec" layer (lin_y
                with its bias and gelu fused), four a "local" layer, three
                for the gated MLP, one read-out, no flash launch;
     serve_rg_ring -- the same model at batch 1 with a 3,072-token prompt
                (the sliding path; rings of the last 2,048 positions), then
                16 decode steps, each against a full forward;
     continuous_rg -- the same model through continuous batching (the
                continuous trace, three prompts of 2,560 tokens, an
                eviction), gated as continuous_ssm (rings and states
                bit-equal after an all-inactive step);
     rglru_scan -- the RG-LRU scan (plain torch) timed at its shapes;
     train_rg -- 2 pattern groups (6 layers) at full width with remat and
                scalable_adamw at 2 x 3,072 tokens; its optimizer state's
                bytes against AdamW's;
     Every train phase runs with cfg.remat (each pattern group's forward
                recomputed in the backward, counted in its launch gates);
                train first runs one step with and one without remat
                (train_remat: equal losses, a higher peak without);
 12. serve_internvl -- internvl2-1b at full width and depth (24 layers,
                every bias and norm leaf drawn): a prefill of 4 x (256
                image tokens from seeded 1024-d features + 256 text tokens)
                through make_prefill_step with modality_feats, then 15
                decode steps from position 512; logits against the torch
                backend, one flash launch a layer in the prefill, GEMM calls
                as the structure implies (the projector's two, seven a
                layer, the tied read-out);
     continuous_internvl -- the same model text-only (as the reference
                serves it) through continuous batching on the continuous
                trace and pool, decode on flash_decode at GQA group 7
                (route A), gated as continuous;
     serve_seamless -- seamless-m4t-large-v2 at full width and depth (24
                encoder + 24 decoder layers, drawn biases and norms):
                encode of 4 x 1,000 seeded 160-d frames (timed alone), a
                256-token prefill with enc_out, 15 decode steps passing it
                again; logits (encoder and prefill) against the torch
                backend; flash launches 24 in the encoder, 48 in the
                prefill and 24 a step, each on route A; the read-out (vocab
                256,206) over a bf16 copy padded to 256,208 columns, which
                TMA reads: every GEMM on route A or B, none on route C;
     train_internvl / train_seamless -- both at full depth with remat and
                AdamW, no checkpoint: 8 x (256 image + 128 text) positions
                with the loss on the text, and 8 x (512 frames, 128
                tokens); gated as train_qwen2p5 (engine vs torch, launch
                counts a step);
     mesh     -- the mesh axis: two ranks spawned on the one card with a
                (data 1, model 2) mesh over gloo (NCCL puts no two ranks
                on one device), each holding phi3.5-moe-42b at full width
                and 2 layers (replicated fp32 masters).  Each rank runs
                the expert-parallel grouped GEMM at its MoE layer's
                shapes (4 x 256 prompt tokens: 4,096 capacity rows; one
                decode step: 512) under both pinned strategies: one
                grouped_fused launch a rank a call, the outputs of the two
                strategies bit-equal and within the bf16 tolerance of the
                plain fp32 product, the counters the reference's (the
                distributed strategy's two all_to_alls and their
                mesh_comm_events bytes, none for the gathered one); the
                host-clock ms a call of each strategy, the planner's pick
                under H100_SXM and its predicted seconds printed.  Then
                both ranks serve the model under the mesh (batch 4,
                prompt 256, 4 new tokens): prefill logits within 5% of
                their range of the one-process engine run, launches and
                collectives as the planner's picks imply, the greedy
                tokens equal to the one-process run's counted; and one
                rank serves it over NCCL on a (1, 1) mesh, bit-equal to
                the run with no mesh;
 13. the ``kernels`` line (the GEMM rows with their large-M and decode
                sums apart, the grouped forwards' with their prefill and
                decode sums apart, the flash kernels' with their device
                times and every case's route, ``flash_routes``, the
                quantized GEMMs' with their prefill and decode sums apart,
                the paged decode kernels' with their device times, warm and
                L2-cold, and every case's route, the SSD kernels' with their
                fp32 CUDA-core operation time, their device times and every
                case's route, ``ssd_routes``; the
                grouped backward's with its device times, its fp32
                CUDA-core operation time and every case's route,
                ``grouped_bwd_routes``; the transpose's with its device
                times, warm and L2-cold, and every case's route,
                ``transpose_routes``),
                then the
                card's nvidia-smi line, then
 14. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BATCH, PROMPT, GEN = 4, 256, 16
TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # atol = rtol, kernel vs plain
# Flash backward vs its plain version (atol = rtol): both compute in fp32
# from the same inputs, but in another summation order, and the kernel's
# atomic dQ adds in an order that changes from run to run.
BWD_TOL = 1e-3
# The forward's LSE rows vs the plain version's (fp32 on both sides).
LSE_TOL = 1e-4
# Prefill last-position logits, engine vs torch backend (both bf16): the
# largest difference may be at most this fraction of the logits' range.
LOGIT_BOUND = 0.05
# int8 rows (f32 outputs) against their plain versions: exact int32 sums
# and the same dequant products; only the epilogue's transcendentals
# differ, in the last fp32 bits.
QUANT_I8_TOL = 1e-5

# Training: the reference CLI's defaults (batch 8, sequence 128, peak lr
# 3e-3 with warmup_cosine over the run), 4 steps, a checkpoint every 2.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR, SAVE_EVERY = 8, 128, 4, 3e-3, 2
# Engine vs torch backend on one batch (both bf16 compute from the same
# fp32 masters; the GEMM and attention kernels round in other places than
# cuBLAS and the chunked softmax): the loss may differ by this fraction of
# itself, the whole gradient by this fraction of its L2 norm.
LOSS_BOUND, GRAD_BOUND = 0.01, 0.05
# Resume from the step-2 checkpoint against the uninterrupted run.  Step 2's
# loss comes from restored weights through a deterministic forward: equal
# to 1e-6.  Its grad_norm, and step 3's loss, pass through the atomic dQ
# adds, whose order changes from run to run: 1e-3.  The parameters after
# step 4 likewise: relative L2 gap 1e-3 (Adam moves an element by at most
# about 2 lr when a near-zero gradient flips sign).
RESUME_EXACT, RESUME_TOL = 1e-6, 1e-3

# Continuous batching at full width: 8 slots over 96 pages of 16 positions
# (at most 24 pages, 384 positions, a sequence), and a Poisson trace that
# overflows the pool, so that growth evicts.
CONT_SLOTS, CONT_PAGES, CONT_PAGE, CONT_BLOCKS = 8, 96, 16, 24
CONT_TRACE = dict(num_requests=12, rate=1.0, prompt_len=(96, 256),
                  max_new=(16, 48), seed=0)

# mamba2-130m through continuous batching: 12 requests at 0.5 a tick,
# prompts of 128-1024 tokens (a re-admitted context stays within 5 chunks
# of 256: the scan's route A), 16-48 new tokens, 8 slots over 160 pages of
# 16 (at most 68 a sequence): this trace evicts once in growth.
SSM_CONT_PAGES, SSM_CONT_BLOCKS = 160, 68
SSM_CONT_TRACE = dict(num_requests=12, rate=0.5, prompt_len=(128, 1024),
                      max_new=(16, 48), seed=0)

# mamba2-130m: static serving at batch 4 with a 1000-token prompt (not a
# multiple of the 256-token chunk: it pads to 4 chunks, so the carried
# state crosses 3 seams), 16 new tokens; training at batch 8 x 1024 (the
# reference CLI's 8 x 128 is one padded chunk, whose reverse walk crosses
# no seam).
SSM_BATCH, SSM_PROMPT, SSM_GEN = 4, 1000, 16
SSM_TRAIN_SEQ = 1024

# phi3.5-moe-42b at its published widths, cut in depth: the port keeps fp32
# master weights (167 GB at 32 layers), so serving runs 4 layers (21.9 GB)
# and training 2 (45.8 GB with gradients and AdamW's m and v).  Serving and
# training use the batches above.
MOE_ARCH, MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = "phi3.5-moe-42b", 4, 2

# The remaining decoder configurations at their published widths: (arch,
# phase tag, layers served, layers trained), None for full depth and 0 for
# no training on the card.  Served at the batches above; trained at 8 x
# 128.  qwen2.5-3b's fp32 masters are 12.3 GB and its training state 49
# GB: full depth both ways.  phi3-mini-3.8b's masters are 15.3 GB, its
# training state 61 GB before activations: 8 layers trained.  starcoder2-15b
# has 1.54 GB of masters a layer and 2.4 GB of tables: 24 layers served, 2
# trained.  grok-1-314b has 19.7 GB a layer and 6.4 GB of tables: 2
# layers served, and one layer's training state (79 GB) does not fit.
ARCH_RUNS = (("qwen2.5-3b", "qwen2p5", None, None),
             ("phi3-mini-3.8b", "phi3_mini", None, 8),
             ("starcoder2-15b", "starcoder2", 24, 2),
             ("grok-1-314b", "grok", 2, 0))
# What a run may write to the card's machine's disk, deleted files
# included: the machine ends a command past it.  The train phase's two
# Qwen3 checkpoints write 14.4 GB of it; the larger models' training
# states (13-37 GB a checkpoint) are not checkpointed.
CKPT_WRITE_GIB = 45
# Block 0's input against the table's rows (times sqrt(d) under
# embed_scale), elementwise relative: three bf16 roundings of 2^-9.
EMBED_TOL = 1e-2

# recurrentgemma-9b at full width and depth (38 layers, 41.8 GB of fp32
# masters): served at the batches above (serve_rg); at batch 1 with a
# 3,072-token prompt, past window + Q_CHUNK = 2,560, so prefill takes the
# sliding path and the rings wrap, then 16 decode steps (serve_rg_ring);
# through continuous batching on the continuous trace with three prompts of
# 2,560 tokens (past the window), 16 new tokens each, over a page pool
# small enough that growth evicts (continuous_rg).  Trained at its widths,
# cut to RG_TRAIN_GROUPS pattern groups, with cfg.remat and the reference's
# optimizer for a model past 10 B parameters (scalable_adamw), at 2 x 3,072
# tokens (train_rg).
RG_ARCH = "recurrentgemma-9b"
RG_RING_PROMPT = 3072
RG_CONT_LONG, RG_CONT_LONG_RIDS = 2560, (1, 4, 7)
# 350 pages: growth evicts request 7 (2,560 tokens) once, and its
# re-admission re-slots a ring from a context past the window.
RG_CONT_PAGES, RG_CONT_BLOCKS = 350, 162
RG_CONT_TRACE = dict(num_requests=12, rate=1.0, prompt_len=(96, 256),
                     max_new=16, seed=0)
RG_TRAIN_GROUPS, RG_TRAIN_BATCH, RG_TRAIN_SEQ = 2, 2, 3072
# The same step with and without remat: the forward is the same work.
REMAT_LOSS_TOL = 1e-6

# internvl2-1b (the vision prefix; 14 query / 2 KV heads of 64) at full
# width and depth: served at the batches above with a prefix of VL_IMAGE
# image tokens (1024-d features) before the PROMPT text tokens, the cache
# sized for both and GEN new tokens (serve_internvl); text-only through
# continuous batching on the continuous trace and pool (continuous_internvl,
# decode on flash_decode at GQA group 7); trained at 8 x (VL_IMAGE image +
# TRAIN_SEQ text) positions with the loss on the text (train_internvl).
# seamless-m4t-large-v2 (the encoder-decoder; 16 heads of 64, LayerNorm)
# at full width and depth (24 + 24 layers): served at batch 4 with
# ED_FRAMES audio frames of 160 features, a PROMPT-token decoder prompt and
# GEN new tokens (serve_seamless); trained at 8 x (ED_TRAIN_FRAMES frames,
# TRAIN_SEQ tokens) (train_seamless).  Features come from seeded generators.
VL_ARCH, VL_IMAGE = "internvl2-1b", 256
ED_ARCH, ED_FRAMES, ED_TRAIN_FRAMES = "seamless-m4t-large-v2", 1000, 512


def emit(**kw):
    print(json.dumps(kw), flush=True)


def peak(dtype_name: str) -> float:
    """The H100 SXM dense peak of a dtype, operations per second, from the
    port's machine model (``H100_SXM``: NVIDIA's data-sheet figures)."""
    from repro_torch.core.machine import H100_SXM
    return H100_SXM.peak(dtype_name)


def hbm() -> float:
    """The H100 SXM's HBM3 rate, bytes per second (``H100_SXM.hbm_bw``)."""
    from repro_torch.core.machine import H100_SXM
    return H100_SXM.hbm_bw


def bound(nbytes: float, ops: float, dtype_name: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the dtype's peak."""
    op_ms = ops / peak(dtype_name) * 1e3
    byte_ms = nbytes / hbm() * 1e3
    return dict(op_ms=op_ms, byte_ms=byte_ms, bound_ms=max(op_ms, byte_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    from repro_torch.kernels import _build
    _build.build_all()
    emit(phase="build", seconds=_build.last_build_seconds,
         sources=sorted(_build.sources()))

    results = phase_kernels(torch)
    counts_transpose = phase_gemm_transpose(torch)
    counts_on, model, prompts, logits = phase_serve(torch)
    counts_off = phase_serve_off(torch, model, prompts, logits)
    phase_profile(torch, model, prompts)
    phase_prefill_profile(torch, model, prompts)
    counts_cont, wide_cont = phase_continuous(torch, model)
    counts_cont_warm = phase_continuous_warm(torch, model)
    # Quantizes the serving model in place: the last phase to use it.
    counts_cont_quant = phase_continuous_quant(torch, model, wide_cont)
    del model, logits  # free the serving model before training
    phase_reduced(torch)
    torch.cuda.empty_cache()
    counts_train = phase_train(torch, remat_check=True)
    torch.cuda.empty_cache()
    counts_ssm, model, prompts, logits = phase_serve_ssm(torch)
    counts_ssm_off = phase_serve_ssm_off(torch, model, prompts, logits)
    phase_serve_ssm_prefill_profile(torch, model, prompts)
    counts_cont_ssm = phase_continuous_ssm(torch, model)
    del model, logits
    torch.cuda.empty_cache()
    counts_train_ssm = phase_train(torch, "mamba2-130m", SSM_TRAIN_SEQ,
                                   "train_ssm")
    torch.cuda.empty_cache()
    counts_moe, model, prompts, logits = phase_serve_moe(torch)
    counts_moe_off = phase_serve_moe_off(torch, model, prompts, logits)
    counts_cont_moe = phase_continuous_moe(torch, model)
    counts_moe_quant = phase_serve_moe_quant(torch, model, prompts, logits)
    del model, logits
    torch.cuda.empty_cache()
    # Training: 2 layers, no checkpoint (parameters, m and v would be a 34
    # GB write) and no resume (the train phase covers it).
    counts_train_moe = phase_train(
        torch, name="train_moe", cfg=_moe_cfg(MOE_TRAIN_LAYERS), resume=False,
        extra={"reduced": _moe_reduced(MOE_TRAIN_LAYERS)})
    torch.cuda.empty_cache()
    counts_archs = phase_arch_runs(torch)
    counts_rg = phase_rg_runs(torch)
    torch.cuda.empty_cache()
    counts_vl_ed = phase_vl_ed_runs(torch)
    torch.cuda.empty_cache()
    counts_mesh = phase_mesh(torch)
    counts_dryrun = phase_dryrun(torch, results)

    by_path = {"serve": counts_on, "serve_off": counts_off,
               "continuous": counts_cont, "train": counts_train,
               "serve_ssm": counts_ssm, "serve_ssm_off": counts_ssm_off,
               "train_ssm": counts_train_ssm, "serve_moe": counts_moe,
               "serve_moe_off": counts_moe_off,
               "train_moe": counts_train_moe,
               "gemm_transpose": counts_transpose,
               "continuous_quant": counts_cont_quant,
               "serve_moe_quant": counts_moe_quant,
               "continuous_moe": counts_cont_moe,
               "continuous_ssm": counts_cont_ssm,
               "continuous_warm": counts_cont_warm, **counts_archs,
               **counts_rg, **counts_vl_ed, **counts_mesh,
               "dryrun": counts_dryrun}
    # Every wide GEMM of the main path reads TMA-legal operands: route C
    # (loads through registers) is for operands off it.  (Seamless's untied
    # read-out, vocab 256,206, runs over a copy padded to 16-byte rows.)
    routes = {p: {r: c.get(f"gemm_route_{r}", 0) for r in ("A", "B", "C",
                                                          "fp32")}
              for p, c in by_path.items()}
    emit(phase="gemm_routes", by_path=routes)
    on_c = {p: r["C"] for p, r in routes.items() if r["C"]}
    if on_c:
        fail(f"main-path GEMMs took route C: {on_c}")
    # Likewise every grouped forward of the main path (bf16): route A.
    grouped_routes = {p: {r: c.get(f"grouped_route_{r}", 0)
                          for r in ("A", "C", "fp32")}
                      for p, c in by_path.items()}
    emit(phase="grouped_routes", by_path=grouped_routes)
    on_c = {p: r["C"] for p, r in grouped_routes.items() if r["C"]}
    if on_c:
        fail(f"main-path grouped GEMMs took route C: {on_c}")
    # Every flash forward and backward of the main path is bf16 with
    # TMA-legal operands: route A (TMA-fed ring, wgmma).  (A main-path
    # kernel row off route A has failed in its case already.)
    flash_routes = {p: {r: c.get(f"flash_route_{r}", 0)
                        for r in ("A", "C", "fp32")}
                    for p, c in by_path.items()}
    bwd_routes = {p: {r: c.get(f"flash_bwd_route_{r}", 0)
                      for r in ("A", "C", "fp32")}
                  for p, c in by_path.items()}
    emit(phase="flash_routes", by_path=flash_routes, bwd_by_path=bwd_routes,
         bwd_kernel_rows={r["case"]: r["route"] for r in results
                          if r["kernel"] == "flash_bwd_fused"})
    off_a = {f"{p} {kind}": r
             for kind, counts in (("forward", flash_routes),
                                  ("backward", bwd_routes))
             for p, r in counts.items() if r["C"] or r["fp32"]}
    if off_a:
        fail(f"main-path flash kernels left route A: {off_a}")
    # The quantized GEMMs of the quantized serving paths, and every
    # main-path quant kernel row: routes A and B (TMA ring, wgmma) only.
    quant_routes = {p: {f"{fam}_{r}": c.get(f"{fam}_route_{r}", 0)
                        for fam in ("gemm_quant", "grouped_quant")
                        for r in ("A", "B", "C", "fp32")}
                    for p, c in by_path.items()}
    rows_off = {r["case"]: r["route"] for r in results
                if r["kernel"] in ("gemm_quant", "grouped_quant")
                and r["main_path"] and r["route"] not in ("A", "B")}
    emit(phase="quant_routes", by_path=quant_routes,
         kernel_rows={r["kernel"] + ":" + r["case"]: r["route"]
                      for r in results
                      if r["kernel"] in ("gemm_quant", "grouped_quant")})
    off_ab = {p: {k: n for k, n in r.items() if n and k.split("_")[-1]
                  in ("C", "fp32")}
              for p, r in quant_routes.items()
              if p in ("continuous_quant", "serve_moe_quant")}
    off_ab = {p: r for p, r in off_ab.items() if r}
    if off_ab or rows_off:
        fail(f"main-path quant GEMMs left routes A and B: {off_ab} "
             f"{rows_off}")
    # Every paged decode call of the serving paths is bf16 within route A's
    # limits: route A (the cluster-split walk on TMA page loads).  (A
    # kernel row off its route has failed in its case already.)
    decode_routes = {p: {r: c.get(f"decode_route_{r}", 0) for r in ("A", "B")}
                     for p, c in by_path.items()}
    emit(phase="decode_routes", by_path=decode_routes,
         kernel_rows={r["kernel"] + ":" + r["case"]: r["route"]
                      for r in results if r["kernel"] in DECODE_KERNELS})
    off_a = {p: r for p, r in decode_routes.items() if r["B"]}
    if off_a:
        fail(f"main-path paged decode left route A: {off_a}")
    for p, kname in (("continuous", "flash_decode"),
                     ("continuous_moe", "flash_decode"),
                     ("continuous_internvl", "flash_decode"),
                     ("continuous_quant", "flash_decode_int8")):
        if decode_routes[p]["A"] != by_path[p][kname]:
            fail(f"{p}: {decode_routes[p]['A']} route-A decode calls, "
                 f"{by_path[p][kname]} {kname} launches")
    # Every SSD backward of the training path is bf16 C/B with fp32 L and
    # xdt within route A's limits: route A (a cluster of blocks a group,
    # wgmma products).  Route B must have run off the path.  (A main-path
    # kernel row off route A has failed in its case already.)
    ssd_routes = {p: {r: c.get(f"ssd_bwd_route_{r}", 0) for r in ("A", "B")}
                  for p, c in by_path.items()}
    ssd_rows = {r["case"]: r["route"] for r in results
                if r["kernel"] == "ssd_scan_bwd"}
    emit(phase="ssd_routes", by_path=ssd_routes, kernel_rows=ssd_rows)
    off_a = {p: r for p, r in ssd_routes.items() if r["B"]}
    if off_a:
        fail(f"main-path SSD backwards left route A: {off_a}")
    if ssd_routes["train_ssm"]["A"] != by_path["train_ssm"]["ssd_scan_bwd"]:
        fail(f"train_ssm: {ssd_routes['train_ssm']['A']} route-A SSD "
             f"backwards, {by_path['train_ssm']['ssd_scan_bwd']} launches")
    if "B" not in ssd_rows.values():
        fail(f"no SSD backward row ran route B: {ssd_rows}")
    # Likewise every SSD forward of the serving and training paths (the
    # scan, and the diag form under fused="off"): route A (a cluster of
    # blocks a group, the state folded over DSMEM, wgmma products).  Route
    # B must have run off the path.
    fwd_routes = {p: {r: c.get(f"ssd_fwd_route_{r}", 0) for r in ("A", "B")}
                  for p, c in by_path.items()}
    fwd_rows = {r["kernel"] + ":" + r["case"]: r["route"] for r in results
                if r["kernel"] in ("ssd_scan_fused", "ssd_chunk_diag")}
    emit(phase="ssd_fwd_routes", by_path=fwd_routes, kernel_rows=fwd_rows)
    off_a = {p: r for p, r in fwd_routes.items() if r["B"]}
    if off_a:
        fail(f"main-path SSD forwards left route A: {off_a}")
    for p, kname in (("serve_ssm", "ssd_scan_fused"),
                     ("train_ssm", "ssd_scan_fused"),
                     ("continuous_ssm", "ssd_scan_fused"),
                     ("serve_ssm_off", "ssd_chunk_diag")):
        if not by_path[p][kname] or \
                fwd_routes[p]["A"] != by_path[p][kname]:
            fail(f"{p}: {fwd_routes[p]['A']} route-A SSD forwards, "
                 f"{by_path[p][kname]} {kname} launches")
    if "B" not in fwd_rows.values():
        fail(f"no SSD forward row ran route B: {fwd_rows}")
    # Every grouped backward of the training path is bf16 with TMA-legal
    # operands: route A (TMA ring, wgmma, dY split into bf16 hi + lo).
    # Routes C and fp32 must have run off the path.  (A main-path kernel row
    # off route A has failed in its case already.)
    gbwd_routes = {p: {r: c.get(f"grouped_bwd_route_{r}", 0)
                       for r in ("A", "C", "fp32")}
                   for p, c in by_path.items()}
    gbwd_rows = {r["case"]: r["route"] for r in results
                 if r["kernel"] == "grouped_bwd"}
    emit(phase="grouped_bwd_routes", by_path=gbwd_routes,
         kernel_rows=gbwd_rows)
    off_a = {p: r for p, r in gbwd_routes.items() if r["C"] or r["fp32"]}
    if off_a:
        fail(f"main-path grouped backwards left route A: {off_a}")
    if gbwd_routes["train_moe"]["A"] != by_path["train_moe"]["grouped_bwd"]:
        fail(f"train_moe: {gbwd_routes['train_moe']['A']} route-A grouped "
             f"backwards, {by_path['train_moe']['grouped_bwd']} launches")
    for want in ("C", "fp32"):
        if want not in gbwd_rows.values():
            fail(f"no grouped_bwd row ran route {want}: {gbwd_rows}")
    # Every transpose of the main path (the two-pass GEMM's first pass, a
    # contiguous table) is one TMA can address: route A (a persistent TMA
    # ring, the output tile stored whole).  Route B must have run off the
    # path.  (A main-path kernel row off route A has failed in its case
    # already.)
    tr_routes = {p: {r: c.get(f"transpose_route_{r}", 0) for r in ("A", "B")}
                 for p, c in by_path.items()}
    tr_rows = {r["case"]: r["route"] for r in results
               if r["kernel"] == "transpose"}
    emit(phase="transpose_routes", by_path=tr_routes, kernel_rows=tr_rows)
    off_a = {p: r for p, r in tr_routes.items() if r["B"]}
    if off_a:
        fail(f"main-path transposes left route A: {off_a}")
    if not by_path["gemm_transpose"]["transpose"] or \
            tr_routes["gemm_transpose"]["A"] != \
            by_path["gemm_transpose"]["transpose"]:
        fail(f"gemm_transpose: {tr_routes['gemm_transpose']['A']} route-A "
             f"transposes, {by_path['gemm_transpose']['transpose']} launches")
    if "B" not in tr_rows.values():
        fail(f"no transpose row ran route B: {tr_rows}")
    kernels = []
    for kname, meta in KERNELS.items():
        paths = {p: c[kname] for p, c in by_path.items() if c.get(kname)}
        if not paths:
            fail(f"{kname} was never launched on the main path")
        rows = [r for r in results if r["kernel"] == kname and r["main_path"]]
        # The cases run one after another: the least time for all of them
        # is the sum of each case's own bound.
        by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
        by_ops = sum(r["bound_ms"] for r in rows
                     if r["bound_by"] == "operations")
        lib = [r["library_ms"] for r in rows]
        libs = sorted({r["library"] for r in rows if "library" in r})
        kernels.append({
            "name": kname, "route": "cuda", "source": meta[0],
            "replaces": meta[1], "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": by_bytes + by_ops,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None if None in lib else sum(lib),
            **({"library": meta[2]} if len(meta) > 2 else
               {"library": "; ".join(libs)} if libs else {}),
            **(_gemm_split_sums(rows) if kname in ("gemm_fused",
                                                  "gemm_region") else {}),
            **(_grouped_split_sums(rows) if kname in ("grouped_fused",
                                                     "grouped_padded")
               else {}),
            **(_flash_sums(rows, [r for r in results if r["kernel"] == kname])
               if kname in ("flash_fwd_fused", "flash_fwd_dense",
                            "flash_bwd_fused") else {}),
            **(_quant_split_sums(rows) if kname in ("gemm_quant",
                                                   "grouped_quant") else {}),
            **(_decode_sums(rows, [r for r in results if r["kernel"] == kname])
               if kname in DECODE_KERNELS else {}),
            **(_ssd_sums(rows, [r for r in results if r["kernel"] == kname])
               if kname.startswith("ssd_") else {}),
            **(_grouped_bwd_sums(rows, [r for r in results
                                        if r["kernel"] == kname])
               if kname == "grouped_bwd" else {}),
            **(_transpose_sums(rows, [r for r in results
                                      if r["kernel"] == kname])
               if kname == "transpose" else {}),
            "cases": len(rows)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _gemm_split_sums(rows):
    """A GEMM row's main-path sums apart for the large-M cases and the
    decode cases (M <= COLD_M, with their device times, warm and L2-cold),
    so that a gain in one cannot hide a loss in the other; and the routes
    taken."""
    out = {}
    for part, sel in (("large_m", lambda r: r["shape"][1] > COLD_M),
                      ("decode", lambda r: r["shape"][1] <= COLD_M)):
        rs = [r for r in rows if sel(r)]
        out[part] = {key: sum(r[key] for r in rs) for key in
                     ("ms", "library_ms", "bound_ms")
                     + (("device_ms", "device_library_ms", "cold_ms",
                         "cold_library_ms") if part == "decode" else ())}
        out[part]["cases"] = len(rs)
    routes = {}
    for r in rows:
        for name, n in r["routes"].items():
            routes[name] = routes.get(name, 0) + n
    out["routes"] = routes
    return out


def _grouped_split_sums(rows):
    """A grouped forward's main-path sums apart for the prefill cases and
    the decode cases (with their device times), and the routes taken."""
    out = {}
    for part in ("prefill", "decode"):
        rs = [r for r in rows if r["stage"] == part]
        out[part] = {key: sum(r[key] for r in rs) for key in
                     ("ms", "library_ms", "bound_ms")
                     + (("device_ms", "device_library_ms")
                        if part == "decode" else ())}
        out[part]["cases"] = len(rs)
    routes = {}
    for r in rows:
        routes[r["route"]] = routes.get(r["route"], 0) + 1
    out["routes"] = routes
    return out


def _quant_split_sums(rows):
    """A quantized GEMM's main-path sums apart for its decode cases (with
    their device times, warm and L2-cold, beside the library's) and its
    prefill cases, and the routes taken."""
    out = {}
    for part in ("prefill", "decode"):
        rs = [r for r in rows if r["stage"] == part]
        keys = ("ms", "library_ms", "bound_ms") + (
            ("device_ms", "device_library_ms", "cold_ms", "cold_library_ms")
            if part == "decode" else ())
        out[part] = {key: sum(r[key] for r in rs) for key in keys
                     if all(r.get(key) is not None for r in rs)}
        out[part]["cases"] = len(rs)
    routes = {}
    for r in rows:
        routes[r["route"]] = routes.get(r["route"], 0) + 1
    out["routes"] = routes
    return out


def _flash_sums(rows, all_rows):
    """A flash kernel's main-path device times (CUDA graphs) beside SDPA's
    (its autograd backward for flash_bwd_fused), and the route every case
    took (``flash_routes``, off-path cases too)."""
    return {"device_ms": sum(r["device_ms"] for r in rows),
            "device_library_ms": sum(r["device_library_ms"] for r in rows),
            "flash_routes": {r["case"]: r["route"] for r in all_rows}}


def _decode_sums(rows, all_rows):
    """A paged decode kernel's main-path device times, warm and L2-cold
    (CUDA graphs), beside SDPA's over the gathered pages, and the route
    every case took (``decode_routes``, off-path cases too)."""
    out = {key: sum(r[key] for r in rows) for key in
           ("device_ms", "cold_ms", "device_library_ms", "cold_library_ms")}
    out["decode_routes"] = {r["case"]: r["route"] for r in all_rows}
    return out


def _ssd_sums(rows, all_rows):
    """An SSD kernel's main-path operation time at the fp32 CUDA-core rate
    (the earlier bound), its device time (CUDA graphs) beside the
    composition's (its autograd backward for ssd_scan_bwd), and the route
    every case took (``ssd_routes``, off-path cases too)."""
    out = {"fp32_op_ms": sum(r["fp32_op_ms"] for r in rows)}
    if all("route" in r for r in all_rows):
        out.update(device_ms=sum(r["device_ms"] for r in rows),
                   device_library_ms=sum(r["device_library_ms"]
                                         for r in rows),
                   ssd_routes={r["case"]: r["route"] for r in all_rows})
    return out


def _grouped_bwd_sums(rows, all_rows):
    """The grouped backward's main-path device times (CUDA graphs) beside
    the composition's, its operation time at the fp32 CUDA-core rate (the
    earlier bound), and the route every case took (``grouped_bwd_routes``,
    off-path cases too)."""
    return {"device_ms": sum(r["device_ms"] for r in rows),
            "device_library_ms": sum(r["device_library_ms"] for r in rows),
            "fp32_op_ms": sum(r["fp32_op_ms"] for r in rows),
            "grouped_bwd_routes": {r["case"]: r["route"] for r in all_rows}}


def _transpose_sums(rows, all_rows):
    """The transpose's main-path device times, warm and L2-cold (CUDA
    graphs), beside the library's, and the route every case took
    (``transpose_routes``, off-path cases too)."""
    out = {key: sum(r[key] for r in rows) for key in
           ("device_ms", "cold_ms", "device_library_ms", "cold_library_ms")}
    out["transpose_routes"] = {r["case"]: r["route"] for r in all_rows}
    return out


DECODE_KERNELS = ("flash_decode", "flash_decode_int8")

KERNELS = {
    "gemm_fused": ("src/repro_torch/kernels/gemm/csrc/gemm.cu",
                   "src/repro/kernels/gemm/kernel.py:266"),
    "gemm_region": ("src/repro_torch/kernels/gemm/csrc/gemm.cu",
                    "src/repro/kernels/gemm/kernel.py:96"),
    # The GEMM backward's recompute of an activation's pre-activation, the
    # derivative in its epilogue: the reference recomputes with XLA's dot
    # (no TPU kernel); its library is cuBLAS's bf16 product and aten's
    # activation backward.
    "gemm_act_bwd": ("src/repro_torch/kernels/gemm/csrc/gemm.cu",
                     "src/repro/core/matmul.py:137",
                     "cuBLAS bf16 product + aten activation backward"),
    "flash_fwd_fused": ("src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
                        "src/repro/kernels/flash_attention/kernel.py:204"),
    "flash_fwd_dense": ("src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
                        "src/repro/kernels/flash_attention/kernel.py:115"),
    "flash_bwd_fused": ("src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
                        "src/repro/kernels/flash_attention/kernel.py:500"),
    "flash_decode": ("src/repro_torch/kernels/flash_attention/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/kernel.py:358"),
    # No single PyTorch call computes the SSD scan: their library times are
    # the torch backend's composition (cuBLAS einsums and the chunk loop,
    # autograd through it for the backward), named in the line.
    "ssd_scan_fused": ("src/repro_torch/kernels/ssd_chunk/csrc/ssd_scan.cu",
                       "src/repro/kernels/ssd_chunk/kernel.py:128",
                       "composition: torch-backend einsums + chunk loop"),
    "ssd_chunk_diag": ("src/repro_torch/kernels/ssd_chunk/csrc/ssd_scan.cu",
                       "src/repro/kernels/ssd_chunk/kernel.py:51",
                       "composition: torch-backend einsums"),
    "ssd_scan_bwd": ("src/repro_torch/kernels/ssd_chunk/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ssd_chunk/kernel.py:264",
                     "composition: autograd through the torch-backend "
                     "einsums + chunk loop"),
    # The grouped rows name their library per case: torch.bmm over the
    # model's uniform (E, rows, K) layout, torch._grouped_mm on a ragged
    # case where the card's torch takes it, else a per-expert matmul loop.
    "grouped_fused": ("src/repro_torch/kernels/grouped_gemm/csrc/grouped.cu",
                      "src/repro/kernels/grouped_gemm/kernel.py:138"),
    "grouped_padded": ("src/repro_torch/kernels/grouped_gemm/csrc/grouped.cu",
                       "src/repro/kernels/grouped_gemm/kernel.py:417"),
    "grouped_bwd": ("src/repro_torch/kernels/grouped_gemm/csrc/grouped.cu",
                    "src/repro/kernels/grouped_gemm/kernel.py:313"),
    # The quant branches of kernels 1, 6 and 7 (their reference function
    # with quant= / kv_quant=True), each its own row: their bounds take the
    # int8 / e4m3 peaks and the wire bytes.
    "gemm_quant": ("src/repro_torch/kernels/gemm/csrc/gemm_quant.cu",
                   "src/repro/kernels/gemm/kernel.py:266"),
    "flash_decode_int8": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_decode.cu",
        "src/repro/kernels/flash_attention/kernel.py:358"),
    "grouped_quant": (
        "src/repro_torch/kernels/grouped_gemm/csrc/grouped_quant.cu",
        "src/repro/kernels/grouped_gemm/kernel.py:138"),
    "transpose": ("src/repro_torch/kernels/transpose/csrc/transpose.cu",
                  "src/repro/kernels/transpose/kernel.py:31",
                  "x.transpose(-2, -1).contiguous()"),
}


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, out, ref, dtype_name, tol=None):
    """Element-wise atol = rtol = ``tol`` (the dtype's TOL by default):
    (max abs error, max relative to the largest |ref|, mismatches, tol)."""
    diff = (out.float() - ref.float()).abs()
    tol = TOL[dtype_name] if tol is None else tol
    bad = diff > tol + tol * ref.float().abs()
    if not torch.isfinite(out.float()).all():
        fail("kernel output is not finite")
    max_abs = diff.max().item()
    return max_abs, max_abs / max(ref.float().abs().max().item(), 1e-30), \
        int(bad.sum().item()), tol


def gemm_cases():
    """(label, m, n, k, layout, epilogue, dtype, accumulate, batch, main)."""
    d, q, kv, ff, vocab = 1024, 2048, 1024, 3072, 151936
    cases = []
    for stage, m in (("prefill", BATCH * PROMPT), ("decode", BATCH)):
        cases += [(f"{stage}_q", m, q, d, "nn", None),
                  (f"{stage}_kv", m, kv, d, "nn", None),
                  (f"{stage}_o", m, d, q, "nn", None),
                  (f"{stage}_gate_silu", m, ff, d, "nn", "silu"),
                  (f"{stage}_up", m, ff, d, "nn", None),
                  (f"{stage}_down", m, d, ff, "nn", None)]
    cases.append(("readout_nt", BATCH, vocab, d, "nt", None))
    # Training runs the prefill shapes (8 x 128 = 1024 tokens) and the
    # read-out over every position.
    cases.append(("train_readout_nt", TRAIN_BATCH * TRAIN_SEQ, vocab, d,
                  "nt", None))
    # mamba2-130m: in_proj (d 768 -> 2 x 1536 + 2 x 128 + 24) and out_proj
    # (1536 -> 768) at the serving prefill, decode and training rows, and
    # the tied read-out (vocab 50,280) at decode and over every training
    # position.
    sd, sproj, sin, svocab = 768, 3352, 1536, 50280
    for stage, m in (("ssm_prefill", SSM_BATCH * SSM_PROMPT),
                     ("ssm_decode", SSM_BATCH),
                     ("ssm_train", TRAIN_BATCH * SSM_TRAIN_SEQ)):
        cases += [(f"{stage}_in", m, sproj, sd, "nn", None),
                  (f"{stage}_out", m, sd, sin, "nn", None)]
    cases += [("ssm_readout_nt", SSM_BATCH, svocab, sd, "nt", None),
              ("ssm_train_readout_nt", TRAIN_BATCH * SSM_TRAIN_SEQ, svocab,
               sd, "nt", None)]
    # phi3.5-moe-42b: the attention projections (d 4096 -> 32 x 128 for q
    # and o, 8 x 128 for k and v) at the serving prefill (= training) rows
    # and decode rows, and its untied read-out (vocab 32,064, nn) at decode
    # and over every training position.
    md, mkv, mvocab = 4096, 1024, 32064
    for stage, m in (("moe_prefill", BATCH * PROMPT), ("moe_decode", BATCH)):
        cases += [(f"{stage}_q_o", m, md, md, "nn", None),
                  (f"{stage}_kv", m, mkv, md, "nn", None)]
    cases += [("moe_readout", BATCH, mvocab, md, "nn", None),
              ("moe_train_readout", TRAIN_BATCH * TRAIN_SEQ, mvocab, md,
               "nn", None)]
    # starcoder2-15b's non-gated MLP: the up projection (d 6144 -> d_ff
    # 24,576) with its bias and the gelu fused, at the serving prefill (=
    # training) rows.
    cases.append(("starcoder2_prefill_up_bias_gelu", BATCH * PROMPT, 24576,
                  6144, "nn", "bias_gelu"))
    # recurrentgemma-9b (d 4096, RG-LRU width 4096, d_ff 12,288): lin_y with
    # its bias and the gelu fused and the GeGLU gate at the serving prefill
    # rows, and the untied read-out (vocab 256,000) at decode.
    cases += [("rg_prefill_lin_y_bias_gelu", BATCH * PROMPT, 4096, 4096, "nn",
               "bias_gelu"),
              ("rg_prefill_gate_gelu", BATCH * PROMPT, 12288, 4096, "nn",
               "gelu"),
              ("rg_decode_readout", BATCH, 256000, 4096, "nn", None)]
    # internvl2-1b's projector: proj1 (1024 -> 896) with its bias and the
    # gelu fused, over the serving prefix's 4 x 256 image rows; seamless-m4t's
    # relu up projection (1024 -> 8192) at the serving prefill rows.
    # Seamless-m4t's untied read-out (d 1024, vocab 256,206) runs over its
    # bf16 copy padded to 16-byte rows (256,208 columns, the logits a view
    # of the first 256,206): at decode and over every training position.
    cases += [("internvl_proj1_bias_gelu", BATCH * VL_IMAGE, 896, 1024, "nn",
               "bias_gelu"),
              ("seamless_prefill_up_relu", BATCH * PROMPT, 8192, 1024, "nn",
               "relu"),
              ("seamless_decode_readout", BATCH, 256208, 1024, "nn", None),
              ("seamless_train_readout", TRAIN_BATCH * TRAIN_SEQ, 256208,
               1024, "nn", None)]
    cases = [c + ("bfloat16", False, 0, True) for c in cases]
    # The kernel's routes off the main path: every epilogue with and
    # without C_in, batches of 3, K below one panel and K off the ring's
    # 6 x 32, the decode rows 1-16 (route B, split K), rows just past a
    # palette edge (mixed tables of bm 128 / 64 beside bm 16 strips), a
    # table of 192 rows, split K whose panels do not divide by the split,
    # and operands TMA cannot read (route C, also the first ragged case).
    cases += [
        ("route_epi_silu", 256, 384, 320, "nn", "silu", "bfloat16", False,
         0, False),
        ("route_epi_relu_nt", 256, 384, 320, "nt", "relu", "bfloat16",
         False, 0, False),
        ("route_epi_bias_silu_acc", 200, 320, 256, "nn", "bias_silu",
         "bfloat16", True, 0, False),
        ("route_epi_gelu_acc_nt", 130, 200, 256, "nt", "gelu", "bfloat16",
         True, 0, False),
        ("route_batched3_bias_silu_acc_nt", 100, 200, 96, "nt", "bias_silu",
         "bfloat16", True, 3, False),
        ("route_batched3_nn", 100, 200, 96, "nn", None, "bfloat16", False, 3,
         False),
        ("route_k24", 96, 200, 24, "nn", None, "bfloat16", False, 0, False),
        ("route_k1000_nt", 140, 260, 1000, "nt", None, "bfloat16", False, 0,
         False),
        ("route_m1_silu", 1, 320, 512, "nn", "silu", "bfloat16", False, 0,
         False),
        ("route_m8_bias_acc_nt", 8, 320, 512, "nt", "bias", "bfloat16", True,
         0, False),
        ("route_m16", 16, 320, 512, "nn", None, "bfloat16", False, 0, False),
        ("route_m17_nt", 17, 320, 512, "nt", None, "bfloat16", False, 0,
         False),
        ("route_m65", 65, 320, 512, "nn", None, "bfloat16", False, 0, False),
        ("route_m129_nt", 129, 320, 512, "nt", None, "bfloat16", False, 0,
         False),
        ("route_rows192", 1024, 3072, 256, "nn", None, "bfloat16", False, 0,
         False),
        ("route_decode_split_k1096_silu", 4, 1024, 1096, "nn", "silu",
         "bfloat16", False, 0, False),
        ("route_c_nn_n1003_silu", 65, 1003, 256, "nn", "silu", "bfloat16",
         False, 0, False),
    ]
    cases += [
        ("ragged_bias_gelu_acc_nt", 997, 1003, 1001, "nt", "bias_gelu",
         "bfloat16", True, 0, False),
        ("ragged_f32_relu_acc", 300, 500, 129, "nn", "relu", "float32", True,
         0, False),
        ("ragged_f32_batched_bias_silu_nt", 77, 200, 50, "nt", "bias_silu",
         "float32", False, 3, False),
        ("decode_f32_gate_silu", 4, 1024, 1024, "nn", "silu", "float32",
         False, 0, False),
    ]
    return cases


# Decode rows (M <= 16) take a few microseconds on the card, less than the
# host takes to launch them, and in the model they read their weights from
# HBM, not from a warm L2: their rows also time the device alone (a CUDA
# graph of the calls), warm and after L2 has been flushed.
COLD_M = 16
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2


def graph_ms(torch, fn, iters: int = 20, flush=None, stream=None) -> float:
    """Mean device milliseconds of one call of ``fn``, from a CUDA graph of
    ``iters`` calls replayed under CUDA events, so no host launch time is
    counted.  With ``flush`` (a buffer larger than L2), each call follows a
    write of the buffer, and the graph time of the writes alone is
    subtracted: the call's time with its operands out of L2.  With
    ``stream``, the warm-up and the capture run on it (an autograd backward
    runs on the stream of its forward, which must be the capturing one)."""
    def capture(body):
        side = stream or torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()  # warm: plans, allocations
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            body()
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (3 * iters)

    def calls():
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            fn()

    def flushes():
        for _ in range(iters):
            flush.zero_()

    t = capture(calls)
    return t if flush is None else t - capture(flushes)


def run_gemm_case(torch, case, gen):
    import torch.nn.functional as F
    from repro_torch.core import GemmDescriptor, plan_gemm
    from repro_torch.kernels.gemm import kernel as gk
    from repro_torch.kernels.gemm.kernel import (FusedGemm, gemm_fused,
                                                 gemm_fused_plain, gemm_region,
                                                 gemm_region_plain)
    label, m, n, k, layout, epi, dname, acc, nb, main_path = case
    dt = getattr(torch, dname)
    nbx = max(1, nb)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    a = rnd(nbx, m, k)
    b = rnd(nbx, k, n, scale=k ** -0.5) if layout == "nn" else \
        rnd(nbx, n, k, scale=k ** -0.5)
    bias = rnd(n) if epi and epi.startswith("bias") else None
    c = rnd(nbx, m, n) if acc else None
    desc = GemmDescriptor(m=m, n=n, k=k, layout=layout, in_dtype=dname,
                          out_dtype=dname, epilogue=epi, accumulate=acc,
                          batch=nb)
    plan = plan_gemm(desc)
    exe = FusedGemm(plan.tile_schedule(), "cuda")
    kw = dict(layout=layout, epilogue=epi, bias=bias, c=c)

    def fused():
        return gemm_fused(exe, a, b, out_dtype=dt, **kw)

    def fused_plain():
        return gemm_fused_plain(exe.schedule, a, b, out_dtype=dt, **kw)

    out_r = torch.empty((nbx, m, n), dtype=dt, device="cuda")
    out_rp = torch.empty_like(out_r)

    def region():
        for r in plan.regions:
            gemm_region(a, b, out_r, r, **kw)

    def region_plain():
        for r in plan.regions:
            gemm_region_plain(a, b, out_rp, r, **kw)

    def library():
        bt = b if layout == "nn" else b.transpose(1, 2)
        y = torch.matmul(a, bt)
        if c is not None:
            y = y + c
        if bias is not None:
            y = y + bias
        if epi in ("gelu", "bias_gelu"):
            y = F.gelu(y, approximate="tanh")
        elif epi in ("silu", "bias_silu"):
            y = F.silu(y)
        elif epi == "relu":
            y = F.relu(y)
        return y

    isz = 2 if dname == "bfloat16" else 4
    nbytes = isz * (nbx * (m * k + k * n + m * n * (2 if acc else 1))
                    + (n if bias is not None else 0))
    op_ms = 2 * nbx * m * n * k / peak(dname) * 1e3
    byte_ms = nbytes / hbm() * 1e3
    lib_ms = time_ms(torch, library, 20)
    cold = m <= COLD_M
    if cold:
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                            device="cuda")
        lib_device = dict(device_library_ms=graph_ms(torch, library),
                          cold_library_ms=graph_ms(torch, library,
                                                   flush=flush))
    sms = gk.sm_count(a.device)
    rows = []
    for kname, kern, plain, out_k, out_p in (
            ("gemm_fused", fused, fused_plain, None, None),
            ("gemm_region", region, region_plain, out_r, out_rp)):
        before = dict(gk.ROUTES)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        routes = {r: gk.ROUTES[r] - before[r] for r in gk.ROUTES
                  if gk.ROUTES[r] != before[r]}
        if kname == "gemm_fused":
            splits = [gk.split_factor(exe.schedule.num_tiles * nbx, k, sms,
                                      next(iter(routes), None))]
        else:
            splits = [gk.split_factor(
                -(-r.rows // r.bm) * -(-r.cols // r.bn) * nbx, k, sms,
                gk.choose_route(dt, k, n if layout == "nn" else k, r.bm))
                for r in plan.regions]
        if out_k is not None:
            got, want = out_k, out_p
        max_abs, rel, nbad, tol = compare(torch, got, want, dname)
        row = dict(phase="kernel", kernel=kname, case=label, main_path=main_path,
                   shape=[nb, m, n, k], layout=layout, epilogue=epi,
                   dtype=dname, accumulate=acc,
                   blocks=[[r.bm, r.bn] for r in plan.regions],
                   routes=routes, splits=splits,
                   max_abs_err=max_abs, max_rel_err=rel, tolerance=tol,
                   mismatches=nbad,
                   ms=time_ms(torch, kern, 20),
                   plain_ms=time_ms(torch, plain, 2),
                   library_ms=lib_ms, op_ms=op_ms, byte_ms=byte_ms,
                   bound_ms=max(op_ms, byte_ms),
                   bound_by="bytes" if byte_ms >= op_ms else "operations")
        if cold:
            row.update(device_ms=graph_ms(torch, kern),
                       cold_ms=graph_ms(torch, kern, flush=flush),
                       **lib_device)
        emit(**row)
        if nbad:
            fail(f"{kname} {label}: {nbad} elements outside atol=rtol={tol}")
        if main_path and dname == "bfloat16" and set(routes) - {"A", "B"}:
            fail(f"{kname} {label}: a main-path bf16 GEMM took route(s) "
                 f"{routes}, not A or B")
        rows.append(row)
    return rows


def gemm_act_bwd_cases():
    """(label, m, n, k, layout, epilogue, accumulate, batch, out dtype,
    route, main) of the GEMM backward's fused recompute: the main path's
    at its training rows -- qwen3-0.6b's gate (the train phase), phi3-mini's
    gate at 8 x 4,096 rows (the benchmark's phi3mini-train), starcoder2's
    biased gelu up projection, whose output is fp32 (the bias takes its
    gradient) -- and off it route B (decode rows, K split) and route C
    (K off 16-byte rows, C, an fp32 output)."""
    d, ff = 1024, 3072
    rows = TRAIN_BATCH * TRAIN_SEQ
    return [
        ("train_gate_silu", rows, ff, d, "nn", "silu", False, 0, "bfloat16",
         "A", True),
        ("phi3_train_gate_silu", 8 * 4096, 8192, 3072, "nn", "silu", False,
         0, "bfloat16", "A", True),
        ("starcoder2_train_up_bias_gelu", rows, 24576, 6144, "nn",
         "bias_gelu", False, 0, "float32", "A", True),
        ("route_b_decode_split_k1096_silu", 4, 1024, 1096, "nn", "silu",
         False, 0, "bfloat16", "B", False),
        ("route_c_k1001_bias_gelu_acc_nt", 97, 103, 1001, "nt", "bias_gelu",
         True, 0, "float32", "C", False),
    ]


# gemm_act_bwd against its fp32 form: a bf16 output within two bf16 ulps of
# the largest entry (one rounding each side of values a few fp32 ulps
# apart); an fp32 output, rounded nowhere, within ACT_BWD_F32_TOL of each
# entry plus of the largest (one bf16 rounding on the way is 2**-9).
ACT_BWD_F32_TOL = 1e-4


def run_gemm_act_bwd_case(torch, case, gen):
    """One fused recompute (``gemm_act_bwd``, on the forward's plan) against
    its fp32 form (``gemm_act_bwd_plain``: the fp32 product and autograd of
    the epilogue, the backward's route off the card's bf16 path), beside
    the library: cuBLAS's bf16 product, then aten's activation backward."""
    from repro_torch.core import GemmDescriptor, plan_gemm
    from repro_torch.kernels.gemm import kernel as gk
    label, m, n, k, layout, epi, acc, nb, oname, route, main_path = case
    odt = getattr(torch, oname)
    nbx = max(1, nb)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).bfloat16()

    a = rnd(nbx, m, k)
    b = rnd(nbx, *((k, n) if layout == "nn" else (n, k)), scale=k ** -0.5)
    c = rnd(nbx, m, n) if acc else None
    bias = rnd(n) if epi.startswith("bias") else None
    dy = rnd(nbx, m, n)
    plan = plan_gemm(GemmDescriptor(m=m, n=n, k=k, layout=layout,
                                    in_dtype="bfloat16", out_dtype="bfloat16",
                                    epilogue=epi, accumulate=acc, batch=nb))
    exe = gk.FusedGemm(plan.tile_schedule(), "cuda")
    kw = dict(layout=layout, epilogue=epi, bias=bias, c=c)

    def fused():
        return gk.gemm_act_bwd(exe, a, b, dy, out_dtype=odt, **kw)

    def plain():
        return gk.gemm_act_bwd_plain(a, b, dy, **kw)

    def library():
        pre = torch.matmul(a, b if layout == "nn" else b.transpose(1, 2))
        if c is not None:
            pre = pre + c
        if bias is not None:
            pre = pre + bias
        if epi in ("gelu", "bias_gelu"):
            return torch.ops.aten.gelu_backward(dy, pre, approximate="tanh")
        if epi in ("silu", "bias_silu"):
            return torch.ops.aten.silu_backward(dy, pre)
        return torch.ops.aten.threshold_backward(dy, pre, 0)

    before = dict(gk.ROUTES)
    got, want = fused(), plain()
    torch.cuda.synchronize()
    routes = {r: gk.ROUTES[r] - before[r] for r in gk.ROUTES
              if gk.ROUTES[r] != before[r]}
    if not torch.isfinite(got.float()).all():
        fail(f"gemm_act_bwd {label}: output is not finite")
    err = (got.float() - want).abs()
    top = want.abs().max().item()
    if oname == "float32":
        tol = ACT_BWD_F32_TOL
        nbad = int((err > tol * (want.abs() + top)).sum().item())
    else:
        tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
        nbad = int((err > tol).sum().item())
    max_abs = err.max().item()
    del got, want, err
    nbytes = (2 * nbx * (m * k + k * n + m * n * (2 if acc else 1))
              + odt.itemsize * nbx * m * n + (2 * n if bias is not None
                                                else 0))
    big = m * n * k >= 1 << 36
    row = dict(phase="kernel", kernel="gemm_act_bwd", case=label,
               main_path=main_path, shape=[nb, m, n, k], layout=layout,
               epilogue=epi, dtype="bfloat16", out_dtype=oname,
               accumulate=acc, blocks=[[r.bm, r.bn] for r in plan.regions],
               route=next(iter(routes), None), routes=routes,
               max_abs_err=max_abs, max_rel_err=max_abs / max(top, 1e-30),
               tolerance=tol, mismatches=nbad,
               ms=time_ms(torch, fused, 5 if big else 20),
               plain_ms=time_ms(torch, plain, 2),
               library_ms=time_ms(torch, library, 5 if big else 20),
               **bound(nbytes, 2 * nbx * m * n * k, "bfloat16"))
    emit(**row)
    if nbad:
        fail(f"gemm_act_bwd {label}: {nbad} elements outside the tolerance "
             f"{tol}")
    if list(routes) != [route]:
        fail(f"gemm_act_bwd {label}: took route(s) {routes}, not {route}")
    return [row]


# Per-head scales of the heads_magnitude case: neighbouring heads that
# differ by orders of magnitude, so that a window that read across a
# head's end (a map over BH * s rows, or a Q box past sq) would show.
HEAD_SCALES = (1.0, 1e3, 1e-3, 30.0)


def flash_cases():
    """(label, bh, sq, sk, d, causal, dtype, main, head_scales): the
    main-path shapes (route A; head dims 128 and phi3-mini's 96; at d 64
    internvl2-1b's prefill over its image prefix and text, and
    seamless-m4t's non-causal calls: the encoder over 1,000 frames and
    cross-attention of a 256-token prefill and of a decode step's single
    row into them), then ragged bf16 cases on route A, a bf16 head dim
    whose rows TMA cannot read (d 36: route C) and fp32 cases."""
    return [("prefill_causal", BATCH * 16, PROMPT, PROMPT, 128, True,
             "bfloat16", True, None),
            ("moe_prefill_causal", BATCH * 32, PROMPT, PROMPT, 128, True,
             "bfloat16", True, None),
            # phi3-mini-3.8b's prefill: 32 heads of 96, route A's DN 128
            # instantiation over 96-column rows.
            ("phi3_prefill_causal_d96", BATCH * 32, PROMPT, PROMPT, 96, True,
             "bfloat16", True, None),
            ("internvl_prefill_causal_d64", BATCH * 14, VL_IMAGE + PROMPT,
             VL_IMAGE + PROMPT, 64, True, "bfloat16", True, None),
            ("seamless_encoder_noncausal", BATCH * 16, ED_FRAMES, ED_FRAMES,
             64, False, "bfloat16", True, None),
            ("seamless_cross_prefill", BATCH * 16, PROMPT, ED_FRAMES, 64,
             False, "bfloat16", True, None),
            ("seamless_cross_decode", BATCH * 16, 1, ED_FRAMES, 64, False,
             "bfloat16", True, None),
            ("ragged_causal_100", 8, 100, 100, 128, True, "bfloat16", False,
             None),
            ("ragged_noncausal_130x70_bf16", 6, 130, 70, 64, False,
             "bfloat16", False, None),
            ("heads_magnitude_100", len(HEAD_SCALES), 100, 100, 128, True,
             "bfloat16", False, HEAD_SCALES),
            ("route_c_causal_d36", 8, 100, 100, 36, True, "bfloat16", False,
             None),
            ("ragged_noncausal_130x70", 6, 130, 70, 64, False, "float32",
             False, None),
            ("f32_causal_d16", 8, 100, 100, 16, True, "float32", False,
             None)]


def _flash_route(torch, kname, fn, want, main_path, dname, label,
                 routes=None):
    """Runs ``fn`` once and returns its output and the flash route it took
    (counted in ``routes``, the forwards' ``ROUTES`` unless given); fails
    unless that is the route choose_route names (``want``), and a main-path
    bf16 case off route A."""
    from repro_torch.kernels.flash_attention import kernel as fk
    routes = fk.ROUTES if routes is None else routes
    before = dict(routes)
    out = fn()
    torch.cuda.synchronize()
    taken = {r: routes[r] - before[r] for r in routes
             if routes[r] != before[r]}
    if taken != {want: 1}:
        fail(f"{kname} {label}: routes {taken}, expected one launch on {want}")
    if main_path and dname == "bfloat16" and want != "A":
        fail(f"{kname} {label}: a main-path bf16 case took route {want}")
    return out, want


def run_flash_case(torch, case, gen):
    import torch.nn.functional as F
    from repro_torch.core import FlashDescriptor, plan_flash
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.kernel import (
        FusedFlash, flash_fwd_dense, flash_fwd_dense_plain, flash_fwd_fused,
        flash_fwd_fused_plain)
    label, bh, sq, sk, d, causal, dname, main_path, head_scales = case
    dt = getattr(torch, dname)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda")
               for s in (sq, sk, sk))
    if head_scales is not None:
        scale = torch.tensor(head_scales, device="cuda")[:, None, None]
        k, v = k * scale.sqrt(), v * scale
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    desc = FlashDescriptor(batch_heads=bh, sq=sq, sk=sk, d=d, causal=causal,
                           dtype=dname)
    plan = plan_flash(desc)
    exe = FusedFlash(plan.tile_schedule(), "cuda")
    bq, bk = min(plan.block_q, sq), min(plan.block_k, sk)
    want_route = fk.choose_route(dt, d, (q.data_ptr(), k.data_ptr(),
                                         v.data_ptr()))

    def library():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=causal)

    op_ms = desc.flops / peak(dname) * 1e3
    byte_ms = (desc.in_bytes + desc.out_bytes) / hbm() * 1e3
    lib_ms = time_ms(torch, library, 20)
    lib_device_ms = graph_ms(torch, library)
    rows = []
    for kname, kern, plain in (
            ("flash_fwd_fused", lambda: flash_fwd_fused(exe, q, k, v),
             lambda: flash_fwd_fused_plain(exe.schedule, q, k, v)),
            ("flash_fwd_dense",
             lambda: flash_fwd_dense(q, k, v, block_q=bq, block_k=bk,
                                     causal=causal),
             lambda: flash_fwd_dense_plain(q, k, v, block_q=bq, block_k=bk,
                                           causal=causal))):
        got, route = _flash_route(torch, kname, kern, want_route, main_path,
                                  dname, label)
        want = plain()
        torch.cuda.synchronize()
        max_abs, rel, nbad, tol = compare(torch, got, want, dname)
        row = dict(phase="kernel", kernel=kname, case=label, main_path=main_path,
                   shape=[bh, sq, sk, d], causal=causal, dtype=dname,
                   blocks=[bq, bk], route=route, head_scales=head_scales,
                   max_abs_err=max_abs, max_rel_err=rel,
                   tolerance=tol, mismatches=nbad,
                   ms=time_ms(torch, kern, 20),
                   plain_ms=time_ms(torch, plain, 2),
                   device_ms=graph_ms(torch, kern),
                   library_ms=lib_ms, device_library_ms=lib_device_ms,
                   op_ms=op_ms, byte_ms=byte_ms,
                   bound_ms=max(op_ms, byte_ms),
                   bound_by="bytes" if byte_ms >= op_ms else "operations")
        emit(**row)
        if nbad:
            fail(f"{kname} {label}: {nbad} elements outside atol=rtol={tol}")
        rows.append(row)
    return rows


def flash_bwd_cases():
    """(label, bh, sq, sk, d, causal, dtype, main): the training shapes
    (batch 8 x 16 heads of Qwen3, 8 x 32 of phi3.5-moe and of phi3-mini,
    whose heads are 96 wide; sequence 128; at d 64 internvl2-1b's 8 x 14
    heads over 256 image + 128 text positions, and seamless-m4t's 8 x 16
    heads: the encoder over 512 frames and cross-attention of 128 tokens
    into them, both non-causal),
    route A's edges in bf16 (ragged non-causal windows with sk > sq at d
    96, a clamped causal case), a bf16 head dim whose rows TMA cannot read
    (d 36: route C) and ragged fp32 cases."""
    return [("train_causal", TRAIN_BATCH * 16, TRAIN_SEQ, TRAIN_SEQ, 128,
             True, "bfloat16", True),
            ("moe_train_causal", TRAIN_BATCH * 32, TRAIN_SEQ, TRAIN_SEQ,
             128, True, "bfloat16", True),
            ("phi3_train_causal_d96", TRAIN_BATCH * 32, TRAIN_SEQ, TRAIN_SEQ,
             96, True, "bfloat16", True),
            ("internvl_train_causal_d64", TRAIN_BATCH * 14,
             VL_IMAGE + TRAIN_SEQ, VL_IMAGE + TRAIN_SEQ, 64, True, "bfloat16",
             True),
            ("seamless_train_encoder", TRAIN_BATCH * 16, ED_TRAIN_FRAMES,
             ED_TRAIN_FRAMES, 64, False, "bfloat16", True),
            ("seamless_train_cross", TRAIN_BATCH * 16, TRAIN_SEQ,
             ED_TRAIN_FRAMES, 64, False, "bfloat16", True),
            ("ragged_noncausal_100x130_d96", 6, 100, 130, 96, False,
             "bfloat16", False),
            ("clamped_causal_100", 8, 100, 100, 128, True, "bfloat16",
             False),
            ("route_c_causal_d36", 8, 100, 100, 36, True, "bfloat16",
             False),
            ("ragged_f32_causal_100x130", 6, 100, 130, 64, True, "float32",
             False),
            ("ragged_f32_noncausal_130x70", 6, 130, 70, 96, False, "float32",
             False)]


def run_flash_bwd_case(torch, case, gen):
    """The LSE form of flash_fwd_fused and flash_bwd_fused against their
    plain versions, with SDPA's forward / backward as the library."""
    import torch.nn.functional as F
    from repro_torch.core import (FlashBwdDescriptor, FlashDescriptor,
                                  plan_flash_bwd)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.kernel import (
        FusedFlash, flash_bwd_fused, flash_bwd_fused_plain, flash_fwd_fused,
        flash_fwd_fused_plain)
    label, bh, sq, sk, d, causal, dname, main_path = case
    dt = getattr(torch, dname)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda").to(dt)
               for s in (sq, sk, sk))
    do = torch.randn((bh, sq, d), generator=gen, device="cuda").to(dt)
    desc = FlashDescriptor(batch_heads=bh, sq=sq, sk=sk, d=d, causal=causal,
                           dtype=dname)
    bdesc = FlashBwdDescriptor.from_forward(desc)
    plan = plan_flash_bwd(bdesc)
    exe = FusedFlash(plan.tile_schedule(), "cuda")
    rows = []

    def row(kname, errs, tol, ms, plain_ms, lib_ms, nbytes, flops, **extra):
        op_ms = flops / peak(dname) * 1e3
        byte_ms = nbytes / hbm() * 1e3
        r = dict(phase="kernel", kernel=kname, case=label,
                 main_path=main_path, shape=[bh, sq, sk, d], causal=causal,
                 dtype=dname, blocks=[exe.schedule.bq, exe.schedule.bk],
                 **extra,
                 max_abs_err=max(e[0] for e in errs.values()),
                 errors={n: e[0] for n, e in errs.items()},
                 max_rel_err=max(e[1] for e in errs.values()), tolerance=tol,
                 mismatches=sum(e[2] for e in errs.values()), ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, op_ms=op_ms,
                 byte_ms=byte_ms, bound_ms=max(op_ms, byte_ms),
                 bound_by="bytes" if byte_ms >= op_ms else "operations")
        emit(**r)
        if r["mismatches"]:
            fail(f"{kname} {label}: {r['mismatches']} elements outside "
                 f"atol=rtol={tol}")
        rows.append(r)

    def errors(got, want, tol):
        diff = (got.float() - want.float()).abs()
        if not torch.isfinite(got.float()).all():
            fail(f"{label}: kernel output is not finite")
        bad = int((diff > tol + tol * want.float().abs()).sum().item())
        return (diff.max().item(),
                diff.max().item() / max(want.float().abs().max().item(), 1e-30),
                bad)

    # Forward with the LSE rows.
    def fwd():
        return flash_fwd_fused(exe, q, k, v, return_lse=True)

    def sdpa():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=causal)

    (o, lse), route = _flash_route(
        torch, "flash_fwd_fused", fwd,
        fk.choose_route(dt, d, (q.data_ptr(), k.data_ptr(), v.data_ptr())),
        main_path, dname, label)
    o_p, lse_p = flash_fwd_fused_plain(exe.schedule, q, k, v, return_lse=True)
    torch.cuda.synchronize()
    lib_fwd = time_ms(torch, sdpa, 20)
    row("flash_fwd_fused", {"o": errors(o, o_p, TOL[dname]),
                            "lse": errors(lse, lse_p, LSE_TOL)},
        {"o": TOL[dname], "lse": LSE_TOL},
        time_ms(torch, fwd, 20),
        time_ms(torch, lambda: flash_fwd_fused_plain(
            exe.schedule, q, k, v, return_lse=True), 2),
        lib_fwd, desc.in_bytes + desc.out_bytes + bh * sq * 4, desc.flops,
        route=route, device_ms=graph_ms(torch, fwd),
        device_library_ms=graph_ms(torch, sdpa))

    # Backward, on the kernel's own o and lse: one launch on the route
    # choose_route names for its five operands (route A on the main path).
    def bwd():
        return flash_bwd_fused(exe, q, k, v, o, do, lse)

    got, bwd_route = _flash_route(
        torch, "flash_bwd_fused", bwd,
        fk.choose_route(dt, d, tuple(t.data_ptr() for t in (q, k, v, o, do))),
        main_path, dname, label, fk.BWD_ROUTES)
    want = flash_bwd_fused_plain(exe.schedule, q, k, v, o, do, lse)
    torch.cuda.synchronize()
    qs, ks, vs = (t.detach()[None].requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    def sdpa_bwd():
        return torch.autograd.grad(out, (qs, ks, vs), do[None],
                                   retain_graph=True)

    # For its device time, SDPA's forward runs on a stream of its own, from
    # leaves first used there, and the graph captures the backward alone on
    # that stream.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach()[None].requires_grad_(True) for t in (q, k, v)]
        out_side = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    torch.cuda.current_stream().wait_stream(side)
    row("flash_bwd_fused",
        {n: errors(g, w, BWD_TOL) for n, g, w in zip(("dq", "dk", "dv"),
                                                      got, want)},
        BWD_TOL, time_ms(torch, bwd, 20),
        time_ms(torch, lambda: flash_bwd_fused_plain(exe.schedule, q, k, v,
                                                     o, do, lse), 2),
        time_ms(torch, sdpa_bwd, 20), bdesc.in_bytes + bdesc.out_bytes,
        bdesc.flops, route=bwd_route, device_ms=graph_ms(torch, bwd),
        device_library_ms=graph_ms(torch, lambda: torch.autograd.grad(
            out_side, leaves, do[None], retain_graph=True), stream=side))
    return rows


def decode_cases():
    """(label, slot lengths, dtype, main): the continuous phase's pool (8
    slots, 16 query / 8 KV heads of 128, 96 pages of 16, 24 blocks) with
    ragged lengths, one slot empty."""
    return [("serve_ragged", (0, 1, 16, 17, 300, 255, 100, 33), "bfloat16",
             True),
            ("f32_ragged", (0, 1, 15, 16, 47, 64, 5, 200), "float32", False)]


def run_decode_case(torch, case, gen):
    """flash_decode against its plain version over shuffled block tables;
    the library is SDPA on the slots' pages gathered to a contiguous,
    masked K/V (the gather outside the timed region)."""
    import torch.nn.functional as F
    from repro_torch.core import DecodeTileSchedule
    from repro_torch.kernels.flash_attention.kernel import (
        FlashDecode, flash_decode, flash_decode_plain)
    from repro_torch.kernels.flash_attention import kernel as fk
    label, lengths, dname, main_path = case
    dt = getattr(torch, dname)
    S, P, B, h, hkv, hd = (CONT_SLOTS, CONT_PAGE, CONT_BLOCKS, 16, 8, 128)
    q = torch.randn((S, h, hd), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((CONT_PAGES, P, hkv, hd), generator=gen,
                        device="cuda").to(dt) for _ in range(2))
    perm = torch.randperm(CONT_PAGES, generator=torch.Generator()
                          .manual_seed(len(label)))
    bt = torch.zeros((S, B), dtype=torch.int32)
    used = 0
    for slot, n in enumerate(-(-L // P) for L in lengths):
        bt[slot, :n] = perm[used:used + n]
        used += n
    bt, lens = bt.cuda(), torch.tensor(lengths, dtype=torch.int32,
                                       device="cuda")
    exe = FlashDecode(DecodeTileSchedule(num_seqs=S, pages=CONT_PAGES,
                                         page_size=P, max_blocks=B), "cuda")
    exe.update(bt, lens)
    before = dict(fk.DECODE_ROUTES)
    got = flash_decode(exe, q, k, v)
    route = _route_taken(fk.DECODE_ROUTES, before)
    want = flash_decode_plain(exe, q, k, v)
    torch.cuda.synchronize()
    max_abs, rel, nbad, tol = compare(torch, got, want, dname)
    empty = [i for i, L in enumerate(lengths) if L == 0]
    if any(got[i].abs().max().item() != 0 for i in empty):
        fail(f"flash_decode {label}: an empty slot did not drain zeros")
    # Library: SDPA over the gathered pages, heads expanded to h.
    span = torch.arange(B * P, device="cuda")
    gk, gv = (t[bt.long()].reshape(S, B * P, hkv, hd).transpose(1, 2)
              .repeat_interleave(h // hkv, dim=1).contiguous() for t in (k, v))
    mask = (span[None, :] < lens[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]

    def kern():
        return flash_decode(exe, q, k, v)

    def library():
        return F.scaled_dot_product_attention(q4, gk, gv, attn_mask=mask)

    # Bytes: the live K/V rows (the kernel never reads rows past a slot's
    # length), q and out, plus the block-table entries and lengths.
    isz = 2 if dname == "bfloat16" else 4
    live_pages = sum(-(-L // P) for L in lengths)
    nbytes = isz * (2 * sum(lengths) * hkv * hd + 2 * S * h * hd) \
        + 4 * (live_pages + S)
    op_ms = 4 * h * hd * sum(lengths) / peak(dname) * 1e3
    byte_ms = nbytes / hbm() * 1e3
    row = dict(phase="kernel", kernel="flash_decode", case=label,
               main_path=main_path, shape=[S, h, hkv, hd, P],
               lengths=list(lengths), dtype=dname, max_abs_err=max_abs,
               max_rel_err=rel, tolerance=tol, mismatches=nbad,
               differ_frac=(got != want).float().mean().item(), route=route,
               ms=time_ms(torch, kern, 50),
               plain_ms=time_ms(torch, lambda: flash_decode_plain(
                   exe, q, k, v), 2),
               library_ms=time_ms(torch, library, 50),
               **_device_and_cold(torch, kern, library), op_ms=op_ms,
               byte_ms=byte_ms, bound_ms=max(op_ms, byte_ms),
               bound_by="bytes" if byte_ms >= op_ms else "operations")
    emit(**row)
    if nbad:
        fail(f"flash_decode {label}: {nbad} elements outside atol=rtol={tol}")
    _check_decode_route("flash_decode", label, route, dname)
    return [row]


def _check_decode_route(kname, label, route, dname):
    """bf16 decode rows run route A (the main path's), fp32 rows B."""
    want = "A" if dname == "bfloat16" else "B"
    if route != want:
        fail(f"{kname} {label}: route {route}, expected {want}")


def ssd_cases():
    """(label, (G, NC, Q, n, p), (C/B, L, xdt) dtypes, main): full-width
    mamba2-130m at serving batch 4 (96 groups; the diag form flattened to
    384) and training batch 8 x 1024 (192 groups, with the entering
    states and the backward) in the model's dtypes, the serving shape in
    bf16 throughout and in fp32, and the odd little case of
    tests/test_kernels_other.py."""
    bf, f32 = "bfloat16", "float32"
    return [("serve_model_dtypes", (96, 4, 256, 128, 64), (bf, f32, f32),
             True),
            ("train_model_dtypes", (192, 4, 256, 128, 64), (bf, f32, f32),
             True),
            ("serve_bf16", (96, 4, 256, 128, 64), (bf, bf, bf), False),
            ("serve_f32", (96, 4, 256, 128, 64), (f32, f32, f32), False),
            ("odd_little_f32", (2, 3, 16, 8, 12), (f32, f32, f32), False)]


def _ssd_operands(torch, shape, dtypes, gen):
    """Physical inputs: decays in (0, 1] from a negative cumulative
    log-decay, L lower-triangular, as the model builds them."""
    g, nc, q, n, p = shape
    cdt, ldt, xdt = (getattr(torch, d) for d in dtypes)

    def rnd(*s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale

    c, b = rnd(g, nc, q, n, scale=0.5).to(cdt), rnd(g, nc, q, n,
                                                     scale=0.5).to(cdt)
    da = -(rnd(g, nc, q).abs() * 0.02).cumsum(-1)
    seg = da[..., :, None] - da[..., None, :]
    tril = torch.ones((q, q), dtype=torch.bool, device="cuda").tril()
    l = torch.where(tril, torch.exp(seg), 0.0).to(ldt)
    x = rnd(g, nc, q, p, scale=0.5).to(xdt)
    di, do = torch.exp(da), torch.exp(da[..., -1:] - da)
    s0 = rnd(g, p, n, scale=0.3)
    return c, b, l, x, di, do, s0


def _ssd_composition(torch, c, b, l, x, di, do, s0):
    """The torch backend's composition (models/ssd.py ``_ssd_chunked``) on
    the kernel's operands: cuBLAS einsums in the operands' dtypes (promoted
    as jnp.einsum would), the inter-chunk recurrence a chunk loop."""
    def es(eq, *ops):
        dt = ops[0].dtype
        for t in ops[1:]:
            dt = torch.promote_types(dt, t.dtype)
        return torch.einsum(eq, *(t.to(dt) for t in ops))
    y_diag = es("gcqk,gckp->gcqp", (es("gcqn,gckn->gcqk", c, b) * l)
                .to(x.dtype), x)
    bx = es("gcqn,gcqp->gcpn", b, (x * do[..., None]).to(x.dtype)).float()
    state, s_prev = s0, []
    for ci in range(c.shape[1]):
        s_prev.append(state)
        state = state * di[:, ci, -1, None, None] + bx[:, ci]
    y_off = es("gcqn,gcpn->gcqp", c, torch.stack(s_prev, 1).to(x.dtype)) \
        * di[..., None].to(x.dtype)
    return (y_diag + y_off).to(x.dtype), state


def _ssd_bound(kind, shape, dtypes, states=False):
    """(byte_ms, op_ms, fp32_op_ms) of one call: each input read once and
    each output written once at its dtype.  ``op_ms`` prices every product
    on the tensor cores at the bf16 peak, a product with one fp32 operand
    as two bf16 products (hi and lo) and with two as three, the least the
    card needs at the kernels' fp32 tolerance; ``fp32_op_ms`` is the
    earlier rule, a product with an fp32 operand at the fp32 CUDA-core
    peak."""
    g, nc, q, n, p = shape
    cells = g * nc
    isz = {"bfloat16": 2, "float32": 4}
    ci, li, xi = (isz[d] for d in dtypes)
    cb, xb = dtypes[0] == "bfloat16", dtypes[2] == "bfloat16"

    def ops_ms(*terms):  # (flops, first operand bf16, second operand bf16)
        tc = sum(f * (3 - a - b) for f, a, b in terms) / peak("bfloat16")
        old = sum(f / peak("bfloat16" if a and b else "float32")
                  for f, a, b in terms)
        return tc * 1e3, old * 1e3

    qqn, qqp, qnp = cells * 2 * q * q * n, cells * 2 * q * q * p, \
        cells * 2 * q * n * p
    cell_in = 2 * q * n * ci + q * q * li + q * p * xi
    if kind == "diag":
        nbytes = cells * (cell_in + q * p * xi)
        op = ops_ms((qqn, cb, cb), (qqp, xb, xb))
    elif kind == "scan":
        nbytes = cells * (cell_in + 2 * q * 4 + q * p * xi) \
            + 2 * g * p * n * 4 + (cells * p * n * 4 if states else 0)
        op = ops_ms((qqn, cb, cb), (qqp, xb, xb),  # C·Bᵀ, W (xdt's dtype)·xdt
                    (qnp, cb, False),              # C·Sᵀ
                    (qnp, xb, cb))                 # xwᵀ·B
    else:  # bwd: operands, states, fp32 dY / dSf in; fp32 cotangents out
        nbytes = cells * (cell_in + 2 * q * 4 + p * n * 4 + q * p * 4) \
            + g * p * n * 4 \
            + cells * (2 * q * n + q * q + q * p + 2 * q) * 4 + g * p * n * 4
        # widened as the reference's backward: the scores C·Bᵀ at C/B's
        # type; dscores·B, dscoresᵀ·C, dW = dY·xdtᵀ and wᵀ·dY; the state
        # terms B·dSᵀ, (xdt ⊙ do)·dS, C·S_inᵀ, (dY ⊙ di)·S_in and the
        # increment (dY ⊙ di)ᵀ·C
        op = ops_ms((qqn, cb, cb), (qqn, False, cb), (qqn, False, cb),
                    (qqp, False, xb), (qqp, False, False),
                    (qnp, cb, False), (qnp, False, False), (qnp, cb, False),
                    (qnp, False, False), (qnp, False, cb))
    return (nbytes / hbm() * 1e3, *op)


def run_ssd_case(torch, case, gen):
    """ssd_scan_fused (with the entering states at the training shape),
    ssd_chunk_diag on the flattened cells and ssd_scan_bwd against their
    plain versions; the library is the torch backend's composition."""
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.kernels.ssd_chunk.kernel import (
        ssd_chunk_diag, ssd_chunk_diag_plain, ssd_scan_bwd, ssd_scan_bwd_plain,
        ssd_scan_fused, ssd_scan_fused_plain)
    label, shape, dtypes, main_path = case
    g, nc, q, n, p = shape
    c, b, l, x, di, do, s0 = ops = _ssd_operands(torch, shape, dtypes, gen)
    train = label.startswith("train")
    rows = []

    def row(kname, kind, errs, tol, kern, plain, library, states=False,
            **extra):
        byte_ms, op_ms, fp32_op_ms = _ssd_bound(kind, shape, dtypes, states)
        r = dict(phase="kernel", kernel=kname, case=label, main_path=main_path,
                 shape=list(shape), dtypes=list(dtypes),
                 max_abs_err=max(e[0] for e in errs.values()),
                 errors={k: e[0] for k, e in errs.items()},
                 max_rel_err=max(e[1] for e in errs.values()), tolerance=tol,
                 mismatches=sum(e[2] for e in errs.values()),
                 ms=time_ms(torch, kern, 10), plain_ms=time_ms(torch, plain, 2),
                 library_ms=time_ms(torch, library, 5), op_ms=op_ms,
                 fp32_op_ms=fp32_op_ms, byte_ms=byte_ms,
                 bound_ms=max(op_ms, byte_ms),
                 bound_by="bytes" if byte_ms >= op_ms else "operations",
                 **extra)
        emit(**r)
        if r["mismatches"]:
            fail(f"{kname} {label}: {r['mismatches']} elements outside "
                 f"atol=rtol={tol}")
        rows.append(r)

    def errors(got, want, tol):
        diff = (got.float() - want.float()).abs()
        if not torch.isfinite(got.float()).all():
            fail(f"{label}: kernel output is not finite")
        bad = int((diff > tol + tol * want.float().abs()).sum().item())
        return (diff.max().item(),
                diff.max().item() / max(want.float().abs().max().item(), 1e-30),
                bad)

    def forward(kname, call):
        """One call on the route choose_fwd_route names (route A on the
        main path), and a second that gives the same bits (no atomics)."""
        before = dict(sk.SSD_FWD_ROUTES)
        got, again = call(), call()
        torch.cuda.synchronize()
        took = [r for r, n in sk.SSD_FWD_ROUTES.items() if n != before[r]]
        route = took[0] if len(took) == 1 else str(took)
        if main_path and route != "A":
            fail(f"{kname} {label}: route {route}, expected A")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{kname} {label}: two runs differ")
        return got, route

    def timed(kern, library):
        """Device times (CUDA graphs) of the kernel and the composition."""
        return dict(device_ms=graph_ms(torch, kern, iters=5),
                    device_library_ms=graph_ms(torch, library, iters=5))

    ytol, stol = TOL[dtypes[2]], TOL["float32"]
    (y, sf, st), route = forward(
        "ssd_scan_fused", lambda: ssd_scan_fused(*ops, return_states=True))
    yp, sfp, stp = ssd_scan_fused_plain(*ops, return_states=True)
    torch.cuda.synchronize()

    def scan():
        return ssd_scan_fused(*ops, return_states=train)

    def composition():
        return _ssd_composition(torch, *ops)

    row("ssd_scan_fused", "scan",
        {"y": errors(y, yp, ytol), "s_final": errors(sf, sfp, stol),
         "states": errors(st, stp, stol)},
        {"y": ytol, "states": stol}, scan,
        lambda: ssd_scan_fused_plain(*ops, return_states=train),
        composition, states=train, route=route, **timed(scan, composition))
    if not train:
        flat = [t.reshape(g * nc, *t.shape[2:]) for t in (c, b, l, x)]
        (yd,), route = forward("ssd_chunk_diag",
                               lambda: (ssd_chunk_diag(*flat),))
        ydp = ssd_chunk_diag_plain(*flat)
        torch.cuda.synchronize()

        def diag():
            return ssd_chunk_diag(*flat)

        def diag_composition():
            return _ssd_diag_composition(torch, *flat)

        row("ssd_chunk_diag", "diag", {"y": errors(yd, ydp, ytol)}, ytol,
            diag, lambda: ssd_chunk_diag_plain(*flat), diag_composition,
            route=route, **timed(diag, diag_composition))
    if train or not main_path:
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        dsf = torch.randn(s0.shape, generator=gen, device="cuda")

        def bwd():
            return ssd_scan_bwd(*ops[:6], st, dy, dsf)

        # One launch, on the route choose_bwd_route names (route A on the
        # main path); a second gives the same bits (no atomics).
        before = dict(sk.SSD_BWD_ROUTES)
        got, again = bwd(), bwd()
        torch.cuda.synchronize()
        took = [r for r, n in sk.SSD_BWD_ROUTES.items() if n != before[r]]
        route = took[0] if len(took) == 1 else str(took)
        if main_path and route != "A":
            fail(f"ssd_scan_bwd {label}: route {route}, expected A")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"ssd_scan_bwd {label}: two runs differ")
        want = ssd_scan_bwd_plain(*ops[:6], st, dy, dsf)
        torch.cuda.synchronize()
        names = ("dc", "db", "dl", "dx", "ddi", "ddo", "ds0")
        leaves = [t.detach().requires_grad_(True) for t in ops]
        outs = _ssd_composition(torch, *leaves)
        # For its device time, the composition's forward runs on a stream
        # of its own, from leaves first used there, and the graph captures
        # the autograd backward alone on that stream.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            side_leaves = [t.detach().requires_grad_(True) for t in ops]
            side_outs = _ssd_composition(torch, *side_leaves)
        torch.cuda.current_stream().wait_stream(side)
        row("ssd_scan_bwd", "bwd",
            {k: errors(a, w, BWD_TOL) for k, a, w in zip(names, got, want)},
            BWD_TOL, bwd, lambda: ssd_scan_bwd_plain(*ops[:6], st, dy, dsf),
            lambda: torch.autograd.grad(outs, leaves, (dy.to(x.dtype), dsf),
                                        retain_graph=True),
            route=route, device_ms=graph_ms(torch, bwd, iters=5),
            device_library_ms=graph_ms(
                torch, lambda: torch.autograd.grad(
                    side_outs, side_leaves, (dy.to(x.dtype), dsf),
                    retain_graph=True), iters=5, stream=side))
    return rows


def _ssd_diag_composition(torch, c, b, l, x):
    """The torch backend's intra-chunk einsums on the flat operands."""
    scores = torch.einsum("gqn,gkn->gqk", c, b)
    w = (scores.to(torch.promote_types(scores.dtype, l.dtype)) * l) \
        .to(x.dtype)
    return torch.einsum("gqk,gkp->gqp", w, x)


def grouped_cases():
    """(label, group sizes, rows past their sum, K, N, epilogue, dtype,
    pinned (bm, bn) or None for the planner's, main, backward too, rows
    past the sum hold NaN).
    phi3.5-moe-42b's expert GEMMs route uniform capacity slots: 16 groups
    of 256 rows at prefill (batch 4 x 256) and training (8 x 128), of 32
    at decode; up and gate (silu) are d 4096 -> d_ff 6400, down the
    reverse, all bf16, and training runs the backward at the prefill
    shapes; grok-1-314b's gate (gelu) at its prefill, 8 groups of 512
    rows, d 6144 -> 32,768.  Then ragged cases: sums below T, empty
    experts, groups smaller than bm, K and N tails, every epilogue.  Then the bf16 wgmma
    tile off the main path: every epilogue with and without bias, every
    (bm, bn) of SHAPES pinned, row-aware tiles (groups of 1, 17, 32, 64
    and 65 rows on bm 128 and bm 64 tiles, an empty expert), K below one
    panel and K off the ring's 6 x 32, route C (x rows of 200 bytes; the
    planned N = 300 case above has weight rows of 600), NaN in the rows
    past sum(group_sizes), and the two decode cases on the pinned bm 16
    and bm 64 tiles beside the planner's bm 128.  The backward runs on
    every prefill and ragged case (bf16 on its routes A and C, fp32) and
    on the row-aware bm 128 and bm 64 tiles and the NaN case of route A."""
    bf, f32 = "bfloat16", "float32"
    d, ff = 4096, 6400
    cases = [
        ("prefill_gate_silu", [256] * 16, 0, d, ff, "silu", bf, None, True,
         True),
        ("prefill_down", [256] * 16, 0, ff, d, None, bf, None, True, True),
        ("decode_gate_silu", [32] * 16, 0, d, ff, "silu", bf, None, True,
         False),
        ("decode_down", [32] * 16, 0, ff, d, None, bf, None, True, False),
        # grok-1-314b's gate (gelu) at its bank, 8 experts of d 6144 -> d_ff
        # 32,768: top-2 routing of the serving prefill's 1024 tokens in
        # groups of 32 gives 16 capacity slots an expert a group, 512 rows.
        ("grok_prefill_gate_gelu", [512] * 8, 0, 6144, 32768, "gelu", bf,
         None, True, False),
        ("ragged_f32_bias_silu", [37, 0, 201, 70], 4, 100, 70, "bias_silu",
         f32, (16, 64), False, True),
        ("ragged_f32_gelu_small_groups", [5, 3, 2, 1, 0], 7, 129, 200, "gelu",
         f32, (64, 128), False, True),
        ("ragged_bf16_relu", [300, 0, 17], 33, 96, 160, "relu", bf,
         (128, 128), False, True),
        ("ragged_f32_bias", [60, 60, 60], 33, 100, 70, "bias", f32, (16, 128),
         False, True),
        ("ragged_f32_bias_gelu", [13, 0, 40, 7], 5, 100, 70, "bias_gelu", f32,
         (128, 64), False, True),
        ("ragged_bf16_bias_silu_planned", [100, 0, 0, 250], 20, 1000, 300,
         "bias_silu", bf, None, False, True),
    ]
    cases = [c + (False,) for c in cases]
    from repro_torch.kernels.grouped_gemm.kernel import SHAPES
    for epi in (None, "bias", "gelu", "silu", "relu", "bias_gelu",
                "bias_silu"):
        cases.append((f"tile_epi_{epi or 'none'}", [100, 0, 37, 130], 20,
                      256, 320, epi, bf, (128, 128), False, False, False))
    for bm, bn in SHAPES:
        cases.append((f"tile_shape_{bm}x{bn}", [70, 17, 0, 140], 9, 160, 200,
                      "bias_silu", bf, (bm, bn), False, False, False))
    rows = [1, 17, 0, 32, 64, 65]
    cases += [
        ("tile_rows_bm128", rows, 0, 512, 256, None, bf, (128, 128), False,
         True, False),
        ("tile_rows_bm64_silu", rows, 0, 512, 256, "silu", bf, (64, 128),
         False, True, False),
        ("tile_k24_relu", [50, 90], 7, 24, 200, "relu", bf, (128, 64), False,
         False, False),
        ("tile_k200_gelu", [50, 0, 80], 3, 200, 136, "gelu", bf, (64, 128),
         False, False, False),
        ("tile_route_c_k100_bias", [60, 85], 5, 100, 160, "bias", bf,
         (128, 64), False, False, False),
        ("tile_nan_past_sum", [40, 0, 90], 30, 256, 192, "silu", bf,
         (128, 128), False, True, True),
        ("tile_nan_past_sum_bm16", [40, 0, 90], 30, 256, 192, "bias", bf,
         (16, 128), False, False, True),
    ]
    for bm in (16, 64):
        cases += [(f"decode_gate_silu_bm{bm}", [32] * 16, 0, d, ff, "silu", bf,
                   (bm, 128), False, False, False),
                  (f"decode_down_bm{bm}", [32] * 16, 0, ff, d, None, bf,
                   (bm, 128), False, False, False)]
    return cases


def _grouped_library(torch, x, w, bias, epi, sizes):
    """(name, forward, name, backward) of the yardsticks: torch.bmm over the
    uniform (E, rows, K) layout the model uses; on a ragged case
    torch._grouped_mm where the card's torch takes these operands, else a
    per-expert torch.matmul loop; the epilogue after it in plain torch.
    The backward takes the fp32 pre-activation cotangent, as the kernel
    does: fp32 products."""
    from repro_torch.kernels.epilogue import apply_epilogue
    e, k, n = w.shape
    total = sum(sizes)
    offs = [0]
    for sz in sizes:
        offs.append(offs[-1] + sz)
    if len(set(sizes)) == 1 and x.shape[0] == total:
        r = sizes[0]
        x3 = x.view(e, r, k)

        def fwd():
            return apply_epilogue(torch.bmm(x3, w), epi,
                                  None if bias is None else bias[:, None])

        def bwd(dy):
            dy3 = dy.view(e, r, n)
            return (torch.bmm(dy3, w.float().transpose(1, 2)),
                    torch.bmm(x3.float().transpose(1, 2), dy3),
                    dy3.sum(1) if bias is not None else None)

        return ("torch.bmm (uniform groups)", fwd,
                "composition: fp32 torch.bmm for dX and dW", bwd)

    def loop_bwd(dy):
        dx = torch.zeros((x.shape[0], k), device=x.device)
        dw = torch.zeros((e, k, n), device=x.device)
        for i in range(e):
            if sizes[i]:
                rows = slice(offs[i], offs[i + 1])
                dx[rows] = dy[rows] @ w[i].float().T
                dw[i] = x[rows].float().T @ dy[rows]
        return dx, dw

    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is not None:
        ends = torch.tensor(offs[1:], dtype=torch.int32, device=x.device)
        rows = torch.repeat_interleave(
            torch.arange(e, device=x.device),
            torch.tensor(sizes, device=x.device))

        def fwd():
            y = grouped_mm(x[:total], w, offs=ends, out_dtype=x.dtype)
            return apply_epilogue(y, epi, None if bias is None else bias[rows])
        try:
            fwd()
            torch.cuda.synchronize()
            return ("torch._grouped_mm", fwd, "composition: per-expert fp32 "
                    "torch.matmul loop", loop_bwd)
        except (RuntimeError, TypeError, ValueError, NotImplementedError):
            pass  # these operands are not ones it takes: the loop below

    def loop_fwd():
        out = torch.zeros((x.shape[0], n), dtype=x.dtype, device=x.device)
        for i in range(e):
            if sizes[i]:
                rows = slice(offs[i], offs[i + 1])
                out[rows] = apply_epilogue(x[rows] @ w[i], epi,
                                           None if bias is None else bias[i])
        return out

    return ("composition: per-expert torch.matmul loop", loop_fwd,
            "composition: per-expert fp32 torch.matmul loop", loop_bwd)


def run_grouped_case(torch, case, gen):
    """grouped_fused over the runtime table, grouped_padded over the padded
    layout and grouped_bwd against their plain versions; an empty expert's
    dW and db must come back exactly zero.  Each forward row names the
    route it took (a main-path row off route A fails); decode rows also
    time the device alone (CUDA graphs), beside the library's.  With NaN
    past sum(group_sizes), grouped_fused must store zeros on those rows and
    finite values on every other; grouped_padded, whose scatter carries
    the NaN rows into the last expert's padding, must give NaN exactly
    where its plain version does."""
    from repro_torch.core import (GroupedGemmDescriptor, GroupedGemmPlan,
                                  plan_grouped)
    from repro_torch.kernels.grouped_gemm import kernel as grk
    from repro_torch.kernels.grouped_gemm.kernel import (
        grouped_bwd, grouped_bwd_plain, grouped_fused, grouped_fused_plain,
        grouped_padded, grouped_padded_plain)
    from repro_torch.kernels.grouped_gemm.ops import plan_groups, scatter_rows
    (label, sizes, extra, k, n, epi, dname, tiles, main_path, bwd,
     nan_tail) = case
    dt = getattr(torch, dname)
    e, total = len(sizes), sum(sizes)
    t = total + extra
    biased = epi is not None and epi.startswith("bias")

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    x, w = rnd(t, k), rnd(e, k, n, scale=k ** -0.5)
    if nan_tail:
        x[total:] = float("nan")
    bias = rnd(e, n) if biased else None
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    desc = GroupedGemmDescriptor(t=t, k=k, n=n, num_experts=e, dtype=dname,
                                 epilogue=epi)
    plan = plan_grouped(desc) if tiles is None else \
        GroupedGemmPlan(desc, tiles[0], 32, tiles[1], fused=True)
    table = plan.tile_schedule().tables(gs)
    offsets, block_expert, nrows = plan_groups(gs, e, plan.bm, plan.t_padded)
    xp, _ = scatter_rows(x, gs, offsets, plan.bm, plan.t_padded)
    kw = dict(bm=plan.bm, bn=plan.bn, epilogue=epi)
    lib_name, lib_fwd, lib_bwd_name, lib_bwd = _grouped_library(
        torch, x, w, bias, epi, sizes)
    # Bound: the rows in groups read once, the touched expert panels read
    # once, every output row written once; 2 x rows x K x N products.
    isz = 2 if dname == "bfloat16" else 4
    panels = sum(1 for sz in sizes if sz) * k * n
    nbytes = isz * (total * k + panels + t * n
                    + (sum(1 for sz in sizes if sz) * n if biased else 0))
    flops = 2 * total * k * n
    op_ms, byte_ms = flops / peak(dname) * 1e3, nbytes / hbm() * 1e3
    lib_ms = time_ms(torch, lib_fwd, 5)
    stage = label.split("_")[0] if main_path else None
    # Decode rows: a few hundred microseconds of weight reads each; the
    # device time of the kernel alone and of the library's call alone.
    decode = label.startswith("decode")
    if decode:
        lib_device_ms = graph_ms(torch, lib_fwd, iters=5)
    base = dict(phase="kernel", case=label, main_path=main_path, stage=stage,
                group_sizes=sizes, rows=t, k=k, n=n, epilogue=epi,
                dtype=dname, blocks=[plan.bm, plan.bk, plan.bn],
                library=lib_name, nan_past_sum=nan_tail)
    rows = []
    for kname, kern, plain in (
            ("grouped_fused", lambda: grouped_fused(table, x, w, bias, **kw),
             lambda: grouped_fused_plain(table, x, w, bias, epilogue=epi)),
            ("grouped_padded",
             lambda: grouped_padded(xp, w, block_expert, nrows, bias, **kw),
             lambda: grouped_padded_plain(xp, w, block_expert, nrows, bias,
                                          bm=plan.bm, epilogue=epi))):
        before = dict(grk.ROUTES)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        routes = {r: grk.ROUTES[r] - before[r] for r in grk.ROUTES
                  if grk.ROUTES[r] != before[r]}
        route = next(iter(routes)) if len(routes) == 1 else routes
        extra_cols = {}
        if nan_tail and kname == "grouped_padded":
            # The NaN rows reach the padded output (and its plain version)
            # only through the scatter: they must agree on where.
            finite = torch.isfinite(want.float())
            if not torch.equal(torch.isfinite(got.float()), finite):
                fail(f"{kname} {label}: NaN where the plain version has "
                     f"none, or the reverse")
            extra_cols["nan_rows"] = int((~finite).any(1).sum().item())
            got, want = got[finite.all(1)], want[finite.all(1)]
        if nan_tail and kname == "grouped_fused" and \
                int(torch.count_nonzero(got[total:])) != 0:
            fail(f"{kname} {label}: rows past sum(group_sizes) are not "
                 f"exactly zero")
        max_abs, rel, nbad, tol = compare(torch, got, want, dname)
        row = dict(base, kernel=kname, route=route, max_abs_err=max_abs,
                   max_rel_err=rel, tolerance=tol, mismatches=nbad,
                   ms=time_ms(torch, kern, 5),
                   plain_ms=time_ms(torch, plain, 2),
                   library_ms=lib_ms, op_ms=op_ms, byte_ms=byte_ms,
                   bound_ms=max(op_ms, byte_ms),
                   bound_by="bytes" if byte_ms >= op_ms else "operations",
                   **extra_cols)
        if decode:
            row.update(device_ms=graph_ms(torch, kern, iters=5),
                       device_library_ms=lib_device_ms)
        emit(**row)
        if nbad:
            fail(f"{kname} {label}: {nbad} elements outside atol=rtol={tol}")
        if main_path and route != "A":
            fail(f"{kname} {label}: a main-path grouped GEMM took route "
                 f"{route}, not A")
        rows.append(row)
    if not bwd:
        return rows
    dy = torch.randn((t, n), generator=gen, device="cuda")
    if nan_tail:
        dy[total:] = float("nan")

    def kern_bwd():
        return grouped_bwd(table, x, dy, w, gs, bm=plan.bm, with_db=biased)

    before = dict(grk.BWD_ROUTES)
    got, again = kern_bwd(), kern_bwd()
    want = grouped_bwd_plain(table, x, dy, w, gs, with_db=biased)
    torch.cuda.synchronize()
    routes = {r: grk.BWD_ROUTES[r] - before[r] for r in grk.BWD_ROUTES
              if grk.BWD_ROUTES[r] != before[r]}
    route = next(iter(routes)) if len(routes) == 1 else routes
    errs = {}
    for name, a, b in zip(("dx", "dw", "db"), got, want):
        if a is None:
            continue
        if not torch.isfinite(a).all():
            fail(f"grouped_bwd {label}: {name} is not finite")
        diff = (a - b).abs()
        errs[name] = (diff.max().item(),
                      int((diff > BWD_TOL + BWD_TOL * b.abs()).sum().item()))
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, again)
                    if a is not None)
    empty = [i for i, sz in enumerate(sizes) if sz == 0]
    empty_zero = all(int(torch.count_nonzero(got[1][i])) == 0 and (
        got[2] is None or int(torch.count_nonzero(got[2][i])) == 0)
        for i in empty)
    tail_zero = int(torch.count_nonzero(got[0][total:])) == 0
    # dx and dw: 4 x rows x K x N products, each with the fp32 cotangent as
    # an operand: on the tensor cores two bf16 products (hi, lo) against
    # bf16 x and w, three (hi hi, hi lo, lo hi) against fp32 ones
    # (fp32_op_ms: the earlier rule, fp32 at the CUDA-core rate); bytes: x,
    # dy, the touched panels in, dx, every dW (empty experts' zeros too)
    # and db out.
    pieces = 2 if dname == "bfloat16" else 3
    b_op_ms = pieces * 2 * flops / peak("bfloat16") * 1e3
    b_bytes = isz * (total * k + panels) + 4 * (
        total * n + t * k + e * k * n + (e * n if biased else 0))
    b_byte_ms = b_bytes / hbm() * 1e3
    row = dict(base, kernel="grouped_bwd", library=lib_bwd_name, route=route,
               max_abs_err=max(v[0] for v in errs.values()),
               errors={k_: v[0] for k_, v in errs.items()},
               tolerance=BWD_TOL, mismatches=sum(v[1] for v in errs.values()),
               rerun_bit_equal=bit_equal, empty_experts=empty,
               empty_expert_dw_db_zero=empty_zero,
               dx_past_sum_zero=tail_zero,
               ms=time_ms(torch, kern_bwd, 5),
               plain_ms=time_ms(torch, lambda: grouped_bwd_plain(
                   table, x, dy, w, gs, with_db=biased), 2),
               library_ms=time_ms(torch, lambda: lib_bwd(dy), 5),
               device_ms=graph_ms(torch, kern_bwd, iters=3),
               device_library_ms=graph_ms(torch, lambda: lib_bwd(dy),
                                          iters=3),
               op_ms=b_op_ms, byte_ms=b_byte_ms,
               fp32_op_ms=2 * flops / peak("float32") * 1e3,
               bound_ms=max(b_op_ms, b_byte_ms),
               bound_by="bytes" if b_byte_ms >= b_op_ms else "operations")
    emit(**row)
    if row["mismatches"]:
        fail(f"grouped_bwd {label}: {row['mismatches']} elements outside "
             f"atol=rtol={BWD_TOL}")
    if not bit_equal:
        fail(f"grouped_bwd {label}: two runs differ")
    if not empty_zero:
        fail(f"grouped_bwd {label}: an empty expert's dW or db is not "
             f"exactly zero")
    if not tail_zero:
        fail(f"grouped_bwd {label}: dX rows past sum(group_sizes) are not "
             f"exactly zero")
    if main_path and route != "A":
        fail(f"grouped_bwd {label}: a main-path backward took route {route}, "
             f"not A")
    rows.append(row)
    return rows


def transpose_cases():
    """(label, (nb, rows, cols), dtype, (row pad, column pad) of a padded
    source view or None, main): the §IV-C panel at fig89's shape and
    Qwen3-0.6B's tied table (the read-out's B, 151,936 x 1,024 bf16, 311 MB
    each way) on route A; off the main path route A at every other element
    size (a ragged fp32 batch read from a view whose padding holds NaN,
    int8, a padded float64 batch) and route B on a bf16 batch read from a
    view padded by 3 columns, whose 1560-byte row stride TMA cannot take."""
    return [("fig89_256x512", (1, 256, 512), "float32", None, True),
            ("qwen3_tied_table", (1, 151936, 1024), "bfloat16", None, True),
            ("ragged_batched_padded", (3, 1000, 777), "float32", (5, 11),
             False),
            ("route_a_int8", (2, 1008, 528), "int8", None, False),
            ("route_a_f64_padded", (2, 998, 130), "float64", (2, 2), False),
            ("route_b_bf16_padded", (2, 999, 777), "bfloat16", (0, 3),
             False)]


def _transpose_source(torch, shape, dname, pad, gen):
    """The case's source: normal draws (integers in [-100, 100) for int8),
    as a view into a buffer padded by ``pad`` rows and columns that holds
    NaN (77 for int8) past the view, where ``pad`` is given."""
    dt = getattr(torch, dname)
    if dt.is_floating_point:
        data = torch.randn(shape, generator=gen, device="cuda").to(dt)
    else:
        data = torch.randint(-100, 100, shape, generator=gen, device="cuda",
                             dtype=dt)
    if pad is None:
        return data
    nb, rows, cols = shape
    base = torch.full((nb, rows + pad[0], cols + pad[1]),
                      float("nan") if dt.is_floating_point else 77,
                      device="cuda", dtype=dt)
    x = base[:, :rows, :cols]
    x.copy_(data)
    return x


def run_transpose_case(torch, case, gen):
    """transpose_tiles at the planned tile edge against its plain version:
    bit-exact, nothing read past the view's extent, on the route
    choose_route names (a main-path row off route A fails); host-timed,
    device (CUDA graph) and L2-cold device times beside the library's,
    ``x.transpose(-2, -1).contiguous()``."""
    from repro_torch.core import TransposeDescriptor, plan_transpose
    from repro_torch.kernels.transpose import kernel as tk
    from repro_torch.kernels.transpose.kernel import (transpose_plain,
                                                      transpose_tiles)
    label, (nb, rows, cols), dname, pad, main_path = case
    x = _transpose_source(torch, (nb, rows, cols), dname, pad, gen)
    bt = plan_transpose(TransposeDescriptor(rows=rows, cols=cols, dtype=dname,
                                            batch=nb)).bt
    before = dict(tk.TRANSPOSE_ROUTES)
    got, want = transpose_tiles(x, bt=bt), transpose_plain(x, bt=bt)
    torch.cuda.synchronize()
    took = [r for r, n in tk.TRANSPOSE_ROUTES.items() if n != before[r]]
    route = took[0] if len(took) == 1 else str(took)
    exact = bool(torch.equal(got, want))
    nan = bool(torch.isnan(got.float()).any())
    max_abs = (got.float() - want.float()).abs().max().item()
    del got, want

    def kern():
        return transpose_tiles(x, bt=bt)

    def library():
        return x.transpose(-2, -1).contiguous()

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    row = dict(phase="kernel", kernel="transpose", case=label,
               main_path=main_path, shape=[nb, rows, cols], dtype=dname,
               tile=bt, padded_view=pad is not None, route=route,
               max_abs_err=max_abs,
               bit_exact=exact, nan_in_output=nan,
               ms=time_ms(torch, kern, 20),
               plain_ms=time_ms(torch, lambda: transpose_plain(x, bt=bt), 3),
               library_ms=time_ms(torch, library, 20),
               device_ms=graph_ms(torch, kern),
               cold_ms=graph_ms(torch, kern, flush=flush),
               device_library_ms=graph_ms(torch, library),
               cold_library_ms=graph_ms(torch, library, flush=flush),
               library="x.transpose(-2, -1).contiguous()",
               # A copy: bytes only (no operations to price in any dtype).
               **bound(2 * nb * rows * cols * x.element_size(), 0, "float32"))
    emit(**row)
    if not exact or nan:
        fail(f"transpose {label}: not bit-exact against its plain version "
             f"(or NaN from outside the view reached the output)")
    if main_path and route != "A":
        fail(f"transpose {label}: a main-path transpose took route {route}, "
             f"not A")
    return [row]


QUANT_COMPUTE = {"int8": "int8", "fp8": "float8_e4m3"}


def gemm_quant_cases():
    """(label, mode, m, n, k, layout, epilogue, A dtype, out dtype, main):
    Qwen3-0.6B's seven projection shapes (q 1024 -> 2048, k / v 1024 ->
    1024, o 2048 -> 1024, gate (silu) and up 1024 -> 3072, down 3072 ->
    1024) at the continuous phase's decode rows (8 slots) and a 256-token
    prefill, under W8A16 (the continuous_quant path: bf16 A, int8 B, bf16
    out), int8 and fp8 (A quantized from bf16; int8 with fp32 outputs, so
    that its exactness shows); then ragged cases: nt with a bias, and
    W8A16 with fp32 activations."""
    d, q, kv, ff = 1024, 2048, 1024, 3072
    shapes = [("q", q, d, None), ("kv", kv, d, None), ("o", d, q, None),
              ("gate_silu", ff, d, "silu"), ("up", ff, d, None),
              ("down", d, ff, None)]
    cases = []
    for mode in ("w8a16", "int8", "fp8"):
        out = "float32" if mode == "int8" else "bfloat16"
        for stage, m in (("decode", CONT_SLOTS), ("prefill", PROMPT)):
            cases += [(f"{mode}_{stage}_{name}", mode, m, n, k, "nn", epi,
                       "bfloat16", out, True) for name, n, k, epi in shapes]
    cases += [
        ("int8_ragged_bias_gelu_nt", "int8", 300, 200, 129, "nt",
         "bias_gelu", "bfloat16", "float32", False),
        ("fp8_ragged_bias_silu_nt", "fp8", 77, 130, 100, "nt", "bias_silu",
         "bfloat16", "bfloat16", False),
        ("w8a16_f32_ragged_relu", "w8a16", 77, 130, 100, "nn", "relu",
         "float32", "float32", False),
    ]
    return cases


def _first_working(torch, candidates):
    """(name, fn) of the first candidate PyTorch call that runs on these
    operands, else (None, None)."""
    for name, fn in candidates:
        try:
            fn()
            torch.cuda.synchronize()
            return name, fn
        except (RuntimeError, TypeError, ValueError, NotImplementedError):
            continue
    return None, None


def _quant_gemm_library(torch, mode, a, aq, bq, sa, sb, epi, bias, layout,
                        out_dt):
    """One PyTorch call for the same function: ``torch._int_mm`` plus the
    dequant epilogue (int8), ``torch._scaled_mm`` with row and column
    scales (e4m3), ``torch.matmul`` on the bf16-cast weight times ``sb``
    (W8A16).  ``_int_mm`` and ``_scaled_mm`` take at least 17 and 16 rows:
    a decode A is zero-padded to 32 rows (the name says so)."""
    from repro_torch.kernels.epilogue import apply_epilogue
    m = a.shape[0]
    b_kn = bq if layout == "nn" else bq.t()
    if mode == "w8a16":
        bw = b_kn.to(a.dtype).contiguous()

        def w8a16():
            return apply_epilogue(torch.matmul(a, bw).float(), epi, bias,
                                  sb[None, :]).to(out_dt)
        return _first_working(torch, [(
            "torch.matmul on the cast weight x sb + epilogue", w8a16)])
    rows = m if m > 16 else 32
    # padded through an int8 view: zero bytes are +0 in e4m3 too
    a_p = aq if rows == m else torch.cat(
        [aq.view(torch.int8), torch.zeros((rows - m, aq.shape[1]),
                                          dtype=torch.int8, device=a.device)]
    ).view(aq.dtype)
    sa_p = sa if rows == m else torch.cat([sa, sa.new_ones(rows - m)])
    pad = "" if rows == m else f" (A padded to {rows} rows)"
    b_col = b_kn.t().contiguous().t()  # column-major (k, n)
    if mode == "int8":
        factor = sa[:, None] * sb[None, :]

        def int_mm(b):
            return lambda: apply_epilogue(
                torch._int_mm(a_p, b)[:m], epi, bias, factor).to(out_dt)
        return _first_working(torch, [
            (f"torch._int_mm{pad} + dequant epilogue", int_mm(b_kn.contiguous())),
            (f"torch._int_mm{pad} (column-major B) + dequant epilogue",
             int_mm(b_col))])

    def scaled(rowwise):
        if rowwise:
            kw = dict(scale_a=sa_p[:, None].contiguous(),
                      scale_b=sb[None, :].contiguous())
            after = None
        else:
            one = torch.ones((), device=a.device)
            kw = dict(scale_a=one, scale_b=one)
            after = sa[:, None] * sb[None, :]

        def run():
            y = torch._scaled_mm(a_p, b_col, out_dtype=torch.bfloat16,
                                 **kw)[:m].float()
            return apply_epilogue(y, epi, bias, after).to(out_dt)
        return run
    return _first_working(torch, [
        (f"torch._scaled_mm{pad}, row / column scales + epilogue",
         scaled(True)),
        (f"torch._scaled_mm{pad}, scales in the epilogue", scaled(False))])


def run_gemm_quant_case(torch, case, gen):
    """gemm_quant over the plan's tile table against its plain version on
    the same quantized operands."""
    from repro_torch.core import GemmDescriptor, plan_gemm, resolve_quant
    from repro_torch.kernels.gemm import kernel as gk
    from repro_torch.kernels.gemm.kernel import (FusedGemm, gemm_quant,
                                                 gemm_quant_plain)
    from repro_torch.optim.compression import quantize_operand
    label, mode, m, n, k, layout, epi, adt, odt, main_path = case
    spec = resolve_quant(mode)
    a = torch.randn((m, k), generator=gen, device="cuda").to(
        getattr(torch, adt))
    b = torch.randn((k, n) if layout == "nn" else (n, k), generator=gen,
                    device="cuda") * k ** -0.5
    bias = torch.randn((n,), generator=gen, device="cuda") \
        if epi and epi.startswith("bias") else None
    bq, sb = quantize_operand(b, spec, axis=1 if layout == "nn" else 0)
    aq, sa = (a, None) if spec.weight_only else \
        quantize_operand(a, spec, axis=0)
    out_dt = getattr(torch, odt)
    desc = GemmDescriptor(m=m, n=n, k=k, layout=layout, in_dtype=str(
        aq.dtype).replace("torch.", "").replace("float8_e4m3fn",
                                                "float8_e4m3"),
        out_dtype=odt, epilogue=epi, quant=spec)
    plan = plan_gemm(desc)
    if not plan.fused:
        fail(f"gemm_quant {label}: the H100 plan is not fused")
    exe = FusedGemm(plan.tile_schedule(), "cuda")
    kw = dict(layout=layout, epilogue=epi, bias=bias, out_dtype=out_dt)

    def kern():
        return gemm_quant(exe, aq, bq, sa, sb, **kw)

    def plain():
        return gemm_quant_plain(aq, bq, sa, sb, **kw)

    before = dict(gk.QUANT_ROUTES)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    route = _route_taken(gk.QUANT_ROUTES, before)
    split = gk.split_factor(exe.schedule.num_tiles, k,
                            gk.sm_count(a.device), route)
    tol = QUANT_I8_TOL if mode == "int8" else TOL[odt]
    max_abs, rel, nbad, tol = compare(torch, got, want, odt, tol)
    lib_name, lib = _quant_gemm_library(torch, mode, a, aq, bq, sa, sb, epi,
                                        bias, layout, out_dt)
    compute = QUANT_COMPUTE.get(mode, adt)
    nbytes = (m * k * aq.element_size() + k * n + 4 * n
              + (4 * m if sa is not None else 0) + m * n * got.element_size()
              + (4 * n if bias is not None else 0))
    stage = "decode" if m <= COLD_M else "prefill"
    row = dict(phase="kernel", kernel="gemm_quant", case=label,
               main_path=main_path, stage=stage, mode=mode, shape=[m, n, k],
               layout=layout, epilogue=epi, a_dtype=adt, out_dtype=odt,
               blocks=[[r.bm, r.bn] for r in plan.regions], route=route,
               split=split, tiles=exe.schedule.num_tiles,
               max_abs_err=max_abs, max_rel_err=rel, tolerance=tol,
               mismatches=nbad, ms=time_ms(torch, kern, 20),
               plain_ms=time_ms(torch, plain, 2),
               library_ms=time_ms(torch, lib, 20) if lib else None,
               library=lib_name or "none runs on these operands",
               **bound(nbytes, 2 * m * n * k, compute))
    if stage == "decode" and lib:
        row.update(_device_and_cold(torch, kern, lib))
    emit(**row)
    if nbad:
        fail(f"gemm_quant {label}: {nbad} elements outside atol=rtol={tol}")
    if main_path and route not in ("A", "B"):
        fail(f"gemm_quant {label}: a main-path row took route {route}, "
             f"not A or B")
    return [row]


def _route_taken(routes, before):
    """The one route a single launch added to a route count
    (``QUANT_ROUTES``, ``DECODE_ROUTES``)."""
    taken = [r for r in routes if routes[r] != before[r]]
    if len(taken) != 1:
        fail(f"expected one counted route, got {taken}")
    return taken[0]


def _device_and_cold(torch, kern, lib):
    """Device milliseconds of the kernel and of the library's call, warm
    (CUDA graphs, no host launch time) and after an L2 flush (operands out
    of L2, as a decode step finds a layer's weights)."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    return dict(device_ms=graph_ms(torch, kern),
                cold_ms=graph_ms(torch, kern, flush=flush),
                device_library_ms=graph_ms(torch, lib),
                cold_library_ms=graph_ms(torch, lib, flush=flush))


def run_decode_int8_case(torch, gen):
    """flash_decode's KV-int8 branch at the continuous phase's pool (8
    slots, 16 / 8 heads of 128, 96 pages of 16, 24 blocks) over ragged
    lengths, one slot empty, pools quantized per token as a decode step
    writes them; the library is SDPA over the gathered pages, dequantized
    outside the timed region."""
    import torch.nn.functional as F
    from repro_torch.core import DecodeTileSchedule
    from repro_torch.kernels.flash_attention.kernel import (
        FlashDecode, flash_decode, flash_decode_plain)
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models.attention import quantize_kv_rows
    S, P, B, h, hkv, hd = (CONT_SLOTS, CONT_PAGE, CONT_BLOCKS, 16, 8, 128)
    lengths = (0, 1, 16, 17, 300, 255, 100, 33)
    q = torch.randn((S, h, hd), generator=gen, device="cuda").bfloat16()
    (kq, ks), (vq, vs) = (quantize_kv_rows(torch.randn(
        (CONT_PAGES, P, hkv, hd), generator=gen, device="cuda").bfloat16())
        for _ in range(2))
    perm = torch.randperm(CONT_PAGES, generator=torch.Generator()
                          .manual_seed(3))
    bt = torch.zeros((S, B), dtype=torch.int32)
    used = 0
    for slot, npages in enumerate(-(-L // P) for L in lengths):
        bt[slot, :npages] = perm[used:used + npages]
        used += npages
    bt, lens = bt.cuda(), torch.tensor(lengths, dtype=torch.int32,
                                       device="cuda")
    exe = FlashDecode(DecodeTileSchedule(num_seqs=S, pages=CONT_PAGES,
                                         page_size=P, max_blocks=B), "cuda")
    exe.update(bt, lens)

    def kern():
        return flash_decode(exe, q, kq, vq, ks, vs)

    def plain():
        return flash_decode_plain(exe, q, kq, vq, ks, vs)

    before = dict(fk.DECODE_ROUTES)
    got = kern()
    route = _route_taken(fk.DECODE_ROUTES, before)
    want = plain()
    torch.cuda.synchronize()
    max_abs, rel, nbad, tol = compare(torch, got, want, "bfloat16")
    if got[0].abs().max().item() != 0:
        fail("flash_decode_int8: the empty slot did not drain zeros")
    span = torch.arange(B * P, device="cuda")
    gk, gv = ((t[bt.long()].float() * s[bt.long()][..., None, None])
              .bfloat16().reshape(S, B * P, hkv, hd).transpose(1, 2)
              .repeat_interleave(h // hkv, dim=1).contiguous()
              for t, s in ((kq, ks), (vq, vs)))
    mask = (span[None, :] < lens[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    live_pages = sum(-(-L // P) for L in lengths)
    nbytes = (2 * sum(lengths) * (hkv * hd + 4) + 2 * 2 * S * h * hd
              + 4 * (live_pages + S))

    def library():
        return F.scaled_dot_product_attention(q4, gk, gv, attn_mask=mask)

    row = dict(phase="kernel", kernel="flash_decode_int8", case="serve_ragged",
               main_path=True, shape=[S, h, hkv, hd, P], lengths=list(lengths),
               dtype="bfloat16", kv_dtype="int8", max_abs_err=max_abs,
               max_rel_err=rel, tolerance=tol, mismatches=nbad,
               differ_frac=(got != want).float().mean().item(), route=route,
               ms=time_ms(torch, kern, 50), plain_ms=time_ms(torch, plain, 2),
               library_ms=time_ms(torch, library, 50),
               **_device_and_cold(torch, kern, library),
               library="SDPA over the gathered pages, dequantized outside "
                       "the timed region",
               **bound(nbytes, 4 * h * hd * sum(lengths), "bfloat16"))
    emit(**row)
    if nbad:
        fail(f"flash_decode_int8: {nbad} elements outside atol=rtol={tol}")
    _check_decode_route("flash_decode_int8", "serve_ragged", route,
                        "bfloat16")
    return [row]


def grouped_quant_cases():
    """(label, mode, group sizes, rows past their sum, K, N, epilogue, x
    dtype, out dtype, main): phi3.5-moe-42b's four expert GEMMs under
    use(quant="int8") (16 groups of 256 capacity rows at prefill, of 32 at
    decode; up / gate 4096 -> 6400, down the reverse), with fp32 outputs so
    that the int8 path's exactness shows; then ragged cases through the
    e4m3 and W8A16 routes with an empty expert."""
    d, ff = 4096, 6400
    return [
        ("prefill_gate_silu", "int8", [256] * 16, 0, d, ff, "silu",
         "bfloat16", "float32", True),
        ("prefill_down", "int8", [256] * 16, 0, ff, d, None, "bfloat16",
         "float32", True),
        ("decode_gate_silu", "int8", [32] * 16, 0, d, ff, "silu", "bfloat16",
         "float32", True),
        ("decode_down", "int8", [32] * 16, 0, ff, d, None, "bfloat16",
         "float32", True),
        ("ragged_fp8_bias_silu", "fp8", [37, 0, 201, 70], 4, 100, 70,
         "bias_silu", "bfloat16", "bfloat16", False),
        ("ragged_w8a16_f32_gelu", "w8a16", [13, 0, 40, 7], 5, 129, 200,
         "gelu", "float32", "float32", False),
    ]


def run_grouped_quant_case(torch, case, gen):
    """grouped_quant over the runtime table against its plain version on
    the same quantized operands; the library is grouped_fused's yardstick
    (torch.bmm over the uniform layout, else a per-expert loop) on the
    dequantized operands."""
    from repro_torch.core import (GroupedGemmDescriptor, plan_grouped,
                                  resolve_quant)
    from repro_torch.kernels.grouped_gemm import kernel as grk
    from repro_torch.kernels.grouped_gemm.kernel import (grouped_quant,
                                                         grouped_quant_plain)
    from repro_torch.kernels.grouped_gemm.ops import _quantize_grouped_w
    from repro_torch.optim.compression import quantize_operand
    label, mode, sizes, extra, k, n, epi, xdt, odt, main_path = case
    spec = resolve_quant(mode)
    e, total = len(sizes), sum(sizes)
    t = total + extra
    biased = epi is not None and epi.startswith("bias")
    x = torch.randn((t, k), generator=gen, device="cuda").to(
        getattr(torch, xdt))
    w = torch.randn((e, k, n), generator=gen, device="cuda") * k ** -0.5
    bias = torch.randn((e, n), generator=gen, device="cuda") if biased \
        else None
    wq, sw = _quantize_grouped_w(w, spec)
    xq, sx = (x, None) if spec.weight_only else \
        quantize_operand(x, spec, axis=0)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    desc = GroupedGemmDescriptor(t=t, k=k, n=n, num_experts=e, dtype=xdt,
                                 epilogue=epi, quant=spec)
    plan = plan_grouped(desc)
    if not plan.fused:
        fail(f"grouped_quant {label}: the H100 plan is not fused")
    table = plan.tile_schedule().tables(gs)
    out_dt = getattr(torch, odt)

    def kern():
        return grouped_quant(table, xq, wq, sx, sw, bias, bm=plan.bm,
                             bn=plan.bn, epilogue=epi, out_dtype=out_dt)

    def plain():
        return grouped_quant_plain(table, xq, wq, sx, sw, bias, epilogue=epi,
                                   out_dtype=out_dt)

    before = dict(grk.QUANT_ROUTES)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    route = _route_taken(grk.QUANT_ROUTES, before)
    tol = QUANT_I8_TOL if mode == "int8" else TOL[odt]
    max_abs, rel, nbad, tol = compare(torch, got, want, odt, tol)
    x_deq = x if sx is None else (xq.float() * sx[:, None]).to(x.dtype)
    w_deq = (wq.float() * sw[:, None, :]).to(x.dtype)
    lib_name, lib_fwd, _, _ = _grouped_library(
        torch, x_deq, w_deq, None if bias is None else bias.to(x.dtype), epi,
        sizes)
    touched = sum(1 for sz in sizes if sz)
    nbytes = (total * k * xq.element_size() + touched * (k * n + 4 * n)
              + (4 * total if sx is not None else 0)
              + t * n * got.element_size() + (4 * touched * n if biased
                                              else 0))
    stage = label.split("_")[0] if main_path else None
    row = dict(phase="kernel", kernel="grouped_quant", case=label,
               main_path=main_path, stage=stage, mode=mode,
               group_sizes=sizes, rows=t, k=k, n=n, epilogue=epi,
               x_dtype=xdt, out_dtype=odt,
               blocks=[plan.bm, plan.bk, plan.bn], route=route,
               max_abs_err=max_abs, max_rel_err=rel, tolerance=tol,
               mismatches=nbad, ms=time_ms(torch, kern, 5),
               plain_ms=time_ms(torch, plain, 2),
               library_ms=time_ms(torch, lib_fwd, 5),
               library=lib_name + " on the dequantized operands",
               **bound(nbytes, 2 * total * k * n,
                       QUANT_COMPUTE.get(mode, xdt)))
    if stage == "decode":
        row.update(_device_and_cold(torch, kern, lib_fwd))
    emit(**row)
    if nbad:
        fail(f"grouped_quant {label}: {nbad} elements outside atol=rtol="
             f"{tol}")
    if main_path and route not in ("A", "B"):
        fail(f"grouped_quant {label}: a main-path row took route {route}, "
             f"not A or B")
    return [row]


def phase_kernels(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for case in gemm_cases():
        rows += run_gemm_case(torch, case, gen)
    for case in gemm_act_bwd_cases():
        rows += run_gemm_act_bwd_case(torch, case, gen)
    for case in flash_cases():
        rows += run_flash_case(torch, case, gen)
    for case in flash_bwd_cases():
        rows += run_flash_bwd_case(torch, case, gen)
    for case in decode_cases():
        rows += run_decode_case(torch, case, gen)
    for case in ssd_cases():
        rows += run_ssd_case(torch, case, gen)
    for case in grouped_cases():
        rows += run_grouped_case(torch, case, gen)
    for case in transpose_cases():
        rows += run_transpose_case(torch, case, gen)
    for case in gemm_quant_cases():
        rows += run_gemm_quant_case(torch, case, gen)
    rows += run_decode_int8_case(torch, gen)
    for case in grouped_quant_cases():
        rows += run_grouped_quant_case(torch, case, gen)
    return rows


# ---------------------------------------------------------------------------
# Phases 4-6: the model through generate
# ---------------------------------------------------------------------------

def _kernel_modules():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.gemm import kernel as gk
    from repro_torch.kernels.grouped_gemm import kernel as grk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.kernels.transpose import kernel as tk
    return gk, fk, sk, grk, tk


def _reset_counts():
    from repro_torch.core import engine
    engine.reset_stats(entries=False)
    for mod in _kernel_modules():
        mod.reset_launches()


def _read_counts():
    from repro_torch.core import engine
    st = engine.stats()
    launches = {}
    for mod in _kernel_modules():
        launches.update(mod.LAUNCHES)
    gk, fk, sk, grk, tk = _kernel_modules()
    launches.update({f"gemm_route_{r}": n for r, n in gk.ROUTES.items()})
    launches.update({f"grouped_route_{r}": n for r, n in grk.ROUTES.items()})
    launches.update({f"grouped_bwd_route_{r}": n
                     for r, n in grk.BWD_ROUTES.items()})
    launches.update({f"flash_route_{r}": n for r, n in fk.ROUTES.items()})
    launches.update({f"flash_bwd_route_{r}": n
                     for r, n in fk.BWD_ROUTES.items()})
    launches.update({f"gemm_quant_route_{r}": n
                     for r, n in gk.QUANT_ROUTES.items()})
    launches.update({f"grouped_quant_route_{r}": n
                     for r, n in grk.QUANT_ROUTES.items()})
    launches.update({f"decode_route_{r}": n
                     for r, n in fk.DECODE_ROUTES.items()})
    launches.update({f"ssd_fwd_route_{r}": n
                     for r, n in sk.SSD_FWD_ROUTES.items()})
    launches.update({f"ssd_bwd_route_{r}": n
                     for r, n in sk.SSD_BWD_ROUTES.items()})
    launches.update({f"transpose_route_{r}": n
                     for r, n in tk.TRANSPOSE_ROUTES.items()})
    return {**launches,
            "engine_transpose_launches": st.get("transpose", {})
            .get("launches", 0),
            "engine_grouped_launches": st.get("grouped_gemm", {})
            .get("launches", 0),
            "engine_grouped_launches_bwd": st.get("grouped_gemm", {})
            .get("launches_bwd", 0),
            "engine_ssd_launches": st.get("ssd_chunk", {}).get("launches", 0),
            "engine_ssd_launches_bwd": st.get("ssd_chunk", {})
            .get("launches_bwd", 0),
            "engine_gemm_launches": st.get("gemm", {}).get("launches", 0),
            "engine_gemm_launches_bwd": st.get("gemm", {})
            .get("launches_bwd", 0),
            "engine_gemm_calls": st.get("gemm", {}).get("plan_hits", 0)
            + st.get("gemm", {}).get("plan_misses", 0),
            "engine_flash_launches": st.get("flash_attention", {})
            .get("launches", 0),
            "engine_flash_launches_bwd": st.get("flash_attention", {})
            .get("launches_bwd", 0),
            "engine_decode_launches": st.get("flash_decode", {})
            .get("launches", 0),
            "engine_plan_misses": sum(v for row in st.values()
                                      for k, v in row.items()
                                      if k.startswith("plan_misses"))}


def _gemm_launch_gap(counts):
    """A GEMM run's kernel launches against the engine's count of them."""
    bad = {}
    if counts["gemm_fused"] + counts["gemm_region"] != \
            counts["engine_gemm_launches"]:
        bad["gemm kernels vs engine"] = (
            counts["gemm_fused"] + counts["gemm_region"],
            counts["engine_gemm_launches"])
    if counts["gemm_act_bwd"] != counts["engine_gemm_launches_bwd"]:
        bad["gemm_act_bwd vs engine"] = (counts["gemm_act_bwd"],
                                         counts["engine_gemm_launches_bwd"])
    return bad


def _add_counts(*parts):
    """Launch counts summed key by key."""
    total = {}
    for counts in parts:
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total


def _prompts(torch, vocab):
    gen = torch.Generator(device="cuda").manual_seed(1)
    return torch.randint(0, vocab, (BATCH, PROMPT), generator=gen,
                         device="cuda")


def _prefill_logits(torch, model, prompts):
    from repro_torch.runtime.steps import make_prefill_step
    logits, _ = make_prefill_step(model, PROMPT + GEN)({"tokens": prompts})
    torch.cuda.synchronize()
    return logits.float()


def _logit_gap(torch, got, ref):
    if not torch.isfinite(got).all() or not torch.isfinite(ref).all():
        fail("non-finite logits")
    spread = (ref.max() - ref.min()).item()
    gap = (got - ref).abs().max().item()
    return gap, spread, gap / spread


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    from repro_torch.models import LanguageModel
    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(torch, cfg.vocab_size)
    with use(backend="engine", fused="auto", device="cuda"):
        generate(model, prompts, 2)  # warm: plans, tile tables
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        res = generate(model, prompts, GEN)
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        logits = _prefill_logits(torch, model, prompts)
    toks = res["tokens"]
    if tuple(toks.shape) != (BATCH, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"bad tokens {tuple(toks.shape)}")
    forwards = GEN  # one prefill + GEN - 1 decode steps
    want_gemm = forwards * (7 * cfg.num_layers + 1)
    want_flash = cfg.num_layers
    if counts["engine_gemm_calls"] != want_gemm:
        fail(f"GEMM calls {counts['engine_gemm_calls']} != {want_gemm}")
    if counts["gemm_fused"] + counts["gemm_region"] != \
            counts["engine_gemm_launches"]:
        fail(f"GEMM kernel launches disagree with the engine: {counts}")
    if counts["gemm_fused"] + counts["gemm_region"] < want_gemm:
        fail(f"projections did not all run the GEMM kernels: {counts}")
    if counts["flash_fwd_fused"] + counts["flash_fwd_dense"] != want_flash \
            or counts["engine_flash_launches"] != want_flash:
        fail(f"prefill attention did not run flash once per layer: {counts}")
    with use(backend="torch", device="cuda"):
        ref = _prefill_logits(torch, model, prompts)
    gap, spread, rel = _logit_gap(torch, logits, ref)
    emit(phase="serve", model=cfg.name, params=cfg.param_count(),
         batch=BATCH, prompt=PROMPT, new_tokens=GEN, fused="auto",
         init_seconds=init_s, prefill_seconds=res["prefill_seconds"],
         prefill_tokens_per_s=BATCH * PROMPT / res["prefill_seconds"],
         decode_seconds=res["decode_seconds"],
         decode_tokens_per_s=BATCH * (GEN - 1) / res["decode_seconds"],
         peak_memory_bytes=peak, launches=counts,
         expected_gemm_calls=want_gemm, expected_flash_calls=want_flash,
         logits_vs_torch_max_abs=gap, logits_spread=spread,
         logits_rel=rel, logits_bound=LOGIT_BOUND)
    if rel > LOGIT_BOUND:
        fail(f"engine vs torch prefill logits differ by {rel:.4f} of their "
             f"range (bound {LOGIT_BOUND})")
    return counts, model, prompts, logits


def phase_serve_off(torch, model, prompts, logits_auto):
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    cfg = model.cfg
    steps = 4
    with use(backend="engine", fused="off", device="cuda"):
        _reset_counts()
        res = generate(model, prompts, steps)
        counts = _read_counts()
        logits = _prefill_logits(torch, model, prompts)
    want_flash = cfg.num_layers
    if counts["gemm_fused"] or counts["flash_fwd_fused"]:
        fail(f"fused kernels ran under fused='off': {counts}")
    if counts["gemm_region"] != counts["engine_gemm_launches"] or \
            counts["engine_gemm_calls"] != steps * (7 * cfg.num_layers + 1):
        fail(f"region GEMM launches disagree: {counts}")
    if counts["flash_fwd_dense"] != want_flash:
        fail(f"dense flash launches {counts['flash_fwd_dense']} != {want_flash}")
    gap, spread, rel = _logit_gap(torch, logits, logits_auto)
    emit(phase="serve_off", fused="off", new_tokens=steps,
         prefill_seconds=res["prefill_seconds"],
         decode_seconds=res["decode_seconds"], launches=counts,
         logits_vs_auto_max_abs=gap, logits_rel=rel,
         logits_bound=LOGIT_BOUND)
    if rel > LOGIT_BOUND:
        fail(f"fused='off' logits differ from fused='auto' by {rel:.4f}")
    return counts


def _device_profile(torch, fn, steps: int):
    """``fn()`` run ``steps`` times under torch.profiler: wall time against
    device time per step, the kernels that take it, and every kernel of
    the port's own sources (``port``, whatever its rank)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []  # device-side events only: the kernels themselves
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / steps
    return dict(wall_ms_per_step=wall * 1e3 / steps,
                device_ms_per_step=device_ms if rows else "not measured",
                device_busy_share=device_ms / (wall * 1e3 / steps) if rows
                else "not measured",
                top=[[name[:80], us / 1e3 / steps, n // steps]
                     for us, name, n in rows[:12]],
                port=[[name[:80], us / 1e3 / steps, n // steps]
                      for us, name, n in rows
                      if name.startswith(("void (anonymous namespace)::",
                                          "(anonymous namespace)::"))])


def phase_profile(torch, model, prompts, steps: int = 2, name="profile"):
    from repro_torch.core import use
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step
    with use(backend="engine", fused="auto", device="cuda"), torch.no_grad():
        logits, cache = make_prefill_step(model, PROMPT + GEN)(
            {"tokens": prompts})
        tok = torch.argmax(logits, -1)[:, None]
        state = {"cache": cache,
                 "pos": torch.tensor(PROMPT, dtype=torch.int32,
                                     device="cuda")}
        serve = make_serve_step(model)

        def step():
            _, state["cache"], state["pos"] = serve(state["cache"], tok,
                                                    state["pos"])

        step()  # warm
        emit(phase=name, decode_steps=steps,
             **_device_profile(torch, step, steps))


def phase_prefill_profile(torch, model, prompts):
    """One full-width Qwen3 prefill (batch 4 x 256, fused="auto") under
    torch.profiler: where prefill time goes, wall against device."""
    from repro_torch.core import use
    from repro_torch.runtime.steps import make_prefill_step
    with use(backend="engine", fused="auto", device="cuda"), torch.no_grad():
        prefill = make_prefill_step(model, PROMPT + GEN)

        def step():
            prefill({"tokens": prompts})

        step()  # warm
        emit(phase="prefill_profile", batch=BATCH, prompt=PROMPT,
             **_device_profile(torch, step, 1))


def phase_continuous(torch, model):
    """Full-width continuous batching through ``run_continuous``, counted
    alone, with its gates; then the static-path oracle outside the
    counted window, one decode step's logits against the static dense
    path, and a profile."""
    from repro_torch.core import use
    from repro_torch.launch.serve import run_continuous, static_oracle
    cfg = model.cfg
    L = cfg.num_layers
    with use(backend="engine", fused="auto", device="cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = run_continuous(model, num_slots=CONT_SLOTS,
                             num_pages=CONT_PAGES, page_size=CONT_PAGE,
                             max_blocks=CONT_BLOCKS, check=False,
                             **CONT_TRACE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        oracle = static_oracle(model, res["trace"], res["outputs"])
        oracle_s = time.perf_counter() - t0
    m, reqs, pool = res["metrics"], res["trace"], res["pool"]
    steps = m["decode_steps"]
    # One prefill per admission (re-admissions replay their context), one
    # forward per decode step: 7 projections per layer and the LM head
    # each, flash forward once per layer per prefill, flash_decode once
    # per layer per step.
    admissions = len(reqs) + m["evictions"]
    want = {
        "flash_decode": steps * L, "engine_decode_launches": steps * L,
        "engine_gemm_calls": (admissions + steps) * (7 * L + 1),
        "flash_fwd_fused": admissions * L,
        "engine_flash_launches": admissions * L,
    }
    emit(phase="continuous", model=cfg.name, slots=CONT_SLOTS,
         num_pages=CONT_PAGES, page_size=CONT_PAGE, max_blocks=CONT_BLOCKS,
         trace=CONT_TRACE,
         prompt_lens=[len(r.prompt) for r in reqs],
         max_new=[r.max_new for r in reqs],
         tokens_per_s=m["tokens_per_s"], total_tokens=m["total_tokens"],
         p50_token_latency_s=m["p50_token_latency_s"],
         p99_token_latency_s=m["p99_token_latency_s"],
         phase_seconds=m["phase_seconds"], decode_steps=steps,
         evictions=m["evictions"], evicted=res["evictions"],
         run_seconds=m["wall_seconds"], wall_seconds=wall,
         oracle_seconds=oracle_s,
         peak_memory_bytes=peak, flash_decode_launches=
         m["flash_decode_launches"], launches=counts, expected=want,
         identical_requests=oracle["identical_requests"],
         requests=len(reqs))
    for r in reqs:
        out = res["outputs"].get(r.rid)
        if out is None or len(out) != r.max_new or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            fail(f"request {r.rid} did not finish with {r.max_new} in-vocab "
                 f"tokens: {out}")
    if m["evictions"] < 1:
        fail("the continuous trace evicted nothing")
    pool.check_invariants([0] * CONT_SLOTS)
    if pool.free_pages != CONT_PAGES:
        fail(f"{CONT_PAGES - pool.free_pages} pages still owned at the end")
    if m["flash_decode_launches"] != steps * L:
        fail(f"flash_decode launches {m['flash_decode_launches']} != "
             f"{steps} steps x {L} layers")
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if bad:
        fail(f"continuous launch counts (got, want): {bad}")
    if counts["gemm_fused"] + counts["gemm_region"] != \
            counts["engine_gemm_launches"] or counts["flash_fwd_dense"]:
        fail(f"GEMM / flash kernel launches disagree with the engine: "
             f"{counts}")
    if counts["gemm_fused"] + counts["gemm_region"] < \
            want["engine_gemm_calls"]:
        fail(f"projections did not all run the GEMM kernels: {counts}")
    _continuous_logits(torch, model, reqs)
    return counts, res


def _continuous_logits(torch, model, reqs, name="continuous",
                       blocks=CONT_BLOCKS, moe=False, state_check=False):
    """Prefill the first 8 requests into the slots of a paged pool, and
    hold the first decode step's paged logits of every slot against the
    static dense path's on the same context (``generate``'s prefill and
    first dense-cache decode step).  With ``moe`` the paged step replays
    the dense steps' routing (each slot's token is its own routing group
    in both, so only the kernels' rounding can flip a choice), and the
    free-routing gap is printed beside it.  With ``state_check`` one
    all-inactive paged step must leave every layer's local ring and
    recurrent or SSM state bit-equal.  Then profile two paged decode steps
    over the 8 slots."""
    from repro_torch.core import use
    from repro_torch.models.attention import PageSpec
    from repro_torch.runtime.pages import (PagePool, init_serving_cache,
                                           refresh_tables, write_prefill)
    from repro_torch.runtime.steps import (make_paged_serve_step,
                                           make_prefill_step, make_serve_step)
    spec = PageSpec(CONT_SLOTS * blocks, CONT_PAGE, blocks)
    with use(backend="engine", fused="auto", device="cuda"), torch.no_grad():
        pool = PagePool(spec, CONT_SLOTS)
        cache = init_serving_cache(model, CONT_SLOTS, spec)
        toks, dense, routes = [], [], []
        for slot, r in enumerate(reqs[:CONT_SLOTS]):
            L = len(r.prompt)
            prompt = torch.from_numpy(r.prompt).long().cuda()[None]
            logits, dcache = make_prefill_step(model, L + 1)(
                {"tokens": prompt})
            tok = torch.argmax(logits, -1)[:, None]
            rec = []
            with _routing("record" if moe else None, rec):
                step, _, _ = make_serve_step(model)(
                    dcache, tok, torch.tensor(L, dtype=torch.int32,
                                              device="cuda"))
            routes.append(rec)
            dense.append(step[0].float())
            ids = pool.grow(slot, L)
            _, pcache = make_prefill_step(model, L)({"tokens": prompt})
            write_prefill(cache, pcache, slot=slot, length=L, page_ids=ids,
                          page_size=CONT_PAGE)
            pool.grow(slot, L + 3)  # room for three decode steps
            toks.append(tok[0])
        refresh_tables(cache, pool.tables)
        tokens = torch.stack(toks)
        lengths = torch.tensor([len(r.prompt) for r in reqs[:CONT_SLOTS]],
                               device="cuda")
        active = torch.ones(CONT_SLOTS, dtype=torch.bool, device="cuda")
        positions = lengths.to(torch.int32)[:, None]
        replay = [torch.cat([rec[i] for rec in routes])
                  for i in range(len(routes[0]))]
        with _routing("replay" if moe else None, replay):
            paged, _, _ = model.apply(tokens, positions=positions,
                                      cache=cache)
        gaps = [_logit_gap(torch, paged[slot, -1].float(), dense[slot])[2]
                for slot in range(CONT_SLOTS)]
        extra = {}
        if moe:
            free, _, _ = model.apply(tokens, positions=positions,
                                     cache=cache)
            extra["rel_gaps_free_routing"] = [
                _logit_gap(torch, free[slot, -1].float(), dense[slot])[2]
                for slot in range(CONT_SLOTS)]
        step_fn = make_paged_serve_step(model)
        if state_check:
            before = [tuple(t.clone() for t in _state_tensors(c))
                      for c in cache if _state_tensors(c)]
            _, idle, _ = step_fn(cache, tokens, lengths,
                                 torch.zeros_like(active))
            after = [_state_tensors(c) for c in idle if _state_tensors(c)]
            # (a bf16 conv tail comes back promoted to the activations'
            # dtype, as jnp.where promotes it: compared in its own dtype)
            extra["inactive_state_bit_equal"] = all(
                torch.equal(a, b.to(a.dtype))
                for pair_a, pair_b in zip(before, after)
                for a, b in zip(pair_a, pair_b))
            extra["state_layers"] = len(before)
        emit(phase=f"{name}_logits", slots=CONT_SLOTS, rel_gaps=gaps,
             bound=LOGIT_BOUND, **({"routing": "the dense steps' replayed"}
                                   if moe else {}), **extra)
        if max(gaps) > LOGIT_BOUND:
            fail(f"{name}: paged vs dense decode logits differ by "
                 f"{max(gaps):.4f} of their range (bound {LOGIT_BOUND})")
        if state_check and not (extra["state_layers"]
                                and extra["inactive_state_bit_equal"]):
            fail(f"{name}: an all-inactive paged step changed ring or state "
                 f"rows ({extra['state_layers']} state layers)")
        state = {"tokens": torch.argmax(paged[:, -1], -1)[:, None],
                 "lengths": lengths + 1}

        def step():
            state["tokens"], _, state["lengths"] = step_fn(
                cache, state["tokens"], state["lengths"], active)

        emit(phase=f"{name}_profile", decode_steps=2,
             active_slots=CONT_SLOTS, **_device_profile(torch, step, 2))


def _run_trace(model, reqs, *, num_slots, num_pages, page_size, max_blocks):
    """``run_continuous`` on a given list of requests."""
    from repro_torch.models.attention import PageSpec
    from repro_torch.runtime.batching import ContinuousBatchingEngine
    serving = ContinuousBatchingEngine(
        model, num_slots=num_slots,
        spec=PageSpec(num_pages, page_size, max_blocks))
    res = serving.run(reqs)
    res.update(trace=reqs, pool=serving.pool)
    return res


def _state_tensors(leaf):
    """A serving leaf's per-slot tensors: a local ring's (k, v, pos), a
    recurrent or SSM state's own; () for a paged pool."""
    from repro_torch.models.attention import KVCache, PagedKVCache
    if isinstance(leaf, PagedKVCache):
        return ()
    if isinstance(leaf, KVCache):
        return (leaf.k, leaf.v, leaf.pos)
    return tuple(leaf)


def _continuous_gated(torch, model, name, run_kw, want_fn, cfg_kw=None,
                      reqs=None):
    """One continuous run through ``run_continuous`` (engine, fused="auto";
    on ``reqs`` when given, with ``run_kw``'s pool), counted alone, then
    the static-path oracle outside the count.  Gated: every request
    finishes with its tokens in vocabulary, growth evicted at least once,
    every page is free at the end, and the launch counts are
    ``want_fn(admissions, steps)``.  Returns (counts, result, oracle)."""
    from repro_torch.core import use
    from repro_torch.launch.serve import run_continuous, static_oracle
    cfg = model.cfg
    with use(backend="engine", fused="auto", device="cuda", **(cfg_kw or {})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = run_continuous(model, check=False, **run_kw) if reqs is None \
            else _run_trace(model, reqs, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        oracle = static_oracle(model, res["trace"], res["outputs"])
        oracle_s = time.perf_counter() - t0
    m, reqs, pool = res["metrics"], res["trace"], res["pool"]
    steps = m["decode_steps"]
    admissions = len(reqs) + m["evictions"]
    want = want_fn(admissions, steps)
    emit(phase=name, model=cfg.name, layers=cfg.num_layers, run=run_kw,
         prompt_lens=[len(r.prompt) for r in reqs],
         max_new=[r.max_new for r in reqs],
         tokens_per_s=m["tokens_per_s"], total_tokens=m["total_tokens"],
         p50_token_latency_s=m["p50_token_latency_s"],
         p99_token_latency_s=m["p99_token_latency_s"],
         phase_seconds=m["phase_seconds"], decode_steps=steps,
         evictions=m["evictions"], evicted=res["evictions"],
         admissions=admissions, run_seconds=m["wall_seconds"],
         wall_seconds=wall, oracle_seconds=oracle_s,
         peak_memory_bytes=peak, launches=counts, expected=want,
         identical_requests=oracle["identical_requests"],
         requests=len(reqs))
    for r in reqs:
        out = res["outputs"].get(r.rid)
        if out is None or len(out) != r.max_new or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            fail(f"{name}: request {r.rid} did not finish with {r.max_new} "
                 f"in-vocab tokens: {out}")
    if m["evictions"] < 1:
        fail(f"{name}: the trace evicted nothing")
    pool.check_invariants([0] * run_kw["num_slots"])
    if pool.free_pages != run_kw["num_pages"]:
        fail(f"{name}: {run_kw['num_pages'] - pool.free_pages} pages still "
             f"owned at the end")
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    bad.update(_gemm_launch_gap(counts))
    if bad:
        fail(f"{name} launch counts (got, want): {bad}")
    return counts, res, oracle


def phase_continuous_moe(torch, model):
    """phi3.5-moe-42b at its published widths and MOE_SERVE_LAYERS layers
    (``serve_moe``'s model, before ``serve_moe_quant`` quantizes it)
    through continuous batching on Qwen3's trace and pool.  A decode step
    routes every slot, inactive ones included, as the reference's does.
    Gated as ``continuous`` (requests, evictions, pages, launches: three
    grouped_fused a MoE layer a forward, four projections a layer and the
    read-out on the GEMM kernels, flash once a layer a prefill and
    flash_decode once a layer a step), and the first paged decode step's
    logits against the static dense path with its routing replayed.
    ``identical_requests`` and the free-routing gap are printed: a mixture
    of experts promises no token identity across batch compositions."""
    L = model.cfg.num_layers
    run_kw = dict(num_slots=CONT_SLOTS, num_pages=CONT_PAGES,
                  page_size=CONT_PAGE, max_blocks=CONT_BLOCKS, **CONT_TRACE)

    def want(admissions, steps):
        forwards = admissions + steps
        return {"grouped_fused": forwards * 3 * L,
                "engine_grouped_launches": forwards * 3 * L,
                "grouped_padded": 0, "grouped_bwd": 0,
                "engine_gemm_calls": forwards * (4 * L + 1),
                "flash_fwd_fused": admissions * L,
                "engine_flash_launches": admissions * L,
                "flash_fwd_dense": 0,
                "flash_decode": steps * L,
                "engine_decode_launches": steps * L}

    counts, res, _ = _continuous_gated(torch, model, "continuous_moe",
                                       run_kw, want)
    _continuous_logits(torch, model, res["trace"], name="continuous_moe",
                       moe=True)
    return counts


def phase_continuous_ssm(torch, model):
    """mamba2-130m at full depth (``serve_ssm``'s model) through continuous
    batching: 12 requests at 0.5 a tick, prompts of 128-1024 tokens (at
    most 5 chunks of 256 with a re-admitted context: the scan's route A),
    16-48 new tokens, 8 slots over SSM_CONT_PAGES pages of 16 (small
    enough that growth evicts).  Gated as ``continuous``, with one
    ssd_scan_fused a layer an admission, 49 GEMM calls a forward, no flash
    launch; the first paged decode step's logits against the static dense
    path; one all-inactive step leaving every slot's conv and s
    bit-equal.  ``identical_requests`` is printed."""
    L = model.cfg.num_layers
    run_kw = dict(num_slots=CONT_SLOTS, num_pages=SSM_CONT_PAGES,
                  page_size=CONT_PAGE, max_blocks=SSM_CONT_BLOCKS,
                  **SSM_CONT_TRACE)

    def want(admissions, steps):
        return {"ssd_scan_fused": admissions * L,
                "engine_ssd_launches": admissions * L,
                "ssd_chunk_diag": 0, "ssd_scan_bwd": 0,
                "engine_gemm_calls": (admissions + steps) * (2 * L + 1),
                "flash_fwd_fused": 0, "flash_fwd_dense": 0,
                "engine_flash_launches": 0, "flash_decode": 0,
                "engine_decode_launches": 0}

    counts, res, oracle = _continuous_gated(torch, model, "continuous_ssm",
                                            run_kw, want)
    _continuous_logits(torch, model, res["trace"], name="continuous_ssm",
                       blocks=SSM_CONT_BLOCKS, state_check=True)
    return counts


def _stat_sum(stats, key):
    return sum(row.get(key, 0) for row in stats.values())


def _readout_searches(vocab):
    """The autotuner's timed lowerings of the tied read-out (the ``nt``
    GEMM against the vocabulary), one entry per searched shape."""
    from repro_torch.core import autotune
    out = []
    for key, log in autotune.TIMED.items():
        d = log[0][0].desc
        if key[0] != "gemm" or d.layout != "nt" or d.n != vocab:
            continue
        ok = [(p, s) for p, s in log if s is not None]
        best = min(ok, key=lambda x: x[1])[0] if ok else None
        out.append({"m": d.m, "n": d.n, "k": d.k, "winner": None if best is
                    None else dict(fused=best.fused,
                                   regions=len(best.regions),
                                   blocks=sorted({(r.bm, r.bn)
                                                  for r in best.regions})),
                    "timed": [dict(fused=p.fused, regions=len(p.regions),
                                   blocks=sorted({(r.bm, r.bn)
                                                  for r in p.regions}),
                                   ms=None if s is None else s * 1e3)
                              for p, s in log]})
    return sorted(out, key=lambda e: e["m"])


def _refit_of(path):
    """A refit of one tuning cache onto H100_SXM, and the analytical
    tier's misranks on the run's measured pairs (each search's model
    favourite against every other timed candidate) before and after."""
    from repro_torch.core import autotune, refit
    from repro_torch.core.machine import H100_SXM
    entries = json.load(open(path))["entries"]
    model = refit.fit_cache_entries(entries, H100_SXM, mode="cuda")
    fitted = refit.apply_fit(H100_SXM, model)
    pairs = [(log[0][0], p, log[0][1] * 1e6, s * 1e6)
             for log in autotune.TIMED.values() if log[0][1] is not None
             for p, s in log[1:] if s is not None]
    before = refit.count_misranks(pairs, H100_SXM)
    after = refit.count_misranks(pairs, fitted)
    return {"entries": model["entries"], "fitted": model["fitted"],
            "coefficients": model["coefficients"],
            "pinned": {k: getattr(H100_SXM, k)
                       for k in model["coefficients"]},
            "residual_us": model["residual_us"],
            "misranks_before": before[0], "misranks_after": after[0],
            "pairs_considered": before[1]}


def _calibration():
    """``calibrate(H100_SXM)``'s probes at full size beside the pinned
    constants they would replace."""
    from repro_torch.core.machine import H100_SXM, MachineModel
    from repro_torch.core.microbench import characterize
    probes = characterize(H100_SXM, size=8192, mbytes=1024, device="cuda")
    cal = MachineModel.from_probes(probes, base=H100_SXM,
                                   name="calibrated_host")
    return {"probes": {k: [p.value, p.unit] for k, p in probes.items()},
            "calibrated": {"peak_flops": cal.peak_flops, "hbm_bw": cal.hbm_bw,
                           "step_overhead_s": cal.step_overhead_s,
                           "launch_overhead_s": cal.launch_overhead_s},
            "pinned": {"peak_flops": H100_SXM.peak_flops,
                       "hbm_bw": H100_SXM.hbm_bw,
                       "step_overhead_s": H100_SXM.step_overhead_s,
                       "launch_overhead_s": H100_SXM.launch_overhead_s}}


def phase_continuous_warm(torch, model):
    """Qwen3-0.6B (before ``continuous_quant`` quantizes it) through the
    continuous phase's trace twice.  Cold: every cache dropped, autotune on
    with a tuning cache in a temporary directory, the descriptor manifest
    saved at the end.  Warm, after dropping every cache again (a restart):
    ``run_continuous(warm_start=manifest)`` preloading that tuning cache,
    counted from just before it.  Gated: the warm run's serving phase
    times nothing and misses no plan, no candidate and no warmup build
    failed, the warmup served from the cache exactly the descriptors the
    cold run autotuned, and the warm run's greedy tokens are the cold
    run's, bit for bit.  Printed: both runs' latency and tokens/s, the
    autotuned read-out with every timed lowering, the calibration probes
    beside the pinned constants, and a refit of the cold cache with the
    misranks before and after."""
    import tempfile

    import numpy as np
    from repro_torch.core import autotune, engine, use
    from repro_torch.launch.serve import run_continuous
    cfg = model.cfg
    L = cfg.num_layers
    kw = dict(num_slots=CONT_SLOTS, num_pages=CONT_PAGES, page_size=CONT_PAGE,
              max_blocks=CONT_BLOCKS, check=False, **CONT_TRACE)
    with tempfile.TemporaryDirectory() as tmp:
        cache, manifest = f"{tmp}/tune.json", f"{tmp}/manifest.json"
        engine.reset_stats(entries=True)
        autotune.reset_tuning_caches()
        with use(backend="engine", fused="auto", device="cuda",
                 autotune=True, tuning_cache=cache):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cold = run_continuous(model, warm_start=manifest, **kw)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
        readout = _readout_searches(cfg.vocab_size)
        refit = _refit_of(cache)
        cold_st = cold["engine_stats"]
        entries = len(json.load(open(cache))["entries"])
        manifest_n = len(json.load(open(manifest))["descriptors"])
        engine.reset_stats(entries=True)
        autotune.reset_tuning_caches()
        with use(backend="engine", fused="auto", device="cuda",
                 tuning_cache_preload=cache):
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            warm = run_continuous(model, warm_start=manifest, **kw)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            counts = _read_counts()
    engine.reset_stats(entries=True)
    autotune.reset_tuning_caches()
    w, cm, wm = warm["warmup"], cold["metrics"], warm["metrics"]
    warm_st = w["engine_stats"]
    tuned = _stat_sum(cold_st, "plan_source_autotuned")
    gates = {
        "post_autotune_timings": w["post_autotune_timings"],
        "post_plan_misses": w["post_plan_misses"],
        "autotune_failures": _stat_sum(cold_st, "autotune_failures"),
        "warmup_failures": _stat_sum(warm_st, "warmup_failures"),
        "autotuned_cold": tuned,
        "tuned_cache_warm": _stat_sum(warm_st, "plan_source_tuned_cache"),
        "tokens_identical": sorted(cold["outputs"]) == sorted(
            warm["outputs"]) and all(
            np.array_equal(cold["outputs"][rid], warm["outputs"][rid])
            for rid in cold["outputs"]),
    }
    emit(phase="continuous_warm", model=cfg.name, trace=CONT_TRACE,
         cold=dict(wall_seconds=cold_s, run_seconds=cm["wall_seconds"],
                   tokens_per_s=cm["tokens_per_s"],
                   p50_token_latency_s=cm["p50_token_latency_s"],
                   p99_token_latency_s=cm["p99_token_latency_s"],
                   autotune_timings=_stat_sum(cold_st, "autotune_timings"),
                   plan_sources={s: _stat_sum(cold_st, f"plan_source_{s}")
                                 for s in ("tuned_cache", "autotuned",
                                           "model")},
                   tuning_cache_entries=entries, manifest_entries=manifest_n,
                   decode_steps=cm["decode_steps"],
                   evictions=cm["evictions"]),
         warm=dict(wall_seconds=warm_s, run_seconds=wm["wall_seconds"],
                   warmup_seconds=w["seconds"], warmed=w["kernels"],
                   prefill_lengths=len(w["prefill_lengths"]),
                   tokens_per_s=wm["tokens_per_s"],
                   p50_token_latency_s=wm["p50_token_latency_s"],
                   p99_token_latency_s=wm["p99_token_latency_s"],
                   decode_steps=wm["decode_steps"],
                   evictions=wm["evictions"]),
         gates=gates, launches=counts, readout=readout, refit=refit,
         calibration=_calibration())
    bad = {k: v for k, v in gates.items()
           if k in ("post_autotune_timings", "post_plan_misses",
                    "autotune_failures", "warmup_failures") and v}
    if bad:
        fail(f"continuous_warm: {bad}")
    if not tuned or gates["tuned_cache_warm"] != tuned:
        fail(f"continuous_warm: the warmup served "
             f"{gates['tuned_cache_warm']} plans from the tuning cache, the "
             f"cold run autotuned {tuned}")
    if not gates["tokens_identical"]:
        fail("continuous_warm: the warm run's tokens differ from the cold "
             "run's")
    if wm["flash_decode_launches"] != wm["decode_steps"] * L:
        fail(f"continuous_warm: {wm['flash_decode_launches']} flash_decode "
             f"launches, {wm['decode_steps']} steps x {L} layers")
    return counts


def phase_reduced(torch):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    from repro_torch.models import LanguageModel
    cfg = reduced_config(get_config("qwen3-0.6b"))
    model = LanguageModel(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                            device="cuda")
    toks = {}
    for be in ("engine", "torch"):
        with use(backend=be, device="cuda"):
            toks[be] = generate(model, prompts, 8)["tokens"]
    same = bool(torch.equal(toks["engine"], toks["torch"]))
    emit(phase="reduced", model=cfg.name, dtype=cfg.dtype,
         tokens_identical=same, tokens=toks["engine"].tolist())
    if not same:
        fail("reduced fp32 engine and torch tokens differ")
    # Continuous batching in fp32 with an eviction (tests/test_serving.py's
    # evict/re-admit case): the paged fp32 decode kernel's tokens must be
    # the static path's.
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import run_continuous
    n0 = fk.LAUNCHES["flash_decode"]
    with use(backend="engine", device="cuda"):
        res = run_continuous(model, num_slots=3, num_pages=9, page_size=4,
                             max_blocks=8, num_requests=4, rate=2.0,
                             prompt_len=10, max_new=8, seed=1)
    m = res["metrics"]
    emit(phase="reduced_continuous", model=cfg.name, dtype=cfg.dtype,
         evictions=m["evictions"], decode_steps=m["decode_steps"],
         flash_decode_kernel_launches=fk.LAUNCHES["flash_decode"] - n0,
         token_identical=res["token_identical"])
    if not (res["token_identical"] and m["evictions"] > 0
            and fk.LAUNCHES["flash_decode"] - n0
            == m["decode_steps"] * cfg.num_layers):
        fail("reduced fp32 continuous run: tokens differ from the static "
             "path, no eviction, or the decode kernel did not run")
    # mamba2-130m in fp32 at reduced width: a 20-token prompt pads to 3
    # chunks of 8, then 8 greedy tokens, engine against torch.
    cfg = reduced_config(get_config("mamba2-130m"))
    model = LanguageModel(cfg, device="cuda", seed=0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen,
                            device="cuda")
    from repro_torch.kernels.ssd_chunk import kernel as sk
    n0 = sk.LAUNCHES["ssd_scan_fused"]
    toks = {}
    for be in ("engine", "torch"):
        with use(backend=be, device="cuda"):
            toks[be] = generate(model, prompts, 8)["tokens"]
    same = bool(torch.equal(toks["engine"], toks["torch"]))
    emit(phase="reduced_ssm", model=cfg.name, dtype=cfg.dtype,
         tokens_identical=same, tokens=toks["engine"].tolist(),
         ssd_scan_fused_launches=sk.LAUNCHES["ssd_scan_fused"] - n0)
    if not same or sk.LAUNCHES["ssd_scan_fused"] - n0 != cfg.num_layers:
        fail("reduced fp32 mamba2: engine and torch tokens differ, or the "
             "scan kernel did not run once per layer")


# ---------------------------------------------------------------------------
# Phase 7: training at full width
# ---------------------------------------------------------------------------

def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _train_parts(torch, cfg, seq, draw=False, batch=TRAIN_BATCH, opt=None,
                 feats=0):
    """(make_state, batch_fn, step_fn); ``draw`` redraws every bias and norm
    leaf of each fresh model (:func:`_draw_leaves`), the same values each
    time; ``opt`` replaces the reference CLI's AdamW; ``feats`` > 0 adds
    ``modality_feats`` of that many rows (image tokens or audio frames)
    to each batch, drawn from a generator seeded by the step."""
    from repro_torch.convert import reference_shapes
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime.steps import make_train_step, model_for
    ds = SyntheticLMDataset(cfg.vocab_size, seq, batch)
    opt = opt or adamw(warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10, TRAIN_STEPS))

    def make_state():
        model = model_for(cfg)(cfg, device="cuda", seed=0)
        if draw:
            _draw_leaves(torch, model)
        return model, opt.init(dict(model.named_parameters()),
                               shapes=reference_shapes(cfg, model))

    def batch_fn(step):
        out = {k: torch.from_numpy(v).to("cuda")
               for k, v in ds.host_batch(step).items()}
        if feats:
            out["modality_feats"] = _features(torch, cfg, batch, feats,
                                              seed=1000 + step)
        return out

    return make_state, batch_fn, make_train_step(cfg, opt)


def _features(torch, cfg, batch, rows, seed):
    """Seeded N(0, 1) features (batch, rows, modality_dim) on the card: the
    stub frontends' precomputed image or audio-frame embeddings."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((batch, rows, cfg.modality_dim), generator=gen,
                       device="cuda")


def _backend_gap(torch, cfg, make_state, batch_fn, name):
    """Loss and gradients of one batch under both backends, same weights.
    For a mixture of experts the torch backend replays the engine's
    routing: bf16 rounding upstream flips near-tied top-k choices, and a
    flipped token's output and gradient are another expert's, which says
    nothing of the kernels.  The free-routing gaps and the number of
    flipped routings are reported beside the gated ones."""
    from repro_torch.core import use
    from repro_torch.runtime.steps import make_loss_fn
    model = make_state()[0]  # the optimizer state is not needed: free it
    params = [p for _, p in model.named_parameters()]
    batch = batch_fn(0)
    moe = bool(cfg.num_experts)
    routes = {"engine": [], "torch": []}

    def run(backend, mode, calls):
        with use(backend=backend, device="cuda"), _routing(mode, calls):
            total, _ = make_loss_fn(cfg)(model, batch)
            return total.item(), torch.autograd.grad(total, params)

    def gaps(loss, grads):
        diff = sum((a.float() - b.float()).square().sum()
                   for a, b in zip(grads_e, grads))
        norm = sum(b.float().square().sum() for b in grads)
        return _rel(loss_e, loss), (diff / norm).sqrt().item(), \
            norm.sqrt().item()

    loss_e, grads_e = run("engine", "record" if moe else None,
                          routes["engine"])
    loss_t, grads = run("torch", "replay" if moe else None, routes["engine"])
    loss_gap, grad_gap, grad_norm = gaps(loss_t, grads)
    del grads
    extra = {}
    if moe:
        loss_f, grads = run("torch", "record", routes["torch"])
        free_loss_gap, free_grad_gap, _ = gaps(loss_f, grads)
        del grads
        extra = dict(routing="the torch backend replays the engine's",
                     loss_torch_free_routing=loss_f,
                     loss_rel_gap_free_routing=free_loss_gap,
                     grad_rel_l2_gap_free_routing=free_grad_gap,
                     **_flips(routes["engine"], routes["torch"]))
    emit(phase=f"{name}_backends", loss_engine=loss_e,
         loss_torch=loss_t, loss_rel_gap=loss_gap,
         loss_bound=LOSS_BOUND, grad_rel_l2_gap=grad_gap,
         grad_bound=GRAD_BOUND, grad_norm_torch=grad_norm, **extra)
    if not (loss_gap <= LOSS_BOUND and grad_gap <= GRAD_BOUND):
        fail(f"engine vs torch: loss gap {loss_gap:.4g} (bound {LOSS_BOUND}),"
             f" gradient gap {grad_gap:.4g} (bound {GRAD_BOUND})")


def _layer_passes(cfg, recompute):
    """How many times each layer's forward runs in a step: once, and once
    more in the backward for a layer of a checkpointed group (``cfg.remat``:
    the first ``num_layers // len(block_pattern)`` groups; the remainder
    layers are not checkpointed)."""
    pat = len(cfg.block_pattern)
    grouped = cfg.num_layers // pat * pat if recompute and cfg.remat else 0
    return [2 if i < grouped else 1 for i in range(cfg.num_layers)]


def _train_want(cfg):
    """Launches per training step that the model's structure implies.  With
    ``cfg.remat`` a checkpointed group's forward runs again in the backward,
    so its forward GEMM, flash, SSD and grouped launches count twice;
    remainder layers and the read-out once."""
    L = cfg.num_layers
    fwd = sum(_layer_passes(cfg, True))
    if cfg.num_experts:
        # the attention projections and the read-out; per layer pass the
        # three expert GEMMs forward (up, gate with its silu, down) and, in
        # the backward, the gate's pre-activation recomputed to peel the
        # silu off, then one backward walk per expert GEMM
        return {"engine_gemm_calls": 4 * fwd + 1, **_act_bwd_want(cfg),
                "flash_fwd_fused": fwd, "flash_fwd_dense": 0,
                "flash_bwd_fused": L, "engine_flash_launches": fwd,
                "engine_flash_launches_bwd": L,
                "grouped_fused": 3 * fwd + L, "grouped_padded": 0,
                "grouped_bwd": 3 * L, "engine_grouped_launches": 3 * fwd + L,
                "engine_grouped_launches_bwd": 3 * L}
    if cfg.block_pattern == ("ssm",):
        # two projections a layer pass and the tied read-out; the scan with
        # its entering states forward, the reverse walk backward
        return {"engine_gemm_calls": 2 * fwd + 1, **_act_bwd_want(cfg),
                "ssd_scan_fused": fwd,
                "ssd_chunk_diag": 0, "ssd_scan_bwd": L,
                "engine_ssd_launches": fwd, "engine_ssd_launches_bwd": L,
                "flash_fwd_fused": 0, "flash_bwd_fused": 0}
    if cfg.encoder_decoder:
        # every encoder layer and decoder layer recomputed; flash once an
        # encoder layer pass (non-causal) and twice a decoder layer pass
        # (causal self-attention, non-causal cross-attention) forward, once
        # an encoder layer and twice a decoder layer backward
        flash_fwd = 2 * (cfg.num_encoder_layers + 2 * L)
        flash_bwd = cfg.num_encoder_layers + 2 * L
        return {**_encdec_gemm_want(cfg, passes=2), **_act_bwd_want(cfg),
                "flash_fwd_fused": flash_fwd, "flash_fwd_dense": 0,
                "flash_bwd_fused": flash_bwd,
                "engine_flash_launches": flash_fwd,
                "engine_flash_launches_bwd": flash_bwd}
    # an attention or hybrid decoder: its GEMMs each layer pass, flash once
    # a global-attention layer pass forward and once backward (none where
    # the attention softcap keeps attention in plain torch, none for
    # sliding-window layers); a vision prefix's two projector GEMMs once
    flash = _flash_calls(cfg)
    gemms = _gemm_want(cfg, 1, recompute=True)
    if cfg.modality == "vision":
        gemms["engine_gemm_calls"] += 2
        gemms["gemm_fused"] += 2
    return {**gemms, **_act_bwd_want(cfg),
            "flash_fwd_fused": _flash_calls(cfg, recompute=True),
            "flash_fwd_dense": 0, "flash_bwd_fused": flash,
            "engine_flash_launches": _flash_calls(cfg, recompute=True),
            "engine_flash_launches_bwd": flash}


def _act_bwd_want(cfg):
    """Fused recomputes of a training step (``gemm_act_bwd`` launches and
    the gemm family's ``launches_bwd``): one for each GEMM with an
    activation epilogue, whose backward runs once a step, remat or not --
    the dense MLP's gate (gated) or up projection in every decoder and
    encoder layer, RG-LRU's lin_y, a vision prefix's proj1.  The expert
    GEMMs of a mixture of experts are the grouped family's; mamba2's
    projections carry no activation."""
    dense = cfg.num_layers if cfg.block_has_mlp and not cfg.num_experts \
        else 0
    n = dense + cfg.num_encoder_layers + _kinds(cfg).count("rec") \
        + (cfg.modality == "vision")
    return {"gemm_act_bwd": n, "engine_gemm_launches_bwd": n}


def _encdec_gemm_want(cfg, passes):
    """GEMM calls and kernel launches of one training forward of an
    encoder-decoder, each layer run ``passes`` times (2 under remat): the
    audio adapter once, four attention and the MLP's GEMMs an encoder layer
    pass, four self-attention, four cross-attention and the MLP's a decoder
    layer pass, and the untied read-out.  At the training rows every plan
    is one fused launch, except a read-out whose vocab is off the 128-column
    tiles (seamless's 256,206, run over its copy padded to whole 16-byte
    rows, 256,208 = 2,001 x 128 + 80): two region launches."""
    mlp = 3 if cfg.mlp_gated else 2
    proj = 1 + passes * (cfg.num_encoder_layers * (4 + mlp)
                         + cfg.num_layers * (8 + mlp))
    ragged = cfg.vocab_size % 128 != 0
    return {"engine_gemm_calls": proj + 1,
            "gemm_fused": proj + (0 if ragged else 1),
            "gemm_region": 2 if ragged else 0}


def _flash_calls(cfg, recompute=False):
    """Flash forwards of one forward pass (with ``recompute``, of a training
    step under remat): one a global-attention layer pass; none for
    sliding-window layers or where the attention softcap keeps attention
    off the flash kernels (grok-1), as in the reference."""
    if cfg.attn_logit_softcap:
        return 0
    return sum(n for n, kind in zip(_layer_passes(cfg, recompute),
                                    _kinds(cfg)) if kind == "attn")


def _kinds(cfg):
    pat = cfg.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


# GEMMs of one layer's mixer: q, k, v and o for attention ("attn", "local");
# lin_y (bias and gelu fused), lin_x, gate_a, gate_x and lin_out for RG-LRU.
MIXER_GEMMS = {"attn": 4, "local": 4, "rec": 5}


def _gemm_want(cfg, forwards, recompute=False):
    """GEMM calls and kernel launches of ``forwards`` forward passes of an
    attention or hybrid model (with ``recompute``, of a training step
    under remat): each layer pass its mixer's GEMMs (``MIXER_GEMMS``) and
    the dense MLP's (three gated, two not; a mixture of experts runs its
    experts on the grouped kernels), and the read-out, one GEMM tied or
    untied.  Every plan of these shapes is one fused launch, except a
    read-out whose vocab is off the 128-column tiles (phi3-mini's and
    phi3.5-moe's 32,064 = 250 x 128 + 64): the planner covers it with two
    regions, two gemm_region launches."""
    mlp = 0 if cfg.num_experts else 3 if cfg.mlp_gated else 2
    proj = sum(n * (MIXER_GEMMS[kind] + mlp) for n, kind in
               zip(_layer_passes(cfg, recompute), _kinds(cfg)))
    ragged = cfg.vocab_size % 128 != 0
    return {"engine_gemm_calls": forwards * (proj + 1),
            "gemm_fused": forwards * (proj + (0 if ragged else 1)),
            "gemm_region": forwards * (2 if ragged else 0)}


def phase_train(torch, arch="qwen3-0.6b", seq=TRAIN_SEQ, name="train",
                cfg=None, resume=True, extra=None, draw=False,
                batch=TRAIN_BATCH, opt=None, remat_check=False, feats=0):
    """Training at full width through ``run_with_restarts``.  ``cfg``
    overrides ``get_config(arch)``; ``resume=False`` writes no checkpoint
    and skips the resume check; ``extra`` joins the phase's line; ``draw``
    redraws the bias and norm leaves (:func:`_draw_leaves`); ``batch`` and
    ``opt`` replace the reference CLI's batch and AdamW; ``remat_check``
    first runs :func:`_remat_check`; ``feats`` adds that many rows of
    modality features to each batch (:func:`_train_parts`).  A step after
    the first resolves no plan: the recompute under remat hits the plans
    its forward built."""
    import os
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core import use
    from repro_torch.runtime.train_loop import (TrainLoopConfig,
                                                run_with_restarts)
    cfg = cfg or get_config(arch)
    make_state, batch_fn, step_fn = _train_parts(torch, cfg, seq, draw,
                                                 batch, opt, feats)
    if remat_check:
        _remat_check(torch, cfg, seq, batch, name)
        torch.cuda.empty_cache()
    with use(backend="engine", fused="auto", device="cuda"):
        _backend_gap(torch, cfg, make_state, batch_fn, name)
    torch.cuda.empty_cache()

    per_step = []

    def counted_step(model, opt_state, batch, step):
        _reset_counts()
        metrics = step_fn(model, opt_state, batch, step)
        per_step.append(_read_counts())
        return metrics

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # No fault is injected, so a restart could only hide a kernel
        # error: the first exception ends the run.
        loop = TrainLoopConfig(total_steps=TRAIN_STEPS, ckpt_dir=ckpt,
                               save_every=SAVE_EVERY if resume else 0,
                               log_every=1, max_restarts=0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with use(backend="engine", fused="auto", device="cuda"):
            out = run_with_restarts(make_state, counted_step, batch_fn, loop)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        hist = out["metrics"]
        losses = [m["loss"] for m in hist]
        step_s = [m["step_seconds"] for m in hist]
        want = _train_want(cfg)
        tokens = batch * seq
        emit(phase=name, model=cfg.name, params=cfg.param_count(),
             layers=cfg.num_layers, remat=cfg.remat,
             batch=batch, seq=seq, modality_rows=feats, steps=len(hist),
             losses=losses, nll=[m["nll"] for m in hist],
             grad_norm=[m["grad_norm"] for m in hist],
             step_seconds=step_s,
             tokens_per_s=[tokens / t for t in step_s],
             run_seconds=run_s, peak_memory_bytes=peak,
             launches_per_step=per_step,
             expected_per_step=want, **(extra or {}))
        if len(hist) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            fail(f"{name} losses not finite over {TRAIN_STEPS} steps: "
                 f"{losses}")
        for i, counts in enumerate(per_step):
            bad = {k: (counts[k], n) for k, n in want.items()
                   if counts[k] != n}
            bad.update(_gemm_launch_gap(counts))
            if i and counts["engine_plan_misses"]:
                bad["plan misses after step 0"] = (
                    counts["engine_plan_misses"], 0)
            if bad:
                fail(f"{name} step {i}: launch counts (got, want) {bad}")
        if resume:
            model, opt_state = _resume(torch, cfg, make_state, batch_fn,
                                       step_fn, ckpt, out, name)
        elif os.listdir(ckpt):
            fail(f"{name} wrote a checkpoint: {os.listdir(ckpt)}")
        else:
            model, opt_state = out["model"], out["opt_state"]
        emit(phase=f"{name}_opt_state", **_opt_state_bytes(opt_state))
        del out
        with use(backend="engine", fused="auto", device="cuda"):
            batch = batch_fn(TRAIN_STEPS)
            emit(phase=f"{name}_profile", steps=1, **_device_profile(
                torch, lambda: step_fn(model, opt_state, batch, TRAIN_STEPS),
                1))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return _add_counts(*per_step)


def _remat_check(torch, cfg, seq, batch, name):
    """One train step with ``cfg.remat`` and one without, each from fresh
    state (the same seed) on the same batch: the losses must agree (the
    forward is the same work, so they are expected bit-equal) and the
    peak memory of the forward and backward (read as the optimizer update
    starts) must be higher without remat.  Both steps' whole peaks and
    times are printed beside it."""
    import dataclasses
    from repro_torch.core import use
    out = {}
    for label, c in (("remat", cfg),
                     ("no_remat", dataclasses.replace(cfg, remat=False))):
        make_state, batch_fn, step_fn = _train_parts(torch, c, seq,
                                                     batch=batch)
        model, opt_state = make_state()
        data = batch_fn(0)
        seen = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with use(backend="engine", fused="auto", device="cuda"), \
                _peak_at_update(torch, seen):
            t0 = time.perf_counter()
            metrics = step_fn(model, opt_state, data, 0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        out[label] = dict(loss=float(metrics["loss"]), step_seconds=dt,
                          peak_memory_bytes=torch.cuda.max_memory_allocated(),
                          fwd_bwd_peak_memory_bytes=seen["peak"])
        del model, opt_state, data, metrics
        torch.cuda.empty_cache()
    gap = _rel(out["no_remat"]["loss"], out["remat"]["loss"])
    higher = out["no_remat"]["fwd_bwd_peak_memory_bytes"] > \
        out["remat"]["fwd_bwd_peak_memory_bytes"]
    emit(phase=f"{name}_remat", batch=batch, seq=seq, **out,
         loss_rel_gap=gap, loss_bound=REMAT_LOSS_TOL,
         loss_bit_equal=out["no_remat"]["loss"] == out["remat"]["loss"],
         peak_higher_without_remat=higher)
    if not gap <= REMAT_LOSS_TOL:
        fail(f"{name}: the loss with remat differs from the loss without by "
             f"{gap:.3g} (bound {REMAT_LOSS_TOL})")
    if not higher:
        fail(f"{name}: the forward and backward peak without remat is not "
             f"above the one with it: {out}")


@contextlib.contextmanager
def _peak_at_update(torch, seen):
    """Record ``torch.cuda.max_memory_allocated()`` when an optimizer update
    starts (the peak of the step's forward and backward) into
    ``seen["peak"]``: ``make_train_step`` calls ``clip_by_global_norm``
    first in every update."""
    import importlib
    # (the package's ``adamw`` attribute is the function: fetch the module)
    adamw_mod = importlib.import_module("repro_torch.optim.adamw")
    clip = adamw_mod.clip_by_global_norm

    def spy(grads, max_norm):
        seen["peak"] = torch.cuda.max_memory_allocated()
        return clip(grads, max_norm)

    adamw_mod.clip_by_global_norm = spy
    try:
        yield
    finally:
        adamw_mod.clip_by_global_norm = clip


def _resume(torch, cfg, make_state, batch_fn, step_fn, ckpt, out, name):
    """Restore the step-2 checkpoint into fresh state and take steps 3 and
    4 again; compare with the uninterrupted run."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core import use
    hist = out["metrics"]
    model, opt_state = make_state()
    restored, meta = restore_checkpoint(
        ckpt, SAVE_EVERY, {"params": dict(model.named_parameters()),
                           "opt_state": opt_state})
    model.load_state_dict(restored["params"])
    opt_state = restored["opt_state"]
    del restored
    again = []
    with use(backend="engine", fused="auto", device="cuda"):
        for step in range(meta["data_step"], TRAIN_STEPS):
            m = step_fn(model, opt_state, batch_fn(step), step)
            again.append({k: float(v) for k, v in m.items()})
    first, second = again[0], again[1]
    diff = sum((a - b).float().square().sum() for a, b in zip(
        model.parameters(), out["model"].parameters()))
    norm = sum(b.float().square().sum() for b in out["model"].parameters())
    param_gap = (diff / norm).sqrt().item()
    # hist[i] is the run's step i (0-based): the restored state steps 2, 3.
    gaps = {"loss[2]": _rel(first["loss"], hist[2]["loss"]),
            "grad_norm[2]": _rel(first["grad_norm"], hist[2]["grad_norm"]),
            "loss[3]": _rel(second["loss"], hist[3]["loss"]),
            "final_params_rel_l2": param_gap}
    bounds = {"loss[2]": RESUME_EXACT, "grad_norm[2]": RESUME_TOL,
              "loss[3]": RESUME_TOL, "final_params_rel_l2": RESUME_TOL}
    emit(phase=f"{name}_resume", from_step=meta["data_step"],
         losses=[a["loss"] for a in again], gaps=gaps, bounds=bounds)
    bad = {k: g for k, g in gaps.items() if not g <= bounds[k]}
    if bad:
        fail(f"{name}: resume from step {meta['data_step']} differs: {bad}")
    return model, opt_state


# ---------------------------------------------------------------------------
# Phase 8: mamba2-130m serving at full width
# ---------------------------------------------------------------------------

def _ssm_prefill_logits(torch, model, prompts):
    from repro_torch.runtime.steps import make_prefill_step
    logits, _ = make_prefill_step(model, prompts.shape[1])(
        {"tokens": prompts})
    torch.cuda.synchronize()
    return logits.float()


def phase_serve_ssm(torch):
    """Full-width mamba2-130m through ``generate`` (engine, fused="auto"),
    counted alone, with its gates; then the torch backend's prefill and the
    decode-consistency check outside the count."""
    from repro_torch.configs import get_config
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    from repro_torch.models import LanguageModel
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step
    cfg = get_config("mamba2-130m")
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT),
                            generator=gen, device="cuda")
    with use(backend="engine", fused="auto", device="cuda"):
        generate(model, prompts, 2)  # warm: plans, first launches
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        res = generate(model, prompts, SSM_GEN)
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        logits = _ssm_prefill_logits(torch, model, prompts)
        # decode consistency: prefill all but the last prompt token, then
        # one decode step on it, against the full forward's last position
        with torch.no_grad():
            full, _, _ = model.apply(prompts, logits_mode="last")
            _, cache = make_prefill_step(model, SSM_PROMPT)(
                {"tokens": prompts[:, :-1]})
            step, _, _ = make_serve_step(model)(
                cache, prompts[:, -1:],
                torch.tensor(SSM_PROMPT - 1, dtype=torch.int32,
                             device="cuda"))
    toks = res["tokens"]
    if tuple(toks.shape) != (SSM_BATCH, SSM_GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"serve_ssm: bad tokens {tuple(toks.shape)}")
    # One prefill and SSM_GEN - 1 decode steps: the scan once per layer in
    # the prefill and never in decode; two projections a layer and the
    # tied read-out a forward.
    want = {"ssd_scan_fused": L, "ssd_chunk_diag": 0, "ssd_scan_bwd": 0,
            "engine_ssd_launches": L,
            "engine_gemm_calls": SSM_GEN * (2 * L + 1),
            "flash_fwd_fused": 0, "flash_decode": 0}
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    bad.update(_gemm_launch_gap(counts))
    with use(backend="torch", device="cuda"):
        ref = _ssm_prefill_logits(torch, model, prompts)
    gap, spread, rel = _logit_gap(torch, logits, ref)
    dgap, _, drel = _logit_gap(torch, step.float(), full[:, -1].float())
    emit(phase="serve_ssm", model=cfg.name, params=cfg.param_count(),
         batch=SSM_BATCH, prompt=SSM_PROMPT, chunks=-(-SSM_PROMPT //
                                                      cfg.ssm_chunk),
         new_tokens=SSM_GEN, fused="auto", init_seconds=init_s,
         prefill_seconds=res["prefill_seconds"],
         prefill_tokens_per_s=SSM_BATCH * SSM_PROMPT / res["prefill_seconds"],
         decode_seconds=res["decode_seconds"],
         decode_tokens_per_s=SSM_BATCH * (SSM_GEN - 1) / res["decode_seconds"],
         peak_memory_bytes=peak, launches=counts, expected=want,
         logits_vs_torch_max_abs=gap, logits_spread=spread, logits_rel=rel,
         decode_vs_full_max_abs=dgap, decode_vs_full_rel=drel,
         logits_bound=LOGIT_BOUND)
    if bad:
        fail(f"serve_ssm launch counts (got, want): {bad}")
    if rel > LOGIT_BOUND:
        fail(f"serve_ssm: engine vs torch prefill logits differ by {rel:.4f} "
             f"of their range (bound {LOGIT_BOUND})")
    if drel > LOGIT_BOUND:
        fail(f"serve_ssm: prefill + decode step vs full forward logits "
             f"differ by {drel:.4f} of their range (bound {LOGIT_BOUND})")
    return counts, model, prompts, logits


def _ssm_scan_lowerings(torch, model, prompts):
    """Layer 0's scan operands at the serving prompt (caught on their way
    into ``ssd_chunk_scan``), through the fused kernel and through the
    fallback (the diag kernel plus the torch recurrence): how far the two
    lowerings' outputs lie apart."""
    import repro_torch.kernels.ssd_chunk as ssd_pkg
    from repro_torch.core import use
    scan, caught = ssd_pkg.ssd_chunk_scan, []

    def catch(*ops):
        if not caught:
            caught.extend(t.clone() for t in ops)
        return scan(*ops)

    ssd_pkg.ssd_chunk_scan = catch  # models/ssd.py imports it per call
    try:
        with use(backend="engine", fused="auto", device="cuda"), \
                torch.no_grad():
            model.apply(prompts, logits_mode="last")
    finally:
        ssd_pkg.ssd_chunk_scan = scan
    out = {}
    for fused in ("auto", "off"):
        with use(backend="engine", fused=fused, device="cuda"), \
                torch.no_grad():
            out[fused] = scan(*caught)
    torch.cuda.synchronize()
    (ya, sa), (yo, so) = out["auto"], out["off"]
    return {"dtypes": [str(t.dtype).split(".")[-1] for t in caught[:4]],
            "y_max_abs_diff": (ya.float() - yo.float()).abs().max().item(),
            "y_max_abs": ya.float().abs().max().item(),
            "y_differing": int((ya != yo).sum()), "y_count": ya.numel(),
            "s_final_max_abs_diff": (sa - so).abs().max().item(),
            "s_final_max_abs": sa.abs().max().item()}


def phase_serve_ssm_prefill_profile(torch, model, prompts):
    """One full-width mamba2-130m prefill (batch 4 x 1000, fused="auto")
    under torch.profiler: wall against device, and the kernels that take
    it (the scan's ``ssd_fwd_wgmma`` among them)."""
    from repro_torch.core import use
    from repro_torch.runtime.steps import make_prefill_step
    with use(backend="engine", fused="auto", device="cuda"), torch.no_grad():
        prefill = make_prefill_step(model, SSM_PROMPT + SSM_GEN)

        def step():
            prefill({"tokens": prompts})

        step()  # warm
        emit(phase="serve_ssm_prefill_profile", batch=SSM_BATCH,
             prompt=SSM_PROMPT, **_device_profile(torch, step, 1))


def phase_serve_ssm_off(torch, model, prompts, logits_auto):
    """The same prefill under fused="off": the intra-chunk kernel once per
    layer and the inter-chunk recurrence in torch ops."""
    from repro_torch.core import use
    L = model.cfg.num_layers
    with use(backend="engine", fused="off", device="cuda"):
        _reset_counts()
        t0 = time.perf_counter()
        logits = _ssm_prefill_logits(torch, model, prompts)
        prefill_s = time.perf_counter() - t0
        counts = _read_counts()
    want = {"ssd_chunk_diag": L, "ssd_scan_fused": 0,
            "engine_ssd_launches": L}
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    gap, _, rel = _logit_gap(torch, logits, logits_auto)
    emit(phase="serve_ssm_off", fused="off", prefill_seconds=prefill_s,
         launches=counts, expected=want, logits_vs_auto_max_abs=gap,
         logits_rel=rel, logits_differing=int((logits != logits_auto).sum()),
         logits_count=logits.numel(), logits_bound=LOGIT_BOUND,
         scan_layer0=_ssm_scan_lowerings(torch, model, prompts))
    if bad:
        fail(f"serve_ssm_off launch counts (got, want): {bad}")
    if rel > LOGIT_BOUND:
        fail(f"serve_ssm fused='off' logits differ from fused='auto' by "
             f"{rel:.4f}")
    return counts


# ---------------------------------------------------------------------------
# Phase 9: phi3.5-moe-42b at full width, cut in depth
# ---------------------------------------------------------------------------

def _moe_cfg(layers: int):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), num_layers=layers)


def _moe_reduced(layers: int):
    return {"num_layers": f"32 -> {layers}",
            "why": "fp32 masters, 167 GB at 32 layers"}


@contextlib.contextmanager
def _routing(mode, calls):
    """Stand in for ``models/moe.py``'s ``top_k`` (``moe_apply`` looks it
    up per call): ``"record"`` appends each call's expert indices to
    ``calls``, ``"replay"`` hands the recorded ones back in order, with the
    gate values gathered from this run's own probabilities; None leaves
    the routing alone."""
    if mode is None:
        yield
        return
    import repro_torch.models.moe as moe_mod
    top_k, replay = moe_mod.top_k, iter(list(calls))

    def route(probs, k):
        if mode == "replay":
            idx = next(replay)
            return probs.gather(-1, idx), idx
        vals, idx = top_k(probs, k)
        calls.append(idx.detach().clone())
        return vals, idx

    moe_mod.top_k = route
    try:
        yield
    finally:
        moe_mod.top_k = top_k


def _flips(calls_a, calls_b):
    """How many (token, layer) routings two recorded runs chose apart (any
    difference in the ordered top-k indices)."""
    differ = [int((a != b).any(-1).sum()) for a, b in zip(calls_a, calls_b)]
    return {"routings_differing": sum(differ),
            "routings_differing_by_call": differ,
            "routings": sum(a[..., 0].numel() for a in calls_a)}


def _moe_layer0(torch, model, prompts):
    """Layer 0's MoE input at the serving prompt (caught on its way into
    ``moe_apply``) through both backends' ``moe_apply``: the same fp32
    routing by construction, so y differs only by the expert GEMMs."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.core import use
    moe_apply, caught = moe_mod.moe_apply, []

    def catch(ff, cfg, x):
        if not caught:
            caught.append(x.clone())
        return moe_apply(ff, cfg, x)

    moe_mod.moe_apply = catch  # MoE.forward looks it up per call
    try:
        with use(backend="engine", fused="auto", device="cuda"), \
                torch.no_grad():
            model.apply(prompts, logits_mode="last")
    finally:
        moe_mod.moe_apply = moe_apply
    out = {}
    for backend in ("engine", "torch"):
        with use(backend=backend, fused="auto", device="cuda"), \
                torch.no_grad():
            out[backend] = moe_apply(model.blocks[0].ff, model.cfg, caught[0])
    torch.cuda.synchronize()
    (ye, auxe), (yt, auxt) = out["engine"], out["torch"]
    max_abs, rel, nbad, tol = compare(torch, ye, yt, "bfloat16")
    return {"y_max_abs_err": max_abs, "y_max_rel_err": rel,
            "y_mismatches": nbad, "tolerance": tol,
            "aux_engine": auxe.item(), "aux_torch": auxt.item()}


def phase_serve_moe(torch):
    """phi3.5-moe-42b at full width and 4 layers through ``generate``
    (engine, fused="auto"), counted alone, with its gates; then, outside
    the count, the torch backend's prefill, the routings that differ, layer
    0's MoE through both backends and a profile of two decode steps."""
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    from repro_torch.models import LanguageModel
    cfg = _moe_cfg(MOE_SERVE_LAYERS)
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(torch, cfg.vocab_size)
    with use(backend="engine", fused="auto", device="cuda"):
        generate(model, prompts, 2)  # warm: plans, first launches
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        res = generate(model, prompts, GEN)
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        routes = {"engine": [], "torch": []}
        with _routing("record", routes["engine"]):
            logits = _prefill_logits(torch, model, prompts)
    toks = res["tokens"]
    if tuple(toks.shape) != (BATCH, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"serve_moe: bad tokens {tuple(toks.shape)}")
    # One prefill and GEN - 1 decode steps: three expert GEMMs a layer a
    # forward on the fused grouped kernel, four attention projections a
    # layer and the read-out on the GEMM kernels, flash once a layer in the
    # prefill.
    want = {"grouped_fused": GEN * 3 * L, "engine_grouped_launches":
            GEN * 3 * L, "grouped_padded": 0, "grouped_bwd": 0,
            "engine_gemm_calls": GEN * (4 * L + 1), "flash_fwd_fused": L,
            "engine_flash_launches": L}
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    bad.update(_gemm_launch_gap(counts))
    # The torch backend with the engine's routing replayed (gated), and
    # with its own (reported, with the routings that flipped).
    with use(backend="torch", device="cuda"):
        with _routing("replay", routes["engine"]):
            ref = _prefill_logits(torch, model, prompts)
        with _routing("record", routes["torch"]):
            ref_free = _prefill_logits(torch, model, prompts)
    gap, spread, rel = _logit_gap(torch, logits, ref)
    free_gap, _, free_rel = _logit_gap(torch, logits, ref_free)
    routing = _flips(routes["engine"], routes["torch"])
    layer0 = _moe_layer0(torch, model, prompts)
    emit(phase="serve_moe", model=cfg.name, params=cfg.param_count(),
         reduced=_moe_reduced(L), d_model=cfg.d_model,
         experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
         d_ff=cfg.d_ff, batch=BATCH, prompt=PROMPT, new_tokens=GEN,
         fused="auto", init_seconds=init_s,
         prefill_seconds=res["prefill_seconds"],
         prefill_tokens_per_s=BATCH * PROMPT / res["prefill_seconds"],
         decode_seconds=res["decode_seconds"],
         decode_tokens_per_s=BATCH * (GEN - 1) / res["decode_seconds"],
         peak_memory_bytes=peak, launches=counts, expected=want,
         routing="the torch backend replays the engine's",
         logits_vs_torch_max_abs=gap, logits_spread=spread, logits_rel=rel,
         logits_bound=LOGIT_BOUND, logits_vs_torch_free_routing_max_abs=
         free_gap, logits_rel_free_routing=free_rel, **routing,
         layer0_moe=layer0)
    if bad:
        fail(f"serve_moe launch counts (got, want): {bad}")
    if layer0["y_mismatches"]:
        fail(f"serve_moe: layer 0's MoE differs between the backends in "
             f"{layer0['y_mismatches']} elements (atol=rtol="
             f"{layer0['tolerance']})")
    if rel > LOGIT_BOUND:
        fail(f"serve_moe: engine vs torch prefill logits differ by "
             f"{rel:.4f} of their range (bound {LOGIT_BOUND})")
    phase_profile(torch, model, prompts, name="serve_moe_profile")
    return counts, model, prompts, logits


def phase_serve_moe_off(torch, model, prompts, logits_auto):
    """The same model and prompts under fused="off": every grouped GEMM on
    the pad/scatter kernel."""
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    L = model.cfg.num_layers
    steps = 4
    with use(backend="engine", fused="off", device="cuda"):
        _reset_counts()
        res = generate(model, prompts, steps)
        counts = _read_counts()
        logits = _prefill_logits(torch, model, prompts)
    want = {"grouped_padded": steps * 3 * L, "grouped_fused": 0,
            "engine_grouped_launches": steps * 3 * L}
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    gap, _, rel = _logit_gap(torch, logits, logits_auto)
    emit(phase="serve_moe_off", fused="off", new_tokens=steps,
         prefill_seconds=res["prefill_seconds"],
         decode_seconds=res["decode_seconds"], launches=counts,
         expected=want, logits_vs_auto_max_abs=gap, logits_rel=rel,
         logits_differing=int((logits != logits_auto).sum()),
         logits_count=logits.numel(), logits_bound=LOGIT_BOUND)
    if bad:
        fail(f"serve_moe_off launch counts (got, want): {bad}")
    if rel > LOGIT_BOUND:
        fail(f"serve_moe fused='off' logits differ from fused='auto' by "
             f"{rel:.4f}")
    return counts


# ---------------------------------------------------------------------------
# The quant axis and the §IV-C two-pass GEMM
# ---------------------------------------------------------------------------

def phase_gemm_transpose(torch):
    """§IV-C: ``gemm(a, b, layout="nt")`` (B's contraction dim strided, the
    kernel reads it in place) against the two passes ``gemm(a,
    transpose(b))`` (a blocked panel transpose, then an nn GEMM), at
    fig89's shape and at Qwen3-0.6B's tied read-out over a 1,024-token
    prefill.  Gated: the outputs agree at the dtype's tolerance and each
    two-pass call launches exactly one transpose.  The counted run is one
    call of each form per case; the timings come after it."""
    from repro_torch.core import use
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.transpose import transpose
    from repro_torch.kernels.transpose import kernel as tk
    cases = [("fig89", 256, 256, 512, "float32", 20),
             ("qwen3_readout", 1024, 151936, 1024, "bfloat16", 3)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    ops = []
    with use(backend="engine", fused="auto", device="cuda"):
        for label, m, n, k, dname, iters in cases:
            dt = getattr(torch, dname)
            a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            b = (torch.randn((n, k), generator=gen, device="cuda")
                 * k ** -0.5).to(dt)
            gemm(a, b, layout="nt")  # warm: plans, tile tables
            gemm(a, transpose(b))
            ops.append((label, m, n, k, dname, iters, a, b))
        torch.cuda.synchronize()
        _reset_counts()
        outs = []
        for label, m, n, k, dname, iters, a, b in ops:
            n0 = tk.LAUNCHES["transpose"]
            two = gemm(a, transpose(b))
            per_call = tk.LAUNCHES["transpose"] - n0
            one = gemm(a, b, layout="nt")
            outs.append((one, two, per_call))
        torch.cuda.synchronize()
        counts = _read_counts()
        rows = []
        for (label, m, n, k, dname, iters, a, b), (one, two, per_call) in \
                zip(ops, outs):
            max_abs, rel, nbad, tol = compare(torch, two, one, dname)
            row = dict(phase="gemm_transpose", case=label, shape=[m, n, k],
                       dtype=dname, max_abs_err=max_abs, max_rel_err=rel,
                       tolerance=tol, mismatches=nbad,
                       transpose_launches_per_call=per_call,
                       nt_ms=time_ms(torch, lambda: gemm(a, b, layout="nt"),
                                     iters),
                       two_pass_ms=time_ms(
                           torch, lambda: gemm(a, transpose(b)), iters),
                       transpose_ms=time_ms(torch, lambda: transpose(b),
                                            iters))
            row["two_pass_over_nt"] = row["two_pass_ms"] / row["nt_ms"]
            emit(**row)
            rows.append(row)
    emit(phase="gemm_transpose_counts", launches=counts)
    for row in rows:
        if row["mismatches"]:
            fail(f"gemm_transpose {row['case']}: two-pass and nt outputs "
                 f"differ in {row['mismatches']} elements")
        if row["transpose_launches_per_call"] != 1:
            fail(f"gemm_transpose {row['case']}: "
                 f"{row['transpose_launches_per_call']} transpose launches "
                 f"in one two-pass call")
    if counts["transpose"] != len(cases) or \
            counts["engine_transpose_launches"] != len(cases):
        fail(f"gemm_transpose launch counts: {counts}")
    return counts


def phase_continuous_quant(torch, model, wide):
    """Qwen3-0.6B at full width with W8A16 weights (``quantize_model``,
    in place: the wide projections are dropped) and KV-int8 pools
    (``PageSpec(kv_quant="int8")``) through the continuous-batching engine
    on the continuous phase's trace, counted alone, as the reference's
    ``benchmarks/quant_gemm.py`` serve phase builds it.  Gated: every
    request finishes, and the quant launches are what the code implies
    (every projection of every forward on gemm_quant, every layer of every
    decode step on flash_decode_int8); then, outside the count, one decode
    step's logits under the engine against the torch backend with the
    same weights and pools.  The share of tokens equal to the wide run's
    is printed, not gated."""
    from repro_torch.core import use
    from repro_torch.models.attention import PageSpec
    from repro_torch.optim.compression import quantize_model
    from repro_torch.runtime.batching import (ContinuousBatchingEngine,
                                              poisson_trace)
    cfg = model.cfg
    L = cfg.num_layers
    wide_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    t0 = time.perf_counter()
    quantize_model(model, "w8a16")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    trace = dict(CONT_TRACE)
    reqs = poisson_trace(num_requests=trace["num_requests"],
                         rate=trace["rate"], prompt_lens=trace["prompt_len"],
                         max_new=trace["max_new"],
                         vocab_size=cfg.vocab_size, seed=trace["seed"])
    spec = PageSpec(CONT_PAGES, CONT_PAGE, CONT_BLOCKS, kv_quant="int8")
    with use(backend="engine", fused="auto", device="cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        serving = ContinuousBatchingEngine(model, num_slots=CONT_SLOTS,
                                           spec=spec)
        res = serving.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        peak_mem = torch.cuda.max_memory_allocated()
    m = res["metrics"]
    steps = m["decode_steps"]
    admissions = len(reqs) + m["evictions"]
    forwards = admissions + steps
    want = {"gemm_quant": forwards * 7 * L,
            "flash_decode_int8": steps * L, "flash_decode": 0,
            "engine_decode_launches": steps * L,
            "engine_gemm_calls": forwards * (7 * L + 1),
            "flash_fwd_fused": admissions * L}
    match = total = 0
    for r in reqs:
        q, w = res["outputs"].get(r.rid), wide["outputs"].get(r.rid)
        if q is not None and w is not None:
            match += int((q == w).sum())
            total += len(w)
    wm = wide["metrics"]
    quant_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters()) + sum(
        mod.w.q.numel() + mod.w.scale.numel() * 4
        for mod in model.modules() if hasattr(mod, "w")
        and not isinstance(mod.w, torch.nn.Parameter))
    emit(phase="continuous_quant", model=cfg.name, weights="w8a16",
         kv_quant="int8", slots=CONT_SLOTS, num_pages=CONT_PAGES,
         page_size=CONT_PAGE, max_blocks=CONT_BLOCKS, trace=CONT_TRACE,
         quantize_seconds=quantize_s, weight_bytes_wide=wide_bytes,
         weight_bytes_quantized=quant_bytes,
         tokens_per_s=m["tokens_per_s"], total_tokens=m["total_tokens"],
         p50_token_latency_s=m["p50_token_latency_s"],
         p99_token_latency_s=m["p99_token_latency_s"],
         phase_seconds=m["phase_seconds"], decode_steps=steps,
         evictions=m["evictions"], run_seconds=m["wall_seconds"],
         wall_seconds=wall, peak_memory_bytes=peak_mem,
         wide_tokens_per_s=wm["tokens_per_s"],
         wide_p50_token_latency_s=wm["p50_token_latency_s"],
         wide_p99_token_latency_s=wm["p99_token_latency_s"],
         wide_decode_steps=wm["decode_steps"],
         wide_evictions=wm["evictions"],
         token_match_frac=match / max(total, 1), launches=counts,
         expected=want, requests=len(reqs))
    for r in reqs:
        out = res["outputs"].get(r.rid)
        if out is None or len(out) != r.max_new or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            fail(f"continuous_quant: request {r.rid} did not finish with "
                 f"{r.max_new} in-vocab tokens: {out}")
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if counts["gemm_fused"] + counts["gemm_region"] + counts["gemm_quant"] \
            != counts["engine_gemm_launches"]:
        bad["gemm kernels vs engine"] = (
            counts["gemm_fused"] + counts["gemm_region"]
            + counts["gemm_quant"], counts["engine_gemm_launches"])
    if bad:
        fail(f"continuous_quant launch counts (got, want): {bad}")
    serving.pool.check_invariants([0] * CONT_SLOTS)
    _continuous_quant_logits(torch, model, reqs)
    return counts


def _continuous_quant_logits(torch, model, reqs):
    """Prefill the first 8 requests into int8 pools and run one paged
    decode step from the same weights and pools under the engine and under
    the torch backend (the pools restored between): the logits of every
    slot within LOGIT_BOUND of their range."""
    from repro_torch.core import use
    from repro_torch.models.attention import PageSpec
    from repro_torch.runtime.pages import (PagePool, init_serving_cache,
                                           refresh_tables, write_prefill)
    from repro_torch.runtime.steps import (make_paged_serve_step,
                                           make_prefill_step)
    spec = PageSpec(CONT_SLOTS * CONT_BLOCKS, CONT_PAGE, CONT_BLOCKS,
                    kv_quant="int8")
    with use(backend="engine", fused="auto", device="cuda"), torch.no_grad():
        pool = PagePool(spec, CONT_SLOTS)
        cache = init_serving_cache(model, CONT_SLOTS, spec)
        toks = []
        for slot, r in enumerate(reqs[:CONT_SLOTS]):
            L = len(r.prompt)
            prompt = torch.from_numpy(r.prompt).long().cuda()[None]
            logits, dcache = make_prefill_step(model, L)({"tokens": prompt})
            write_prefill(cache, dcache, slot=slot, length=L,
                          page_ids=pool.grow(slot, L), page_size=CONT_PAGE)
            pool.grow(slot, L + 1)
            toks.append(torch.argmax(logits, -1))
        refresh_tables(cache, pool.tables)
        tokens = torch.stack(toks)
        positions = torch.tensor([[len(r.prompt)] for r in
                                  reqs[:CONT_SLOTS]], dtype=torch.int32,
                                 device="cuda")
        saved = [tuple(t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale))
                 for c in cache]
        eng, _, _ = model.apply(tokens, positions=positions, cache=cache)
        for c, (k, v, ks, vs) in zip(cache, saved):
            for dst, src in ((c.k, k), (c.v, v), (c.k_scale, ks),
                             (c.v_scale, vs)):
                dst.copy_(src)
    with use(backend="torch", device="cuda"), torch.no_grad():
        ref, _, _ = model.apply(tokens, positions=positions, cache=cache)
    gaps = [_logit_gap(torch, eng[s, -1].float(), ref[s, -1].float())[2]
            for s in range(CONT_SLOTS)]
    emit(phase="continuous_quant_logits", slots=CONT_SLOTS, rel_gaps=gaps,
         bound=LOGIT_BOUND)
    if max(gaps) > LOGIT_BOUND:
        fail(f"continuous_quant: engine vs torch decode logits differ by "
             f"{max(gaps):.4f} of their range (bound {LOGIT_BOUND})")
    # Two engine decode steps over the 8 slots, profiled (the pools have
    # room for them: each slot grew by one position past its prompt and
    # the steps rewrite that position).
    step_fn = make_paged_serve_step(model)
    active = torch.ones(CONT_SLOTS, dtype=torch.bool, device="cuda")
    lengths = positions[:, 0].long()

    def step():
        with use(backend="engine", fused="auto", device="cuda"):
            step_fn(cache, tokens, lengths, active)

    emit(phase="continuous_quant_profile", decode_steps=2,
         active_slots=CONT_SLOTS, **_device_profile(torch, step, 2))


def phase_serve_moe_quant(torch, model, prompts, logits_wide):
    """phi3.5-moe-42b at 4 layers under ``use(quant="int8")`` through
    ``generate``, counted alone: every expert GEMM quantizes its rows and
    its bank at dispatch and runs grouped_quant (three a layer a forward).
    The torch backend's expert einsums stay wide, as the reference's XLA
    path does: its logits, with the engine's routing replayed, are gated
    at LOGIT_BOUND; the gap to the wide serve_moe logits is printed."""
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    cfg = model.cfg
    L = cfg.num_layers
    with use(backend="engine", fused="auto", device="cuda", quant="int8"):
        generate(model, prompts, 2)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        res = generate(model, prompts, GEN)
        counts = _read_counts()
        peak_mem = torch.cuda.max_memory_allocated()
        routes = []
        with _routing("record", routes):
            logits = _prefill_logits(torch, model, prompts)
    want = {"grouped_quant": GEN * 3 * L, "engine_grouped_launches":
            GEN * 3 * L, "grouped_fused": 0, "grouped_padded": 0,
            "engine_gemm_calls": GEN * (4 * L + 1), "flash_fwd_fused": L,
            "gemm_quant": 0}
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    with use(backend="torch", device="cuda", quant="int8"), \
            _routing("replay", routes):
        ref = _prefill_logits(torch, model, prompts)
    gap, spread, rel = _logit_gap(torch, logits, ref)
    wide_gap, _, wide_rel = _logit_gap(torch, logits, logits_wide)
    toks = res["tokens"]
    emit(phase="serve_moe_quant", model=cfg.name, reduced=_moe_reduced(L),
         quant="int8", batch=BATCH, prompt=PROMPT, new_tokens=GEN,
         prefill_seconds=res["prefill_seconds"],
         prefill_tokens_per_s=BATCH * PROMPT / res["prefill_seconds"],
         decode_seconds=res["decode_seconds"],
         decode_tokens_per_s=BATCH * (GEN - 1) / res["decode_seconds"],
         peak_memory_bytes=peak_mem, launches=counts, expected=want,
         routing="the torch backend replays the engine's",
         logits_vs_torch_max_abs=gap, logits_spread=spread, logits_rel=rel,
         logits_bound=LOGIT_BOUND, logits_vs_wide_max_abs=wide_gap,
         logits_vs_wide_rel=wide_rel)
    if tuple(toks.shape) != (BATCH, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"serve_moe_quant: bad tokens {tuple(toks.shape)}")
    if bad:
        fail(f"serve_moe_quant launch counts (got, want): {bad}")
    if rel > LOGIT_BOUND:
        fail(f"serve_moe_quant: engine vs torch prefill logits differ by "
             f"{rel:.4f} of their range (bound {LOGIT_BOUND})")
    with use(quant="int8"):
        phase_profile(torch, model, prompts, name="serve_moe_quant_profile")
    return counts


# ---------------------------------------------------------------------------
# The remaining decoder configurations at full width
# ---------------------------------------------------------------------------

def _draw_leaves(torch, model, seed: int = 2):
    """Redraw every bias and norm leaf of ``model`` from a seeded generator:
    biases N(0, 0.2^2), norm scales 1 + N(0, 0.2^2).  ``Init`` gives zeros
    and ones, under which a bias or norm wired wrong would not show.  The
    same seed gives the same values, so both backends see one model."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    drawn = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "b" or ("norm" in name and leaf in ("scale", "bias")):
                noise = 0.2 * torch.randn(p.shape, generator=gen,
                                          device=p.device)
                p.copy_(noise + (1.0 if leaf == "scale" else 0.0))
                drawn.append(name)
    return drawn


def _arch_cfg(arch, layers, training):
    """``get_config(arch)`` cut to ``layers`` (None: full depth) and the
    cut's ``reduced`` entry: what the card could not hold at full depth --
    the fp32 masters, or training's 16 bytes a parameter (masters,
    gradients, AdamW's m and v) before activations."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg, None
    cut = dataclasses.replace(cfg, num_layers=layers)
    per, what = (16, "training state") if training else (4, "fp32 masters")
    return cut, {"num_layers": f"{cfg.num_layers} -> {layers}",
                 "why": f"{what}: {per * cfg.param_count() / 1e9:.1f} GB at "
                        f"{cfg.num_layers} layers, "
                        f"{per * cut.param_count() / 1e9:.1f} GB at {layers}"}


@contextlib.contextmanager
def _block0_input(model):
    """The first input of block 0 (the scaled embedding), caught by a
    forward pre-hook."""
    caught = []
    hook = model.blocks[0].register_forward_pre_hook(
        lambda _, args: caught.append(args[0].detach().clone())
        if not caught else None)
    try:
        yield caught
    finally:
        hook.remove()


def phase_serve_arch(torch, arch, tag, layers, keep=False):
    """One of the remaining decoder configurations at its published widths
    (depth cut to ``layers`` where the card cannot hold more) through
    ``generate`` (engine, fused="auto"), with its bias and norm leaves
    drawn (:func:`_draw_leaves`), counted alone, with its gates: launch
    counts from the model's structure; prefill logits against the torch
    backend (a mixture of experts replays the engine's routing; the
    free-routing gap beside it); block 0's input against the table's rows
    (times sqrt(d) under ``embed_scale``); logits within the final softcap.
    The attention softcap keeps grok-1's attention in plain torch in both
    backends, as in the reference: no flash launch; sliding-window layers
    (recurrentgemma's "local") stay off the flash kernels too.  With
    ``keep`` returns (counts, model)."""
    from repro_torch.core import use
    from repro_torch.launch.serve import generate
    from repro_torch.models import LanguageModel
    name = f"serve_{tag}"
    cfg, reduced = _arch_cfg(arch, layers, training=False)
    L, moe = cfg.num_layers, bool(cfg.num_experts)
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device="cuda", seed=0)
    drawn = _draw_leaves(torch, model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(torch, cfg.vocab_size)
    routes = {"engine": [], "torch": []}
    with use(backend="engine", fused="auto", device="cuda"):
        generate(model, prompts, 2)  # warm: plans, first launches
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        res = generate(model, prompts, GEN)
        counts = _read_counts()
        peak_mem = torch.cuda.max_memory_allocated()
        with _routing("record" if moe else None, routes["engine"]), \
                _block0_input(model) as x0:
            logits = _prefill_logits(torch, model, prompts)
    toks = res["tokens"]
    if tuple(toks.shape) != (BATCH, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{name}: bad tokens {tuple(toks.shape)}")
    # One prefill and GEN - 1 decode steps; flash in the prefill only.
    flash = _flash_calls(cfg)
    want = {**_gemm_want(cfg, GEN), "flash_fwd_fused": flash,
            "flash_fwd_dense": 0, "engine_flash_launches": flash,
            "flash_bwd_fused": 0}
    if moe:
        experts = GEN * (3 if cfg.mlp_gated else 2) * L
        want.update(grouped_fused=experts, engine_grouped_launches=experts,
                    grouped_padded=0, grouped_bwd=0)
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    bad.update(_gemm_launch_gap(counts))
    with use(backend="torch", device="cuda"):
        with _routing("replay" if moe else None, routes["engine"]):
            ref = _prefill_logits(torch, model, prompts)
        if moe:
            with _routing("record", routes["torch"]):
                ref_free = _prefill_logits(torch, model, prompts)
    gap, spread, rel = _logit_gap(torch, logits, ref)
    extra = {}
    if moe:
        free_gap, _, free_rel = _logit_gap(torch, logits, ref_free)
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        extra = dict(routing="the torch backend replays the engine's",
                     logits_vs_torch_free_routing_max_abs=free_gap,
                     logits_rel_free_routing=free_rel,
                     **_flips(routes["engine"], routes["torch"]),
                     bank_cast_bytes_per_layer_call=(
                         3 if cfg.mlp_gated else 2) * e * d * f * 2)
    # Block 0's input: the table's rows in bf16, times sqrt(d) under
    # embed_scale, within three bf16 roundings (the row, the scale, the
    # product: 2^-9 relative each).
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else 1.0
    want_x0 = model.embed.table[prompts].float() * scale
    embed_err = ((x0[0].float() - want_x0).abs()
                 / want_x0.abs().clamp_min(1e-30)).max().item()
    logit_max = logits.abs().max().item()
    cap = cfg.final_logit_softcap
    emit(phase=name, model=cfg.name, params=cfg.param_count(),
         fp32_master_bytes=4 * cfg.param_count(), reduced=reduced,
         layers=L, d_model=cfg.d_model, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, norm=cfg.norm_type,
         experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
         drawn_leaves=len(drawn), batch=BATCH, prompt=PROMPT,
         new_tokens=GEN, fused="auto", init_seconds=init_s,
         attention="plain torch: attn_logit_softcap keeps it off the flash "
                   "kernels, as in the reference" if cfg.attn_logit_softcap
         else "plain torch: sliding-window layers stay off the flash "
              "kernels, as in the reference" if not _flash_calls(cfg)
         else "flash_fwd_fused",
         block_pattern=cfg.block_pattern,
         prefill_seconds=res["prefill_seconds"],
         prefill_tokens_per_s=BATCH * PROMPT / res["prefill_seconds"],
         decode_seconds=res["decode_seconds"],
         decode_tokens_per_s=BATCH * (GEN - 1) / res["decode_seconds"],
         peak_memory_bytes=peak_mem, launches=counts, expected=want,
         logits_vs_torch_max_abs=gap, logits_spread=spread, logits_rel=rel,
         logits_bound=LOGIT_BOUND, embed_scale=cfg.embed_scale,
         embed_max_rel_err=embed_err, embed_bound=EMBED_TOL,
         final_logit_softcap=cap, logits_max_abs=logit_max, **extra)
    if bad:
        fail(f"{name} launch counts (got, want): {bad}")
    if not len(drawn):
        fail(f"{name}: no bias or norm leaf drawn")
    if not embed_err <= EMBED_TOL:
        fail(f"{name}: block 0's input is off the scaled table by "
             f"{embed_err:.4g} (bound {EMBED_TOL})")
    if cap and not logit_max <= cap:
        fail(f"{name}: logits reach {logit_max} past the softcap {cap}")
    if rel > LOGIT_BOUND:
        fail(f"{name}: engine vs torch prefill logits differ by {rel:.4f} "
             f"of their range (bound {LOGIT_BOUND})")
    phase_profile(torch, model, prompts, name=f"{name}_profile")
    return (counts, model) if keep else counts


def phase_arch_runs(torch):
    """Every run of ``ARCH_RUNS``: each configuration served, then trained
    where the card holds its training state.  Returns each path's
    counts."""
    counts = {}
    for arch, tag, serve_layers, train_layers in ARCH_RUNS:
        counts[f"serve_{tag}"] = phase_serve_arch(torch, arch, tag,
                                                  serve_layers)
        torch.cuda.empty_cache()
        if train_layers == 0:
            continue
        cfg, reduced = _arch_cfg(arch, train_layers, training=True)
        state_gb = 16 * cfg.param_count() / 1e9
        counts[f"train_{tag}"] = phase_train(
            torch, name=f"train_{tag}", cfg=cfg, draw=True, resume=False,
            extra={"reduced": reduced, "checkpoint": (
                f"none: two checkpoints of the {0.75 * state_gb:.1f} GB of "
                f"parameters and moments would pass the {CKPT_WRITE_GIB} GiB "
                f"the card's machine lets a run write")})
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# recurrentgemma-9b: RG-LRU blocks and sliding-window attention
# ---------------------------------------------------------------------------

def _opt_state_bytes(state):
    """The optimizer state's bytes by kind: the first moment, the factored
    second moment's rows and columns, the unfactored second moment, beside
    AdamW's 8 bytes a parameter (fp32 m and v)."""
    from repro_torch.optim import is_factored_leaf
    m = sum(t.numel() * t.element_size() for t in state.get("m", {}).values())
    rc = unf = params = 0
    for name, v in state["v"].items():
        if is_factored_leaf(v):
            rc += sum(t.numel() * t.element_size() for t in v.values())
            params += v["r"].numel() * v["c"].shape[-1]
        else:
            unf += v.numel() * v.element_size()
            params += v.numel()
    return dict(m_bytes=m, m_dtype=str(next(iter(state["m"].values())).dtype)
                if state.get("m") else None,
                factored_v_rc_bytes=rc, unfactored_v_bytes=unf,
                total_bytes=m + rc + unf, params=params,
                adamw_bytes=8 * params,
                bytes_per_param=(m + rc + unf) / params)


def phase_serve_rg_ring(torch, model):
    """recurrentgemma-9b at batch 1 with a RG_RING_PROMPT-token prompt,
    longer than window + Q_CHUNK: the prefill's local layers take the
    sliding path and write only their ring's last ``window`` positions;
    then GEN decode steps wrap the rings.  Gated: after the prefill every
    ring holds exactly the last ``window`` positions, and each decode step's
    logits are within LOGIT_BOUND of their range of a full forward over
    the prompt and the tokens generated so far (the card's form of the
    reference's ring-buffer test)."""
    from repro_torch.core import use
    from repro_torch.models.attention import KVCache
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step
    cfg = model.cfg
    P, W = RG_RING_PROMPT, cfg.attn_window
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, P), generator=gen,
                           device="cuda")
    with use(backend="engine", fused="auto", device="cuda"), torch.no_grad():
        prefill = make_prefill_step(model, P + GEN)
        serve = make_serve_step(model)
        prefill({"tokens": prompt})  # warm: plans, first launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = prefill({"tokens": prompt})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        rings = [c for c in cache if isinstance(c, KVCache)]
        ring_ok = all(c.k.shape[1] == W and sorted(c.pos[0].tolist())
                      == list(range(P - W, P)) for c in rings)
        tok = torch.argmax(logits, -1)[:, None]
        seq, pos, gaps, decode_s = torch.cat([prompt, tok], 1), \
            torch.tensor(P, dtype=torch.int32, device="cuda"), [], 0.0
        for _ in range(GEN):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step, cache, pos = serve(cache, tok, pos)
            torch.cuda.synchronize()
            decode_s += time.perf_counter() - t0
            full, _, _ = model.apply(seq, logits_mode="last")
            gaps.append(_logit_gap(torch, step[0].float(),
                                   full[0, -1].float())[2])
            tok = torch.argmax(step, -1)[:, None]
            seq = torch.cat([seq, tok], 1)
        peak_mem = torch.cuda.max_memory_allocated()
    emit(phase="serve_rg_ring", model=cfg.name, layers=cfg.num_layers,
         batch=1, prompt=P, window=W, decode_steps=GEN, local_rings=len(rings),
         rings_hold_last_window=ring_ok, prefill_seconds=prefill_s,
         prefill_tokens_per_s=P / prefill_s, decode_seconds=decode_s,
         decode_tokens_per_s=GEN / decode_s, peak_memory_bytes=peak_mem,
         rel_gaps_vs_full_forward=gaps, bound=LOGIT_BOUND)
    if not (rings and ring_ok):
        fail(f"serve_rg_ring: the {len(rings)} rings do not hold the last "
             f"{W} of {P} positions after the prefill")
    if max(gaps) > LOGIT_BOUND:
        fail(f"serve_rg_ring: decode on the rings differs from the full "
             f"forward by {max(gaps):.4f} of the logits' range (bound "
             f"{LOGIT_BOUND})")


def phase_continuous_rg(torch, model):
    """recurrentgemma-9b at full depth (``serve_rg``'s model) through
    continuous batching: the continuous trace's 12 requests (rate 1, prompts
    of 96-256 tokens) with RG_CONT_LONG_RIDS' prompts replaced by
    RG_CONT_LONG tokens (past the window: the rings wrap in the prefill
    and a re-admitted one re-slots them), 16 new tokens each, 8 slots over
    RG_CONT_PAGES pages of 16 (small enough that growth evicts).  Gated as
    ``continuous`` (requests, evictions, pages, launches: each forward the
    model's GEMM calls, fused or, for a ragged prefill, in regions; no
    flash or decode-kernel launch), the first paged
    decode step's logits against the static dense path, and one
    all-inactive step leaving every ring and state bit-equal.
    ``identical_requests`` is printed."""
    import numpy as np
    from repro_torch.runtime.batching import poisson_trace
    cfg = model.cfg
    reqs = poisson_trace(num_requests=RG_CONT_TRACE["num_requests"],
                         rate=RG_CONT_TRACE["rate"],
                         prompt_lens=RG_CONT_TRACE["prompt_len"],
                         max_new=RG_CONT_TRACE["max_new"],
                         vocab_size=cfg.vocab_size,
                         seed=RG_CONT_TRACE["seed"])
    rng = np.random.default_rng(5)
    for rid in RG_CONT_LONG_RIDS:
        reqs[rid].prompt = rng.integers(0, cfg.vocab_size, RG_CONT_LONG) \
            .astype(np.int32)
    run_kw = dict(num_slots=CONT_SLOTS, num_pages=RG_CONT_PAGES,
                  page_size=CONT_PAGE, max_blocks=RG_CONT_BLOCKS)

    def want(admissions, steps):
        # (GEMM calls only: a ragged prefill's plans take kernel 2, two
        # region launches a call, which the engine's launch count checks)
        return {"engine_gemm_calls":
                _gemm_want(cfg, admissions + steps)["engine_gemm_calls"],
                "flash_fwd_fused": 0, "flash_fwd_dense": 0,
                "engine_flash_launches": 0, "flash_decode": 0,
                "engine_decode_launches": 0}

    counts, res, _ = _continuous_gated(torch, model, "continuous_rg", run_kw,
                                       want, reqs=reqs)
    _continuous_logits(torch, model, res["trace"], name="continuous_rg",
                       blocks=RG_CONT_BLOCKS, state_check=True)
    return counts


def phase_rglru_scan(torch):
    """The RG-LRU scan (plain torch, no kernel replaces it: the reference's
    ``lax.associative_scan``) timed alone with CUDA events at its main-path
    shapes: the serving prefill (4 x 256), the long prompt (1 x 3,072)
    and training (2 x 3,072, forward and backward), width 4,096; and per
    forward of the model (26 "rec" layers of 38; 4 of train_rg's 6)."""
    from repro_torch.models.rglru import _rglru_scan
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {}
    for label, b, s, grad, layers in (
            ("prefill_4x256", BATCH, PROMPT, False, 26),
            ("ring_prompt_1x3072", 1, RG_RING_PROMPT, False, 26),
            ("train_2x3072_fwd_bwd", RG_TRAIN_BATCH, RG_TRAIN_SEQ, True,
             2 * RG_TRAIN_GROUPS)):
        xs = torch.randn((b, s, 4096), generator=gen, device="cuda")
        la = -torch.rand((b, s, 4096), generator=gen, device="cuda") * 0.1
        h0 = torch.randn((b, 4096), generator=gen, device="cuda")
        if grad:
            xs.requires_grad_(True)
            la.requires_grad_(True)

            def fn():
                h = _rglru_scan(xs, la, h0)
                torch.autograd.grad(h.sum(), (xs, la))
        else:
            def fn():
                with torch.no_grad():
                    _rglru_scan(xs, la, h0)
        ms = time_ms(torch, fn, 5)
        rows[label] = dict(ms=ms, rec_layers=layers, ms_per_forward=ms * layers)
        del xs, la, h0
    emit(phase="rglru_scan", **rows)


def phase_rg_runs(torch):
    """recurrentgemma-9b served (``serve_rg``, full depth), on the ring
    (``serve_rg_ring``), continuously (``continuous_rg``), its scan timed,
    then trained (``train_rg``).  Returns each path's counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.optim import scalable_adamw, warmup_cosine
    counts = {}
    counts["serve_rg"], model = phase_serve_arch(torch, RG_ARCH, "rg", None,
                                                 keep=True)
    phase_serve_rg_ring(torch, model)
    counts["continuous_rg"] = phase_continuous_rg(torch, model)
    del model
    torch.cuda.empty_cache()
    phase_rglru_scan(torch)
    torch.cuda.empty_cache()
    full = get_config(RG_ARCH)
    layers = RG_TRAIN_GROUPS * len(full.block_pattern)
    cfg = dataclasses.replace(full, num_layers=layers)
    opt = scalable_adamw(warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10,
                                       TRAIN_STEPS))
    counts["train_rg"] = phase_train(
        torch, name="train_rg", cfg=cfg, seq=RG_TRAIN_SEQ,
        batch=RG_TRAIN_BATCH, opt=opt, draw=True, resume=False,
        extra={"reduced": {
            "num_layers": f"{full.num_layers} -> {layers}",
            "why": f"training state: {full.param_count() / 1e9:.2f} B "
                   f"parameters at {full.num_layers} layers, "
                   f"{cfg.param_count() / 1e9:.2f} B at {layers} (whole "
                   f"pattern groups); fp32 masters and gradients, the "
                   f"clipped gradients, the bf16 first moment and the "
                   f"update's temporaries on the 1.05 B-row tables"},
               "optimizer": "scalable_adamw (bf16 m, factored v): the "
                            "reference's pick_optimizer past 10 B parameters",
               "checkpoint": "none"})
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# internvl2-1b (vision prefix) and seamless-m4t-large-v2 (encoder-decoder)
# ---------------------------------------------------------------------------

def _segment(torch, fn):
    """``fn()`` counted alone (its launches) and timed on the host clock
    around work that ends in a synchronise: (result, counts, seconds)."""
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, _read_counts(), time.perf_counter() - t0


def _decode_loop(torch, serve, cache, tok, pos, steps, enc_out=None):
    """``steps`` greedy decode steps; returns the tokens (b, steps + 1)
    with ``tok`` first."""
    out = [tok]
    for _ in range(steps):
        logits, cache, pos = serve(cache, tok, pos, enc_out)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    return torch.cat(out, 1)


def phase_serve_internvl(torch):
    """internvl2-1b at full width and depth (24 layers), every bias and norm
    leaf drawn: a prefill of BATCH x (VL_IMAGE image tokens from seeded
    1024-d features + PROMPT text tokens) through ``make_prefill_step``
    with ``modality_feats`` (cache of VL_IMAGE + PROMPT + GEN rows), then
    GEN - 1 decode steps from position VL_IMAGE + PROMPT.  Gated: the
    prefill's last-position logits within LOGIT_BOUND of the torch
    backend's; one flash launch a layer in the prefill, none in decode;
    GEMM calls as the structure implies (the projector's two, seven a
    layer and the tied read-out a forward), every one on the GEMM kernels.
    Returns (counts, model)."""
    from repro_torch.configs import get_config
    from repro_torch.core import use
    from repro_torch.models import LanguageModel
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step
    cfg = get_config(VL_ARCH)
    L, n_mod = cfg.num_layers, VL_IMAGE
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device="cuda", seed=0)
    drawn = _draw_leaves(torch, model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(torch, cfg.vocab_size)
    feats = _features(torch, cfg, BATCH, n_mod, seed=7)
    batch = {"tokens": prompts, "modality_feats": feats}
    cap = n_mod + PROMPT + GEN
    start = torch.tensor(n_mod + PROMPT, dtype=torch.int32, device="cuda")
    with use(backend="engine", fused="auto", device="cuda"), torch.no_grad():
        prefill, serve = make_prefill_step(model, cap), make_serve_step(model)
        logits, cache = prefill(batch)  # warm: plans, first launches
        serve(cache, torch.argmax(logits, -1)[:, None], start)
        del cache
        torch.cuda.reset_peak_memory_stats()
        (logits, cache), c_pre, prefill_s = _segment(
            torch, lambda: prefill(batch))
        tok = torch.argmax(logits, -1)[:, None]
        toks, c_dec, decode_s = _segment(
            torch, lambda: _decode_loop(torch, serve, cache, tok, start,
                                        GEN - 1))
        peak_mem = torch.cuda.max_memory_allocated()
        logits = logits.float()
    with use(backend="torch", device="cuda"), torch.no_grad():
        ref, _ = make_prefill_step(model, cap)(batch)
    gap, spread, rel = _logit_gap(torch, logits, ref.float())
    per_fwd = 7 * L + 1
    want_pre = {"engine_gemm_calls": 2 + per_fwd, "flash_fwd_fused": L,
                "engine_flash_launches": L, "flash_fwd_dense": 0}
    want_dec = {"engine_gemm_calls": (GEN - 1) * per_fwd,
                "flash_fwd_fused": 0, "engine_flash_launches": 0,
                "flash_fwd_dense": 0}
    bad = {f"prefill {k}": (c_pre[k], n) for k, n in want_pre.items()
           if c_pre[k] != n}
    bad.update({f"decode {k}": (c_dec[k], n) for k, n in want_dec.items()
                if c_dec[k] != n})
    bad.update(_gemm_launch_gap(c_pre))
    bad.update(_gemm_launch_gap(c_dec))
    counts = _add_counts(c_pre, c_dec)
    emit(phase="serve_internvl", model=cfg.name, params=cfg.param_count(),
         layers=L, d_model=cfg.d_model, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
         vocab=cfg.vocab_size, drawn_leaves=len(drawn), batch=BATCH,
         image_tokens=n_mod, feature_dim=cfg.modality_dim, prompt=PROMPT,
         new_tokens=GEN, capacity=cap, fused="auto", init_seconds=init_s,
         prefill_seconds=prefill_s,
         prefill_tokens_per_s=BATCH * (n_mod + PROMPT) / prefill_s,
         decode_seconds=decode_s,
         decode_tokens_per_s=BATCH * (GEN - 1) / decode_s,
         peak_memory_bytes=peak_mem, launches_prefill=c_pre,
         launches_decode=c_dec, expected_prefill=want_pre,
         expected_decode=want_dec, logits_vs_torch_max_abs=gap,
         logits_spread=spread, logits_rel=rel, logits_bound=LOGIT_BOUND)
    if tuple(toks.shape) != (BATCH, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"serve_internvl: bad tokens {tuple(toks.shape)}")
    if bad:
        fail(f"serve_internvl launch counts (got, want): {bad}")
    if rel > LOGIT_BOUND:
        fail(f"serve_internvl: engine vs torch prefill logits differ by "
             f"{rel:.4f} of their range (bound {LOGIT_BOUND})")
    return counts, model


def phase_continuous_internvl(torch, model):
    """internvl2-1b (``serve_internvl``'s model) text-only through
    continuous batching, as the reference serves it: the continuous trace
    over 8 slots and 96 pages of 16, every decode step on ``flash_decode``
    (GQA group 7, route A).  Gated as ``continuous`` (requests, evictions,
    pages, launches: seven GEMMs a layer and the read-out a forward, flash
    once a layer a prefill, flash_decode once a layer a step) and the first
    paged decode step's logits against the static dense path."""
    cfg = model.cfg
    L = cfg.num_layers
    run_kw = dict(num_slots=CONT_SLOTS, num_pages=CONT_PAGES,
                  page_size=CONT_PAGE, max_blocks=CONT_BLOCKS, **CONT_TRACE)

    def want(admissions, steps):
        return {"flash_decode": steps * L,
                "engine_decode_launches": steps * L,
                "engine_gemm_calls": (admissions + steps) * (7 * L + 1),
                "flash_fwd_fused": admissions * L,
                "engine_flash_launches": admissions * L,
                "flash_fwd_dense": 0}

    counts, res, _ = _continuous_gated(torch, model, "continuous_internvl",
                                       run_kw, want)
    _continuous_logits(torch, model, res["trace"],
                       name="continuous_internvl")
    return counts


def phase_serve_seamless(torch):
    """seamless-m4t-large-v2 at full width and depth (24 encoder and 24
    decoder layers), every bias and norm leaf drawn: ``encode`` of BATCH x
    ED_FRAMES seeded 160-d frames (timed on its own), a prefill of a
    PROMPT-token decoder prompt with ``enc_out``, then GEN - 1 decode steps
    passing ``enc_out`` again.  Gated: the prefill's last-position logits
    (encoder and prefill together) within LOGIT_BOUND of the torch
    backend's; flash launches 24 in the encoder (non-causal), 48 in the
    prefill (causal self-, non-causal cross-attention) and 24 a decode step
    (cross-attention, one query row), every one on route A; GEMM calls as
    the structure implies (the adapter and six a layer in the encoder, ten
    a decoder layer and the read-out a forward), every one on the GEMM
    kernels."""
    from repro_torch.configs import get_config
    from repro_torch.core import use
    from repro_torch.models import EncoderDecoderModel
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step
    cfg = get_config(ED_ARCH)
    L, E = cfg.num_layers, cfg.num_encoder_layers
    t0 = time.perf_counter()
    model = EncoderDecoderModel(cfg, device="cuda", seed=0)
    drawn = _draw_leaves(torch, model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(torch, cfg.vocab_size)
    feats = _features(torch, cfg, BATCH, ED_FRAMES, seed=8)
    start = torch.tensor(PROMPT, dtype=torch.int32, device="cuda")
    with use(backend="engine", fused="auto", device="cuda"), torch.no_grad():
        prefill = make_prefill_step(model, PROMPT + GEN)
        serve = make_serve_step(model)
        enc = model.encode(feats)  # warm: plans, first launches
        logits, cache = prefill({"tokens": prompts, "enc_out": enc})
        serve(cache, torch.argmax(logits, -1)[:, None], start, enc)
        del enc, cache
        torch.cuda.reset_peak_memory_stats()
        enc, c_enc, encode_s = _segment(torch, lambda: model.encode(feats))
        (logits, cache), c_pre, prefill_s = _segment(
            torch, lambda: prefill({"tokens": prompts, "enc_out": enc}))
        tok = torch.argmax(logits, -1)[:, None]
        toks, c_dec, decode_s = _segment(
            torch, lambda: _decode_loop(torch, serve, cache, tok, start,
                                        GEN - 1, enc))
        peak_mem = torch.cuda.max_memory_allocated()
        logits = logits.float()
    with use(backend="torch", device="cuda"), torch.no_grad():
        ref, _ = make_prefill_step(model, PROMPT + GEN)(
            {"tokens": prompts, "modality_feats": feats})
    gap, spread, rel = _logit_gap(torch, logits, ref.float())
    mlp = 3 if cfg.mlp_gated else 2
    dec_fwd = L * (8 + mlp) + 1
    want = {"encode": {"engine_gemm_calls": 1 + E * (4 + mlp),
                       "flash_fwd_fused": E, "flash_route_A": E},
            "prefill": {"engine_gemm_calls": dec_fwd,
                        "flash_fwd_fused": 2 * L, "flash_route_A": 2 * L},
            "decode": {"engine_gemm_calls": (GEN - 1) * dec_fwd,
                       "flash_fwd_fused": (GEN - 1) * L,
                       "flash_route_A": (GEN - 1) * L}}
    got = {"encode": c_enc, "prefill": c_pre, "decode": c_dec}
    bad = {}
    for seg, w in want.items():
        c = got[seg]
        w = dict(w, flash_fwd_dense=0,
                 engine_flash_launches=w["flash_fwd_fused"])
        want[seg] = w
        bad.update({f"{seg} {k}": (c[k], n) for k, n in w.items()
                    if c[k] != n})
        bad.update({f"{seg} {k}": v for k, v in _gemm_launch_gap(c).items()})
    counts = _add_counts(c_enc, c_pre, c_dec)
    emit(phase="serve_seamless", model=cfg.name, params=cfg.param_count(),
         layers=L, encoder_layers=E, d_model=cfg.d_model,
         heads=cfg.num_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, norm=cfg.norm_type, drawn_leaves=len(drawn),
         batch=BATCH, frames=ED_FRAMES, feature_dim=cfg.modality_dim,
         prompt=PROMPT, new_tokens=GEN, fused="auto", init_seconds=init_s,
         encode_seconds=encode_s,
         encode_frames_per_s=BATCH * ED_FRAMES / encode_s,
         prefill_seconds=prefill_s,
         prefill_tokens_per_s=BATCH * PROMPT / prefill_s,
         decode_seconds=decode_s,
         decode_tokens_per_s=BATCH * (GEN - 1) / decode_s,
         peak_memory_bytes=peak_mem,
         launches={seg: got[seg] for seg in want}, expected=want,
         logits_vs_torch_max_abs=gap, logits_spread=spread, logits_rel=rel,
         logits_bound=LOGIT_BOUND)
    if tuple(toks.shape) != (BATCH, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"serve_seamless: bad tokens {tuple(toks.shape)}")
    if bad:
        fail(f"serve_seamless launch counts (got, want): {bad}")
    if rel > LOGIT_BOUND:
        fail(f"serve_seamless: engine vs torch prefill logits differ by "
             f"{rel:.4f} of their range (bound {LOGIT_BOUND})")
    return counts


def phase_vl_ed_runs(torch):
    """internvl2-1b served (``serve_internvl``) and served continuously
    (``continuous_internvl``), seamless-m4t-large-v2 served
    (``serve_seamless``), then both trained at full depth (``train_internvl``:
    8 x (256 image + 128 text) positions, the loss on the text;
    ``train_seamless``: 8 x (512 frames, 128 tokens)), with remat, AdamW
    and no checkpoint.  Returns each path's counts."""
    from repro_torch.configs import get_config
    counts = {}
    counts["serve_internvl"], model = phase_serve_internvl(torch)
    counts["continuous_internvl"] = phase_continuous_internvl(torch, model)
    del model
    torch.cuda.empty_cache()
    counts["serve_seamless"] = phase_serve_seamless(torch)
    torch.cuda.empty_cache()
    for arch, tag, rows in ((VL_ARCH, "internvl", VL_IMAGE),
                            (ED_ARCH, "seamless", ED_TRAIN_FRAMES)):
        cfg = get_config(arch)
        counts[f"train_{tag}"] = phase_train(
            torch, name=f"train_{tag}", cfg=cfg, draw=True, resume=False,
            feats=rows, extra={"checkpoint": "none"})
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# The mesh axis: expert parallelism over two ranks on the one card
# ---------------------------------------------------------------------------

# phi3.5-moe-42b at full width cut to 2 layers: each rank holds the whole
# model's fp32 masters (11.4 GB), as the port keeps parameters replicated.
MESH_LAYERS, MESH_GEN = 2, 4
# Host-clock repeats of each pinned expert-parallel call (after one
# checked call).
MESH_REPS = 3
MESH_TIMEOUT_S = 300


def _mesh_ep_cases(cfg):
    """(label, capacity rows, K, N) of the MoE layer's up projection at the
    serving prompt and at one decode step: the layer's own shapes."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    out = []
    for label, t in (("prefill", BATCH * PROMPT), ("decode", BATCH)):
        g = min(cfg.moe_group, max(1, t // 32))
        while t % g:
            g -= 1
        cap = max(8, -(-int(cfg.capacity_factor * g * k / e) // 8) * 8)
        out.append((label, t // g, cap))
    return out


def _mesh_ep(torch, model, world):
    """Each pinned strategy of the expert-parallel grouped GEMM at the MoE
    layer's shapes (layer 0's up bank), on this rank."""
    import dataclasses
    from repro_torch.core import (H100_SXM, GroupedGemmDescriptor, MeshSpec,
                                  engine, mesh_comm_events,
                                  mesh_comm_seconds, mesh_local_desc,
                                  plan_grouped)
    from repro_torch.kernels.grouped_gemm.ops import _ref_ep
    cfg = model.cfg
    w = model.blocks[0].ff.w_up.w.detach().to(torch.bfloat16)
    e, d, f = w.shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for label, n, cap in _mesh_ep_cases(cfg):
        x4 = torch.randn((n, e, cap, d), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        desc = GroupedGemmDescriptor(t=n * e * cap, k=d, n=f, num_experts=e,
                                     dtype="bfloat16",
                                     mesh=MeshSpec("model", world))
        want = _ref_ep(None, x4, w)
        row = {"case": label, "capacity_rows": n * e * cap, "k": d, "n": f,
               "pick": plan_grouped(desc, H100_SXM).comm, "strategies": {}}
        outs = {}
        for comm in ("gathered", "distributed"):
            pin = dataclasses.replace(
                plan_grouped(mesh_local_desc(desc, comm), H100_SXM),
                desc=desc, comm=comm)
            _reset_counts()
            y = engine.dispatch(desc, x4, w, None, plan=pin)
            torch.cuda.synchronize()
            counts = _read_counts()
            st = engine.stats()["grouped_gemm"]
            outs[comm] = y
            ms = []
            for _ in range(MESH_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.dispatch(desc, x4, w, None, plan=pin)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            max_abs, rel, nbad, tol = compare(torch, y, want, "bfloat16")
            events = mesh_comm_events(desc, comm)
            row["strategies"][comm] = {
                "ms_host": ms, "grouped_fused": counts["grouped_fused"],
                "engine_launches": st["launches"],
                "comm_bytes": st["comm_bytes"],
                "collective_launches": st["collective_launches"],
                "events": [list(ev) for ev in events],
                "predicted_s": pin.predicted_seconds(H100_SXM),
                "predicted_comm_s": mesh_comm_seconds(desc, H100_SXM, comm),
                "local_t": pin.local_desc.t,
                "local_experts": pin.local_desc.num_experts,
                "tile": [pin.bm, pin.bk, pin.bn],
                "routes": {r: counts.get(f"grouped_route_{r}", 0)
                           for r in ("A", "C", "fp32")},
                "max_abs_err": max_abs, "rel_err": rel, "mismatches": nbad,
                "tolerance": tol, "sum": float(y.double().sum())}
        row["strategies_bit_equal"] = bool(
            torch.equal(outs["gathered"], outs["distributed"]))
        rows.append(row)
    return rows


def _mesh_rank(rank, world, out_dir, prompts_path, with_ep):
    """One rank of the mesh phase (spawned): the model from seed 0, the
    expert-parallel calls (``with_ep``), then the mesh serve, counted
    alone; its results saved for the parent."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from repro_torch.core import engine, use
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import LanguageModel
    from repro_torch.runtime.shardlib import use_mesh
    mesh = make_test_mesh(1, world, device="cuda")
    model = LanguageModel(_moe_cfg(MESH_LAYERS), device="cuda", seed=0)
    prompts = torch.load(prompts_path).to("cuda")
    out = {"backend": dist.get_backend()}
    with use_mesh(mesh), use(backend="engine", fused="auto", device="cuda"):
        if with_ep:
            out["ep"] = _mesh_ep(torch, model, world)
        generate(model, prompts, 2)  # warm: plans, first launches
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        _reset_counts()
        res = generate(model, prompts, MESH_GEN)
        counts = _read_counts()
        st = engine.stats()["grouped_gemm"]
        counts["comm_bytes"] = st["comm_bytes"]
        counts["collective_launches"] = st["collective_launches"]
        out["logits"] = _prefill_logits(torch, model, prompts).cpu()
    out.update(tokens=res["tokens"].cpu(), counts=counts,
               prefill_seconds=res["prefill_seconds"],
               decode_seconds=res["decode_seconds"],
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def _mesh_serve_want(cfg, world):
    """Per rank, per forward: three expert-parallel calls a layer, each one
    grouped_fused launch; the planner's picks under H100_SXM at the
    prefill and decode rows give the counted collectives and bytes."""
    from repro_torch.core import (H100_SXM, GroupedGemmDescriptor, MeshSpec,
                                  mesh_comm_events, plan_grouped)
    L, e, d, f = cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff
    want = {"grouped_fused": MESH_GEN * 3 * L,
            "engine_grouped_launches": MESH_GEN * 3 * L,
            "comm_bytes": 0, "collective_launches": 0}
    picks = {}
    for (label, n, cap), forwards in zip(_mesh_ep_cases(cfg),
                                         (1, MESH_GEN - 1)):
        for k, nn, epi in ((d, f, None), (d, f, cfg.mlp_act), (f, d, None)):
            desc = GroupedGemmDescriptor(
                t=n * e * cap, k=k, n=nn, num_experts=e, dtype="bfloat16",
                epilogue=epi, mesh=MeshSpec("model", world))
            comm = plan_grouped(desc, H100_SXM).comm
            picks[f"{label}_{k}x{nn}_{epi}"] = comm
            if comm == "distributed":
                events = mesh_comm_events(desc, comm)
                want["comm_bytes"] += forwards * L * sum(b for _, b in events)
                want["collective_launches"] += forwards * L * len(events)
    return want, picks


def phase_dryrun(torch, results):
    """The dry-run held to the card (``launch/dryrun.py::card_check``): the
    byte count of full-width qwen3-0.6b against the allocator, its meta
    trace against a prefill and a train step run on the card, and
    ``kernel_roofline`` beside :func:`bound` for every kernel row."""
    from repro_torch.core import use
    from repro_torch.launch.dryrun import card_check
    _reset_counts()
    with use(backend="engine", fused="auto", device="cuda"):
        report = card_check("cuda", results, (CONT_PAGES, CONT_BLOCKS))
    counts = _read_counts()
    emit(phase="dryrun", **report)
    bad = report["failures"] + [f"{k}: {v}" for k, v in
                                _gemm_launch_gap(counts).items()]
    bad += [f"{k} never launched" for k in ("flash_fwd_fused",
                                            "flash_bwd_fused")
            if not counts[k]]
    if not counts["gemm_fused"] + counts["gemm_region"]:
        bad.append("no GEMM launched")
    if bad:
        fail(f"dryrun: {bad}")
    return counts


def phase_mesh(torch):
    """phi3.5-moe-42b (full width, 2 layers) served in one process, then by
    two gloo ranks on a (data 1, model 2) mesh and by one NCCL rank on a
    (1, 1) mesh; the expert-parallel calls of the two ranks with it."""
    import tempfile
    from repro_torch.core import use
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.serve import generate
    from repro_torch.models import LanguageModel
    cfg = _moe_cfg(MESH_LAYERS)
    model = LanguageModel(cfg, device="cuda", seed=0)
    prompts = _prompts(torch, cfg.vocab_size)
    with use(backend="engine", fused="auto", device="cuda"):
        generate(model, prompts, 2)
        one = generate(model, prompts, MESH_GEN)
        one_logits = _prefill_logits(torch, model, prompts)
    one_tokens = one["tokens"].cpu()
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        prompts_path = f"{tmp}/prompts.pt"
        torch.save(prompts.cpu(), prompts_path)
        runs = {}
        for tag, world, backend, with_ep in (("gloo", 2, "gloo", True),
                                             ("nccl", 1, "nccl", False)):
            d = f"{tmp}/{tag}"
            t0 = time.perf_counter()
            run_ranks(_mesh_rank, world, (d, prompts_path, with_ep),
                      store_dir=d, device="cuda", backend=backend,
                      timeout_s=MESH_TIMEOUT_S)
            runs[tag] = {"seconds": time.perf_counter() - t0,
                         "ranks": [torch.load(f"{d}/rank{r}.pt")
                                   for r in range(world)]}
    want, picks = _mesh_serve_want(cfg, 2)
    bad, serve = {}, []
    for r, res in enumerate(runs["gloo"]["ranks"]):
        c = res["counts"]
        for k, n in want.items():
            if c[k] != n:
                bad[f"rank{r} {k}"] = (c[k], n)
        gap, spread, rel = _logit_gap(torch, res["logits"].cuda(),
                                      one_logits)
        if rel > LOGIT_BOUND:
            bad[f"rank{r} logits_rel"] = (rel, LOGIT_BOUND)
        toks = res["tokens"]
        if tuple(toks.shape) != (BATCH, MESH_GEN):
            bad[f"rank{r} tokens"] = tuple(toks.shape)
        serve.append({"rank": r, "backend": res["backend"],
                      "prefill_seconds": res["prefill_seconds"],
                      "decode_tokens_per_s": BATCH * (MESH_GEN - 1)
                      / res["decode_seconds"],
                      "peak_memory_bytes": res["peak_memory_bytes"],
                      "logits_vs_one_process_max_abs": gap,
                      "logits_spread": spread, "logits_rel": rel,
                      "tokens_equal_one_process":
                      int((toks == one_tokens).sum()),
                      "launches": {k: c[k] for k in (
                          "grouped_fused", "engine_grouped_launches",
                          "comm_bytes", "collective_launches", "gemm_fused",
                          "gemm_region", "flash_fwd_fused",
                          "grouped_route_A")}})
        for row in res["ep"]:
            s = row["strategies"]
            for comm, v in s.items():
                events = v["events"] if comm == "distributed" else []
                want_c = (1, sum(b for _, b in events), len(events))
                got_c = (v["grouped_fused"], v["comm_bytes"],
                         v["collective_launches"])
                if got_c != want_c or v["engine_launches"] != 1:
                    bad[f"rank{r} ep {row['case']} {comm}"] = (got_c, want_c)
                if v["mismatches"]:
                    bad[f"rank{r} ep {row['case']} {comm} vs plain"] = \
                        v["mismatches"]
            if not row["strategies_bit_equal"]:
                bad[f"rank{r} ep {row['case']}"] = "strategies differ"
    r0, r1 = runs["gloo"]["ranks"]
    ranks_agree = bool(torch.equal(r0["tokens"], r1["tokens"])) and all(
        a["strategies"][c]["sum"] == b["strategies"][c]["sum"]
        for a, b in zip(r0["ep"], r1["ep"]) for c in a["strategies"])
    if not ranks_agree:
        bad["ranks"] = "the two ranks' tokens or expert outputs differ"
    nc = runs["nccl"]["ranks"][0]
    nccl_equal = bool(torch.equal(nc["logits"], one_logits.cpu())) and \
        bool(torch.equal(nc["tokens"], one_tokens))
    if not nccl_equal:
        bad["nccl"] = "the one-rank NCCL mesh serve is not bit-equal"
    emit(phase="mesh", model=cfg.name, reduced={
             "num_layers": f"32 -> {MESH_LAYERS}",
             "why": "every rank holds the replicated fp32 masters (11.4 GB "
                    "a rank at 2 layers)"},
         mesh={"data": 1, "model": 2}, transport="gloo (through the host)",
         batch=BATCH, prompt=PROMPT, new_tokens=MESH_GEN,
         ep=r0["ep"], ep_rank1=r1["ep"], serve=serve, expected=want,
         planner_picks=picks, ranks_agree=ranks_agree,
         one_process_tokens=one_tokens.tolist(),
         nccl={"backend": nc["backend"], "mesh": {"data": 1, "model": 1},
               "bit_equal_no_mesh": nccl_equal,
               "prefill_seconds": nc["prefill_seconds"],
               "decode_tokens_per_s": BATCH * (MESH_GEN - 1)
               / nc["decode_seconds"]},
         seconds={k: v["seconds"] for k, v in runs.items()})
    if bad:
        fail(f"mesh: {bad}")
    return {"mesh": _add_counts(*(res["counts"] for res
                                  in runs["gloo"]["ranks"])),
            "mesh_nccl": nc["counts"]}


if __name__ == "__main__":
    sys.exit(main())
