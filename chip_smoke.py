#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmspeculativesampling_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --only mellum   # the build and phase 11 alone

Phases, each printing lines before the last:
  1. device: the card's name and power limit (nvidia-smi), torch/CUDA
     versions, and the build of every kernel source (nvcc processes started
     together) with its ptxas register report (B1 must not spill);
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card, through its public wrapper, at the shapes of both paths, with
     the tolerance stated; kernel, plain, library-yardstick and bound times.
     B1 (W8A16 matmul) at the single-stream and the serving M and at
     ragged shapes (M not a multiple of 8, a K tail, N=48), B2
     (contiguous flash-decode), B3 (paged flash-decode) at the serving
     shapes, several page sizes, multi-page shuffled tables and a sentinel
     row, lengths on split and page edges, per-row lengths with partly
     empty splits, tree bias, G=4 x S_new=25, and B2 at the tree/beam
     path's shapes (tree verify B 1/4 x 17 tokens under ancestor biases,
     multi's B=4 x 5, the beam draft's B=4 x Hkv 6) and at the remaining
     algorithms' (MJSD's default B=8 x 5, BiLD's check 1 x 11, random
     beam's B=4 x 1), B1 also at their M (11, 40, 4); each attention case
     also bit-identical across a repeat and between the forward's
     transposed views and contiguous copies, one launch a call, the ticket
     counters back at 0; timing rows at the verify, AR-decode and draft
     shapes of every path. At the OPT path's shapes: B1 at the target's
     5120x5120, 5120x20480 and 20480x5120 (M 1, 9, 64, 144) and the draft's
     640x640, 640x2560, 2560x640 (M 1, 2, 16, 64), fc2 at M=512 under the
     batch-invariant plan; B2 at Hkv 40 x 9, 1 x 17 under an ancestor bias
     and Hkv 5 x 1/2; B3 at B=16 x Hkv 40 x 9 and Hkv 5; the dense tied
     head's bf16 product (fp32 sums) against the fp32 product. At the
     prefix cache's extend windows: B3 at KB=8 x Hkv 40 (and the draft's 6)
     x S_new=32 over a 512-position prefix whose 4 pages all 8 tables
     share, own pages after it, sentinel tails, and a row the extend has
     exhausted (an all-sentinel table), under the batch-invariant plan (a
     row alone gives the bits it gets among 8), with its time beside the
     plan from B=1; B1 per target forward at M=32 and 256 under both plans.
     At the SARATHI and adaptive-gamma shapes: B1 per target forward at
     M = 80, 108, 204, 272 (16 x 5, 12 x 9, 12 x 17, 16 x 17); B3 at the
     adaptive arms' verifies (B=16 x Hkv 40 x S_new 5 / 17), the cold mix's
     (B=12 x 9 / 17 with a staged row at length 0 and one mid-prompt) and
     the draft-only windows (KB 1 / 8 x Hkv 6 x 32, batch-invariant). At the
     slotted engine's shapes: B2 at B=16 slots over S_max 256 with per-slot
     lengths that differ row to row (an idle slot at 1, split edges, one at
     256 - 9), the target verify (Hkv 40 x S_new 9, int8 KV) and the draft
     steps (Hkv 6 x S_new 1 / 2, dense), with the grid's block count. At
     one tp=2 rank's shard shapes: B1 at q/k/v and gate/up with half their
     columns, o and down with half their rows and fp32 output (the
     row-parallel partials), the 16000-row head (M 1, 25, 144; draft M 1, 2,
     16); B2 at Hkv 20 x 25 and 1, the draft's Hkv 3 x 1 / 2 and the slotted
     16 x Hkv 20 x 9 (int8 KV); B3 at 16 x Hkv 20 x 9 (int8 pool) and Hkv 3.
     At one dp=2 rank's shapes: B1 at the target's projections and head at
     M = 8 x 9 = 72 and the draft's at M = 8; B2 at 8 slots x Hkv 40 x 9
     (int8 KV, S_max 256); B3 at B=8 x Hkv 40 x 9 over a 16-block int8 pool
     with tables of P = 16;
  3. forward: logits of a 2-layer, full-width (5120) int8 Llama slice on the
     card with the kernels vs the same weights on the CPU with the plain
     versions, through a contiguous cache and through a paged int8 pool
     (per-row lengths, rollbacks, a sentinel row, a page crossing), and a
     tree forward (4 rows x 17 tokens, positions and ancestor mask) whose
     cache ``compact_tree_paths`` compacts alike on the card and the CPU;
     the same for a 2-layer 5120-wide (ffn 20480) int8 OPT slice
     (contiguous, paged int8 pool, a 4 x 17 tree block with shared
     positions); the Llama slice with fp8 e4m3 weights (the plain fp8
     product, never B1); and a loader round trip: a 2-layer 5120-wide bf16
     OPT written under HF names as safetensors, loaded onto the card by
     ``load_pretrained``, leaves and logits bit-equal to what was written;
     and prefix reuse: a 576-token prompt prefilled at once (the miss path)
     against 512 prefilled tokens plus two 32-token extend windows (the hit
     path), the last logits and the suffix's KV within 3e-2; and SARATHI's
     staged prefill: a 960-token prompt prefilled at once against the same
     prompt staged through 120 verify windows of 9 tokens (B1 planned from
     M, B3 over the pages), the last logits and the prompt's KV within 3e-2;
  4. single-stream path: the 13B-shaped int8 target + 768-wide int8 draft,
     born on the card from a seed; autoregressive and speculative decoding
     with bench.py's settings (64-token prompt, 128 new tokens, gamma=24,
     top_k=20, top_p=0.9, eos=2), each step a replayed CUDA graph (the
     device loop, ``engine/device_loop.py``); then the device loop itself:
     a fresh capture of each step timed, and for 3 seeds the replayed
     generation equal to an eager run of the same step function, ids and
     details, spec and AR; B1 and B2 inside both graphs (the replay
     accounting), B3 not; spec acc_rate >= 0.6; then the device loops of
     multi iid, multi-beam, MJSD and random beam at the tree path's
     settings (gamma 4, 4 candidates or beams, 64 new tokens): a capture
     of each step timed with its launches a replay (B1, B2 > 0, B3 0) and
     the memory its entry holds, and for 3 seeds the replayed run equal to
     an eager one, ids and details; then a replaced ``lm_head`` must give
     a new capture (ids equal to a fresh dict's), and a copy of the pair,
     dropped after spec and multi runs, must free its memory and entries
     without ``release_graphs()``; then the device loops of beam v1, beam
     v2 (extra_sample_cnt 1) and BiLD (gamma 10, fallback 0.6, rollback
     5.0) at the same settings, each replay launching exactly the B1 and B2
     calls of its forwards (a tree step 341 / 48, a BiLD macro-step 431 /
     60), replays equal to eager runs over 3 seeds, and the decodes BiLD's
     macro-steps masked;
  5. paged serving path: the same pair through ``PagedEngine`` behind
     ``BatchedInferenceServer`` with the settings of ``scripts/bench_paged.py
     --config 13b --kv_int8 --steps_per_sync 8`` (16 rows, 32 int8 blocks of
     128, gamma=8), two traffic mixes (uniform, with one request over HTTP
     on a loopback port, and mixed) from concurrent client threads, on
     demand (the default), and the mixed mix once reserving each request's
     worst case; then 8 requests through the engine as a burst and one at a
     time, whose output ids must be equal. Then, driving the engine
     directly as scripts/bench_paged.py does: the shared_prefix mix (24 x
     576-token prompts sharing a 512-token system prompt, 48 new tokens)
     with the prefix cache and without it (only the first request may miss;
     B3 must run in the extend windows), the longgen mix (24 x (64, 256))
     at overcommit 1.0 (no preemption) and 2.0 (preemptions; how many
     preempted requests come out bit-identical is reported), every pool
     ending at available_blocks == num_blocks; and 8 prefix-cache hits
     admitted together and one at a time, whose ids must be equal. Then
     SARATHI's A/B (scripts/bench_chunked_prefill.py's 13B settings: 12
     rows, gamma 8, steps_per_sync 4, a closed loop of 36 requests, every
     5th a 960-token cold prompt; extend windows of 32) monolithic, chunked
     and chunked at prefill_extra 8, each after ``warmup()``: tok/s, the
     gaps between chunk reads (steady and across an admission), the cold
     requests' TTFT, ``interleaved_chunks`` (0 monolithic, fewer at
     prefill_extra 8), B3 in the draft-only windows; and fixed gamma 8
     against ``adaptive_gamma=(4, 8, 16)`` on 96 uniform requests (16 rows
     of two pages): the ramp must run every arm; ``adaptive_stats()``. Then
     the slotted path: the same pair through ``ContinuousBatchingEngine``
     behind ``BatchedInferenceServer`` with ``scripts/bench_serving.py
     --config 13b --max_total_len 256 --gamma 8 --num_slots 16 --kv_int8
     --steps_per_sync 8``'s settings (16 slots x 256 positions, int8 KV
     target), after ``warmup()``: 24 x (64, 64) from threads and one over
     HTTP; tok/s, TTFT, chunks and host ms a chunk beside the paged uniform
     mix; acc_rate >= 0.6, B1 and B2 launched and B3 not; then 8 requests
     as a burst and one at a time, whose ids must be equal;
     then the serving pipeline: the paged uniform mix and the slotted mix
     (25 x (64, 64)) each as the pipelined ``run_until_idle`` over
     replayed steps and as a synchronous ``step()`` loop of eager steps,
     untraced and traced: every request's ids, acc_len and counts equal
     across the four; tok/s, idle share, the host gap between dispatches,
     masked steps a chunk and the harvests the device stayed busy across;
  6. tree/beam path: the same pair through multi iid (width 4), beam v1 and
     beam v2 (4 beams) with ``scripts/bench_beam.py --thirteen_b``'s
     settings (gamma 4, 64 new tokens); B2 must serve every tree verify,
     multi's acc_rate must reach 0.6 and v2's mean acc_len exceed 1; the
     time of the row gathers (``select_rows``) a step.
  7. remaining algorithms: the same pair and settings through multi's
     'beam' strategy (width 4), MJSD (width = num_beams = 4, accept_thres
     0.1), BiLD (gamma 10, fallback 0.6, rollback 5.0), the cache-less
     speculative v2 and random-width beam (4 beams); B2 must serve every
     target forward but v2's, and never run in v2 (each v2 forward
     recomputes the whole prefix); v2's acc_rate must reach 0.6, and MJSD
     must accept every draft at accept_thres 0 and none at 1.5. Then spec
     v2's device loop: the capture of its step timed, a replay launching
     exactly B1 4 x 15 + 281 = 341 and no B2 or B3, and for 3 seeds the
     replayed run equal to an eager one, ids and details, with ms a step,
     tok/s and the idle share of a traced replayed run.
  8. the OPT path, after the Llama pair is freed: the OPT-13B int8 target
     + 640-wide draft (``synthetic_opt_pair_int8_small_draft``, tied bf16
     heads) with ``scripts/bench_opt13b.py``'s settings: AR and speculative
     decoding at gamma 8 (128 new tokens), beam v2 (4 beams, gamma 4, 64
     new tokens) and the uniform serving mix through ``PagedEngine``
     behind ``BatchedInferenceServer``; B2 in every layer of every
     short-block target forward, spec and serving acc_rate >= 0.6, v2 mean
     acc_len > 1, the pool ending free.
     Each path's launch counters are set to 0 just before it and read just
     after; each kernel of a path must have run on it, B2 must not run on
     the paged path and B3 not on the others. Before the OPT pair, the
     tensor-parallel path: two ranks on this one card over gloo
     (``parallel/launch.py``; NCCL refuses two ranks on a device) build the
     13B-int8 pair in turn and keep their tp=2 shards; the gathered logits
     of a 64-token prefill and a 25-token verify within 3e-2 of the
     unsharded forward's, ``norm_logits_topk_tp`` equal to the dense sparse
     path, the gloo all_reduce time, then (launches counted from here) spec
     (128 tokens, gamma 24) and AR (32) with ``tp_mesh``,
     ``PagedMultiHostDriver`` over ``PagedEngine(mesh=)`` on the uniform
     mix and ``MultiHostDriver`` over ``ContinuousBatchingEngine(mesh=)``
     on 16 x (64, 64): tokens and completions identical on both ranks,
     acc_rate >= 0.6, B1, B2 and B3 launched. Its tok/s are one card's
     work split over two processes plus gloo's host transport, not TP
     speed. Then the data-parallel path: two ranks at dp=2 x tp=1 (each
     holding the whole pair, params being replicated over dp) and four at
     dp=2 x tp=2 on the card over gloo: a rank's 8 rows' paged verify
     logits within 3e-2 of the dp=1 forward over all 16;
     ``PagedMultiHostDriver`` over ``PagedEngine(mesh=)`` (8 rows and 16
     int8 blocks a rank) on the uniform mix, ``MultiHostDriver`` over
     ``ContinuousBatchingEngine(mesh=)`` (8 slots a rank) on 25 x (64,
     64), and at dp=2 x tp=2 the paged driver on 16 x (64, 32): every
     rank's completions and gathered token rows identical, every block id
     a rank's tables hold within its 16-block half, every shard's pool
     ending free, acc_rate >= 0.6, B1 and B3 launched on the paged runs
     (B2 not), B1 and B2 on the slotted run (B3 not). Not dp speed
     either;
  9. the evaluation harness, through ``evalx.harness.main`` at its own
     full-width synthetic pair (Llama 2048 x 16, vocab 32000, bf16): every
     method over 2 prompts of 64 tokens with 64 new tokens and the score,
     the speculative block under ``--profile_dir`` (a Chrome trace must be
     written), and autoregressive blocks until one runs over 2 s (its
     energy from nvidia-smi must be > 0); every block makes tokens and
     carries the JAX harness's keys, B2 runs and B3 not;
 10. the trained pair: ``train_tiny_pair()`` at its defaults on the card,
     both losses below 0.75x their start, the trained draft accepted at
     >= 0.55 and an untrained one at <= 0.20 (6 prompts x 48 tokens, gamma
     4), the int8 target (B1) within 0.15 of its acc_rate and 0.35 of its
     score, get_score of spec minus AR over 16 prompts; one forward on the
     card against the CPU (fp32, 1e-4); B2 and B1 raise under grad. Phase 2
     holds B2 at both pairs' shapes and B1 at the int8 target's;
 11. Mellum 2 (JetBrains' Mellum2-12B-A2.5B, the benchmark's pair at its
     published widths): B4 (the grouped W8A16 expert product and its
     alignment) at the cell's verify (320 tokens x top-8 of 64 experts,
     tile 64) and at a 2,048-token prefill (tile 128), and B3 with the
     1,024-position window at the verify (64 rows x Hkv 4 x G 8 x 5, int8
     pool, lengths 600-2,800), each against its plain version on the same
     inputs; then the model through ``PagedEngine`` (8 requests of
     576-2,000 tokens, 48 new, the cell's engine settings at 8 rows) with
     the counters set to 0 before it: B1, B3 and B4 launch, B2 never, two
     B4 products a launch of the alignment;
 12. a ``{"kernels": [...]}`` line (each kernel also with its numbers at the
     OPT path's shapes, under "opt", and B1 and B3 at the extend window's,
     under "extend", at the cold mix's 12 x 17 verify, under "sarathi",
     B1 and B2 at the slotted verify, under "slotted", B2 at the harness
     verify, under "harness", and B1 and B2 at the trained pair's verify,
     under "trained_pair", and all three at one tp=2 rank's shapes, under
     "tp", and at one dp=2 rank's, under "dp"; ``launches_by_path`` has the
     device loop's replayed runs under "device_loop", spec v2's under
     "v2_loop" and the pipelined serving runs' under "serving_pipeline";
     B3 at Mellum's window under "mellum"; B4 its own entry, its prefill
     numbers under "prefill"),
     the card line again, and as the last
     line ``{"ok": true, "device": {...}}``. Each phase prints its seconds.
Any failed check raises: the script exits non-zero and prints no result.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12    # H100 SXM dense bf16 tensor rate
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 rate outside the tensor cores
L2_FLUSH_BYTES = 128 << 20  # rotate through this many bytes of operands: > 50 MB L2

# main-path shapes (bench.py settings on the 13B-int8 pair)
TARGET_SHAPES = [(5120, 5120, 4), (5120, 13824, 2), (13824, 5120, 1)]  # (K, N, per layer)
DRAFT_SHAPES = [(768, 768, 4), (768, 3072, 2), (3072, 768, 1)]
VOCAB = 32000
TARGET_M = (64, 25, 1)  # prefill, verify (gamma+1), AR decode
DRAFT_M = (64, 2, 1)    # prefill, first draft step, draft decode
S_MAX = 256             # aligned_total(64 + 128 + 25)
GAMMA = 24
REPS = 3                # timed reps of each method on the main path, after one warm-up
# paged serving (scripts/bench_paged.py --config 13b --kv_int8 --steps_per_sync 8)
ROWS, BLOCKS, PAGE, SERVE_GAMMA, SYNC = 16, 32, 128, 8, 8
SERVE_TARGET_M = (ROWS * (SERVE_GAMMA + 1), 8 * 64)  # verify, prefill of 8 prompts of 64
SERVE_DRAFT_M = (ROWS, 2 * ROWS, 8 * 64)             # draft step, two-token re-feed, prefill
# tree/beam path (scripts/bench_beam.py --thirteen_b settings): gamma 4, 4
# beams or candidates, 64 new tokens
TREE_GAMMA, TREE_BEAMS, TREE_NEW = 4, 4, 64
TREE_TOKENS = TREE_GAMMA * TREE_BEAMS + 1                 # anchor + 16 nodes
TREE_TARGET_M = (TREE_TOKENS, TREE_BEAMS * (TREE_GAMMA + 1), TREE_BEAMS * TREE_TOKENS,
                 TREE_BEAMS * 64)  # v2 verify (1 row), multi verify, v1 verify (4 rows), prefill
TREE_DRAFT_M = (TREE_BEAMS, 2 * TREE_BEAMS, TREE_BEAMS * 64)  # beam step, re-feed, prefill
TREE_PREFIX = 96  # a mid-run committed length of the tree path (64 prompt + up to 64 new)
# the remaining algorithms (same settings; BiLD at JAX's defaults gamma 10,
# fallback 0.6, rollback 5.0): B1 at BiLD's check window, MJSD's default
# verify (width 8 x 5 tokens) and random beam's 4-row decode
BILD_GAMMA = 10
ALG_TARGET_M = (BILD_GAMMA + 1, 8 * (TREE_GAMMA + 1), TREE_BEAMS)
# the OPT path (scripts/bench_opt13b.py's settings on the OPT-13B int8 target
# with its 640-wide draft): 64-token prompt, gamma 8, 128 new tokens; serving
# and beam v2 with the Llama paths' settings. Projections: q/k/v/o, fc1, fc2
OPT_TARGET_SHAPES = [(5120, 5120, 4), (5120, 20480, 1), (20480, 5120, 1)]
OPT_DRAFT_SHAPES = [(640, 640, 4), (640, 2560, 1), (2560, 640, 1)]
OPT_GAMMA = 8
OPT_TARGET_M = (1, OPT_GAMMA + 1, 64, ROWS * (SERVE_GAMMA + 1))  # decode, verify, prefill, serving
OPT_DRAFT_M = (1, 2, ROWS, 64)  # decode, re-feed, serving step, prefill
# the prefix cache (scripts/bench_paged.py's shared_prefix mix: a 512-token
# system prompt + 64 unique tokens): hits extend 32-token windows over the 4
# shared pages, up to 8 hits a window; tables of ceil((576 + 48 + 9) / 128)
SHARED_PAGES, EXTEND_W, EXTEND_KB, EXTEND_PAGES = 4, 32, 8, 5
# SARATHI chunked prefill (scripts/bench_chunked_prefill.py's A/B, --kv_int8
# --gamma 8 --steps_per_sync 4 --long_prompt 960 --n_requests 36
# --batch_rows 12 over 32 blocks of 128): a closed loop, every 5th request a
# 960-token cold prompt with 32 new tokens, the rest 64 + 48; extend windows
# of 32 (B3's S_new limit) where the command gives 128; prefill_extra 8 in
# the third run. Adaptive gamma (scripts/bench_paged.py --adaptive_gamma
# 4,8,16 --repeat_workload 4): 96 x (64, 48) at the serving settings, whose
# deepest arm's worst case (129 positions) takes 2 pages a row
COLD_ROWS, COLD_SYNC, COLD_LEN, COLD_NEW, COLD_N, COLD_EXTRA = 12, 4, 960, 32, 36, 8
ADAPT_ARMS, ADAPT_N, ADAPT_PAGES = (4, 8, 16), 96, 2
SARATHI_TARGET_M = (ROWS * (ADAPT_ARMS[0] + 1), COLD_ROWS * (SERVE_GAMMA + 1),
                    COLD_ROWS * (SERVE_GAMMA + 1 + COLD_EXTRA), ROWS * (ADAPT_ARMS[2] + 1))
# the slotted engine (scripts/bench_serving.py --config 13b --max_total_len 256
# --gamma 8 --num_slots 16 --kv_int8 --steps_per_sync 8): 16 slots of 256
# positions, the paged uniform cell's 4,096-position KV budget; 24 requests of
# 64-token prompts and 64 new tokens after warmup(). Its verify is B1 at
# M = 16 x 9 = 144 (the paged serving verify's) and B2 at B=16 x Hkv 40 x 9
SLOTS, SLOT_LEN, SLOT_N, SLOT_NEW = 16, 256, 24, 64
# the evaluation harness (python -m llmspeculativesampling_tpu_torch.evalx.harness
# --dataset synthetic --methods all --num_prompts 2 --max_tokens 64 --score):
# synthetic_pair's Llama, 2048 wide x 16 layers (16 heads of 128), vocab
# 32000, bf16; gamma 4, width 4, 8 beams; caches of aligned_total(64 + 64 +
# gamma + 1) = 256 positions (BiLD's gamma 10 too)
HARNESS_ARGS = ["--dataset", "synthetic", "--num_prompts", "2", "--max_tokens", "64"]
HARNESS_HKV, HARNESS_GAMMA, HARNESS_S_MAX = 16, 4, 256
# JAX's harness result keys a block (llmspeculativesampling_tpu/evalx/harness.py:302-320)
HARNESS_KEYS = {"method", "prompts", "total_tokens", "total_time_s", "s_per_token", "tokens_per_s",
                "mean_acc_len", "acc_rate", "target_call_times", "approx_call_times", "energy_j",
                "j_per_token"}
# the trained pair: train_tiny_pair()'s defaults (a 256-wide 4-layer byte-level
# target, an independent 128-wide 2-layer draft, 4 heads, fp32, 300 steps
# each of 16 x 128 bytes) and tests/test_trained_pair.py's generation: 32-byte
# prompts, 48 new tokens, gamma 4, top_k 20, top_p 0.9; caches of
# aligned_total(64 + 48 + 5) = 128. Its int8 target's projections (per layer;
# the head stays dense, as quantize_params leaves it by default)
TRAINED_PROMPT, TRAINED_NEW, TRAINED_GAMMA, TRAINED_S_MAX = 32, 48, 4, 128
TRAINED_SHAPES = [(256, 256, 4), (256, 1024, 2), (1024, 256, 1)]
TRAINED_LAYERS = 4
# tensor parallelism: one rank's shard of the 13B-int8 pair at tp=2. q/k/v
# and gate/up keep half their columns, o and down half their rows (their
# partials leave B1 in fp32, to be summed over the ranks before the cast),
# the head half the vocab; 20 of the 40 heads (the draft: 3 of 6). Two
# ranks share the one card over gloo (parallel/launch.py). (K, N, per
# layer, fp32 out)
TP = 2
TP_TARGET_SHAPES = [(5120, 2560, 3, False), (2560, 5120, 1, True), (5120, 6912, 2, False),
                    (6912, 5120, 1, True), (5120, VOCAB // TP, 0, False)]
TP_DRAFT_SHAPES = [(768, 384, 3, False), (384, 768, 1, True), (768, 1536, 2, False),
                   (1536, 768, 1, True), (768, VOCAB // TP, 0, False)]
TP_TARGET_M = (1, GAMMA + 1, ROWS * (SERVE_GAMMA + 1))  # AR decode, single verify, serving verify
TP_DRAFT_M = (1, 2, ROWS)                               # draft decode, re-feed, serving draft step
TP_AR_NEW, TP_SLOT_N = 32, 16  # AR tokens; slotted requests of (64, 64)
TP_LIMIT_S = 480.0  # each rank's time limit
# data parallelism: one dp=2 rank's shard of the serving state at the paged
# and slotted settings above: 8 of the 16 rows over 16 of the 32 int8 blocks
# of 128 (max_pages_per_req 16, the table width P, at most a shard's pool),
# 8 of the 16 slots of 256; params replicated. Its verify: B1 at M = 8 x 9,
# B3 at B = 8 (paged), B2 at 8 slots (slotted); its draft step: B1 at M = 8.
# The dp=2 x tp=2 run takes the uniform mix cut to 16 x (64, 32). Admission
# fills shard 0's free rows first (JAX's row order), so the drivers release
# up to 16 requests a round: at 8 a round (the tp phase's), each round's 8
# land on shard 0 and finish within its chunk, and shard 1 idles
DP = 2
DP_ROWS, DP_BLOCKS, DP_PAGES = ROWS // DP, BLOCKS // DP, BLOCKS // DP
DP_TARGET_M, DP_DRAFT_M = DP_ROWS * (SERVE_GAMMA + 1), DP_ROWS
DP_SLOT_N, DP_TP_REQS = 25, [(64, 32)] * 16
DP_LIMIT_S = 300.0  # each rank's time limit


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def bound(bytes_: float, ops: float):
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls, by CUDA events
    around one replay of a CUDA graph of the calls: a small kernel runs in
    less time than its Python wrapper takes to enqueue it, so timing eager
    calls would measure the host."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float):
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    lim = atol + rtol * ref.abs()
    worst = float((err / lim).max())
    max_abs = float(err.max())
    if worst > 1.0:
        raise AssertionError(
            f"{name}: max abs err {max_abs:.3e} exceeds atol {atol:.1e} + rtol {rtol:.1e}*|ref| "
            f"(worst ratio {worst:.2f})")
    return max_abs, float(max_abs / max(float(ref.abs().max()), 1e-30))


# ---------------------------------------------------------------- phase 1
def phase_device(pkg_build):
    log(f"[device] {card_line()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} gpu {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    pkg_build.build(["int8_matmul", "flash_decode", "moe_matmul"])
    log(f"[device] kernels built in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name, text in pkg_build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Performance" in line:
                log(f"[ptxas {name}] {line.strip()}")
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", pkg_build.BUILD_LOGS["int8_matmul"])
    if any(int(n) for n in spills):
        raise AssertionError("int8_matmul: ptxas reports register spills")


# ---------------------------------------------------------------- phase 2
def _rotated(make):
    """Operand sets for timing: as many fresh ones from ``make`` as together
    exceed the L2 cache (a set is a tensor or a list of tensors)."""
    first = make()
    parts = first if isinstance(first, (list, tuple)) else [first]
    nbytes = sum(x.nbytes for x in parts if x is not None)
    n = max(1, min(256, math.ceil(L2_FLUSH_BYTES / max(nbytes, 1))))
    return [first] + [make() for _ in range(n - 1)]


def phase_int8_matmul(results):
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref, plan

    gen = torch.Generator(device="cuda").manual_seed(1)
    rtol, atol_rel = 2.0 ** -7, 1e-3
    log(f"[int8_matmul] tolerance: |kernel-plain| <= {rtol:.2e}*|plain| + {atol_rel:.0e}*max|plain| "
        "(two bf16 ulps; both sum exact bf16 x int8 products in fp32, in other orders)")
    # one target forward of each kind: its 40 x 7 projections and the lm_head
    forwards = {1: "AR decode", TARGET_M[0]: "single prefill", GAMMA + 1: "single verify",
                SERVE_TARGET_M[0]: "serving verify",
                SERVE_TARGET_M[1]: "serving prefill", TREE_TARGET_M[0]: "v2 tree verify",
                TREE_TARGET_M[1]: "multi / multi-beam / MJSD-4 verify",
                TREE_TARGET_M[2]: "v1 tree verify",
                TREE_TARGET_M[3]: "4-row prefill / 8-hit extend window",
                ALG_TARGET_M[0]: "BiLD check", ALG_TARGET_M[1]: "MJSD-8 verify",
                ALG_TARGET_M[2]: "random-beam decode",
                SARATHI_TARGET_M[0]: "adaptive gamma-4 verify (16 x 5)",
                SARATHI_TARGET_M[1]: "cold_mix verify (12 x 9)",
                SARATHI_TARGET_M[2]: "cold_mix prefill_extra-8 verify (12 x 17)",
                SARATHI_TARGET_M[3]: "adaptive gamma-16 verify (16 x 17)"}
    fwd = {m: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0) for m in forwards}
    # the admission prefill's M (64 x requests) plans B1 batch-invariant: time
    # that plan beside the one chosen from M at each prefill M
    prefill_m = {TARGET_M[0], TREE_TARGET_M[3], SERVE_TARGET_M[1]}
    inv = {m: 0.0 for m in prefill_m}
    worst_abs = 0.0
    tm = sorted(set(TARGET_M + SERVE_TARGET_M + TREE_TARGET_M + ALG_TARGET_M + SARATHI_TARGET_M),
                reverse=True)
    dm = sorted(set(DRAFT_M + SERVE_DRAFT_M + TREE_DRAFT_M), reverse=True)
    cases = [("target", m, k, n, c) for m in tm for (k, n, c) in TARGET_SHAPES + [(5120, VOCAB, 1)]]
    cases += [("draft", m, k, n, c) for m in dm for (k, n, c) in DRAFT_SHAPES + [(768, VOCAB, 1)]]
    # ragged shapes: row tiles part-filled (M not a multiple of 8, two tiles
    # above 256), a K tail inside a 64-row chunk, N narrower than a block
    ragged = [("ragged", m, k, n, 0) for m in (3, 9, 37, 145, 200, 448)
              for (k, n) in ((5120, 5120), (768, 3072))]
    ragged += [("ragged", m, 96, 5120, 0) for m in (9, 145)]
    ragged += [("ragged", m, 5120, 48, 0) for m in (3, 200)]
    ragged += [("ragged", 37, 96, 48, 0)]
    for model, m, k, n, per_layer in cases + ragged:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        ws = _rotated(lambda: torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8,
                                            device="cuda"))
        s = (0.8 + 0.4 * torch.rand((n,), generator=gen, device="cuda")) / (73.0 * math.sqrt(k))
        got = int8_matmul(x[None], ws[0], s)[0]  # [B, S, K] activations, as linear() passes them
        ref = int8_matmul_ref(x, ws[0], s)
        torch.cuda.synchronize()
        max_abs, rel = check_close(f"int8_matmul {model} M={m} K={k} N={n}", got, ref, rtol,
                                   atol_rel * float(ref.float().abs().max()))
        worst_abs = max(worst_abs, max_abs)
        t_k = time_ms(lambda i: int8_matmul(x[None], ws[i % len(ws)], s), 20)
        b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * k * n)
        shape = (f"[int8_matmul] {model} M={m:3d} K={k:5d} N={n:5d} plan {plan(m, k, n)}: "
                 f"max_abs_err {max_abs:.3e} (rel {rel:.1e}) kernel_ms {t_k:.4f} "
                 f"bound_us {b_ms * 1e3:.1f} ({b_by}) bound share {b_ms / t_k:.3f}")
        if model == "ragged":
            log(shape)
            del ws
            continue
        w16 = [w.to(torch.bfloat16) for w in ws]
        t_p = time_ms(lambda i: int8_matmul_ref(x, ws[i % len(ws)], s), 5)
        t_l = time_ms(lambda i: torch.matmul(x, w16[i % len(w16)]), 20)
        t_inv = None
        if model == "target" and m in prefill_m:
            got_inv = int8_matmul(x[None], ws[0], s, batch_invariant=True)[0]
            check_close(f"int8_matmul batch-invariant M={m} K={k} N={n}", got_inv, ref, rtol,
                        atol_rel * float(ref.float().abs().max()))
            t_inv = time_ms(lambda i: int8_matmul(x[None], ws[i % len(ws)], s,
                                                  batch_invariant=True), 20)
            inv[m] += (40 * per_layer if n != VOCAB else 1) * t_inv
        log(f"{shape} plain_ms {t_p:.4f} library_ms {t_l:.4f} "
            "(torch.matmul on pre-widened bf16, 2 B/weight)"
            + ("" if t_inv is None else f"; batch-invariant plan {plan(m, k, n, True)} kernel_ms "
               f"{t_inv:.4f}"))
        if model == "target" and m in fwd:
            calls = 40 * per_layer if n != VOCAB else 1
            for key, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms)):
                fwd[m][key] += calls * t
            fwd[m]["bound_by"] = b_by
        del ws, w16
    # an fp32 config takes the kernel's fp32-output instantiation: the same
    # exact products summed in fp32 in other orders over K=5120
    x = torch.randn((GAMMA + 1, 5120), generator=gen, device="cuda")
    w = torch.randint(-127, 128, (5120, 5120), generator=gen, dtype=torch.int8, device="cuda")
    s = torch.rand((5120,), generator=gen, device="cuda") / (73.0 * math.sqrt(5120))
    ref = int8_matmul_ref(x, w, s)
    max_abs, _ = check_close("int8_matmul fp32 x", int8_matmul(x[None], w, s)[0], ref, 0.0,
                             1e-4 * float(ref.abs().max()))
    log(f"[int8_matmul] fp32 x M=25 K=5120 N=5120: max_abs_err {max_abs:.3e} "
        "(tol 1e-4*max|plain|: fp32 sums in other orders)")
    results["int8_matmul"] = dict(**fwd[SERVE_TARGET_M[0]], max_abs_err=worst_abs,
                                  single_stream_verify_ms=fwd[GAMMA + 1]["ms"],
                                  tree_forwards_ms={forwards[m]: fwd[m]["ms"] for m in TREE_TARGET_M},
                                  algorithm_forwards_ms={forwards[m]: fwd[m]["ms"]
                                                         for m in ALG_TARGET_M},
                                  sarathi={m: fwd[m] for m in SARATHI_TARGET_M})
    for m, what in forwards.items():
        f = fwd[m]
        log(f"[int8_matmul] one {what} target forward (281 launches at M={m}): "
            f"kernel_ms {f['ms']:.3f} plain_ms {f['plain_ms']:.3f} library_ms {f['library_ms']:.3f} "
            f"bound_ms {f['bound_ms']:.3f} ({f['bound_by']}) bound share {f['bound_ms'] / f['ms']:.3f}"
            + (f"; batch-invariant plan (the admission prefill's) kernel_ms {inv[m]:.3f}"
               if m in inv else ""))
    results["int8_matmul"]["prefill_ms"] = {m: (fwd[m]["ms"], inv[m]) for m in sorted(inv)}
    m = EXTEND_KB * EXTEND_W  # an extend window of 8 hits takes the invariant plan
    results["int8_matmul"]["extend"] = dict(fwd[m], ms=inv[m], plan_from_m_ms=fwd[m]["ms"])


def _flash_inputs(gen, b, hq, hkv, s_new, d, quant, tree, dtype=torch.bfloat16, s_max=S_MAX):
    """Inputs in the layouts the forward passes: q/k_new/v_new are
    [B, H, S_new, D] views of [B, S_new, H, D] projections, the cache
    [B, Hkv, s_max, D]. bf16 q comes with the softmax scale folded in
    (called with scale 1.0, so kernel and plain version see the same q);
    fp32 q is raw (scale 1/sqrt(d): the kernel's fold rounds nothing in
    fp32)."""
    q = torch.randn((b, s_new, hq, d), generator=gen, device="cuda")
    q = (q / math.sqrt(d) if dtype == torch.bfloat16 else q).to(dtype).transpose(1, 2)
    kn = torch.randn((b, s_new, hkv, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    vn = torch.randn((b, s_new, hkv, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    kc = torch.randn((b, hkv, s_max, d), generator=gen, device="cuda")
    vc = torch.randn((b, hkv, s_max, d), generator=gen, device="cuda")
    vis = torch.ones((s_new, s_new), dtype=torch.bool, device="cuda").tril()
    if tree:
        vis &= torch.rand((s_new, s_new), generator=gen, device="cuda") > 0.3
        vis |= torch.eye(s_new, dtype=torch.bool, device="cuda")
    bias = torch.where(vis, 0.0, -1e30).float()[None].expand(b, s_new, s_new).contiguous()
    if quant:
        from llmspeculativesampling_tpu_torch.cache.kvcache import _quantize_kv
        kq, ks = _quantize_kv(kc)
        vq, vs = _quantize_kv(vc)
        return q, kn, vn, kq, vq, bias, ks, vs
    return q, kn, vn, kc.to(dtype), vc.to(dtype), bias, None, None


def _check_case(name, fn, ref, args, kw, rtol, atol):
    """One attention case through its public wrapper: the inputs as the
    forward passes them and as contiguous copies give bit-identical output,
    so does a second call, every call is one launch and the ticket counters
    are back at 0 after a synchronize; then the output against the plain
    version. Returns (max_abs_err, rel)."""
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import _COUNTERS

    before = fn.launches
    got = fn(*args, **kw)
    again = fn(*args, **kw)
    contig = fn(*[x.contiguous() if isinstance(x, torch.Tensor) else x for x in args], **kw)
    torch.cuda.synchronize()
    if fn.launches - before != 3:
        raise AssertionError(f"{name}: 3 calls made {fn.launches - before} launches")
    if not (torch.equal(got, again) and torch.equal(got, contig)):
        raise AssertionError(f"{name}: repeated or contiguous calls are not bit-identical")
    if any(int(c.count_nonzero()) for c in _COUNTERS.values()):
        raise AssertionError(f"{name}: ticket counters not back at 0")
    return check_close(name, got, ref(*args, **kw), rtol, atol)


def _flash_bound(hkv, s_new, length, quant, rows=1, extra_bytes=0, stored=None, d=128,
                 dtype=torch.bfloat16):
    """Least time of one call: live prefix K/V (and scales) read once, q,
    k_new, v_new, out, bias, lengths (and ``extra_bytes``: block tables)
    once; QK^T and PV over ``length``, the rows' summed live prefix, at the
    bf16 tensor rate (fp32: the CUDA cores' rate). ``stored``: the distinct
    prefix positions when rows share pages (a shared page is read once),
    else ``length``."""
    elem = 4 if dtype == torch.float32 else 2
    kv_b = 1 if quant else elem
    stored = length if stored is None else stored
    nbytes = (2 * stored * hkv * d * kv_b + (2 * stored * hkv * 4 if quant else 0)
              + 4 * rows * hkv * s_new * d * elem + rows * s_new * s_new * 4 + rows * 4
              + extra_bytes)
    ops = 2 * 2 * hkv * s_new * (length + rows * s_new) * d
    if dtype == torch.float32:  # bound() counts operations at the bf16 rate
        ops *= BF16_OPS_PER_S / FP32_OPS_PER_S
    return bound(nbytes, ops)


def phase_flash_decode(results):
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref, plan)

    gen = torch.Generator(device="cuda").manual_seed(2)
    rtol = atol = 2.0 ** -7
    log(f"[flash_decode] tolerance: |kernel-plain| <= {atol:.2e} + {rtol:.2e}*|plain| "
        "(q pre-scaled in bf16 for both; fp32 softmax in both, bf16 output: ~1 ulp); each case "
        "also bit-identical across a repeat and contiguous inputs, one launch a call, counters 0")
    worst = 0.0
    cases = []
    for quant in (False, True):
        for hkv in (40, 6):
            for s_new in (1, 2, 25):
                ps = plan(1, hkv, s_new, S_MAX).ps
                edges = (ps - 1, ps, ps + 1, 2 * ps - 1, 2 * ps, 2 * ps + 1)
                for length in sorted({0, 1, 127, 128, 200, S_MAX - s_new, *edges}):
                    for tree in (False, True):
                        cases.append((1, hkv, hkv, s_new, 128, quant, tree, [length]))
    cases += [(1, 16, 4, 25, 128, q, True, [130]) for q in (False, True)]   # GQA, G=4
    cases += [(2, 16, 4, 25, 128, q, True, [33, S_MAX - 25]) for q in (False, True)]  # 100 rows
    cases += [(1, 12, 12, 25, 64, q, False, [100]) for q in (False, True)]  # D=64
    cases += [(1, 12, 12, 25, 32, q, True, [200]) for q in (False, True)]   # D=32
    cases += [(1, 8, 8, 25, 96, q, False, [129]) for q in (False, True)]    # D=96
    cases += [(3, 8, 8, 5, 128, q, False, [0, 64, 251]) for q in (False, True)]  # per-row
    # per-row lengths whose splits are partly empty: a row past every edge,
    # one on an edge, one empty, one full
    cases += [(4, 8, 8, 9, 128, q, True, [33, 64, 0, S_MAX - 9]) for q in (False, True)]
    for b, hq, hkv, s_new, d, quant, tree, lens in cases:
        q, kn, vn, kc, vc, bias, ks, vs = _flash_inputs(gen, b, hq, hkv, s_new, d, quant, tree)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        max_abs, _ = _check_case(
            f"flash_decode quant={quant} B={b} Hq={hq} Hkv={hkv} S_new={s_new} D={d} "
            f"len={lens} tree={tree}", flash_decode_attention, flash_decode_ref,
            (q, kn, vn, kc, vc, lengths, bias), dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
        worst = max(worst, max_abs)
    log(f"[flash_decode] {len(cases)} cases within tolerance (lengths at split edges k*ps-1, "
        f"k*ps, k*ps+1, 0, S_max-S_new; tree bias; G=4 x S_new=25 over two row tiles; per-row "
        f"lengths), worst max_abs_err {worst:.3e}")
    # fp32 configs take the kernel's fp32 instantiations: same math in fp32
    # throughout, sums in other orders
    for d in (128, 96, 64, 32):
        for quant in (False, True):
            q, kn, vn, kc, vc, bias, ks, vs = _flash_inputs(gen, 1, 8, 4, 25, d, quant, True,
                                                            torch.float32)
            lengths = torch.tensor([200], dtype=torch.int32, device="cuda")
            max_abs, _ = _check_case(
                f"flash_decode fp32 quant={quant} D={d}", flash_decode_attention, flash_decode_ref,
                (q, kn, vn, kc, vc, lengths, bias), dict(scale=d ** -0.5, k_scales=ks, v_scales=vs),
                1e-4, 1e-4)
            log(f"[flash_decode] fp32 q, quant={quant}, D={d}, GQA 8/4, tree, len=200: "
                f"max_abs_err {max_abs:.3e} (tol 1e-4 + 1e-4*|plain|: fp32 throughout)")

    # timing: the verify shape (Hkv=40, S_new=25, len 128, dense and int8),
    # AR decode (S_new=1, len 128 and 255) and the draft (Hkv=6, S_new 1, 2)
    shapes = [("single verify", 40, GAMMA + 1, 128, False), ("single verify", 40, GAMMA + 1, 128, True),
              ("AR decode", 40, 1, 128, False), ("AR decode", 40, 1, 255, False),
              ("draft decode", 6, 1, 128, False), ("draft first step", 6, 2, 128, False)]
    for what, hkv, s_new, length, quant in shapes:
        t_k, t_p, t_l, b_ms, b_by, n_sets = _time_flash(gen, hkv, s_new, [length], quant)
        p = plan(1, hkv, s_new, S_MAX)
        log(f"[flash_decode] {what}: {'int8-KV' if quant else 'dense'} Hkv={hkv} S_new={s_new} "
            f"len={length} plan ps={p.ps} blocks={p.blocks(1, hkv)}: kernel_ms {t_k:.4f} "
            f"plain_ms {t_p:.4f} library_ms {t_l:.4f} "
            f"(F.scaled_dot_product_attention over [0,len) + block; int8: a dequantized view) "
            f"bound_us {b_ms * 1e3:.2f} ({b_by}) bound share {b_ms / t_k:.3f}; "
            f"{n_sets} input sets rotated")
        if what == "single verify" and not quant:
            results["flash_decode"] = dict(
                ms=40 * t_k, plain_ms=40 * t_p, library_ms=40 * t_l, bound_ms=40 * b_ms,
                max_abs_err=worst, bound_by=b_by)
    log(f"[flash_decode] one target verify forward (40 launches, len=128): "
        f"kernel_ms {results['flash_decode']['ms']:.3f} bound_ms {results['flash_decode']['bound_ms']:.4f}")


def _tree_bias(gen, b):
    """[B, 17, 17] additive bias of a tree verify, as ``tree_verify`` makes
    it: the anchor column visible to all, nodes see their ancestors under
    random parents (gamma 4, 4 beams), through the forward's block_bias."""
    from llmspeculativesampling_tpu_torch.engine.beam_tree import ancestor_matrix
    from llmspeculativesampling_tpu_torch.models.llama import block_bias

    parents = torch.randint(0, TREE_BEAMS, (TREE_GAMMA, TREE_BEAMS), generator=gen, device="cuda")
    block = torch.zeros((TREE_TOKENS, TREE_TOKENS), dtype=torch.bool, device="cuda")
    block[:, 0] = True
    block[1:, 1:] = ancestor_matrix(parents, TREE_GAMMA, TREE_BEAMS)
    return block_bias(TREE_TOKENS, block[None].expand(b, TREE_TOKENS, TREE_TOKENS), b, "cuda")


def _rows_inputs(gen, b, hkv, s_new, quant, lens, tree, d=128, dtype=torch.bfloat16,
                 s_max=S_MAX):
    """B2 inputs at B = len(lens) rows with per-row lengths, Hq = Hkv: the
    causal bias, or (``tree``) a tree verify's ancestor bias."""
    q, kn, vn, kc, vc, bias, ks, vs = _flash_inputs(gen, b, hkv, hkv, s_new, d, quant, False,
                                                    dtype, s_max)
    if tree:
        bias = _tree_bias(gen, b)
    return q, kn, vn, kc, vc, torch.tensor(lens, dtype=torch.int32, device="cuda"), bias, ks, vs


def _time_flash(gen, hkv, s_new, lens, quant=False, tree=False, d=128, dtype=torch.bfloat16,
                s_max=S_MAX):
    """Kernel, plain and SDPA times of B2 at B = len(lens) rows (see
    :func:`_rows_inputs`; fp32 q is raw, so every call takes 1/sqrt(d)). Inputs rotate through > L2 bytes and are
    contiguous, so that only the kernel runs inside the timed graph; SDPA
    attends [0, max len) + the block under a float mask (-inf past a row's
    length, the causal or tree bias on the block), over a dequantized bf16
    view of an int8 cache (made untimed)."""
    import torch.nn.functional as F

    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref)

    b = len(lens)
    scale = 1.0 if dtype == torch.bfloat16 else d ** -0.5

    def make():
        t = _rows_inputs(gen, b, hkv, s_new, quant, lens, tree, d, dtype, s_max)
        return [x.contiguous() if x is not None else None for x in t]

    sets = _rotated(make)

    def kern(i):
        q, kn, vn, kc, vc, lengths, bias, ks, vs = sets[i % len(sets)]
        return flash_decode_attention(q, kn, vn, kc, vc, lengths, bias, scale=scale,
                                      k_scales=ks, v_scales=vs)

    def plain(i):
        q, kn, vn, kc, vc, lengths, bias, ks, vs = sets[i % len(sets)]
        return flash_decode_ref(q, kn, vn, kc, vc, lengths, bias, scale=scale, k_scales=ks,
                                v_scales=vs)

    t_k, t_p = time_ms(kern, 50), time_ms(plain, 20)
    width = max(max(lens), 1)
    lib_sets = []
    for q, kn, vn, kc, vc, lengths, bias, ks, vs in sets:
        if quant:  # a dequantized view, made untimed
            kc, vc = kc.float() * ks[..., None], vc.float() * vs[..., None]
        pre = torch.arange(width, device="cuda")[None, None, :] < lengths[:, None, None]
        pre = torch.where(pre, 0.0, float("-inf")).expand(b, s_new, width)
        mask = torch.cat([pre, torch.where(bias == 0, 0.0, float("-inf"))], dim=2)[:, None]
        lib_sets.append((q, torch.cat([kc[:, :, :width].to(q.dtype), kn], 2),
                         torch.cat([vc[:, :, :width].to(q.dtype), vn], 2), mask.contiguous()))

    def lib(i):
        q, k_all, v_all, mask = lib_sets[i % len(lib_sets)]
        return F.scaled_dot_product_attention(q, k_all, v_all, attn_mask=mask, scale=scale)

    t_l = time_ms(lib, 50)
    del lib_sets
    b_ms, b_by = _flash_bound(hkv, s_new, sum(lens), quant, rows=b, d=d, dtype=dtype)
    n = len(sets)
    del sets
    return t_k, t_p, t_l, b_ms, b_by, n


def phase_flash_tree(results):
    """B2 at the tree/beam path's shapes: the tree verify (B 1 and 4, Hkv
    40, S_new 17 under an ancestor bias), multi's causal verify (B=4,
    S_new 5) and the beam draft (B=4, Hkv 6, S_new 1 and 2)."""
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref, plan)

    gen = torch.Generator(device="cuda").manual_seed(12)
    rtol = atol = 2.0 ** -7
    lens4 = [[64, 97, 150, 200], [200, 64, 129, 65], [TREE_PREFIX] * 4]
    cases = []  # (what, b, hkv, s_new, lens, tree)
    for lens in ([64], [130], [200], [TREE_PREFIX]):
        cases.append(("tree verify", 1, 40, TREE_TOKENS, lens, True))
    for lens in lens4:
        cases.append(("tree verify", 4, 40, TREE_TOKENS, lens, True))
        cases.append(("multi verify", 4, 40, TREE_GAMMA + 1, lens, False))
        for s_new in (1, 2):
            cases.append(("beam draft", 4, 6, s_new, lens, False))
    worst = 0.0
    for quant in (False, True):
        for what, b, hkv, s_new, lens, tree in cases:
            q, kn, vn, kc, vc, lengths, bias, ks, vs = _rows_inputs(gen, b, hkv, s_new, quant,
                                                                   lens, tree)
            max_abs, _ = _check_case(
                f"flash_decode {what} quant={quant} B={b} Hkv={hkv} S_new={s_new} len={lens}",
                flash_decode_attention, flash_decode_ref, (q, kn, vn, kc, vc, lengths, bias),
                dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
            worst = max(worst, max_abs)
    log(f"[flash_decode tree] {2 * len(cases)} cases within tolerance (bf16 and int8 KV; tree "
        f"verify B 1/4 x S_new {TREE_TOKENS} under ancestor biases of random parents, multi verify "
        f"B=4 x S_new {TREE_GAMMA + 1}, beam draft B=4 x Hkv 6 x S_new 1/2; lengths 64-200), "
        f"worst max_abs_err {worst:.3e}")
    rows = {}
    for what, b, hkv, s_new, tree in (("tree verify", 1, 40, TREE_TOKENS, True),
                                      ("tree verify", 4, 40, TREE_TOKENS, True),
                                      ("multi verify", 4, 40, TREE_GAMMA + 1, False),
                                      ("beam draft", 4, 6, 1, False),
                                      ("beam draft re-feed", 4, 6, 2, False)):
        lens = [TREE_PREFIX] * b
        t_k, t_p, t_l, b_ms, b_by, n_sets = _time_flash(gen, hkv, s_new, lens, tree=tree)
        p = plan(b, hkv, s_new, S_MAX)
        log(f"[flash_decode tree] {what}: dense B={b} Hkv={hkv} S_new={s_new} len={TREE_PREFIX} "
            f"plan ps={p.ps} blocks={p.blocks(b, hkv)}: kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
            f"library_ms {t_l:.4f} (F.scaled_dot_product_attention, {'tree' if tree else 'causal'} "
            f"as a float mask) bound_us {b_ms * 1e3:.2f} ({b_by}) bound share {b_ms / t_k:.3f}; "
            f"{n_sets} input sets rotated")
        rows[f"{what} B={b}"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                                     bound_by=b_by)
    results["flash_decode_tree"] = dict(max_abs_err=worst, per_call=rows)


def phase_flash_algorithms(results):
    """B2 at the remaining algorithms' shapes: MJSD's default verify (B=8,
    S_new 5, causal), BiLD's check window (B=1, S_new 11, causal) and
    random beam's 4-row decode (S_new 1), Hkv 40 each."""
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref, plan)

    gen = torch.Generator(device="cuda").manual_seed(13)
    rtol = atol = 2.0 ** -7
    s5, s11 = TREE_GAMMA + 1, BILD_GAMMA + 1
    cases = [("MJSD-8 verify", 8, s5, lens) for lens in
             ([TREE_PREFIX] * 8, [64, 80, 96, 110, 127, 128, 129, S_MAX - s5])]
    cases += [("BiLD check", 1, s11, [n]) for n in (64 - s11, 64, TREE_PREFIX, 128, S_MAX - s11)]
    cases += [("random-beam decode", 4, 1, lens) for lens in
              ([65] * 4, [TREE_PREFIX] * 4, [127] * 4, [128] * 4)]
    worst = 0.0
    for quant in (False, True):
        for what, b, s_new, lens in cases:
            q, kn, vn, kc, vc, lengths, bias, ks, vs = _rows_inputs(gen, b, 40, s_new, quant, lens,
                                                                   False)
            max_abs, _ = _check_case(
                f"flash_decode {what} quant={quant} B={b} Hkv=40 S_new={s_new} len={lens}",
                flash_decode_attention, flash_decode_ref, (q, kn, vn, kc, vc, lengths, bias),
                dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
            worst = max(worst, max_abs)
    log(f"[flash_decode algorithms] {2 * len(cases)} cases within tolerance (bf16 and int8 KV; "
        f"MJSD-8 verify B=8 x S_new {s5}, BiLD check B=1 x S_new {s11}, random-beam decode B=4 x "
        f"S_new 1; causal; lengths 53-251), worst max_abs_err {worst:.3e}")
    rows = {}
    for what, b, s_new in (("MJSD-8 verify", 8, s5), ("BiLD check", 1, s11),
                           ("random-beam decode", 4, 1)):
        lens = [TREE_PREFIX] * b
        t_k, t_p, t_l, b_ms, b_by, n_sets = _time_flash(gen, 40, s_new, lens)
        p = plan(b, 40, s_new, S_MAX)
        log(f"[flash_decode algorithms] {what}: dense B={b} Hkv=40 S_new={s_new} len={TREE_PREFIX} "
            f"plan ps={p.ps} blocks={p.blocks(b, 40)}: kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
            f"library_ms {t_l:.4f} (F.scaled_dot_product_attention, causal as a float mask) "
            f"bound_us {b_ms * 1e3:.2f} ({b_by}) bound share {b_ms / t_k:.3f}; {n_sets} input sets "
            "rotated")
        rows[f"{what} B={b}"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                                     bound_by=b_by)
    results["flash_decode_algorithms"] = dict(max_abs_err=worst, per_call=rows)


def _slot_lens(s_new):
    """Per-slot lengths of a slotted call (B=16 over S_max 256): an idle
    slot (cur_len 2: its verify rolls back to 1), slots on the edges of 64-
    and 128-position splits, mid-run slots and one at the last start the
    cache takes (S_max - S_new)."""
    return [1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 70, 100, 150, 200, 230, S_MAX - s_new]


def phase_flash_slotted(results):
    """B2 at the slotted engine's shapes, per-slot lengths that differ row
    to row (:func:`_slot_lens`): the target verify (B=16 x Hkv 40 x S_new
    9, int8 KV, and bf16 as a check) and the draft steps (B=16 x Hkv 6 x
    S_new 1 and 2, dense). The grid follows S_max, not the live lengths
    (ROADMAP B-queue item 1): every call launches the blocks of 256
    positions a slot."""
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref, plan)

    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(14)
    rtol = atol = 2.0 ** -7
    s9 = SERVE_GAMMA + 1
    shapes = [("slotted target verify", 40, s9, True), ("slotted draft step", 6, 1, False),
              ("slotted draft re-feed", 6, 2, False)]
    log(f"[slotted B2] tolerance as [flash_decode]: {atol:.2e} + {rtol:.2e}*|plain| (one bf16 ulp), "
        "each case bit-identical across a repeat and contiguous inputs, one launch a call, "
        "counters 0")
    worst, rows = 0.0, {}
    cases = [(what, hkv, s_new, q) for what, hkv, s_new, q in shapes]
    cases.append(("slotted target verify", 40, s9, False))
    for what, hkv, s_new, quant in cases:
        lens = _slot_lens(s_new)
        q, kn, vn, kc, vc, lengths, bias, ks, vs = _rows_inputs(gen, SLOTS, hkv, s_new, quant,
                                                               lens, False)
        max_abs, _ = _check_case(
            f"flash_decode {what} quant={quant} B={SLOTS} Hkv={hkv} S_new={s_new} len={lens}",
            flash_decode_attention, flash_decode_ref, (q, kn, vn, kc, vc, lengths, bias),
            dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
        worst = max(worst, max_abs)
    for what, hkv, s_new, quant in shapes:
        lens = _slot_lens(s_new)
        t_k, t_p, t_l, b_ms, b_by, n_sets = _time_flash(gen, hkv, s_new, lens, quant)
        p = plan(SLOTS, hkv, s_new, S_MAX)
        rows[what] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                          blocks=p.blocks(SLOTS, hkv), live=sum(lens))
        log(f"[slotted B2] {what}: {'int8-KV' if quant else 'dense'} B={SLOTS} Hkv={hkv} "
            f"S_new={s_new} over S_max {S_MAX}, {sum(lens)} live positions (plan ps={p.ps} "
            f"blocks={p.blocks(SLOTS, hkv)}: the grid covers S_max, not the live lengths): kernel_ms "
            f"{t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} (F.scaled_dot_product_attention, "
            f"causal as a float mask; int8: a dequantized view) bound_us {b_ms * 1e3:.2f} ({b_by}) "
            f"bound share {b_ms / t_k:.3f}; {n_sets} input sets rotated ({card})")
    log(f"[slotted B2] {len(cases)} cases within tolerance, worst max_abs_err {worst:.3e}")
    results["slotted_b2"] = dict(per_call=rows, max_abs_err=worst)


def _paged_inputs(gen, lens, hq, hkv, s_new, d, page, p_max, quant, tree=False,
                  dtype=torch.bfloat16, n_blocks=None):
    """Inputs of one paged attention call in the forward's layouts: q/k_new/
    v_new are [B, H, S_new, D] views of [B, S_new, H, D] projections; pools
    [N+1, Hkv, page, D] with the trash block last (N: the rows' pages, or
    ``n_blocks`` when larger); each row's pages are shuffled blocks from the
    allocator, unused table slots (and a row of length 0) hold the sentinel
    N. bf16 q comes pre-scaled (scale 1.0, as in the B2 phase); fp32 q is
    raw."""
    from llmspeculativesampling_tpu_torch.cache.kvcache import _quantize_kv

    b = len(lens)
    n_blk = max(sum(-(-ln // page) for ln in lens), n_blocks or 1)
    q = torch.randn((b, s_new, hq, d), generator=gen, device="cuda")
    q = (q / math.sqrt(d) if dtype == torch.bfloat16 else q).to(dtype).transpose(1, 2)
    kn = torch.randn((b, s_new, hkv, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    vn = torch.randn((b, s_new, hkv, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    kp = torch.randn((n_blk + 1, hkv, page, d), generator=gen, device="cuda")
    vp = torch.randn((n_blk + 1, hkv, page, d), generator=gen, device="cuda")
    perm = torch.randperm(n_blk, generator=gen, device="cuda").tolist()
    tables = torch.full((b, p_max), n_blk, dtype=torch.int32)
    for i, ln in enumerate(lens):
        take = -(-ln // page)
        tables[i, :take] = torch.tensor(perm[:take], dtype=torch.int32)
        perm = perm[take:]
    vis = torch.ones((s_new, s_new), dtype=torch.bool, device="cuda").tril()
    if tree:
        vis &= torch.rand((s_new, s_new), generator=gen, device="cuda") > 0.3
        vis |= torch.eye(s_new, dtype=torch.bool, device="cuda")
    bias = torch.where(vis, 0.0, -1e30).float()[None].expand(b, s_new, s_new).contiguous()
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if quant:
        kq, ks = _quantize_kv(kp)
        vq, vs = _quantize_kv(vp)
        return q, kn, vn, kq, vq, tables.cuda(), lengths, bias, ks, vs
    return q, kn, vn, kp.to(dtype), vp.to(dtype), tables.cuda(), lengths, bias, None, None


def _uniform_lens(gen, b):
    """Serving lengths of the uniform mix: prompts of 64 plus up to 57
    committed tokens (48 new + gamma + 1 fit one page of 128)."""
    return torch.randint(64, 122, (b,), generator=gen, device="cuda").tolist()


MIXED_LENS = [121, 640, 70, 512, 99, 600, 64, 77, 545, 88, 101, 119, 66, 630, 90, 74]


def _time_paged_sets(make, s_new, quant, **kernel_kw):
    """Kernel, plain and SDPA times of B3 over input sets from ``make``
    (``_paged_inputs``' layout, Hq=Hkv, scale 1.0), rotated past L2; the
    library yardstick attends over a pre-gathered contiguous (dequantized)
    view, the gather untimed. Returns (kernel, plain, library ms, sets)."""
    import torch.nn.functional as F

    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        gather_pages, paged_flash_decode_attention, paged_flash_decode_ref)

    sets = _rotated(lambda: [x.contiguous() if x is not None else None for x in make()])

    def kern(i):
        q, kn, vn, kp, vp, tables, lengths, bias, ks, vs = sets[i % len(sets)]
        return paged_flash_decode_attention(q, kn, vn, kp, vp, tables, lengths, bias,
                                            scale=1.0, k_scales=ks, v_scales=vs, **kernel_kw)

    def plain(i):
        q, kn, vn, kp, vp, tables, lengths, bias, ks, vs = sets[i % len(sets)]
        return paged_flash_decode_ref(q, kn, vn, kp, vp, tables, lengths, bias,
                                      scale=1.0, k_scales=ks, v_scales=vs)

    lib_sets = []
    for q, kn, vn, kp, vp, tables, lengths, bias, ks, vs in sets:
        kc, vc = gather_pages(kp, tables), gather_pages(vp, tables)
        if quant:
            kc = kc.float() * gather_pages(ks, tables)[..., None]
            vc = vc.float() * gather_pages(vs, tables)[..., None]
        width = kc.shape[2]
        pre = torch.arange(width, device="cuda")[None, None, :] < lengths[:, None, None]
        mask = torch.cat([pre.expand(q.shape[0], s_new, width), bias == 0], dim=2)[:, None]
        lib_sets.append((q, torch.cat([kc.to(q.dtype), kn], 2), torch.cat([vc.to(q.dtype), vn], 2),
                         mask))

    def lib(i):
        q, k_all, v_all, mask = lib_sets[i % len(lib_sets)]
        return F.scaled_dot_product_attention(q, k_all, v_all, attn_mask=mask, scale=1.0)

    t_k, t_p, t_l = time_ms(kern, 50), time_ms(plain, 20), time_ms(lib, 50)
    n = len(sets)
    del sets, lib_sets
    return t_k, t_p, t_l, n


def _time_paged(gen, lens, p_max, hkv, s_new, quant, n_blocks=None, **kernel_kw):
    """Kernel, plain and SDPA times and the bound of B3 at B=len(lens),
    Hq=Hkv, D=128, page 128, each row on pages of its own (of a pool of
    ``n_blocks``, when given)."""
    t_k, t_p, t_l, n = _time_paged_sets(
        lambda: _paged_inputs(gen, lens, hkv, hkv, s_new, 128, PAGE, p_max, quant,
                              n_blocks=n_blocks), s_new, quant, **kernel_kw)
    b_ms, b_by = _flash_bound(hkv, s_new, sum(lens), quant, rows=len(lens),
                              extra_bytes=len(lens) * p_max * 4)
    return t_k, t_p, t_l, b_ms, b_by, n


def phase_paged_flash_decode(results):
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import plan
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_attention, paged_flash_decode_ref)

    gen = torch.Generator(device="cuda").manual_seed(4)
    rtol = atol = 2.0 ** -7
    log(f"[paged_flash_decode] tolerance: |kernel-plain| <= {atol:.2e} + {rtol:.2e}*|plain| "
        "(bf16 q pre-scaled for both; fp32 softmax in both, bf16 output: ~1 ulp); fp32: 1e-4; "
        "each case also bit-identical across a repeat and contiguous inputs, one launch a call, "
        "counters 0")
    mixed = MIXED_LENS
    # the draft's serving plan cuts a page in two: lengths at its split edges
    ps = plan(ROWS, 6, 1, PAGE, 1).ps
    draft_edges = [ps - 1, ps, ps + 1, 2 * ps - 1, 2 * ps, 0, 1, 100, 37, ps + 7, 90, 2, 120,
                   ps - 2, 3, 127][:ROWS]
    page_edges = [PAGE - 1, PAGE, PAGE + 1, 2 * PAGE - 1, 2 * PAGE, 2 * PAGE + 1, 0, 6 * PAGE,
                  5 * PAGE + 3, 64, 700, 1, 3 * PAGE, 400, 129, 511]
    cases = []  # (lens, hq, hkv, s_new, d, page, P, tree, quant)
    for quant in (True, False):
        cases += [(_uniform_lens(gen, ROWS), 40, 40, SERVE_GAMMA + 1, 128, PAGE, 1, False, quant),
                  (mixed, 40, 40, SERVE_GAMMA + 1, 128, PAGE, 6, False, quant),
                  (page_edges, 40, 40, SERVE_GAMMA + 1, 128, PAGE, 6, True, quant)]
        for s_new in (1, 2):  # draft decode and the two-token re-feed
            cases += [(_uniform_lens(gen, ROWS), 6, 6, s_new, 128, PAGE, 1, False, quant),
                      (mixed, 6, 6, s_new, 128, PAGE, 6, False, quant),
                      (draft_edges, 6, 6, s_new, 128, PAGE, 1, s_new == 2, quant)]
        # multi-page: lengths to 1024 ending mid-page and on a page edge, a
        # row of length 0 with an all-sentinel table
        cases.append(([1024, 0, 640, 129, 127, 128, 1, 1000], 8, 8, 9, 128, PAGE, 8, True, quant))
        for page in (16, 32):
            for d in (128, 96, 64, 32):
                cases.append(([8 * page, 0, 5 * page - 3, page, 2 * page + 1, 37],
                              16, 4, 9, d, page, 8, d == 64, quant))
        cases.append(([200, 64, 0], 12, 12, 25, 64, PAGE, 2, True, quant))
        cases.append(([200, 64, 0, 100], 16, 4, 25, 128, PAGE, 2, True, quant))  # G=4, 100 rows
    worst = 0.0
    for lens, hq, hkv, s_new, d, page, p_max, tree, quant in cases:
        q, kn, vn, kp, vp, tables, lengths, bias, ks, vs = _paged_inputs(
            gen, lens, hq, hkv, s_new, d, page, p_max, quant, tree)
        max_abs, _ = _check_case(
            f"paged_flash_decode quant={quant} B={len(lens)} Hq={hq} Hkv={hkv} S_new={s_new} D={d} "
            f"page={page} P={p_max} lens={lens}", paged_flash_decode_attention,
            paged_flash_decode_ref, (q, kn, vn, kp, vp, tables, lengths, bias),
            dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
        worst = max(worst, max_abs)
    log(f"[paged_flash_decode] {len(cases)} cases within tolerance (pages 16/32/128, D 32-128, "
        f"up to 8 pages a row, a sentinel row, lengths at page and split edges, G=4 x S_new=25), "
        f"worst max_abs_err {worst:.3e}")
    for d in (128, 96, 64, 32):
        for quant in (False, True):
            q, kn, vn, kp, vp, tables, lengths, bias, ks, vs = _paged_inputs(
                gen, [200, 0, 37, 129], 8, 4, 9, d, 32, 8, quant, True, torch.float32)
            max_abs, _ = _check_case(
                f"paged_flash_decode fp32 quant={quant} D={d}", paged_flash_decode_attention,
                paged_flash_decode_ref, (q, kn, vn, kp, vp, tables, lengths, bias),
                dict(scale=d ** -0.5, k_scales=ks, v_scales=vs), 1e-4, 1e-4)
            log(f"[paged_flash_decode] fp32 q, quant={quant}, D={d}, GQA 8/4, tree, page 32: "
                f"max_abs_err {max_abs:.3e} (tol 1e-4 + 1e-4*|plain|: fp32 throughout)")

    # timing at the serving path's target verify (Hkv=40, S_new=9; int8
    # pool as served, and bf16) and its draft (Hkv=6, S_new 1 and 2, int8):
    # uniform lengths on one page, mixed lengths on up to six
    shapes = [("target verify", 40, SERVE_GAMMA + 1, q) for q in (True, False)]
    shapes += [("draft step", 6, 1, True), ("draft re-feed", 6, 2, True)]
    for what, hkv, s_new, quant in shapes:
        for mix, p_max in (("uniform", 1), ("mixed", 6)):
            lens = _uniform_lens(gen, ROWS) if mix == "uniform" else mixed
            t_k, t_p, t_l, b_ms, b_by, n_sets = _time_paged(gen, lens, p_max, hkv, s_new, quant)
            p = plan(ROWS, hkv, s_new, PAGE, p_max)
            log(f"[paged_flash_decode] {what}: {'int8' if quant else 'bf16'} pool, {mix} lengths "
                f"(B=16, Hkv={hkv}, S_new={s_new}, page 128, P={p_max}, {sum(lens)} live positions; "
                f"plan ps={p.ps} blocks={p.blocks(ROWS, hkv)}): kernel_ms {t_k:.4f} plain_ms "
                f"{t_p:.4f} library_ms {t_l:.4f} (F.scaled_dot_product_attention over a "
                f"pre-gathered view, gather untimed) bound_us {b_ms * 1e3:.2f} ({b_by}) "
                f"bound share {b_ms / t_k:.3f}; {n_sets} input sets rotated")
            if what == "target verify" and quant and mix == "uniform":
                results["paged_flash_decode"] = dict(
                    ms=40 * t_k, plain_ms=40 * t_p, library_ms=40 * t_l, bound_ms=40 * b_ms,
                    max_abs_err=worst, bound_by=b_by)
    r = results["paged_flash_decode"]
    log(f"[paged_flash_decode] one serving target verify forward (40 launches, int8 pool, uniform): "
        f"kernel_ms {r['ms']:.3f} bound_ms {r['bound_ms']:.4f}")


def _extend_inputs(gen, lens, hkv, quant, p_max=EXTEND_PAGES):
    """Inputs of one extend-window B3 call in ``_paged_inputs``' layout
    (Hq=Hkv, D=128, page 128, S_new = EXTEND_W): every row of nonzero length
    reads the same 4 shuffled pages (the 512-position shared prefix), then
    a page of its own; the table's tail, and the whole table of a row of
    length 0 (a row the extend has exhausted), hold the sentinel."""
    from llmspeculativesampling_tpu_torch.cache.kvcache import _quantize_kv

    b, s_new, d = len(lens), EXTEND_W, 128
    n_blk = SHARED_PAGES + b
    q = torch.randn((b, s_new, hkv, d), generator=gen, device="cuda")
    q = (q / math.sqrt(d)).to(torch.bfloat16).transpose(1, 2)
    kn = torch.randn((b, s_new, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    vn = torch.randn((b, s_new, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((n_blk + 1, hkv, PAGE, d), generator=gen, device="cuda")
    vp = torch.randn((n_blk + 1, hkv, PAGE, d), generator=gen, device="cuda")
    perm = torch.randperm(n_blk, generator=gen, device="cuda").tolist()
    tables = torch.full((b, p_max), n_blk, dtype=torch.int32)
    for i, ln in enumerate(lens):
        if ln:
            tables[i, :SHARED_PAGES + 1] = torch.tensor(perm[:SHARED_PAGES] + [perm[SHARED_PAGES + i]],
                                                        dtype=torch.int32)
    vis = torch.ones((s_new, s_new), dtype=torch.bool, device="cuda").tril()
    bias = torch.where(vis, 0.0, -1e30).float()[None].expand(b, s_new, s_new).contiguous()
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    args = [q, kn.transpose(1, 2), vn.transpose(1, 2)]
    if quant:
        (kq, ks), (vq, vs) = _quantize_kv(kp), _quantize_kv(vp)
        return args + [kq, vq, tables.cuda(), lengths, bias, ks, vs]
    return args + [kp.to(torch.bfloat16), vp.to(torch.bfloat16), tables.cuda(), lengths, bias,
                   None, None]


def _b3_counted(**kernel_kw):
    """B3's wrapper with ``kernel_kw`` bound, carrying its own count of the
    launches it made (``_check_case`` reads ``fn.launches``)."""
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_attention)

    def counted(*a, **kw):
        before = paged_flash_decode_attention.launches
        out = paged_flash_decode_attention(*a, **kw, **kernel_kw)
        counted.launches += paged_flash_decode_attention.launches - before
        return out

    counted.launches = 0
    return counted


def _extend_lens(kb):
    """The rows of the two extend windows over the shared prefix: at 512
    (the first window) and 544 (the second), alternating."""
    return [SHARED_PAGES * PAGE + EXTEND_W * (i % 2) for i in range(kb)]


def phase_paged_extend(results):
    """B3 at the prefix cache's extend shapes, the batch-invariant plan the
    extend windows take, and B1 at an extend window's M."""
    from functools import partial

    from llmspeculativesampling_tpu_torch.kernels.flash_decode import INVARIANT_BSZ, plan
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul, plan as b1_plan
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_attention, paged_flash_decode_ref)

    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(9)
    rtol = atol = 2.0 ** -7
    kern = partial(paged_flash_decode_attention, batch_invariant=True)
    counted = _b3_counted(batch_invariant=True)
    log(f"[extend] tolerance as [paged_flash_decode]: {atol:.2e} + {rtol:.2e}*|plain| (one bf16 "
        "ulp), each case bit-identical across a repeat and contiguous inputs, one launch a call, "
        "counters 0; calls made with batch_invariant=True, as the extend windows make them")
    cases = [(_extend_lens(EXTEND_KB), hkv, quant) for hkv in (40, 6) for quant in (True, False)]
    cases += [([SHARED_PAGES * PAGE + EXTEND_W, 0, SHARED_PAGES * PAGE], 40, True)]  # an exhausted row
    worst = 0.0
    for lens, hkv, quant in cases:
        q, kn, vn, kp, vp, tables, lengths, bias, ks, vs = _extend_inputs(gen, lens, hkv, quant)
        max_abs, _ = _check_case(
            f"paged_flash_decode extend quant={quant} KB={len(lens)} Hkv={hkv} lens={lens}",
            counted, paged_flash_decode_ref, (q, kn, vn, kp, vp, tables, lengths, bias),
            dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
        worst = max(worst, max_abs)
        # batch invariance: row 0 alone gives the bits it gets among KB rows
        one = kern(q[:1], kn[:1], vn[:1], kp, vp, tables[:1], lengths[:1], bias[:1], scale=1.0,
                   k_scales=ks, v_scales=vs)
        full = kern(q, kn, vn, kp, vp, tables, lengths, bias, scale=1.0, k_scales=ks, v_scales=vs)
        if not torch.equal(one[0], full[0]):
            raise AssertionError(f"extend B3 KB={len(lens)} Hkv={hkv}: row 0 depends on its batch")
        own = paged_flash_decode_attention(q[:1], kn[:1], vn[:1], kp, vp, tables[:1], lengths[:1],
                                           bias[:1], scale=1.0, k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        log(f"[extend] KB={len(lens)} Hkv={hkv} int8={quant}: max_abs_err {max_abs:.3e}; row 0 "
            f"alone = row 0 of the batch under the invariant plan; planned from its own batch "
            f"(B=1, ps={plan(1, hkv, EXTEND_W, PAGE, EXTEND_PAGES).ps} against "
            f"{plan(INVARIANT_BSZ, hkv, EXTEND_W, PAGE, EXTEND_PAGES).ps}) it is "
            f"{'bit-identical' if torch.equal(own[0], full[0]) else 'not bit-identical'}")
    log(f"[extend] {len(cases)} cases within tolerance, worst max_abs_err {worst:.3e}")

    rows = {}
    for what, hkv in (("target", 40), ("draft", 6)):
        lens = _extend_lens(EXTEND_KB)
        t_k, t_p, t_l, n_sets = _time_paged_sets(
            lambda: _extend_inputs(gen, lens, hkv, True), EXTEND_W, True, batch_invariant=True)
        b_ms, b_by = _flash_bound(hkv, EXTEND_W, sum(lens), True, rows=EXTEND_KB,
                                  extra_bytes=EXTEND_KB * EXTEND_PAGES * 4,
                                  stored=SHARED_PAGES * PAGE + EXTEND_W * (EXTEND_KB // 2))
        p = plan(INVARIANT_BSZ, hkv, EXTEND_W, PAGE, EXTEND_PAGES)
        rows[what] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by)
        log(f"[extend] B3 {what} extend window: int8 pool, KB={EXTEND_KB}, Hkv={hkv}, S_new="
            f"{EXTEND_W}, 4 shared pages + 1 own, P={EXTEND_PAGES}, lens {lens[:2]}... (plan ps="
            f"{p.ps} blocks={p.blocks(EXTEND_KB, hkv)}): kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
            f"library_ms {t_l:.4f} (F.scaled_dot_product_attention over a pre-gathered view, "
            f"gather untimed) bound_us {b_ms * 1e3:.2f} ({b_by}) bound share {b_ms / t_k:.3f}; "
            f"{n_sets} input sets rotated ({card})")
    # what the invariant plan costs a hit admitted alone (KB=1)
    lens1 = _extend_lens(1)
    inv1, plain1, lib1, _ = _time_paged_sets(lambda: _extend_inputs(gen, lens1, 40, True), EXTEND_W,
                                             True, batch_invariant=True)
    own1 = _time_paged_sets(lambda: _extend_inputs(gen, lens1, 40, True), EXTEND_W, True)[0]
    b1_ms, b1_by = _flash_bound(40, EXTEND_W, sum(lens1), True, extra_bytes=EXTEND_PAGES * 4)
    log(f"[extend] B3 target, one hit alone (KB=1): invariant plan (ps="
        f"{plan(INVARIANT_BSZ, 40, EXTEND_W, PAGE, EXTEND_PAGES).ps}) kernel_ms {inv1:.4f}, plan "
        f"from B=1 (ps={plan(1, 40, EXTEND_W, PAGE, EXTEND_PAGES).ps}) kernel_ms {own1:.4f}; "
        f"plain_ms {plain1:.4f} library_ms {lib1:.4f} (SDPA over a pre-gathered view) bound_us "
        f"{b1_ms * 1e3:.2f} ({b1_by}) ({card})")
    # B1 at an extend window's M (32 a hit), the target's 40 x 7 projections + head
    b1 = {}
    for m in (EXTEND_W, EXTEND_KB * EXTEND_W):
        tot = {False: 0.0, True: 0.0}
        for k, n, per_layer in TARGET_SHAPES + [(5120, VOCAB, 1)]:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            ws = _rotated(lambda: torch.randint(-127, 128, (k, n), generator=gen,
                                                dtype=torch.int8, device="cuda"))
            sc = torch.rand((n,), generator=gen, device="cuda") / (73.0 * math.sqrt(k))
            for inv in (False, True):
                t = time_ms(lambda i: int8_matmul(x, ws[i % len(ws)], sc, batch_invariant=inv), 20)
                tot[inv] += (40 * per_layer if n != VOCAB else 1) * t
            del ws
        b1[m] = tot
        log(f"[extend] B1 one target forward at M={m} ({m // EXTEND_W} hit(s) x {EXTEND_W}): "
            f"batch-invariant plan (the extend's; 5120x5120 ksplit "
            f"{b1_plan(m, 5120, 5120, True)[1]}) kernel_ms {tot[True]:.3f}, plan from M (ksplit "
            f"{b1_plan(m, 5120, 5120)[1]}) kernel_ms {tot[False]:.3f} ({card})")
    r = rows["target"]
    results["extend"] = dict(
        b3=rows, b3_max_abs_err=worst,
        b3_one_hit_ms=dict(invariant=inv1, own=own1, plain_ms=plain1, library_ms=lib1,
                           bound_ms=b1_ms, bound_by=b1_by),
        b1_forward_ms={m: dict(invariant=v[True], from_m=v[False]) for m, v in b1.items()})
    log(f"[extend] one target extend window (40 B3 launches): kernel_ms {40 * r['ms']:.3f} "
        f"bound_ms {40 * r['bound_ms']:.4f}")


def _cold_verify_lens(gen):
    """The cold mix's verify rows: 10 decode rows of the short requests
    (lengths 64-121), a staged row at its first piggyback step (length 0:
    the verify rolls back to cur_len - 1 = 0) and one mid-prompt (481)."""
    return _uniform_lens(gen, COLD_ROWS - 2) + [0, 481]


def _draft_window_lens(kb):
    """Draft-only windows of staged 960-token prompts: KB rows at window
    offsets (multiples of 32) from the first to the last."""
    return [EXTEND_W * ((7 * i) % (COLD_LEN // EXTEND_W)) for i in range(kb)]


def phase_paged_sarathi(results):
    """B3 at the SARATHI and adaptive-gamma shapes: the adaptive arms'
    verifies (B=16 x Hkv 40 x S_new 5 / 17, two pages a row), the cold
    mix's (B=12 x 9 / 17 with a staged row at length 0 and one mid-prompt,
    8 pages a row) and the draft-only windows (KB 1 / 8 x Hkv 6 x 32 over
    a staged prompt's own pages, batch-invariant plan, as the windows run)."""
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import INVARIANT_BSZ, plan
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import paged_flash_decode_ref

    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(10)
    rtol = atol = 2.0 ** -7
    cold_p = -(-(COLD_LEN + COLD_NEW + SERVE_GAMMA + 1) // PAGE)
    shapes = [  # (what, lens, Hkv, S_new, P, batch-invariant)
        ("adaptive gamma-4 verify", _uniform_lens(gen, ROWS), 40, ADAPT_ARMS[0] + 1,
         ADAPT_PAGES, False),
        ("adaptive gamma-16 verify", _uniform_lens(gen, ROWS), 40, ADAPT_ARMS[2] + 1,
         ADAPT_PAGES, False),
        ("cold_mix verify", _cold_verify_lens(gen), 40, SERVE_GAMMA + 1, cold_p, False),
        ("cold_mix prefill_extra-8 verify", _cold_verify_lens(gen), 40,
         SERVE_GAMMA + 1 + COLD_EXTRA, cold_p, False),
        ("draft window KB=1", [COLD_LEN // 2], 6, EXTEND_W, cold_p, True),
        ("draft window KB=8", _draft_window_lens(EXTEND_KB), 6, EXTEND_W, cold_p, True),
    ]
    log(f"[sarathi B3] tolerance as [paged_flash_decode]: {atol:.2e} + {rtol:.2e}*|plain| (one "
        "bf16 ulp), each case bit-identical across a repeat and contiguous inputs, one launch a "
        "call, counters 0; the draft windows with batch_invariant=True, as they run")
    worst, rows = 0.0, {}
    for what, lens, hkv, s_new, p_max, inv in shapes:
        for quant in (True, False):
            q, kn, vn, kp, vp, tables, lengths, bias, ks, vs = _paged_inputs(
                gen, lens, hkv, hkv, s_new, 128, PAGE, p_max, quant)
            max_abs, _ = _check_case(
                f"paged_flash_decode {what} quant={quant} lens={lens}",
                _b3_counted(batch_invariant=inv),
                paged_flash_decode_ref, (q, kn, vn, kp, vp, tables, lengths, bias),
                dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
            worst = max(worst, max_abs)
        t_k, t_p, t_l, b_ms, b_by, n_sets = _time_paged(gen, lens, p_max, hkv, s_new, True,
                                                        batch_invariant=inv)
        p = plan(INVARIANT_BSZ if inv else len(lens), hkv, s_new, PAGE, p_max)
        rows[what] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                          rows=len(lens), hkv=hkv, s_new=s_new, live=sum(lens),
                          blocks=p.blocks(len(lens), hkv))
        log(f"[sarathi B3] {what}: int8 pool, B={len(lens)}, Hkv={hkv}, S_new={s_new}, P={p_max}, "
            f"{sum(lens)} live positions (plan ps={p.ps} blocks={p.blocks(len(lens), hkv)}"
            f"{', batch-invariant' if inv else ''}): max_abs_err within tolerance; kernel_ms "
            f"{t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} (F.scaled_dot_product_attention "
            f"over a pre-gathered view, gather untimed) bound_us {b_ms * 1e3:.2f} ({b_by}) bound "
            f"share {b_ms / t_k:.3f}; {n_sets} input sets rotated ({card})")
    log(f"[sarathi B3] {2 * len(shapes)} cases (int8 and bf16 pools) within tolerance, worst "
        f"max_abs_err {worst:.3e}")
    results["sarathi"] = dict(b3=rows, b3_max_abs_err=worst)


# ---------------------------------------------------------------- phase 2, OPT shapes
def phase_opt_int8_matmul(results):
    """B1 at the OPT path's six projections: target q/k/v/o 5120x5120, fc1
    5120x20480 and fc2 20480x5120 (K = 320 chunks of 64) at M = 1, 9, 64,
    144; the draft's 640x640, 640x2560 and 2560x640 at M = 1, 2, 16, 64; and
    fc2 at M = 512 under the admission prefill's batch-invariant plan
    beside the plan chosen from M. Each case bit-identical across a repeat.
    Then the dense tied head (not a B1 call): ``lm_head_logits``' bf16
    product with fp32 sums against the fp32 product it replaced."""
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref, plan
    from llmspeculativesampling_tpu_torch.models.linear import lm_head_logits

    gen = torch.Generator(device="cuda").manual_seed(21)
    rtol, atol_rel = 2.0 ** -7, 1e-3
    fwd = {}  # (model, M) -> summed times of one forward's 6 x layers calls
    worst = 0.0
    cases = [("target", m, k, n, c) for m in OPT_TARGET_M for k, n, c in OPT_TARGET_SHAPES]
    cases += [("draft", m, k, n, c) for m in OPT_DRAFT_M for k, n, c in OPT_DRAFT_SHAPES]
    cases += [("fc2 prefill", 512, 20480, 5120, 0)]
    for model, m, k, n, per_layer in cases:
        inv = model == "fc2 prefill"
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        ws = _rotated(lambda: torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8,
                                            device="cuda"))
        s = (0.8 + 0.4 * torch.rand((n,), generator=gen, device="cuda")) / (73.0 * math.sqrt(k))
        got = int8_matmul(x[None], ws[0], s, batch_invariant=inv)[0]
        again = int8_matmul(x[None], ws[0], s, batch_invariant=inv)[0]
        ref = int8_matmul_ref(x, ws[0], s)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"int8_matmul opt {model} M={m} K={k} N={n}: not bit-identical")
        max_abs, rel = check_close(f"int8_matmul opt {model} M={m} K={k} N={n}", got, ref, rtol,
                                   atol_rel * float(ref.float().abs().max()))
        worst = max(worst, max_abs)
        w16 = [w.to(torch.bfloat16) for w in ws]
        t_k = time_ms(lambda i: int8_matmul(x[None], ws[i % len(ws)], s, batch_invariant=inv), 20)
        t_p = time_ms(lambda i: int8_matmul_ref(x, ws[i % len(ws)], s), 5)
        t_l = time_ms(lambda i: torch.matmul(x, w16[i % len(w16)]), 20)
        b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * k * n)
        extra = ""
        if inv:
            got_m = int8_matmul(x[None], ws[0], s)[0]
            check_close("int8_matmul opt fc2 M=512 plan from M", got_m, ref, rtol,
                        atol_rel * float(ref.float().abs().max()))
            t_m = time_ms(lambda i: int8_matmul(x[None], ws[i % len(ws)], s), 20)
            extra = (f"; batch-invariant plan {plan(m, k, n, True)} (above) vs plan from M "
                     f"{plan(m, k, n)} kernel_ms {t_m:.4f}")
            results["opt_fc2_prefill"] = dict(invariant_ms=t_k, from_m_ms=t_m, bound_ms=b_ms)
        log(f"[opt int8_matmul] {model} M={m:3d} K={k:5d} N={n:5d} plan "
            f"{plan(m, k, n, inv)}: max_abs_err {max_abs:.3e} (rel {rel:.1e}) kernel_ms {t_k:.4f} "
            f"plain_ms {t_p:.4f} library_ms {t_l:.4f} bound_us {b_ms * 1e3:.1f} ({b_by}) "
            f"bound share {b_ms / t_k:.3f}{extra}")
        if not inv:
            calls = (40 if model == "target" else 2) * per_layer
            f = fwd.setdefault((model, m), dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                                bound_ms=0.0))
            for key, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                           ("bound_ms", b_ms)):
                f[key] += calls * t
            f["bound_by"] = b_by
        del ws, w16
    for (model, m), f in fwd.items():
        log(f"[opt int8_matmul] one {model} forward at M={m} ({240 if model == 'target' else 12} "
            f"calls): kernel_ms {f['ms']:.3f} plain_ms {f['plain_ms']:.3f} library_ms "
            f"{f['library_ms']:.3f} bound_ms {f['bound_ms']:.3f} ({f['bound_by']}) bound share "
            f"{f['bound_ms'] / f['ms']:.3f}")
    results["opt_int8_matmul"] = dict(max_abs_err=worst, forwards={
        f"{model} M={m}": f for (model, m), f in fwd.items()})

    # the dense tied head [V, H] bf16: lm_head_logits (bf16 operands, fp32
    # sums and output) against the fp32 product of the widened operands
    # (the same exact products summed in other orders: 1e-5 of max|plain|)
    heads = {}
    for model, hid, ms_ in (("target", 5120, (1, OPT_GAMMA + 1, ROWS * (SERVE_GAMMA + 1))),
                            ("draft", 640, (1, ROWS))):
        heads_sets = _rotated(lambda: torch.randn((50272, hid), generator=gen, device="cuda")
                              .to(torch.bfloat16))
        for m in ms_:
            h = torch.randn((1, m, hid), generator=gen, device="cuda").to(torch.bfloat16)
            got = lm_head_logits(h, heads_sets[0])
            ref = h.float() @ heads_sets[0].float().t()
            max_abs, _ = check_close(f"dense head {model} M={m}", got, ref, 0.0,
                                     1e-5 * float(ref.abs().max()))
            t_k = time_ms(lambda i: lm_head_logits(h, heads_sets[i % len(heads_sets)]), 20)
            t_p = time_ms(lambda i: h.float() @ heads_sets[i % len(heads_sets)].float().t(), 5)
            b_ms, b_by = bound(50272 * hid * 2 + m * hid * 2 + m * 50272 * 4, 2 * m * hid * 50272)
            log(f"[opt head] dense tied {model} head 50272x{hid} bf16, M={m}: max_abs_err "
                f"{max_abs:.3e} lm_head_logits_ms {t_k:.4f} (torch.mm, bf16 operands, fp32 out) "
                f"fp32-copy product_ms {t_p:.4f} bound_us {b_ms * 1e3:.1f} ({b_by}) bound share "
                f"{b_ms / t_k:.3f}")
            heads[f"{model} M={m}"] = dict(ms=t_k, fp32_copy_ms=t_p, bound_ms=b_ms)
        del heads_sets
    results["opt_head"] = heads


def phase_opt_attention(results):
    """B2 and B3 at the OPT path's shapes (D=128): B2 at the target verify
    (Hkv 40 x S_new 9), the beam-v2 tree verify (1 x 17 under an ancestor
    bias) and the draft (Hkv 5 x S_new 1/2); B3 at the serving verify (B=16,
    Hkv 40, S_new 9) and the draft's step and re-feed (Hkv 5), int8 pools
    as served and bf16. Each case as the earlier phases hold them."""
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref, plan)
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_attention, paged_flash_decode_ref)

    gen = torch.Generator(device="cuda").manual_seed(22)
    rtol = atol = 2.0 ** -7
    cases = []  # (what, hkv, s_new, lens, tree)
    for lens in ([64], [100], [128], [S_MAX - OPT_GAMMA - 1]):
        cases.append(("target verify", 40, OPT_GAMMA + 1, lens, False))
    for lens in ([64], [TREE_PREFIX], [200]):
        cases.append(("tree verify", 40, TREE_TOKENS, lens, True))
    for lens in ([0], [64], [127], [128], [S_MAX - 2]):
        cases += [("draft", 5, 1, lens, False), ("draft re-feed", 5, 2, lens, False)]
    worst = 0.0
    for quant in (False, True):
        for what, hkv, s_new, lens, tree in cases:
            q, kn, vn, kc, vc, lengths, bias, ks, vs = _rows_inputs(gen, 1, hkv, s_new, quant, lens,
                                                                   tree)
            max_abs, _ = _check_case(
                f"flash_decode opt {what} quant={quant} Hkv={hkv} S_new={s_new} len={lens}",
                flash_decode_attention, flash_decode_ref, (q, kn, vn, kc, vc, lengths, bias),
                dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
            worst = max(worst, max_abs)
    paged_cases = []  # (lens, hkv, s_new, p_max, tree)
    for hkv, s_new in ((40, OPT_GAMMA + 1), (5, 1), (5, 2)):
        paged_cases += [(_uniform_lens(gen, ROWS), hkv, s_new, 1, False),
                        (MIXED_LENS, hkv, s_new, 6, hkv == 40)]
    for quant in (True, False):
        for lens, hkv, s_new, p_max, tree in paged_cases:
            q, kn, vn, kp, vp, tables, lengths, bias, ks, vs = _paged_inputs(
                gen, lens, hkv, hkv, s_new, 128, PAGE, p_max, quant, tree)
            max_abs, _ = _check_case(
                f"paged_flash_decode opt quant={quant} Hkv={hkv} S_new={s_new} P={p_max}",
                paged_flash_decode_attention, paged_flash_decode_ref,
                (q, kn, vn, kp, vp, tables, lengths, bias),
                dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
            worst = max(worst, max_abs)
    log(f"[opt attention] {2 * len(cases)} B2 and {2 * len(paged_cases)} B3 cases within "
        f"tolerance (bf16 and int8 KV; B2 Hkv 40 x S_new {OPT_GAMMA + 1}, 1 x {TREE_TOKENS} tree, "
        f"Hkv 5 x S_new 1/2; B3 B=16 Hkv 40 x S_new {OPT_GAMMA + 1} and Hkv 5 x 1/2, uniform and "
        f"mixed lengths), worst max_abs_err {worst:.3e}")
    rows = {}
    for what, hkv, s_new, length, tree in (
            ("B2 target verify", 40, OPT_GAMMA + 1, 128, False),
            ("B2 tree verify", 40, TREE_TOKENS, TREE_PREFIX, True),
            ("B2 draft decode", 5, 1, 128, False), ("B2 draft re-feed", 5, 2, 128, False)):
        t_k, t_p, t_l, b_ms, b_by, n_sets = _time_flash(gen, hkv, s_new, [length], tree=tree)
        p = plan(1, hkv, s_new, S_MAX)
        log(f"[opt attention] {what}: dense B=1 Hkv={hkv} S_new={s_new} len={length} plan "
            f"ps={p.ps} blocks={p.blocks(1, hkv)}: kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
            f"library_ms {t_l:.4f} (F.scaled_dot_product_attention) bound_us {b_ms * 1e3:.2f} "
            f"({b_by}) bound share {b_ms / t_k:.3f}; {n_sets} input sets rotated")
        rows[what] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by)
    for what, hkv, s_new in (("B3 serving verify", 40, SERVE_GAMMA + 1),
                             ("B3 draft step", 5, 1), ("B3 draft re-feed", 5, 2)):
        lens = _uniform_lens(gen, ROWS)
        t_k, t_p, t_l, b_ms, b_by, n_sets = _time_paged(gen, lens, 1, hkv, s_new, True)
        p = plan(ROWS, hkv, s_new, PAGE, 1)
        log(f"[opt attention] {what}: int8 pool, uniform lengths (B=16, Hkv={hkv}, S_new={s_new}, "
            f"{sum(lens)} live positions; plan ps={p.ps} blocks={p.blocks(ROWS, hkv)}): kernel_ms "
            f"{t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} (SDPA over a pre-gathered view) "
            f"bound_us {b_ms * 1e3:.2f} ({b_by}) bound share {b_ms / t_k:.3f}; {n_sets} input sets "
            "rotated")
        rows[what] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by)
    results["opt_attention"] = dict(max_abs_err=worst, per_call=rows)


def phase_flash_harness(results):
    """B2 at the evaluation harness's shapes (synthetic_pair's Llama: bf16,
    Hkv 16, D 128, S_max 256: the verify 1 x 5, decode 1 x 1, re-feed
    1 x 2, BiLD's check 1 x 11, multi's verify 4 x 5, random beam's decode
    8 x 1) and the trained pair's (fp32, Hkv 4, S_max 128: the target's
    D 64 verify 1 x 5 and decode, the draft's D 32 step and re-feed)."""
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref, plan)

    gen = torch.Generator(device="cuda").manual_seed(14)
    g1, top = HARNESS_GAMMA + 1, HARNESS_S_MAX
    harness = [("verify", 1, g1, [n]) for n in (59, 64, 96, 128, top - g1)]
    harness += [("decode", 1, 1, [n]) for n in (64, 127, 128, top - 1)]
    harness += [("draft re-feed", 1, 2, [96]), ("BiLD check", 1, 11, [64]),
                ("BiLD check", 1, 11, [top - 11]), ("multi verify", 4, g1, [64, 97, 150, 200]),
                ("random-beam decode", 8, 1, [96] * 8)]
    trained = [("target verify", 64, g1, [n]) for n in (32, 63, 64, 100, TRAINED_S_MAX - g1)]
    trained += [("target decode", 64, 1, [n]) for n in (32, 80)]
    trained += [("draft step", 32, 1, [n]) for n in (32, 80)] + [("draft re-feed", 32, 2, [80])]
    worst = {}
    for tag, cases, dtype, s_max, tol in (
            ("harness", [(w, b, s, ls, 128) for w, b, s, ls in harness], torch.bfloat16,
             HARNESS_S_MAX, 2.0 ** -7),
            ("trained", [(w, 1, s, ls, d) for w, d, s, ls in trained], torch.float32,
             TRAINED_S_MAX, 1e-4)):
        hkv = HARNESS_HKV if tag == "harness" else 4
        for what, b, s_new, lens, d in cases:
            q, kn, vn, kc, vc, lengths, bias, _, _ = _rows_inputs(
                gen, b, hkv, s_new, False, lens, False, d=d, dtype=dtype, s_max=s_max)
            scale = 1.0 if dtype == torch.bfloat16 else d ** -0.5
            max_abs, _ = _check_case(
                f"flash_decode {tag} {what} B={b} Hkv={hkv} S_new={s_new} D={d} len={lens}",
                flash_decode_attention, flash_decode_ref, (q, kn, vn, kc, vc, lengths, bias),
                dict(scale=scale), tol, tol)
            worst[tag] = max(worst.get(tag, 0.0), max_abs)
    log(f"[flash_decode harness] {len(harness)} harness cases (bf16, Hkv 16, D 128, S_max 256; "
        f"tol {2.0 ** -7:.2e} + {2.0 ** -7:.2e}*|plain|) worst max_abs_err {worst['harness']:.3e}; "
        f"{len(trained)} trained-pair cases (fp32, Hkv 4, D 64 / 32, S_max 128; tol 1e-4 + "
        f"1e-4*|plain|) worst {worst['trained']:.3e}")
    rows = {}
    for what, hkv, s_new, d, dtype, s_max, length in (
            ("harness verify", HARNESS_HKV, g1, 128, torch.bfloat16, HARNESS_S_MAX, 96),
            ("harness decode", HARNESS_HKV, 1, 128, torch.bfloat16, HARNESS_S_MAX, 96),
            ("trained target verify", 4, g1, 64, torch.float32, TRAINED_S_MAX, 64),
            ("trained draft step", 4, 1, 32, torch.float32, TRAINED_S_MAX, 64)):
        t_k, t_p, t_l, b_ms, b_by, n_sets = _time_flash(gen, hkv, s_new, [length], d=d,
                                                        dtype=dtype, s_max=s_max)
        p = plan(1, hkv, s_new, s_max)
        log(f"[flash_decode harness] {what}: {str(dtype)[6:]} B=1 Hkv={hkv} S_new={s_new} D={d} "
            f"len={length} S_max={s_max} plan ps={p.ps} blocks={p.blocks(1, hkv)}: kernel_ms "
            f"{t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} (F.scaled_dot_product_attention, "
            f"causal as a float mask) bound_us {b_ms * 1e3:.3f} ({b_by}) bound share "
            f"{b_ms / t_k:.3f}; {n_sets} input sets rotated")
        rows[what] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by)
    results["flash_decode_harness"] = dict(max_abs_err=worst, per_call=rows)


def phase_trained_int8_matmul(results):
    """B1 at the trained pair's int8 target (256 wide, 4 layers, ffn 1024;
    fp32 activations, which the kernel rounds to bf16 as the plain version
    does): each projection against the plain version at M = 1 (decode), 5
    (the verify), 64 (the prompt bucket) and 128 (get_score's padded
    forward), and one forward's 28 calls timed at M 1 and 5."""
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref, plan

    gen = torch.Generator(device="cuda").manual_seed(15)
    timed_m = (1, TRAINED_GAMMA + 1)
    fwd = {m: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0) for m in timed_m}
    worst = 0.0
    for m in timed_m + (64, 128):
        for k, n, per_layer in TRAINED_SHAPES:
            x = torch.randn((m, k), generator=gen, device="cuda")
            ws = _rotated(lambda: torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8,
                                                device="cuda"))
            s = (0.8 + 0.4 * torch.rand((n,), generator=gen, device="cuda")) / (73.0 * math.sqrt(k))
            ref = int8_matmul_ref(x, ws[0], s)
            max_abs, _ = check_close(f"int8_matmul trained M={m} K={k} N={n}",
                                     int8_matmul(x[None], ws[0], s)[0], ref, 0.0,
                                     1e-4 * float(ref.abs().max()))
            worst = max(worst, max_abs)
            if m not in fwd:
                del ws
                continue
            xb, w16 = x.to(torch.bfloat16), [w.to(torch.bfloat16) for w in ws]
            t_k = time_ms(lambda i: int8_matmul(x[None], ws[i % len(ws)], s), 20)
            t_p = time_ms(lambda i: int8_matmul_ref(x, ws[i % len(ws)], s), 5)
            t_l = time_ms(lambda i: torch.matmul(xb, w16[i % len(w16)]), 20)
            b_ms, b_by = bound(m * k * 4 + k * n + n * 4 + m * n * 4, 2 * m * k * n)
            log(f"[int8_matmul trained] M={m} K={k} N={n} plan {plan(m, k, n)}: max_abs_err "
                f"{max_abs:.3e} kernel_ms {t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} "
                f"(torch.matmul on pre-cast bf16) bound_us {b_ms * 1e3:.3f} ({b_by}) bound share "
                f"{b_ms / t_k:.3f}")
            for key, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms)):
                fwd[m][key] += TRAINED_LAYERS * per_layer * t
            fwd[m]["bound_by"] = b_by
            del ws, w16
    for m, f in fwd.items():
        log(f"[int8_matmul trained] one int8 target forward ({7 * TRAINED_LAYERS} launches at "
            f"M={m}): kernel_ms {f['ms']:.4f} plain_ms {f['plain_ms']:.4f} library_ms "
            f"{f['library_ms']:.4f} bound_ms {f['bound_ms']:.5f} ({f['bound_by']}) bound share "
            f"{f['bound_ms'] / f['ms']:.3f}; every projection within 1e-4*max|plain| at M 1, 5, "
            f"64, 128 (worst {worst:.3e})")
    results["int8_matmul_trained"] = dict(forwards=fwd, max_abs_err=worst)


# ---------------------------------------------------------------- phase 3
def phase_tp_kernels(results):
    """B1, B2 and B3 through their public wrappers at one tp=2 rank's shard
    shapes, against their plain versions on the card: B1 at the column-
    and row-parallel projections (o and down with fp32 output) and the
    half-vocab head, M = 1, 25 and 144 (draft M = 1, 2 and 16); B2 at the
    single-stream verify (Hkv 20 x 25, len 128), the AR decode, the draft
    (Hkv 3 x 1 / 2) and the slotted verify (16 x Hkv 20 x 9, int8 KV,
    per-slot lengths); B3 at the serving verify (16 x Hkv 20 x 9, int8
    pool, uniform lengths) and the serving draft (Hkv 3 x 1 / 2). Times,
    bounds, plain and library times, and B2/B3's block counts."""
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref, plan as flash_plan)
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref, plan
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_attention, paged_flash_decode_ref)

    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(21)
    rtol, atol_rel = 2.0 ** -7, 1e-3
    log(f"[tp B1] tolerance: bf16 output {rtol:.2e}*|plain| + {atol_rel:.0e}*max|plain| (as "
        "[int8_matmul]); fp32 output (the row-parallel partials) 1e-4*max|plain|: the same exact "
        "products summed in fp32 in other orders")
    fwd = {(model, m): dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
           for model, ms in (("target", TP_TARGET_M), ("draft", TP_DRAFT_M)) for m in ms}
    worst_b1 = 0.0
    cases = [("target", m, *shape) for m in TP_TARGET_M for shape in TP_TARGET_SHAPES]
    cases += [("draft", m, *shape) for m in TP_DRAFT_M for shape in TP_DRAFT_SHAPES]
    for model, m, k, n, per_layer, f32 in cases:
        out_dtype = torch.float32 if f32 else None
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        ws = _rotated(lambda: torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8,
                                            device="cuda"))
        s = (0.8 + 0.4 * torch.rand((n,), generator=gen, device="cuda")) / (73.0 * math.sqrt(k))
        got = int8_matmul(x[None], ws[0], s, out_dtype=out_dtype)[0]
        ref = int8_matmul_ref(x, ws[0], s, out_dtype)
        top = float(ref.float().abs().max())
        max_abs, rel = check_close(f"tp int8_matmul {model} M={m} K={k} N={n} fp32_out={f32}", got,
                                   ref, 0.0 if f32 else rtol, (1e-4 if f32 else atol_rel) * top)
        worst_b1 = max(worst_b1, max_abs)
        w16 = [w.to(torch.bfloat16) for w in ws]
        t_k = time_ms(lambda i: int8_matmul(x[None], ws[i % len(ws)], s, out_dtype=out_dtype), 20)
        t_p = time_ms(lambda i: int8_matmul_ref(x, ws[i % len(ws)], s, out_dtype), 5)
        if f32:
            t_l = time_ms(lambda i: torch.mm(x, w16[i % len(w16)], out_dtype=torch.float32), 20)
        else:
            t_l = time_ms(lambda i: torch.matmul(x, w16[i % len(w16)]), 20)
        b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * (4 if f32 else 2), 2 * m * k * n)
        log(f"[tp B1] {model} M={m:3d} K={k:5d} N={n:5d}{' fp32 out' if f32 else ''} plan "
            f"{plan(m, k, n)}: max_abs_err {max_abs:.3e} (rel {rel:.1e}) kernel_ms {t_k:.4f} "
            f"plain_ms {t_p:.4f} library_ms {t_l:.4f} ({'torch.mm fp32 out' if f32 else 'torch.matmul'}"
            f" on pre-widened bf16) bound_us {b_ms * 1e3:.1f} ({b_by}) bound share {b_ms / t_k:.3f}")
        calls = (40 if model == "target" else 2) * per_layer or 1
        row = fwd[(model, m)]
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms)):
            row[key] += calls * t
        row["bound_by"] = b_by
        del ws, w16
    for (model, m), f in fwd.items():
        calls = 281 if model == "target" else 15
        log(f"[tp B1] one tp=2 rank's {model} forward ({calls} launches at M={m}): kernel_ms "
            f"{f['ms']:.3f} plain_ms {f['plain_ms']:.3f} library_ms {f['library_ms']:.3f} bound_ms "
            f"{f['bound_ms']:.3f} ({f['bound_by']}) bound share {f['bound_ms'] / f['ms']:.3f} ({card})")

    rtol = atol = 2.0 ** -7
    log(f"[tp B2/B3] tolerance as [flash_decode]: {atol:.2e} + {rtol:.2e}*|plain|, each case "
        "bit-identical across a repeat and contiguous inputs, one launch a call, counters 0")
    worst_b2 = worst_b3 = 0.0
    per_call = {}
    b2_cases = [("B2 target verify", 20, GAMMA + 1, [128], False),
                ("B2 AR decode", 20, 1, [128], False),
                ("B2 draft step", 3, 1, [128], False), ("B2 draft re-feed", 3, 2, [128], False),
                ("B2 slotted verify", 20, SERVE_GAMMA + 1, _slot_lens(SERVE_GAMMA + 1), True)]
    for what, hkv, s_new, lens, quant in b2_cases:
        q, kn, vn, kc, vc, lengths, bias, ks, vs = _rows_inputs(gen, len(lens), hkv, s_new, quant,
                                                               lens, False)
        max_abs, _ = _check_case(f"tp flash_decode {what}", flash_decode_attention,
                                 flash_decode_ref, (q, kn, vn, kc, vc, lengths, bias),
                                 dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
        worst_b2 = max(worst_b2, max_abs)
        t_k, t_p, t_l, b_ms, b_by, n_sets = _time_flash(gen, hkv, s_new, lens, quant)
        blocks = flash_plan(len(lens), hkv, s_new, S_MAX).blocks(len(lens), hkv)
        per_call[what] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                              blocks=blocks)
        log(f"[tp B2] {what}: {'int8-KV' if quant else 'dense'} B={len(lens)} Hkv={hkv} "
            f"S_new={s_new} lens {lens if len(lens) == 1 else sum(lens)} ({blocks} blocks): kernel_ms "
            f"{t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} (SDPA) bound_us {b_ms * 1e3:.2f} "
            f"({b_by}) bound share {b_ms / t_k:.3f}; {n_sets} input sets rotated ({card})")
    uniform = _uniform_lens(gen, ROWS)
    for what, hkv, s_new in (("B3 serving verify", 20, SERVE_GAMMA + 1),
                             ("B3 serving draft step", 3, 1), ("B3 serving draft re-feed", 3, 2)):
        q, kn, vn, kp, vp, tables, lengths, bias, ks, vs = _paged_inputs(
            gen, uniform, hkv, hkv, s_new, 128, PAGE, 1, True)
        max_abs, _ = _check_case(f"tp paged_flash_decode {what}", paged_flash_decode_attention,
                                 paged_flash_decode_ref, (q, kn, vn, kp, vp, tables, lengths, bias),
                                 dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
        worst_b3 = max(worst_b3, max_abs)
        t_k, t_p, t_l, b_ms, b_by, n_sets = _time_paged(gen, uniform, 1, hkv, s_new, True)
        blocks = flash_plan(ROWS, hkv, s_new, PAGE, 1).blocks(ROWS, hkv)
        per_call[what] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                              blocks=blocks)
        log(f"[tp B3] {what}: int8 pool B={ROWS} Hkv={hkv} S_new={s_new}, {sum(uniform)} live "
            f"positions, P=1 ({blocks} blocks): kernel_ms {t_k:.4f} plain_ms {t_p:.4f} library_ms "
            f"{t_l:.4f} (SDPA over a pre-gathered view) bound_us {b_ms * 1e3:.2f} ({b_by}) bound "
            f"share {b_ms / t_k:.3f}; {n_sets} input sets rotated ({card})")
    log(f"[tp B2/B3] worst max_abs_err B2 {worst_b2:.3e} B3 {worst_b3:.3e}")
    results["tp_kernels"] = dict(b1=fwd, b1_max_abs_err=worst_b1, per_call=per_call,
                                 b2_max_abs_err=worst_b2, b3_max_abs_err=worst_b3)


def phase_dp_kernels(results):
    """B1, B2 and B3 through their public wrappers at one dp=2 rank's
    shapes, against their plain versions on the card: B1 at the target's
    projections and head at M = 8 x 9 = 72 (a rank's verify; the plan
    takes its K split from M) and the draft's at M = 8 (its draft step);
    B2 at the slotted verify (8 slots x Hkv 40 x S_new 9 over S_max 256,
    int8 KV, per-slot lengths); B3 at the paged verify (B=8 x Hkv 40 x 9,
    a 16-block int8 pool, tables of P = 16). Times, bounds, plain and
    library times, and B2/B3's block counts."""
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref, plan as flash_plan)
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref, plan
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_attention, paged_flash_decode_ref)

    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(31)
    rtol, atol_rel = 2.0 ** -7, 1e-3
    log(f"[dp B1] tolerance as [int8_matmul]: {rtol:.2e}*|plain| + {atol_rel:.0e}*max|plain|")
    fwd = {(model, m): dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
           for model, m in (("target", DP_TARGET_M), ("draft", DP_DRAFT_M))}
    worst_b1 = 0.0
    cases = [("target", DP_TARGET_M, k, n, c) for k, n, c in TARGET_SHAPES + [(5120, VOCAB, 0)]]
    cases += [("draft", DP_DRAFT_M, k, n, c) for k, n, c in DRAFT_SHAPES + [(768, VOCAB, 0)]]
    for model, m, k, n, per_layer in cases:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        ws = _rotated(lambda: torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8,
                                            device="cuda"))
        s = (0.8 + 0.4 * torch.rand((n,), generator=gen, device="cuda")) / (73.0 * math.sqrt(k))
        got = int8_matmul(x[None], ws[0], s)[0]
        ref = int8_matmul_ref(x, ws[0], s)
        top = float(ref.float().abs().max())
        max_abs, rel = check_close(f"dp int8_matmul {model} M={m} K={k} N={n}", got, ref, rtol,
                                   atol_rel * top)
        worst_b1 = max(worst_b1, max_abs)
        w16 = [w.to(torch.bfloat16) for w in ws]
        t_k = time_ms(lambda i: int8_matmul(x[None], ws[i % len(ws)], s), 20)
        t_p = time_ms(lambda i: int8_matmul_ref(x, ws[i % len(ws)], s), 5)
        t_l = time_ms(lambda i: torch.matmul(x, w16[i % len(w16)]), 20)
        b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * k * n)
        log(f"[dp B1] {model} M={m:3d} K={k:5d} N={n:5d} plan {plan(m, k, n)}: max_abs_err "
            f"{max_abs:.3e} (rel {rel:.1e}) kernel_ms {t_k:.4f} plain_ms {t_p:.4f} library_ms "
            f"{t_l:.4f} (torch.matmul on pre-widened bf16) bound_us {b_ms * 1e3:.1f} ({b_by}) bound "
            f"share {b_ms / t_k:.3f}")
        calls = (40 if model == "target" else 2) * per_layer or 1
        row = fwd[(model, m)]
        for key, t in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l), ("bound_ms", b_ms)):
            row[key] += calls * t
        row["bound_by"] = b_by
        del ws, w16
    for (model, m), f in fwd.items():
        calls = 281 if model == "target" else 15
        log(f"[dp B1] one dp=2 rank's {model} forward ({calls} launches at M={m}): kernel_ms "
            f"{f['ms']:.3f} plain_ms {f['plain_ms']:.3f} library_ms {f['library_ms']:.3f} bound_ms "
            f"{f['bound_ms']:.3f} ({f['bound_by']}) bound share {f['bound_ms'] / f['ms']:.3f} ({card})")

    rtol = atol = 2.0 ** -7
    log(f"[dp B2/B3] tolerance as [flash_decode]: {atol:.2e} + {rtol:.2e}*|plain|, each case "
        "bit-identical across a repeat and contiguous inputs, one launch a call, counters 0")
    s9, per_call = SERVE_GAMMA + 1, {}
    lens = _slot_lens(s9)[:DP_ROWS]
    q, kn, vn, kc, vc, lengths, bias, ks, vs = _rows_inputs(gen, DP_ROWS, 40, s9, True, lens, False)
    worst_b2, _ = _check_case("dp flash_decode slotted verify", flash_decode_attention,
                              flash_decode_ref, (q, kn, vn, kc, vc, lengths, bias),
                              dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
    t_k, t_p, t_l, b_ms, b_by, n_sets = _time_flash(gen, 40, s9, lens, True)
    blocks = flash_plan(DP_ROWS, 40, s9, S_MAX).blocks(DP_ROWS, 40)
    per_call["B2 slotted verify"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                                         bound_by=b_by, blocks=blocks)
    log(f"[dp B2] slotted verify: int8-KV B={DP_ROWS} Hkv=40 S_new={s9} over S_max {S_MAX}, lens "
        f"{lens} ({blocks} blocks): kernel_ms {t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} "
        f"(SDPA over a dequantized view) bound_us {b_ms * 1e3:.2f} ({b_by}) bound share "
        f"{b_ms / t_k:.3f}; {n_sets} input sets rotated ({card})")
    uniform = _uniform_lens(gen, DP_ROWS)
    q, kn, vn, kp, vp, tables, lengths, bias, ks, vs = _paged_inputs(
        gen, uniform, 40, 40, s9, 128, PAGE, DP_PAGES, True, n_blocks=DP_BLOCKS)
    worst_b3, _ = _check_case("dp paged_flash_decode paged verify", paged_flash_decode_attention,
                              paged_flash_decode_ref, (q, kn, vn, kp, vp, tables, lengths, bias),
                              dict(scale=1.0, k_scales=ks, v_scales=vs), rtol, atol)
    t_k, t_p, t_l, b_ms, b_by, n_sets = _time_paged(gen, uniform, DP_PAGES, 40, s9, True,
                                                    n_blocks=DP_BLOCKS)
    blocks = flash_plan(DP_ROWS, 40, s9, PAGE, DP_PAGES).blocks(DP_ROWS, 40)
    per_call["B3 paged verify"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                                       bound_by=b_by, blocks=blocks)
    log(f"[dp B3] paged verify: int8 pool of {DP_BLOCKS} blocks, B={DP_ROWS} Hkv=40 S_new={s9}, "
        f"{sum(uniform)} live positions, P={DP_PAGES} ({blocks} blocks): kernel_ms {t_k:.4f} "
        f"plain_ms {t_p:.4f} library_ms {t_l:.4f} (SDPA over a pre-gathered view) bound_us "
        f"{b_ms * 1e3:.2f} ({b_by}) bound share {b_ms / t_k:.3f}; {n_sets} input sets rotated "
        f"({card})")
    log(f"[dp B1/B2/B3] worst max_abs_err B1 {worst_b1:.3e} B2 {worst_b2:.3e} B3 {worst_b3:.3e}")
    results["dp_kernels"] = dict(b1=fwd, b1_max_abs_err=worst_b1, per_call=per_call,
                                 b2_max_abs_err=worst_b2, b3_max_abs_err=worst_b3)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _hold_logits(tag: str, g: torch.Tensor, r: torch.Tensor, rel_tol: float = 3e-2):
    """Card logits ``g`` against the CPU's ``r`` (both float, on the CPU):
    finite, the same shape, relative error within ``rel_tol`` and the same
    argmax wherever the CPU's top-2 gap exceeds twice the largest
    difference (bf16 activations round at the same places on both devices
    but sum in other orders; random weights leave many near-ties)."""
    if not torch.isfinite(g).all() or g.shape != r.shape:
        raise AssertionError(f"{tag}: bad logits {tuple(g.shape)}")
    max_abs = float((g - r).abs().max())
    rel = max_abs / float(r.abs().max())
    top2 = r.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * max_abs
    agree = (g.argmax(-1) == r.argmax(-1)) | ~clear
    log(f"{tag}: max|gpu-cpu|/max|cpu| {rel:.2e} (tol {rel_tol:.0e}); argmax agrees at "
        f"{int(agree.sum())}/{agree.numel()} positions ({int(clear.sum())} with a clear top-2 gap, "
        "which must agree)")
    if rel > rel_tol or not bool(agree.all()):
        raise AssertionError(f"{tag}: gpu and cpu logits disagree")


def phase_forward():
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8

    _, _, bt, pt = synthetic_pair_int8(num_layers=2, draft_layers=2, seed=5, device="cuda")
    pc = _to_cpu(pt)
    cfg = bt.cfg
    rng = np.random.default_rng(3)
    pre = torch.as_tensor(rng.integers(100, 31000, (1, 64)), dtype=torch.long)
    ver = torch.as_tensor(rng.integers(100, 31000, (1, GAMMA + 1)), dtype=torch.long)
    dec = torch.as_tensor(rng.integers(100, 31000, (1, 1)), dtype=torch.long)
    outs = {}
    for dev, params in (("cuda", pt), ("cpu", pc)):
        cache = bt.make_cache(1, S_MAX, device=dev)
        l0, cache = bt.forward(params, cfg, pre.to(dev), cache)
        l1, cache = bt.forward(params, cfg, ver.to(dev), cache)
        l2, cache = bt.forward(params, cfg, dec.to(dev), cache)
        outs[dev] = [t.float().cpu() for t in (l0, l1, l2)]
    for name, g, r in zip(("prefill 64", "verify 25", "decode 1"), outs["cuda"], outs["cpu"]):
        _hold_logits(f"[forward] 2-layer 5120-wide int8 {name}", g, r)
    del pt, pc


def phase_paged_forward():
    """The same 2-layer slice through a paged int8 pool on the card vs the
    CPU: a prefill of empty rows (paged_prefill), per-row rollbacks, a
    verify block and a decode step (the paged kernel), the draft's
    two-token re-feed, and a 40-token block (the gather path) that crosses
    a page edge. Row 3 holds the sentinel table; rows 0-2 are compared."""
    import dataclasses

    from llmspeculativesampling_tpu_torch.cache.paged import init_paged_cache, set_row_table
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_attention)

    _, _, bt, pt = synthetic_pair_int8(num_layers=2, draft_layers=2, seed=6, device="cuda")
    pc = _to_cpu(pt)
    cfg = bt.cfg
    rng = np.random.default_rng(7)
    tables = [[5, 11, 2], [9, 0, 14], [3, 7, 12], []]
    steps = [("prefill 64", 64, None), ("verify 9", 9, [64, 50, 37, 0]), ("decode 1", 1, None),
             ("re-feed 2", 2, [70, 58, 47, 0]), ("block 40 over a page edge", 40, [120, 100, 60, 0])]
    toks = {n: torch.as_tensor(rng.integers(100, 31000, (4, w)), dtype=torch.long)
            for n, w, _ in steps}
    outs = {}
    launches = paged_flash_decode_attention.launches
    for dev, params in (("cuda", pt), ("cpu", pc)):
        cache = init_paged_cache(cfg.num_layers, 16, cfg.num_kv_heads, PAGE, cfg.head_dim, 4, 3,
                                 quant=True, device=dev)
        for row, blocks in enumerate(tables):
            set_row_table(cache, row, blocks + [16] * (3 - len(blocks)), 0)
        outs[dev] = []
        for name, _, rollback in steps:
            if rollback is not None:
                cache = dataclasses.replace(
                    cache, lengths=torch.tensor(rollback, dtype=torch.int32, device=dev))
            logits, cache = bt.forward(params, cfg, toks[name].to(dev), cache,
                                       paged_prefill=name.startswith("prefill"))
            outs[dev].append(logits[:3].float().cpu())
    if paged_flash_decode_attention.launches - launches != 3 * cfg.num_layers:
        raise AssertionError("the paged forward did not take the paged kernel on its short blocks")
    for (name, _, _), g, r in zip(steps, outs["cuda"], outs["cpu"]):
        _hold_logits(f"[paged forward] 2-layer 5120-wide int8, int8 pool, {name}", g, r)
    del pt, pc


def phase_prefix_forward():
    """Prefix reuse in one forward of the 2-layer slice, int8 pool: a
    576-token prompt prefilled monolithically (the miss path) against its
    first 512 tokens prefilled (the registered prefix) and the last 64 in
    two 32-token extend windows (the hit path: B3 over the 4 prefix pages,
    planned batch-invariant). The last position's logits and the suffix's
    KV must agree within _hold_logits's 3e-2."""
    import dataclasses

    from llmspeculativesampling_tpu_torch.cache.paged import init_paged_cache
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_attention)

    _, _, bt, pt = synthetic_pair_int8(num_layers=2, draft_layers=2, seed=8, device="cuda")
    cfg = bt.cfg
    n_pre, p_len = SHARED_PAGES * PAGE, SHARED_PAGES * PAGE + 2 * EXTEND_W
    prompt = torch.as_tensor(np.random.default_rng(9).integers(100, 31000, (1, p_len)),
                             device="cuda")
    table = torch.tensor([[3, 0, 6, 1, 4]], dtype=torch.int32, device="cuda")

    def pool():
        cache = init_paged_cache(cfg.num_layers, 8, cfg.num_kv_heads, PAGE, cfg.head_dim, 1,
                                 EXTEND_PAGES, quant=True, device="cuda")
        return dataclasses.replace(cache, block_tables=table)

    def at(cache, length):
        return dataclasses.replace(cache, lengths=torch.tensor([length], dtype=torch.int32,
                                                                device="cuda"))

    miss = pool()
    logits_miss, _ = bt.forward(pt, cfg, prompt, at(miss, 0), paged_prefill=True)
    hit = pool()
    bt.forward(pt, cfg, prompt[:, :n_pre], at(hit, 0), paged_prefill=True)
    launches = paged_flash_decode_attention.launches
    for j in range(2):
        lo = n_pre + j * EXTEND_W
        logits_hit, _ = bt.forward(pt, cfg, prompt[:, lo:lo + EXTEND_W], at(hit, lo),
                                   batch_invariant=True)
    torch.cuda.synchronize()
    if paged_flash_decode_attention.launches - launches != 2 * cfg.num_layers:
        raise AssertionError("the extend windows did not take the paged kernel")
    _hold_logits("[prefix forward] 2-layer 5120-wide int8, int8 pool, position 575: 512 cached + "
                 "two 32-token extend windows vs a monolithic 576-token prefill",
                 logits_hit[:, -1].float().cpu(), logits_miss[:, -1].float().cpu())
    own = table[0, SHARED_PAGES]
    for name in ("k", "v"):
        deq = [(getattr(c, name + "_q")[:, own].float() * getattr(c, name + "_s")[:, own, ..., None])
               [:, :, :2 * EXTEND_W].cpu() for c in (hit, miss)]
        rel = float((deq[0] - deq[1]).abs().max() / deq[1].abs().max())
        log(f"[prefix forward] suffix {name} (positions 512-575, both layers): max|hit-miss|/max|miss| "
            f"{rel:.2e} (tol 3e-2)")
        if not rel <= 3e-2:
            raise AssertionError(f"prefix forward: the suffix {name} of the hit path disagrees")
    del pt


def phase_sarathi_forward():
    """SARATHI's staged prefill against the admission prefill, on the
    2-layer 5120-wide int8 slice with a paged int8 pool: one 960-token
    prompt prefilled at once (B1's batch-invariant plan, block-only
    attention) and the same prompt staged through the verify windows a
    staged row rides (gamma + 1 = 9 tokens at cur_len - 1 = 0, 8, ..., 952;
    B1 planned from M, B3 over the pages). The last position's logits and
    the prompt's KV must agree within _hold_logits's 3e-2; the deltas are
    printed."""
    import dataclasses

    from llmspeculativesampling_tpu_torch.cache.paged import init_paged_cache
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        gather_pages, paged_flash_decode_attention)

    _, _, bt, pt = synthetic_pair_int8(num_layers=2, draft_layers=2, seed=12, device="cuda")
    cfg = bt.cfg
    w = SERVE_GAMMA + 1
    n_pages = -(-(COLD_LEN + w) // PAGE)
    table = torch.tensor([[(5 * i + 3) % n_pages for i in range(n_pages)]], dtype=torch.int32,
                         device="cuda")
    tokens = torch.zeros((1, n_pages * PAGE), dtype=torch.long, device="cuda")
    tokens[:, :COLD_LEN] = torch.as_tensor(
        np.random.default_rng(13).integers(100, 31000, (1, COLD_LEN)), device="cuda")

    def pool():
        cache = init_paged_cache(cfg.num_layers, n_pages, cfg.num_kv_heads, PAGE, cfg.head_dim, 1,
                                 n_pages, quant=True, device="cuda")
        return dataclasses.replace(cache, block_tables=table)

    def at(cache, length):
        return dataclasses.replace(cache, lengths=torch.tensor([length], dtype=torch.int32,
                                                                device="cuda"))

    mono = pool()
    logits_mono, _ = bt.forward(pt, cfg, tokens[:, :COLD_LEN], at(mono, 0), paged_prefill=True)
    staged = pool()
    launches = paged_flash_decode_attention.launches
    starts = range(0, COLD_LEN - 1, SERVE_GAMMA)
    for st in starts:
        logits_st, _ = bt.forward(pt, cfg, tokens[:, st:st + w], at(staged, st))
    torch.cuda.synchronize()
    if paged_flash_decode_attention.launches - launches != len(starts) * cfg.num_layers:
        raise AssertionError("the staged windows did not take the paged kernel")
    _hold_logits(f"[sarathi forward] 2-layer 5120-wide int8, int8 pool, position {COLD_LEN - 1}: "
                 f"{len(starts)} staged verify windows of {w} vs a monolithic {COLD_LEN}-token "
                 "prefill", logits_st[:, COLD_LEN - 1 - starts[-1]].float().cpu(),
                 logits_mono[:, -1].float().cpu())
    for name in ("k", "v"):
        deq = [torch.stack([(gather_pages(q_l, table).float() * gather_pages(s_l, table)[..., None])
                            [..., :COLD_LEN, :] for q_l, s_l in zip(getattr(c, name + "_q"),
                                                                    getattr(c, name + "_s"))]).cpu()
               for c in (staged, mono)]
        rel = float((deq[0] - deq[1]).abs().max() / deq[1].abs().max())
        log(f"[sarathi forward] prompt {name} (positions 0-{COLD_LEN - 1}, both layers): "
            f"max|staged-monolithic|/max|monolithic| {rel:.2e} (tol 3e-2)")
        if not rel <= 3e-2:
            raise AssertionError(f"sarathi forward: the staged prompt's {name} disagrees")
    del pt


def phase_tree_forward():
    """A tree forward (4 rows x 17 tokens: ``positions`` and ``tree_mask``
    as ``tree_verify`` builds them, so B2 runs under the ancestor bias) of
    the 2-layer slice through a contiguous bf16 cache, card vs CPU; then
    ``compact_tree_paths`` of the card's cache on the card and of the same
    cache copied to the CPU must agree bit for bit (and on an int8 cache)."""
    import dataclasses

    from llmspeculativesampling_tpu_torch.cache.kvcache import (
        QuantKVCache, compact_tree_paths, kv_buffers, rollback)
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8
    from llmspeculativesampling_tpu_torch.engine.beam_tree import ancestor_matrix, backtrack_path
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import flash_decode_attention

    _, _, bt, pt = synthetic_pair_int8(num_layers=2, draft_layers=2, seed=9, device="cuda")
    pc = _to_cpu(pt)
    cfg = bt.cfg
    rng = np.random.default_rng(9)
    rows, n, cur_len = TREE_BEAMS, TREE_GAMMA * TREE_BEAMS, 64
    prompt = torch.as_tensor(rng.integers(100, 31000, (rows, cur_len)), dtype=torch.long)
    parents = torch.as_tensor(rng.integers(0, TREE_BEAMS, (TREE_GAMMA, TREE_BEAMS)))
    nodes = torch.as_tensor(rng.integers(100, 31000, n), dtype=torch.long)
    block = torch.zeros((n + 1, n + 1), dtype=torch.bool)
    block[:, 0] = True
    block[1:, 1:] = ancestor_matrix(parents, TREE_GAMMA, TREE_BEAMS)
    level = torch.arange(TREE_GAMMA).repeat_interleave(TREE_BEAMS)
    positions = torch.cat([torch.tensor([cur_len - 1]), cur_len + level])[None].expand(rows, n + 1)
    vin = torch.cat([prompt[:, -1:], nodes[None].expand(rows, n)], dim=1)
    outs, caches = {}, {}
    launches = flash_decode_attention.launches
    for dev, params in (("cuda", pt), ("cpu", pc)):
        cache = bt.make_cache(rows, S_MAX, device=dev)
        _, cache = bt.forward(params, cfg, prompt.to(dev), cache)
        cache = rollback(cache, cur_len - 1)
        logits, cache = bt.forward(params, cfg, vin.to(dev), cache, positions=positions.to(dev),
                                   tree_mask=block[None].expand(rows, n + 1, n + 1).to(dev))
        outs[dev], caches[dev] = logits.float().cpu(), cache
    if flash_decode_attention.launches - launches != cfg.num_layers:
        raise AssertionError("the tree forward did not take the flash-decode kernel")
    if outs["cuda"].shape != (rows, n + 1, cfg.vocab_size):
        raise AssertionError(f"tree forward: bad logits {tuple(outs['cuda'].shape)}")
    _hold_logits(f"[tree forward] 2-layer 5120-wide int8, {rows} rows x {n + 1} tree tokens at "
                 f"prefix {cur_len - 1}", outs["cuda"], outs["cpu"])
    rel_tol = 3e-2
    kv_rel = max(float((a.float().cpu() - b.float()).abs().max()) / float(b.float().abs().max())
                 for a, b in zip(kv_buffers(caches["cuda"]), kv_buffers(caches["cpu"])))
    log(f"[tree forward] cache after the tree forward: max|gpu-cpu|/max|cpu| {kv_rel:.2e} "
        f"(tol {rel_tol:.0e})")
    if kv_rel > rel_tol:
        raise AssertionError("tree forward: gpu and cpu caches disagree")

    # compaction of one cache's content on both devices: the card's tree cache,
    # and a random int8 cache
    quant = QuantKVCache(*(torch.randint(-127, 128, (2, rows, 40, S_MAX, 128), dtype=torch.int8)
                           for _ in range(2)),
                         *(torch.rand((2, rows, 40, S_MAX)) for _ in range(2)), cur_len + n)
    for name, src in (("bf16 tree cache", caches["cuda"]), ("int8 cache", quant)):
        for max_l in (0, 2, TREE_GAMMA):
            parent = torch.as_tensor(rng.integers(0, TREE_BEAMS, rows))
            _, _, path_nodes, _ = backtrack_path(parents, nodes.reshape(TREE_GAMMA, TREE_BEAMS),
                                                 parent, max_l, TREE_GAMMA, TREE_BEAMS)
            valid = (torch.arange(TREE_GAMMA) < max_l)[None].expand(rows, TREE_GAMMA)
            bufs = [f.name for f in dataclasses.fields(src) if f.name not in ("length", "lengths")]
            got = compact_tree_paths(
                dataclasses.replace(src, **{b: getattr(src, b).cuda().clone() for b in bufs}),
                path_nodes.cuda(), valid.cuda(), cur_len)
            ref = compact_tree_paths(
                dataclasses.replace(src, **{b: getattr(src, b).cpu().clone() for b in bufs}),
                path_nodes, valid, cur_len)
            if got.length != ref.length or not all(
                    torch.equal(a.cpu(), b) for a, b in zip(kv_buffers(got), kv_buffers(ref))):
                raise AssertionError(f"compact_tree_paths: card and CPU differ ({name}, max_l {max_l})")
    log("[tree forward] compact_tree_paths: card == CPU bit for bit (bf16 tree cache and an int8 "
        "cache; accepted depths 0, 2, 4)")
    del pt, pc


def phase_opt_forward():
    """A 2-layer, full-width (5120, ffn 20480, vocab 50272) int8 OPT slice
    on the card against the same weights on the CPU: through a contiguous
    cache (prefill 64, verify 9, decode 1), through a paged int8 pool (an
    admission prefill, per-row rollbacks, verify 9, decode 1, the draft's
    re-feed and a 40-token block over a page edge; row 3 on the sentinel
    table) and a 4-row x 17-token tree block whose nodes at one depth
    share a position, under the ancestor bias."""
    import dataclasses

    from llmspeculativesampling_tpu_torch.cache.kvcache import rollback
    from llmspeculativesampling_tpu_torch.cache.paged import init_paged_cache, set_row_table
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_opt_pair_int8
    from llmspeculativesampling_tpu_torch.engine.beam_tree import ancestor_matrix

    _, _, bt, pt = synthetic_opt_pair_int8(num_layers=2, draft_layers=2, seed=5, device="cuda")
    pc = _to_cpu(pt)
    cfg = bt.cfg
    counters = _counters()
    rng = np.random.default_rng(11)

    def ids(*shape):
        return torch.as_tensor(rng.integers(100, 50000, shape), dtype=torch.long)

    # contiguous
    steps = [("prefill 64", ids(1, 64)), ("verify 9", ids(1, OPT_GAMMA + 1)), ("decode 1", ids(1, 1))]
    outs = {}
    b2 = counters["flash_decode"].launches
    for dev, params in (("cuda", pt), ("cpu", pc)):
        cache = bt.make_cache(1, S_MAX, device=dev)
        outs[dev] = []
        for _, toks in steps:
            logits, cache = bt.forward(params, cfg, toks.to(dev), cache)
            outs[dev].append(logits.float().cpu())
    if counters["flash_decode"].launches - b2 != 2 * cfg.num_layers:
        raise AssertionError("opt forward: the short blocks did not take B2")
    for (name, _), g, r in zip(steps, outs["cuda"], outs["cpu"]):
        _hold_logits(f"[opt forward] 2-layer 5120-wide int8 OPT, {name}", g, r)

    # paged int8 pool
    tables = [[5, 11, 2], [9, 0, 14], [3, 7, 12], []]
    psteps = [("prefill 64", 64, None), ("verify 9", 9, [64, 50, 37, 0]), ("decode 1", 1, None),
              ("re-feed 2", 2, [70, 58, 47, 0]), ("block 40 over a page edge", 40, [120, 100, 60, 0])]
    ptoks = {n: ids(4, w) for n, w, _ in psteps}
    outs = {}
    b3 = counters["paged_flash_decode"].launches
    for dev, params in (("cuda", pt), ("cpu", pc)):
        cache = init_paged_cache(cfg.num_layers, 16, cfg.num_kv_heads, PAGE, cfg.head_dim, 4, 3,
                                 quant=True, device=dev)
        for row, blocks in enumerate(tables):
            set_row_table(cache, row, blocks + [16] * (3 - len(blocks)), 0)
        outs[dev] = []
        for name, _, lens in psteps:
            if lens is not None:
                cache = dataclasses.replace(
                    cache, lengths=torch.tensor(lens, dtype=torch.int32, device=dev))
            logits, cache = bt.forward(params, cfg, ptoks[name].to(dev), cache,
                                       paged_prefill=name.startswith("prefill"))
            outs[dev].append(logits[:3].float().cpu())
    if counters["paged_flash_decode"].launches - b3 != 3 * cfg.num_layers:
        raise AssertionError("opt paged forward: the short blocks did not take B3")
    for (name, _, _), g, r in zip(psteps, outs["cuda"], outs["cpu"]):
        _hold_logits(f"[opt paged forward] int8 pool, {name}", g, r)

    # a tree block: 4 rows x (anchor + 16 nodes), nodes at one depth share a position
    rows, n, cur_len = TREE_BEAMS, TREE_GAMMA * TREE_BEAMS, 64
    prompt = ids(rows, cur_len)
    parents = torch.as_tensor(rng.integers(0, TREE_BEAMS, (TREE_GAMMA, TREE_BEAMS)))
    block = torch.zeros((n + 1, n + 1), dtype=torch.bool)
    block[:, 0] = True
    block[1:, 1:] = ancestor_matrix(parents, TREE_GAMMA, TREE_BEAMS)
    level = torch.arange(TREE_GAMMA).repeat_interleave(TREE_BEAMS)
    positions = torch.cat([torch.tensor([cur_len - 1]), cur_len + level])[None].expand(rows, n + 1)
    vin = torch.cat([prompt[:, -1:], ids(1, n).expand(rows, n)], dim=1)
    outs = {}
    b2 = counters["flash_decode"].launches
    for dev, params in (("cuda", pt), ("cpu", pc)):
        cache = bt.make_cache(rows, S_MAX, device=dev)
        _, cache = bt.forward(params, cfg, prompt.to(dev), cache)
        cache = rollback(cache, cur_len - 1)
        logits, _ = bt.forward(params, cfg, vin.to(dev), cache, positions=positions.to(dev),
                               tree_mask=block[None].expand(rows, n + 1, n + 1).to(dev))
        outs[dev] = logits.float().cpu()
    if counters["flash_decode"].launches - b2 != cfg.num_layers:
        raise AssertionError("opt tree forward: the tree block did not take B2")
    _hold_logits(f"[opt tree forward] {rows} rows x {n + 1} tokens, shared positions",
                 outs["cuda"], outs["cpu"])
    del pt, pc


def phase_fp8_forward():
    """fp8 e4m3 weights on the card: the 2-layer 5120-wide Llama slice with
    its int8 codes cast to e4m3 (every projection and the lm_head) through
    a contiguous cache, card against CPU. The fp8 product is the plain bf16
    one of ``models/linear.py``, so B1 must not run; B1's wrapper still
    refuses an fp8 weight."""
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul

    _, _, bt, pt = synthetic_pair_int8(num_layers=2, draft_layers=2, seed=5, device="cuda")

    def fp8(tree):
        if isinstance(tree, dict) and "q" in tree:
            return {"q": tree["q"].to(torch.float8_e4m3fn), "s": tree["s"]}
        if isinstance(tree, dict):
            return {k: fp8(v) for k, v in tree.items()}
        return tree

    pt = fp8(pt)
    pc = _to_cpu(pt)
    cfg = bt.cfg
    rng = np.random.default_rng(13)
    steps = [(name, torch.as_tensor(rng.integers(100, 31000, (1, w)), dtype=torch.long))
             for name, w in (("prefill 64", 64), ("verify 25", GAMMA + 1), ("decode 1", 1))]
    outs = {}
    b1 = int8_matmul.launches
    for dev, params in (("cuda", pt), ("cpu", pc)):
        cache = bt.make_cache(1, S_MAX, device=dev)
        outs[dev] = []
        for _, toks in steps:
            logits, cache = bt.forward(params, cfg, toks.to(dev), cache)
            outs[dev].append(logits.float().cpu())
    if int8_matmul.launches != b1:
        raise AssertionError("fp8 forward: an fp8 weight reached the int8 kernel")
    for (name, _), g, r in zip(steps, outs["cuda"], outs["cpu"]):
        _hold_logits(f"[fp8 forward] 2-layer 5120-wide fp8 e4m3 Llama, {name}", g, r)
    w = pt["layers"]["wq"]
    try:
        int8_matmul(torch.zeros((1, w["q"].shape[1]), dtype=torch.bfloat16, device="cuda"),
                    w["q"][0], w["s"][0])
    except NotImplementedError:
        log("[fp8 forward] B1's wrapper refuses an fp8 weight (NotImplementedError), as it should")
    else:
        raise AssertionError("B1's wrapper took an fp8 weight")
    del pt, pc


_ST_DTYPE_NAMES = {torch.bfloat16: "BF16", torch.float32: "F32"}


def write_safetensors(path: str, tensors: dict):
    """A safetensors file written without the ``safetensors`` package: an
    8-byte little-endian header length, the JSON header (dtype, shape and
    ``data_offsets`` of each tensor, space-padded to 8 bytes), then each
    tensor's bytes in order."""
    import struct

    header, offset, order = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
        order.append(t)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in order:
            f.write(t.view(torch.uint8).numpy().tobytes())


def phase_loader():
    """A checkpoint round trip: a 2-layer 5120-wide bf16 OPT with random
    weights, biases and LayerNorms written under HF's names ([out, in]
    Linear weights) as two safetensors shards and a config.json into a
    temporary directory, loaded by ``load_pretrained`` onto the card. Every
    leaf and the logits of a prefill and a verify must equal those of the
    params written, bit for bit."""
    import tempfile

    from llmspeculativesampling_tpu_torch.core.config import OPTConfig
    from llmspeculativesampling_tpu_torch.core.loader import load_pretrained
    from llmspeculativesampling_tpu_torch.engine.types import ModelBundle
    from llmspeculativesampling_tpu_torch.models import opt

    cfg = OPTConfig(vocab_size=50272, hidden_size=5120, ffn_dim=20480, num_layers=2,
                    num_heads=40, max_position=2048, dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(17)
    params = opt.init_params(cfg, gen, device="cuda")
    for name, x in list(params["layers"].items()) + [("ln_final_w", params["ln_final_w"]),
                                                     ("ln_final_b", params["ln_final_b"])]:
        if x.dim() <= 2:  # biases and LayerNorms
            base = 1.0 if name.startswith("ln") and name.endswith("_w") else 0.0
            x.copy_(base + 0.05 * torch.randn(x.shape, generator=gen, device="cuda"))
    pre = "model.decoder."
    names = {"wq": "self_attn.q_proj.weight", "bq": "self_attn.q_proj.bias",
             "wk": "self_attn.k_proj.weight", "bk": "self_attn.k_proj.bias",
             "wv": "self_attn.v_proj.weight", "bv": "self_attn.v_proj.bias",
             "wo": "self_attn.out_proj.weight", "bo": "self_attn.out_proj.bias",
             "fc1_w": "fc1.weight", "fc1_b": "fc1.bias", "fc2_w": "fc2.weight", "fc2_b": "fc2.bias",
             "ln_attn_w": "self_attn_layer_norm.weight", "ln_attn_b": "self_attn_layer_norm.bias",
             "ln_mlp_w": "final_layer_norm.weight", "ln_mlp_b": "final_layer_norm.bias"}
    layer_sd = {}
    for key, name in names.items():
        for i in range(cfg.num_layers):
            x = params["layers"][key][i]
            layer_sd[f"{pre}layers.{i}.{name}"] = x.t() if x.dim() == 2 else x
    rest = {pre + "embed_tokens.weight": params["embed"],
            pre + "embed_positions.weight": params["embed_pos"],
            pre + "final_layer_norm.weight": params["ln_final_w"],
            pre + "final_layer_norm.bias": params["ln_final_b"]}
    hf_config = {"model_type": "opt", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                 "ffn_dim": cfg.ffn_dim, "num_hidden_layers": cfg.num_layers,
                 "num_attention_heads": cfg.num_heads, "max_position_embeddings": cfg.max_position,
                 "do_layer_norm_before": True, "word_embed_proj_dim": cfg.hidden_size}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        write_safetensors(os.path.join(d, "model-00001-of-00002.safetensors"), layer_sd)
        write_safetensors(os.path.join(d, "model-00002-of-00002.safetensors"), rest)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf_config, f)
        size = sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))
        t1 = time.perf_counter()
        fam, cfg2, loaded = load_pretrained(d, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    del layer_sd, rest
    if fam != "opt" or cfg2 != cfg:
        raise AssertionError(f"loader: got {fam} {cfg2}")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix[:-1], tree

    got, want = dict(leaves(loaded)), dict(leaves(params))
    if sorted(got) != sorted(want):
        raise AssertionError(f"loader: leaves {sorted(got)} != {sorted(want)}")
    for name, x in want.items():
        if got[name].device.type != "cuda" or not torch.equal(got[name], x):
            raise AssertionError(f"loader: leaf {name} differs from what was written")
    rng = np.random.default_rng(19)
    toks = [torch.as_tensor(rng.integers(100, 50000, (1, w)), dtype=torch.long, device="cuda")
            for w in (64, OPT_GAMMA + 1)]
    logits = []
    bundle = ModelBundle("opt", cfg, opt.forward)
    for p in (params, loaded):
        cache = bundle.make_cache(1, S_MAX, device="cuda")
        out = []
        for t in toks:
            lg, cache = opt.forward(p, cfg, t, cache)
            out.append(lg)
        logits.append(out)
    if not all(torch.equal(a, b) for a, b in zip(*logits)):
        raise AssertionError("loader: logits of the loaded params differ from the written ones")
    log(f"[loader] 2-layer 5120-wide bf16 OPT: {size / 1e9:.2f} GB written as 2 safetensors shards "
        f"in {t1 - t0:.1f} s, loaded onto the card by load_pretrained in {t2 - t1:.1f} s; every "
        "leaf and the prefill/verify logits equal the written params' bit for bit")
    del params, loaded


# ---------------------------------------------------------------- phase 4
def _counters():
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import flash_decode_attention
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_attention)

    from llmspeculativesampling_tpu_torch.kernels.moe_matmul import (
        expert_align, grouped_int8_matmul)

    return {"int8_matmul": int8_matmul, "flash_decode": flash_decode_attention,
            "paged_flash_decode": paged_flash_decode_attention,
            "moe_matmul": grouped_int8_matmul, "expert_align": expert_align}


def release_graphs():
    from llmspeculativesampling_tpu_torch.engine import device_loop

    device_loop.release_graphs()


def reset_launches():
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in _counters().items()}


def build_pair():
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8_small_draft

    t0 = time.perf_counter()
    pair = synthetic_pair_int8_small_draft(device="cuda")
    torch.cuda.synchronize()
    log(f"[main] 13B-int8 target + 768x2 draft born on the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated ({card_line()})")
    return pair


def phase_main_path(results, reps: int, pair):
    from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate
    from llmspeculativesampling_tpu_torch.engine.speculative import speculative_generate

    card = card_line()
    bd, pd, bt, pt = pair
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, details=True, device="cuda")

    def gen(k):
        return torch.Generator(device="cuda").manual_seed(k)

    # warm-up (allocator, calibration of the phase split), untimed
    autoregressive_generate(bt, pt, prompt, 128, generator=gen(0), **kw)
    speculative_generate(bd, pd, bt, pt, prompt, 128, gamma=GAMMA, generator=gen(0), **kw)
    torch.cuda.synchronize()

    reset_launches()
    ar, sp, outs = [], [], []
    for k in range(1, reps + 1):
        out, d = autoregressive_generate(bt, pt, prompt, 128, generator=gen(k), **kw)
        ar.append(d)
        outs.append(out)
        out, d = speculative_generate(bd, pd, bt, pt, prompt, 128, gamma=GAMMA, generator=gen(k), **kw)
        sp.append(d)
        outs.append(out)
    launches = read_launches()

    # AR stops at 128 new tokens; spec may overshoot by up to gamma (the
    # reference's loop checks the budget before a step adds gamma+1 tokens)
    for i, out in enumerate(outs):
        gen_ids, cap = out[64:], 128 + (GAMMA if i % 2 else 0)
        if not (np.array_equal(out[:64], np.asarray(prompt)) and 1 <= len(gen_ids) <= cap
                and (len(gen_ids) >= 128 or gen_ids[-1] == 2)
                and gen_ids.min() >= 0 and gen_ids.max() < VOCAB):
            raise AssertionError(f"main path: bad output of length {len(out)}")
    ar_rates = [d["tokens_per_s"] for d in ar]
    sp_rates = [d["tokens_per_s"] for d in sp]
    acc = [d["acc_rate"] for d in sp]
    acc_len = [float(np.mean(d["acc_len"])) for d in sp]
    for name, r in (("AR", ar_rates), ("spec", sp_rates)):
        log(f"[main] {name} tok/s median {np.median(r):.2f} min {min(r):.2f} max {max(r):.2f} "
            f"over {reps} reps ({card})")
    log(f"[main] spec gamma={GAMMA}: acc_rate {np.mean(acc):.4f} (per rep {[round(a, 4) for a in acc]}), "
        f"mean acc_len {np.mean(acc_len):.3f}, steps per rep {[d['target_call_times'] for d in sp]}, "
        f"speedup {np.median(sp_rates) / np.median(ar_rates):.3f}x ({card})")
    log(f"[main] launches during the timed reps: {launches}")
    if np.mean(acc) < 0.6:
        raise AssertionError(f"acceptance {np.mean(acc):.3f} < 0.6: a kernel is likely wrong")
    for name in ("int8_matmul", "flash_decode"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the single-stream path")
    results["launches"] = {"single_stream": launches}
    results["main"] = dict(ar_tok_s=float(np.median(ar_rates)), spec_tok_s=float(np.median(sp_rates)),
                           acc_rate=float(np.mean(acc)))


def phase_device_loop(results, reps: int, pair):
    """The main path's device loop (``engine/device_loop.py``): the step of
    ``speculative_generate`` and ``autoregressive_generate`` captured once
    into a CUDA graph and replayed until the state says stop, on the
    13B-int8 pair with phase 4's settings (64-token prompt, 128 new tokens,
    gamma 24, top_k 20, top_p 0.9). A fresh capture of each step is timed;
    then, for each of ``reps`` seeds, the replayed generation's ids and
    details must equal an eager run of the same step function
    (``device_loop.eager_steps``) token for token, spec and AR; B1 and B2
    must launch inside both graphs (the replay accounting) and B3 not;
    spec's acc_rate must reach 0.6. Launches counted under "device_loop":
    the replayed runs' (their prefills' B1 calls included), not the eager
    runs'."""
    from llmspeculativesampling_tpu_torch.engine import device_loop
    from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate
    from llmspeculativesampling_tpu_torch.engine.speculative import speculative_generate

    card = card_line()
    bd, pd, bt, pt = pair
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, details=True, device="cuda")
    runs = {
        "spec": lambda g: speculative_generate(bd, pd, bt, pt, prompt, 128, gamma=GAMMA,
                                               generator=g, **kw),
        "ar": lambda g: autoregressive_generate(bt, pt, prompt, 128, generator=g, **kw),
    }
    same_keys = {"spec": ("acc_len", "acc_rate", "accepted_count", "resample_count",
                          "target_sample_count", "target_call_times", "tokens_generated"),
                 "ar": ("tokens_generated",)}

    def gen(k):
        return torch.Generator(device="cuda").manual_seed(k)

    def timed_run(name, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, d = runs[name](gen(k))
        return out, d, time.perf_counter() - t0

    device_loop.release_graphs()
    n_cap = len(device_loop.capture_seconds)
    for name in runs:
        timed_run(name, 0)  # the first step runs eagerly, then the capture
    caps = device_loop.capture_seconds[n_cap:]
    per_replay = dict(device_loop.graph_launches())
    log(f"[device_loop] capture of one step: spec {caps[0] * 1e3:.1f} ms, AR {caps[1] * 1e3:.1f} ms; "
        f"launches a replay: spec {per_replay['spec']}, AR {per_replay['ar']} ({card})")
    for name, counts in per_replay.items():
        if counts["int8_matmul"] <= 0 or counts["flash_decode_attention"] <= 0 \
                or counts["paged_flash_decode_attention"] != 0:
            raise AssertionError(f"device loop {name}: B1/B2 not inside the graph, or B3: {counts}")
    totals = dict.fromkeys(_counters(), 0)
    rows = {name: [] for name in runs}
    for k in range(1, reps + 1):
        for name in runs:
            reset_launches()
            out, d, wall = timed_run(name, k)
            for kname, v in read_launches().items():
                totals[kname] += v
            with device_loop.eager_steps():
                out_e, d_e, wall_e = timed_run(name, k)
            diff = [x for x in same_keys[name] if d[x] != d_e[x]]
            if not np.array_equal(out, out_e) or diff:
                first = int(np.argmax(out[:min(len(out), len(out_e))] != out_e[:min(len(out), len(out_e))]))
                raise AssertionError(f"device loop {name} seed {k}: replay != eager (lengths "
                                     f"{len(out)} / {len(out_e)}, first differing position "
                                     f"{first}, details {diff})")
            gen_ids = out[64:]
            if not (np.array_equal(out[:64], np.asarray(prompt)) and len(gen_ids) >= 1
                    and gen_ids.min() >= 0 and gen_ids.max() < VOCAB):
                raise AssertionError(f"device loop {name}: bad output of length {len(out)}")
            steps = d.get("target_call_times", len(gen_ids))
            rows[name].append(dict(tokens=len(gen_ids), steps=steps, replay_ms=wall * 1e3,
                                   eager_ms=wall_e * 1e3, acc_rate=d.get("acc_rate")))
            log(f"[device_loop] {name} seed {k}: {len(gen_ids)} tokens in {steps} steps, replay "
                f"{wall * 1e3:.1f} ms ({wall * 1e3 / steps:.2f} ms a step) vs eager "
                f"{wall_e * 1e3:.1f} ms ({wall_e * 1e3 / steps:.2f} ms a step), ids and details "
                f"equal ({card})")
    acc = [r["acc_rate"] for r in rows["spec"]]
    if np.mean(acc) < 0.6:
        raise AssertionError(f"device loop: acceptance {np.mean(acc):.3f} < 0.6")
    if totals["int8_matmul"] <= 0 or totals["flash_decode"] <= 0 or totals["paged_flash_decode"]:
        raise AssertionError(f"device loop: launches {totals}")
    log(f"[device_loop] launches of the replayed runs: {totals}; spec acc_rate {np.mean(acc):.4f}")
    results["launches"]["device_loop"] = totals
    results["device_loop"] = dict(capture_ms=[c * 1e3 for c in caps], per_replay=per_replay,
                                  runs=rows)


def _clone_tree(t):
    if isinstance(t, torch.Tensor):
        return t.clone()
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    return t


def _changed_head(head):
    """The head with its vocab rolled by one: every logit moves to the next id."""
    if isinstance(head, dict):  # the int8 re-layout {"q": [H, V], "s": [V]}
        return {"q": head["q"].roll(1, dims=1), "s": head["s"].roll(1, dims=0)}
    return head.roll(1, dims=0)  # dense [V, H]


def _leaf_checks(pair, card: str) -> dict:
    """The captured steps follow their params and free with them: a greedy
    spec run, the same dict with ``lm_head`` replaced, then a fresh dict of
    the new leaves (its ids must equal the replaced run's and differ from
    the first's); then a copy of the pair on the card runs spec and multi,
    is dropped, and ``memory_allocated`` must fall back with its entries
    gone, without ``release_graphs()``."""
    from llmspeculativesampling_tpu_torch import multi_speculative_generate, speculative_generate
    from llmspeculativesampling_tpu_torch.engine import device_loop

    bd, pd, bt, pt = pair
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, top_k=1, device="cuda")
    params = dict(pt)
    first = speculative_generate(bd, pd, bt, params, prompt, 32, gamma=TREE_GAMMA, **kw)
    params["lm_head"] = _changed_head(pt["lm_head"])
    replaced = speculative_generate(bd, pd, bt, params, prompt, 32, gamma=TREE_GAMMA, **kw)
    fresh = speculative_generate(bd, pd, bt, dict(params), prompt, 32, gamma=TREE_GAMMA, **kw)
    if not np.array_equal(replaced, fresh) or np.array_equal(replaced, first):
        raise AssertionError("a replaced lm_head was not read by the next run: "
                             f"replaced == fresh {np.array_equal(replaced, fresh)}, "
                             f"replaced == first {np.array_equal(replaced, first)}")
    del params
    gc.collect()
    torch.cuda.synchronize()
    n_entries, before = len(device_loop._ENTRIES), torch.cuda.memory_allocated()
    copy = [_clone_tree(pd), _clone_tree(pt)]
    speculative_generate(bd, copy[0], bt, copy[1], prompt, 32, gamma=TREE_GAMMA, **kw)
    multi_speculative_generate(bd, copy[0], bt, copy[1], prompt, 32, gamma=TREE_GAMMA,
                               width=TREE_BEAMS, **kw)
    torch.cuda.synchronize()
    held, with_copy = len(device_loop._ENTRIES), torch.cuda.memory_allocated()
    del copy
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    log(f"[device_loop params] a replaced lm_head gave a new capture: its ids equal a fresh "
        f"dict's and differ from the first run's; with a copy of the pair and its spec and multi "
        f"entries {with_copy / 2**30:.2f} GiB allocated and {held} entries (at most "
        f"{device_loop.MAX_ENTRIES} are kept), after dropping it {after / 2**30:.2f} GiB and "
        f"{len(device_loop._ENTRIES)} entries ({before / 2**30:.2f} GiB and {n_entries} before "
        f"the copy), without release_graphs() ({card})")
    if len(device_loop._ENTRIES) > n_entries or after > before + 2**28:
        raise AssertionError(f"a dropped pair was not freed: {after} bytes after, {before} before, "
                             f"{len(device_loop._ENTRIES)} entries")
    return dict(gib_with_copy=with_copy / 2**30, gib_after=after / 2**30,
                gib_before=before / 2**30)


def _loop_replays(tag: str, runs: dict, same_keys: dict, prompt: list, reps: int,
                  max_new: int, card: str, per_step=None) -> dict:
    """The device-loop checks of the engines ``runs`` (entry kind -> run of
    a generator): for each, a fresh capture timed, with the launches one
    replay makes (B1 and B2 > 0, B3 0, and ``per_step[kind]`` exactly when
    given) and the device memory its entry holds; then, for ``reps`` seeds,
    the replayed generation's ids and the details ``same_keys[kind]`` equal
    to an eager run's (``device_loop.eager_steps``) token for token, with
    the steps each run called (``device_loop.last_steps``). Returns the
    numbers and the replayed runs' launches."""
    from llmspeculativesampling_tpu_torch.engine import device_loop

    def timed_run(kind, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, d = runs[kind](torch.Generator(device="cuda").manual_seed(k))
        return out, d, time.perf_counter() - t0, device_loop.last_steps[0]

    capture, held_gib = {}, {}
    for kind in runs:
        gc.collect()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        n_cap = len(device_loop.capture_seconds)
        timed_run(kind, 0)  # the first step runs eagerly, then the capture
        if len(device_loop.capture_seconds) != n_cap + 1:
            raise AssertionError(f"{tag} {kind}: {len(device_loop.capture_seconds) - n_cap} "
                                 "captures in its first run, not one")
        capture[kind] = device_loop.capture_seconds[-1] * 1e3
        torch.cuda.empty_cache()
        held_gib[kind] = (torch.cuda.memory_reserved() - mem0) / 2**30
    per_replay = {kind: counts for kind, counts in device_loop.graph_launches() if kind in runs}
    for kind in runs:
        counts = per_replay.get(kind)
        if not counts or counts["int8_matmul"] <= 0 or counts["flash_decode_attention"] <= 0 \
                or counts["paged_flash_decode_attention"] != 0:
            raise AssertionError(f"{tag} {kind}: B1/B2 not inside the graph, or B3: {counts}")
        want = (per_step or {}).get(kind)
        if want is not None and (counts["int8_matmul"], counts["flash_decode_attention"]) != want:
            raise AssertionError(f"{tag} {kind}: a replay launches {counts}, not B1/B2 {want}")
        log(f"[{tag} {kind}] capture of one step {capture[kind]:.1f} ms; launches a "
            f"replay {counts}; the entry holds {held_gib[kind]:.3f} GiB of device memory "
            f"(reserved, state and graph pool) ({card})")
    totals = dict.fromkeys(_counters(), 0)
    rows = {kind: [] for kind in runs}
    for k in range(1, reps + 1):
        for kind in runs:
            reset_launches()
            out, d, wall, n_steps = timed_run(kind, k)
            for kname, v in read_launches().items():
                totals[kname] += v
            with device_loop.eager_steps():
                out_e, d_e, wall_e, n_eager = timed_run(kind, k)
            diff = [x for x in same_keys[kind] if d[x] != d_e[x]]
            if not np.array_equal(out, out_e) or diff:
                n = min(len(out), len(out_e))
                first = int(np.argmax(out[:n] != out_e[:n]))
                raise AssertionError(f"{tag} {kind} seed {k}: replay != eager (lengths "
                                     f"{len(out)} / {len(out_e)}, first differing position "
                                     f"{first}, details {diff})")
            gen_ids = out[64:]
            if not (np.array_equal(out[:64], np.asarray(prompt)) and 1 <= len(gen_ids) <= max_new
                    and gen_ids.min() >= 0 and gen_ids.max() < VOCAB):
                raise AssertionError(f"{tag} {kind}: bad output of length {len(out)}")
            steps = d["target_call_times"]
            rows[kind].append(dict(tokens=len(gen_ids), steps=steps, replay_ms=wall * 1e3,
                                   eager_ms=wall_e * 1e3, tok_s=d["tokens_per_s"],
                                   acc_rate=d.get("acc_rate"), replays=n_steps,
                                   eager_steps=n_eager, small=d.get("approx_call_times")))
            log(f"[{tag} {kind}] seed {k}: {len(gen_ids)} tokens, {steps} target forwards, "
                f"{n_eager} steps ({n_steps} replayed, the masked last included), replay "
                f"{wall * 1e3:.1f} ms ({wall * 1e3 / n_eager:.2f} ms a step, "
                f"{d['tokens_per_s']:.2f} tok/s) vs eager {wall_e * 1e3:.1f} ms "
                f"({wall_e * 1e3 / n_eager:.2f} ms a step), ids and details equal ({card})")
    if totals["int8_matmul"] <= 0 or totals["flash_decode"] <= 0 or totals["paged_flash_decode"]:
        raise AssertionError(f"{tag}: launches {totals}")
    return dict(capture_ms=capture, held_gib=held_gib, per_replay=per_replay, runs=rows,
                totals=totals)


def phase_winner_loops(results, reps: int, pair):
    """The device loops of the winner-row engines (multi iid, multi-beam,
    MJSD, random beam) on the 13B-int8 pair at the tree path's settings
    (64-token prompt, 64 new tokens, gamma 4, 4 candidates or beams, top_k
    20, top_p 0.9, eos 2; MJSD at accept_thres 0.1): :func:`_loop_replays`,
    then the param checks (:func:`_leaf_checks`). The replayed runs'
    launches are added under "device_loop"."""
    from llmspeculativesampling_tpu_torch import (
        mjsd_generate, multi_speculative_generate, random_width_beam_generate)

    t_phase = time.perf_counter()
    card = card_line()
    bd, pd, bt, pt = pair
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, details=True, device="cuda")
    g, nb, new = TREE_GAMMA, TREE_BEAMS, TREE_NEW
    runs = {  # kind (the entry's) -> run
        "multi": lambda gen: multi_speculative_generate(
            bd, pd, bt, pt, prompt, new, gamma=g, width=nb, generator=gen, **kw),
        "beam": lambda gen: multi_speculative_generate(
            bd, pd, bt, pt, prompt, new, gamma=g, width=nb, strategy="beam", generator=gen, **kw),
        "mjsd": lambda gen: mjsd_generate(
            bd, pd, bt, pt, prompt, new, gamma=g, width=nb, num_beams=nb, accept_thres=0.1,
            generator=gen, **kw),
        "random_beam": lambda gen: random_width_beam_generate(
            bt, pt, prompt, new, max_num_beams=nb, generator=gen, **kw),
    }
    winner_keys = ("acc_len", "acc_rate", "accepted_count", "target_call_times",
                   "tokens_generated")
    same_keys = {k: winner_keys for k in ("multi", "beam", "mjsd")}
    same_keys["random_beam"] = ("target_call_times", "tokens_generated")
    r = _loop_replays("winner_loops", runs, same_keys, prompt, reps, new + g, card)
    totals = r.pop("totals")
    acc = np.mean([x["acc_rate"] for x in r["runs"]["multi"]])
    if acc < 0.6:
        raise AssertionError(f"winner loops: multi acceptance {acc:.3f} < 0.6")
    log(f"[winner_loops] launches of the replayed runs: {totals}; multi acc_rate {acc:.4f}")
    leaves = _leaf_checks(pair, card)
    for kname, v in totals.items():
        results["launches"]["device_loop"][kname] += v
    elapsed = time.perf_counter() - t_phase
    log(f"[winner_loops] phase took {elapsed:.1f} s")
    results["winner_loops"] = dict(r, params=leaves, seconds=elapsed)


def phase_tree_loops(results, reps: int, pair):
    """The device loops of the tree engines and of BiLD on the 13B-int8 pair
    at the tree path's settings (64-token prompt, 64 new tokens, top_k 20,
    top_p 0.9, eos 2): beam v1 (gamma 4, 4 beams), beam v2 (gamma 4, 4
    beams, extra_sample_cnt 1, expect_thres 0.7) and BiLD (gamma BILD_GAMMA,
    fallback 0.6, rollback 5.0): :func:`_loop_replays`, where one replay
    must launch B1 and B2 exactly as often as its forwards need (a tree
    step: gamma draft forwards and one tree verify; a BiLD macro-step:
    BILD_GAMMA draft decodes and one check), and the decodes BiLD's
    macro-steps masked. The replayed runs' launches are added under
    "device_loop"."""
    from llmspeculativesampling_tpu_torch import (
        beam_speculative_generate, beam_speculative_v2_generate, bild_generate)

    t_phase = time.perf_counter()
    card = card_line()
    bd, pd, bt, pt = pair
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, details=True, device="cuda")
    g, nb, new = TREE_GAMMA, TREE_BEAMS, TREE_NEW
    runs = {
        "beam_v1": lambda gen: beam_speculative_generate(
            bd, pd, bt, pt, prompt, new, gamma=g, num_beams=nb, generator=gen, **kw),
        "beam_v2": lambda gen: beam_speculative_v2_generate(
            bd, pd, bt, pt, prompt, new, gamma=g, num_beams=nb, extra_sample_cnt=1,
            expect_thres=0.7, generator=gen, **kw),
        "bild": lambda gen: bild_generate(
            bd, pd, bt, pt, prompt, new, gamma=BILD_GAMMA, fallback_thres=0.6, rollback_thres=5.0,
            generator=gen, **kw),
    }
    tree_keys = ("acc_len", "acc_rate", "accepted_count", "target_call_times", "expect_cnt_list",
                 "num_beams_list", "tokens_generated")
    same_keys = {"beam_v1": tree_keys, "beam_v2": tree_keys,
                 "bild": ("acc_len", "accepted_count", "target_call_times", "approx_call_times",
                          "tokens_generated")}
    # B1 a forward: 7 projections a layer and the int8 head; B2: one a layer
    b1_d, b1_t = 7 * bd.cfg.num_layers + 1, 7 * bt.cfg.num_layers + 1
    b2_d, b2_t = bd.cfg.num_layers, bt.cfg.num_layers
    per_step = {"beam_v1": (g * b1_d + b1_t, g * b2_d + b2_t),
                "beam_v2": (g * b1_d + b1_t, g * b2_d + b2_t),
                "bild": (BILD_GAMMA * b1_d + b1_t, BILD_GAMMA * b2_d + b2_t)}
    r = _loop_replays("tree_loops", runs, same_keys, prompt, reps, new + g, card, per_step)
    totals = r.pop("totals")
    masked = [x["replays"] * BILD_GAMMA - x["small"] for x in r["runs"]["bild"]]
    masked_eager = [x["eager_steps"] * BILD_GAMMA - x["small"] for x in r["runs"]["bild"]]
    log(f"[tree_loops bild] decodes masked a generation: {masked} replayed (its masked last "
        f"macro-step included), {masked_eager} eager, of {BILD_GAMMA} a macro-step; small-model "
        f"decodes {[x['small'] for x in r['runs']['bild']]} ({card})")
    for kname, v in totals.items():
        results["launches"]["device_loop"][kname] += v
    elapsed = time.perf_counter() - t_phase
    log(f"[tree_loops] launches of the replayed runs: {totals}; phase took {elapsed:.1f} s")
    results["tree_loops"] = dict(r, bild_masked_decodes=masked,
                                 bild_masked_decodes_eager=masked_eager, seconds=elapsed)


# ---------------------------------------------------------------- phase 6
def _time_select_rows(cache, rows: int, reps: int = 20, inplace: bool = False, start=None,
                      size: int = 0) -> float:
    """Device ms of one ``select_rows`` of ``cache`` into ``rows`` rows (CUDA
    events around eager calls: each allocates its copy), or of the in-place
    ``select_rows_`` (the whole rows, or the window ``[start, start+size)``
    at a device position)."""
    from llmspeculativesampling_tpu_torch.cache.kvcache import select_rows, select_rows_

    idx = torch.zeros((rows,), dtype=torch.long, device="cuda")

    def one():
        if inplace:
            select_rows_(cache, idx, start, size)
        else:
            select_rows(cache, idx)

    one()
    torch.cuda.synchronize()
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start_ev.record()
    for _ in range(reps):
        one()
    end_ev.record()
    torch.cuda.synchronize()
    return start_ev.elapsed_time(end_ev) / reps


def phase_tree_path(results, reps: int, pair):
    """The tree/beam path on the 13B-int8 pair with scripts/bench_beam.py's
    --thirteen_b settings: multi iid (width 4), beam v1 (4 beams) and beam
    v2 (4 beams, extra_sample_cnt 1, expect_thres 0.7); gamma 4, top_k 20,
    top_p 0.9, 64 new tokens from a 64-token prompt, eos 2. One warm-up,
    then ``reps`` timed runs a engine, with the launch counts of those."""
    from llmspeculativesampling_tpu_torch.cache.kvcache import kv_buffers
    from llmspeculativesampling_tpu_torch.engine.beam_tree import (
        beam_speculative_generate, beam_speculative_v2_generate)
    from llmspeculativesampling_tpu_torch.engine.multi import multi_speculative_generate

    card = card_line()
    bd, pd, bt, pt = pair
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, details=True, device="cuda")
    g, nb = TREE_GAMMA, TREE_BEAMS
    engines = {
        "multi": lambda gen: multi_speculative_generate(
            bd, pd, bt, pt, prompt, TREE_NEW, gamma=g, width=nb, generator=gen, **kw),
        "beam_v1": lambda gen: beam_speculative_generate(
            bd, pd, bt, pt, prompt, TREE_NEW, gamma=g, num_beams=nb, generator=gen, **kw),
        "beam_v2": lambda gen: beam_speculative_v2_generate(
            bd, pd, bt, pt, prompt, TREE_NEW, gamma=g, num_beams=nb, extra_sample_cnt=1,
            expect_thres=0.7, generator=gen, **kw),
    }
    out_res, total_launches = {}, {}
    for name, run in engines.items():
        run(torch.Generator(device="cuda").manual_seed(0))  # warm-up, phase-split calibration
        torch.cuda.synchronize()
        reset_launches()
        ds = []
        for k in range(1, reps + 1):
            out, d = run(torch.Generator(device="cuda").manual_seed(k))
            ds.append(d)
            gen_ids = out[64:]
            # the loop checks the budget before a step, which adds up to gamma+1 tokens
            if not (np.array_equal(out[:64], np.asarray(prompt)) and 1 <= len(gen_ids) <= TREE_NEW + g
                    and gen_ids.min() >= 0 and gen_ids.max() < VOCAB):
                raise AssertionError(f"tree path {name}: bad output of length {len(out)}")
        launches = read_launches()
        steps = [d["target_call_times"] for d in ds]
        rates = [d["tokens_per_s"] for d in ds]
        acc = [d["acc_rate"] for d in ds]
        acc_len = [float(np.mean(d["acc_len"])) for d in ds]
        log(f"[tree {name}] tok/s median {np.median(rates):.2f} min {min(rates):.2f} max "
            f"{max(rates):.2f} over {reps} reps; acc_rate {np.mean(acc):.4f}, mean acc_len "
            f"{np.mean(acc_len):.3f} (per rep {[round(a, 3) for a in acc_len]}), steps per rep "
            f"{steps}; launches {launches} ({card})")
        if launches["int8_matmul"] <= 0 or launches["paged_flash_decode"] != 0:
            raise AssertionError(f"tree path {name}: B1 did not run, or B3 ran")
        if launches["flash_decode"] < bt.cfg.num_layers * sum(steps):
            raise AssertionError(f"tree path {name}: {launches['flash_decode']} B2 launches for "
                                 f"{sum(steps)} verify forwards of {bt.cfg.num_layers} layers: "
                                 "the verify skipped B2")
        if name == "multi" and np.mean(acc) < 0.6:
            raise AssertionError(f"tree path multi: acceptance {np.mean(acc):.3f} < 0.6")
        if name == "beam_v2" and np.mean(acc_len) <= 1.0:
            raise AssertionError(f"tree path beam_v2: mean acc_len {np.mean(acc_len):.3f} <= 1: "
                                 "the tree verify is likely wrong")
        out_res[name] = dict(tok_s=float(np.median(rates)), acc_rate=float(np.mean(acc)),
                             acc_len=float(np.mean(acc_len)), steps=steps, launches=launches)
        for kname, n in launches.items():
            total_launches[kname] = total_launches.get(kname, 0) + n

    # select_rows: the row gathers of a step, at this path's caches
    tc4 = bt.make_cache(nb, 256, device="cuda")
    tc1 = bt.make_cache(1, 256, device="cuda")
    dc4 = bd.make_cache(nb, 256, device="cuda")
    t4, t1, d4 = _time_select_rows(tc4, nb), _time_select_rows(tc1, 1), _time_select_rows(dc4, nb)
    per_step = {"multi": t4 + d4, "beam_v1": t4 + (g + 1) * d4, "beam_v2": t1 + (g + 1) * d4}
    gb = sum(x.nbytes for x in kv_buffers(tc4)) / 1e9
    log(f"[tree select_rows] target 4 rows x 256 ({gb:.2f} GB bf16) {t4:.3f} ms, target 1 row "
        f"{t1:.3f} ms, draft 4 rows {d4:.4f} ms; a step's gathers: multi {per_step['multi']:.3f} ms, "
        f"v1 {per_step['beam_v1']:.3f} ms, v2 {per_step['beam_v2']:.3f} ms ({card})")
    # the device loops' in-place forms: the whole rows (random beam's reorder,
    # JAX's take) and the window a winner-row step writes (multi, multi-beam, MJSD)
    pos = torch.full((), TREE_PREFIX, dtype=torch.long, device="cuda")
    f4 = _time_select_rows(tc4, nb, inplace=True)
    w4 = _time_select_rows(tc4, nb, inplace=True, start=pos - 1, size=g + 2)
    wd4 = _time_select_rows(dc4, nb, inplace=True, start=pos - 2, size=g + 2)
    log(f"[tree select_rows_] in place, target 4 rows x 256: whole rows {f4:.3f} ms, the "
        f"{g + 2}-position window {w4:.4f} ms; draft window {wd4:.4f} ms; a multi step's "
        f"re-broadcast {w4 + wd4:.4f} ms against {t4 + d4:.3f} for the whole-row takes ({card})")
    del tc4, tc1, dc4
    torch.cuda.empty_cache()
    results["tree"] = dict(engines=out_res, select_rows_ms=dict(target4=t4, target1=t1, draft4=d4),
                           select_rows_per_step_ms=per_step,
                           select_rows_inplace_ms=dict(target4_whole=f4, target4_window=w4,
                                                       draft4_window=wd4))
    results["launches"]["tree_beam"] = total_launches


def phase_algorithms(results, reps: int, pair):
    """The remaining algorithms on the 13B-int8 pair with the tree/beam
    path's settings (64-token prompt, 64 new tokens, gamma 4, top_k 20,
    top_p 0.9, eos 2): multi through strategy='beam' (width 4), MJSD at
    width = num_beams = 4 and accept_thres 0.1, BiLD at JAX's defaults
    (gamma 10, fallback 0.6, rollback 5.0), the cache-less v2 and random
    beam at 4 beams. One warm-up, then ``reps`` timed runs an engine with
    their launch counts; then MJSD's two threshold guards."""
    from llmspeculativesampling_tpu_torch import (
        bild_generate, mjsd_generate, multi_speculative_generate, random_width_beam_generate,
        speculative_generate_v2)

    t_phase = time.perf_counter()
    card = card_line()
    bd, pd, bt, pt = pair
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, details=True, device="cuda")
    g, nb, new = TREE_GAMMA, TREE_BEAMS, TREE_NEW
    engines = {  # name -> (run, most new tokens a run may return)
        "multi_beam": (lambda gen, **o: multi_speculative_generate(
            bd, pd, bt, pt, prompt, new, gamma=g, width=nb, strategy="beam", generator=gen,
            **{**kw, **o}), new + g),
        "mjsd": (lambda gen, **o: mjsd_generate(
            bd, pd, bt, pt, prompt, new, gamma=g, width=nb, num_beams=nb, generator=gen,
            **{**kw, "accept_thres": 0.1, **o}), new + g),
        "bild": (lambda gen, **o: bild_generate(
            bd, pd, bt, pt, prompt, new, gamma=BILD_GAMMA, fallback_thres=0.6, rollback_thres=5.0,
            generator=gen, **{**kw, **o}), new + 1),
        "spec_v2": (lambda gen, **o: speculative_generate_v2(
            bd, pd, bt, pt, prompt, new, gamma=g, generator=gen, **{**kw, **o}), new + g),
        "random_beam": (lambda gen, **o: random_width_beam_generate(
            bt, pt, prompt, new, max_num_beams=nb, generator=gen, **{**kw, **o}), new),
    }
    out_res, total_launches = {}, {}
    for name, (run, cap) in engines.items():
        run(torch.Generator(device="cuda").manual_seed(0))  # warm-up, phase-split calibration
        torch.cuda.synchronize()
        reset_launches()
        ds = []
        for k in range(1, reps + 1):
            out, d = run(torch.Generator(device="cuda").manual_seed(k))
            ds.append(d)
            gen_ids = out[64:]
            if not (np.array_equal(out[:64], np.asarray(prompt)) and 1 <= len(gen_ids) <= cap
                    and gen_ids.min() >= 0 and gen_ids.max() < VOCAB):
                raise AssertionError(f"algorithms {name}: bad output of length {len(out)}")
        launches = read_launches()
        steps = [d["target_call_times"] for d in ds]
        rates = [d["tokens_per_s"] for d in ds]
        acc = [d.get("acc_rate", float("nan")) for d in ds]
        acc_len = [float(np.mean(d["acc_len"])) if d.get("acc_len") else float("nan") for d in ds]
        small = [d["approx_call_times"] for d in ds]
        log(f"[algorithms {name}] tok/s median {np.median(rates):.2f} min {min(rates):.2f} max "
            f"{max(rates):.2f} over {reps} reps; acc_rate {np.mean(acc):.4f}, mean acc_len "
            f"{np.mean(acc_len):.3f} (per rep {[round(a, 3) for a in acc_len]}), target forwards "
            f"per rep {steps}, draft calls per rep {small}; launches {launches} ({card})")
        if launches["int8_matmul"] <= 0 or launches["paged_flash_decode"] != 0:
            raise AssertionError(f"algorithms {name}: B1 did not run, or B3 ran")
        if name == "spec_v2":
            # every forward covers the whole live prefix (> 32 tokens): B2 never runs
            if launches["flash_decode"] != 0:
                raise AssertionError(f"algorithms spec_v2: {launches['flash_decode']} B2 launches: "
                                     "a forward did not recompute the prefix")
            if np.mean(acc) < 0.6:
                raise AssertionError(f"algorithms spec_v2: acceptance {np.mean(acc):.3f} < 0.6")
        elif launches["flash_decode"] < bt.cfg.num_layers * sum(steps):
            raise AssertionError(f"algorithms {name}: {launches['flash_decode']} B2 launches for "
                                 f"{sum(steps)} target forwards of {bt.cfg.num_layers} layers")
        out_res[name] = dict(tok_s=float(np.median(rates)), acc_rate=float(np.mean(acc)),
                             acc_len=float(np.mean(acc_len)), steps=steps, draft_calls=small,
                             launches=launches)
        for kname, n in launches.items():
            total_launches[kname] = total_launches.get(kname, 0) + n

    # MJSD's deterministic guards: accept_thres 0 takes every draft, 1.5 none
    mjsd = engines["mjsd"][0]
    _, d0 = mjsd(torch.Generator(device="cuda").manual_seed(7), accept_thres=0.0)
    _, d1 = mjsd(torch.Generator(device="cuda").manual_seed(7), accept_thres=1.5)
    log(f"[algorithms mjsd guards] accept_thres 0: mean acc_len {np.mean(d0['acc_len']):.3f} "
        f"(gamma {g}); accept_thres 1.5: accepted {d1['accepted_count']} over "
        f"{d1['target_call_times']} steps")
    if np.mean(d0["acc_len"]) != g or d1["accepted_count"] != 0:
        raise AssertionError("algorithms mjsd: the threshold guards failed")
    elapsed = time.perf_counter() - t_phase
    log(f"[algorithms] phase took {elapsed:.1f} s")
    results["algorithms"] = dict(engines=out_res, seconds=elapsed)
    results["launches"]["algorithms"] = total_launches



def _traced(fn):
    """(fn's result, wall s, device-busy s) of one call under
    ``torch.profiler`` (CUPTI, device activity only): busy is the sum of the
    device events' durations (one stream, so they do not overlap), read
    from the raw trace without building the profiler's event tree; the wall
    runs from the call to a synchronize after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e9
    return out, wall, busy


def phase_v2_loop(results, reps: int, pair):
    """Spec v2's device loop (``engine/speculative_v2.py`` on
    ``device_loop.run``) on the 13B-int8 pair at the algorithms phase's
    settings (64-token prompt, 64 new tokens, gamma 4, top_k 20, top_p
    0.9): the capture of one step timed, its launches a replay (B1 exactly
    gamma x 15 draft + 281 target = 341, B2 and B3 none: every forward
    covers the whole 256-position buffer), then for ``reps`` seeds the
    replayed run equal to an eager run of the same step
    (``device_loop.eager_steps``), ids and details, with ms a step, tok/s
    and the idle share of a traced replayed run; acc_rate >= 0.6. Launches
    counted under "v2_loop": the replayed runs'."""
    from llmspeculativesampling_tpu_torch import speculative_generate_v2
    from llmspeculativesampling_tpu_torch.engine import device_loop

    card = card_line()
    bd, pd, bt, pt = pair
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, details=True, device="cuda")
    g, new = TREE_GAMMA, TREE_NEW
    keys = ("acc_len", "acc_rate", "accepted_count", "target_call_times", "tokens_generated")

    def run(k):
        return speculative_generate_v2(bd, pd, bt, pt, prompt, new, gamma=g,
                                       generator=torch.Generator(device="cuda").manual_seed(k), **kw)

    device_loop.release_graphs()  # the algorithms phase captured this step already
    n_cap = len(device_loop.capture_seconds)
    run(0)  # the first step eager, then the capture
    cap = device_loop.capture_seconds[n_cap:]
    per_replay = [c for kind, c in device_loop.graph_launches() if kind == "spec_v2"][-1]
    want_b1 = g * (bd.cfg.num_layers * 7 + 1) + bt.cfg.num_layers * 7 + 1
    log(f"[v2_loop] capture of one step {cap[0]:.3f} s; launches a replay {per_replay} "
        f"(B1 expected {want_b1}) ({card})")
    if (len(cap) != 1 or per_replay["int8_matmul"] != want_b1
            or per_replay["flash_decode_attention"] or per_replay["paged_flash_decode_attention"]):
        raise AssertionError(f"v2_loop: one capture with B1 {want_b1} and no B2/B3 a replay, got "
                             f"{len(cap)} captures, {per_replay}")
    totals = dict.fromkeys(_counters(), 0)
    rows = []
    for k in range(1, reps + 1):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, d = run(k)
        wall = time.perf_counter() - t0
        for name, v in read_launches().items():
            totals[name] += v
        with device_loop.eager_steps():
            t0 = time.perf_counter()
            out_e, d_e = run(k)
            wall_e = time.perf_counter() - t0
        diff = [x for x in keys if d[x] != d_e[x]]
        if not np.array_equal(out, out_e) or diff:
            raise AssertionError(f"v2_loop seed {k}: replay != eager (lengths {len(out)} / "
                                 f"{len(out_e)}, details {diff})")
        gen_ids = out[64:]
        if not (np.array_equal(out[:64], np.asarray(prompt)) and 1 <= len(gen_ids) <= new + g
                and gen_ids.min() >= 0 and gen_ids.max() < VOCAB):
            raise AssertionError(f"v2_loop: bad output of length {len(out)}")
        (_, _), t_wall, busy = _traced(lambda: run(k))
        steps = d["target_call_times"]
        rows.append(dict(tokens=len(gen_ids), steps=steps, ms_step=wall * 1e3 / steps,
                         eager_ms_step=wall_e * 1e3 / steps, tok_s=len(gen_ids) / wall,
                         idle=1 - busy / t_wall, busy_ms_step=busy * 1e3 / steps,
                         acc_rate=d["acc_rate"]))
        r = rows[-1]
        log(f"[v2_loop] seed {k}: {r['tokens']} tokens in {steps} steps, replay "
            f"{r['ms_step']:.2f} ms a step ({r['tok_s']:.2f} tok/s) vs eager "
            f"{r['eager_ms_step']:.2f}; traced replay: device busy {r['busy_ms_step']:.2f} ms a "
            f"step, idle share {r['idle']:.3f}; acc_rate {r['acc_rate']:.4f}; ids and details "
            f"equal ({card})")
    acc = float(np.mean([r["acc_rate"] for r in rows]))
    if acc < 0.6:
        raise AssertionError(f"v2_loop: acceptance {acc:.3f} < 0.6")
    if totals["int8_matmul"] <= 0 or totals["flash_decode"] or totals["paged_flash_decode"]:
        raise AssertionError(f"v2_loop: launches {totals}")
    log(f"[v2_loop] launches of the replayed runs: {totals}; acc_rate {acc:.4f}")
    results["launches"]["v2_loop"] = totals
    results["v2_loop"] = dict(capture_s=cap[0], per_replay=per_replay, runs=rows)


# ---------------------------------------------------------------- phase 5
def _workload(kind: str, rng):
    """scripts/bench_paged.py's mixes: (prompt_len, max_new) per request.
    Uniform: 24 x (64, 48). Mixed: 24 short (64, 24-48) with a long
    (512, 128) after every four, six in all. shared_prefix: 24 x (576, 48),
    a 512-token system prompt and 64 unique tokens. longgen: 24 x (64,
    256)."""
    if kind == "uniform":
        return [(64, 48) for _ in range(24)]
    if kind == "shared_prefix":
        return [(576, 48) for _ in range(24)]
    if kind == "longgen":
        return [(64, 256) for _ in range(24)]
    short = [(64, int(rng.integers(24, 49))) for _ in range(24)]
    out, si, li = [], 0, 0
    for i in range(30):
        if i % 5 == 4 and li < 6:
            out.append((512, 128))
            li += 1
        else:
            out.append(short[si])
            si += 1
    return out


def _mix_prompts(kind: str):
    """The mix's requests and prompts, as scripts/bench_paged.py makes them
    (ids 100-31000 from ``default_rng(0)``; shared_prefix: one system prompt,
    then each request's tail)."""
    rng = np.random.default_rng(0)
    reqs = _workload(kind, rng)
    if kind == "shared_prefix":
        system = rng.integers(100, 31000, 512).astype(np.int32)
        return reqs, [np.concatenate([system, rng.integers(100, 31000, pl - 512).astype(np.int32)])
                      for pl, _ in reqs]
    return reqs, [rng.integers(100, 31000, pl).astype(np.int32) for pl, _ in reqs]


def _check_outputs(tag: str, reqs, prompts, outs, vocab: int, gamma: int = SERVE_GAMMA) -> int:
    """Every output starts with its prompt, holds ids of the vocabulary and
    has max_new to max_new + gamma new tokens unless EOS ends it. Returns
    the generated tokens."""
    gen_tokens = 0
    for (pl, mn), prompt, out in zip(reqs, prompts, outs):
        if out is None:
            raise AssertionError(f"{tag}: a request got no output")
        out = np.asarray(out)
        n_new = len(out) - pl
        ok_len = mn <= n_new <= mn + gamma or (1 <= n_new and out[-1] == 2)
        if not (np.array_equal(out[:pl], prompt) and ok_len and out.min() >= 0
                and out.max() < vocab):
            raise AssertionError(f"{tag}: bad output of length {len(out)} for ({pl}, {mn})")
        gen_tokens += n_new
    return gen_tokens


def _serve_mix(kind: str, pair, **engine_kw) -> dict:
    import threading
    import urllib.request

    from llmspeculativesampling_tpu_torch.serve.server import (
        BatchedInferenceServer, InferenceServer, ServerConfig, make_http_server)

    bd, pd, bt, pt = pair
    card = card_line()
    tag = kind + ("" if engine_kw.get("on_demand", True) else " reserved")
    reqs, prompts = _mix_prompts(kind)
    engine = _serving_engine(pair, reqs, **engine_kw)
    # warm-up (untimed): one admission and a few chunks of this mix's shapes
    for pl in sorted({pl for pl, _ in reqs}):
        engine.submit(np.random.default_rng(pl).integers(100, 31000, pl), 16)
    engine.run_until_idle()
    engine.completions.clear()
    torch.cuda.synchronize()

    base = InferenceServer(bd, pd, bt, pt, config=ServerConfig(
        num_tokens=48, top_k=20, top_p=0.9, gamma=SERVE_GAMMA, eos_token_id=2), device="cuda")
    server = BatchedInferenceServer(base, engine=engine)
    # observe the engine from outside: each completion's details (for the
    # acc_rate check), the size of each admission prefill, and the chunks run
    details, prefills, chunks = [], [], [0]
    take, prefill, chunk = engine.result, engine._dispatch_prefill, engine._dispatch_chunk

    def result(rid):
        comp = take(rid)
        details.append(comp.details)
        return comp

    def dispatch_prefill(batch):
        prefills.append(len(batch))
        return prefill(batch)

    def dispatch_chunk():
        chunks[0] += 1
        return chunk()

    engine.result, engine._dispatch_prefill = result, dispatch_prefill
    engine._dispatch_chunk = dispatch_chunk
    httpd = make_http_server(server, "127.0.0.1", 0)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    outs = [None] * (len(reqs) + (kind == "uniform"))

    def call(i):
        _, outs[i] = server.process_request({"prompt_ids": prompts[i].tolist(),
                                             "max_tokens": reqs[i][1]})

    def call_http(i):
        body = json.dumps({"prompt_ids": prompts[i].tolist(), "max_tokens": reqs[i][1]}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            outs[i] = np.asarray(json.loads(r.read())["output_ids"])

    if kind == "uniform":  # the HTTP request repeats the first prompt
        reqs, prompts = reqs + [reqs[0]], prompts + [prompts[0]]
    reset_launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=call_http if kind == "uniform" and i == len(reqs) - 1
                                else call, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = read_launches()
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()
    http_thread.join(timeout=10)
    if any(t.is_alive() for t in threads) or http_thread.is_alive():
        raise AssertionError(f"serving {tag}: a client thread did not finish")

    gen_tokens = _check_outputs(f"serving {tag}", reqs, prompts, outs, bt.cfg.vocab_size)
    if engine.allocator.available_blocks != BLOCKS or engine.num_active or engine._pending:
        raise AssertionError(f"serving {tag}: the pool did not end fully free")
    acc = float(np.mean([d["acc_rate"] for d in details]))
    snap = base.stats.snapshot()
    log(f"[serve {tag}] {len(reqs)} requests, {gen_tokens} generated tokens in {wall:.2f} s: "
        f"{gen_tokens / wall:.2f} tok/s aggregate ({card})")
    log(f"[serve {tag}] latency p50 {snap['latency_p50_s']} s p95 {snap['latency_p95_s']} s, "
        f"TTFT p50 {snap['ttft_p50_s']} s p95 {snap['ttft_p95_s']} s (ServerStats) ({card})")
    log(f"[serve {tag}] acc_rate {acc:.4f} (mean over requests), mean steps per request "
        f"{np.mean([d['target_call_times'] for d in details]):.2f}, launches {launches}")
    log(f"[serve {tag}] {chunks[0]} chunks of up to {SYNC} steps; requests per admission "
        f"prefill, in order: {prefills}")
    _check_serving(f"serving {tag}", acc, launches)
    del engine, server, base
    torch.cuda.empty_cache()
    return dict(tok_s=gen_tokens / wall, wall_s=wall, tokens=gen_tokens, requests=len(reqs),
                acc_rate=acc, launches=launches, **{k: snap[k] for k in (
                    "latency_p50_s", "latency_p95_s", "ttft_p50_s", "ttft_p95_s")})


def _serving_engine(pair, reqs, **engine_kw):
    """A ``PagedEngine`` with scripts/bench_paged.py's settings for the 13B
    config (16 rows, 32 int8 blocks of 128, gamma 8, steps_per_sync 8,
    tables as wide as the mix's longest request) and ``engine_kw``."""
    from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

    bd, pd, bt, pt = pair
    worst = max(pl + mn for pl, mn in reqs) + SERVE_GAMMA + 1
    kw = dict(batch_rows=ROWS, num_blocks=BLOCKS, page=PAGE, max_pages_per_req=-(-worst // PAGE),
              max_new_cap=max(mn for _, mn in reqs), gamma=SERVE_GAMMA, eos_token_id=2,
              temperature=1.0, top_k=20, top_p=0.9, prompt_bucket=64, steps_per_sync=SYNC,
              kv_quant=True, device="cuda")
    return PagedEngine(bd, pd, bt, pt, **{**kw, **engine_kw})


def _check_serving(tag: str, acc: float, launches: dict) -> None:
    """The guards of every serving run: acceptance (target ~ draft, so a
    wrong kernel collapses it), B1 and B3 on the paged path, B2 never."""
    if acc < 0.6:
        raise AssertionError(f"{tag}: acceptance {acc:.3f} < 0.6: a kernel is likely wrong")
    if launches["int8_matmul"] <= 0 or launches["paged_flash_decode"] <= 0:
        raise AssertionError(f"{tag}: B1 or B3 was not launched on the paged path")
    if launches["flash_decode"] != 0:
        raise AssertionError(f"{tag}: B2 ran on the paged path")


def _engine_mix(kind: str, pair, **engine_kw) -> dict:
    """scripts/bench_paged.py's ``_run``: the mix's requests submitted at
    once (request i under rid i, so two runs draw the same streams) to a
    fresh engine, drained by ``run_until_idle``, after a warm-up of two
    requests at the mix's prompt length (a miss and, with the prefix cache,
    a hit). Watches each admission dispatch, the B1/B3 launches inside the
    extend windows, the active rows before each chunk and the preempted
    rids; checks the outputs, acceptance, launches and the pool ending
    free."""
    reqs, prompts = _mix_prompts(kind)
    engine = _serving_engine(pair, reqs, **engine_kw)
    warm = np.random.default_rng(5).integers(100, 31000, reqs[0][0])
    for rid in (10_000, 10_001):
        engine.submit_with_rid(rid, warm, 8)
        engine.run_until_idle()
    engine.completions.clear()
    hits0 = getattr(engine.allocator, "hits", 0)
    seen = dict(prefills=[], extends=[], extend_launches={}, active=[], preempted=[])
    prefill, extend = engine._dispatch_prefill, engine._dispatch_extend
    chunk, preempt = engine._dispatch_chunk, engine._preempt_row

    def dispatch_prefill(batch):
        seen["prefills"].append(len(batch))
        return prefill(batch)

    def dispatch_extend(batch):
        seen["extends"].append(len(batch))
        before = {k: fn.launches for k, fn in _counters().items()}
        out = extend(batch)
        for k, fn in _counters().items():
            seen["extend_launches"][k] = seen["extend_launches"].get(k, 0) + fn.launches - before[k]
        return out

    def dispatch_chunk():
        seen["active"].append(engine.num_active)
        return chunk()

    def preempt_row(row):
        seen["preempted"].append(engine._row_req[row].rid)
        return preempt(row)

    engine._dispatch_prefill, engine._dispatch_extend = dispatch_prefill, dispatch_extend
    engine._dispatch_chunk, engine._preempt_row = dispatch_chunk, preempt_row
    reset_launches()
    t0 = time.perf_counter()
    for i, (p, (_, mn)) in enumerate(zip(prompts, reqs)):
        engine.submit_with_rid(i, p, mn)
    engine.run_until_idle()
    wall = time.perf_counter() - t0
    launches = read_launches()
    comps = [engine.result(i) for i in range(len(reqs))]
    tag = f"{kind} {engine_kw}"
    if any(c is None for c in comps):
        raise AssertionError(f"{tag}: a request did not complete")
    tokens = _check_outputs(tag, reqs, prompts, [c.output_ids for c in comps],
                            pair[2].cfg.vocab_size)
    if engine.allocator.available_blocks != BLOCKS or engine.num_active or engine._pending:
        raise AssertionError(f"{tag}: the pool did not end fully free")
    acc = float(np.mean([c.details["acc_rate"] for c in comps]))
    _check_serving(tag, acc, launches)
    ttft = sorted(c.details["ttft_s"] for c in comps)
    out = dict(tok_s=tokens / wall, wall_s=wall, tokens=tokens, acc_rate=acc, launches=launches,
               ttft_p50_s=ttft[len(ttft) // 2], ttft_p95_s=ttft[int(len(ttft) * 0.95)],
               hits=getattr(engine.allocator, "hits", 0) - hits0,
               preemptions=len(seen["preempted"]), peak_active=max(seen["active"]),
               outs=[c.output_ids for c in comps],
               cached=[c.details["prefix_cached_tokens"] for c in comps], **seen)
    del engine
    torch.cuda.empty_cache()
    return out


def _mix_line(r: dict) -> str:
    return (f"{r['tokens']} generated tokens in {r['wall_s']:.2f} s: {r['tok_s']:.2f} tok/s "
            f"aggregate, TTFT p50 {r['ttft_p50_s']:.4f} s p95 {r['ttft_p95_s']:.4f} s, acc_rate "
            f"{r['acc_rate']:.4f}, peak active rows {r['peak_active']}, launches {r['launches']}")


def phase_shared_prefix(results, pair):
    """scripts/bench_paged.py's shared_prefix mix with the prefix cache and
    without it, on the same prompts: with it, only the first request misses
    (the registration), every later one hits the 4 system pages and extends
    its 64-token tail in 32-token windows through B3."""
    card = card_line()
    runs = {pc: _engine_mix("shared_prefix", pair, prefix_cache=pc) for pc in (True, False)}
    on = runs[True]
    misses = sum(c == 0 for c in on["cached"])
    for pc, r in runs.items():
        log(f"[shared_prefix] prefix_cache={pc}: {_mix_line(r)}; allocator hits {r['hits']} "
            f"pages; admission prefills {r['prefills']}, extend dispatches {r['extends']} "
            f"({card})")
    log(f"[shared_prefix] extend windows' launches: {on['extend_launches']}")
    if not (on["hits"] > 0 and misses == 1 and on["prefills"] == [1]
            and all(c in (0, SHARED_PAGES * PAGE) for c in on["cached"])
            and on["hits"] == SHARED_PAGES * (len(on["cached"]) - 1)):
        raise AssertionError(f"shared_prefix: a request after the first registration missed "
                             f"(cached {on['cached']}, hits {on['hits']})")
    if on["extend_launches"].get("paged_flash_decode", 0) <= 0:
        raise AssertionError("shared_prefix: B3 did not run in the extend windows")
    if runs[False]["hits"] or any(runs[False]["cached"]):
        raise AssertionError("shared_prefix: a hit without the prefix cache")
    results["shared_prefix"] = {pc: {k: v for k, v in r.items() if k != "outs"}
                                for pc, r in runs.items()}
    results["launches"]["shared_prefix"] = {
        k: sum(r["launches"][k] for r in runs.values()) for k in on["launches"]}


def phase_longgen(results, pair):
    """scripts/bench_paged.py's longgen mix on demand at overcommit 1.0
    (admission within the pool's worst case: no preemption) and 2.0 (twice
    that: the pool runs out and the youngest rows are preempted and
    resumed). Reports how many preempted requests came out bit-identical
    to the 1.0 run (equal in distribution is the contract on the card)."""
    card = card_line()
    runs = {oc: _engine_mix("longgen", pair, overcommit=oc) for oc in (1.0, 2.0)}
    for oc, r in runs.items():
        log(f"[longgen] overcommit {oc}: {_mix_line(r)}; preemptions {r['preemptions']} ({card})")
    if runs[1.0]["preemptions"] != 0 or runs[2.0]["preemptions"] <= 0:
        raise AssertionError(f"longgen: preemptions {runs[1.0]['preemptions']} at 1.0 and "
                             f"{runs[2.0]['preemptions']} at 2.0")
    preempted = sorted(set(runs[2.0]["preempted"]))
    same = [rid for rid in preempted
            if np.array_equal(runs[2.0]["outs"][rid], runs[1.0]["outs"][rid])]
    others = [rid for rid in range(len(runs[1.0]["outs"])) if rid not in preempted]
    same_others = sum(np.array_equal(runs[2.0]["outs"][r], runs[1.0]["outs"][r]) for r in others)
    log(f"[longgen] {len(same)}/{len(preempted)} preempted requests bit-identical to the 1.0 run "
        f"(rids {preempted}); {same_others}/{len(others)} of the others")
    results["longgen"] = {oc: {k: v for k, v in r.items() if k != "outs"}
                          for oc, r in runs.items()}
    results["longgen"]["preempted_identical"] = (len(same), len(preempted))
    results["launches"]["longgen"] = {
        k: sum(r["launches"][k] for r in runs.values()) for k in runs[1.0]["launches"]}


def phase_hit_burst_trickle(results, pair, n_req: int = EXTEND_KB):
    """Hit-path batch invariance: after one request has registered a
    512-token system prompt, ``n_req`` requests sharing it (576-token
    prompts, 48 new tokens) are admitted as one batch of hits (8 rows in
    each extend window: B1 at M=256) and then one at a time (M=32), under
    the same rids: the output ids must be equal. The extend windows plan B1
    and B3 batch-invariant."""
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import INVARIANT_BSZ, plan
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import plan as b1_plan

    rng = np.random.default_rng(3)
    system = rng.integers(100, 31000, SHARED_PAGES * PAGE).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(100, 31000, 2 * EXTEND_W).astype(np.int32)])
               for _ in range(n_req + 1)]
    reqs = [(len(p), 48) for p in prompts]
    engine = _serving_engine(pair, reqs, prefix_cache=True,
                             prefill_token_budget=n_req * len(prompts[0]))
    engine.submit_with_rid(1000, prompts[0], 48)
    engine.run_until_idle()
    engine.result(1000)
    kbs = []
    extend = engine._dispatch_extend

    def dispatch_extend(batch):
        kbs.append(len(batch))
        return extend(batch)

    engine._dispatch_extend = dispatch_extend
    for rid in range(n_req):
        engine.submit_with_rid(rid, prompts[1 + rid], 48)
    engine.run_until_idle()
    burst = [engine.result(rid) for rid in range(n_req)]
    trickle = []
    for rid in range(n_req):
        engine.submit_with_rid(rid, prompts[1 + rid], 48)
        engine.run_until_idle()
        trickle.append(engine.result(rid))
    if kbs != [n_req] + [1] * n_req or any(
            c.details["prefix_cached_tokens"] != SHARED_PAGES * PAGE for c in burst + trickle):
        raise AssertionError(f"hit burst vs trickle: extend batches {kbs}, not all hits")
    diff = []
    for rid, (a, b) in enumerate(zip(burst, trickle)):
        a, b = a.output_ids, b.output_ids
        if not np.array_equal(a, b):
            n = min(len(a), len(b))
            neq = np.nonzero(a[:n] != b[:n])[0]
            diff.append((rid, int(neq[0]) if neq.size else n))
    plans = (f"B3 target plan ps: batch of {n_req} {plan(n_req, 40, EXTEND_W, PAGE, EXTEND_PAGES).ps}"
             f", alone {plan(1, 40, EXTEND_W, PAGE, EXTEND_PAGES).ps}, invariant "
             f"{plan(INVARIANT_BSZ, 40, EXTEND_W, PAGE, EXTEND_PAGES).ps}; B1 5120x5120 ksplit: "
             f"M={n_req * EXTEND_W} {b1_plan(n_req * EXTEND_W, 5120, 5120)[1]}, M={EXTEND_W} "
             f"{b1_plan(EXTEND_W, 5120, 5120)[1]}, invariant {b1_plan(EXTEND_W, 5120, 5120, True)[1]}")
    if diff:
        log(f"[hit burst vs trickle] {len(diff)}/{n_req} requests differ: (rid, first differing "
            f"position) {diff}; {plans}")
        raise AssertionError("hit burst vs trickle: a hit's output depends on its admission batch")
    log(f"[hit burst vs trickle] all {n_req} prefix-cache hits give identical output ids admitted "
        f"together (extend batches {kbs[:1]}) and one at a time ({plans})")
    results["hit_burst_trickle"] = dict(requests=n_req, differ=diff)
    del engine
    torch.cuda.empty_cache()


def _pct(xs, q):
    """The q-th percentile (nearest rank below) of ``xs``, or nan."""
    if not xs:
        return float("nan")
    xs = sorted(xs)
    return xs[min(int(len(xs) * q / 100), len(xs) - 1)]


def _cold_mix_run(pair, chunked: bool, extra: int) -> dict:
    """scripts/bench_chunked_prefill.py's ``run_config`` on the port: a
    closed loop keeping COLD_ROWS + 2 requests in flight, driven by
    ``step()``, after ``warmup()``. Records every gap between two chunk
    reads, tagged with whether an admission (a prefill or an extend
    window) ran in it, the B3 launches of the draft-only windows, the
    prompts staged (every prompt longer than ``extend_chunk`` admitted
    while a row decodes: at 32 the 64-token ones too) and the rows a chunk
    carried."""
    from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

    bd, pd, bt, pt = pair
    rng = np.random.default_rng(0)
    sched = [(COLD_LEN, COLD_NEW) if i % 5 == 4 else (64, 48) for i in range(COLD_N)]
    prompts = [rng.integers(100, 31000, pl).astype(np.int32) for pl, _ in sched]
    worst = max(pl + mn for pl, mn in sched) + SERVE_GAMMA + 1
    eng = PagedEngine(bd, pd, bt, pt, batch_rows=COLD_ROWS, num_blocks=BLOCKS, page=PAGE,
                      max_pages_per_req=-(-worst // PAGE), max_new_cap=64, gamma=SERVE_GAMMA,
                      eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, prompt_bucket=64,
                      steps_per_sync=COLD_SYNC, kv_quant=True, extend_chunk=EXTEND_W,
                      chunked_prefill=chunked, prefill_extra=extra, device="cuda")
    t_w = time.perf_counter()
    eng.warmup(prompt_lens=sorted({pl for pl, _ in sched}))
    warm_s = time.perf_counter() - t_w
    b3 = _counters()["paged_flash_decode"]
    gaps, mark, t_last, draft_b3, prefilling, staged, rows = [], [False], [None], [0], [], [0], []
    prefill, window, meta = eng._dispatch_prefill, eng._extend_window, eng._meta_np
    stage = eng._stage_admission

    def stage_admission(batch):
        staged[0] += len(batch)
        return stage(batch)

    def dispatch_prefill(batch):
        mark[0] = True
        return prefill(batch)

    def extend_window(arrays, j, draft_only=False):
        mark[0] = True
        before = b3.launches
        out = window(arrays, j, draft_only)
        if draft_only:
            draft_b3[0] += b3.launches - before
        return out

    def meta_np(pack):
        prefilling.append(eng._n_prefilling())
        rows.append(eng.num_active)
        hv = meta(pack)  # reads the chunk's metadata: the chunk has finished
        now = time.perf_counter()
        if t_last[0] is not None:
            gaps.append((now - t_last[0], mark[0]))
        t_last[0], mark[0] = now, False
        return hv

    eng._dispatch_prefill, eng._extend_window, eng._meta_np = dispatch_prefill, extend_window, meta_np
    eng._stage_admission = stage_admission
    interleaved0 = eng.interleaved_chunks
    queue = list(zip(prompts, sched))[::-1]
    rids = []

    def top_up():
        while queue and len(rids) - len(eng.completions) < COLD_ROWS + 2:
            p, (_, mn) = queue.pop()
            rids.append(eng.submit(p, mn))

    reset_launches()
    t0 = time.perf_counter()
    top_up()
    guard = 0
    while (eng.num_active or eng._pending or queue) and guard < 100_000:
        guard += 1
        eng.step()
        top_up()
    wall = time.perf_counter() - t0
    launches = read_launches()
    comps = [eng.result(r) for r in rids]
    tag = f"cold_mix chunked={chunked} prefill_extra={extra}"
    if any(c is None for c in comps):
        raise AssertionError(f"{tag}: a request did not complete")
    tokens = _check_outputs(tag, sched, prompts, [c.output_ids for c in comps],
                            bt.cfg.vocab_size)
    if eng.allocator.available_blocks != BLOCKS or eng.num_active or eng._pending:
        raise AssertionError(f"{tag}: the pool did not end fully free")
    acc = float(np.mean([c.details["acc_rate"] for c in comps]))
    _check_serving(tag, acc, launches)
    steady = [g for g, adm in gaps if not adm]
    admission = [g for g, adm in gaps if adm]
    cold = [c.details["ttft_s"] for c, (pl, _) in zip(comps, sched) if pl == COLD_LEN]
    out = dict(tok_s=tokens / wall, wall_s=wall, tokens=tokens, acc_rate=acc, launches=launches,
               warmup_s=warm_s, steady_gap_p50_ms=_pct(steady, 50) * 1e3,
               steady_gap_p95_ms=_pct(steady, 95) * 1e3,
               admission_gap_p95_ms=_pct(admission, 95) * 1e3,
               admission_gap_max_ms=max(admission, default=float("nan")) * 1e3,
               cold_ttft_p50_s=_pct(cold, 50), interleaved_chunks=eng.interleaved_chunks - interleaved0,
               draft_window_b3=draft_b3[0], preemptions=eng.preemptions, chunks=len(prefilling),
               prefilling_rows=sum(prefilling), staged=staged[0],
               mean_rows=float(np.mean(rows)) if rows else 0.0,
               outs=[c.output_ids for c in comps], cold=[pl == COLD_LEN for pl, _ in sched])
    del eng
    torch.cuda.empty_cache()
    return out


def phase_cold_mix(results, pair):
    """SARATHI's A/B on the port: the cold mix monolithic, chunked, and
    chunked with prefill_extra 8 (verify windows of 17). Every request must
    complete with valid ids and the pool end free; chunked runs must carry
    a prefilling row in some chunks (fewer with prefill_extra), the
    monolithic none; B3 must run in the draft-only windows. How many
    requests (cold ones apart) come out identical to the monolithic run's
    is reported: on the card B1 plans the verify from M and B3 attends
    otherwise than the admission prefill, so bits may differ."""
    card = card_line()
    runs = {(c, e): _cold_mix_run(pair, c, e) for c, e in ((False, 0), (True, 0),
                                                           (True, COLD_EXTRA))}
    mono = runs[False, 0]
    for (chunked, extra), r in runs.items():
        same = [np.array_equal(a, b) for a, b in zip(r["outs"], mono["outs"])]
        n_cold = sum(r["cold"])
        same_cold = sum(s for s, c in zip(same, r["cold"]) if c)
        log(f"[cold_mix chunked={chunked} prefill_extra={extra}] {r['tokens']} generated tokens in "
            f"{r['wall_s']:.2f} s: {r['tok_s']:.2f} tok/s aggregate; chunk gaps: steady p50 "
            f"{r['steady_gap_p50_ms']:.1f} ms p95 {r['steady_gap_p95_ms']:.1f} ms, admission p95 "
            f"{r['admission_gap_p95_ms']:.1f} ms max {r['admission_gap_max_ms']:.1f} ms; cold TTFT "
            f"p50 {r['cold_ttft_p50_s']:.3f} s; interleaved_chunks {r['interleaved_chunks']} of "
            f"{r['chunks']} chunks ({r['prefilling_rows']} prefilling row-chunks, {r['staged']} "
            f"prompts staged, {r['mean_rows']:.2f} rows a chunk on average); B3 "
            f"launches in the draft windows {r['draft_window_b3']}; acc_rate {r['acc_rate']:.4f}; "
            f"preemptions {r['preemptions']}; identical to the monolithic run: {same_cold}/{n_cold} "
            f"cold, {sum(same) - same_cold}/{len(same) - n_cold} others; warm-up "
            f"{r['warmup_s']:.1f} s; launches {r['launches']} ({card})")
    chunked, wide = runs[True, 0], runs[True, COLD_EXTRA]
    if mono["interleaved_chunks"] != 0 or chunked["interleaved_chunks"] <= 0:
        raise AssertionError(f"cold_mix: interleaved_chunks {mono['interleaved_chunks']} "
                             f"monolithic, {chunked['interleaved_chunks']} chunked")
    if not 0 < wide["interleaved_chunks"] < chunked["interleaved_chunks"]:
        raise AssertionError(f"cold_mix: prefill_extra {COLD_EXTRA} interleaved "
                             f"{wide['interleaved_chunks']} chunks, not fewer than "
                             f"{chunked['interleaved_chunks']}")
    if chunked["draft_window_b3"] <= 0 or wide["draft_window_b3"] <= 0:
        raise AssertionError("cold_mix: B3 did not run in the draft-only windows")
    results["cold_mix"] = {f"chunked={c} prefill_extra={e}": {
        k: v for k, v in r.items() if k not in ("outs", "cold")} for (c, e), r in runs.items()}
    results["launches"]["cold_mix"] = {
        k: sum(r["launches"][k] for r in runs.values()) for k in mono["launches"]}


def _adaptive_run(pair, arms) -> dict:
    """ADAPT_N uniform requests (64 + 48) submitted at once under rids 0..,
    drained by ``run_until_idle`` after ``warmup()``, at the serving
    settings with two-page tables; fixed gamma when ``arms`` is None.
    Records each chunk's gamma, whether the ramp epoch ran it, and the
    active rows."""
    from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

    bd, pd, bt, pt = pair
    rng = np.random.default_rng(0)
    reqs = [(64, 48)] * ADAPT_N
    prompts = [rng.integers(100, 31000, 64).astype(np.int32) for _ in reqs]
    eng = PagedEngine(bd, pd, bt, pt, batch_rows=ROWS, num_blocks=BLOCKS, page=PAGE,
                      max_pages_per_req=ADAPT_PAGES, max_new_cap=48, gamma=SERVE_GAMMA,
                      eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, prompt_bucket=64,
                      steps_per_sync=SYNC, kv_quant=True, adaptive_gamma=arms, device="cuda")
    eng.warmup(prompt_lens=(64,))
    gammas, ramp, active = [], [], []
    chunk = eng._dispatch_chunk

    def dispatch_chunk():
        active.append(eng.num_active)
        in_ramp = eng._ep_phase == "ramp"
        pack = chunk()
        gammas.append(eng._chunk_log[-1][0])
        if arms and in_ramp:
            ramp.append(eng._chunk_log[-1][0])
        return pack

    eng._dispatch_chunk = dispatch_chunk
    reset_launches()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit_with_rid(i, p, 48)
    eng.run_until_idle()
    wall = time.perf_counter() - t0
    launches = read_launches()
    comps = [eng.result(i) for i in range(ADAPT_N)]
    tag = f"adaptive {arms or SERVE_GAMMA}"
    if any(c is None for c in comps):
        raise AssertionError(f"{tag}: a request did not complete")
    tokens = _check_outputs(tag, reqs, prompts, [c.output_ids for c in comps], bt.cfg.vocab_size,
                            gamma=max(arms or (SERVE_GAMMA,)))
    if eng.allocator.available_blocks != BLOCKS or eng.num_active or eng._pending:
        raise AssertionError(f"{tag}: the pool did not end fully free")
    acc = float(np.mean([c.details["acc_rate"] for c in comps]))
    _check_serving(tag, acc, launches)
    out = dict(tok_s=tokens / wall, wall_s=wall, tokens=tokens, acc_rate=acc, launches=launches,
               peak_active=max(active), chunks=len(gammas),
               chunks_by_gamma={g: gammas.count(g) for g in sorted(set(gammas))},
               ramp=ramp, stats=eng.adaptive_stats())
    del eng
    torch.cuda.empty_cache()
    return out


def phase_adaptive(results, pair):
    """Fixed gamma 8 against adaptive_gamma (4, 8, 16) in epoch mode on a
    saturated uniform mix: the ramp epoch must rotate the arms in order
    chunk by chunk (it closes with the first wave's 16 completions, which
    may come before all three arms had a chunk), every arm must run, the
    outputs be valid, acc_rate (over the drafts each request made) reach
    0.6 and the pool end free. 16 rows of two pages commit the 32-page
    pool exactly at overcommit 1.0."""
    card = card_line()
    runs = {"fixed": _adaptive_run(pair, None), "adaptive": _adaptive_run(pair, ADAPT_ARMS)}
    for name, r in runs.items():
        st = r["stats"]
        log(f"[adaptive {name}] {r['tokens']} generated tokens in {r['wall_s']:.2f} s: "
            f"{r['tok_s']:.2f} tok/s aggregate; acc_rate {r['acc_rate']:.4f}; peak active rows "
            f"{r['peak_active']}; {r['chunks']} chunks by gamma {r['chunks_by_gamma']}; launches "
            f"{r['launches']} ({card})")
        if name == "adaptive":
            log(f"[adaptive {name}] ramp chunks' gammas {r['ramp']}; epochs {st['epochs']}, phase "
                f"{st['epoch_phase']}, incumbent {st['incumbent']}, gamma {st['gamma']}, acc_ema "
                f"{st['acc_ema']:.4f}; epoch rates {st['epoch_rates']}; chunk rates "
                f"{ {g: round(v, 1) for g, v in st['chunk_rates'].items()} }")
            log(f"[adaptive {name}] epoch history {st['epoch_history']}")
    ad = runs["adaptive"]
    rotation = [ADAPT_ARMS[k % len(ADAPT_ARMS)] for k in range(len(ad["ramp"]))]
    if not ad["ramp"] or ad["ramp"][:2 * len(ADAPT_ARMS)] != rotation[:2 * len(ADAPT_ARMS)]:
        raise AssertionError(f"adaptive: the ramp ran {ad['ramp']}, not the arms in turn")
    if set(ad["chunks_by_gamma"]) != set(ADAPT_ARMS):
        raise AssertionError(f"adaptive: the arms run were {ad['chunks_by_gamma']}, not every arm")
    results["adaptive"] = runs
    results["launches"]["adaptive"] = {
        k: sum(r["launches"][k] for r in runs.values()) for k in runs["fixed"]["launches"]}


def phase_burst_trickle(results, pair, n_req: int = 8, tag: str = "burst_trickle"):
    """The same requests through one ``PagedEngine`` (the uniform mix's
    settings) once as a burst (one admission prefill of all of them) and
    once one at a time (an admission each), under the same rids, so the
    same per-request random streams: the output ids must be equal. Each
    admission prefill has M = requests x 64 rows; its B1 calls are planned
    batch-invariant (the split of K from (K, N) alone), and every other
    call of a step has the same shapes however many requests are live."""
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import plan
    from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

    bd, pd, bt, pt = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(100, 31000, 64).astype(np.int32) for _ in range(n_req)]
    engine = PagedEngine(
        bd, pd, bt, pt, batch_rows=ROWS, num_blocks=BLOCKS, page=PAGE, max_pages_per_req=1,
        max_new_cap=48, gamma=SERVE_GAMMA, eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9,
        prompt_bucket=64, steps_per_sync=SYNC, kv_quant=True, device="cuda")
    for rid, p in enumerate(prompts):
        engine.submit_with_rid(rid, p, 48)
    engine.run_until_idle()
    burst = [engine.result(rid).output_ids for rid in range(n_req)]
    trickle = []
    for rid, p in enumerate(prompts):
        engine.submit_with_rid(rid, p, 48)
        engine.run_until_idle()
        trickle.append(engine.result(rid).output_ids)
    diff = []  # (rid, first differing position)
    for rid, (a, b) in enumerate(zip(burst, trickle)):
        if not np.array_equal(a, b):
            n = min(len(a), len(b))
            neq = np.nonzero(a[:n] != b[:n])[0]
            diff.append((rid, int(neq[0]) if neq.size else n))
    ks = {m: plan(m, 5120, 5120, True)[1] for m in (64, n_req * 64)}
    if diff:
        log(f"[burst vs trickle] {len(diff)}/{n_req} requests differ: (rid, first differing "
            f"position) {diff}; B1 ksplit of a 5120x5120 admission prefill projection: M=64 -> "
            f"{ks[64]}, M={n_req * 64} -> {ks[n_req * 64]}")
    else:
        log(f"[burst vs trickle] all {n_req} requests give identical output ids "
            f"({sum(len(o) - 64 for o in burst)} generated tokens; B1 ksplit at the prefill: "
            f"M=64 -> {ks[64]}, M={n_req * 64} -> {ks[n_req * 64]})")
    results[tag] = dict(requests=n_req, differ=diff)
    if diff:
        raise AssertionError(f"{tag}: a request's output depends on its admission batch")
    del engine
    torch.cuda.empty_cache()


def phase_serving(results, pair):
    """The uniform and mixed mixes on demand (the engine's default), and the
    mixed mix once more reserving each request's worst case at admission
    (``on_demand=False``)."""
    serving = {kind: _serve_mix(kind, pair) for kind in ("uniform", "mixed")}
    serving["mixed reserved"] = _serve_mix("mixed", pair, on_demand=False)
    results["serving"] = serving
    results["launches"]["paged_serving"] = {
        name: sum(serving[k]["launches"][name] for k in serving)
        for name in serving["uniform"]["launches"]}


def _slotted_engine(pair):
    """A ``ContinuousBatchingEngine`` with scripts/bench_serving.py's settings
    for the 13B config: 16 slots of 256 positions, int8 KV target, gamma 8,
    steps_per_sync 8, max_new_cap 64."""
    import dataclasses

    from llmspeculativesampling_tpu_torch.serve.scheduler import ContinuousBatchingEngine

    bd, pd, bt, pt = pair
    return ContinuousBatchingEngine(
        bd, pd, dataclasses.replace(bt, kv_quant=True), pt, num_slots=SLOTS,
        max_total_len=SLOT_LEN, max_new_cap=SLOT_NEW, gamma=SERVE_GAMMA, eos_token_id=2,
        temperature=1.0, top_k=20, top_p=0.9, steps_per_sync=SYNC, device="cuda")


def phase_slotted(results, pair):
    """The slotted serving path: ``BatchedInferenceServer`` over the
    slotted engine (scripts/bench_serving.py --config 13b --max_total_len
    256 --gamma 8 --num_slots 16 --kv_int8 --steps_per_sync 8), after
    ``warmup()``; 24 requests of 64-token prompts and 64 new tokens from
    client threads and one more over HTTP on a loopback port. Checks every
    output, acc_rate >= 0.6, B1 and B2 launched and B3 not; prints tok/s,
    TTFT, latency, chunks and host ms a chunk, and the paged uniform mix of
    this run beside it (the same 4,096-position KV budget)."""
    import threading
    import urllib.request

    from llmspeculativesampling_tpu_torch.serve.server import (
        BatchedInferenceServer, InferenceServer, ServerConfig, make_http_server)

    bd, pd, bt, pt = pair
    card = card_line()
    engine = _slotted_engine(pair)
    t0 = time.perf_counter()
    engine.warmup(prompt_len=64)
    torch.cuda.synchronize()
    log(f"[slotted] warmup() {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(100, 31000, 64).astype(np.int32) for _ in range(SLOT_N)]
    prompts.append(prompts[0])  # the HTTP request repeats the first prompt
    reqs = [(64, SLOT_NEW)] * len(prompts)
    base = InferenceServer(bd, pd, engine.bundle_t, pt, config=ServerConfig(
        num_tokens=SLOT_NEW, top_k=20, top_p=0.9, gamma=SERVE_GAMMA, eos_token_id=2),
        device="cuda")
    server = BatchedInferenceServer(base, engine=engine)
    details, prefills, chunk_ms = [], [], []
    take, prefill, chunk = engine.result, engine._dispatch_prefill, engine._dispatch_chunk

    def result(rid):
        comp = take(rid)
        details.append(comp.details)
        return comp

    def dispatch_prefill(batch, bucket):
        prefills.append(len(batch))
        return prefill(batch, bucket)

    def dispatch_chunk():
        t = time.perf_counter()
        out = chunk()
        out = out.cpu()  # the harvest's one read: the chunk's wall ends here
        chunk_ms.append((time.perf_counter() - t) * 1e3)
        return out

    engine.result, engine._dispatch_prefill = result, dispatch_prefill
    engine._dispatch_chunk = dispatch_chunk
    httpd = make_http_server(server, "127.0.0.1", 0)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    outs = [None] * len(prompts)

    def call(i):
        _, outs[i] = server.process_request({"prompt_ids": prompts[i].tolist(),
                                             "max_tokens": SLOT_NEW})

    def call_http(i):
        body = json.dumps({"prompt_ids": prompts[i].tolist(), "max_tokens": SLOT_NEW}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            outs[i] = np.asarray(json.loads(r.read())["output_ids"])

    reset_launches()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=call_http if i == len(prompts) - 1 else call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = read_launches()
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()
    http_thread.join(timeout=10)
    if any(t.is_alive() for t in threads) or http_thread.is_alive():
        raise AssertionError("slotted: a client thread did not finish")
    gen_tokens = _check_outputs("slotted", reqs, prompts, outs, bt.cfg.vocab_size)
    if engine.num_active or engine._pending:
        raise AssertionError("slotted: the engine did not drain")
    acc = float(np.mean([d["acc_rate"] for d in details]))
    snap = base.stats.snapshot()
    log(f"[slotted {SLOTS}x{SLOT_LEN}] {len(prompts)} requests, {gen_tokens} generated tokens in "
        f"{wall:.2f} s: {gen_tokens / wall:.2f} tok/s aggregate, TTFT p50 {snap['ttft_p50_s']} s "
        f"p95 {snap['ttft_p95_s']} s, latency p50 {snap['latency_p50_s']} s (ServerStats), "
        f"{len(chunk_ms)} chunks of up to {SYNC} steps, host ms a chunk p50 "
        f"{_pct(chunk_ms, 50):.1f} max {max(chunk_ms):.1f}, acc_rate {acc:.4f} ({card})")
    log(f"[slotted] requests per admission prefill, in order: {prefills}; launches {launches}")
    if acc < 0.6:
        raise AssertionError(f"slotted: acceptance {acc:.3f} < 0.6: a kernel is likely wrong")
    if launches["int8_matmul"] <= 0 or launches["flash_decode"] <= 0:
        raise AssertionError("slotted: B1 or B2 was not launched on the slotted path")
    if launches["paged_flash_decode"] != 0:
        raise AssertionError("slotted: B3 ran on the slotted path")
    paged = results["serving"]["uniform"]
    log(f"[slotted vs paged] paged/slotted throughput {paged['tok_s'] / (gen_tokens / wall):.2f}x "
        f"({paged['tok_s']:.2f} / {gen_tokens / wall:.2f} tok/s), TTFT p50 slotted/paged "
        f"{snap['ttft_p50_s'] / paged['ttft_p50_s']:.2f}x; the same 4,096-position KV budget "
        f"(paged: {BLOCKS} blocks of {PAGE} over {ROWS} rows, 25 x (64, 48); slotted: {SLOTS} x "
        f"{SLOT_LEN}, 25 x (64, {SLOT_NEW})); this run ({card})")
    results["slotted"] = dict(tok_s=gen_tokens / wall, wall_s=wall, tokens=gen_tokens,
                              acc_rate=acc, chunks=len(chunk_ms), chunk_ms_p50=_pct(chunk_ms, 50),
                              **{k: snap[k] for k in ("latency_p50_s", "ttft_p50_s",
                                                      "ttft_p95_s")})
    results["launches"]["slotted"] = launches
    engine.result, engine._dispatch_prefill = take, prefill
    engine._dispatch_chunk = chunk
    _slotted_burst_trickle(engine)
    del engine, server, base
    torch.cuda.empty_cache()


def _slotted_burst_trickle(engine, n_req: int = 8):
    """8 requests through the slotted engine as a burst (one admission
    prefill of all of them) and one at a time, under the same rids (so the
    same per-request streams): the output ids must be equal. Every decode
    step runs all 16 slots, whoever holds them."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(100, 31000, 64).astype(np.int32) for _ in range(n_req)]
    rid0 = engine._next_rid
    burst = [engine.submit(p, 48) for p in prompts]
    engine.run_until_idle()
    burst = [engine.result(r).output_ids for r in burst]
    engine._next_rid = rid0
    trickle = []
    for p in prompts:
        rid = engine.submit(p, 48)
        engine.run_until_idle()
        trickle.append(engine.result(rid).output_ids)
    diff = [i for i, (a, b) in enumerate(zip(burst, trickle)) if not np.array_equal(a, b)]
    log(f"[slotted burst vs trickle] {n_req - len(diff)}/{n_req} requests give identical output "
        f"ids ({sum(len(o) - 64 for o in burst)} generated tokens in the burst)")
    if diff:
        raise AssertionError(f"slotted burst vs trickle: requests {diff} depend on their admission")



def _drain(engine, pipelined: bool) -> None:
    """Serve everything queued: the pipelined ``run_until_idle`` (captured
    steps replayed), or a synchronous ``step()`` loop of eager steps."""
    from llmspeculativesampling_tpu_torch.engine import device_loop

    if pipelined:
        engine.run_until_idle()
        return
    with device_loop.eager_steps():
        while engine._pending or engine.num_active:
            engine.step()


def _pipeline_pass(engine, submit, pipelined: bool, traced: bool) -> dict:
    """One drain of the requests ``submit()`` queues (returning their
    rids): the completions by rid, the wall, the device-busy share of a
    traced drain, the chunks and masked steps, and the host gaps between
    one chunk's dispatch returning and the next one's starting (the
    harvest, admission and table upkeep between them; under the
    synchronous loop also the wait for the chunk's end), and how many
    harvests ended with work still queued on the card (the device busy
    across the harvest)."""
    gaps, ends, busy_after = [], [], []
    chunk, harvest = engine._dispatch_chunk, engine._harvest

    def dispatch():
        t = time.perf_counter()
        if ends:
            gaps.append((t - ends[-1]) * 1e3)
        out = chunk()
        ends.append(time.perf_counter())
        return out

    def harvest_(*a):
        out = harvest(*a)
        busy_after.append(not torch.cuda.current_stream().query())  # work still queued
        return out

    engine._dispatch_chunk, engine._harvest = dispatch, harvest_
    m0 = engine.masked_steps
    rids = submit()
    torch.cuda.synchronize()
    if traced:
        _, wall, busy = _traced(lambda: _drain(engine, pipelined))
    else:
        t0 = time.perf_counter()
        _drain(engine, pipelined)
        torch.cuda.synchronize()
        wall, busy = time.perf_counter() - t0, float("nan")
    del engine._dispatch_chunk, engine._harvest  # the class's methods again
    comps = {rid: engine.result(rid) for rid in rids}
    tokens = sum(len(c.output_ids) - c.prompt_len for c in comps.values())
    return dict(comps=comps, wall=wall, tok_s=tokens / wall, tokens=tokens,
                idle=1 - busy / wall, chunks=len(ends), masked=engine.masked_steps - m0,
                gap_p50_ms=_pct(gaps, 50), gap_max_ms=max(gaps) if gaps else float("nan"),
                busy_harvests=sum(busy_after), harvests=len(busy_after))


def _same_completions(tag: str, a: dict, b: dict) -> None:
    for rid, ca in a.items():
        cb = b[rid]
        if not np.array_equal(ca.output_ids, cb.output_ids) or any(
                ca.details[k] != cb.details[k] for k in (
                    "acc_len", "accepted_count", "resample_count", "target_sample_count",
                    "target_call_times", "tokens_generated")):
            raise AssertionError(f"{tag}: request {rid} differs between the pipelined and the "
                                 "synchronous run")


def phase_serving_pipeline(results, pair):
    """The serving engines' one-deep pipeline over captured steps. The paged
    uniform mix (``scripts/bench_paged.py --config 13b --kv_int8
    --steps_per_sync 8``: 24 x (64, 48) over 16 rows, 32 int8 blocks of
    128, gamma 8) and the slotted mix (16 slots x 256, int8 KV, gamma 8,
    steps_per_sync 8, 25 x (64, 64)) each run as the pipelined
    ``run_until_idle`` over replayed steps and as a synchronous ``step()``
    loop of eager steps (``device_loop.eager_steps``), once untimed and
    untraced for tok/s and once under ``torch.profiler`` for the idle
    share: every request's ids, acc_len and counts equal across the four
    (fixed gamma, overcommit 1.0, no chunked prefill: rows are independent
    at a static M and admission prefills are batch-invariant); prints the
    host gap between two dispatches and the masked steps a chunk.
    Launches counted under "serving_pipeline": the pipelined untraced
    runs' (B1 and B3 paged, B1 and B2 slotted)."""
    from llmspeculativesampling_tpu_torch.engine import device_loop

    card = card_line()
    out, totals = {}, dict.fromkeys(_counters(), 0)
    reqs, prompts = _mix_prompts("uniform")
    paged = _serving_engine(pair, reqs)
    for pl in sorted({pl for pl, _ in reqs}):  # warm-up: the capture of the gamma-8 step
        paged.submit(np.random.default_rng(pl).integers(100, 31000, pl), 16)
    paged.run_until_idle()
    paged.completions.clear()

    def submit_paged():
        for i, (p, (_, mn)) in enumerate(zip(prompts, reqs)):
            paged.submit_with_rid(i, p, mn)
        return list(range(len(reqs)))

    slotted = _slotted_engine(pair)
    slotted.warmup(prompt_len=64)
    rng = np.random.default_rng(0)
    s_prompts = [rng.integers(100, 31000, 64).astype(np.int32) for _ in range(SLOT_N + 1)]

    def submit_slotted():
        slotted._next_rid = 0
        return [slotted.submit(p, SLOT_NEW) for p in s_prompts]

    engines = {"paged": (paged, submit_paged, ("int8_matmul", "paged_flash_decode"),
                         "flash_decode", "serve_paged"),
               "slotted": (slotted, submit_slotted, ("int8_matmul", "flash_decode"),
                           "paged_flash_decode", "serve_slots")}
    for name, (eng, submit, used, unused, kind) in engines.items():
        runs = {}
        for label, pipelined, traced in (("pipelined", True, False), ("sync", False, False),
                                         ("pipelined traced", True, True),
                                         ("sync traced", False, True)):
            reset_launches()
            runs[label] = _pipeline_pass(eng, submit, pipelined, traced)
            launches = read_launches()
            if label == "pipelined":
                for k, v in launches.items():
                    totals[k] += v
                if any(launches[k] <= 0 for k in used) or launches[unused]:
                    raise AssertionError(f"serving_pipeline {name}: launches {launches}")
            _same_completions(f"serving_pipeline {name} {label}", runs["pipelined"]["comps"],
                              runs[label]["comps"])
        per_replay = [c for k, c in device_loop.graph_launches() if k == kind][-1]
        acc = float(np.mean([c.details["acc_rate"] for c in runs["pipelined"]["comps"].values()]))
        if acc < 0.6:
            raise AssertionError(f"serving_pipeline {name}: acceptance {acc:.3f} < 0.6")
        for label in ("pipelined", "sync"):
            r, t = runs[label], runs[label + " traced"]
            log(f"[serving_pipeline {name} {label}] {len(r['comps'])} requests, {r['tokens']} "
                f"tokens in {r['wall']:.3f} s: {r['tok_s']:.2f} tok/s; {r['chunks']} chunks, "
                f"masked steps a chunk {r['masked'] / max(r['chunks'], 1):.3f}, host gap between "
                f"dispatches p50 {r['gap_p50_ms']:.2f} ms max {r['gap_max_ms']:.2f} ms, device "
                f"busy at the end of {r['busy_harvests']} of {r['harvests']} harvests; traced: "
                f"idle share {t['idle']:.3f}, {t['tok_s']:.2f} tok/s ({card})")
        log(f"[serving_pipeline {name}] completions equal per request id across the four runs; "
            f"acc_rate {acc:.4f}; launches a replayed step {per_replay}; pipelined/sync tok/s "
            f"{runs['pipelined']['tok_s'] / runs['sync']['tok_s']:.3f}x")
        out[name] = {label: {k: v for k, v in r.items() if k != "comps"}
                     for label, r in runs.items()}
        out[name]["per_replay"] = per_replay
    del paged, slotted, engines
    torch.cuda.empty_cache()
    results["launches"]["serving_pipeline"] = totals
    results["serving_pipeline"] = out


def _tp_logits(bundle, params, pre, ver):
    """Logits of a 64-token prefill and a 25-token verify through one cache."""
    cache = bundle.make_cache(1, S_MAX, device=pre.device)
    l0, cache = bundle.forward(params, bundle.cfg, pre, cache)
    l1, _ = bundle.forward(params, bundle.cfg, ver, cache)
    return l0.float(), l1.float()


def _time_all_reduce(mesh, shape, device, iters: int = 50) -> float:
    """Host ms of one fp32 all_reduce of ``shape`` over the tp group, the
    ranks started together by a barrier, each call waited for."""
    import torch.distributed as dist

    from llmspeculativesampling_tpu_torch.core.config import synchronize
    from llmspeculativesampling_tpu_torch.parallel.comm import all_reduce

    x = torch.randn(shape, device=device) * 1e-3
    for _ in range(5):
        all_reduce(x, mesh)
    synchronize(x.device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        all_reduce(x, mesh)
    synchronize(x.device)
    return (time.perf_counter() - t0) / iters * 1e3


def tp_rank() -> dict:
    """One rank of the tp=2 path (run by ``phase_tp`` through
    ``parallel/launch.py``, two ranks on cuda:0 over gloo). The ranks build
    the 13B-int8 pair from seed 0 one at a time, keep their shards and free
    the rest; rank 0 first runs the unsharded prefill and verify for the
    parity check. Then: the tp=2 logits gathered, the distributed top-k on
    them, the all_reduce time, and, launches counted from here, the
    speculative and AR engines with ``tp_mesh``, ``PagedMultiHostDriver``
    over ``PagedEngine(mesh=)`` and ``MultiHostDriver`` over
    ``ContinuousBatchingEngine(mesh=)``. Returns tensors on the CPU, numpy
    and numbers."""
    import dataclasses

    import torch.distributed as dist

    from llmspeculativesampling_tpu_torch.core.config import synchronize
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8_small_draft
    from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate
    from llmspeculativesampling_tpu_torch.engine.speculative import speculative_generate
    from llmspeculativesampling_tpu_torch.ops.sampling import (
        SamplingConfig, norm_logits_topk, norm_logits_topk_tp)
    from llmspeculativesampling_tpu_torch.parallel.comm import vocab_slice
    from llmspeculativesampling_tpu_torch.parallel.sharding import make_mesh, param_specs, shard_params
    from llmspeculativesampling_tpu_torch.serve.multihost import MultiHostDriver, PagedMultiHostDriver
    from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine
    from llmspeculativesampling_tpu_torch.serve.scheduler import ContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda"
    rank, mesh = dist.get_rank(), make_mesh(1, TP)
    out = {"rank": rank, "seconds": {}}
    clock = [time.perf_counter()]

    def lap(name):
        synchronize(torch.device(device))
        now = time.perf_counter()
        out["seconds"][name] = now - clock[0]
        clock[0] = now
        if rank == 0:
            log(f"[tp rank 0] {name} {out['seconds'][name]:.1f} s")
    rng = np.random.default_rng(3)
    pre = torch.as_tensor(rng.integers(100, 31000, (1, 64)), device=device)
    ver = torch.as_tensor(rng.integers(100, 31000, (1, GAMMA + 1)), device=device)
    for r in range(TP):  # one full pair (13.3 GB) on the card at a time
        if r == rank:
            t0 = time.perf_counter()
            bd, pd, bt, pt = synthetic_pair_int8_small_draft(device=device)
            if rank == 0:
                out["whole"] = [x.cpu() for x in _tp_logits(bt, pt, pre, ver)]
            pd = shard_params(pd, param_specs("llama", bd.cfg), mesh)
            pt = shard_params(pt, param_specs("llama", bt.cfg), mesh)
            gc.collect()
            torch.cuda.empty_cache()
            out["shard_gib"] = torch.cuda.memory_allocated() / 2 ** 30
            out["build_s"] = time.perf_counter() - t0
        dist.barrier()
    lap("build and shard, one rank after the other")

    # parity: the gathered tp=2 logits, and the distributed top-k on them
    l0, l1 = _tp_logits(bt.for_params(pt), pt, pre, ver)
    out["tp"] = [l0.cpu(), l1.cpu()]
    cfg = SamplingConfig(1.0, 20, 0.9)
    dist_tp = norm_logits_topk_tp(vocab_slice(l1[0], mesh), SamplingConfig(1.0, 20, 0.9, tp_mesh=mesh))
    dense = norm_logits_topk(l1[0], cfg)
    out["topk_equal"] = bool(torch.equal(dist_tp.idx, dense.idx)
                             and torch.equal(dist_tp.probs, dense.probs))
    out["all_reduce_ms"] = {f"{what} {m} x 5120": _time_all_reduce(mesh, (m, 5120), device)
                            for what, m in (("verify", GAMMA + 1), ("decode", 1),
                                            ("serving verify", ROWS * (SERVE_GAMMA + 1)))}
    # the transport's floor: the decode's size as a CPU tensor (no copies)
    out["all_reduce_ms"]["decode 1 x 5120 on the host"] = _time_all_reduce(mesh, (1, 5120), "cpu")
    lap("parity and all_reduce timing")

    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, device=device, tp_mesh=mesh)

    def gen(k):
        return torch.Generator(device=device).manual_seed(k)

    reqs, prompts = _mix_prompts("uniform")
    worst = max(pl + mn for pl, mn in reqs) + SERVE_GAMMA + 1
    paged = PagedEngine(bd, pd, bt, pt, batch_rows=ROWS, num_blocks=BLOCKS, page=PAGE,
                        max_pages_per_req=-(-worst // PAGE), max_new_cap=max(mn for _, mn in reqs),
                        gamma=SERVE_GAMMA, eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9,
                        prompt_bucket=64, steps_per_sync=SYNC, kv_quant=True, mesh=mesh,
                        device=device)
    slots = ContinuousBatchingEngine(
        bd, pd, dataclasses.replace(bt, kv_quant=True), pt, num_slots=SLOTS,
        max_total_len=SLOT_LEN, max_new_cap=SLOT_NEW, gamma=SERVE_GAMMA, eos_token_id=2,
        temperature=1.0, top_k=20, top_p=0.9, steps_per_sync=SYNC, mesh=mesh, device=device)
    # warm-up (untimed): first launches, the allocator, the engines' waves
    speculative_generate(bd, pd, bt, pt, prompt, 16, gamma=GAMMA, generator=gen(0), **kw)
    autoregressive_generate(bt, pt, prompt, 4, generator=gen(0), **kw)
    paged.warmup(prompt_lens=(64,))
    slots.warmup(prompt_len=64)
    lap("engines built and warmed up")

    reset_launches()
    sp_out, sp = speculative_generate(bd, pd, bt, pt, prompt, 128, gamma=GAMMA, generator=gen(1),
                                      details=True, **kw)
    ar_out, ar = autoregressive_generate(bt, pt, prompt, TP_AR_NEW, generator=gen(1), details=True,
                                         **kw)
    seg = {"single_stream": read_launches()}
    lap("spec and AR")
    out.update(spec_out=sp_out, ar_out=ar_out, spec_tok_s=sp["tokens_per_s"],
               ar_tok_s=ar["tokens_per_s"], acc_rate=sp["acc_rate"],
               acc_len=float(np.mean(sp["acc_len"])))

    drv = PagedMultiHostDriver(paged, prompt_cap=64, batch_cap=8)
    if drv.is_primary:
        for p, (_, mn) in zip(prompts, reqs):
            drv.submit(p, mn)
    t0 = time.perf_counter()
    drv.run_until_idle()
    wall = time.perf_counter() - t0
    comps = [drv.result(i) for i in range(len(reqs))]
    seg["paged"] = read_launches()
    lap("paged driver")
    out["paged"] = dict(wall_s=wall, outs=[c.output_ids for c in comps],
                        acc_rate=float(np.mean([c.details["acc_rate"] for c in comps])),
                        free=paged.allocator.available_blocks == BLOCKS and not paged.num_active)

    srng = np.random.default_rng(0)
    sprompts = [srng.integers(100, 31000, 64).astype(np.int32) for _ in range(TP_SLOT_N)]
    drv2 = MultiHostDriver(slots, prompt_cap=64)
    if drv2.is_primary:
        for p in sprompts:
            drv2.submit(p, SLOT_NEW)
    t0 = time.perf_counter()
    drv2.run_until_idle()
    wall = time.perf_counter() - t0
    rids = sorted(slots.completions)
    comps = [drv2.result(i) for i in rids]
    seg["slotted"] = read_launches()
    lap("slotted driver")
    out["slotted"] = dict(wall_s=wall, rids=rids, outs=[c.output_ids for c in comps],
                          prompts=sprompts,
                          acc_rate=float(np.mean([c.details["acc_rate"] for c in comps])))
    prev = {k: 0 for k in seg["single_stream"]}
    out["segments"] = {}
    for name, total in seg.items():  # counts a segment (the counters run on)
        out["segments"][name] = {k: total[k] - prev[k] for k in total}
        prev = total
    out["launches"] = seg["slotted"]
    return out


def phase_tp(results):
    """Tensor parallelism at tp=2 on the 13B-int8 pair, driven through
    ``parallel/launch.py``: two gloo ranks share cuda:0 (NCCL refuses two
    ranks on one device), so every number here is one card's work split
    over two processes plus gloo's host transport: not TP speed, which
    needs two cards. Checks: the gathered tp=2 logits within 3e-2 of the
    unsharded forward's (``_hold_logits``), the distributed top-k's ids and
    probs equal to the dense sparse path's, tokens and completions
    identical on both ranks, every output well formed, acc_rate >= 0.6, B1,
    B2 and B3 launched on the path (B2 not on the paged segment, B3 not on
    the others) and the same launches on both ranks."""
    from llmspeculativesampling_tpu_torch.parallel.launch import launch

    card = card_line()
    t0 = time.perf_counter()
    r0, r1 = launch("chip_smoke:tp_rank", TP, device="cuda", timeout_s=TP_LIMIT_S)
    log(f"[tp] two ranks on cuda:0 over gloo ran in {time.perf_counter() - t0:.1f} s; pair build "
        f"and shard {r0['build_s']:.1f} / {r1['build_s']:.1f} s, {r0['shard_gib']:.2f} / "
        f"{r1['shard_gib']:.2f} GiB allocated after a rank's shard ({card})")
    for tag, g, r in zip(("prefill 64", "verify 25"), r0["tp"], r0["whole"]):
        _hold_logits(f"[tp] tp=2 gathered vs unsharded {tag}", g, r)
    dev = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(r0["tp"], r0["whole"])]
    if not all(torch.equal(a, b) for a, b in zip(r0["tp"], r1["tp"])):
        raise AssertionError("[tp] the ranks' gathered logits differ")
    if not (r0["topk_equal"] and r1["topk_equal"]):
        raise AssertionError("[tp] norm_logits_topk_tp differs from norm_logits_topk")
    log("[tp] norm_logits_topk_tp == norm_logits_topk (ids and probs) on the gathered verify "
        "logits, both ranks")
    for key in ("spec_out", "ar_out"):
        if not np.array_equal(r0[key], r1[key]):
            raise AssertionError(f"[tp] {key}: the ranks' tokens differ")
    prompt = np.asarray(np.random.default_rng(0).integers(100, 31000, 64))
    for key, cap in (("spec_out", 128 + GAMMA), ("ar_out", TP_AR_NEW)):
        out, n = r0[key], 128 if key == "spec_out" else TP_AR_NEW
        new = out[64:]
        if not (np.array_equal(out[:64], prompt) and 1 <= len(new) <= cap
                and (len(new) >= n or new[-1] == 2) and new.min() >= 0 and new.max() < VOCAB):
            raise AssertionError(f"[tp] {key}: bad output of length {len(out)}")
    if r0["acc_rate"] < 0.6:
        raise AssertionError(f"[tp] acceptance {r0['acc_rate']:.3f} < 0.6: a kernel is likely wrong")
    log(f"[tp] spec gamma={GAMMA} 128 tokens {r0['spec_tok_s']:.2f} tok/s, acc_rate "
        f"{r0['acc_rate']:.4f}, mean acc_len {r0['acc_len']:.3f}; AR {TP_AR_NEW} tokens "
        f"{r0['ar_tok_s']:.2f} tok/s: one card over gloo, not TP speed ({card})")
    log(f"[tp] gloo all_reduce, fp32, host ms a call: "
        + ", ".join(f"{k} {v:.4f}" for k, v in r0["all_reduce_ms"].items()) + f" ({card})")
    reqs, prompts = _mix_prompts("uniform")
    p0, p1 = r0["paged"], r1["paged"]
    if not all(np.array_equal(a, b) for a, b in zip(p0["outs"], p1["outs"])):
        raise AssertionError("[tp] paged: the ranks' completions differ")
    tokens = _check_outputs("tp paged", reqs, prompts, p0["outs"], VOCAB)
    if not (p0["free"] and p1["free"]):
        raise AssertionError("[tp] paged: the pool did not end fully free")
    s0, s1 = r0["slotted"], r1["slotted"]
    if s0["rids"] != s1["rids"] or not all(np.array_equal(a, b) for a, b in zip(s0["outs"], s1["outs"])):
        raise AssertionError("[tp] slotted: the ranks' completions differ")
    stokens = _check_outputs("tp slotted", [(64, SLOT_NEW)] * TP_SLOT_N, s0["prompts"], s0["outs"],
                             VOCAB)
    for tag, r, toks in (("paged", p0, tokens), ("slotted", s0, stokens)):
        log(f"[tp {tag}] {toks} generated tokens in {r['wall_s']:.2f} s: {toks / r['wall_s']:.2f} "
            f"tok/s aggregate, acc_rate {r['acc_rate']:.4f}: one card over gloo ({card})")
        if r["acc_rate"] < 0.6:
            raise AssertionError(f"[tp {tag}] acceptance {r['acc_rate']:.3f} < 0.6")
    if r0["segments"] != r1["segments"]:
        raise AssertionError(f"[tp] the ranks launched differently: {r0['segments']} / "
                             f"{r1['segments']}")
    seg = r0["segments"]
    log(f"[tp] launches a rank: {seg}")
    if any(r0["launches"][k] <= 0 for k in r0["launches"]):
        raise AssertionError(f"[tp] a kernel was not launched on the tp path: {r0['launches']}")
    if seg["paged"]["flash_decode"] or seg["single_stream"]["paged_flash_decode"] or \
            seg["slotted"]["paged_flash_decode"]:
        raise AssertionError(f"[tp] B2 ran on the paged segment or B3 off it: {seg}")
    results["launches"]["tp"] = r0["launches"]
    results["tp"] = dict(spec_tok_s=r0["spec_tok_s"], ar_tok_s=r0["ar_tok_s"],
                         acc_rate=r0["acc_rate"], logits_dev=dev,
                         all_reduce_ms=r0["all_reduce_ms"],
                         paged_tok_s=tokens / p0["wall_s"], slotted_tok_s=stokens / s0["wall_s"])


def _dp_verify_logits(bt, pt, mesh) -> tuple:
    """This dp rank's 8 rows through a paged int8 pool of 16 blocks, with
    shard-local block ids (B1 at M = 72, B3 at B = 8): a 64-token prefill,
    then a verify window of 9, whose logits it returns; rank 0 also all 16
    rows at dp 1 over 32 blocks (M = 144). Returns (mine, whole or None)."""
    import dataclasses

    from llmspeculativesampling_tpu_torch.cache.paged import init_paged_cache

    cfg = bt.cfg
    rng = np.random.default_rng(5)
    pre = torch.as_tensor(rng.integers(100, 31000, (ROWS, 64)), device="cuda")
    ver = torch.as_tensor(rng.integers(100, 31000, (ROWS, SERVE_GAMMA + 1)), device="cuda")

    def run(rows, n_blocks):
        cache = init_paged_cache(cfg.num_layers, n_blocks, cfg.num_kv_heads, PAGE, cfg.head_dim,
                                 len(rows), DP_PAGES, quant=True, device="cuda")
        # a page a row, counted down from the pool's last block
        cache.block_tables[:, 0] = torch.arange(n_blocks - 1, n_blocks - 1 - len(rows), -1)
        _, cache = bt.forward(pt, cfg, pre[rows], cache, paged_prefill=True)
        cache = dataclasses.replace(cache, lengths=torch.full((len(rows),), 64, dtype=torch.int32,
                                                              device="cuda"))
        logits, _ = bt.forward(pt, cfg, ver[rows], cache)
        return logits.float().cpu()

    d = mesh.dp_rank
    mine = run(list(range(d * DP_ROWS, (d + 1) * DP_ROWS)), DP_BLOCKS)
    return mine, run(list(range(ROWS)), BLOCKS) if mesh.rank == 0 else None


def dp_rank(mode: str) -> dict:
    """One rank of the data-parallel path (run by ``phase_dp`` through
    ``parallel/launch.py``, ranks on cuda:0 over gloo). ``"dp"``: a dp=2 x
    tp=1 mesh of two ranks, each building the whole 13B-int8 pair from seed
    0 (params are replicated over dp), one after the other; its 8 rows'
    paged verify logits (rank 0 also all 16 at dp 1); then, each after
    ``warmup()`` and with launches counted from here,
    ``PagedMultiHostDriver`` over ``PagedEngine(mesh=)`` (16 rows, 32 int8
    blocks of 128: 8 rows and 16 blocks a rank) on the uniform mix and
    ``MultiHostDriver`` over ``ContinuousBatchingEngine(mesh=)`` (16 slots
    x 256: 8 a rank) on 25 x (64, 64). ``"dp_tp"``: dp=2 x tp=2 on four
    ranks, each keeping its tp shard, the paged driver on 16 x (64, 32).
    Before every chunk the rank reads its device tables: the largest block
    id it holds must lie in its 16-block half. Returns numpy, CPU tensors
    and numbers."""
    import dataclasses

    import torch.distributed as dist

    from llmspeculativesampling_tpu_torch.core.config import synchronize
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8_small_draft
    from llmspeculativesampling_tpu_torch.parallel.distributed import host_fetch
    from llmspeculativesampling_tpu_torch.parallel.sharding import make_mesh, param_specs, shard_params
    from llmspeculativesampling_tpu_torch.serve.multihost import MultiHostDriver, PagedMultiHostDriver
    from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine
    from llmspeculativesampling_tpu_torch.serve.scheduler import ContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda"
    mesh = make_mesh(DP, TP if mode == "dp_tp" else 1)
    rank = dist.get_rank()
    out = {"rank": rank, "coords": mesh.coords, "seconds": {}}
    clock = [time.perf_counter()]

    def lap(name):
        synchronize(torch.device(device))
        now = time.perf_counter()
        out["seconds"][name] = now - clock[0]
        clock[0] = now
        if rank == 0:
            log(f"[{mode} rank 0] {name} {out['seconds'][name]:.1f} s")
    for r in range(mesh.size):  # one whole pair (13.3 GB) built at a time
        if r == rank:
            bd, pd, bt, pt = synthetic_pair_int8_small_draft(device=device)
            if mesh.tp > 1:
                pd = shard_params(pd, param_specs("llama", bd.cfg), mesh)
                pt = shard_params(pt, param_specs("llama", bt.cfg), mesh)
                gc.collect()
                torch.cuda.empty_cache()
            out["gib"] = torch.cuda.memory_allocated() / 2 ** 30
        dist.barrier()
    lap("build, one rank after the other")
    if mode == "dp":
        out["logits"] = _dp_verify_logits(bt, pt, mesh)
        lap("verify logits")

    reqs, prompts = _mix_prompts("uniform")
    if mode == "dp_tp":
        reqs, prompts = DP_TP_REQS, [p[:pl] for p, (pl, _) in zip(prompts, DP_TP_REQS)]
    paged = PagedEngine(bd, pd, bt, pt, batch_rows=ROWS, num_blocks=BLOCKS, page=PAGE,
                        max_pages_per_req=DP_PAGES, max_new_cap=max(mn for _, mn in reqs),
                        gamma=SERVE_GAMMA, eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9,
                        prompt_bucket=64, steps_per_sync=SYNC, kv_quant=True, mesh=mesh,
                        device=device)
    held = []
    dispatch = paged._dispatch_chunk

    def checked():  # the block ids this rank's device tables hold
        for c in (paged.state.draft_cache, paged.state.target_cache):
            t = c.block_tables
            held.append(int(torch.where(t == c.num_blocks, -1, t).max()))
        return dispatch()

    paged._dispatch_chunk = checked
    paged.warmup(prompt_lens=(64,))
    if mode == "dp":
        slots = ContinuousBatchingEngine(
            bd, pd, dataclasses.replace(bt, kv_quant=True), pt, num_slots=SLOTS,
            max_total_len=SLOT_LEN, max_new_cap=SLOT_NEW, gamma=SERVE_GAMMA, eos_token_id=2,
            temperature=1.0, top_k=20, top_p=0.9, steps_per_sync=SYNC, mesh=mesh, device=device)
        slots.warmup(prompt_len=64)
    lap("engines built and warmed up")

    reset_launches()
    drv = PagedMultiHostDriver(paged, prompt_cap=64, batch_cap=ROWS)
    if drv.is_primary:
        for p, (_, mn) in zip(prompts, reqs):
            drv.submit(p, mn)
    t0 = time.perf_counter()
    drv.run_until_idle()
    wall = time.perf_counter() - t0
    comps = [drv.result(i) for i in range(len(reqs))]
    segments = {"paged": read_launches()}
    lap("paged driver")
    out["paged"] = dict(
        wall_s=wall, outs=[c.output_ids for c in comps], prompts=prompts, reqs=reqs,
        acc_rate=float(np.mean([c.details["acc_rate"] for c in comps])),
        ttft_p50=_pct([c.details["ttft_s"] for c in comps], 50),
        free=[a.available_blocks == a.num_blocks == DP_BLOCKS for a in paged._allocs],
        pool_blocks=paged.state.target_cache.num_blocks, max_block=max(held),
        rows=host_fetch(paged.state.tokens))
    if mode == "dp":
        reset_launches()
        srng = np.random.default_rng(0)
        sprompts = [srng.integers(100, 31000, 64).astype(np.int32) for _ in range(DP_SLOT_N)]
        drv2 = MultiHostDriver(slots, prompt_cap=64)
        if drv2.is_primary:
            for p in sprompts:
                drv2.submit(p, SLOT_NEW)
        t0 = time.perf_counter()
        drv2.run_until_idle()
        wall = time.perf_counter() - t0
        rids = sorted(slots.completions)
        comps = [drv2.result(i) for i in rids]
        segments["slotted"] = read_launches()
        lap("slotted driver")
        out["slotted"] = dict(
            wall_s=wall, rids=rids, outs=[c.output_ids for c in comps], prompts=sprompts,
            acc_rate=float(np.mean([c.details["acc_rate"] for c in comps])),
            ttft_p50=_pct([c.details["ttft_s"] for c in comps], 50),
            slots_local=slots.state.tokens.shape[0], rows=host_fetch(slots.state.tokens))
    out["segments"] = segments
    return out


def _dp_check_run(tag: str, runs: list, reqs, prompts, card: str) -> int:
    """The checks on one dp run across its ranks: identical completions and
    gathered token rows, well-formed outputs, acc_rate >= 0.6; returns the
    generated tokens and prints tok/s, TTFT p50 and the wall."""
    r0 = runs[0]
    for r in runs[1:]:
        if not all(np.array_equal(a, b) for a, b in zip(r0["outs"], r["outs"])):
            raise AssertionError(f"[{tag}] the ranks' completions differ")
        if not np.array_equal(r0["rows"], r["rows"]):
            raise AssertionError(f"[{tag}] the ranks' gathered token rows differ")
    tokens = _check_outputs(tag, reqs, prompts, r0["outs"], VOCAB)
    if r0["acc_rate"] < 0.6:
        raise AssertionError(f"[{tag}] acceptance {r0['acc_rate']:.3f} < 0.6: a kernel is likely wrong")
    log(f"[{tag}] {tokens} generated tokens in {r0['wall_s']:.2f} s: {tokens / r0['wall_s']:.2f} tok/s "
        f"aggregate, TTFT p50 {r0['ttft_p50']:.4f} s, acc_rate {r0['acc_rate']:.4f}, wall "
        f"{r0['wall_s']:.2f} s: {len(runs)} ranks sharing one card over gloo, not dp speed ({card})")
    return tokens


def phase_dp(results):
    """Data parallelism above 1 on the 13B-int8 pair, driven through
    ``parallel/launch.py`` (``dp_rank``): two ranks at dp=2 x tp=1 and then
    four at dp=2 x tp=2, all on cuda:0 over gloo, so every number here is
    one card's work split over processes plus gloo's host transport, not dp
    speed, which needs a card a replica. Checks: each rank's 8 rows' verify
    logits within 3e-2 of the dp=1 forward over all 16 (``_hold_logits``;
    B1's plan takes its K split from M, so M = 72 and 144 sum in other
    orders); every rank's completions and gathered token rows identical;
    every output well formed; acc_rate >= 0.6; every block id a rank's
    tables hold lies in its 16-block half, whose pool ends fully free; B1
    and B3 launched on every rank's paged run (B2 not), B1 and B2 on the
    slotted run (B3 not)."""
    from llmspeculativesampling_tpu_torch.parallel.launch import launch

    card = card_line()
    t0 = time.perf_counter()
    ranks = launch("chip_smoke:dp_rank", DP, ("dp",), device="cuda", timeout_s=DP_LIMIT_S)
    log(f"[dp] two ranks (dp=2 x tp=1) on cuda:0 over gloo ran in {time.perf_counter() - t0:.1f} s, "
        f"{ranks[0]['gib']:.2f} / {ranks[1]['gib']:.2f} GiB allocated after a rank's pair ({card})")
    whole = ranks[0]["logits"][1]
    for r in ranks:
        d = r["coords"][0]
        _hold_logits(f"[dp] rank {r['rank']}'s 8 rows (M=72, its 16-block pool) vs dp=1 over 16 "
                     f"(M=144, 32 blocks), verify 9", r["logits"][0],
                     whole[d * DP_ROWS:(d + 1) * DP_ROWS])
    t1 = time.perf_counter()
    ranks4 = launch("chip_smoke:dp_rank", DP * TP, ("dp_tp",), device="cuda", timeout_s=DP_LIMIT_S)
    log(f"[dp] four ranks (dp=2 x tp=2) on cuda:0 over gloo ran in {time.perf_counter() - t1:.1f} s "
        f"({card})")
    runs = {"dp paged": [r["paged"] for r in ranks], "dp slotted": [r["slotted"] for r in ranks],
            "dp x tp paged": [r["paged"] for r in ranks4]}
    tok_s = {}
    for tag, rr in runs.items():
        tokens = _dp_check_run(tag, rr, rr[0].get("reqs") or [(64, SLOT_NEW)] * DP_SLOT_N,
                               rr[0]["prompts"], card)
        tok_s[tag] = dict(tok_s=tokens / rr[0]["wall_s"], ttft_p50=rr[0]["ttft_p50"],
                          wall_s=rr[0]["wall_s"], acc_rate=rr[0]["acc_rate"])
    for tag in ("dp paged", "dp x tp paged"):
        for r in runs[tag]:
            if not (all(r["free"]) and r["pool_blocks"] == DP_BLOCKS and r["max_block"] < DP_BLOCKS):
                raise AssertionError(f"[{tag}] a rank's pool: {r['pool_blocks']} blocks, largest id "
                                     f"held {r['max_block']}, shards free {r['free']}")
    log(f"[dp] every rank's tables held block ids below its {DP_BLOCKS}-block half (largest "
        f"{max(r['paged']['max_block'] for r in ranks + ranks4)}), every shard's pool ended free; "
        f"slots a rank {ranks[0]['slotted']['slots_local']}")
    for r in ranks + ranks4:
        seg = r["segments"]
        log(f"[dp] rank {r['rank']} {r['coords']} launches: {seg}")
        p = seg["paged"]
        if not (p["int8_matmul"] > 0 and p["paged_flash_decode"] > 0 and p["flash_decode"] == 0):
            raise AssertionError(f"[dp] rank {r['rank']}'s paged run: B1 and B3 must run, B2 not: {p}")
        if "slotted" in seg:
            q = seg["slotted"]
            if not (q["int8_matmul"] > 0 and q["flash_decode"] > 0 and q["paged_flash_decode"] == 0):
                raise AssertionError(f"[dp] rank {r['rank']}'s slotted run: B1 and B2 must run, B3 "
                                     f"not: {q}")
    seg = ranks[0]["segments"]
    results["launches"]["dp"] = {k: seg["paged"][k] + seg["slotted"][k] for k in seg["paged"]}
    results["dp"] = dict(runs=tok_s, seconds=[r["seconds"] for r in ranks + ranks4])


def phase_opt_path(results, reps: int):
    """The OPT path at full width: ``synthetic_opt_pair_int8_small_draft``
    (OPT-13B int8 target, 640-wide 2-layer draft, tied bf16 heads) born on
    the card, with scripts/bench_opt13b.py's settings (64-token prompt,
    top_k 20, top_p 0.9, eos 2): AR and speculative decoding at gamma 8 with
    128 new tokens, beam v2 (4 beams, gamma 4, 64 new tokens), one warm-up
    and ``reps`` timed runs each, then the uniform serving mix through
    ``PagedEngine`` behind ``BatchedInferenceServer``. Every target forward
    of the contiguous paths must run B2 in each of its 40 layers, B3 never;
    the paged path never runs B2."""
    from llmspeculativesampling_tpu_torch import (
        autoregressive_generate, beam_speculative_v2_generate, speculative_generate,
        synthetic_opt_pair_int8_small_draft)

    t_phase = time.perf_counter()
    card = card_line()
    pair = synthetic_opt_pair_int8_small_draft(device="cuda")
    torch.cuda.synchronize()
    log(f"[opt] OPT-13B int8 target + 640x2 draft born on the card in "
        f"{time.perf_counter() - t_phase:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated ({card})")
    bd, pd, bt, pt = pair
    vocab, n_layers = bt.cfg.vocab_size, bt.cfg.num_layers
    prompt = list(np.random.default_rng(0).integers(100, 50000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, details=True, device="cuda")
    engines = {  # name -> (run, fewest and most new tokens a run returns unless EOS ends it)
        "ar": (lambda gen: autoregressive_generate(bt, pt, prompt, 128, generator=gen, **kw),
               128, 128),
        "spec": (lambda gen: speculative_generate(bd, pd, bt, pt, prompt, 128, gamma=OPT_GAMMA,
                                                  generator=gen, **kw), 128, 128 + OPT_GAMMA),
        # the tree loop checks its budget before a step, which adds up to gamma+1 tokens
        "beam_v2": (lambda gen: beam_speculative_v2_generate(
            bd, pd, bt, pt, prompt, TREE_NEW, gamma=TREE_GAMMA, num_beams=TREE_BEAMS,
            extra_sample_cnt=1, expect_thres=0.7, generator=gen, **kw), 1, TREE_NEW + TREE_GAMMA),
    }
    out_res, total = {}, {}
    for name, (run, least, cap) in engines.items():
        run(torch.Generator(device="cuda").manual_seed(0))  # warm-up, phase-split calibration
        torch.cuda.synchronize()
        reset_launches()
        ds, target_forwards = [], 0
        for k in range(1, reps + 1):
            out, d = run(torch.Generator(device="cuda").manual_seed(k))
            ds.append(d)
            gen_ids = out[64:]
            if not (np.array_equal(out[:64], np.asarray(prompt)) and 1 <= len(gen_ids) <= cap
                    and (len(gen_ids) >= least or gen_ids[-1] == 2)
                    and gen_ids.min() >= 0 and gen_ids.max() < vocab):
                raise AssertionError(f"opt {name}: bad output of length {len(out)}")
            # short-block target forwards: AR's decode steps, a verify a step
            target_forwards += len(gen_ids) - 1 if name == "ar" else d["target_call_times"]
        launches = read_launches()
        rates = [d["tokens_per_s"] for d in ds]
        line = (f"[opt {name}] tok/s median {np.median(rates):.2f} min {min(rates):.2f} max "
                f"{max(rates):.2f} over {reps} reps; {target_forwards} short-block target "
                f"forwards; launches {launches}")
        res = dict(tok_s=float(np.median(rates)), launches=launches)
        if name != "ar":
            acc = float(np.mean([d["acc_rate"] for d in ds]))
            acc_len = float(np.mean([np.mean(d["acc_len"]) for d in ds]))
            steps = [d["target_call_times"] for d in ds]
            line += f"; acc_rate {acc:.4f}, mean acc_len {acc_len:.3f}, steps per rep {steps}"
            res.update(acc_rate=acc, acc_len=acc_len, steps=steps)
        log(f"{line} ({card})")
        if launches["int8_matmul"] <= 0 or launches["paged_flash_decode"] != 0:
            raise AssertionError(f"opt {name}: B1 did not run, or B3 ran")
        if launches["flash_decode"] < n_layers * target_forwards:
            raise AssertionError(f"opt {name}: {launches['flash_decode']} B2 launches for "
                                 f"{target_forwards} target forwards of {n_layers} layers")
        if name == "spec" and res["acc_rate"] < 0.6:
            raise AssertionError(f"opt spec: acceptance {res['acc_rate']:.3f} < 0.6")
        if name == "beam_v2" and res["acc_len"] <= 1.0:
            raise AssertionError(f"opt beam_v2: mean acc_len {res['acc_len']:.3f} <= 1")
        out_res[name] = res
        for kname, n in launches.items():
            total[kname] = total.get(kname, 0) + n
    log(f"[opt] spec gamma={OPT_GAMMA} speedup over AR "
        f"{out_res['spec']['tok_s'] / out_res['ar']['tok_s']:.3f}x ({card})")
    serve = _serve_mix("uniform", pair)
    for kname, n in serve["launches"].items():
        total[kname] += n
    out_res["serving_uniform"] = serve
    # the admission prefill's B1 calls and dense head are planned batch-invariant
    phase_burst_trickle(results, pair, tag="opt_burst_trickle")
    release_graphs()
    del pair, bd, pd, bt, pt, engines
    gc.collect()
    torch.cuda.empty_cache()
    elapsed = time.perf_counter() - t_phase
    log(f"[opt] phase took {elapsed:.1f} s")
    results["opt"] = dict(engines=out_res, seconds=elapsed)
    results["launches"]["opt"] = total


def phase_harness(results):
    """The evaluation harness through its entry point
    (``evalx.harness.main``) on the card, at its own synthetic pair (full
    width: Llama 2048 x 16, vocab 32000, bf16): every method over 2 synthetic
    prompts of 64 tokens, 64 new tokens each, with the target-logprob score;
    then the speculative block under ``--profile_dir``; then autoregressive
    blocks, doubling the prompts until one's engines run over 2 s. Every block
    must make tokens and carry JAX's result keys, B2 must launch and B3 not,
    the profiler must write a trace, and the long block must report energy
    > 0 from nvidia-smi."""
    import tempfile

    from llmspeculativesampling_tpu_torch.evalx import harness
    from llmspeculativesampling_tpu_torch.utils.power import PowerMonitor

    card = card_line()
    source = PowerMonitor().source
    if source != "nvidia-smi":
        raise AssertionError(f"harness: the power source is {source}, not nvidia-smi")
    reset_launches()
    blocks = harness.main(HARNESS_ARGS + ["--methods", "all", "--score"])
    if [r["method"] for r in blocks] != list(harness.ALL_METHODS):
        raise AssertionError(f"harness: blocks {[r['method'] for r in blocks]}")
    with tempfile.TemporaryDirectory() as tmp:
        traced = harness.main(HARNESS_ARGS + ["--methods", "speculative", "--profile_dir", tmp])
        traces = [os.path.join(d, f) for d, _, fs in os.walk(tmp) for f in fs if f.endswith(".json")]
        trace_mb = sum(os.path.getsize(f) for f in traces) / 1e6
    if not traces:
        raise AssertionError("harness: --profile_dir wrote no trace")
    n = 4
    for _ in range(6):
        long_block = harness.main(["--dataset", "synthetic", "--methods", "autoregressive",
                                   "--num_prompts", str(n), "--max_tokens", "128"])[0]
        if long_block["total_time_s"] > 2.0:
            break
        n *= 2
    launches = read_launches()
    for r in blocks + traced + [long_block]:
        want = HARNESS_KEYS | ({"prob_score"} if r in blocks else set())
        if set(r) != want:
            raise AssertionError(f"harness {r['method']}: keys {sorted(set(r) ^ want)} differ")
        if not (r["total_tokens"] >= r["prompts"] > 0 and r["tokens_per_s"] > 0):
            raise AssertionError(f"harness {r['method']}: made no tokens: {r}")
        if "prob_score" in r and not math.isfinite(r["prob_score"]):
            raise AssertionError(f"harness {r['method']}: score {r['prob_score']}")
    if long_block["total_time_s"] <= 2.0 or not long_block["energy_j"] > 0:
        raise AssertionError(f"harness: no energy from a block over 2 s: {long_block}")
    if launches["flash_decode"] <= 0 or launches["paged_flash_decode"] != 0:
        raise AssertionError(f"harness: B2 did not run, or B3 ran: {launches}")
    for r in blocks + traced + [long_block]:
        log(f"[harness] {r['method']}: {r['prompts']} prompts, {r['total_tokens']} tokens, tok/s "
            f"{r['tokens_per_s']}, acc_rate {r['acc_rate']}, mean acc_len {r['mean_acc_len']}, "
            f"energy_j {r['energy_j']}, prob_score {r.get('prob_score')} ({card})")
    log(f"[harness] --profile_dir: {len(traces)} Chrome trace(s), {trace_mb:.1f} MB; power from "
        f"{source}: {long_block['energy_j']} J over {long_block['total_time_s']} s of engine time; "
        f"launches on the harness path {launches}")
    results["harness"] = {r["method"]: r for r in blocks}
    results["launches"]["harness"] = launches


def phase_trained_pair(results):
    """The port's first trained pair: ``train_tiny_pair()`` at the JAX
    module's defaults on the card, then the gates of
    tests/test_trained_pair.py: both losses below 0.75x their start; over 6
    prompts x 48 new tokens at gamma 4 the trained draft's acc_rate >= 0.55,
    an untrained draft's <= 0.20; the int8 target (B1) within 0.15 of the
    fp32 target's acc_rate and its outputs within 0.35 of their get_score.
    Prints get_score of spec minus AR over 16 prompts; holds one forward of
    the card-trained target against the same params on the CPU (fp32:
    1e-4 relative); B2 and B1 must refuse to run under grad."""
    from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate
    from llmspeculativesampling_tpu_torch.engine.speculative import speculative_generate
    from llmspeculativesampling_tpu_torch.evalx.metrics import get_score
    from llmspeculativesampling_tpu_torch.models import llama
    from llmspeculativesampling_tpu_torch.quant.core import quantize_params
    from llmspeculativesampling_tpu_torch.train import pinned_corpus, train_tiny_pair

    card = card_line()
    corpus = pinned_corpus()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bd, pd, bt, pt, info = train_tiny_pair()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = info["target_loss"][-1][0] + info["draft_loss"][-1][0] + 2
    log(f"[trained] train_tiny_pair(): {steps} steps of 16 x 128 bytes in {train_s:.2f} s, "
        f"{1e3 * train_s / steps:.2f} ms a step (256x4 target and 128x2 draft together); target "
        f"loss {info['target_loss']}, draft loss {info['draft_loss']} ({card})")
    for key in ("target_loss", "draft_loss"):
        (_, l0), (_, l1) = info[key][0], info[key][-1]
        if not l1 < 0.75 * l0:
            raise AssertionError(f"trained: {key} fell from {l0} to {l1} only")
    kw = dict(gamma=TRAINED_GAMMA, eos_token_id=-1, temperature=1.0, top_k=20, top_p=0.9,
              details=True, device="cuda")

    def spec(draft, target, prompts, seed0=0):
        accs, outs = [], []
        for i, p in enumerate(prompts):
            out, d = speculative_generate(bd, draft, bt, target, p, TRAINED_NEW,
                                          generator=torch.Generator(device="cuda").manual_seed(
                                              seed0 + i), **kw)
            accs.append(d["acc_rate"])
            outs.append((out, len(p)))
        return float(np.mean(accs)), outs

    def windows(seed, n):
        rng = np.random.default_rng(seed)
        return [corpus[o:o + TRAINED_PROMPT].astype(np.int32)
                for o in rng.integers(0, corpus.size - TRAINED_PROMPT - 8, n)]

    prompts = windows(0, 6)
    reset_launches()
    acc_fp, outs_fp = spec(pd, pt, prompts)
    untrained = llama.init_params(bd.cfg, torch.Generator(device="cuda").manual_seed(999),
                                  device="cuda")
    acc_untrained, _ = spec(untrained, pt, prompts)
    deltas = []
    for i, p in enumerate(windows(42, 16)):
        out = spec(pd, pt, [p], seed0=i)[1][0][0]
        ar = autoregressive_generate(bt, pt, p, TRAINED_NEW, eos_token_id=-1, top_k=20, top_p=0.9,
                                     generator=torch.Generator(device="cuda").manual_seed(100 + i),
                                     device="cuda")
        deltas.append(get_score(bt, pt, out, TRAINED_PROMPT) - get_score(bt, pt, ar, TRAINED_PROMPT))
    b1_before = read_launches()["int8_matmul"]
    qt = quantize_params(pt, "llama")
    acc_q, outs_q = spec(pd, qt, prompts)
    launches = read_launches()
    b1_int8 = launches["int8_matmul"] - b1_before
    s_fp = float(np.mean([get_score(bt, pt, o, pl) for o, pl in outs_fp]))
    s_q = float(np.mean([get_score(bt, pt, o, pl) for o, pl in outs_q]))
    deltas = np.asarray(deltas)
    log(f"[trained] acc_rate over 6 prompts x {TRAINED_NEW} tokens at gamma {TRAINED_GAMMA}: "
        f"trained draft {acc_fp:.4f}, untrained {acc_untrained:.4f}; int8 target {acc_q:.4f} "
        f"({b1_int8} B1 launches); get_score of the fp32 target's outputs {s_fp:.4f}, the int8 "
        f"target's {s_q:.4f} (delta {s_q - s_fp:+.4f}); get_score spec - AR over 16 prompts: "
        f"mean {deltas.mean():+.4f}, sd {deltas.std(ddof=1):.4f}, se "
        f"{deltas.std(ddof=1) / 4:.4f}; launches {launches} ({card})")
    if not (acc_fp >= 0.55 and acc_untrained <= 0.20 and acc_fp > acc_untrained + 0.30):
        raise AssertionError(f"trained: acc_rate {acc_fp:.4f} trained, {acc_untrained:.4f} untrained")
    if not (abs(acc_q - acc_fp) < 0.15 and abs(s_q - s_fp) < 0.35):
        raise AssertionError(f"trained: int8 target moved acc_rate {acc_fp:.4f} -> {acc_q:.4f} or "
                             f"score {s_fp:.4f} -> {s_q:.4f}")
    if b1_int8 <= 0 or launches["flash_decode"] <= 0 or launches["paged_flash_decode"] != 0:
        raise AssertionError(f"trained: B1 or B2 did not run, or B3 ran: {launches}")

    # one forward of the card-trained target: a 128-byte prefill (the einsum
    # path) and a 5-byte verify (B2), against the same params on the CPU
    block = torch.as_tensor(corpus[:128 + TRAINED_GAMMA + 1].astype(np.int64))[None]
    outs = {}
    for dev, params in (("cuda", pt), ("cpu", _to_cpu(pt))):
        cache = bt.make_cache(1, 256, device=dev)
        l0, cache = bt.forward(params, bt.cfg, block[:, :128].to(dev), cache)
        l1, _ = bt.forward(params, bt.cfg, block[:, 128:].to(dev), cache)
        outs[dev] = [t.float().cpu() for t in (l0, l1)]
    for name, g, r in zip(("prefill 128", "verify 5"), outs["cuda"], outs["cpu"]):
        _hold_logits(f"[trained] fp32 target {name}", g, r, rel_tol=1e-4)

    # the kernels have no backward pass: under grad they raise
    grad_t = {k: (v.clone().requires_grad_() if k == "embed" else v) for k, v in pt.items()}
    grad_q = {k: (v.clone().requires_grad_() if k == "embed" else v) for k, v in qt.items()}
    for name, params, n_tok in (("B2", grad_t, 16), ("B1", grad_q, 64)):
        try:
            bt.forward(params, bt.cfg, block[:, :n_tok].cuda(), bt.make_cache(1, 128, device="cuda"))
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            log(f"[trained] {name} under grad raises: {e}")
        else:
            raise AssertionError(f"trained: {name} ran under grad with an input requiring grad")
    results["trained_pair"] = dict(train_ms_a_step=1e3 * train_s / steps, acc_rate=acc_fp,
                                   acc_untrained=acc_untrained, acc_int8=acc_q,
                                   score_delta_int8=s_q - s_fp, spec_minus_ar=float(deltas.mean()))
    results["launches"]["trained_pair"] = launches


# ---------------------------------------------------------------- Mellum 2
MELLUM_CONFIG = "benchmarks/configs/mellum2_12b_int8_pair.json"
MELLUM_H, MELLUM_F, MELLUM_E, MELLUM_K = 2304, 896, 64, 8  # hidden, expert width, experts, top-k
MELLUM_HKV, MELLUM_G, MELLUM_WINDOW, MELLUM_PAGES = 4, 8, 1024, 23
MELLUM_TOKENS = (320, 2048)  # the cell's verify (64 rows x 5) and a 2,048-token prefill
MELLUM_PROMPTS = (576, 1100, 1500, 2000, 640, 1216, 1792, 960)  # the main path's 8 requests
MELLUM_NEW, MELLUM_GAMMA = 48, 4  # new tokens a request; the cell's gamma


def _b4_case(tokens: int) -> dict:
    """B4 at ``tokens`` x top-8 over Mellum's 64 experts: the alignment (its
    live tiles, tile experts, totals and each pair's slot) and both products
    (gate/up 2304 -> 1792 in bf16, down 896 -> 2304 in fp32) against the
    plain versions on the same inputs; their times against the least time
    of the touched experts' bytes, the rows in and out and the FLOPs."""
    from llmspeculativesampling_tpu_torch.kernels import moe_matmul

    h, f, e, k = MELLUM_H, MELLUM_F, MELLUM_E, MELLUM_K
    gen = torch.Generator(device="cuda").manual_seed(tokens)
    ids = torch.argsort(torch.rand((tokens, e), generator=gen, device="cuda"), dim=-1)[:, :k]
    x = torch.randn((tokens, h), generator=gen, device="cuda").to(torch.bfloat16)

    def experts(kk, n):
        q = torch.randint(-127, 128, (e, kk, n), generator=gen, dtype=torch.int8, device="cuda")
        sc = (0.8 + 0.4 * torch.rand((e, n), generator=gen, device="cuda")) / (73 * math.sqrt(kk))
        return q, sc

    wgu, sgu = experts(h, 2 * f)
    wdn, sdn = experts(f, h)
    mt = moe_matmul.row_tile(tokens * k, e)
    totals = torch.zeros(e, dtype=torch.int64, device="cuda")
    r = moe_matmul.expert_align(ids, e, mt, totals)
    r_ref = moe_matmul.expert_align_ref(ids.cpu(), e, mt)
    slots = r.inv.long().cpu()
    if (int(r.live) != int(r_ref.live) or not torch.equal(r.tile_expert.cpu(), r_ref.tile_expert)
            or not torch.equal(totals.cpu(), torch.bincount(ids.reshape(-1).cpu(), minlength=e))
            or not torch.equal(torch.sort(slots).values, torch.sort(r_ref.inv.long()).values)
            or not torch.equal(r.rows.cpu()[slots], (torch.arange(tokens * k) // k).int())):
        raise AssertionError(f"b4 tokens={tokens}: the alignment differs from the plain one")
    cpu_r = r._replace(tile_expert=r.tile_expert.cpu(), live=r.live.cpu())
    live = int(r.live) * mt
    xs = x.index_select(0, r.rows)
    gu = moe_matmul.grouped_int8_matmul(xs, wgu, sgu, r)
    act = torch.nn.functional.silu(gu[:, :f].float()).to(torch.bfloat16) * gu[:, f:]
    touched = int((torch.bincount(ids.reshape(-1), minlength=e) > 0).sum())
    pairs = tokens * k
    out = {"tokens": tokens, "mt": mt, "live_tiles": int(r.live), "touched": touched}
    for name, xin, w, sc, kk, n, od in (("gate_up", xs, wgu, sgu, h, 2 * f, None),
                                        ("down", act, wdn, sdn, f, h, torch.float32)):
        got = moe_matmul.grouped_int8_matmul(xin, w, sc, r, out_dtype=od)
        t0 = time.perf_counter()
        ref = moe_matmul.grouped_int8_matmul_ref(xin.cpu(), w.cpu(), sc.cpu(), cpu_r, od)
        plain = (time.perf_counter() - t0) * 1e3
        peak = float(ref[:live].abs().max())
        # the same fp32 sums of exact products in another order; bf16 output
        # rounds once (1 ulp = 2**-8 relative), fp32 keeps the sums
        rtol = 2.0 ** -7 if od is None else 1e-5
        max_abs, _ = check_close(f"b4 {name} tokens={tokens}", got.cpu()[:live], ref[:live],
                                 rtol, rtol * peak)
        ms = time_ms(lambda i, xin=xin, w=w, sc=sc, od=od: moe_matmul.grouped_int8_matmul(
            xin, w, sc, r, out_dtype=od), 10)
        nbytes = touched * (kk * n + 4 * n) + pairs * kk * 2 + pairs * n * (4 if od else 2)
        b_ms, by = bound(nbytes, 2.0 * pairs * kk * n)
        out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=by, plain_ms=plain, max_abs_err=max_abs)
        log(f"[mellum] b4 {name} tokens={tokens} mt={mt}: {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({by}), plain (CPU) {plain:.1f} ms, max abs err {max_abs:.3e} "
            f"(tolerance {rtol:.1e} of |plain| + of its largest)")
    out["align_ms"] = time_ms(lambda i: moe_matmul.expert_align(ids, e, mt), 10)
    return out


def _b3_window_case() -> dict:
    """B3 at the cell's verify, window 1,024: 64 rows x Hkv 4 x G 8 x 5 new
    over an int8 pool of 128-position pages (23 a row, shuffled), lengths
    600-2,800 (most past the window), against the plain version on the
    same inputs; then its time with and without the window against the
    least time of the positions each reads."""
    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_attention, paged_flash_decode_ref)
    from llmspeculativesampling_tpu_torch.models.llama import block_bias

    rows, s_new, hkv, d = 64, MELLUM_GAMMA + 1, MELLUM_HKV, 128
    gen = torch.Generator(device="cuda").manual_seed(24)
    lens = torch.randint(600, 2800, (rows,), generator=torch.Generator().manual_seed(5)).tolist()
    q, kn, vn, kq, vq, tables, lengths, _, ks, vs = _paged_inputs(
        gen, lens, hkv * MELLUM_G, hkv, s_new, d, PAGE, MELLUM_PAGES, True)
    out = {"rows": rows, "mean_len": sum(lens) / rows}
    rtol = atol = 2.0 ** -7
    for window in (MELLUM_WINDOW, 0):
        bias = block_bias(s_new, None, rows, "cuda", window or None)
        kw = dict(scale=1.0, k_scales=ks, v_scales=vs, window=window)
        args = (q, kn, vn, kq, vq, tables, lengths, bias)
        max_abs, _ = _check_case(f"paged_flash_decode window={window} B={rows} Hkv={hkv} "
                                 f"G={MELLUM_G} S_new={s_new}", paged_flash_decode_attention,
                                 paged_flash_decode_ref, args, kw, rtol, atol)
        ms = time_ms(lambda i: paged_flash_decode_attention(*args, **kw), 20)
        t0 = time.perf_counter()
        paged_flash_decode_ref(*args, **kw)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        seen = sum(min(n, window - 1) if window else n for n in lens)
        b_ms, by = _flash_bound(hkv, s_new, seen, True, rows=rows, extra_bytes=tables.nbytes)
        out[window] = dict(ms=ms, bound_ms=b_ms, bound_by=by, plain_ms=plain, max_abs_err=max_abs)
        log(f"[mellum] b3 window={window} {rows} x {hkv} x {MELLUM_G} x {s_new} int8, mean len "
            f"{out['mean_len']:.0f}: {ms:.4f} ms, bound {b_ms:.4f} ms ({by}), plain {plain:.1f} ms, "
            f"max abs err {max_abs:.3e}")
    return out


def _mellum_main_path() -> dict:
    """Mellum2-12B-A2.5B at its published widths (the benchmark's pair,
    ``benchmarks/families/mellum.py``) through ``PagedEngine`` with the
    cell's engine settings at 8 rows: one request to warm the shapes, then
    8 at once with the counters at 0. B1, B3 and B4 must launch, B2 never;
    two B4 products a launch of the alignment (one a layer, no per-expert
    loop); the routed totals grow by top-8 pairs a token; every request
    makes its new tokens (48 to 48 + gamma, or fewer ending in EOS) in the
    vocabulary."""
    from benchmarks import families
    from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), MELLUM_CONFIG)) as fh:
        cfg = json.load(fh)
    fam = families.family(cfg)
    t0 = time.perf_counter()
    pair = fam.build(cfg, 2**31 + 24, torch.device("cuda"))
    b = fam.bundles(pair, kv_quant=True)
    rows = len(MELLUM_PROMPTS)
    engine = PagedEngine(b["draft"], pair["draft"], b["target"], pair["target"], seed=24,
                         device="cuda", batch_rows=rows, num_blocks=rows * MELLUM_PAGES,
                         page=PAGE, max_pages_per_req=MELLUM_PAGES, max_new_cap=MELLUM_NEW,
                         gamma=MELLUM_GAMMA, eos_token_id=2, temperature=1.0, top_k=1, top_p=0.0,
                         prompt_bucket=64, steps_per_sync=8, kv_quant=True,
                         prefill_token_budget=512)
    gen = np.random.default_rng(24)
    prompts = [gen.integers(100, 98000, size=n).astype(np.int32) for n in MELLUM_PROMPTS]
    engine.submit(prompts[0], 4)
    engine.run_until_idle()
    for rid in list(engine.completions):
        engine.result(rid)
    torch.cuda.synchronize()
    log(f"[mellum] pair born and the engine warm in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    routed = pair["target"]["routed_rows"]
    before = routed.clone()
    reset_launches()
    t0 = time.perf_counter()
    rids = [engine.submit(p, MELLUM_NEW) for p in prompts]
    engine.run_until_idle()
    launches = read_launches()
    wall = time.perf_counter() - t0
    outs = [engine.result(rid).output_ids for rid in rids]
    made = _check_outputs("mellum", [(len(p), MELLUM_NEW) for p in prompts], prompts, outs,
                          pair["widths"]["target"]["vocab"], MELLUM_GAMMA)
    grown = int((routed - before).sum())
    if (launches["moe_matmul"] <= 0 or launches["moe_matmul"] != 2 * launches["expert_align"]
            or launches["int8_matmul"] <= 0 or launches["paged_flash_decode"] <= 0
            or launches["flash_decode"] != 0):
        raise AssertionError(f"mellum main path: launches {launches}")
    if grown <= 0 or grown % MELLUM_K:
        raise AssertionError(f"mellum main path: the routed totals grew by {grown}")
    log(f"[mellum] main path: {rows} requests, {made} new tokens in {wall:.2f} s; launches "
        f"{launches}; routed pairs {grown}; prefills replayed / eager {engine.prefill_replays} / "
        f"{engine.prefill_eager}")
    del engine, pair, b
    release_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_mellum(results):
    """Mellum 2's kernels at the benchmark cell's shapes (B4 at the verify
    and at a 2,048-token prefill, B3 with the 1,024 window at the verify),
    each against its plain version, then the model through its main path
    for the launch counts."""
    results["mellum"] = {"b4": [_b4_case(t) for t in MELLUM_TOKENS], "b3": _b3_window_case()}
    results.setdefault("launches", {})["mellum"] = _mellum_main_path()


def mellum_kernels(results) -> tuple:
    """The ``kernels`` line's B4 entry, and B3's numbers at Mellum's window
    (its entry's ``mellum``)."""
    m = results["mellum"]
    verify, prefill = m["b4"]
    both = lambda c, key: c["gate_up"][key] + c["down"][key]  # noqa: E731
    launches = {path: n.get("moe_matmul", 0) for path, n in results["launches"].items()}
    b4 = {"name": "moe_matmul", "route": "cuda",
          "source": "llmspeculativesampling_tpu_torch/csrc/moe_matmul.cu", "replaces": None,
          "at": f"one expert layer of a Mellum verify: {verify['tokens']} tokens x top-8 over 64 "
                f"experts, tile {verify['mt']}, gate/up and down",
          "launches": sum(launches.values()), "launches_by_path": launches,
          "max_abs_err": max(c[p]["max_abs_err"] for c in m["b4"] for p in ("gate_up", "down")),
          "ms": both(verify, "ms"), "plain_ms": both(verify, "plain_ms"),
          "bound_ms": both(verify, "bound_ms"), "bound_by": verify["down"]["bound_by"],
          "library_ms": None,
          "prefill": {"at": f"one expert layer of a {prefill['tokens']}-token prefill, tile "
                            f"{prefill['mt']}", "ms": both(prefill, "ms"),
                      "plain_ms": both(prefill, "plain_ms"), "bound_ms": both(prefill, "bound_ms"),
                      "bound_by": prefill["gate_up"]["bound_by"]}}
    w = m["b3"][MELLUM_WINDOW]
    b3 = {"at": f"one window layer of a Mellum verify: B={m['b3']['rows']}, Hkv=4, G=8, S_new=5, "
                f"window {MELLUM_WINDOW}, int8 pool, mean length {m['b3']['mean_len']:.0f}",
          "launches": results["launches"]["mellum"]["paged_flash_decode"],
          **{key: w[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
          "no_window_ms": m["b3"][0]["ms"]}
    return b4, b3


def main(argv=None) -> int:
    only = list(sys.argv[1:] if argv is None else argv)
    if only not in ([], ["--only", "mellum"]):
        print("usage: chip_smoke.py [--only mellum]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from llmspeculativesampling_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    t_all = time.perf_counter()

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[smoke] {fn.__name__} took {time.perf_counter() - t0:.1f} s")
        return out

    timed(phase_device, _build)
    if only:
        timed(phase_mellum, results)
        b4, b3 = mellum_kernels(results)
        print(json.dumps({"kernels": [b4, {"name": "paged_flash_decode", "mellum": b3}]}))
        print(card_line())
        print(json.dumps({"ok": True}))
        return 0
    for phase in (phase_int8_matmul, phase_flash_decode, phase_flash_tree, phase_flash_algorithms,
                  phase_flash_slotted, phase_paged_flash_decode, phase_paged_extend,
                  phase_paged_sarathi, phase_opt_int8_matmul, phase_opt_attention,
                  phase_flash_harness, phase_trained_int8_matmul, phase_tp_kernels,
                  phase_dp_kernels):
        timed(phase, results)
    for phase in (phase_forward, phase_paged_forward, phase_prefix_forward, phase_sarathi_forward,
                  phase_tree_forward, phase_opt_forward, phase_fp8_forward, phase_loader):
        timed(phase)
    pair = timed(build_pair)
    for phase in (phase_main_path, phase_device_loop, phase_winner_loops, phase_tree_loops,
                  phase_tree_path, phase_algorithms, phase_v2_loop):
        timed(phase, results, REPS, pair)
    timed(phase_serving, results, pair)
    timed(phase_burst_trickle, results, pair)
    for phase in (phase_shared_prefix, phase_longgen, phase_hit_burst_trickle, phase_cold_mix,
                  phase_adaptive, phase_slotted, phase_serving_pipeline):
        timed(phase, results, pair)
    release_graphs()  # the entries free with the pair; this frees their caches first
    del pair
    gc.collect()
    torch.cuda.empty_cache()  # the Llama pair's 13.3 GB go before the tp ranks' and the OPT pair's
    timed(phase_tp, results)
    timed(phase_dp, results)
    timed(phase_opt_path, results, REPS)
    for phase in (phase_harness, phase_trained_pair, phase_mellum):
        timed(phase, results)
    by_path = results["launches"]
    kernels = [
        {"name": "int8_matmul", "route": "cuda",
         "source": "llmspeculativesampling_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "llmspeculativesampling_tpu/kernels/int8_matmul.py:75",
         "at": "one target verify forward of the paged serving path: 281 calls at M=144"},
        {"name": "flash_decode", "route": "cuda",
         "source": "llmspeculativesampling_tpu_torch/csrc/flash_decode.cu",
         "replaces": "llmspeculativesampling_tpu/kernels/flash_decode.py:470",
         "at": "one single-stream target verify forward: 40 calls, Hkv=40, S_new=25, len=128, "
               "dense KV"},
        {"name": "paged_flash_decode", "route": "cuda",
         "source": "llmspeculativesampling_tpu_torch/csrc/flash_decode.cu",
         "replaces": "llmspeculativesampling_tpu/kernels/flash_decode.py:567",
         "at": "one serving target verify forward: 40 calls, B=16, Hkv=40, S_new=9, page 128, "
               "int8 pool, uniform lengths"},
    ]
    # the same numbers at the OPT path's shapes, under "opt"
    att = results["opt_attention"]["per_call"]
    opt_rows = {
        "int8_matmul": ("one OPT target verify forward: 240 calls at M=9",
                        results["opt_int8_matmul"]["forwards"][f"target M={OPT_GAMMA + 1}"], 1),
        "flash_decode": ("one OPT target verify forward: 40 calls, Hkv=40, S_new=9, len=128",
                         att["B2 target verify"], 40),
        "paged_flash_decode": ("one OPT serving verify forward: 40 calls, B=16, Hkv=40, S_new=9, "
                               "int8 pool, uniform lengths", att["B3 serving verify"], 40),
    }
    opt_err = {"int8_matmul": results["opt_int8_matmul"]["max_abs_err"],
               "flash_decode": results["opt_attention"]["max_abs_err"],
               "paged_flash_decode": results["opt_attention"]["max_abs_err"]}
    for k in kernels:
        r = results[k["name"]]
        n = {path: counts[k["name"]] for path, counts in by_path.items()}
        k.update(launches=sum(n.values()), launches_by_path=n,
                 max_abs_err=max(r["max_abs_err"], opt_err[k["name"]]),
                 ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                 library_ms=r["library_ms"])
        at, row, calls = opt_rows[k["name"]]
        k["opt"] = dict(at=at, bound_by=row["bound_by"],
                        **{key: calls * row[key] for key in ("ms", "plain_ms", "library_ms",
                                                             "bound_ms")})
    # the same numbers at the prefix cache's extend window, under "extend";
    # "launches" there: the launches inside the shared_prefix run's windows
    ext, ext_launches = results["extend"], results["shared_prefix"][True]["extend_launches"]
    b1 = results["int8_matmul"]["extend"]
    extend_rows = {
        "int8_matmul": ("one target forward of an 8-hit extend window: 281 calls at M=256, "
                        "batch-invariant plan", b1, 1, results["int8_matmul"]["max_abs_err"]),
        "paged_flash_decode": ("one target extend window: 40 calls, KB=8, Hkv=40, S_new=32 over "
                               "a 512-position prefix all 8 tables share, int8 pool, "
                               "batch-invariant plan", ext["b3"]["target"], 40,
                               ext["b3_max_abs_err"]),
    }
    for k in kernels:
        if k["name"] in extend_rows:
            at, row, calls, err = extend_rows[k["name"]]
            k["extend"] = dict(at=at, bound_by=row["bound_by"], max_abs_err=err,
                               launches=ext_launches.get(k["name"], 0),
                               **{key: calls * row[key] for key in ("ms", "plain_ms", "library_ms",
                                                                    "bound_ms")})
    # the same numbers at the SARATHI path's widest verify (the cold mix at
    # prefill_extra 8: 12 rows x 17), under "sarathi"; "launches" there: the
    # cold mix's and the adaptive runs'
    sar = results["sarathi"]["b3"]["cold_mix prefill_extra-8 verify"]
    sarathi_rows = {
        "int8_matmul": ("one cold_mix prefill_extra-8 verify forward: 281 calls at M=204",
                        results["int8_matmul"]["sarathi"][SARATHI_TARGET_M[2]], 1,
                        results["int8_matmul"]["max_abs_err"]),
        "paged_flash_decode": ("one cold_mix prefill_extra-8 verify forward: 40 calls, B=12, "
                               "Hkv=40, S_new=17, a staged row at length 0 and one mid-prompt, "
                               "int8 pool", sar, 40, results["sarathi"]["b3_max_abs_err"]),
    }
    for k in kernels:
        if k["name"] in sarathi_rows:
            at, row, calls, err = sarathi_rows[k["name"]]
            k["sarathi"] = dict(at=at, bound_by=row["bound_by"], max_abs_err=err,
                                launches=by_path["cold_mix"][k["name"]]
                                + by_path["adaptive"][k["name"]],
                                **{key: calls * row[key] for key in ("ms", "plain_ms", "library_ms",
                                                                     "bound_ms")})
    # the same numbers at the slotted engine's verify (16 slots x 9, per-slot
    # lengths, int8 KV), under "slotted"; "launches" there: the slotted run's
    b2 = results["slotted_b2"]
    slotted_rows = {
        "int8_matmul": ("one slotted target verify forward: 281 calls at M=144",
                        results["int8_matmul"], 1, results["int8_matmul"]["max_abs_err"]),
        "flash_decode": ("one slotted target verify forward: 40 calls, B=16, Hkv=40, S_new=9 over "
                         "S_max 256, per-slot lengths 1-247, int8 KV",
                         b2["per_call"]["slotted target verify"], 40, b2["max_abs_err"]),
    }
    for k in kernels:
        if k["name"] in slotted_rows:
            at, row, calls, err = slotted_rows[k["name"]]
            k["slotted"] = dict(at=at, bound_by=row["bound_by"], max_abs_err=err,
                                launches=by_path["slotted"][k["name"]],
                                **{key: calls * row[key] for key in ("ms", "plain_ms", "library_ms",
                                                                     "bound_ms")})
    # the same numbers at the harness pair's verify (B2) and the trained
    # pair's (B2, fp32; B1, its int8 target's forward at M=5), under
    # "harness" and "trained_pair"; "launches" there: those paths'
    fh, b1t = results["flash_decode_harness"], results["int8_matmul_trained"]
    new_rows = {
        ("flash_decode", "harness"): ("one harness target verify forward: 16 calls, B=1, Hkv=16, "
                                      "S_new=5, D=128, len=96, bf16", fh["per_call"]["harness verify"],
                                      16, fh["max_abs_err"]["harness"]),
        ("flash_decode", "trained_pair"): ("one trained target verify forward: 4 calls, B=1, Hkv=4, "
                                           "S_new=5, D=64, len=64, fp32",
                                           fh["per_call"]["trained target verify"], 4,
                                           fh["max_abs_err"]["trained"]),
        ("int8_matmul", "trained_pair"): (f"one trained int8 target verify forward: 28 calls at "
                                          f"M={TRAINED_GAMMA + 1}, K/N 256/1024, fp32 x",
                                          b1t["forwards"][TRAINED_GAMMA + 1], 1, b1t["max_abs_err"]),
    }
    # the same numbers at one tp=2 rank's shard shapes, under "tp"; "launches"
    # there: one rank's on the tp path (the other's are equal)
    tpk = results["tp_kernels"]
    pc = tpk["per_call"]
    new_rows.update({
        ("int8_matmul", "tp"): (f"one tp=2 rank's target verify forward: 281 calls at M={GAMMA + 1}, "
                                "q/k/v and gate/up at half their columns, o and down at half "
                                "their rows with fp32 output, a 16000-row head",
                                tpk["b1"][("target", GAMMA + 1)], 1, tpk["b1_max_abs_err"]),
        ("flash_decode", "tp"): ("one tp=2 rank's target verify forward: 40 calls, Hkv=20, "
                                 "S_new=25, len=128, dense KV", pc["B2 target verify"], 40,
                                 tpk["b2_max_abs_err"]),
        ("paged_flash_decode", "tp"): ("one tp=2 rank's serving verify forward: 40 calls, B=16, "
                                       "Hkv=20, S_new=9, int8 pool, uniform lengths",
                                       pc["B3 serving verify"], 40, tpk["b3_max_abs_err"]),
    })
    # the same numbers at one dp=2 rank's shapes, under "dp"; "launches"
    # there: rank 0's on the dp=2 x tp=1 paged and slotted runs
    dpk = results["dp_kernels"]
    pc = dpk["per_call"]
    new_rows.update({
        ("int8_matmul", "dp"): (f"one dp=2 rank's paged or slotted target verify forward: 281 "
                                f"calls at M={DP_TARGET_M} (8 rows x 9)",
                                dpk["b1"][("target", DP_TARGET_M)], 1, dpk["b1_max_abs_err"]),
        ("flash_decode", "dp"): ("one dp=2 rank's slotted target verify forward: 40 calls, 8 "
                                 "slots, Hkv=40, S_new=9 over S_max 256, per-slot lengths, int8 KV",
                                 pc["B2 slotted verify"], 40, dpk["b2_max_abs_err"]),
        ("paged_flash_decode", "dp"): ("one dp=2 rank's paged target verify forward: 40 calls, "
                                       "B=8, Hkv=40, S_new=9, a 16-block int8 pool, P=16, "
                                       "uniform lengths", pc["B3 paged verify"], 40,
                                       dpk["b3_max_abs_err"]),
    })
    for k in kernels:
        for (name, path), (at, row, calls, err) in new_rows.items():
            if k["name"] == name:
                k[path] = dict(at=at, bound_by=row["bound_by"], max_abs_err=err,
                               launches=by_path[path][name],
                               **{key: calls * row[key] for key in ("ms", "plain_ms", "library_ms",
                                                                    "bound_ms")})
    # Mellum 2's: B4, and B3 at the window (under "mellum")
    b4, b3 = mellum_kernels(results)
    next(k for k in kernels if k["name"] == "paged_flash_decode")["mellum"] = b3
    kernels.append(b4)
    log(f"[smoke] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
