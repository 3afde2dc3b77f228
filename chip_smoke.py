#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmspeculativesampling_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py

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
     head's bf16 product (fp32 sums) against the fp32 product;
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
  4. single-stream path: the 13B-shaped int8 target + 768-wide int8 draft,
     born on the card from a seed; autoregressive and speculative decoding
     with bench.py's settings (64-token prompt, 128 new tokens, gamma=24,
     top_k=20, top_p=0.9, eos=2);
  5. paged serving path: the same pair through ``PagedEngine`` behind
     ``BatchedInferenceServer`` with the settings of ``scripts/bench_paged.py
     --config 13b --kv_int8 --steps_per_sync 8`` (16 rows, 32 int8 blocks of
     128, gamma=8), two traffic mixes (uniform, with one request over HTTP
     on a loopback port, and mixed) from concurrent client threads; then 8
     requests through the engine as a burst and one at a time, whose output
     ids must be equal;
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
     must accept every draft at accept_thres 0 and none at 1.5.
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
     the paged path and B3 not on the others;
  9. a ``{"kernels": [...]}`` line (each kernel also with its numbers at the
     OPT path's shapes, under "opt"), the card line again, and as the last
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
    pkg_build.build(["int8_matmul", "flash_decode"])
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
                TREE_TARGET_M[2]: "v1 tree verify", TREE_TARGET_M[3]: "4-row prefill",
                ALG_TARGET_M[0]: "BiLD check", ALG_TARGET_M[1]: "MJSD-8 verify",
                ALG_TARGET_M[2]: "random-beam decode"}
    fwd = {m: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0) for m in forwards}
    # the admission prefill's M (64 x requests) plans B1 batch-invariant: time
    # that plan beside the one chosen from M at each prefill M
    prefill_m = {TARGET_M[0], TREE_TARGET_M[3], SERVE_TARGET_M[1]}
    inv = {m: 0.0 for m in prefill_m}
    worst_abs = 0.0
    tm = sorted(set(TARGET_M + SERVE_TARGET_M + TREE_TARGET_M + ALG_TARGET_M), reverse=True)
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
                                                         for m in ALG_TARGET_M})
    for m, what in forwards.items():
        f = fwd[m]
        log(f"[int8_matmul] one {what} target forward (281 launches at M={m}): "
            f"kernel_ms {f['ms']:.3f} plain_ms {f['plain_ms']:.3f} library_ms {f['library_ms']:.3f} "
            f"bound_ms {f['bound_ms']:.3f} ({f['bound_by']}) bound share {f['bound_ms'] / f['ms']:.3f}"
            + (f"; batch-invariant plan (the admission prefill's) kernel_ms {inv[m]:.3f}"
               if m in inv else ""))
    results["int8_matmul"]["prefill_ms"] = {m: (fwd[m]["ms"], inv[m]) for m in sorted(inv)}


def _flash_inputs(gen, b, hq, hkv, s_new, d, quant, tree, dtype=torch.bfloat16):
    """Inputs in the layouts the forward passes: q/k_new/v_new are
    [B, H, S_new, D] views of [B, S_new, H, D] projections. bf16 q comes with
    the softmax scale folded in (called with scale 1.0, so kernel and plain
    version see the same q); fp32 q is raw (scale 1/sqrt(d): the kernel's
    fold rounds nothing in fp32)."""
    q = torch.randn((b, s_new, hq, d), generator=gen, device="cuda")
    q = (q / math.sqrt(d) if dtype == torch.bfloat16 else q).to(dtype).transpose(1, 2)
    kn = torch.randn((b, s_new, hkv, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    vn = torch.randn((b, s_new, hkv, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    kc = torch.randn((b, hkv, S_MAX, d), generator=gen, device="cuda")
    vc = torch.randn((b, hkv, S_MAX, d), generator=gen, device="cuda")
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


def _flash_bound(hkv, s_new, length, quant, rows=1, extra_bytes=0):
    """Least time of one call: live prefix K/V (and scales) read once, q,
    k_new, v_new, out, bias, lengths (and ``extra_bytes``: block tables)
    once; QK^T and PV in bf16."""
    kv_b = 1 if quant else 2
    nbytes = (2 * length * hkv * 128 * kv_b + (2 * length * hkv * 4 if quant else 0)
              + 4 * rows * hkv * s_new * 128 * 2 + rows * s_new * s_new * 4 + rows * 4
              + extra_bytes)
    return bound(nbytes, 2 * 2 * hkv * s_new * (length + rows * s_new) * 128)


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
            f"plain_ms {t_p:.4f} library_ms {'n/a' if t_l is None else f'{t_l:.4f}'} "
            f"(F.scaled_dot_product_attention over [0,len) + block, dense only) "
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


def _rows_inputs(gen, b, hkv, s_new, quant, lens, tree):
    """B2 inputs at B = len(lens) rows with per-row lengths, Hq = Hkv,
    D=128: the causal bias, or (``tree``) a tree verify's ancestor bias."""
    q, kn, vn, kc, vc, bias, ks, vs = _flash_inputs(gen, b, hkv, hkv, s_new, 128, quant, False)
    if tree:
        bias = _tree_bias(gen, b)
    return q, kn, vn, kc, vc, torch.tensor(lens, dtype=torch.int32, device="cuda"), bias, ks, vs


def _time_flash(gen, hkv, s_new, lens, quant=False, tree=False):
    """Kernel, plain and (dense only) SDPA times of B2 at B = len(lens) rows
    (see :func:`_rows_inputs`). Inputs rotate through > L2 bytes and are
    contiguous, so that only the kernel runs inside the timed graph; SDPA
    attends [0, max len) + the block under a float mask (-inf past a row's
    length, the causal or tree bias on the block)."""
    import torch.nn.functional as F

    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref)

    b = len(lens)

    def make():
        t = _rows_inputs(gen, b, hkv, s_new, quant, lens, tree)
        return [x.contiguous() if x is not None else None for x in t]

    sets = _rotated(make)

    def kern(i):
        q, kn, vn, kc, vc, lengths, bias, ks, vs = sets[i % len(sets)]
        return flash_decode_attention(q, kn, vn, kc, vc, lengths, bias, scale=1.0,
                                      k_scales=ks, v_scales=vs)

    def plain(i):
        q, kn, vn, kc, vc, lengths, bias, ks, vs = sets[i % len(sets)]
        return flash_decode_ref(q, kn, vn, kc, vc, lengths, bias, scale=1.0, k_scales=ks, v_scales=vs)

    t_k, t_p, t_l = time_ms(kern, 50), time_ms(plain, 20), None
    if not quant:
        width = max(lens)
        lib_sets = []
        for q, kn, vn, kc, vc, lengths, bias, _, _ in sets:
            pre = torch.arange(width, device="cuda")[None, None, :] < lengths[:, None, None]
            pre = torch.where(pre, 0.0, float("-inf")).expand(b, s_new, width)
            mask = torch.cat([pre, torch.where(bias == 0, 0.0, float("-inf"))], dim=2)[:, None]
            lib_sets.append((q, torch.cat([kc[:, :, :width], kn], 2),
                             torch.cat([vc[:, :, :width], vn], 2), mask.contiguous()))

        def lib(i):
            q, k_all, v_all, mask = lib_sets[i % len(lib_sets)]
            return F.scaled_dot_product_attention(q, k_all, v_all, attn_mask=mask, scale=1.0)

        t_l = time_ms(lib, 50)
        del lib_sets
    b_ms, b_by = _flash_bound(hkv, s_new, sum(lens), quant, rows=b)
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


def _paged_inputs(gen, lens, hq, hkv, s_new, d, page, p_max, quant, tree=False,
                  dtype=torch.bfloat16):
    """Inputs of one paged attention call in the forward's layouts: q/k_new/
    v_new are [B, H, S_new, D] views of [B, S_new, H, D] projections; pools
    [N+1, Hkv, page, D] with the trash block last; each row's pages are
    shuffled blocks from the allocator, unused table slots (and a row of
    length 0) hold the sentinel N. bf16 q comes pre-scaled (scale 1.0, as
    in the B2 phase); fp32 q is raw."""
    from llmspeculativesampling_tpu_torch.cache.kvcache import _quantize_kv

    b = len(lens)
    n_blk = max(sum(-(-ln // page) for ln in lens), 1)
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


def _time_paged(gen, lens, p_max, hkv, s_new, quant):
    """Kernel, plain and SDPA times of B3 at B=16, Hq=Hkv, D=128, page 128.
    Inputs rotate past L2; the library yardstick attends over a
    pre-gathered contiguous (dequantized) view, the gather untimed."""
    import torch.nn.functional as F

    from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
        gather_pages, paged_flash_decode_attention, paged_flash_decode_ref)

    def make():
        t = _paged_inputs(gen, lens, hkv, hkv, s_new, 128, PAGE, p_max, quant)
        return [x.contiguous() if x is not None else None for x in t]

    sets = _rotated(make)

    def kern(i):
        q, kn, vn, kp, vp, tables, lengths, bias, ks, vs = sets[i % len(sets)]
        return paged_flash_decode_attention(q, kn, vn, kp, vp, tables, lengths, bias,
                                            scale=1.0, k_scales=ks, v_scales=vs)

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
        mask = torch.cat([pre.expand(ROWS, s_new, width), bias == 0], dim=2)[:, None]
        lib_sets.append((q, torch.cat([kc.to(q.dtype), kn], 2), torch.cat([vc.to(q.dtype), vn], 2),
                         mask))

    def lib(i):
        q, k_all, v_all, mask = lib_sets[i % len(lib_sets)]
        return F.scaled_dot_product_attention(q, k_all, v_all, attn_mask=mask, scale=1.0)

    t_k, t_p, t_l = time_ms(kern, 50), time_ms(plain, 20), time_ms(lib, 50)
    b_ms, b_by = _flash_bound(hkv, s_new, sum(lens), quant, rows=ROWS,
                              extra_bytes=ROWS * p_max * 4)
    n = len(sets)
    del sets, lib_sets
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


# ---------------------------------------------------------------- phase 3
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
            got = compact_tree_paths(
                dataclasses.replace(src, **{f.name: getattr(src, f.name).cuda().clone()
                                            for f in dataclasses.fields(src) if f.name != "length"}),
                path_nodes.cuda(), valid.cuda(), cur_len)
            ref = compact_tree_paths(
                dataclasses.replace(src, **{f.name: getattr(src, f.name).cpu().clone()
                                            for f in dataclasses.fields(src) if f.name != "length"}),
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

    return {"int8_matmul": int8_matmul, "flash_decode": flash_decode_attention,
            "paged_flash_decode": paged_flash_decode_attention}


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


# ---------------------------------------------------------------- phase 6
def _time_select_rows(cache, rows: int, reps: int = 20) -> float:
    """Device ms of one ``select_rows`` of ``cache`` into ``rows`` rows (CUDA
    events around eager calls: each allocates its copy)."""
    from llmspeculativesampling_tpu_torch.cache.kvcache import select_rows

    idx = torch.zeros((rows,), dtype=torch.long, device="cuda")
    select_rows(cache, idx)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        select_rows(cache, idx)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    del tc4, tc1, dc4
    torch.cuda.empty_cache()
    results["tree"] = dict(engines=out_res, select_rows_ms=dict(target4=t4, target1=t1, draft4=d4),
                           select_rows_per_step_ms=per_step)
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


# ---------------------------------------------------------------- phase 5
def _workload(kind: str, rng):
    """scripts/bench_paged.py's mixes: (prompt_len, max_new) per request.
    Uniform: 24 x (64, 48). Mixed: 24 short (64, 24-48) with a long
    (512, 128) after every four, six in all."""
    if kind == "uniform":
        return [(64, 48) for _ in range(24)]
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


def _serve_mix(kind: str, pair) -> dict:
    import threading
    import urllib.request

    from llmspeculativesampling_tpu_torch.serve.paged import PagedEngine
    from llmspeculativesampling_tpu_torch.serve.server import (
        BatchedInferenceServer, InferenceServer, ServerConfig, make_http_server)

    bd, pd, bt, pt = pair
    card = card_line()
    rng = np.random.default_rng(0)
    reqs = _workload(kind, rng)
    prompts = [rng.integers(100, 31000, pl).astype(np.int32) for pl, _ in reqs]
    worst = max(pl + mn for pl, mn in reqs) + SERVE_GAMMA + 1
    engine = PagedEngine(
        bd, pd, bt, pt, batch_rows=ROWS, num_blocks=BLOCKS, page=PAGE,
        max_pages_per_req=-(-worst // PAGE), max_new_cap=max(mn for _, mn in reqs),
        gamma=SERVE_GAMMA, eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9,
        prompt_bucket=64, steps_per_sync=SYNC, kv_quant=True, device="cuda")
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
        raise AssertionError(f"serving {kind}: a client thread did not finish")

    gen_tokens = 0
    for (pl, mn), prompt, out in zip(reqs, prompts, outs):
        if out is None:
            raise AssertionError(f"serving {kind}: a request got no output")
        out = np.asarray(out)
        n_new = len(out) - pl
        # the length lands in [max_new, max_new + gamma] unless EOS ends it
        ok_len = mn <= n_new <= mn + SERVE_GAMMA or (1 <= n_new and out[-1] == 2)
        if not (np.array_equal(out[:pl], prompt) and ok_len and out.min() >= 0
                and out.max() < bt.cfg.vocab_size):
            raise AssertionError(f"serving {kind}: bad output of length {len(out)} for ({pl}, {mn})")
        gen_tokens += n_new
    if engine.allocator.free_blocks != BLOCKS or engine.num_active or engine._pending:
        raise AssertionError(f"serving {kind}: the pool did not end fully free")
    acc = float(np.mean([d["acc_rate"] for d in details]))
    snap = base.stats.snapshot()
    log(f"[serve {kind}] {len(reqs)} requests, {gen_tokens} generated tokens in {wall:.2f} s: "
        f"{gen_tokens / wall:.2f} tok/s aggregate ({card})")
    log(f"[serve {kind}] latency p50 {snap['latency_p50_s']} s p95 {snap['latency_p95_s']} s, "
        f"TTFT p50 {snap['ttft_p50_s']} s p95 {snap['ttft_p95_s']} s (ServerStats) ({card})")
    log(f"[serve {kind}] acc_rate {acc:.4f} (mean over requests), mean steps per request "
        f"{np.mean([d['target_call_times'] for d in details]):.2f}, launches {launches}")
    log(f"[serve {kind}] {chunks[0]} chunks of up to {SYNC} steps; requests per admission "
        f"prefill, in order: {prefills}")
    if acc < 0.6:
        raise AssertionError(f"serving {kind}: acceptance {acc:.3f} < 0.6: a kernel is likely wrong")
    if launches["int8_matmul"] <= 0 or launches["paged_flash_decode"] <= 0:
        raise AssertionError(f"serving {kind}: B1 or B3 was not launched on the paged path")
    if launches["flash_decode"] != 0:
        raise AssertionError(f"serving {kind}: B2 ran on the paged path")
    del engine, server, base
    torch.cuda.empty_cache()
    return dict(tok_s=gen_tokens / wall, wall_s=wall, tokens=gen_tokens, requests=len(reqs),
                acc_rate=acc, launches=launches, **{k: snap[k] for k in (
                    "latency_p50_s", "latency_p95_s", "ttft_p50_s", "ttft_p95_s")})


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
    serving = {kind: _serve_mix(kind, pair) for kind in ("uniform", "mixed")}
    results["serving"] = serving
    results["launches"]["paged_serving"] = {
        name: sum(serving[k]["launches"][name] for k in serving)
        for name in serving["uniform"]["launches"]}


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
    del pair, bd, pd, bt, pt, engines
    gc.collect()
    torch.cuda.empty_cache()
    elapsed = time.perf_counter() - t_phase
    log(f"[opt] phase took {elapsed:.1f} s")
    results["opt"] = dict(engines=out_res, seconds=elapsed)
    results["launches"]["opt"] = total


def main() -> int:
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
    for phase in (phase_int8_matmul, phase_flash_decode, phase_flash_tree, phase_flash_algorithms,
                  phase_paged_flash_decode, phase_opt_int8_matmul, phase_opt_attention):
        timed(phase, results)
    for phase in (phase_forward, phase_paged_forward, phase_tree_forward, phase_opt_forward,
                  phase_fp8_forward, phase_loader):
        timed(phase)
    pair = timed(build_pair)
    for phase in (phase_main_path, phase_tree_path, phase_algorithms):
        timed(phase, results, REPS, pair)
    timed(phase_serving, results, pair)
    timed(phase_burst_trickle, results, pair)
    del pair
    gc.collect()
    torch.cuda.empty_cache()  # the Llama pair's 13.3 GB go before the OPT pair's 13.1 GB
    timed(phase_opt_path, results, REPS)
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
    log(f"[smoke] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
