#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmspeculativesampling_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing lines before the last:
  1. device: the card's name and power limit (nvidia-smi), torch/CUDA
     versions, and the build of every kernel (nvcc processes started
     together) with its ptxas register report;
  2. kernels: each hand-written kernel against its plain PyTorch version on
     the card at the main path's shapes, with the tolerance stated; kernel,
     plain, library-yardstick and bound times;
  3. forward: logits of a 2-layer, full-width (5120) int8 Llama slice on the
     card with the kernels vs the same weights on the CPU with the plain
     versions;
  4. main path: the 13B-shaped int8 target + 768-wide int8 draft, born on
     the card from a seed; autoregressive and speculative decoding with
     bench.py's settings (64-token prompt, 128 new tokens, gamma=24,
     top_k=20, top_p=0.9, eos=2). Every launch counter is set to 0 just
     before the timed reps and read just after; each kernel must have run.
  5. a ``{"kernels": [...]}`` line, the card line again, and as the last
     line ``{"ok": true, "device": {...}}``.
Any failed check raises: the script exits non-zero and prints no result.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
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
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")


# ---------------------------------------------------------------- phase 2
def _rotated(make, nbytes: int):
    n = max(1, min(256, math.ceil(L2_FLUSH_BYTES / max(nbytes, 1))))
    return [make() for _ in range(n)]


def phase_int8_matmul(results):
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    rtol, atol_rel = 2.0 ** -7, 1e-3
    log(f"[int8_matmul] tolerance: |kernel-plain| <= {rtol:.2e}*|plain| + {atol_rel:.0e}*max|plain| "
        "(two bf16 ulps; both sum exact bf16 x int8 products in fp32, in other orders)")
    verify_ms = verify_plain = verify_lib = verify_bound = 0.0
    worst_abs = 0.0
    cases = [("target", m, k, n, c) for m in TARGET_M for (k, n, c) in TARGET_SHAPES + [(5120, VOCAB, 1)]]
    cases += [("draft", m, k, n, c) for m in DRAFT_M for (k, n, c) in DRAFT_SHAPES + [(768, VOCAB, 1)]]
    for model, m, k, n, per_layer in cases:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        ws = _rotated(lambda: torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8,
                                            device="cuda"), k * n)
        s = (0.8 + 0.4 * torch.rand((n,), generator=gen, device="cuda")) / (73.0 * math.sqrt(k))
        got = int8_matmul(x[None], ws[0], s)[0]  # [B, S, K] activations, as linear() passes them
        ref = int8_matmul_ref(x, ws[0], s)
        torch.cuda.synchronize()
        max_abs, rel = check_close(f"int8_matmul {model} M={m} K={k} N={n}", got, ref, rtol,
                                   atol_rel * float(ref.float().abs().max()))
        worst_abs = max(worst_abs, max_abs)
        w16 = [w.to(torch.bfloat16) for w in ws]
        t_k = time_ms(lambda i: int8_matmul(x[None], ws[i % len(ws)], s), 20)
        t_p = time_ms(lambda i: int8_matmul_ref(x, ws[i % len(ws)], s), 5)
        t_l = time_ms(lambda i: torch.matmul(x, w16[i % len(w16)]), 20)
        b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * k * n)
        log(f"[int8_matmul] {model} M={m:2d} K={k:5d} N={n:5d}: max_abs_err {max_abs:.3e} "
            f"(rel {rel:.1e}) kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
            f"library_ms {t_l:.4f} (torch.matmul on pre-widened bf16, 2 B/weight) "
            f"bound_us {b_ms * 1e3:.1f} ({b_by})")
        if model == "target" and m == GAMMA + 1:
            calls = 40 * per_layer if n != VOCAB else 1
            verify_ms += calls * t_k
            verify_plain += calls * t_p
            verify_lib += calls * t_l
            verify_bound += calls * b_ms
            verify_by = b_by
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
    results["int8_matmul"] = dict(
        ms=verify_ms, plain_ms=verify_plain, library_ms=verify_lib, bound_ms=verify_bound,
        max_abs_err=worst_abs, bound_by=verify_by)
    log(f"[int8_matmul] one target verify forward (281 launches at M=25): kernel_ms {verify_ms:.3f} "
        f"plain_ms {verify_plain:.3f} library_ms {verify_lib:.3f} bound_ms {verify_bound:.3f}")


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


def phase_flash_decode(results):
    import torch.nn.functional as F

    from llmspeculativesampling_tpu_torch.kernels.flash_decode import (
        flash_decode_attention, flash_decode_ref)

    gen = torch.Generator(device="cuda").manual_seed(2)
    rtol = atol = 2.0 ** -7
    log(f"[flash_decode] tolerance: |kernel-plain| <= {atol:.2e} + {rtol:.2e}*|plain| "
        "(q pre-scaled in bf16 for both; fp32 softmax in both, bf16 output: ~1 ulp)")
    worst = 0.0
    n_cases = 0
    cases = []
    for quant in (False, True):
        for hkv in (40, 6):
            for s_new in (1, 2, 25):
                for length in (0, 1, 127, 128, 200, S_MAX - s_new):
                    for tree in (False, True):
                        cases.append((1, hkv, hkv, s_new, 128, quant, tree, [length]))
    cases += [(1, 16, 4, 25, 128, q, True, [130]) for q in (False, True)]   # GQA, G=4
    cases += [(1, 12, 12, 25, 64, q, False, [100]) for q in (False, True)]  # D=64
    cases += [(1, 12, 12, 25, 32, q, True, [200]) for q in (False, True)]   # D=32
    cases += [(1, 8, 8, 25, 96, q, False, [129]) for q in (False, True)]    # D=96
    cases += [(3, 8, 8, 5, 128, q, False, [0, 64, 251]) for q in (False, True)]  # per-row
    for b, hq, hkv, s_new, d, quant, tree, lens in cases:
        q, kn, vn, kc, vc, bias, ks, vs = _flash_inputs(gen, b, hq, hkv, s_new, d, quant, tree)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = flash_decode_attention(q, kn, vn, kc, vc, lengths, bias, scale=1.0,
                                     k_scales=ks, v_scales=vs)
        ref = flash_decode_ref(q, kn, vn, kc, vc, lengths, bias, scale=1.0, k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        max_abs, _ = check_close(
            f"flash_decode quant={quant} B={b} Hq={hq} Hkv={hkv} S_new={s_new} D={d} "
            f"len={lens} tree={tree}", got, ref, rtol, atol)
        worst = max(worst, max_abs)
        n_cases += 1
    log(f"[flash_decode] {n_cases} cases within tolerance, worst max_abs_err {worst:.3e}")
    # fp32 configs take the kernel's fp32 instantiations: same math in fp32
    # throughout, sums in other orders
    for d in (128, 96, 64, 32):
        for quant in (False, True):
            q, kn, vn, kc, vc, bias, ks, vs = _flash_inputs(gen, 1, 8, 4, 25, d, quant, True,
                                                            torch.float32)
            lengths = torch.tensor([200], dtype=torch.int32, device="cuda")
            got = flash_decode_attention(q, kn, vn, kc, vc, lengths, bias, scale=d ** -0.5,
                                         k_scales=ks, v_scales=vs)
            ref = flash_decode_ref(q, kn, vn, kc, vc, lengths, bias, scale=d ** -0.5,
                                   k_scales=ks, v_scales=vs)
            torch.cuda.synchronize()
            max_abs, _ = check_close(f"flash_decode fp32 quant={quant} D={d}", got, ref, 1e-4, 1e-4)
            log(f"[flash_decode] fp32 q, quant={quant}, D={d}, GQA 8/4, tree, len=200: "
                f"max_abs_err {max_abs:.3e} (tol 1e-4 + 1e-4*|plain|: fp32 throughout)")

    # timing at the verify shape: Hkv=40, S_new=25, a mid-generation prefix;
    # inputs rotate through > L2 bytes, as in the matmul phase, and are
    # contiguous so that only the kernel runs inside the timed graph
    for quant in (False, True):
        length = 128

        def make():
            t = _flash_inputs(gen, 1, 40, 40, GAMMA + 1, 128, quant, False)
            return [x.contiguous() if x is not None else None for x in t]

        sets = _rotated(make, sum(x.nbytes for x in make() if x is not None))
        lengths = torch.full((1,), length, dtype=torch.int32, device="cuda")

        def kern(i):
            q, kn, vn, kc, vc, bias, ks, vs = sets[i % len(sets)]
            return flash_decode_attention(q, kn, vn, kc, vc, lengths, bias, scale=1.0,
                                          k_scales=ks, v_scales=vs)

        def plain(i):
            q, kn, vn, kc, vc, bias, ks, vs = sets[i % len(sets)]
            return flash_decode_ref(q, kn, vn, kc, vc, lengths, bias, scale=1.0,
                                    k_scales=ks, v_scales=vs)

        t_k = time_ms(kern, 50)
        t_p = time_ms(plain, 20)
        kv_b = 1 if quant else 2
        live = 2 * 40 * length * 128 * kv_b + (2 * 40 * length * 4 if quant else 0)
        small = 40 * (GAMMA + 1) * 128 * 2 * 4 + (GAMMA + 1) ** 2 * 4 + 4
        ops = 2 * 2 * 40 * (GAMMA + 1) * (length + GAMMA + 1) * 128
        b_ms, b_by = bound(live + small, ops)
        t_l = None
        if not quant:
            lib_sets = []
            for q, kn, vn, kc, vc, bias, _, _ in sets:
                mask = torch.cat([torch.ones((GAMMA + 1, length), dtype=torch.bool, device="cuda"),
                                  bias[0] == 0], dim=1)
                lib_sets.append((q, torch.cat([kc[:, :, :length], kn], dim=2),
                                 torch.cat([vc[:, :, :length], vn], dim=2), mask))

            def lib(i):
                q, k_all, v_all, mask = lib_sets[i % len(lib_sets)]
                return F.scaled_dot_product_attention(q, k_all, v_all, attn_mask=mask, scale=1.0)

            t_l = time_ms(lib, 50)
        log(f"[flash_decode] {'int8-KV' if quant else 'dense'} Hkv=40 S_new=25 len={length}: "
            f"kernel_ms {t_k:.4f} plain_ms {t_p:.4f} library_ms "
            f"{'n/a' if t_l is None else f'{t_l:.4f}'} (F.scaled_dot_product_attention over "
            f"[0,len) + block, dense only) bound_us {b_ms * 1e3:.2f} ({b_by}); "
            f"{len(sets)} input sets rotated")
        if not quant:
            results["flash_decode"] = dict(
                ms=40 * t_k, plain_ms=40 * t_p, library_ms=40 * t_l, bound_ms=40 * b_ms,
                max_abs_err=worst, bound_by=b_by)
    log(f"[flash_decode] one target verify forward (40 launches, len=128): "
        f"kernel_ms {results['flash_decode']['ms']:.3f} bound_ms {results['flash_decode']['bound_ms']:.4f}")


# ---------------------------------------------------------------- phase 3
def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


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
    # bf16 activations: the two devices round at the same places but sum in
    # other orders, and a flipped bf16 rounding propagates through 2 layers.
    # The argmax must agree wherever the CPU's top-2 gap exceeds twice the
    # largest difference (random weights leave many near-ties).
    rel_tol = 3e-2
    for name, g, r in zip(("prefill 64", "verify 25", "decode 1"), outs["cuda"], outs["cpu"]):
        if not torch.isfinite(g).all() or g.shape != (1, r.shape[1], cfg.vocab_size):
            raise AssertionError(f"forward {name}: bad logits {tuple(g.shape)}")
        max_abs = float((g - r).abs().max())
        rel = max_abs / float(r.abs().max())
        top2 = r.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * max_abs
        agree = (g.argmax(-1) == r.argmax(-1)) | ~clear
        log(f"[forward] 2-layer 5120-wide int8 {name}: max|gpu-cpu|/max|cpu| {rel:.2e} "
            f"(tol {rel_tol:.0e}); argmax agrees at {int(agree.sum())}/{agree.numel()} positions "
            f"({int(clear.sum())} with a top-2 gap > 2*max|gpu-cpu|, which must agree)")
        if rel > rel_tol or not bool(agree.all()):
            raise AssertionError(f"forward {name}: gpu and cpu logits disagree")
    del pt, pc


# ---------------------------------------------------------------- phase 4
def phase_main_path(results, reps: int):
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8_small_draft
    from llmspeculativesampling_tpu_torch.engine.autoregressive import autoregressive_generate
    from llmspeculativesampling_tpu_torch.engine.speculative import speculative_generate
    from llmspeculativesampling_tpu_torch.kernels.flash_decode import flash_decode_attention
    from llmspeculativesampling_tpu_torch.kernels.int8_matmul import int8_matmul

    card = card_line()
    t0 = time.perf_counter()
    bd, pd, bt, pt = synthetic_pair_int8_small_draft(device="cuda")
    torch.cuda.synchronize()
    log(f"[main] 13B-int8 target + 768x2 draft born on the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated ({card})")
    prompt = list(np.random.default_rng(0).integers(100, 31000, 64))
    kw = dict(eos_token_id=2, temperature=1.0, top_k=20, top_p=0.9, details=True, device="cuda")

    def gen(k):
        return torch.Generator(device="cuda").manual_seed(k)

    # warm-up (allocator, calibration of the phase split), untimed
    autoregressive_generate(bt, pt, prompt, 128, generator=gen(0), **kw)
    speculative_generate(bd, pd, bt, pt, prompt, 128, gamma=GAMMA, generator=gen(0), **kw)
    torch.cuda.synchronize()

    int8_matmul.launches = 0
    flash_decode_attention.launches = 0
    ar, sp, outs = [], [], []
    for k in range(1, reps + 1):
        out, d = autoregressive_generate(bt, pt, prompt, 128, generator=gen(k), **kw)
        ar.append(d)
        outs.append(out)
        out, d = speculative_generate(bd, pd, bt, pt, prompt, 128, gamma=GAMMA, generator=gen(k), **kw)
        sp.append(d)
        outs.append(out)
    torch.cuda.synchronize()
    launches = {"int8_matmul": int8_matmul.launches, "flash_decode": flash_decode_attention.launches}

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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        results[name]["launches"] = n
    results["main"] = dict(ar_tok_s=float(np.median(ar_rates)), spec_tok_s=float(np.median(sp_rates)),
                           acc_rate=float(np.mean(acc)))
    del bd, pd, bt, pt


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
    phase_device(_build)
    phase_int8_matmul(results)
    phase_flash_decode(results)
    phase_forward()
    phase_main_path(results, REPS)
    kernels = [
        {"name": "int8_matmul", "route": "cuda",
         "source": "llmspeculativesampling_tpu_torch/csrc/int8_matmul.cu",
         "replaces": "llmspeculativesampling_tpu/kernels/int8_matmul.py:75",
         "at": "one target verify forward: 281 calls at M=25"},
        {"name": "flash_decode", "route": "cuda",
         "source": "llmspeculativesampling_tpu_torch/csrc/flash_decode.cu",
         "replaces": "llmspeculativesampling_tpu/kernels/flash_decode.py:470",
         "at": "one target verify forward: 40 calls, Hkv=40, S_new=25, len=128, dense KV"},
    ]
    for k in kernels:
        r = results[k["name"]]
        k.update(launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                 library_ms=r["library_ms"])
    log(f"[smoke] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
