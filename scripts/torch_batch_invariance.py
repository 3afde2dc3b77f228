#!/usr/bin/env python3
"""Does a request's prefill on the card depend on the requests that share
its admission batch?

    python3 scripts/torch_batch_invariance.py

``PagedEngine`` prefills the requests it admits together as one forward of
M = requests x 64 rows, and B1's plan (``kernels/int8_matmul.py::plan``)
picks its split of K from M unless the call asks for a batch-invariant
plan, as the admission prefill does. On the 13B-shaped int8 target (born on
the card from seed 0) this prints, bit for bit:

1. B1 alone: rows 0..63 of an [M, K] product for M = 128..512 against the
   same 64 rows as an M=64 call, for each prefill projection shape, with
   each M's split of K, planned from M and planned batch-invariant;
2. the target's prefill logits of one 64-token prompt alone (M=64) and as
   row 0 of a batch of 8 prompts (M=512): through a contiguous cache (B1
   planned from M) and through a paged int8 pool as the admission prefill
   runs it (``paged_prefill=True``: B1 planned batch-invariant).

Every line carries the card's name and power limit. It imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import card_line  # noqa: E402


def log(*a):
    print(*a, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_batch_invariance: CUDA is not available", file=sys.stderr)
        return 1
    import importlib

    from llmspeculativesampling_tpu_torch.cache.paged import init_paged_cache
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8_small_draft
    from llmspeculativesampling_tpu_torch.models.llama import unstack_layers

    b1 = importlib.import_module("llmspeculativesampling_tpu_torch.kernels.int8_matmul")

    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for k, n in ((5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000)):
        w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8, device="cuda")
        s = torch.rand((n,), generator=gen, device="cuda") / (73.0 * k ** 0.5)
        x = torch.randn((512, k), generator=gen, device="cuda").to(torch.bfloat16)
        alone = b1.int8_matmul(x[:64], w, s)
        for inv in (False, True):
            same = []
            for m in (128, 192, 256, 320, 448, 512):
                rows = b1.int8_matmul(x[:m], w, s, batch_invariant=inv)[:64]
                same.append(f"M={m} (ksplit {b1.plan(m, k, n, inv)[1]}): "
                            f"{'equal' if torch.equal(rows, alone) else 'differ'}")
            log(f"[B1] K={k} N={n} {'batch-invariant plan' if inv else 'plan from M'}: rows "
                f"0..63 vs the M=64 call (ksplit {b1.plan(64, k, n)[1]}): {'; '.join(same)} ({card})")
        del w, x

    _, _, bt, pt = synthetic_pair_int8_small_draft(device="cuda")
    pt = unstack_layers(pt)
    c = bt.cfg
    prompts = torch.as_tensor(np.random.default_rng(1).integers(100, 31000, (8, 64)),
                              dtype=torch.long, device="cuda")

    def contiguous(rows):
        logits, _ = bt.forward(pt, c, prompts[:rows], bt.make_cache(rows, 128, device="cuda"))
        return logits[0].float()

    def paged(rows):
        cache = init_paged_cache(c.num_layers, rows, c.num_kv_heads, 128, c.head_dim, rows, 1,
                                 c.torch_dtype, quant=True, device="cuda")
        cache.block_tables[:, 0] = torch.arange(rows, dtype=torch.int32, device="cuda")
        logits, _ = bt.forward(pt, c, prompts[:rows], cache, paged_prefill=True)
        return logits[0].float()

    for what, fn in (("contiguous cache, B1 planned from M", contiguous),
                     ("paged admission prefill, B1 planned batch-invariant", paged)):
        a, b = fn(1), fn(8)
        d = float((a - b).abs().max())
        same = ("bit-identical" if torch.equal(a, b) else
                f"differ, max |diff| {d:.3e} of max |logit| {float(a.abs().max()):.3e}")
        log(f"[prefill] {what}: prompt 0 alone (M=64) vs in a batch of 8 (M=512): {same}; "
            f"last-position argmax {int(a[-1].argmax())} vs {int(b[-1].argmax())} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
