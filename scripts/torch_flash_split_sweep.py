#!/usr/bin/env python3
"""Time the port's flash-decode kernels (B2, B3) at each prefix split size,
on one GPU.

    python3 scripts/torch_flash_split_sweep.py

For the single-stream verify and AR-decode shapes (B2: B=1, Hkv=40, D=128,
a 256-position bf16 cache) and the serving target-verify and draft shapes
(B3: 16 rows, page 128, int8 pool, uniform and mixed lengths, as
chip_smoke.py makes them), it forces each split size of 32-256 positions
into ``kernels/flash_decode.plan`` and prints the kernel's device time per
call (CUDA-graph replay, inputs rotated past L2), the grid's block count
and the split size ``plan`` itself picks, with the card's name and power
limit. It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402
from llmspeculativesampling_tpu_torch.kernels import flash_decode as fd  # noqa: E402
from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (  # noqa: E402
    paged_flash_decode_attention)

SIZES = (32, 64, 128, 256)


def sweep(name, make, call, shape):
    """Time ``call`` on rotated inputs from ``make`` at each forced split size."""
    sets = smoke._rotated(make)
    chosen = fd.plan(*shape)
    real = fd.plan
    try:
        for ps in SIZES:
            def forced(bsz, hkv, rows, page, pages=1, ps=ps):
                p = real(bsz, hkv, rows, page, pages)
                size = min(ps, page)
                ppp = -(-page // size)
                return fd.Plan(size, ppp, pages * ppp, p.warps, p.tiles)

            fd.plan = forced
            t = smoke.time_ms(lambda i: call(sets[i % len(sets)]), 50)
            blocks = forced(*shape).blocks(*shape[:2])
            mark = " (plan)" if min(ps, shape[3]) == chosen.ps else ""
            smoke.log(f"[sweep] {name} ps={ps}{mark} blocks={blocks} kernel_us {t * 1e3:.2f}")
    finally:
        fd.plan = real


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_split_sweep: CUDA is not available", file=sys.stderr)
        return 1
    smoke.log(f"[sweep] {smoke.card_line()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for s_new, length in ((smoke.GAMMA + 1, 128), (1, 128), (1, 255)):
        lengths = torch.full((1,), length, dtype=torch.int32, device="cuda")

        def make(s_new=s_new):
            t = smoke._flash_inputs(gen, 1, 40, 40, s_new, 128, False, False)
            return [x.contiguous() if x is not None else None for x in t]

        sweep(f"B2 dense Hkv=40 S_new={s_new} len={length}", make,
              lambda st: fd.flash_decode_attention(*st[:5], lengths, st[5], scale=1.0),
              (1, 40, s_new, smoke.S_MAX, 1))
    for hkv, s_new in ((40, smoke.SERVE_GAMMA + 1), (6, 1)):
        for mix, p_max in (("uniform", 1), ("mixed", 6)):
            lens = smoke._uniform_lens(gen, smoke.ROWS) if mix == "uniform" else smoke.MIXED_LENS

            def make(lens=lens, hkv=hkv, s_new=s_new, p_max=p_max):
                t = smoke._paged_inputs(gen, lens, hkv, hkv, s_new, 128, smoke.PAGE, p_max, True)
                return [x.contiguous() if x is not None else None for x in t]

            sweep(f"B3 int8 Hkv={hkv} S_new={s_new} {mix}", make,
                  lambda st: paged_flash_decode_attention(*st[:8], scale=1.0, k_scales=st[8],
                                                          v_scales=st[9]),
                  (smoke.ROWS, hkv, s_new, smoke.PAGE, p_max))
    return 0


if __name__ == "__main__":
    sys.exit(main())
