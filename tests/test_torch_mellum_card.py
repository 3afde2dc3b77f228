"""Card tests of the kernels Mellum 2 brought: B4 (the grouped W8A16 expert
product and its alignment) and the window start of B2/B3, each against its
plain version at the benchmark cell's shapes, with times beside their
bounds. They skip without a CUDA card:

    python -m pytest tests/test_torch_mellum_card.py --noconftest -m card -s

(the file imports no JAX). Tolerances: a B4 output row is the same fp32
sum of exact products as the plain version's, in another order, then
rounded once to bf16 (2**-8 relative) or kept in fp32; B2/B3 compare bf16
contexts from fp32 softmax sums taken in another order (2e-2 absolute on
values of order 1, as the repository's other B2/B3 checks)."""

import math

import pytest
import torch

from llmspeculativesampling_tpu_torch.kernels import moe_matmul
from llmspeculativesampling_tpu_torch.kernels.flash_decode import flash_decode_attention
from llmspeculativesampling_tpu_torch.kernels.paged_flash_decode import (
    paged_flash_decode_attention,
)
from llmspeculativesampling_tpu_torch.models.llama import block_bias

H, F, E, K_TOP = 2304, 896, 64, 8  # Mellum2-12B-A2.5B's widths
HKV, G, D, WINDOW = 4, 8, 128, 1024
BYTES_PER_S, FLOPS_PER_S = 3.35e12, 989e12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: `python -m pytest tests/test_torch_mellum_card.py "
                    "--noconftest -m card -s` on a GPU machine")
    return torch.device("cuda", 0)


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _experts(gen, k, n, dev):
    q = torch.randint(-127, 128, (E, k, n), generator=gen, dtype=torch.int8, device=dev)
    s = (0.8 + 0.4 * torch.rand((E, n), generator=gen, device=dev)) / (73 * math.sqrt(k))
    return q, s


@pytest.mark.card
@pytest.mark.parametrize("tokens", [320, 2048])
def test_b4_against_plain(tokens, card):
    """B4 at the verify (64 rows x 5 tokens) and at a 2,048-token prefill:
    the alignment, and both products, against the plain versions pair by
    pair; then their times against the least time of the bytes and FLOPs."""
    gen = torch.Generator(device=card).manual_seed(tokens)
    ids = torch.argsort(torch.rand((tokens, E), generator=gen, device=card), dim=-1)[:, :K_TOP]
    x = torch.randn((tokens, H), generator=gen, device=card).to(torch.bfloat16)
    wgu, sgu = _experts(gen, H, 2 * F, card)
    wdn, sdn = _experts(gen, F, H, card)
    mt = moe_matmul.row_tile(tokens * K_TOP, E)
    totals = torch.zeros(E, dtype=torch.int64, device=card)
    r = moe_matmul.expert_align(ids, E, mt, totals)
    r_ref = moe_matmul.expert_align_ref(ids.cpu(), E, mt)
    assert int(r.live) == int(r_ref.live)
    assert torch.equal(r.tile_expert.cpu(), r_ref.tile_expert)
    assert torch.equal(totals.cpu(), torch.bincount(ids.reshape(-1).cpu(), minlength=E))
    slots = r.inv.long().cpu()
    assert torch.equal(torch.sort(slots).values, torch.sort(r_ref.inv.long()).values)
    assert torch.equal(r.rows.cpu()[slots], (torch.arange(tokens * K_TOP) // K_TOP).int())

    xs = x.index_select(0, r.rows)
    gu = moe_matmul.grouped_int8_matmul(xs, wgu, sgu, r)
    gu_ref = moe_matmul.grouped_int8_matmul_ref(x.cpu().index_select(0, r_ref.rows), wgu.cpu(),
                                                sgu.cpu(), r_ref)
    a, b = gu.cpu()[slots].float(), gu_ref[r_ref.inv.long()].float()
    assert (a - b).abs().max() <= 2 ** -7 * b.abs().max(), (a - b).abs().max()
    act = torch.nn.functional.silu(gu[:, :F].float()).to(torch.bfloat16) * gu[:, F:]
    dn = moe_matmul.grouped_int8_matmul(act, wdn, sdn, r, out_dtype=torch.float32)
    dn_ref = moe_matmul.grouped_int8_matmul_ref(act.cpu(), wdn.cpu(), sdn.cpu(),
                                                r._replace(tile_expert=r.tile_expert.cpu(),
                                                           live=r.live.cpu()),
                                                out_dtype=torch.float32)
    live = int(r.live) * mt
    err = (dn.cpu()[:live] - dn_ref[:live]).abs().max()
    assert err <= 1e-5 * dn_ref[:live].abs().max() + 1e-6, err

    touched = int((torch.bincount(ids.reshape(-1), minlength=E) > 0).sum())
    pairs = tokens * K_TOP
    for name, xin, w, s, k, n, od in (("gate_up", xs, wgu, sgu, H, 2 * F, None),
                                      ("down", act, wdn, sdn, F, H, torch.float32)):
        ms = _ms(lambda: moe_matmul.grouped_int8_matmul(xin, w, s, r, out_dtype=od))
        nbytes = touched * (k * n + 4 * n) + pairs * k * 2 + pairs * n * (4 if od else 2)
        flops = 2.0 * pairs * k * n
        bound = max(nbytes / BYTES_PER_S, flops / FLOPS_PER_S) * 1e3
        plain = _ms(lambda: moe_matmul.grouped_int8_matmul_ref(
            xin[:live].cpu(), w.cpu(), s.cpu(), r._replace(tile_expert=r.tile_expert.cpu(),
                                                            live=r.live.cpu()), od), reps=1)
        print(f"[b4 {name} tokens={tokens} mt={mt}] {ms:.4f} ms, bound {bound:.4f} ms "
              f"({'bytes' if nbytes / BYTES_PER_S > flops / FLOPS_PER_S else 'flops'}), "
              f"share {100 * bound / ms:.1f} %, plain (CPU) {plain:.1f} ms")
    ms = _ms(lambda: moe_matmul.expert_align(ids, E, mt))
    print(f"[b4 align tokens={tokens}] {ms:.4f} ms")


def _pool(gen, n_blocks, page, dev):
    q = torch.randint(-127, 128, (n_blocks, HKV, page, D), generator=gen, dtype=torch.int8,
                      device=dev)
    s = 0.01 + 0.02 * torch.rand((n_blocks, HKV, page), generator=gen, device=dev)
    return q, s


@pytest.mark.card
@pytest.mark.parametrize("window", [0, WINDOW])
def test_window_b2_b3_against_plain(window, card):
    """B3 (int8 pool, shuffled tables) and B2 (bf16 and int8 caches) at
    Mellum's heads, a verify block of 5, lengths on both sides of the
    window and on page edges, with and without the window; then B3 at the
    cell's 64 rows x ~1.5k positions."""
    gen = torch.Generator(device=card).manual_seed(window + 1)
    lens = torch.tensor([2000, 1500, 900, 1024, 1025, 2817, 128, 5], dtype=torch.int32, device=card)
    b, s_new, page = lens.numel(), 5, 128
    pages = 23
    q = torch.randn((b, HKV * G, s_new, D), generator=gen, device=card).to(torch.bfloat16)
    kn = torch.randn((b, HKV, s_new, D), generator=gen, device=card).to(torch.bfloat16)
    vn = torch.randn((b, HKV, s_new, D), generator=gen, device=card).to(torch.bfloat16)
    bias = block_bias(s_new, None, b, card, window or None)
    kq, ks = _pool(gen, b * pages + 1, page, card)
    vq, vs = _pool(gen, b * pages + 1, page, card)
    tables = torch.randperm(b * pages, generator=torch.Generator().manual_seed(3)).view(b, pages)
    tables = tables.int().to(card)
    scale = 1 / math.sqrt(D)
    out = paged_flash_decode_attention(q, kn, vn, kq, vq, tables, lens, bias, scale=scale,
                                       k_scales=ks, v_scales=vs, window=window)
    ref = paged_flash_decode_attention(q.cpu(), kn.cpu(), vn.cpu(), kq.cpu(), vq.cpu(),
                                       tables.cpu(), lens.cpu(), bias.cpu(), scale=scale,
                                       k_scales=ks.cpu(), v_scales=vs.cpu(), window=window)
    assert (out.cpu().float() - ref.float()).abs().max() < 2e-2
    s_max = pages * page
    kc = torch.randn((b, HKV, s_max, D), generator=gen, device=card).to(torch.bfloat16)
    vc = torch.randn((b, HKV, s_max, D), generator=gen, device=card).to(torch.bfloat16)
    out = flash_decode_attention(q, kn, vn, kc, vc, lens, bias, scale=scale, window=window)
    ref = flash_decode_attention(q.cpu(), kn.cpu(), vn.cpu(), kc.cpu(), vc.cpu(), lens.cpu(),
                                 bias.cpu(), scale=scale, window=window)
    assert (out.cpu().float() - ref.float()).abs().max() < 2e-2
    kq8, ks8 = _pool(gen, b, s_max, card)
    vq8, vs8 = _pool(gen, b, s_max, card)
    out = flash_decode_attention(q, kn, vn, kq8, vq8, lens, bias, scale=scale, k_scales=ks8,
                                 v_scales=vs8, window=window)
    ref = flash_decode_attention(q.cpu(), kn.cpu(), vn.cpu(), kq8.cpu(), vq8.cpu(), lens.cpu(),
                                 bias.cpu(), scale=scale, k_scales=ks8.cpu(),
                                 v_scales=vs8.cpu(), window=window)
    assert (out.cpu().float() - ref.float()).abs().max() < 2e-2

    # the cell's verify: 64 rows at ~1.5k positions, B3 over the int8 pool
    rows = 64
    gl = torch.Generator().manual_seed(5)
    lens = torch.randint(600, 2800, (rows,), generator=gl, dtype=torch.int32).to(card)
    kq, ks = _pool(gen, rows * pages + 1, page, card)
    vq, vs = _pool(gen, rows * pages + 1, page, card)
    tables = torch.randperm(rows * pages, generator=gl).view(rows, pages).int().to(card)
    q = torch.randn((rows, HKV * G, s_new, D), generator=gen, device=card).to(torch.bfloat16)
    kn = torch.randn((rows, HKV, s_new, D), generator=gen, device=card).to(torch.bfloat16)
    vn = torch.randn((rows, HKV, s_new, D), generator=gen, device=card).to(torch.bfloat16)
    bias = block_bias(s_new, None, rows, card, window or None)
    ms = _ms(lambda: paged_flash_decode_attention(q, kn, vn, kq, vq, tables, lens, bias,
                                                  scale=scale, k_scales=ks, v_scales=vs,
                                                  window=window))
    seen = lens.long().clamp(max=(window - 1) if window else 1 << 30)
    nbytes = float(seen.sum()) * 2 * HKV * (D + 4) + rows * s_new * (2 * HKV * G + 2 * HKV) * D * 2
    flops = 4.0 * HKV * G * D * float((seen * s_new).sum())
    bound = max(nbytes / BYTES_PER_S, flops / FLOPS_PER_S) * 1e3
    print(f"[b3 window={window} 64 x 4 x 8 x 5 int8, mean len {float(lens.float().mean()):.0f}] "
          f"{ms:.4f} ms, bound {bound:.4f} ms, share {100 * bound / ms:.1f} %")
