"""The roofline arithmetic on hand-worked B1, B2 and B3 shapes, the KV bytes
under grouped-query attention, and the FLOP count behind ``step_mfu``
against PyTorch's own count on a tiny OPT."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmarks import families, roofline

W13 = dict(hidden=5120, ffn=20480, layers=40, heads=40, kv_heads=40, head_dim=128, vocab=50272,
           family="opt")


def test_b1_verify_shape():
    # OPT-13B q projection at the single stream's verify, M = 9, K = N = 5120
    nbytes, flops = roofline.w8a16(9, 5120, 5120)
    assert nbytes == 9 * 5120 * 2 + 5120 * 5120 + 5120 * 4 + 9 * 5120 * 2 == 26_419_200
    assert flops == 2 * 9 * 5120 * 5120 == 471_859_200
    assert roofline.least_time(nbytes, flops) == pytest.approx(26_419_200 / 3.35e12)


def test_b1_prefill_is_bound_by_flops():
    # fc1 of OPT-30B at M = 1536: 2 * 1536 * 7168 * 28672 FLOPs
    nbytes, flops = roofline.w8a16(1536, 7168, 28672)
    assert flops == pytest.approx(631.3e9, rel=1e-3)
    assert roofline.least_time(nbytes, flops) == pytest.approx(flops / 989e12)


def test_b1_forward_and_pooled_bound():
    one = roofline.w8a16_forward_time(W13, 9)
    per_layer = sum(roofline.least_time(*roofline.w8a16(9, k, n))
                    for k, n in [(5120, 5120)] * 4 + [(5120, 20480), (20480, 5120)])
    assert one == pytest.approx(40 * per_layer)
    exact = roofline.w8a16_forward_time(W13, 64) + roofline.w8a16_forward_time(W13, 448)
    pooled = roofline.w8a16_forwards_time(W13, 2, 512)
    assert pooled <= exact and pooled == pytest.approx(2 * roofline.w8a16_forward_time(W13, 256))


def test_b2_bf16_and_b3_int8_bytes():
    # a bf16 position of OPT-13B: K and V, 40 heads of 128, 2 bytes each
    assert roofline.kv_bytes_per_position(W13, "bfloat16") == 2 * 40 * 128 * 2 == 20480
    # int8 codes plus one float32 scale a head and position
    assert roofline.kv_bytes_per_position(W13, "int8") == 2 * 40 * (128 + 4) == 10560
    # the verify of 9 new tokens after 128 cached ones, one layer
    assert roofline.attention_call_bytes(W13, "bfloat16", 128, 9) == (
        128 * 20480 + 9 * 40 * 128 * 2 * 4)
    assert roofline.attention_call_flops(W13, 128, 9) == 4 * 40 * 128 * (9 * 128 + 45)
    rows = [(128, 9), (1000, 5)]
    t = roofline.attention_forward_time(W13, "int8", rows)
    nbytes = sum(roofline.attention_call_bytes(W13, "int8", p, s) for p, s in rows)
    assert t == pytest.approx(40 * nbytes / 3.35e12)


def test_model_flops_match_pytorchs_count():
    cfg = {"model_type": "opt", "hidden_size": 256, "ffn_dim": 1024, "num_hidden_layers": 3, "num_attention_heads": 2,
           "vocab_size": 512, "max_position_embeddings": 64,
           "assumed": {"draft": {"hidden_size": 128, "ffn_dim": 512, "num_hidden_layers": 2,
                                 "num_attention_heads": 1}, "damp": 0.5, "embed_std": 0.5}}
    fam = families.family(cfg)
    pair = fam.build(cfg, 3, torch.device("cpu"))
    w = pair["widths"]["target"]
    s = 24
    seq = torch.arange(5, 5 + s)
    with FlopCounterMode(display=False) as fc:
        h = fam.reference.final_hidden(pair["target"], w, [seq])[0]
        fam.reference.logits(fam.reference.head_weight(pair["target"]), h)
    attention = w["layers"] * 2 * (2 * s * s * w["hidden"])  # scores and weighted sum, unmasked
    assert fc.get_total_flops() - attention == s * roofline.model_flops_per_token(w)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_gqa_shrinks_only_the_kv_bytes(kv_dtype):
    """Four kv heads under 32 query heads: K and V, cached and new, shrink by
    exactly 4 / 32; q, the output and the FLOPs do not."""
    full = dict(W13, heads=32, kv_heads=32)
    gqa = dict(full, kv_heads=4)
    assert roofline.kv_bytes_per_position(gqa, kv_dtype) * 32 == (
        roofline.kv_bytes_per_position(full, kv_dtype) * 4)
    q_out = 2 * 32 * 128 * 2
    assert roofline.new_token_bytes(gqa) - q_out == (roofline.new_token_bytes(full) - q_out) // 8
    prefix, s_new = 700, 9
    kv = lambda w: (prefix * roofline.kv_bytes_per_position(w, kv_dtype)  # noqa: E731
                    + s_new * 2 * w["kv_heads"] * 128 * 2)
    assert roofline.attention_call_bytes(gqa, kv_dtype, prefix, s_new) == (
        kv(full) // 8 + s_new * q_out)
    assert roofline.attention_call_flops(gqa, prefix, s_new) == (
        roofline.attention_call_flops(full, prefix, s_new))
