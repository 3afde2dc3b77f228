"""The work an operation needs, whatever implements it, and the chip's peaks.

Bytes count each input byte once and each output byte once; FLOPs count a
product of ``[M, K]`` and ``[K, N]`` as ``2 * M * K * N``. The least time of
a call is ``max(bytes / BYTES_PER_S, flops / FLOPS_PER_S)``. Peaks are the
published dense rates of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit); the W8A16 product runs its MMA in bf16 (the int8 weights are
widened to bf16 in registers), so its peak is the bf16 one.
"""

from __future__ import annotations

from benchmarks import families

BYTES_PER_S = 3.35e12
FLOPS_PER_S = 989e12  # bf16 dense

BF16 = 2
F32 = 4
INT8 = 1


def least_time(nbytes: float, flops: float) -> float:
    return max(nbytes / BYTES_PER_S, flops / FLOPS_PER_S)


# --------------------------------------------------------------- B1: W8A16
def w8a16(m: float, k: int, n: int) -> tuple:
    """(bytes, flops) of ``x [m, k] bf16 @ (q [k, n] int8 * s [n] f32)`` into
    ``[m, n]`` bf16: x, the codes and the scales read once, the output
    written once."""
    nbytes = m * k * BF16 + k * n * INT8 + n * F32 + m * n * BF16
    return nbytes, 2.0 * m * k * n


def w8a16_forward_time(w: dict, m: float) -> float:
    """Least time of the W8A16 calls of one forward of ``m`` token rows: each
    layer's int8 products, as the model's family counts them
    (``projections``); the head is a bf16 product, not B1."""
    per_layer = sum(least_time(*w8a16(rows, k, n))
                    for rows, k, n in families.of(w).projections(w, m))
    return w["layers"] * per_layer


def w8a16_forwards_time(w: dict, forwards: int, m_total: float) -> float:
    """A lower bound of the least time of ``forwards`` forwards whose rows sum
    to ``m_total``, when how the rows split is not known: the least time of
    one forward is convex in its rows, so equal rows bound the sum from
    below."""
    if forwards <= 0:
        return 0.0
    return forwards * w8a16_forward_time(w, m_total / forwards)


# --------------------------------------------------- B2 / B3: decode attention
def kv_bytes_per_position(w: dict, kv_dtype: str) -> float:
    """Bytes of one cached position of one layer, K and V over every kv head
    (``kv_heads``): bf16, or int8 codes with one float32 scale a head and
    position."""
    per = w["head_dim"] * BF16 if kv_dtype == "bfloat16" else w["head_dim"] * INT8 + F32
    return 2 * w["kv_heads"] * per


def new_token_bytes(w: dict) -> int:
    """Bytes of one new token of one layer's short-block attention, in bf16:
    its q read and its output written over every query head, its k and v
    read over every kv head."""
    return (2 * w["heads"] + 2 * w["kv_heads"]) * w["head_dim"] * BF16


def attention_call_bytes(w: dict, kv_dtype: str, prefix: float, s_new: int) -> float:
    """Bytes one layer's short-block attention needs for one row: the cached
    prefix's K and V read once, and the new block's tokens."""
    return prefix * kv_bytes_per_position(w, kv_dtype) + s_new * new_token_bytes(w)


def attention_call_flops(w: dict, prefix: float, s_new: int) -> float:
    """FLOPs of one row's scores and weighted sum: each new token against
    the prefix and the new block up to itself."""
    keys = s_new * prefix + s_new * (s_new + 1) / 2
    return 4.0 * w["heads"] * w["head_dim"] * keys


def attention_forward_time(w: dict, kv_dtype: str, rows) -> float:
    """Least time of one forward's short-block attention, one call a layer
    over every row: ``rows`` holds each live row's (prefix, new tokens); a
    row that is not live needs nothing."""
    nbytes = sum(attention_call_bytes(w, kv_dtype, p, s) for p, s in rows)
    flops = sum(attention_call_flops(w, p, s) for p, s in rows)
    return w["layers"] * least_time(nbytes, flops)


# ------------------------------------------------------------- the whole model
def model_flops_per_token(w: dict) -> float:
    """Matmul FLOPs one token needs through one model: every layer's int8
    products at one row (``projections``) and the head. Attention's scores
    and weighted sums are left out (under 2 % at these lengths), so a share
    of the peak built on this count is never over-stated."""
    per_layer = sum(2.0 * rows * k * n for rows, k, n in families.of(w).projections(w, 1))
    return w["layers"] * per_layer + 2.0 * w["hidden"] * w["vocab"]
