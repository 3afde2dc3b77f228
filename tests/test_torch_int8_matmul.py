"""The port's W8A16 matmul (``kernels/int8_matmul.py``) against the JAX
package's: its plain version vs ``int8_matmul_ref`` and vs the Pallas
kernel ``_int8_matmul_2d`` in interpret mode, on the same numpy inputs.

Tolerances: with fp32 x both sides sum exact bf16(x) x int8 products in
fp32 in different orders, so 1e-5 of the largest output; with bf16 x the
result is rounded to bf16 as well, so two bf16 ulps (2**-7) relative plus
1e-3 of the largest output for sums that cancel."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.kernels.int8_matmul import _int8_matmul_2d, int8_matmul_ref

from _torch_port import to_np

# the module: the package attribute ``kernels.int8_matmul`` is the function, as in JAX
port = importlib.import_module("llmspeculativesampling_tpu_torch.kernels.int8_matmul")


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.uniform(0.8, 1.2, n) / (73.0 * np.sqrt(k))).astype(np.float32)
    return x, w, s


def _check(got, ref, dtype):
    got, ref = to_np(got), to_np(ref)
    top = np.max(np.abs(ref))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * top)
    else:
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-3 * top)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (2, 128, 384), (25, 512, 256), (64, 256, 512), (37, 96, 48)])
def test_plain_matches_jax_ref(m, k, n, dtype):
    x, w, s = _inputs(m, k, n)
    ref = int8_matmul_ref(jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(s))
    tdt = getattr(torch, dtype)
    got = port.int8_matmul_ref(torch.from_numpy(x).to(tdt), torch.from_numpy(w), torch.from_numpy(s))
    assert got.dtype == tdt
    _check(got, ref, dtype)


@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (25, 256, 384), (64, 512, 256)])
def test_plain_matches_pallas_interpret(m, k, n):
    x, w, s = _inputs(m, k, n, seed=1)
    ref = _int8_matmul_2d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(s),
                          block_m=16, block_n=128, block_k=128, interpret=True)
    got = port.int8_matmul_ref(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                               torch.from_numpy(s))
    _check(got, ref, "bfloat16")


def test_wrapper_on_cpu_uses_plain_version_and_keeps_lead_dims():
    x, w, s = _inputs(6, 128, 64, seed=2)
    xt = torch.from_numpy(x).reshape(2, 3, 128)
    before = port.int8_matmul.launches
    out = port.int8_matmul(xt, torch.from_numpy(w), torch.from_numpy(s))
    assert out.shape == (2, 3, 64) and out.dtype == torch.float32
    assert port.int8_matmul.launches == before  # no kernel on the CPU
    ref = port.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s))
    assert torch.equal(out.reshape(6, 64), ref)


def _max_ksplit(m, k, n):
    """The most K ranges the workspace cap admits (1 always)."""
    chunks = -(-k // port.BK)
    return max([1] + [ks for ks in range(2, chunks + 1) if ks * m * n * 4 <= port.WS_CAP])


@pytest.mark.parametrize("m,k,n", [(1, 5120, 5120), (25, 5120, 13824), (25, 13824, 5120),
                                   (64, 5120, 32000), (2, 768, 768), (1, 3072, 768), (25, 96, 48)])
def test_plan_covers_k_and_fills_the_card(m, k, n):
    mt, ksplit, cps = port.plan(m, k, n)
    m_tiles = -(-m // port.MTS[-1])
    assert mt in port.MTS and mt >= -(-m // m_tiles)  # the wgmma N covers the row tile
    assert mt == min(t for t in port.MTS if t >= -(-m // m_tiles))  # and is the smallest that does
    chunks = -(-k // port.BK)
    assert (ksplit - 1) * cps < chunks <= ksplit * cps  # every chunk in exactly one split
    tiles = -(-n // port.BN) * -(-m // mt)
    assert tiles * ksplit >= min(port.SMS, tiles * _max_ksplit(m, k, n))  # a block per SM if possible
    assert ksplit == 1 or ksplit * m * n * 4 <= port.WS_CAP  # the partials stay under the L2 cap


TARGET_KN = [(5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000)]
DRAFT_KN = [(768, 768), (768, 3072), (3072, 768), (768, 32000)]


@pytest.mark.parametrize("model", ["target", "draft"])
@pytest.mark.parametrize("m", [1, 2, 16, 25, 32, 64, 128, 144, 448, 512])
def test_plan_reads_weights_once_up_to_256_rows(m, model):
    """Every M the single-stream and serving paths launch: up to 256 rows
    one row tile (each weight byte read once), above it ceil(M/256) tiles."""
    for k, n in TARGET_KN if model == "target" else DRAFT_KN:
        mt, ksplit, _ = port.plan(m, k, n)
        weight_reads = -(-m // mt)
        assert weight_reads == (1 if m <= 256 else -(-m // 256))
        assert ksplit >= 1 and mt in port.MTS


def test_kernel_wrapper_rejects_what_the_kernel_cannot_take():
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    s = torch.ones(32)
    with pytest.raises(NotImplementedError):
        port._launch(x, torch.zeros((64, 32), dtype=torch.float8_e4m3fn), s, torch.bfloat16)
    with pytest.raises(ValueError):
        port._launch(x[:, :60], torch.zeros((60, 32), dtype=torch.int8), s, torch.bfloat16)
    with pytest.raises(TypeError):
        port._launch(x.half(), torch.zeros((64, 32), dtype=torch.int8), s, torch.float16)


@pytest.mark.parametrize("model", ["target", "draft"])
def test_batch_invariant_plan_splits_k_from_k_and_n_alone(model):
    """The admission prefill's M is 64 x the requests admitted together; a
    batch-invariant plan gives every such M the M=64 split of K (so a row's
    sums do not depend on the batch) and still covers M with its row tile."""
    for k, n in TARGET_KN if model == "target" else DRAFT_KN:
        ref = port.plan(64, k, n)
        assert port.plan(64, k, n, True) == ref
        for m in range(64, 513, 64):
            mt, ksplit, cps = port.plan(m, k, n, True)
            assert (ksplit, cps) == ref[1:]
            assert mt == port.plan(m, k, n)[0]


def test_paged_prefill_plans_every_w8a16_call_batch_invariant(monkeypatch):
    """The forward asks B1 for the batch-invariant plan on the admission
    prefill (``paged_prefill=True``) and only there."""
    from llmspeculativesampling_tpu_torch.cache.paged import init_paged_cache
    from llmspeculativesampling_tpu_torch.core.synthetic import synthetic_pair_int8
    from llmspeculativesampling_tpu_torch.models import linear

    _, _, bt, pt = synthetic_pair_int8(hidden_size=128, intermediate_size=256, num_layers=2,
                                       num_heads=2, vocab_size=256, device="cpu")
    seen = []
    real = linear.int8_matmul
    monkeypatch.setattr(linear, "int8_matmul",
                        lambda x, q, s, inv=False: seen.append(inv) or real(x, q, s, inv))
    c = bt.cfg
    cache = init_paged_cache(c.num_layers, 4, c.num_kv_heads, 32, c.head_dim, 2, 2, device="cpu")
    cache.block_tables[:, 0] = torch.tensor([0, 1], dtype=torch.int32)
    toks = torch.arange(10, 26).reshape(2, 8)
    _, cache = bt.forward(pt, c, toks, cache, paged_prefill=True)
    assert len(seen) == 2 * 7 + 1 and all(seen)
    seen.clear()
    bt.forward(pt, c, toks[:, :2], cache)
    assert len(seen) == 2 * 7 + 1 and not any(seen)
