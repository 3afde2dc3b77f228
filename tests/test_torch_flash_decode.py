"""The port's flash-decode attention (``kernels/flash_decode.py``) against the
JAX package's: its plain version vs ``flash_decode_ref`` over the cases of
``tests/test_flash_decode.py`` (odd lengths, length 0, a chunk boundary, a
full cache, GQA, a tree bias, per-row lengths, int8 KV, D in {32, 64, 96,
128}), and vs the Pallas kernel ``_flash_call`` in interpret mode.

Tolerances: fp32 inputs, both sides fp32 softmax and sums in different
orders: 2e-5. Against the Pallas kernel's int8 path, which runs bf16 MXU
math, 2e-2 (the JAX suite's own bound for that path)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.cache.kvcache import _quantize_kv as jax_quantize_kv
from llmspeculativesampling_tpu.kernels.flash_decode import flash_decode_attention as jax_flash
from llmspeculativesampling_tpu.kernels.flash_decode import flash_decode_ref as jax_ref
from llmspeculativesampling_tpu_torch.kernels import flash_decode as port

from _torch_port import to_np


def _mk(b, hq, hkv, s_new, s_max, d, seed=0, tree=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    vis = np.tril(np.ones((s_new, s_new), bool))
    if tree:
        vis &= rng.random((s_new, s_new)) > 0.3
        np.fill_diagonal(vis, True)
    bias = np.where(vis, 0.0, -1e30).astype(np.float32)
    bias = np.broadcast_to(bias[None], (b, s_new, s_new)).copy()
    return f(b, hq, s_new, d), f(b, hkv, s_new, d), f(b, hkv, s_new, d), f(b, hkv, s_max, d), \
        f(b, hkv, s_max, d), bias


def _both(q, kn, vn, kc, vc, lengths, bias, scale, quant=False):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    kw_j, kw_t = {}, {}
    if quant:
        kq, ks = jax_quantize_kv(jnp.asarray(kc))
        vq, vs = jax_quantize_kv(jnp.asarray(vc))
        kc, vc = np.asarray(kq), np.asarray(vq)
        kw_j = dict(k_scales=ks, v_scales=vs)
        kw_t = dict(k_scales=t(ks), v_scales=t(vs))
    ref = jax_ref(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
                  jnp.asarray(vc), jnp.asarray(lengths, jnp.int32), jnp.asarray(bias),
                  scale=scale, **kw_j)
    got = port.flash_decode_attention(t(q), t(kn), t(vn), t(kc), t(vc),
                                      torch.tensor(lengths, dtype=torch.int32), t(bias),
                                      scale=scale, **kw_t)
    return got, ref


@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize(
    "b,hq,hkv,s_new,length",
    [
        (1, 4, 4, 1, 0),      # first decode, no prefix
        (1, 4, 4, 5, 100),    # verify block, partial chunk
        (2, 8, 2, 3, 128),    # GQA, chunk boundary
        (1, 4, 4, 1, 256),    # full cache
        (2, 4, 4, 7, 37),     # odd length
        (1, 2, 2, 25, 231),   # the main path's verify block
    ],
)
def test_plain_matches_jax_ref(b, hq, hkv, s_new, length, d):
    q, kn, vn, kc, vc, bias = _mk(b, hq, hkv, s_new, 256, d)
    got, ref = _both(q, kn, vn, kc, vc, length, bias, 1.0 / d ** 0.5)
    assert got.shape == (b, hq, s_new, d)
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=2e-5, atol=2e-5)


def test_tree_bias_matches_jax_ref():
    q, kn, vn, kc, vc, bias = _mk(1, 4, 4, 6, 256, 64, seed=1, tree=True)
    got, ref = _both(q, kn, vn, kc, vc, 90, bias, 0.125)
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=2e-5, atol=2e-5)


def test_per_row_lengths_match_jax_ref():
    q, kn, vn, kc, vc, bias = _mk(3, 2, 2, 2, 256, 64, seed=2)
    got, ref = _both(q, kn, vn, kc, vc, [0, 64, 200], bias, 0.125)
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d,hq,hkv,length", [(64, 4, 2, 130), (128, 4, 4, 0), (128, 2, 2, 255)])
def test_int8_kv_matches_jax_ref(d, hq, hkv, length):
    q, kn, vn, kc, vc, bias = _mk(1, hq, hkv, 3, 256, d, seed=3)
    got, ref = _both(q, kn, vn, kc, vc, length, bias, 1.0 / d ** 0.5, quant=True)
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("quant,tol", [(False, 2e-4), (True, 2e-2)])
def test_plain_matches_pallas_interpret(quant, tol):
    q, kn, vn, kc, vc, bias = _mk(1, 4, 2, 3, 256, 64, seed=4)
    kw_j, kw_t = {}, {}
    if quant:
        kq, ks = jax_quantize_kv(jnp.asarray(kc))
        vq, vs = jax_quantize_kv(jnp.asarray(vc))
        kc, vc = np.asarray(kq), np.asarray(vq)
        kw_j = dict(k_scales=ks, v_scales=vs)
        kw_t = dict(k_scales=torch.from_numpy(np.array(ks)), v_scales=torch.from_numpy(np.array(vs)))
    out = jax_flash(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
                    jnp.asarray(vc), jnp.asarray(130, jnp.int32), jnp.asarray(bias),
                    scale=0.125, interpret=True, **kw_j)
    t = torch.from_numpy
    got = port.flash_decode_attention(t(q), t(kn), t(vn), t(kc), t(vc), 130, t(bias),
                                      scale=0.125, **kw_t)
    np.testing.assert_allclose(to_np(got), to_np(out), rtol=tol, atol=tol)


def test_wrapper_counts_no_launch_on_cpu():
    q, kn, vn, kc, vc, bias = _mk(1, 2, 2, 1, 128, 64, seed=5)
    before = port.flash_decode_attention.launches
    t = torch.from_numpy
    out = port.flash_decode_attention(t(q), t(kn), t(vn), t(kc), t(vc), 17, t(bias), scale=0.125)
    assert out.shape == (1, 2, 1, 64) and port.flash_decode_attention.launches == before


def test_gate():
    assert port.should_use(1) and port.should_use(32)
    assert not port.should_use(33)  # prefill takes the einsum path
    assert not port.should_use(8, mode="off")


@pytest.mark.parametrize("head_dim", [32, 80])
def test_forward_takes_the_flash_path_at_any_head_dim(monkeypatch, head_dim):
    """The gate has no head-size floor: a decode block goes to the flash
    function whatever D is (on the card a D the kernel lacks raises), and
    gives the einsum path's logits."""
    from llmspeculativesampling_tpu_torch.cache.kvcache import init_cache
    from llmspeculativesampling_tpu_torch.core.config import LlamaConfig
    from llmspeculativesampling_tpu_torch.models import llama

    calls = []
    real = port.flash_decode_attention
    monkeypatch.setattr(port, "flash_decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for mode in ("auto", "off"):
        cfg = LlamaConfig(vocab_size=64, hidden_size=2 * head_dim, intermediate_size=64,
                          num_layers=1, num_heads=2, num_kv_heads=2, dtype="float32", flash=mode)
        params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        cache = init_cache(1, 1, 2, 64, head_dim, torch.float32, device="cpu")
        _, cache = llama.forward(params, cfg, torch.arange(40)[None] % 64, cache)  # einsum
        out[mode], _ = llama.forward(params, cfg, torch.tensor([[5, 6]]), cache)
    assert len(calls) == 1  # the 2-token block under "auto"
    # fp32 both ways, softmax over the same scores in other orders
    np.testing.assert_allclose(to_np(out["auto"]), to_np(out["off"]), rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_rejects_what_the_kernel_cannot_take():
    q, kn, vn, kc, vc, bias = (torch.from_numpy(a) for a in _mk(1, 2, 2, 33, 128, 64, seed=6))
    lengths = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):  # new block longer than 32
        port._launch(q, kn, vn, kc, vc, lengths, bias, 0.125, None, None)
    with pytest.raises(ValueError):  # head_dim 48: no instantiation
        port._launch(q[..., :48], kn[..., :48], vn[..., :48], kc[..., :48], vc[..., :48],
                     lengths, bias, 0.125, None, None)
    with pytest.raises(ValueError):  # D not contiguous: the kernel reads rows of D
        port._launch(q[..., ::2], kn[..., ::2], vn[..., ::2], kc[..., :32], vc[..., :32],
                     lengths, bias, 0.125, None, None)


# ------------------------------------------------------------ split-KV plan

PATH_PLANS = [
    # (B, Hkv, G*S_new, page, pages) -> (ps, n_split, warps, tiles, blocks)
    ((1, 40, 25, 256, 1), (64, 4, 2, 1, 200)),     # B2, single-stream verify
    ((16, 40, 9, 128, 1), (128, 1, 1, 1, 1280)),   # B3, serving verify, uniform
    ((16, 40, 9, 128, 6), (128, 6, 1, 1, 4480)),   # B3, serving verify, mixed
]


@pytest.mark.parametrize("shape,want", PATH_PLANS)
def test_plan_grid_at_the_path_shapes(shape, want):
    p = port.plan(*shape)
    assert (p.ps, p.n_split, p.warps, p.tiles, p.blocks(*shape[:2])) == want
    assert p.blocks(*shape[:2]) <= port.MAX_BLOCKS_PER_SM * port.SMS or p.ps == shape[3]


@pytest.mark.parametrize("shape", [s for s, _ in PATH_PLANS] + [
    (1, 6, 1, 256, 1), (1, 6, 2, 256, 1), (16, 6, 1, 128, 1), (16, 6, 2, 128, 6),
    (1, 4, 100, 256, 1), (3, 8, 5, 256, 1), (8, 4, 36, 16, 8), (6, 4, 9, 32, 8), (2, 3, 7, 100, 3),
])
def test_plan_covers_every_position_once(shape):
    """Every position a row can hold lies in exactly one prefix split, in
    order; a paged split never crosses a page; the new block is the one
    split after them; the row tiles cover the G*S_new rows."""
    bsz, hkv, rows, page, pages = shape
    p = port.plan(*shape)
    ranges = port.split_ranges(p, page)
    assert len(ranges) == p.n_split and p.n_split == pages * p.ppp
    pos = [x for s, e in ranges for x in range(s, e)]
    assert pos == list(range(page * pages))
    assert all(s // page == (e - 1) // page and e - s <= p.ps for s, e in ranges)
    assert p.blocks(bsz, hkv) == bsz * hkv * p.tiles * (p.n_split + 1)
    assert 16 * p.warps * p.tiles >= rows > 16 * p.warps * (p.tiles - 1)
    assert 1 <= p.warps <= port.MAX_WARPS


def split_merge(q, kn, vn, kc, vc, lens, bias, scale, ranges, ks=None, vs=None):
    """The plain version split by split: per batch row, the partials of each
    live prefix split (cut at the row's length) and of the new block, merged
    with ``combine_ref``. kc/vc: [B, Hkv, span, D], the contiguous cache or
    the gathered pages."""
    bsz, hq, s_new, d = q.shape
    hkv = kc.shape[1]
    g = hq // hkv
    qg = q.float().reshape(bsz, hkv, g * s_new, d) * scale
    bias_rows = bias.float().repeat(1, g, 1)  # row g*S_new + s takes bias row s
    outs = []
    for b in range(bsz):
        parts = []
        for s, e in ranges:
            e = min(e, int(lens[b]))
            if s < e:
                parts.append(port.partial_ref(
                    qg[b:b + 1], kc[b:b + 1, :, s:e], vc[b:b + 1, :, s:e],
                    k_scales=None if ks is None else ks[b:b + 1, :, s:e],
                    v_scales=None if vs is None else vs[b:b + 1, :, s:e]))
        parts.append(port.partial_ref(qg[b:b + 1], kn[b:b + 1], vn[b:b + 1], bias_rows[b:b + 1]))
        outs.append(port.combine_ref(parts))
    return torch.cat(outs).reshape(bsz, hq, s_new, d)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,hq,hkv,s_new,lens", [
    (1, 2, 2, 25, [128]),            # the single-stream verify, scaled down
    (1, 2, 2, 25, [231]),            # S_max - S_new
    (1, 2, 2, 1, [0]),               # length 0: the new block alone
    (3, 8, 2, 5, [63, 64, 65]),      # split edges, GQA G=4
    (2, 16, 4, 25, [95, 256 - 25]),  # G=4 x S_new=25: 100 rows over two row tiles
])
def test_split_and_combine_match_the_plain_versions(b, hq, hkv, s_new, lens, quant):
    """The kernel's arithmetic on the CPU: the plain version over the plan's
    splits, merged in split order, against the port's and the JAX package's
    flash_decode_ref (fp32, sums in other orders: 2e-5)."""
    q, kn, vn, kc, vc, bias = _mk(b, hq, hkv, s_new, 256, 64, seed=7, tree=True)
    t = torch.from_numpy
    ks = vs = None
    kw_j, kw_t = {}, {}
    if quant:
        kq, ks_ = jax_quantize_kv(jnp.asarray(kc))
        vq, vs_ = jax_quantize_kv(jnp.asarray(vc))
        kc, vc = np.asarray(kq), np.asarray(vq)
        ks, vs = t(np.array(ks_)), t(np.array(vs_))
        kw_j, kw_t = dict(k_scales=ks_, v_scales=vs_), dict(k_scales=ks, v_scales=vs)
    p = port.plan(b, hkv, s_new * hq // hkv, 256)
    lengths = torch.tensor(lens, dtype=torch.int32)
    got = split_merge(t(q), t(kn), t(vn), t(kc), t(vc), lengths, t(bias), 0.125,
                      port.split_ranges(p, 256), ks, vs)
    ref_t = port.flash_decode_ref(t(q), t(kn), t(vn), t(kc), t(vc), lengths, t(bias), scale=0.125,
                                  **kw_t)
    ref_j = jax_ref(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
                    jnp.asarray(vc), jnp.asarray(lens, jnp.int32), jnp.asarray(bias), scale=0.125,
                    **kw_j)
    np.testing.assert_allclose(to_np(got), to_np(ref_t), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(to_np(got), np.asarray(ref_j), rtol=2e-5, atol=2e-5)
