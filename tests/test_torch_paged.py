"""The port's paged KV cache (``cache/paged.py``), paged attention
(``kernels/paged_flash_decode.py``, its plain version on the CPU) and the
paged forward of ``models/llama.py`` against the JAX package.

Tolerances:
* paged attention, fp32 pools: 2e-4 (the same fp32 math in other orders);
* paged attention, int8 pools against JAX's interpret-mode kernel: 2e-2,
  the JAX test's own (its int8 branch runs bf16 MXU math);
* paged forward, fp32: 2e-4 relative to the largest logit; the pools the
  two forwards write must agree to 1e-5;
* paged forward, int8 pools: 3e-2, the JAX test's own: the JAX CPU forward
  reads the new block back through the int8 pool (its gather path) where
  the port's decode path attends to it unquantized, as the kernel does.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmspeculativesampling_tpu.cache import paged as jpaged
from llmspeculativesampling_tpu.cache.kvcache import _quantize_kv as j_quantize_kv
from llmspeculativesampling_tpu.core.config import LlamaConfig as JCfg
from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.kernels import flash_decode as jfd
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu_torch.cache import paged as tpaged
from llmspeculativesampling_tpu_torch.cache.kvcache import _quantize_kv as t_quantize_kv
from llmspeculativesampling_tpu_torch.core.config import LlamaConfig as TCfg
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.kernels import paged_flash_decode as tpfd
from llmspeculativesampling_tpu_torch.models import llama as tl

from _torch_port import rel_err, to_np, to_port
from test_torch_flash_decode import split_merge


def _bias(b, s_new, tree=False, seed=0):
    vis = np.tril(np.ones((s_new, s_new), bool))
    if tree:
        vis &= np.random.default_rng(seed).random((s_new, s_new)) > 0.3
        vis |= np.eye(s_new, dtype=bool)
    return np.broadcast_to(np.where(vis, 0.0, -1e30).astype(np.float32), (b, s_new, s_new)).copy()


def _attn_inputs(seed, b, hq, hkv, s_new, d, n_blocks, page):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return f(b, hq, s_new, d), f(b, hkv, s_new, d), f(b, hkv, s_new, d), \
        f(n_blocks, hkv, page, d), f(n_blocks, hkv, page, d)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_matches_jax_interpret_kernel(quant):
    """d=128, page 128 (tests/test_paged.py's case): the port against JAX's
    paged kernel in interpret mode, interleaved per-row tables."""
    b, hq, hkv, s_new, d, page = 2, 8, 4, 5, 128, 128
    q, kn, vn, kp, vp = _attn_inputs(3, b, hq, hkv, s_new, d, 8, page)
    tables = np.asarray([[0, 2, 4], [5, 1, 3]], np.int32)
    lengths = np.asarray([200, 130], np.int32)
    bias = _bias(b, s_new)
    scale = d ** -0.5
    t = torch.from_numpy
    if quant:
        kq, ks = j_quantize_kv(jnp.asarray(kp))
        vq, vs = j_quantize_kv(jnp.asarray(vp))
        jout = jfd.paged_flash_decode_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), kq, vq, jnp.asarray(tables),
            jnp.asarray(lengths), jnp.asarray(bias), scale=scale, k_scales=ks, v_scales=vs,
            interpret=True)
        tout = tpfd.paged_flash_decode_attention(
            t(q), t(kn), t(vn), t(np.asarray(kq)), t(np.asarray(vq)), t(tables), t(lengths),
            t(bias), scale=scale, k_scales=t(np.asarray(ks)), v_scales=t(np.asarray(vs)))
        tol = 2e-2
    else:
        jout = jfd.paged_flash_decode_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(bias), scale=scale,
            interpret=True)
        tout = tpfd.paged_flash_decode_attention(
            t(q), t(kn), t(vn), t(kp), t(vp), t(tables), t(lengths), t(bias), scale=scale)
        tol = 2e-4
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), rtol=tol, atol=tol)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page,s_new,hq,hkv,d,tree", [
    (16, 9, 4, 4, 64, False),   # verify-sized block
    (16, 1, 6, 6, 32, False),   # decode
    (32, 2, 8, 2, 128, True),   # the draft's two-token re-feed, GQA, tree bias
    (32, 5, 4, 4, 96, False),
])
def test_paged_attention_matches_jax_gather_oracle(page, s_new, hq, hkv, d, tree, quant):
    """Small pages (any page size runs on Hopper): the port against JAX's
    ``flash_decode_ref`` over the gathered view. Multi-page shuffled tables,
    lengths ending mid-page and on a page edge, and a row of length 0 with
    an all-sentinel table."""
    b, p, n_blocks = 4, 6, 20
    q, kn, vn, kp, vp = _attn_inputs(page + s_new, b, hq, hkv, s_new, d, n_blocks, page)
    perm = np.random.default_rng(page).permutation(n_blocks)
    tables = np.full((b, p), n_blocks, np.int32)  # sentinel = n_blocks
    tables[0, :6] = perm[:6]
    tables[1, :3] = perm[6:9]
    tables[2, :5] = perm[9:14]
    lengths = np.asarray([6 * page - 3, 3 * page, 0, 4 * page + 7], np.int32)
    tables[3, :5] = perm[14:19]
    bias = _bias(b, s_new, tree=tree, seed=page)
    scale = d ** -0.5
    t = torch.from_numpy
    if quant:
        kq, ks = t_quantize_kv(t(kp))
        vq, vs = t_quantize_kv(t(vp))
        k_deq, v_deq = to_np(kq) * to_np(ks)[..., None], to_np(vq) * to_np(vs)[..., None]
        tout = tpfd.paged_flash_decode_attention(
            t(q), t(kn), t(vn), kq, vq, t(tables), t(lengths), t(bias), scale=scale,
            k_scales=ks, v_scales=vs)
    else:
        k_deq, v_deq = kp, vp
        tout = tpfd.paged_flash_decode_attention(
            t(q), t(kn), t(vn), t(kp), t(vp), t(tables), t(lengths), t(bias), scale=scale)

    def gather(pool):
        g = pool[np.minimum(tables, n_blocks - 1)]  # [B, P, H, page, D]
        return jnp.asarray(g.transpose(0, 2, 1, 3, 4).reshape(b, hkv, p * page, d))

    ref = jfd.flash_decode_ref(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), gather(k_deq),
                               gather(v_deq), jnp.asarray(lengths), jnp.asarray(bias), scale=scale)
    np.testing.assert_allclose(to_np(tout), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_kernel_build_without_nvcc_raises_and_leaves_nothing(tmp_path, monkeypatch):
    """The paged kernel's source builds like every csrc/ source: a machine
    without nvcc gets an error and no partial file in the build directory."""
    from llmspeculativesampling_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_decode"])
    assert not (tmp_path / "kernels").exists() or not any((tmp_path / "kernels").iterdir())


def test_paged_attention_wrapper_refuses_other_devices():
    x = torch.zeros((1, 1, 1, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpfd.paged_flash_decode_attention(x, x, x, x, x, x, x, x, scale=1.0)


# ------------------------------------------------------------------ forward

def _models():
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
              num_heads=4, num_kv_heads=2, max_position=512, dtype="float32")
    params = jl.init_params(JCfg(**kw), jax.random.key(0))
    return (JBundle("llama", JCfg(**kw), jl.forward), params,
            TBundle("llama", TCfg(**kw), tl.forward), to_port(params))


N_BLOCKS, PAGE, MAX_PAGES = 16, 16, 8


def _caches(cfg, quant, tables, batch):
    jc = jpaged.init_paged_cache(cfg.num_layers, N_BLOCKS, cfg.num_kv_heads, PAGE, cfg.head_dim,
                                 batch=batch, max_pages=MAX_PAGES, dtype=jnp.float32, quant=quant)
    tc = tpaged.init_paged_cache(cfg.num_layers, N_BLOCKS, cfg.num_kv_heads, PAGE, cfg.head_dim,
                                 batch=batch, max_pages=MAX_PAGES, dtype=torch.float32,
                                 quant=quant, device="cpu")
    alloc = tpaged.PageAllocator(N_BLOCKS, PAGE, MAX_PAGES)
    for row, blocks in enumerate(tables):
        table = alloc.table_row(blocks)
        jc = jpaged.set_row_table(jc, row, jnp.asarray(table), 0)
        tc = tpaged.set_row_table(tc, row, table, 0)
    return jc, tc


def _pools(cache):
    names = ("k_q", "k_s", "v_q", "v_s") if hasattr(cache, "k_q") else ("k", "v")
    return [to_np(getattr(cache, n)) for n in names]


@pytest.mark.parametrize("quant", [False, True])
def test_paged_forward_matches_jax(quant):
    """Batched paged forwards over three rows with interleaved tables: a
    prefill, decode steps, a verify-sized block, a per-row rollback and a
    block longer than 32 (the gather path). Row 2 holds the sentinel table:
    it writes only into the trash block and does not touch the other rows."""
    jb, jp, tb, tp = _models()
    jfwd = jax.jit(lambda p, t, c: jb.forward(p, jb.cfg, t, c))
    tables = [[3, 0, 7, 12], [1, 9, 4, 15], []]  # row 2: sentinel only
    jc, tc = _caches(jb.cfg, quant, tables, batch=3)
    tol = 3e-2 if quant else 2e-4
    rng = np.random.default_rng(0)
    steps = [rng.integers(1, 250, (3, 8)), rng.integers(1, 250, (3, 1)),
             rng.integers(1, 250, (3, 1)), rng.integers(1, 250, (3, 5))]
    for i, toks in enumerate(steps + ["rollback", rng.integers(1, 250, (3, 2)),
                                      rng.integers(1, 250, (3, 36))]):
        if isinstance(toks, str):
            new = np.asarray([11, 9, 0], np.int32)
            jc = jpaged.rollback_rows(jc, jnp.asarray(new))
            tc = tpaged.rollback_rows(tc, torch.from_numpy(new))
            continue
        jl_, jc = jfwd(jp, jnp.asarray(toks, jnp.int32), jc)
        tl_, tc = tb.forward(tp, tb.cfg, torch.from_numpy(toks).long(), tc)
        np.testing.assert_array_equal(to_np(tc.lengths), np.asarray(jc.lengths))
        assert rel_err(tl_[:2], np.asarray(jl_)[:2]) < tol, (i, rel_err(tl_[:2], np.asarray(jl_)[:2]))
    owned = sorted(b for row in tables for b in row)
    untouched = [blk for blk in range(N_BLOCKS) if blk not in owned]
    for tpool, jpool in zip(_pools(tc), _pools(jc)):
        assert not tpool[:, untouched].any(), "a sentinel row wrote outside the trash block"
        assert tpool[:, N_BLOCKS].any(), "the sentinel row's writes should land in the trash block"
        if tpool.dtype != np.int8:  # int8 codes may round apart where the scales agree
            np.testing.assert_allclose(tpool[:, owned], jpool[:, owned], rtol=1e-5,
                                       atol=2e-3 if quant else 1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_prefill_matches_jax(quant):
    """``paged_prefill=True`` over empty rows (block-only attention, pool
    written in place) against the JAX admission prefill, and the next
    decode step over the written pools."""
    jb, jp, tb, tp = _models()
    tables = [[2, 5, 11], [6, 0, 13]]
    jc, tc = _caches(jb.cfg, quant, tables, batch=2)
    tol = 3e-2 if quant else 2e-4
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, 250, (2, 40))
    nxt = rng.integers(1, 250, (2, 3))
    jlog, jc = jax.jit(lambda p, t, c: jb.forward(p, jb.cfg, t, c, paged_prefill=True))(
        jp, jnp.asarray(prompts, jnp.int32), jc)
    tlog, tc = tb.forward(tp, tb.cfg, torch.from_numpy(prompts).long(), tc, paged_prefill=True)
    assert rel_err(tlog, jlog) < tol
    jlog, _ = jax.jit(lambda p, t, c: jb.forward(p, jb.cfg, t, c))(jp, jnp.asarray(nxt, jnp.int32), jc)
    tlog, _ = tb.forward(tp, tb.cfg, torch.from_numpy(nxt).long(), tc)
    assert rel_err(tlog, jlog) < tol


def test_paged_prefill_needs_a_paged_cache():
    _, _, tb, tp = _models()
    with pytest.raises(ValueError, match="paged cache"):
        tb.forward(tp, tb.cfg, torch.zeros((1, 4), dtype=torch.long),
                   tb.make_cache(1, 64, device="cpu"), paged_prefill=True)


def test_paged_forward_matches_contiguous_forward():
    """Per row, a batched paged forward gives what a contiguous-cache
    forward of that row alone gives (the JAX test's parity target)."""
    _, _, tb, tp = _models()
    _, tc = _caches(tb.cfg, False, [[4, 1, 8], [0, 14, 3]], batch=2)
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(1, 250, (2, 8))).long()
    step = torch.from_numpy(rng.integers(1, 250, (2, 4))).long()
    tb.forward(tp, tb.cfg, prompts, tc, paged_prefill=True)
    tc = dataclasses.replace(tc, lengths=torch.tensor([8, 8], dtype=torch.int32))
    got, _ = tb.forward(tp, tb.cfg, step, tc)
    for r in range(2):
        cache = tb.make_cache(1, 64, device="cpu")
        _, cache = tb.forward(tp, tb.cfg, prompts[r:r + 1], cache)
        ref, _ = tb.forward(tp, tb.cfg, step[r:r + 1], cache)
        assert rel_err(got[r:r + 1], ref) < 2e-4


# ------------------------------------------------------------- host side

def test_allocator_matches_jax():
    j = jpaged.PageAllocator(num_blocks=8, page=16, max_pages=8)
    t = tpaged.PageAllocator(num_blocks=8, page=16, max_pages=8)
    for total in (40, 16 * 6, 16, 17, 200):
        jb_, tb_ = j.alloc(total), t.alloc(total)
        assert jb_ == tb_ and j.free_blocks == t.free_blocks
    j.free([2, 0]), t.free([2, 0])
    assert j.alloc(32) == t.alloc(32)
    np.testing.assert_array_equal(t.table_row([2, 5]), np.asarray(j.table_row([2, 5])))
    a = tpaged.PageAllocator(num_blocks=32, page=16, max_pages=32)
    big, smalls = a.alloc(256), [a.alloc(40) for _ in range(5)]
    assert big is not None and all(s is not None for s in smalls)
    assert a.free_blocks == 32 - 16 - 5 * 3


def test_dest_indices_send_what_jax_drops_to_the_trash_block():
    tables = np.asarray([[3, 1], [5, 6], [6, 6]], np.int32)  # row 2: sentinel 6 = trash
    lengths = np.asarray([30, 3, 0], np.int32)
    jblk, joff = jpaged._dest_indices(jnp.asarray(tables), jnp.asarray(lengths), 4, 16)
    tblk, toff = tpaged._dest_indices(torch.from_numpy(tables), torch.from_numpy(lengths), 4, 16,
                                      trash=6)
    jblk = np.asarray(jblk)
    dropped = jblk >= 6  # JAX: out of range -> the scatter drops the write
    np.testing.assert_array_equal(to_np(tblk)[~dropped], jblk[~dropped])
    assert (to_np(tblk)[dropped] == 6).all() and dropped[0, 2:].all() and dropped[2].all()
    np.testing.assert_array_equal(to_np(toff), np.asarray(joff))


# ------------------------------------------------------------ split-KV plan

@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page,s_new,hq,hkv,lens", [
    (16, 9, 2, 2, [6 * 16 - 3, 3 * 16, 0, 4 * 16 + 7]),  # the serving verify, scaled down
    (32, 1, 6, 6, [31, 32, 33, 0]),                       # draft decode, split edges
    (16, 2, 8, 2, [17, 96, 1, 15]),                       # the re-feed, GQA
    (48, 9, 4, 4, [100, 200, 47, 144]),                   # pages cut into two splits
])
def test_paged_split_and_combine_match_the_plain_versions(page, s_new, hq, hkv, lens, quant):
    """The kernel's arithmetic over the paged plan's splits (one page, or a
    part of one, each), merged in split order, against the port's paged
    plain version and JAX's flash_decode_ref over the gathered view
    (fp32, sums in other orders: 2e-5)."""
    from llmspeculativesampling_tpu_torch.kernels import flash_decode as tfd

    b, p, n_blocks, d = 4, 6, 24, 64
    q, kn, vn, kp, vp = _attn_inputs(page + s_new, b, hq, hkv, s_new, d, n_blocks, page)
    perm = np.random.default_rng(page).permutation(n_blocks)
    tables = np.full((b, p), n_blocks, np.int32)  # sentinel = n_blocks
    for i, ln in enumerate(lens):
        take = -(-ln // page)
        tables[i, :take], perm = perm[:take], perm[take:]
    lengths = np.asarray(lens, np.int32)
    bias = _bias(b, s_new, tree=True, seed=page)
    t = torch.from_numpy
    ks = vs = None
    kw = {}
    if quant:
        kq, ks, vq, vs = *t_quantize_kv(t(kp)), *t_quantize_kv(t(vp))
        kw = dict(k_scales=ks, v_scales=vs)
        kp_t, vp_t = kq, vq
        k_deq, v_deq = to_np(kq) * to_np(ks)[..., None], to_np(vq) * to_np(vs)[..., None]
    else:
        kp_t, vp_t, k_deq, v_deq = t(kp), t(vp), kp, vp
    tt = t(tables)
    pl = tfd.plan(b, hkv, s_new * hq // hkv, page, p)
    gks = None if ks is None else tpfd.gather_pages(ks, tt)
    gvs = None if vs is None else tpfd.gather_pages(vs, tt)
    got = split_merge(t(q), t(kn), t(vn), tpfd.gather_pages(kp_t, tt), tpfd.gather_pages(vp_t, tt),
                      lengths, t(bias), d ** -0.5, tfd.split_ranges(pl, page), gks, gvs)
    ref_t = tpfd.paged_flash_decode_ref(t(q), t(kn), t(vn), kp_t, vp_t, tt, t(lengths), t(bias),
                                        scale=d ** -0.5, **kw)

    def gather(pool):
        g = pool[np.minimum(tables, n_blocks - 1)]
        return jnp.asarray(g.transpose(0, 2, 1, 3, 4).reshape(b, hkv, p * page, d))

    ref_j = jfd.flash_decode_ref(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), gather(k_deq),
                                 gather(v_deq), jnp.asarray(lengths), jnp.asarray(bias),
                                 scale=d ** -0.5)
    np.testing.assert_allclose(to_np(got), to_np(ref_t), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(to_np(got), np.asarray(ref_j), rtol=2e-5, atol=2e-5)


def test_paged_kernel_wrapper_rejects_what_the_kernel_cannot_take():
    b, hq, hkv, s_new, d, page = 2, 2, 2, 33, 64, 16
    q, kn, vn, kp, vp = (torch.from_numpy(a) for a in _attn_inputs(9, b, hq, hkv, s_new, d, 4, page))
    tables = torch.zeros((b, 2), dtype=torch.int32)
    lengths = torch.zeros(b, dtype=torch.int32)
    bias = torch.from_numpy(_bias(b, s_new))
    with pytest.raises(ValueError):  # new block longer than 32
        tpfd._launch(q, kn, vn, kp, vp, tables, lengths, bias, 0.125, None, None)
    q, kn, vn, bias = q[:, :, :9], kn[:, :, :9], vn[:, :, :9], bias[:, :9, :9]
    with pytest.raises(ValueError):  # head_dim 48: no instantiation
        tpfd._launch(q[..., :48], kn[..., :48], vn[..., :48], kp[..., :48], vp[..., :48], tables,
                     lengths, bias, 0.125, None, None)
    with pytest.raises(ValueError):  # tables not [B, P]
        tpfd._launch(q, kn, vn, kp, vp, tables[0], lengths, bias, 0.125, None, None)
    with pytest.raises(TypeError):  # int8 scales with a float pool
        tpfd._launch(q, kn, vn, kp, vp, tables, lengths, bias, 0.125, kp[..., 0], vp[..., 0])
