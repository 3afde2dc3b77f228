"""Parity of the port's tiny-pair training (``llmspeculativesampling_tpu_torch/train``)
with the JAX package's, and the differentiable forward it needs, on the CPU.

Tolerances: loss 1e-5 relative; every gradient leaf 1e-4 of its largest
value (``rel_err``) against ``jax.grad`` of JAX's ``_loss_fn``; the
learning-rate schedule 1e-6 relative against optax's. AdamW against
optax's ``adamw``: fed the same gradients, every param leaf within 1e-5 of
its largest value after each of five steps; five whole training steps
(each side its own forward and backward), every leaf within 1e-4 in the
relative Frobenius norm. Adam divides a gradient by its own magnitude
plus eps 1e-8, so an element whose first gradient is near 1e-8 (one of
the 4,608 of ``w_down`` here: 1.5e-8) turns the two sides' last-bit
differences into 2e-4 of the leaf's largest value; the norm measures the
leaf as a whole, and the fed-gradient test holds the update rule itself
element by element.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llmspeculativesampling_tpu.engine.types import ModelBundle as JBundle
from llmspeculativesampling_tpu.models import llama as jl
from llmspeculativesampling_tpu.train import tiny as jt
from llmspeculativesampling_tpu_torch.core.config import OPTConfig
from llmspeculativesampling_tpu_torch.engine.speculative import speculative_generate
from llmspeculativesampling_tpu_torch.engine.types import ModelBundle as TBundle
from llmspeculativesampling_tpu_torch.kernels import _build
from llmspeculativesampling_tpu_torch.models import llama as tl
from llmspeculativesampling_tpu_torch.models import opt as to
from llmspeculativesampling_tpu_torch.train import tiny as tt
from _torch_port import one_thread, rel_err, to_port  # noqa: F401

_CFG = dict(hidden=48, layers=2, heads=2, max_position=128)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jt._byte_cfg(**_CFG)
    return cfg, jax.tree.map(lambda x: x.astype(jnp.float32), jl.init_params(cfg, jax.random.key(0)))


def _grad_leaves(tree, path=()):
    """(path, tensor) of every leaf of a port param tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _grad_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------------------ corpus

def test_snapshot_and_batches_equal_jax(tmp_path):
    """The port's snapshot is the JAX package's, byte for byte; the live
    corpus of a tree and the seeded batches equal JAX's."""
    def sha(path):
        with open(path, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()

    assert sha(tt._SNAPSHOT) == sha(jt._SNAPSHOT)
    assert np.array_equal(tt.pinned_corpus(), jt.pinned_corpus())
    assert tt._CORPUS_GLOBS == jt._CORPUS_GLOBS and tt._CORPUS_EXTS == jt._CORPUS_EXTS
    (tmp_path / "docs" / "b").mkdir(parents=True)
    (tmp_path / "README.md").write_bytes(b"readme " * 300)
    (tmp_path / "docs" / "z.md").write_bytes(b"zz " * 900)
    (tmp_path / "docs" / "b" / "a.py").write_bytes(b"print(1)\n" * 400)
    (tmp_path / "docs" / "skip.txt").write_bytes(b"not corpus " * 100)
    for max_bytes in (1 << 22, 5000):
        got = tt.build_repo_corpus(max_bytes, root=str(tmp_path))
        assert np.array_equal(got, jt.build_repo_corpus(max_bytes, root=str(tmp_path)))
    corpus = tt.pinned_corpus()
    for a, b in zip(tt.sample_batches(corpus, 4, 64, 3, 7), jt.sample_batches(corpus, 4, 64, 3, 7)):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


# ------------------------------------------------------- loss and gradients

@pytest.mark.parametrize("seq", [64, 16])
def test_loss_and_grads_match_jax(jax_params, seq):
    """S=64 takes the einsum path, S=16 the flash-decode path (its plain
    version on the CPU): both differentiate to jax.grad's leaves."""
    cfg_j, pj = jax_params
    cfg_t = tt._byte_cfg(**_CFG)
    tok = next(tt.sample_batches(tt.pinned_corpus(), 4, seq, 1, 3))
    loss_j, grads_j = jax.value_and_grad(jt._loss_fn)(
        pj, cfg_j, JBundle("llama", cfg_j, jl.forward), jnp.asarray(tok))
    pt = to_port(pj)
    for _, leaf in _grad_leaves(pt):
        leaf.requires_grad_(True)
    loss_t = tt._loss_fn(pt, cfg_t, TBundle("llama", cfg_t, tl.forward),
                         torch.as_tensor(tok, dtype=torch.long))
    loss_t.backward()
    assert abs(loss_t.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    flat_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(flat_j) == len(list(_grad_leaves(pt)))
    for path, g in flat_j:
        err = rel_err(_at(pt, tuple(k.key for k in path)).grad, g)
        assert err < 1e-4, (path, err)


@pytest.mark.parametrize("family,seq", [("llama", 64), ("llama", 16), ("opt", 64), ("opt", 16)])
def test_forward_differentiable_inference_bits_unchanged(family, seq):
    """Regression for the in-place cache writes: ``loss.backward()`` through
    the port's forward used to raise ("modified by an inplace operation")
    on fp32, because each layer's einsum (or the plain flash version) saved
    a view of the stacked cache that the next layer's write bumped. Now it
    runs, and the forward's logits and cache bits are the same with grad
    on as with grad off."""
    if family == "llama":
        cfg = tt._byte_cfg(**_CFG)
        mod = tl
    else:
        cfg = OPTConfig(vocab_size=256, hidden_size=48, ffn_dim=96, num_layers=2, num_heads=2,
                        max_position=128, dtype="float32")
        mod = to
    bundle = TBundle(family, cfg, mod.forward)
    params = mod.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.as_tensor(next(tt.sample_batches(tt.pinned_corpus(), 2, seq, 1, 5)),
                          dtype=torch.long)
    with torch.no_grad():
        cache0 = bundle.make_cache(2, 96, device="cpu")
        logits0, c0 = bundle.forward(params, cfg, tok, cache0)
    for _, leaf in _grad_leaves(params):
        leaf.requires_grad_(True)
    cache1 = bundle.make_cache(2, 96, device="cpu")
    logits1, c1 = bundle.forward(params, cfg, tok, cache1)
    assert torch.equal(logits0, logits1.detach())
    assert torch.equal(cache0.k, cache1.k.detach()) and torch.equal(cache0.v, cache1.v.detach())
    assert c0.length == c1.length == seq
    logits1[:, :-1].log_softmax(-1).mean().backward()
    grads = [leaf.grad for _, leaf in _grad_leaves(params)]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert float(params["embed"].grad.abs().sum()) > 0


def test_kernels_refuse_grad():
    """A kernel without a backward pass raises under grad, rather than
    cutting the gradient silently; outside grad mode, or when nothing
    requires grad, it goes through."""
    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("flash_decode", torch.zeros(1), x)
    with torch.no_grad():
        _build.refuse_grad("flash_decode", x)
    _build.refuse_grad("int8_matmul", torch.zeros(2), None)


# ----------------------------------------------------------------- optimizer

def test_schedule_matches_optax():
    ref = optax.cosine_decay_schedule(3e-3, 20, alpha=0.1)
    got = tt.cosine_decay_schedule(3e-3, 20, alpha=0.1)
    for count in range(24):
        assert got(count) == pytest.approx(float(ref(count)), rel=1e-6)
    assert got(0) == 3e-3


def _optax_pair(jax_params, steps=5, lr=3e-3):
    cfg_j, pj = jax_params
    tx = optax.adamw(optax.cosine_decay_schedule(lr, steps, alpha=0.1), weight_decay=0.01)
    pt = to_port(pj)
    opt, schedule = tt.make_optimizer(pt, lr, steps)
    pj = jax.tree.map(jnp.array, pj)  # the JAX step donates its params
    return cfg_j, pj, tx, tx.init(pj), pt, opt, schedule


def test_adamw_update_matches_optax(jax_params):
    """The update rule alone: both optimizers get JAX's gradients at JAX's
    params for five steps (b1, b2, eps outside the root, decoupled decay on
    every leaf, the schedule at the pre-increment count)."""
    cfg_j, pj, tx, state, pt, opt, schedule = _optax_pair(jax_params)
    bj = JBundle("llama", cfg_j, jl.forward)
    grad_fn = jax.jit(jax.grad(jt._loss_fn), static_argnums=(1, 2))
    for i, tok in enumerate(tt.sample_batches(tt.pinned_corpus(), 4, 64, 5, 11)):
        grads = grad_fn(pj, cfg_j, bj, jnp.asarray(tok))
        updates, state = tx.update(grads, state, pj)
        pj = optax.apply_updates(pj, updates)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            _at(pt, tuple(k.key for k in path)).grad = to_port(g)
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        opt.step()
        for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
            err = rel_err(_at(pt, tuple(k.key for k in path)).detach(), leaf)
            assert err < 1e-5, (i, path, err)


def test_five_steps_match_optax(jax_params):
    """Five port steps (forward, backward, AdamW under the cosine schedule)
    against JAX's ``_train_step`` with optax's ``adamw``: each step's loss,
    and every param leaf after the last."""
    cfg_j, pj, tx, state, pt, opt, schedule = _optax_pair(jax_params)
    cfg_t = tt._byte_cfg(**_CFG)
    bj = JBundle("llama", cfg_j, jl.forward)
    bt = TBundle("llama", cfg_t, tl.forward)
    for i, tok in enumerate(tt.sample_batches(tt.pinned_corpus(), 4, 64, 5, 11)):
        pj, state, loss_j = jt._train_step(pj, state, jnp.asarray(tok), cfg_j, bj, tx)
        loss_t = tt._train_step(pt, opt, schedule, i, torch.as_tensor(tok, dtype=torch.long),
                                cfg_t, bt)
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
        got = _at(pt, tuple(k.key for k in path)).detach().double()
        ref = torch.as_tensor(np.asarray(leaf), dtype=torch.float64)
        err = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
        assert err < 1e-4, (path, err)


# ------------------------------------------------------------- a tiny pair

def _acc(bd, pd, bt, pt, prompts):
    rates = []
    for i, p in enumerate(prompts):
        _, d = speculative_generate(bd, pd, bt, pt, p, 24, gamma=4, eos_token_id=-1, top_k=20,
                                    top_p=0.9, generator=torch.Generator().manual_seed(i),
                                    details=True, device="cpu")
        rates.append(d["acc_rate"])
    return float(np.mean(rates))


def test_tiny_pair_learns():
    """A 48-wide target and a 24-wide draft, one layer each, 60 steps: both
    losses fall, the params come back detached, and the trained draft is
    accepted more often than an untrained draft of the same shape."""
    corpus = tt.pinned_corpus()
    bd, pd, bt, pt, info = tt.train_tiny_pair(
        target_hidden=48, target_layers=1, draft_hidden=24, draft_layers=1, heads=2, steps=60,
        batch=8, seq_len=64, max_position=256, corpus=corpus, device="cpu")
    for key in ("target_loss", "draft_loss"):
        (i0, l0), (i1, l1) = info[key][0], info[key][-1]
        assert (i0, i1) == (0, 59) and l1 < 0.85 * l0, info[key]
    assert info["corpus_bytes"] == corpus.size
    assert not any(leaf.requires_grad for _, leaf in _grad_leaves(pt))
    rng = np.random.default_rng(0)
    prompts = [corpus[o:o + 32].astype(np.int32) for o in rng.integers(0, corpus.size - 40, 4)]
    untrained = tl.init_params(bd.cfg, torch.Generator().manual_seed(999), device="cpu")
    acc_trained, acc_untrained = _acc(bd, pd, bt, pt, prompts), _acc(bd, untrained, bt, pt, prompts)
    assert acc_trained > acc_untrained + 0.1, (acc_trained, acc_untrained)
