"""Training loop for tiny byte-level draft/target pairs
(counterpart of ``llmspeculativesampling_tpu/train/tiny.py``).

The same corpus (the frozen snapshot of the repository's text beside this
file, or the live text through :func:`build_repo_corpus`), the same seeded
batches and the same objective (next-byte cross-entropy) as the JAX
module. The step is ``torch.optim.AdamW`` under optax's
``adamw(cosine_decay_schedule(lr, steps, alpha=0.1), weight_decay=0.01)``:
b1 0.9, b2 0.999, eps 1e-8 outside the square root, decay ``lr * wd * p``
on every leaf, and the schedule read at the step's count before it is
incremented (step 0 uses ``lr``).

Initialisation draws from a seeded ``torch.Generator``, so trained weights
equal the JAX module's only in distribution. Training runs on the card
unless ``device="cpu"`` is passed; its blocks are longer than 32 tokens,
so the forward takes the attention path autograd can differentiate (the
flash-decode kernel has no backward pass and raises under grad).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.config import LlamaConfig, resolve_device
from ..engine.types import ModelBundle
from ..models import llama

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# text shipped with the repository, walked by build_repo_corpus: the same
# list as the JAX module's, so both give the same bytes
_CORPUS_GLOBS = ("SURVEY.md", "README.md", "BASELINE.md", "docs", "llmspeculativesampling_tpu")
_CORPUS_EXTS = (".md", ".py")

# the frozen corpus (a byte-for-byte copy of the JAX package's snapshot):
# live text drifts with every doc edit, which would perturb the trained pair
_SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus_snapshot.bin.gz")


def pinned_corpus() -> np.ndarray:
    """The frozen byte corpus (uint8 [N]) that trained-pair numbers use."""
    import gzip

    with gzip.open(_SNAPSHOT, "rb") as fh:
        return np.frombuffer(fh.read(), np.uint8)


def build_repo_corpus(max_bytes: int = 1 << 22, root: Optional[str] = None) -> np.ndarray:
    """Byte-level corpus (uint8 [N]) from the repository's own text: the
    files of a fixed top-level list, walked and concatenated in sorted
    order, truncated to ``max_bytes``."""
    root = root or _REPO_ROOT
    paths = []
    for top in _CORPUS_GLOBS:
        p = os.path.join(root, top)
        if os.path.isfile(p):
            paths.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames.sort()
                for f in sorted(filenames):
                    if f.endswith(_CORPUS_EXTS):
                        paths.append(os.path.join(dirpath, f))
    chunks = []
    total = 0
    for p in paths:
        with open(p, "rb") as fh:
            b = fh.read()
        chunks.append(np.frombuffer(b, np.uint8))
        total += len(b)
        if total >= max_bytes:
            break
    corpus = np.concatenate(chunks)[:max_bytes]
    if corpus.size < 4096:
        raise RuntimeError(f"repo corpus unexpectedly small: {corpus.size} bytes")
    return corpus


def sample_batches(
    corpus: np.ndarray, batch: int, seq_len: int, steps: int, seed: int
) -> Iterator[np.ndarray]:
    """Seeded stream of [batch, seq_len] int32 windows into the corpus."""
    rng = np.random.default_rng(seed)
    hi = corpus.size - seq_len - 1
    for _ in range(steps):
        off = rng.integers(0, hi, size=(batch,))
        yield np.stack([corpus[o : o + seq_len] for o in off]).astype(np.int32)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: ``init_value`` times
    ``(1 - alpha) * 0.5 * (1 + cos(pi * min(count, decay_steps) /
    decay_steps)) + alpha``."""
    if decay_steps <= 0:
        raise ValueError("decay_steps must be positive")

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return schedule


def _leaves(tree) -> list:
    """The tensor leaves of a param tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _loss_fn(params, cfg: LlamaConfig, bundle: ModelBundle, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` [B, S] (a fresh cache)."""
    cache = bundle.make_cache(tokens.shape[0], tokens.shape[1], device=tokens.device)
    logits, _ = bundle.forward(params, cfg, tokens, cache)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]
    return -ll.mean()


def make_optimizer(params, lr: float, steps: int):
    """(AdamW over every leaf of ``params``, its cosine schedule): the
    counterpart of optax's ``adamw(cosine_decay_schedule(lr, steps,
    alpha=0.1), weight_decay=0.01)``. The leaves are made to require grad."""
    leaves = [t.requires_grad_(True) for t in _leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    return opt, cosine_decay_schedule(lr, steps, alpha=0.1)


def _train_step(params, opt, schedule, count: int, tokens: torch.Tensor, cfg: LlamaConfig,
                bundle: ModelBundle) -> torch.Tensor:
    """One step at learning rate ``schedule(count)``; returns the loss
    before the update (a device scalar)."""
    for group in opt.param_groups:
        group["lr"] = schedule(count)
    opt.zero_grad(set_to_none=True)
    loss = _loss_fn(params, cfg, bundle, tokens)
    loss.backward()
    opt.step()
    return loss.detach()


def train_lm(
    cfg: LlamaConfig,
    corpus: np.ndarray,
    *,
    steps: int = 300,
    batch: int = 16,
    seq_len: int = 128,
    lr: float = 3e-3,
    seed: int = 0,
    log_every: int = 0,
    device=None,
) -> Tuple[dict, list]:
    """Train a Llama-family LM on the corpus; returns (params, loss_log),
    the log a list of (step, loss). Params are fp32 whatever ``cfg.dtype``
    says, and come back detached (no leaf requires grad)."""
    dev = resolve_device(device)
    bundle = ModelBundle("llama", cfg, llama.forward)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    params = _map(params, lambda t: t.float())
    opt, schedule = make_optimizer(params, lr, steps)
    losses = []
    for i, tok in enumerate(sample_batches(corpus, batch, seq_len, steps, seed + 1)):
        tokens = torch.as_tensor(tok, dtype=torch.long).to(dev)
        loss = _train_step(params, opt, schedule, i, tokens, cfg, bundle)
        if (log_every and i % log_every == 0) or i in (0, steps - 1):
            losses.append((i, float(loss)))
    for t in _leaves(params):
        t.requires_grad_(False)
    return params, losses


def _byte_cfg(hidden: int, layers: int, heads: int, max_position: int) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=256,
        hidden_size=hidden,
        intermediate_size=4 * hidden,
        num_layers=layers,
        num_heads=heads,
        num_kv_heads=heads,
        max_position=max_position,
        dtype="float32",
    )


def train_tiny_pair(
    *,
    target_hidden: int = 256,
    target_layers: int = 4,
    draft_hidden: int = 128,
    draft_layers: int = 2,
    heads: int = 4,
    steps: int = 300,
    draft_steps: Optional[int] = None,
    batch: int = 16,
    seq_len: int = 128,
    lr: float = 3e-3,
    seed: int = 0,
    max_position: int = 1024,
    corpus: Optional[np.ndarray] = None,
    device=None,
):
    """Train an independent (draft, target) pair on the corpus (default
    :func:`pinned_corpus`). Returns ``(bundle_d, params_d, bundle_t,
    params_t, info)`` in the engines' order; ``info`` holds each model's
    loss log and the corpus size. The draft has its own init, width and
    depth: its agreement with the target comes only from both having
    learned the corpus."""
    corpus = corpus if corpus is not None else pinned_corpus()
    cfg_t = _byte_cfg(target_hidden, target_layers, heads, max_position)
    cfg_d = _byte_cfg(draft_hidden, draft_layers, heads, max_position)
    params_t, loss_t = train_lm(
        cfg_t, corpus, steps=steps, batch=batch, seq_len=seq_len, lr=lr, seed=seed,
        device=device)
    params_d, loss_d = train_lm(
        cfg_d, corpus, steps=draft_steps or steps, batch=batch, seq_len=seq_len,
        lr=lr, seed=seed + 100, device=device)
    bt = ModelBundle("llama", cfg_t, llama.forward)
    bd = ModelBundle("llama", cfg_d, llama.forward)
    info = {"target_loss": loss_t, "draft_loss": loss_d, "corpus_bytes": int(corpus.size)}
    return bd, params_d, bt, params_t, info
