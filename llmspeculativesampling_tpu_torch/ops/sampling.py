"""Sampling and acceptance math (counterpart of ``llmspeculativesampling_tpu/ops/sampling.py``).

Same pipeline as the JAX module: temperature -> top-k (value threshold,
ties kept) -> top-p (stable sort, shifted cumsum, first token always kept)
-> softmax; the Gumbel-argmax draw with the zero-probability -> argmax
guard; ``max_fn`` and the acceptance helpers with their 1e-6 guards; and
the sparse :class:`TopKDist` path the engines take when ``top_k > 0``.

Random draws come from an explicit ``torch.Generator`` on the tensors'
device. Its bits differ from ``jax.random``'s, so the tests compare
samplers in distribution and everything else exactly. Nothing here reads a
device value back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

ZERO_PROB_EPS = 1e-9
MAX_FN_EPS = 1e-6
_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Static sampling knobs (temperature, top_k, top_p)."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "temperature", float(self.temperature))
        object.__setattr__(self, "top_k", int(self.top_k))
        object.__setattr__(self, "top_p", float(self.top_p))


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask logits strictly below the k-th largest value (ties kept)."""
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, _NEG_INF)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: drop sorted position i iff the exclusive prefix mass
    exceeds p (the first sorted token is always kept)."""
    if p <= 0.0:
        return logits
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) <= p
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return logits.masked_fill(~keep, _NEG_INF)


def filter_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    out = logits.float()
    if cfg.temperature != 1.0:
        out = out / cfg.temperature
    out = apply_top_k(out, cfg.top_k)
    return apply_top_p(out, cfg.top_p)


def norm_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Full pipeline -> probability distribution [..., V]."""
    return torch.softmax(filter_logits(logits, cfg), dim=-1)


def _gumbel(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample(generator: Optional[torch.Generator], probs: torch.Tensor) -> torch.Tensor:
    """One id per leading element: Gumbel-argmax on log-probs, a draw of
    probability < 1e-9 replaced by the argmax. Returns int64 ids."""
    tok = torch.argmax(torch.log(probs) + _gumbel(generator, probs.shape, probs.device), dim=-1)
    chosen = torch.gather(probs, -1, tok[..., None])[..., 0]
    return torch.where(chosen < ZERO_PROB_EPS, torch.argmax(probs, dim=-1), tok)


def sample_k(generator: Optional[torch.Generator], probs: torch.Tensor, k: int) -> torch.Tensor:
    """``k`` ids without replacement (Gumbel top-k); over-drawn zero-prob
    winners become the argmax."""
    g = _gumbel(generator, probs.shape, probs.device)
    idx = torch.topk(torch.log(probs) + g, k, dim=-1).indices
    chosen = torch.gather(probs, -1, idx)
    safe = torch.argmax(probs, dim=-1, keepdim=True).expand_as(idx)
    return torch.where(chosen < ZERO_PROB_EPS, safe, idx)


def max_fn(x: torch.Tensor) -> torch.Tensor:
    """Residual distribution ``norm(max(x, 0))``."""
    xm = torch.clamp(x, min=0.0)
    return xm / (xm.sum(dim=-1, keepdim=True) + MAX_FN_EPS)


def acceptance_prob(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """alpha = sum_x q(x) * min(1, p(x) / (q(x) + 1e-6))."""
    ratio = p / (q + MAX_FN_EPS)
    return (torch.clamp(ratio, max=1.0) * q).sum(dim=-1)


def residual_update(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    new_p = torch.clamp(p - q, min=0.0)
    return new_p / (new_p.sum(dim=-1, keepdim=True) + MAX_FN_EPS)


class TopKDist(NamedTuple):
    """A filtered, normalized distribution restricted to its support:
    ``idx`` int64 [..., k] ids in descending probability, ``probs`` f32
    [..., k] (zeros where top-p dropped a candidate)."""

    idx: torch.Tensor
    probs: torch.Tensor


def norm_logits_topk(logits: torch.Tensor, cfg: SamplingConfig) -> TopKDist:
    """Sparse :func:`norm_logits`; requires ``cfg.top_k > 0``."""
    if cfg.top_k <= 0:
        raise ValueError("the sparse path requires top-k filtering")
    k = min(cfg.top_k, logits.shape[-1])
    x = logits.float()
    if cfg.temperature != 1.0:
        x = x / cfg.temperature
    vals, idx = torch.topk(x, k, dim=-1)
    probs = torch.softmax(vals, dim=-1)
    if cfg.top_p > 0.0:
        cum = torch.cumsum(probs, dim=-1)
        probs = torch.where((cum - probs) <= cfg.top_p, probs, torch.zeros_like(probs))
        probs = probs / probs.sum(dim=-1, keepdim=True)
    return TopKDist(idx, probs)


def sample_topk(generator: Optional[torch.Generator], dist: TopKDist) -> torch.Tensor:
    """k-space categorical draw with the zero-prob guard; returns ids."""
    p = dist.probs
    j = torch.argmax(torch.log(p) + _gumbel(generator, p.shape, p.device), dim=-1)
    chosen = torch.gather(p, -1, j[..., None])[..., 0]
    j = torch.where(chosen < ZERO_PROB_EPS, torch.argmax(p, dim=-1), j)
    return torch.gather(dist.idx, -1, j[..., None])[..., 0]


def prob_of_topk(dist: TopKDist, token: torch.Tensor) -> torch.Tensor:
    """Mass on ``token`` (0 outside the support)."""
    hit = dist.idx == token[..., None]
    return torch.where(hit, dist.probs, torch.zeros_like(dist.probs)).sum(dim=-1)


def residual_topk(p: TopKDist, q: TopKDist) -> TopKDist:
    """Sparse ``max_fn(p - q)``: the residual lives in p's support."""
    match = p.idx[..., :, None] == q.idx[..., None, :]
    q_at_p = torch.where(match, q.probs[..., None, :], torch.zeros((), device=q.probs.device)).sum(-1)
    w = torch.clamp(p.probs - q_at_p, min=0.0)
    return TopKDist(p.idx, w / (w.sum(dim=-1, keepdim=True) + MAX_FN_EPS))


def dense_probs(dist: TopKDist, vocab_size: int) -> torch.Tensor:
    """Scatter a TopKDist back to a dense [..., V] distribution."""
    out = torch.zeros(dist.probs.shape[:-1] + (vocab_size,), dtype=torch.float32,
                      device=dist.probs.device)
    return out.scatter_add_(-1, dist.idx, dist.probs.float())


# ---- representation-agnostic dispatch: dense [..., V] tensors or TopKDist,
# chosen from the SamplingConfig

def use_sparse(cfg: SamplingConfig) -> bool:
    return cfg.top_k > 0


def dist_norm(logits: torch.Tensor, cfg: SamplingConfig):
    return norm_logits_topk(logits, cfg) if use_sparse(cfg) else norm_logits(logits, cfg)


def dist_sample(generator, dist) -> torch.Tensor:
    return sample_topk(generator, dist) if isinstance(dist, TopKDist) else sample(generator, dist)


def dist_prob_of(dist, token: torch.Tensor) -> torch.Tensor:
    if isinstance(dist, TopKDist):
        return prob_of_topk(dist, token)
    return torch.gather(dist, -1, token[..., None])[..., 0]


def dist_residual(p, q):
    return residual_topk(p, q) if isinstance(p, TopKDist) else max_fn(p - q)


def _take(x: torch.Tensor, n, axis: int) -> torch.Tensor:
    if isinstance(n, int):
        return x.select(axis, n)
    n = torch.as_tensor(n, device=x.device).long()  # a device index: no host round trip
    out = x.index_select(axis, n.reshape(-1))
    return out.squeeze(axis) if n.dim() == 0 else out


def dist_take(dist, n, axis: int = 0):
    """Row-select with an int, a 0-dim device tensor (row dropped) or an
    index vector (rows kept)."""
    if isinstance(dist, TopKDist):
        return TopKDist(_take(dist.idx, n, axis), _take(dist.probs, n, axis))
    return _take(dist, n, axis)


def dist_concat(dists, axis: int = 0):
    if isinstance(dists[0], TopKDist):
        return TopKDist(torch.cat([d.idx for d in dists], dim=axis),
                        torch.cat([d.probs for d in dists], dim=axis))
    return torch.cat(dists, dim=axis)


def _pad_rows(x: torch.Tensor, rows: int, axis: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = rows
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=axis)


def dist_pad_zero_rows(dist, rows: int = 1, axis: int = 0):
    """Append all-zero rows (guards gathers past the last draft)."""
    if isinstance(dist, TopKDist):
        return TopKDist(_pad_rows(dist.idx, rows, axis), _pad_rows(dist.probs, rows, axis))
    return _pad_rows(dist, rows, axis)
