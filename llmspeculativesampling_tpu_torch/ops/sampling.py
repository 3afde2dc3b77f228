"""Sampling and acceptance math (counterpart of ``llmspeculativesampling_tpu/ops/sampling.py``).

Same pipeline as the JAX module: temperature -> top-k (value threshold,
ties kept) -> top-p (stable sort, shifted cumsum, first token always kept)
-> softmax; the Gumbel-argmax draw with the zero-probability -> argmax
guard; ``max_fn`` and the acceptance helpers with their 1e-6 guards; and
the sparse :class:`TopKDist` path the engines take when ``top_k > 0``.

Random draws come from an explicit ``torch.Generator`` on the tensors'
device, or, for batched serving, from per-row counter-based streams
(:func:`row_keys`, :func:`row_uniform`): each row's draws depend only on
its own key, so a request samples the same values whatever rows share its
batch. Their bits differ from ``jax.random``'s, so the tests compare
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
    """Static sampling knobs (temperature, top_k, top_p).

    ``tp_mesh`` (a ``parallel.sharding.Mesh``) declares that the logits fed
    to :func:`dist_norm` are this rank's vocab slice over that mesh's tp
    axis: the sparse path then runs :func:`norm_logits_topk_tp`, whose one
    collective moves ``tp * k`` candidates a row instead of the vocab. It
    needs ``top_k > 0``, as in JAX: the dense path has no distributed form."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    tp_mesh: Optional[object] = None

    def __post_init__(self):
        object.__setattr__(self, "temperature", float(self.temperature))
        object.__setattr__(self, "top_k", int(self.top_k))
        object.__setattr__(self, "top_p", float(self.top_p))
        if self.tp_mesh is not None and self.top_k <= 0:
            raise ValueError(
                "tp_mesh sampling requires top_k > 0: the dense (top_k=0) path has no "
                "distributed implementation and would gather full-vocab logits every step")


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


def _gumbel_of(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def _gumbel(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    return _gumbel_of(torch.rand(shape, generator=generator, device=device, dtype=torch.float32))


# ---- per-row counter-based streams. A row's key is [stream id, draw
# counter] (int64, 32-bit values); draw i of a call is a hash of (stream,
# counter, i). Plain int64 tensor ops that never overflow, so the CPU and the
# card give the same bits.

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), in 16-bit halves (no int64
    overflow)."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 integer hash (C. Wellons) on 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def row_keys(seed: int, rids, device=None) -> torch.Tensor:
    """Keys [K, 2] of the streams of (``seed``, rid) for each rid, counters
    at 0: independent of one another and of the rows they land on."""
    rid = torch.as_tensor(rids, dtype=torch.long, device=device).reshape(-1) & _M32
    base = _mix32(torch.tensor(int(seed) & _M32, dtype=torch.long, device=device) ^ 0x9E3779B9)
    return torch.stack([_mix32(base ^ _mix32(rid)), torch.zeros_like(rid)], dim=1)


def row_uniform(keys: torch.Tensor, n: int):
    """``n`` uniforms in (0, 1) per row from keys [B, 2] -> (u [B, n] f32,
    keys with every counter advanced by one)."""
    i = torch.arange(n, device=keys.device, dtype=torch.long)[None, :]
    h = _mix32(keys[:, :1] ^ _mix32((keys[:, 1:] + 0x85EBCA6B) & _M32))
    h = _mix32(h ^ _mix32((i + 0xC2B2AE35) & _M32))
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return u, torch.stack([keys[:, 0], keys[:, 1] + 1], dim=1)


def sample_u(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One id per leading element from uniforms ``u`` (probs' shape):
    Gumbel-argmax on log-probs, a draw of probability < 1e-9 replaced by the
    argmax. Returns int64 ids."""
    tok = torch.argmax(torch.log(probs) + _gumbel_of(u), dim=-1)
    chosen = torch.gather(probs, -1, tok[..., None])[..., 0]
    return torch.where(chosen < ZERO_PROB_EPS, torch.argmax(probs, dim=-1), tok)


def sample(generator: Optional[torch.Generator], probs: torch.Tensor) -> torch.Tensor:
    """:func:`sample_u` with uniforms from ``generator``."""
    u = torch.rand(probs.shape, generator=generator, device=probs.device, dtype=torch.float32)
    return sample_u(probs, u)


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


def topk_lowest_id(x: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their ids, in
    descending order, the lowest id first among equal values (the order of
    JAX's ``lax.top_k``; ``torch.topk`` leaves ties unordered)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sparse_dist(vals: torch.Tensor, idx: torch.Tensor, cfg: SamplingConfig) -> TopKDist:
    probs = torch.softmax(vals, dim=-1)
    if cfg.top_p > 0.0:
        probs = _nucleus(probs, cfg.top_p)
    return TopKDist(idx, probs)


def _tempered(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    x = logits.float()
    return x / cfg.temperature if cfg.temperature != 1.0 else x


def norm_logits_topk(logits: torch.Tensor, cfg: SamplingConfig) -> TopKDist:
    """Sparse :func:`norm_logits`; requires ``cfg.top_k > 0``."""
    if cfg.top_k <= 0:
        raise ValueError("the sparse path requires top-k filtering")
    vals, idx = topk_lowest_id(_tempered(logits, cfg), min(cfg.top_k, logits.shape[-1]))
    return _sparse_dist(vals, idx, cfg)


def norm_logits_topk_tp(logits: torch.Tensor, cfg: SamplingConfig) -> TopKDist:
    """:func:`norm_logits_topk` of vocab-sharded logits: ``logits`` [..., V/tp]
    is this rank's contiguous slice of ``cfg.tp_mesh``'s vocab. Each rank
    takes its local top-k (global ids), one gather moves the ``tp * k``
    candidates of every row, and a top-k of those merges them: the global
    top-k is the top-k of the per-shard top-ks. The candidates stand in
    shard order, so among equal values the lowest id wins, as in
    :func:`norm_logits_topk`, and the result is the same bits."""
    from ..parallel.comm import gather_last

    mesh, k = cfg.tp_mesh, cfg.top_k
    n = logits.shape[-1]
    if k <= 0 or k > n:
        raise ValueError(f"tp sampling needs 0 < top_k <= V/tp, got top_k={k}, V/tp={n}")
    vals, idx = topk_lowest_id(_tempered(logits, cfg), k)
    idx = idx + mesh.tp_rank * n
    # one collective for both: fp64 holds the fp32 values and the ids exactly
    cand = gather_last(torch.stack([vals.double(), idx.double()], dim=-2), mesh)  # [..., 2, tp*k]
    mvals, pos = topk_lowest_id(cand[..., 0, :].float(), k)
    midx = torch.gather(cand[..., 1, :], -1, pos).long()
    return _sparse_dist(mvals, midx, cfg)


def sample_topk_u(dist: TopKDist, u: torch.Tensor) -> torch.Tensor:
    """k-space categorical draw from uniforms ``u`` (probs' shape) with the
    zero-prob guard; returns ids."""
    j = sample_u(dist.probs, u)
    return torch.gather(dist.idx, -1, j[..., None])[..., 0]


def sample_topk(generator: Optional[torch.Generator], dist: TopKDist) -> torch.Tensor:
    """:func:`sample_topk_u` with uniforms from ``generator``."""
    p = dist.probs
    return sample_topk_u(dist, torch.rand(p.shape, generator=generator, device=p.device,
                                          dtype=torch.float32))


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


# ---- sparse JOINT (beam x vocab) distributions of the tree/beam engines.
# With top-k warping active every joint's support lies inside the union of
# the per-row top-k candidates (<= B*k flat ids), so these build TopKDists
# whose ``idx`` are FLAT ids (row * V + token) and never sort [B*V].

def _nucleus(probs: torch.Tensor, top_p: float) -> torch.Tensor:
    """Shifted-cumsum top-p over sorted ``probs`` (first entry kept),
    renormalized."""
    cum = torch.cumsum(probs, dim=-1)
    probs = torch.where((cum - probs) <= top_p, probs, torch.zeros_like(probs))
    return probs / probs.sum(dim=-1, keepdim=True)


def _flat_ids(idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, k] per-row ids -> [B*k] flat ids row * vocab + id."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return (rows * vocab + idx).reshape(-1)


def joint_topk_from_dists(row_dists: TopKDist, row_scores: torch.Tensor, valid: torch.Tensor,
                          cfg: SamplingConfig, vocab: int, out_k: Optional[int] = None) -> TopKDist:
    """Warped joint over flat ids from per-row sparse dists [B, k]: the
    dense ``norm_logits((log(p) + scores).reshape(1, -1))`` with invalid
    rows masked. ``out_k`` candidates are kept (default cfg.top_k; B*k for
    the plain softmax of the v1 walk, which skips top-p)."""
    b, k = row_dists.probs.shape
    vals = torch.log(row_dists.probs + 1e-30) + row_scores[:, None]
    vals = torch.where(valid[:, None] & (row_dists.probs > 0.0), vals,
                       torch.full_like(vals, _NEG_INF)).reshape(-1)
    flat = _flat_ids(row_dists.idx, vocab)
    if cfg.temperature != 1.0:
        vals = vals / cfg.temperature
    kk = out_k if out_k is not None else (cfg.top_k if cfg.top_k > 0 else b * k)
    top_vals, pos = torch.topk(vals, min(kk, b * k))
    probs = torch.softmax(top_vals, dim=-1)
    if cfg.top_p > 0.0 and out_k is None:
        probs = _nucleus(probs, cfg.top_p)
    # fully masked candidates (padding when fewer than kk are real) get 0
    probs = torch.where(top_vals == _NEG_INF, torch.zeros_like(probs), probs)
    return TopKDist(flat[pos], probs / probs.sum().clamp_min(1e-30))


def joint_topk_from_logp(logp: torch.Tensor, row_scores: torch.Tensor,
                         cfg: SamplingConfig) -> TopKDist:
    """Warped joint over flat ids from dense per-row log-probs [B, V]:
    per-row top-k, then a global top-k merge (never a [B*V] sort)."""
    if cfg.top_k <= 0:
        raise ValueError("the sparse joint requires top-k filtering")
    b, v = logp.shape
    k = min(cfg.top_k, v)
    x = logp + row_scores[:, None]
    if cfg.temperature != 1.0:
        x = x / cfg.temperature
    vals, idx = torch.topk(x, k, dim=-1)
    top_vals, pos = torch.topk(vals.reshape(-1), k)
    probs = torch.softmax(top_vals, dim=-1)
    if cfg.top_p > 0.0:
        probs = _nucleus(probs, cfg.top_p)
    return TopKDist(_flat_ids(idx, v)[pos], probs)


def joint_rowwarp_dense(logp: torch.Tensor, row_scores: torch.Tensor,
                        cfg: SamplingConfig) -> torch.Tensor:
    """The beam draft's joint: top-k/top-p warp EACH ROW of ``logp``
    [B, V], add the row priors, one softmax over the flattened [B*V]. The
    support is the union of the per-row nuclei (up to B*k candidates). A
    per-row constant prior moves neither mask, so the masks come from
    ``logp`` alone. The reference's beam joint has no temperature: pass
    1.0 for its semantics."""
    filt = filter_logits(logp, cfg)
    return torch.softmax((filt + row_scores[:, None]).reshape(-1), dim=-1)


def joint_rowwarp_topk(logp: torch.Tensor, row_scores: torch.Tensor,
                       cfg: SamplingConfig) -> TopKDist:
    """Sparse :func:`joint_rowwarp_dense`: per-row top-k candidates (B*k
    flat ids), the per-row nucleus mask, one softmax over all that is
    kept."""
    if cfg.top_k <= 0:
        raise ValueError("the sparse joint requires top-k filtering")
    b, v = logp.shape
    k = min(cfg.top_k, v)
    x = logp.float()
    if cfg.temperature != 1.0:
        x = x / cfg.temperature
    vals, idx = torch.topk(x, k, dim=-1)
    if cfg.top_p > 0.0:
        # the nucleus within the row's top-k is the nucleus of the filtered row
        probs_row = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs_row, dim=-1)
        vals = torch.where((cum - probs_row) <= cfg.top_p, vals, torch.full_like(vals, _NEG_INF))
    joint = (vals + row_scores[:, None]).reshape(-1)
    return TopKDist(_flat_ids(idx, v), torch.softmax(joint, dim=-1))


def rewarp_topk(dist: TopKDist, cfg: SamplingConfig) -> TopKDist:
    """The full warp (temperature -> top-k -> top-p -> softmax) of a
    distribution already restricted to candidates: the dense
    ``norm_logits(log(p))`` over a sparse support."""
    vals = torch.log(dist.probs + 1e-30)
    vals = torch.where(dist.probs > 0.0, vals, torch.full_like(vals, _NEG_INF))
    if cfg.temperature != 1.0:
        vals = vals / cfg.temperature
    n = vals.shape[-1]
    top_vals, pos = torch.topk(vals, min(cfg.top_k, n) if cfg.top_k > 0 else n, dim=-1)
    ids = torch.gather(dist.idx, -1, pos)
    probs = torch.softmax(top_vals, dim=-1)
    if cfg.top_p > 0.0:
        probs = _nucleus(probs, cfg.top_p)
    probs = torch.where(top_vals == _NEG_INF, torch.zeros_like(probs), probs)
    return TopKDist(ids, probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-30))


def sample_k_topk(generator: Optional[torch.Generator], dist: TopKDist, n: int) -> torch.Tensor:
    """``n`` draws without replacement (Gumbel top-k) in candidate space;
    over-drawn zero-prob winners become the argmax, as :func:`sample_k`.
    Fewer candidates than draws are padded with zero-prob entries, which
    the same guard resolves. Returns ids [..., n]."""
    k = dist.probs.shape[-1]
    if n > k:
        dist = TopKDist(_pad_rows(dist.idx, n - k, -1), _pad_rows(dist.probs, n - k, -1))
    g = _gumbel(generator, dist.probs.shape, dist.probs.device)
    pos = torch.topk(torch.log(dist.probs) + g, n, dim=-1).indices
    chosen = torch.gather(dist.probs, -1, pos)
    safe = torch.argmax(dist.probs, dim=-1, keepdim=True).expand_as(pos)
    pos = torch.where(chosen < ZERO_PROB_EPS, safe, pos)
    return torch.gather(dist.idx, -1, pos)


def min_sum(p: TopKDist, q: TopKDist) -> torch.Tensor:
    """Acceptance probability sum q*min(1, p/(q + 1e-6)) in candidate
    space: only q's support matters."""
    match = q.idx[..., :, None] == p.idx[..., None, :]
    p_at_q = torch.where(match, p.probs[..., None, :], torch.zeros((), device=p.probs.device)).sum(-1)
    ratio = p_at_q / (q.probs + MAX_FN_EPS)
    return (torch.clamp(ratio, max=1.0) * q.probs).sum(dim=-1)


def acceptance_alphas_topk(p: TopKDist, q: TopKDist, m: int) -> torch.Tensor:
    """Sparse ``ops.dp.acceptance_alphas``: alpha_i with p residual-updated
    between draws; the residual never leaves p's support. float32 [m]."""
    cur = TopKDist(p.idx, p.probs.float())
    alphas = []
    for _ in range(m):
        alphas.append(min_sum(cur, q))
        cur = residual_topk(cur, q)
    return torch.stack(alphas)


# ---- representation-agnostic dispatch: dense [..., V] tensors or TopKDist,
# chosen from the SamplingConfig

def use_sparse(cfg: SamplingConfig) -> bool:
    return cfg.top_k > 0


def dist_norm(logits: torch.Tensor, cfg: SamplingConfig):
    if use_sparse(cfg):
        if cfg.tp_mesh is not None:
            return norm_logits_topk_tp(logits, cfg)
        return norm_logits_topk(logits, cfg)
    return norm_logits(logits, cfg)


def dist_sample(generator, dist) -> torch.Tensor:
    return sample_topk(generator, dist) if isinstance(dist, TopKDist) else sample(generator, dist)


def dist_width(dist) -> int:
    """Uniforms one draw takes: the support size (k sparse, V dense)."""
    return (dist.probs if isinstance(dist, TopKDist) else dist).shape[-1]


def dist_sample_u(dist, u: torch.Tensor) -> torch.Tensor:
    return sample_topk_u(dist, u) if isinstance(dist, TopKDist) else sample_u(dist, u)


def dist_map(fn, dist):
    """Apply ``fn`` to every tensor of a dist (both leaves of a TopKDist)."""
    return TopKDist(fn(dist.idx), fn(dist.probs)) if isinstance(dist, TopKDist) else fn(dist)


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
