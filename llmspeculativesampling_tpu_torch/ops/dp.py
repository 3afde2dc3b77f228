"""Dynamic-width acceptance DP (counterpart of ``llmspeculativesampling_tpu/ops/dp.py``).

The dynamic-width beam engine (``engine/beam_tree.py``, v2) picks how many
candidate beams to accept at a level from the distribution of the number of
acceptable draws out of ``m``, given the target joint ``p`` and the draft
joint ``q`` over the flattened beam x vocab axis. With alpha_i the
acceptance probability of draw i against the i-times-residual-updated
target:

    F(i)   = alpha_{i-1} * prod_{j<i-1} (1 - alpha_j)      # first accept at i
    P(m,0) = prod_{j<m} (1 - alpha_j)
    P(m,k) = sum_{i=1..m} F(i) * P(m-i, k-1)

Every sub-problem reuses the alphas from index 0, as the reference does.
The reference's output layout is kept too: ``get_num_acc_prob`` returns
``[P(m,1), ..., P(m,m), P(m,0)]`` (P(m,0) wraps to the last slot), and
``get_expect_cnt_by_thres`` walks that layout from the end.

All of it stays on the tensors' device: the m alphas are vocab-axis
reductions, and the O(m^2) table is filled one row per ``mm`` with a
vector product, so nothing is read back to the host.
"""

from __future__ import annotations

import torch

from .sampling import acceptance_prob, residual_update


def acceptance_alphas(p: torch.Tensor, q: torch.Tensor, m: int) -> torch.Tensor:
    """alpha_i for i < m with p residual-updated between draws:
    p_0 = p, p_{i+1} = norm(max(p_i - q, 0)), alpha_i = sum q*min(1, p_i/q).
    Returns float32 [m]."""
    cur = p.float()
    alphas = []
    for _ in range(m):
        alphas.append(acceptance_prob(cur, q))
        cur = residual_update(cur, q)
    return torch.stack(alphas)


def num_accept_distribution(alphas: torch.Tensor, m: int):
    """P(#accepted = k) for k = 0..m. Returns ``(probs, expect)``: ``probs``
    float32 [m+1] in the clean layout probs[k] = P(m,k), ``expect`` =
    sum k * P(m,k)."""
    alphas = alphas.float()
    one = torch.ones((1,), dtype=torch.float32, device=alphas.device)
    survival = torch.cat([one, torch.cumprod(1.0 - alphas, dim=0)])  # [m+1]
    first_acc = alphas * survival[:-1]  # first_acc[i-1] == F(i)
    # table[mm, k] = P(mm, k); row mm from rows mm-1 .. 0
    table = torch.zeros((m + 1, m + 1), dtype=torch.float32, device=alphas.device)
    table[0, 0].fill_(1.0)  # a Python scalar assigned by index is a host copy: no capture
    for mm in range(1, m + 1):
        prev = table[:mm, :m].flip(0)  # rows mm-1, ..., 0
        row = (first_acc[:mm, None] * prev).sum(dim=0)  # P(mm, k) for k = 1..m
        table[mm, 0] = survival[mm]
        table[mm, 1:] = row
    probs = table[m]
    ks = torch.arange(m + 1, dtype=torch.float32, device=alphas.device)
    return probs, (probs * ks).sum()


def get_num_acc_prob(p: torch.Tensor, q: torch.Tensor, m: int):
    """``(p_width, expect)`` with ``p_width`` [m+1] in the reference layout
    [P(m,1), ..., P(m,m), P(m,0)]."""
    probs, expect = num_accept_distribution(acceptance_alphas(p, q, m), m)
    return torch.cat([probs[1:], probs[:1]]), expect


def get_expect_cnt_by_thres(p_width: torch.Tensor, expect_thres: float) -> torch.Tensor:
    """Walk n = len-1 .. 0 summing p_width[n] until the sum reaches
    ``expect_thres``; return that n (int64 device scalar; 0 when the
    threshold is never reached)."""
    n = p_width.shape[0]
    cum = torch.cumsum(p_width.flip(0), dim=0)
    hit = cum >= expect_thres
    steps = torch.where(hit.any(), torch.argmax(hit.long()) + 1, n)
    return n - steps
