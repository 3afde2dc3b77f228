"""The batched speculative step shared by both serving engines: the slotted
``ContinuousBatchingEngine`` (``serve/scheduler.py``, a contiguous cache
with per-row device lengths) and the ``PagedEngine`` (``serve/paged.py``,
a block pool). The JAX package vmaps its single-request step over rows;
here every phase runs batch-level on one ``[B, ...]`` state:

* the draft re-feeds positions ``cur_len - 2, cur_len - 1`` of every row
  (the rollback is the per-row length reset) and drafts ``gamma`` tokens;
* one target forward verifies each row's window of ``gamma + 1`` tokens
  (both phases are ``engine/speculative.py``'s, which the single-request
  device loop runs at B = 1);
* ``engine/speculative.py::accept_phase_rows`` accepts, resamples or
  takes the bonus per row, from each row's own random stream
  (``ops/sampling.py::row_uniform``);
* :func:`commit_rows` keeps the step for live rows and every field of the
  others (finished or idle rows run through the forwards and change
  nothing), as the JAX engines' ``keep`` gate does.

The engines differ only in their caches, and in what the paged engine adds
around the step (sentinel gates, rows still prefilling). Under a mesh the
state is a rank's own rows (its dp shard's; ``parallel/sharding.py``): the
step runs over them alone, with only the tp collectives of their forwards.
"""

from __future__ import annotations

import dataclasses

import torch

from ..engine.speculative import accept_phase_rows
from ..ops.sampling import dist_width, row_uniform


@dataclasses.dataclass
class BatchState:
    """Every row's decode state (the counterpart of JAX's ``SpecState``
    with a leading row axis, plus ``active`` and ``target_len``)."""

    tokens: torch.Tensor        # [B, T_max] int64
    cur_len: torch.Tensor       # [B] int64
    draft_cache: object         # a cache of batch B with per-row device lengths
    target_cache: object
    key: torch.Tensor           # [B, 2] per-row stream keys (ops/sampling.py)
    active: torch.Tensor        # [B] bool: the row holds a request
    done: torch.Tensor          # [B] bool
    target_len: torch.Tensor    # [B] int64: done once cur_len reaches it
    accepted: torch.Tensor      # [B] int64
    resamples: torch.Tensor
    bonus: torch.Tensor
    steps: torch.Tensor
    acc_rate_sum: torch.Tensor  # [B] f32
    acc_len_hist: torch.Tensor  # [B, max_new_cap] int64


def accept_rows(gamma, tokens, cur_len, q_stack, drafts, p_stack, keys):
    """The accept uniforms and the resample/bonus draw from each row's
    stream, then ``accept_phase_rows``. Returns (tokens', new_len, n,
    all_acc, acc_rate_step, keys')."""
    r, keys = row_uniform(keys, gamma)
    u_t, keys = row_uniform(keys, dist_width(p_stack))
    tokens, new_len, _, n, all_acc, acc_step = accept_phase_rows(
        gamma, tokens, cur_len, q_stack, drafts, p_stack, r, u_t)
    return tokens, new_len, n, all_acc, acc_step, keys


def commit_rows(state, tokens, new_len, n, all_acc, acc_step, keys, eos_token_id: int,
                live: torch.Tensor, stats: torch.Tensor, **fields):
    """``state`` after one step: rows in ``live`` take the step's tokens,
    length and done flag (EOS among the newly committed tokens, or the
    budget reached); rows in ``stats`` also its counters and acceptance
    history; every other field of every other row keeps its value. The
    keys advance for every row. ``fields`` (the new caches) replace as
    given."""
    cur_len = state.cur_len
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    new_mask = (pos >= cur_len[:, None]) & (pos < new_len[:, None])
    done_now = (new_mask & (tokens == eos_token_id)).any(dim=1) & stats

    def sel(new, old, keep=live):
        return torch.where(keep, new, old)

    col = state.steps.clamp(max=state.acc_len_hist.shape[1] - 1)
    hist = state.acc_len_hist.scatter(1, col[:, None], n[:, None])
    return dataclasses.replace(
        state,
        tokens=torch.where(live[:, None], tokens, state.tokens),
        cur_len=sel(new_len, cur_len),
        key=keys,
        done=sel(done_now | (new_len >= state.target_len), state.done),
        accepted=sel(state.accepted + n, state.accepted, stats),
        resamples=sel(state.resamples + (~all_acc).long(), state.resamples, stats),
        bonus=sel(state.bonus + all_acc.long(), state.bonus, stats),
        steps=sel(state.steps + 1, state.steps, stats),
        acc_rate_sum=sel(state.acc_rate_sum + acc_step, state.acc_rate_sum, stats),
        acc_len_hist=torch.where(stats[:, None], hist, state.acc_len_hist),
        **fields,
    )


def run_steps(state, n_steps: int, step):
    """Up to ``n_steps`` calls of ``step(state)``; the chunk ends early once
    no row is live, read with one small device read (``live.any()``)
    before each step, where JAX exits its ``while_loop`` on the device.
    The read is a rank's own: the tp ranks of a dp shard hold the same
    rows, so their exits agree, while shards may run different step
    counts, since no collective crosses dp inside a chunk."""
    for _ in range(n_steps):
        if not bool((state.active & ~state.done).any()):
            break
        state = step(state)
    return state


def admit_rows(state, rows, prompts, p_lens, max_news, keys, cur0=None) -> None:
    """Install admitted rows' scheduler state in place: their tokens (the
    padded prompts, zeros after), lengths (both caches' too), stream keys,
    flags and zeroed counters. ``cur_len`` starts at ``cur0`` (default
    p_len)."""
    cur0 = p_lens if cur0 is None else cur0
    for cache in (state.draft_cache, state.target_cache):
        cache.lengths[rows] = cur0.to(torch.int32)
    tok_rows = torch.zeros((rows.shape[0], state.tokens.shape[1]), dtype=state.tokens.dtype,
                           device=state.tokens.device)
    tok_rows[:, :prompts.shape[1]] = prompts
    state.tokens[rows] = tok_rows
    state.cur_len[rows] = cur0
    state.key[rows] = keys
    state.active[rows] = True
    state.done[rows] = False
    state.target_len[rows] = p_lens + max_news
    for name in ("accepted", "resamples", "bonus", "steps", "acc_rate_sum", "acc_len_hist"):
        getattr(state, name)[rows] = 0
