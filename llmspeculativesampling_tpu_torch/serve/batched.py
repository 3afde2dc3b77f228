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
* :func:`commit_rows` writes the step into the state's static buffers in
  place, keeping the step for live rows and every field of the others
  (finished or idle rows run through the forwards and change nothing), as
  the JAX engines' ``keep`` gate does.

A step is therefore a function of tensors only, with no host read, and a
chunk (:func:`run_chunk`) runs up to ``steps_per_sync`` of them the way JAX's
chunk ``while_loop`` does: on the card one captured CUDA graph per engine,
gamma and verify width, replayed while a device ``live`` flag (some row
active and not done) that each replay writes says so, the host reading the
flag one step behind (``engine/device_loop.py::serve_chunk``); on the CPU
and under a mesh the same step eagerly, with the flag read before each
step. The host reads nothing else during a chunk: the chunk's packed
metadata is copied into pinned memory behind it (:class:`MetaCopies`) and
read by the engines' one-deep pipeline while the next chunk runs; host
values reach the device through :func:`to_device` without blocking; TTFT
comes from a device event (:class:`DeviceClock`), not a synchronize.

The engines differ only in their caches, and in what the paged engine adds
around the step (sentinel gates, rows still prefilling). Under a mesh the
state is a rank's own rows (its dp shard's; ``parallel/sharding.py``): the
step runs over them alone, with only the tp collectives of their forwards.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from ..engine import device_loop
from ..engine.speculative import accept_phase_rows
from ..ops.sampling import dist_width, row_uniform
from ..parallel.distributed import host_fetch


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
                live: torch.Tensor, stats: torch.Tensor, draft_lengths: torch.Tensor,
                target_lengths: torch.Tensor) -> None:
    """Write one step into ``state``'s buffers, in place: rows in ``live``
    take the step's tokens, length and done flag (EOS among the newly
    committed tokens, or the budget reached); rows in ``stats`` also its
    counters and acceptance history; every other field of every other row
    keeps its value. The keys advance for every row, and the caches take
    the forwards' per-row lengths."""
    cur_len = state.cur_len
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    new_mask = (pos >= cur_len[:, None]) & (pos < new_len[:, None])
    done_now = (new_mask & (tokens == eos_token_id)).any(dim=1) & stats
    done = torch.where(live, done_now | (new_len >= state.target_len), state.done)
    col = state.steps.clamp(max=state.acc_len_hist.shape[1] - 1)
    hist = state.acc_len_hist.scatter(1, col[:, None], n[:, None])
    state.tokens.copy_(torch.where(live[:, None], tokens, state.tokens))
    state.cur_len.copy_(torch.where(live, new_len, cur_len))
    state.key.copy_(keys)
    state.done.copy_(done)
    for name, new in (("accepted", state.accepted + n),
                      ("resamples", state.resamples + (~all_acc).long()),
                      ("bonus", state.bonus + all_acc.long()),
                      ("steps", state.steps + 1),
                      ("acc_rate_sum", state.acc_rate_sum + acc_step)):
        old = getattr(state, name)
        old.copy_(torch.where(stats, new, old))
    state.acc_len_hist.copy_(torch.where(stats[:, None], hist, state.acc_len_hist))
    state.draft_cache.lengths.copy_(draft_lengths)
    state.target_cache.lengths.copy_(target_lengths)


def state_leaves(state) -> list:
    """Every tensor of a serving state, its caches' buffers included: what
    a captured step reads and writes."""
    out = []
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x):
            out.extend(state_leaves(x))
    return out


def live_rows(state) -> torch.Tensor:
    """A device bool: some row holds a request that is not done (JAX's
    chunk ``cond``)."""
    return (state.active & ~state.done).any()


def run_chunk(key: tuple, params: tuple, state, step, n_steps: int, replay: bool) -> tuple:
    """Up to ``n_steps`` calls of ``step(state)`` while some row is live:
    ``engine/device_loop.py::serve_chunk`` over the engine's static state,
    captured and replayed on the card under ``key`` and the identities of
    the param leaves and the state's buffers (one graph per engine, gamma
    and verify width), eager on the CPU and under a mesh. The device flag
    is a rank's own: the tp ranks of a dp shard hold the same rows, so
    their exits agree, while shards may run different step counts, since
    no collective crosses dp inside a chunk. Returns (steps called, masked
    steps)."""
    return device_loop.serve_chunk(
        key, device_loop.param_leaves(*params) + state_leaves(state),
        functools.partial(step, state), functools.partial(live_rows, state), n_steps, replay)


class MetaCopies:
    """The chunk metadata's device-to-host copies of the one-deep
    pipeline: :meth:`start` enqueues a chunk's copy into one of two pinned
    buffers behind the chunk and records an event; :meth:`fetch` waits on
    that event only, so chunk k's copy is read while chunk k+1 runs. On the
    CPU, and under a mesh (whose read is ``host_fetch``'s gather across
    dp, a collective every rank calls at the same point), the chunk's pack
    itself is the ticket and :meth:`fetch` reads it."""

    def __init__(self, device: torch.device, mesh):
        self._pinned = device.type == "cuda" and mesh is None
        self._device = device
        self._bufs: list = [None, None]
        self._next = 0

    def start(self, pack: Optional[torch.Tensor]):
        if pack is None or not self._pinned:
            return pack
        i, self._next = self._next, self._next ^ 1
        buf = self._bufs[i]
        if buf is None or buf.shape != pack.shape:
            buf = self._bufs[i] = torch.empty(pack.shape, dtype=pack.dtype, pin_memory=True)
        buf.copy_(pack, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._device))
        return buf, event

    def fetch(self, ticket) -> np.ndarray:
        if not self._pinned:
            return host_fetch(ticket)
        buf, event = ticket
        event.synchronize()
        return buf.numpy().copy()  # the buffer takes the chunk after next


class DeviceClock:
    """Host times of work enqueued on the card, without a synchronize:
    :meth:`mark` records a timing event behind what is enqueued so far,
    and :meth:`seen` gives the host time at which the device completed it
    (None while it has not), through an anchor event whose host time is
    taken once, at construction. On the CPU a mark is the time itself:
    the work is done when the call returns."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._anchor = torch.cuda.Event(enable_timing=True)
            self._anchor.record(torch.cuda.current_stream(device))
            self._anchor.synchronize()
            self._t0 = time.perf_counter()
            self._device = device

    def mark(self):
        if not self._cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        return event

    def seen(self, mark) -> Optional[float]:
        if not self._cuda:
            return mark
        if not mark.query():
            return None
        return self._t0 + self._anchor.elapsed_time(mark) / 1e3


def stamp_prefills(clock: DeviceClock, reqs) -> None:
    """Stamp the TTFT (``prefill_time``) of each request among ``reqs``
    whose admission prefill the device has completed (its ``prefill_mark``,
    recorded behind the prefill)."""
    for req in reqs:
        if req is not None and req.prefill_mark is not None:
            t = clock.seen(req.prefill_mark)
            if t is not None:
                req.prefill_time, req.prefill_mark = t, None


def to_device(x, dtype, device: torch.device) -> torch.Tensor:
    """Host values ``x`` as a tensor on ``device``. On the card the copy
    leaves from pinned memory without blocking, so it queues behind the
    chunk in flight instead of waiting for it (PyTorch's host allocator
    keeps the pinned block until the copy is done)."""
    t = torch.as_tensor(np.asarray(x), dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def admit_rows(state, rows, prompts, p_lens, max_news, keys, cur0=None) -> None:
    """Install admitted rows' scheduler state in place: their tokens (the
    padded prompts, zeros after), lengths (both caches' too), stream keys,
    flags and zeroed counters. ``cur_len`` starts at ``cur0`` (default
    p_len). Every value is a device tensor or a scalar fill: an indexed
    write of a Python scalar (``t[rows] = 0``) copies it from the host and
    waits for the card."""
    cur0 = p_lens if cur0 is None else cur0
    for cache in (state.draft_cache, state.target_cache):
        cache.lengths[rows] = cur0.to(torch.int32)
    tok_rows = torch.zeros((rows.shape[0], state.tokens.shape[1]), dtype=state.tokens.dtype,
                           device=state.tokens.device)
    tok_rows[:, :prompts.shape[1]] = prompts
    state.tokens[rows] = tok_rows
    state.cur_len[rows] = cur0
    state.key[rows] = keys
    state.active.index_fill_(0, rows, True)  # a scalar fill: no host value to copy
    state.done.index_fill_(0, rows, False)
    state.target_len[rows] = p_lens + max_news
    for name in ("accepted", "resamples", "bonus", "steps", "acc_rate_sum", "acc_len_hist"):
        getattr(state, name).index_fill_(0, rows, 0)
