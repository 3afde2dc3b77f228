"""Lockstep serving drivers across ranks (counterpart of
``llmspeculativesampling_tpu/serve/multihost.py``).

Every rank runs the same engine, and a mesh-sharded engine issues the same
collectives on every rank in the same order, so every rank must take the
same host decisions. Requests arrive at rank 0 only: each round, rank 0
broadcasts its plan (fixed-shape integer arrays, one ``torch.distributed``
broadcast over a gloo group), every rank applies it and runs the same
steps, and rank 0 answers. The per-round broadcast is the heartbeat: a
peer that dies either breaks it at once (gloo reports the closed
connection) or leaves it hanging past ``heartbeat_timeout_s``; both become
:class:`WorkerLostError`, with the host state kept for
:meth:`PagedMultiHostDriver.recover_requests`.

One process runs both drivers as well: the broadcast is then the identity.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.comm import CollectiveError, broadcast
from ..parallel.distributed import host_group, process_count, process_index
from .scheduler import ContinuousBatchingEngine, Request


class WorkerLostError(RuntimeError):
    """A peer process stopped taking part in the lockstep collectives
    (died, wedged or unreachable). The raising driver keeps its host state;
    :meth:`PagedMultiHostDriver.recover_requests` extracts every outstanding
    request in resumable form."""


def _broadcast_now(tree):
    """Rank 0's integer arrays, every rank's shapes: one flat int64
    broadcast, cut back into the arrays."""
    leaves = [np.asarray(x) for x in tree]
    flat = torch.from_numpy(np.concatenate([x.astype(np.int64).reshape(-1) for x in leaves]))
    broadcast(flat, host_group())
    out, i = [], 0
    for x in leaves:
        out.append(flat[i:i + x.size].numpy().astype(x.dtype).reshape(x.shape))
        i += x.size
    return tuple(out)


def _broadcast(tree, timeout_s: Optional[float] = None):
    """Lockstep broadcast of ``tree`` (a tuple of integer arrays) from rank 0,
    with a watchdog when ``timeout_s`` is given: a broadcast that neither
    completes nor fails within it means a peer is gone. Failures become
    :class:`WorkerLostError`; the abandoned thread is a daemon, and the
    raising rank does not wait for it."""
    if process_count() == 1:
        return tree
    if timeout_s is None:
        return _broadcast_now(tree)
    box: list = []
    err: list = []

    def work():
        try:
            box.append(_broadcast_now(tree))
        except Exception as e:  # noqa: BLE001 - classified below
            err.append(e)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise WorkerLostError(f"lockstep broadcast did not complete within {timeout_s}s: a peer "
                              "process is gone or wedged")
    if err:
        raise WorkerLostError(f"lockstep collective failed: {err[0]!r}") from err[0]
    return box[0]


class MultiHostDriver:
    """Lockstep wrapper around a :class:`ContinuousBatchingEngine`.

    Only rank 0 may :meth:`submit`. Every rank calls :meth:`round` at the
    same cadence. The plan names each admission's slot and rid, so every
    rank prefills the same slots and derives the same stream keys
    (``row_keys(seed, rid)``): the keys advance in lockstep, and a driver's
    outputs equal a one-process engine's."""

    def __init__(self, engine: ContinuousBatchingEngine, prompt_cap: int = 512):
        self.engine = engine
        self.prompt_cap = prompt_cap
        self.is_primary = process_index() == 0
        self._planned: list = []
        self._more_queued = False
        if process_count() > 1:
            host_group()  # built now, on every rank (a collective)

    def submit(self, prompt_ids, max_new_tokens: int = 40) -> int:
        assert self.is_primary, "only rank 0 owns the request queue"
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.shape[0] > self.prompt_cap:
            raise ValueError(f"prompt longer than prompt_cap={self.prompt_cap}")
        return self.engine.submit(ids, max_new_tokens)

    def _build_plan(self):
        """Rank 0: the admissions as fixed-shape arrays (slot -1 marks an
        unused entry), by the engine's policy: FIFO into free slots, and
        whether requests stay queued."""
        eng = self.engine
        s = eng.num_slots
        slots = np.full((s,), -1, np.int32)
        rids = np.full((s,), -1, np.int64)
        p_lens = np.zeros((s,), np.int32)
        max_new = np.zeros((s,), np.int32)
        prompts = np.zeros((s, self.prompt_cap), np.int32)
        if self.is_primary:
            free = [i for i, r in enumerate(eng._slot_req) if r is None]
            j = 0
            while free and eng._pending:
                slot = free.pop(0)
                req = eng._pending.popleft()
                slots[j], rids[j] = slot, req.rid
                p_lens[j] = req.prompt.shape[0]
                max_new[j] = req.max_new_tokens
                prompts[j, :req.prompt.shape[0]] = req.prompt
                self._planned.append(req)
                j += 1
        more = np.asarray(bool(self.is_primary and eng._pending), np.int32)
        return slots, rids, p_lens, max_new, prompts, more

    def round(self, chunks: int = 1) -> int:
        """One lockstep round: broadcast the admissions, prefill them alike
        everywhere, run ``chunks`` decode chunks and harvest. Returns the
        busy slots (the same on every rank)."""
        eng = self.engine
        self._planned = []
        slots, rids, p_lens, max_new, prompts, more = _broadcast(self._build_plan())
        self._more_queued = bool(more)
        pairs = []
        for j in range(eng.num_slots):
            if slots[j] < 0:
                continue
            if self.is_primary:
                req = self._planned.pop(0)
            else:  # the other ranks track occupancy with stand-in requests
                req = Request(rid=int(rids[j]), prompt=prompts[j, :p_lens[j]].copy(),
                              max_new_tokens=int(max_new[j]), submit_time=time.perf_counter())
            pairs.append((int(slots[j]), req))
        eng._admit_pairs(pairs)
        for _ in range(chunks):
            if not eng.num_active:
                break
            eng._collect(eng._dispatch_chunk(), tuple(eng._slot_gen))
        return eng.num_active

    def run_until_idle(self, max_rounds: int = 10_000) -> int:
        """Drain, in the do-while shape of :meth:`PagedMultiHostDriver.run_until_idle`
        (JAX's loop tests rank 0's local queue first, which the other ranks
        never see filled)."""
        rounds = 0
        while rounds < max_rounds:
            self.round()
            rounds += 1
            if not (self._more_queued or self.engine.num_active):
                break
        return rounds

    def result(self, rid: int):
        return self.engine.result(rid)


def _is_transport_error(e: BaseException) -> bool:
    """A lost peer inside a step: a failed collective, never a host-side
    scheduling error (ValueError, the engine's own RuntimeErrors)."""
    return isinstance(e, (CollectiveError, dist.DistError, OSError))


class PagedMultiHostDriver:
    """Lockstep wrapper around a :class:`~.paged.PagedEngine`.

    The paged engine's whole host loop (admission order, allocators, the
    prefix cache, per-rid streams, chunk exits, harvests) is a
    deterministic function of its request stream and its replicated device
    state, so lockstep needs only the stream replicated: rank 0 owns the
    queue, each round broadcasts up to ``batch_cap`` (rid, prompt, max_new)
    releases, and every rank injects them with ``submit_with_rid`` and calls
    the same ``step()``. Rank 0 answers; the others hold the same
    completions."""

    def __init__(self, engine, prompt_cap: int = 512, batch_cap: int = 8,
                 heartbeat_timeout_s: Optional[float] = None):
        self.engine = engine
        self.prompt_cap = prompt_cap
        self.batch_cap = batch_cap
        # the heartbeat: the per-round broadcast fails or outlasts this on a
        # lost peer. A collective inside step() that fails is a lost peer
        # too; one that hangs there is seen at the next round's broadcast
        # only if it returns, so a wedged step needs an outside supervisor
        # (the process group's own timeout lies above this one).
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.failed = False
        self.is_primary = process_index() == 0
        self._queue: list = []  # rank 0's queue: (rid, ids, max_new, submit time)
        self._next_rid = 0
        self._more_queued = False
        if process_count() > 1:
            host_group()  # built now, on every rank (a collective)

    def submit(self, prompt_ids, max_new_tokens: int = 40) -> int:
        assert self.is_primary, "only rank 0 owns the request queue"
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.shape[0] > self.prompt_cap:
            raise ValueError(f"prompt longer than prompt_cap={self.prompt_cap}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, ids, int(max_new_tokens), time.perf_counter()))
        return rid

    def _build_plan(self):
        """Peek (never consume: a failed broadcast must lose nothing) up to
        ``batch_cap`` releases; the ``more`` flag tells every rank whether
        rank 0 still holds queued work."""
        k = self.batch_cap
        rids = np.full((k,), -1, np.int64)
        p_lens = np.zeros((k,), np.int32)
        max_new = np.zeros((k,), np.int32)
        prompts = np.zeros((k, self.prompt_cap), np.int32)
        n_planned = 0
        if self.is_primary:
            n_planned = min(k, len(self._queue))
            for j in range(n_planned):
                rid, ids, mn, _ = self._queue[j]
                rids[j], p_lens[j], max_new[j] = rid, ids.shape[0], mn
                prompts[j, :ids.shape[0]] = ids
        more = np.asarray(len(self._queue) > n_planned, np.int32)
        return n_planned, (rids, p_lens, max_new, prompts, more)

    def round(self, chunks: int = 1) -> int:
        """Broadcast up to ``batch_cap`` releases, inject them on every rank,
        run ``chunks`` engine steps. Returns the busy rows (the same on
        every rank). Raises :class:`WorkerLostError` when a peer stops
        taking part (state kept: :meth:`recover_requests`)."""
        if self.failed:
            raise WorkerLostError("driver is degraded; recover_requests()")
        eng = self.engine
        n_planned, plan = self._build_plan()
        try:
            rids, p_lens, max_new, prompts, more = _broadcast(plan, self.heartbeat_timeout_s)
        except WorkerLostError:
            self.failed = True
            raise
        if self.is_primary:
            del self._queue[:n_planned]  # the releases now exist on every rank
        self._more_queued = bool(more)
        for j in range(rids.shape[0]):
            if rids[j] >= 0:
                eng.submit_with_rid(int(rids[j]), prompts[j, :p_lens[j]].copy(), int(max_new[j]))
        for _ in range(max(chunks, 1)):
            try:
                eng.step()
            except Exception as e:
                if process_count() > 1 and _is_transport_error(e):
                    self.failed = True
                    raise WorkerLostError(f"engine step collective failed: {e!r}") from e
                raise
        return eng.num_active

    def recover_requests(self) -> list:
        """Rank 0, after :class:`WorkerLostError`: every outstanding request
        in resumable form, with no device access: the running rows
        preempted into resume requests (committed tokens and evolved stream
        keys from the last harvested chunk), the engine's queue, and this
        driver's unreleased queue with the original submit times. Feed them
        to a fresh engine with ``submit_request``."""
        assert self.failed, "recover_requests() is the failure path"
        assert self.is_primary, "only rank 0 owns request state"
        recovered = self.engine.drain_requests()
        for rid, ids, mn, t0 in self._queue:
            recovered.append(Request(rid, ids, mn, t0))
        self._queue.clear()
        return recovered

    def run_until_idle(self, max_rounds: int = 10_000) -> int:
        """Drain. Do-while: every rank enters the first round (the other
        ranks see an empty queue and an idle engine before it); after each
        round all ranks agree on the condition (replicated engine state,
        and the queued flag rode the broadcast)."""
        rounds = 0
        while rounds < max_rounds:
            self.round()
            rounds += 1
            if not (self._more_queued or self.engine._pending or self.engine.num_active):
                break
        return rounds

    def result(self, rid: int):
        return self.engine.result(rid)
