"""Paged continuous-batching engine: speculative decoding of many requests
at once over a shared block-pool KV cache (counterpart of
``llmspeculativesampling_tpu/serve/paged.py``).

The draft and verify phases run batch-level (one batched forward with
per-row block tables and lengths, ``models/llama.py``'s paged path, whose
attention is the paged flash-decode kernel) and the accept/resample math runs
per row (``engine/speculative.py::accept_phase_rows``). Each row draws from
its own random stream keyed by (engine seed, request id)
(``ops/sampling.py::row_keys``), so the same request set gives the same
outputs whatever the arrival order or the release cadence.

A request is admitted when a row and its pages are free, prefilled in one
batched forward per model, decoded in ``steps_per_sync``-step chunks with
one packed metadata read per chunk, and harvested (pages freed) when done.

* **On-demand paging** (``on_demand=True``, the default, as in JAX):
  admission reserves the prompt's pages plus a two-chunk runway,
  ``_ensure_runway`` appends pages as rows grow, and when the pool runs out
  the youngest row is preempted: its pages are freed and it requeues at the
  front with its committed tokens and its evolved stream key, so the resumed
  run replays the preempted one. Admission is gated on the rows' worst-case
  commitment (``overcommit`` times the pool); at 1.0 no row is ever
  preempted. ``on_demand=False`` reserves each request's worst case
  (prompt + max_new + gamma + 1) at admission.
* **Prefix cache** (``prefix_cache=True``): a request whose prompt repeats a
  registered page-aligned prefix (``cache/paged.py::SharedPageAllocator``)
  references those pages and computes only its suffix, in
  ``extend_chunk``-token windows through the paged decode path.

Not ported yet, each raising ``NotImplementedError`` in the constructor:
SARATHI chunked prefill (``chunked_prefill``, ``prefill_extra``), adaptive
gamma (``adaptive_gamma``) and the data-parallel mesh (``mesh``).

Differences from the JAX engine that do not change what it computes:
  * the host loop runs eagerly: a chunk ends early when no row is live by
    one small device read (``live.any()``) per step, where JAX exits its
    ``while_loop`` on the device, and each chunk's packed metadata is read
    synchronously, where JAX overlaps the read with the next chunk: the
    host's view of each row is current when it grows tables or preempts;
  * an admission batch is not padded to a power of two (nothing is
    compiled per shape), so no padding row exists;
  * dead rows, unused table slots, an extend window's padding and the rows
    it has exhausted write into the pools' trash block (``cache/paged.py``)
    where JAX drops the write;
  * TTFT is stamped once the admission prefill (or the extend) has
    finished on the device.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..cache.paged import (
    PageAllocator,
    SharedPageAllocator,
    init_paged_cache,
    prompt_page_hashes,
    rollback_rows,
)
from ..core.config import resolve_device, synchronize
from ..engine.speculative import accept_phase_rows
from ..engine.types import ModelBundle, first_eos_truncate, pad_prompt
from ..models.llama import unstack_layers
from ..ops.sampling import (
    SamplingConfig,
    dist_concat,
    dist_map,
    dist_norm,
    dist_sample_u,
    dist_width,
    row_keys,
    row_uniform,
)
from .scheduler import Completion, Request


@dataclasses.dataclass
class PagedBatchState:
    tokens: torch.Tensor        # [B, T_max] int64
    cur_len: torch.Tensor       # [B] int64
    draft_cache: object         # PagedKVCache / QuantPagedKVCache, batch B
    target_cache: object
    key: torch.Tensor           # [B, 2] per-row stream keys (ops/sampling.py)
    active: torch.Tensor        # [B] bool
    done: torch.Tensor          # [B] bool
    target_len: torch.Tensor    # [B] int64
    accepted: torch.Tensor      # [B] int64
    resamples: torch.Tensor
    bonus: torch.Tensor
    steps: torch.Tensor
    acc_rate_sum: torch.Tensor  # [B] f32
    acc_len_hist: torch.Tensor  # [B, max_new_cap] int64


def _rows_window(tokens: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """Per-row window tokens[b, starts[b] : starts[b]+width] -> [B, width]
    (indices clamped into the buffer: only dead rows reach its end)."""
    idx = starts[:, None] + torch.arange(width, device=tokens.device)[None, :]
    return torch.gather(tokens, 1, idx.clamp(0, tokens.shape[1] - 1))


def _sample_rows(dist, keys):
    """One draw per row from its own stream -> (ids [B], keys')."""
    u, keys = row_uniform(keys, dist_width(dist))
    return dist_sample_u(dist, u), keys


def _draft_phase_batched(bundle, params, scfg, gamma, tokens, cur_len, cache, keys):
    """Batched draft: every row re-feeds positions cur_len-2, cur_len-1 (the
    paged rollback is the per-row length reset), then gamma-1 single-token
    steps. Returns (tokens' (a new tensor, drafts written at cur_len..),
    cache', q_stack [B, gamma, ...], drafts [B, gamma], keys')."""
    cfg = bundle.cfg
    cache = rollback_rows(cache, cur_len - 2)
    logits, cache = bundle.forward(params, cfg, _rows_window(tokens, cur_len - 2, 2), cache)
    q = dist_norm(logits[:, -1], scfg)
    x, keys = _sample_rows(q, keys)
    qs, xs = [q], [x]
    for _ in range(gamma - 1):
        logits, cache = bundle.forward(params, cfg, x[:, None], cache)
        q = dist_norm(logits[:, 0], scfg)
        x, keys = _sample_rows(q, keys)
        qs.append(q)
        xs.append(x)
    drafts = torch.stack(xs, dim=1)
    cols = cur_len[:, None] + torch.arange(gamma, device=tokens.device)[None, :]
    tokens = tokens.scatter(1, cols.clamp(0, tokens.shape[1] - 1), drafts)
    q_stack = dist_concat([dist_map(lambda a: a[:, None], d) for d in qs], axis=1)
    return tokens, cache, q_stack, drafts, keys


def _verify_phase_batched(bundle, params, scfg, gamma, tokens, cur_len, cache):
    """One batched target forward over per-row windows of gamma+1 tokens ->
    (p_stack [B, gamma+1, ...], cache')."""
    cache = rollback_rows(cache, cur_len - 1)
    logits, cache = bundle.forward(params, bundle.cfg, _rows_window(tokens, cur_len - 1, gamma + 1),
                                   cache)
    return dist_norm(logits, scfg), cache


def _gate(cache, ok: torch.Tensor):
    """A view of ``cache`` whose rows outside ``ok`` hold the sentinel table:
    their writes land in the trash block."""
    sentinel = torch.full_like(cache.block_tables, cache.num_blocks)
    return dataclasses.replace(
        cache, block_tables=torch.where(ok[:, None], cache.block_tables, sentinel))


def _paged_spec_step(bundle_d, bundle_t, params_d, params_t, scfg, gamma, eos_token_id,
                     state: PagedBatchState) -> PagedBatchState:
    """One speculative step of every row. Dead rows (inactive or done) run
    through the batched forwards too; their tables are gated to the
    sentinel for the step, so they cannot write into pages a live row owns
    (a harvested row's table still names freed blocks), and every field of
    theirs keeps its value."""
    tokens, cur_len = state.tokens, state.cur_len
    live = state.active & ~state.done
    tokens2, draft_cache, q_stack, drafts, keys = _draft_phase_batched(
        bundle_d, params_d, scfg, gamma, tokens, cur_len, _gate(state.draft_cache, live),
        state.key)
    p_stack, target_cache = _verify_phase_batched(
        bundle_t, params_t, scfg, gamma, tokens2, cur_len, _gate(state.target_cache, live))
    # the gates are per-step views: the carried caches keep the real tables
    draft_cache = dataclasses.replace(draft_cache, block_tables=state.draft_cache.block_tables)
    target_cache = dataclasses.replace(target_cache, block_tables=state.target_cache.block_tables)

    r, keys = row_uniform(keys, gamma)
    u_t, keys = row_uniform(keys, dist_width(p_stack))
    tokens3, new_len, _, n, all_acc, acc_step = accept_phase_rows(
        gamma, tokens2, cur_len, q_stack, drafts, p_stack, r, u_t)

    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    new_mask = (pos >= cur_len[:, None]) & (pos < new_len[:, None])
    done_now = (new_mask & (tokens3 == eos_token_id)).any(dim=1)

    def sel(new, old):
        return torch.where(live, new, old)

    col = state.steps.clamp(max=state.acc_len_hist.shape[1] - 1)
    hist = state.acc_len_hist.scatter(1, col[:, None], n[:, None])
    return PagedBatchState(
        tokens=torch.where(live[:, None], tokens3, tokens),
        cur_len=sel(new_len, cur_len),
        draft_cache=draft_cache,
        target_cache=target_cache,
        key=keys,
        active=state.active,
        done=sel(done_now | (new_len >= state.target_len), state.done),
        target_len=state.target_len,
        accepted=sel(state.accepted + n, state.accepted),
        resamples=sel(state.resamples + (~all_acc).long(), state.resamples),
        bonus=sel(state.bonus + all_acc.long(), state.bonus),
        steps=sel(state.steps + 1, state.steps),
        acc_rate_sum=sel(state.acc_rate_sum + acc_step, state.acc_rate_sum),
        acc_len_hist=torch.where(live[:, None], hist, state.acc_len_hist),
    )


def _paged_chunk_body(params_d, params_t, state: PagedBatchState, *, bundle_d, bundle_t,
                      gamma: int, scfg: SamplingConfig, eos_token_id: int, n_steps: int):
    """Up to ``n_steps`` steps; the chunk ends early once no row is live,
    read with one small device read (``live.any()``) before each step.
    Returns (state, packed metadata)."""
    for _ in range(n_steps):
        if not bool((state.active & ~state.done).any()):
            break
        state = _paged_spec_step(bundle_d, bundle_t, params_d, params_t, scfg, gamma,
                                 eos_token_id, state)
    return state, _pack_chunk_meta(state)


def _pack_chunk_meta(state: PagedBatchState) -> torch.Tensor:
    """Everything the host reads after a chunk, as one flat int32 vector
    (one device-to-host copy): [cur_len b | done b | steps b | accepted b |
    resamples b | bonus b | acc_rate_sum (f32 bits) b | key b*2 |
    acc_len_hist b*h | tokens b*t]. ``key`` is each row's evolved stream key
    (both words below 2**32), which a preempted request resumes from. The
    JAX layout also carries the adaptive-gamma deltas, not ported yet."""
    def f(x):
        return x.to(torch.int32).reshape(-1)

    return torch.cat([
        f(state.cur_len), f(state.done), f(state.steps), f(state.accepted),
        f(state.resamples), f(state.bonus),
        state.acc_rate_sum.float().contiguous().view(torch.int32),
        f(state.key), f(state.acc_len_hist), f(state.tokens),
    ])


def _unpack_chunk_meta(pack: np.ndarray, b: int, h: int, t: int) -> dict:
    """Host-side inverse of :func:`_pack_chunk_meta`."""
    o = 0

    def take(n, shape=None):
        nonlocal o
        out = pack[o:o + n]
        o += n
        return out.reshape(shape) if shape else out

    return {
        "cur_len": take(b), "done": take(b).astype(bool), "steps": take(b),
        "accepted": take(b), "resamples": take(b), "bonus": take(b),
        "acc_rate_sum": take(b).view(np.float32),
        "key": take(b * 2, (b, 2)).view(np.uint32).astype(np.int64),
        "acc_len_hist": take(b * h, (b, h)), "tokens": take(b * t, (b, t)),
    }


def _admit_tables(state: PagedBatchState, rows, tables) -> None:
    """Install admitted rows' block tables and zero their lengths, in place."""
    for cache in (state.draft_cache, state.target_cache):
        cache.block_tables[rows] = tables
        cache.lengths[rows] = 0


def _install_state(state: PagedBatchState, rows, prompts, p_lens, max_news, keys) -> None:
    """Install admitted rows' scheduler metadata (tokens, lengths, stream
    keys, flags, zeroed counters) in place; ``cur_len`` starts at p_len."""
    for cache in (state.draft_cache, state.target_cache):
        cache.lengths[rows] = p_lens.to(torch.int32)
    tok_rows = torch.zeros((rows.shape[0], state.tokens.shape[1]), dtype=state.tokens.dtype,
                           device=state.tokens.device)
    tok_rows[:, :prompts.shape[1]] = prompts
    state.tokens[rows] = tok_rows
    state.cur_len[rows] = p_lens
    state.key[rows] = keys
    state.active[rows] = True
    state.done[rows] = False
    state.target_len[rows] = p_lens + max_news
    for name in ("accepted", "resamples", "bonus", "steps", "acc_rate_sum", "acc_len_hist"):
        getattr(state, name)[rows] = 0


def _paged_prefill_body(params_d, params_t, state: PagedBatchState, rows, tables, prompts,
                        p_lens, max_news, keys, *, bundle_d: ModelBundle,
                        bundle_t: ModelBundle) -> PagedBatchState:
    """Admit K requests at once: install their tables, run one batched
    prefill forward per model over a K-row view of the same pools (the
    prefill's pool writes are the admission's), then install the rows.
    Block tables of different requests are disjoint, so the K rows write
    disjoint pages."""
    _admit_tables(state, rows, tables)
    zeros = torch.zeros((rows.shape[0],), dtype=torch.int32, device=rows.device)
    for bundle, params, cache in ((bundle_d, params_d, state.draft_cache),
                                  (bundle_t, params_t, state.target_cache)):
        view = dataclasses.replace(cache, block_tables=tables, lengths=zeros)
        bundle.forward(params, bundle.cfg, prompts, view, paged_prefill=True)
    _install_state(state, rows, prompts, p_lens, max_news, keys)
    return state


def _paged_extend_body(params_d, params_t, state: PagedBatchState, tables, lens_now, window, *,
                       bundle_d: ModelBundle, bundle_t: ModelBundle) -> PagedBatchState:
    """One window of the prefix-cache hits' admission: both models over
    ``window`` [KB, W] with the rows' caches at ``lens_now`` (the
    shared-prefix boundary, then W further each window), through the normal
    paged path: B3 reads the shared pages, the new KV lands in the rows' own
    pages. Planned batch-invariant, so a hit's KV does not depend on the hits
    admitted with it. Rows whose prompt is exhausted carry the sentinel table
    and length 0: their writes land in the trash block and they read
    nothing."""
    for bundle, params, cache in ((bundle_d, params_d, state.draft_cache),
                                  (bundle_t, params_t, state.target_cache)):
        view = dataclasses.replace(cache, block_tables=tables, lengths=lens_now)
        bundle.forward(params, bundle.cfg, window, view, batch_invariant=True)
    return state


def _paged_finalize_body(state: PagedBatchState, rows, tables, prompts, p_lens, max_news,
                         keys) -> PagedBatchState:
    """Install rows whose KV is already in the pools (prefix-cache hits after
    their extend windows): the prefill's bookkeeping without its forwards."""
    _admit_tables(state, rows, tables)
    _install_state(state, rows, prompts, p_lens, max_news, keys)
    return state


def _paged_maintain_body(state: PagedBatchState, tables, deact) -> PagedBatchState:
    """On-demand paging's upkeep before a chunk: install the host's block
    tables ``tables`` [B, P] (rows grow pages as they cross page edges) and
    deactivate the preempted rows (``deact`` [B] bool), whose tables are
    now the sentinel's, so no later chunk writes pages another row may own."""
    for cache in (state.draft_cache, state.target_cache):
        cache.block_tables.copy_(tables)
    state.active &= ~deact
    state.done |= deact
    return state


# options of the JAX engine that later slices port (ROADMAP "Still to port")
_NOT_YET = {
    "chunked_prefill": "A14 step 5 (SARATHI chunked prefill)",
    "prefill_extra": "A14 step 5 (SARATHI chunked prefill)",
    "adaptive_gamma": "A14 step 6 (adaptive gamma)",
    "mesh": "A16 (data-parallel mesh)",
}


class Admission(NamedTuple):
    """One request of an admission batch."""
    row: int
    req: Request
    prompt: np.ndarray   # [bucket] the padded prompt
    p_len: int
    blocks: List[int]
    cached_len: int      # leading positions whose KV shared pages hold
    hashes: List[bytes]  # the prompt's page hashes (prefix cache), else []


class PagedEngine:
    """Continuous batching over a paged (optionally int8) KV pool.

    ``submit`` enqueues; ``step`` admits into free rows when the request's
    pages are free, grows the tables of running rows (preempting on
    exhaustion), runs one chunk of ``steps_per_sync`` speculative steps over
    every row and harvests finished requests (their pages return to the
    pool); ``run_until_idle`` repeats until the queue drains. Runs on the
    card unless ``device="cpu"``; the params must lie on that device."""

    def __init__(
        self,
        bundle_d: ModelBundle, params_d,
        bundle_t: ModelBundle, params_t,
        *,
        batch_rows: int = 8,
        num_blocks: int = 64,
        page: int = 128,
        max_pages_per_req: Optional[int] = None,
        max_new_cap: int = 256,
        gamma: int = 4,
        eos_token_id: int = 2,
        temperature: float = 1.0,
        top_k: int = 20,
        top_p: float = 0.9,
        seed: int = 0,
        prompt_bucket: int = 64,
        steps_per_sync: int = 4,
        kv_quant: bool = False,
        prefill_token_budget: int = 512,
        prefix_cache: bool = False,
        extend_chunk: int = 32,
        on_demand: bool = True,
        overcommit: float = 1.0,
        chunked_prefill: bool = False,
        prefill_extra: int = 0,
        adaptive_gamma=None,
        mesh=None,
        device=None,
    ):
        later = dict(chunked_prefill=chunked_prefill, prefill_extra=prefill_extra,
                     adaptive_gamma=adaptive_gamma, mesh=mesh)
        for name, value in later.items():
            if value:
                raise NotImplementedError(
                    f"PagedEngine({name}={value!r}) is not ported yet: ROADMAP {_NOT_YET[name]}")
        self.device = resolve_device(device)
        self.bundle_d, self.params_d = bundle_d, unstack_layers(params_d)
        self.bundle_t, self.params_t = bundle_t, unstack_layers(params_t)
        self.batch_rows = batch_rows
        self.page = page
        self.gamma = gamma
        self.eos_token_id = eos_token_id
        self.scfg = SamplingConfig(temperature, top_k, top_p)
        self.seed = seed
        self.prompt_bucket = prompt_bucket
        self.steps_per_sync = max(1, int(steps_per_sync))
        self.prefill_token_budget = max(int(prefill_token_budget), 1)
        self.max_new_cap = max_new_cap
        self.prefix_cache = bool(prefix_cache)
        self.extend_chunk = int(extend_chunk)
        self.on_demand = bool(on_demand)
        self.overcommit = float(overcommit)
        max_pages = max_pages_per_req or num_blocks
        if max_pages > num_blocks:
            raise ValueError(f"max_pages_per_req={max_pages} exceeds the {num_blocks}-block pool")
        alloc_cls = SharedPageAllocator if self.prefix_cache else PageAllocator
        self.allocator = alloc_cls(num_blocks, page, max_pages)
        self.t_max = max_pages * page
        # a chunk's worst-case advance plus its verify overrun: the most a
        # row's length can pass its last known value by the chunk's end
        self._chunk_runway = self.steps_per_sync * (gamma + 1) + gamma + 1

        dev, b = self.device, batch_rows

        def pool(cfg):
            return init_paged_cache(cfg.num_layers, num_blocks, cfg.num_kv_heads, page,
                                    cfg.head_dim, b, max_pages, cfg.torch_dtype, quant=kv_quant,
                                    device=dev)

        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.state = PagedBatchState(
            tokens=zeros(b, self.t_max),
            cur_len=torch.full((b,), 2, dtype=torch.long, device=dev),
            draft_cache=pool(bundle_d.cfg),
            target_cache=pool(bundle_t.cfg),
            key=zeros(b, 2),
            active=zeros(b, dtype=torch.bool),
            done=torch.ones((b,), dtype=torch.bool, device=dev),
            target_len=torch.full((b,), self.t_max, dtype=torch.long, device=dev),
            accepted=zeros(b), resamples=zeros(b), bonus=zeros(b), steps=zeros(b),
            acc_rate_sum=zeros(b, dtype=torch.float32),
            acc_len_hist=zeros(b, max_new_cap),
        )
        self._next_rid = 0
        self._pending: collections.deque[Request] = collections.deque()
        self._row_req: list[Optional[Request]] = [None] * b
        self._row_blocks: list[Optional[list]] = [None] * b
        self.completions: dict[int, Completion] = {}
        # on-demand paging: the host's view of each row's length (the last
        # chunk's), the worst-case pages each row and all rows commit, rows
        # admitted since the last chunk's snapshot, rows to deactivate and
        # whether the device's tables are behind the host's
        self._row_len: list[int] = [0] * b
        self._row_commit: list[int] = [0] * b
        self._commit_pages = 0
        self._unharvested: set = set()
        self._deact_rows: set = set()
        self._tables_dirty = False
        self._last_harvest: Optional[dict] = None
        self.preemptions = 0

    # --------------------------------------------------------------- interface
    def submit(self, prompt_ids, max_new_tokens: int = 40) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.submit_with_rid(rid, prompt_ids, max_new_tokens)
        return rid

    def submit_with_rid(self, rid: int, prompt_ids, max_new_tokens: int = 40) -> None:
        """Enqueue under a caller-chosen rid (the rid keys the request's
        random stream)."""
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.shape[0] < 2:
            raise ValueError("prompt must have at least 2 tokens")
        max_new = min(int(max_new_tokens), self.max_new_cap)
        if ids.shape[0] + max_new + self.gamma + 1 > self.t_max:
            raise ValueError("request exceeds max pages per request")
        self._pending.append(Request(rid, ids, max_new, time.perf_counter()))

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._row_req)

    def _reserve(self, req: Request, p_len: int):
        """Pages to admit ``req``: its worst case, or on demand its prompt
        plus a two-chunk runway, sharing the longest registered prefix
        chain when the prefix cache is on. Returns (blocks, cached_len,
        hashes, committed pages), or None (and holds nothing) while the pool
        or, on demand, the commitment watermark cannot take it: the rows'
        worst-case pages, this one's included, must stay within
        ``overcommit`` times the pool. Shared pages are charged to their
        first holder only."""
        worst = p_len + req.max_new_tokens + self.gamma + 1
        total = min(worst, p_len + 2 * self._chunk_runway) if self.on_demand else worst
        hashes = prompt_page_hashes(req.prompt, self.page) if self.prefix_cache else []
        if self.prefix_cache:
            got = self.allocator.alloc_shared(total, hashes)
            if got is None:
                return None
            blocks, cached_len = got
        else:
            blocks, cached_len = self.allocator.alloc(total), 0
            if blocks is None:
                return None
        if not self.on_demand:
            return blocks, cached_len, hashes, 0
        commit = self.allocator.pages_needed(worst) - cached_len // self.page
        if self._commit_pages + commit > self.allocator.num_blocks * self.overcommit:
            self.allocator.free(blocks)
            return None
        return blocks, cached_len, hashes, commit

    def _admit(self) -> None:
        """Admit queued requests in FIFO order while a row and their pages
        are free: batches of up to 8 of one prompt bucket within the prefill
        token budget. A batch's misses take one prefill, its prefix-cache
        hits their extend windows; the prompt pages of both are then
        registered."""
        free_rows = [i for i, r in enumerate(self._row_req) if r is None]
        while free_rows and self._pending:
            batch: List[Admission] = []
            bucket = None
            while free_rows and self._pending and len(batch) < 8:
                nxt = self._pending[0]
                padded, p_len = pad_prompt(nxt.prompt, self.prompt_bucket)
                if bucket is None:
                    bucket = padded.shape[-1]
                elif padded.shape[-1] != bucket:
                    break
                if batch and (len(batch) + 1) * bucket > self.prefill_token_budget:
                    break
                got = self._reserve(nxt, p_len)
                if got is None:
                    break  # the pool is short: keep it queued
                blocks, cached_len, hashes, commit = got
                self._pending.popleft()
                row = free_rows.pop(0)
                self._row_commit[row] = commit
                self._commit_pages += commit
                batch.append(Admission(row, nxt, padded.reshape(-1), p_len, blocks, cached_len,
                                       hashes))
            if not batch:
                break
            misses = [e for e in batch if e.cached_len == 0]
            hits = [e for e in batch if e.cached_len > 0]
            if misses:
                self._dispatch_prefill(misses)
            if hits:
                self._dispatch_extend(hits)
            now = time.perf_counter()
            for e in batch:
                if e.req.prefill_time is None:  # a resumed request keeps its TTFT
                    e.req.prefill_time = now
                e.req.cached_len = e.cached_len
                self._row_req[e.row] = e.req
                self._row_blocks[e.row] = e.blocks
                self._row_len[e.row] = e.p_len
                self._unharvested.add(e.row)
                if e.hashes:
                    self.allocator.register(e.hashes, e.blocks[:len(e.hashes)])

    # ------------------------------------------------------- on-demand paging
    def _ensure_runway(self) -> None:
        """Grow each running row's table to cover two chunks past its last
        known length, capped at its worst case (the admission commitment's
        basis, so overcommit 1.0 never preempts) and at the table's width.
        When the pool is empty, preempt the youngest row."""
        if not self.on_demand:
            return
        for row in range(self.batch_rows):
            req = self._row_req[row]
            if req is None:
                continue
            need = min(self._row_len[row] + 2 * self._chunk_runway,
                       len(req.prompt) + req.max_new_tokens + self.gamma + 1, self.t_max)
            while (self._row_req[row] is not None
                   and len(self._row_blocks[row]) * self.page < need):
                blk = self.allocator.alloc_one()
                if blk is not None:
                    self._row_blocks[row].append(blk)
                    self._tables_dirty = True
                    continue
                victim = self._pick_victim()
                if victim == row and self.allocator.num_blocks * self.page < need:
                    raise RuntimeError(f"request {req.rid} needs {need} cache positions but the "
                                       f"pool holds {self.allocator.num_blocks * self.page}")
                self._preempt_row(victim)  # the needy row itself exits the loop

    def _pick_victim(self) -> int:
        """The youngest (highest-rid) running row: first come, first served,
        and a resumed request (an old rid) is protected."""
        rows = [r for r in range(self.batch_rows) if self._row_req[r] is not None]
        return max(rows, key=lambda r: self._row_req[r].rid)

    def _preempt_row(self, row: int) -> None:
        """Free the row's pages and requeue its request at the front. A row
        with a snapshot of its own resumes from it: its committed tokens
        become the prompt, its evolved stream key and its counters ride
        along, so the resumed run replays the preempted continuation, bit
        for bit when the prefill recomputes the decode path's KV bit for bit
        (fp32 on the CPU; on the card a low bit can flip a sample, the
        distribution unchanged). A row without one restarts its request.

        The chunk metadata is read synchronously, so the last snapshot is
        the end state of the chunk just run: JAX's row-generation guard
        against its one-deep pipeline reduces here to whether the row has
        run a chunk since it was admitted."""
        req = self._row_req[row]
        hv = self._last_harvest
        resume = req
        if hv is not None and row not in self._unharvested and int(hv["steps"][row]) > 0:
            cur = int(hv["cur_len"][row])
            orig_plen = req.orig_prompt_len if req.orig_prompt_len is not None else len(req.prompt)
            prev = req.carry or {}
            steps = int(hv["steps"][row])
            carry = {
                "steps": prev.get("steps", 0) + steps,
                "accepted": prev.get("accepted", 0) + int(hv["accepted"][row]),
                "resamples": prev.get("resamples", 0) + int(hv["resamples"][row]),
                "bonus": prev.get("bonus", 0) + int(hv["bonus"][row]),
                "acc_rate_sum": prev.get("acc_rate_sum", 0.0) + float(hv["acc_rate_sum"][row]),
                "acc_len": prev.get("acc_len", []) + hv["acc_len_hist"][row][:steps].tolist(),
                "gamma_steps": prev.get("gamma_steps", 0) + steps * self.gamma,
                "prefix_cached_tokens": prev.get("prefix_cached_tokens", req.cached_len),
                "target_total": prev.get("target_total", orig_plen + req.max_new_tokens),
            }
            resume = Request(
                req.rid, hv["tokens"][row][:cur].astype(np.int32),
                max(carry["target_total"] - cur, 0), req.submit_time,
                prefill_time=req.prefill_time, resume_key=hv["key"][row].copy(), carry=carry,
                orig_prompt_len=orig_plen)
        self.allocator.free(self._row_blocks[row])
        self._commit_pages -= self._row_commit[row]
        self._row_commit[row] = 0
        self._row_req[row] = None
        self._row_blocks[row] = None
        self._unharvested.discard(row)
        self._deact_rows.add(row)
        self._tables_dirty = True
        self._pending.appendleft(resume)
        self.preemptions += 1

    def _flush_maintenance(self) -> None:
        """Send the host's tables (one host-to-device copy) and the pending
        deactivations to the device before the next chunk."""
        if not (self._tables_dirty or self._deact_rows):
            return
        tables = np.stack([self.allocator.table_row(b or []) for b in self._row_blocks])
        deact = np.zeros((self.batch_rows,), bool)
        deact[list(self._deact_rows)] = True
        self.state = _paged_maintain_body(
            self.state, torch.as_tensor(tables).to(self.device),
            torch.as_tensor(deact).to(self.device))
        self._deact_rows.clear()
        self._tables_dirty = False

    # ---------------------------------------------------------------- dispatch
    def _admission_arrays(self, batch: List[Admission]):
        """Host arrays of an admission batch: rows [K], tables [K, P],
        prompts [K, bucket], p_lens [K], max_news [K], cached lengths [K];
        and the rows' stream keys [K, 2] on the device: (seed, rid)'s, or a
        resumed request's evolved key."""
        keys = row_keys(self.seed, [e.req.rid for e in batch], device=self.device)
        for i, e in enumerate(batch):
            if e.req.resume_key is not None:
                keys[i] = torch.as_tensor(e.req.resume_key, dtype=torch.long)
        arrays = (
            np.asarray([e.row for e in batch]),
            np.stack([self.allocator.table_row(e.blocks) for e in batch]),
            np.stack([e.prompt for e in batch]),
            np.asarray([e.p_len for e in batch]),
            np.asarray([e.req.max_new_tokens for e in batch]),
            np.asarray([e.cached_len for e in batch]),
        )
        return arrays, keys

    def _dev(self, x: np.ndarray, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def _install_args(self, arrays, keys):
        """(rows, tables, prompts, p_lens, max_news, keys) on the device."""
        rows, tables, prompts, p_lens, max_news, _ = arrays
        return (self._dev(rows), self._dev(tables, torch.int32), self._dev(prompts),
                self._dev(p_lens), self._dev(max_news), keys)

    def _dispatch_prefill(self, batch: List[Admission]) -> None:
        self.state = _paged_prefill_body(
            self.params_d, self.params_t, self.state,
            *self._install_args(*self._admission_arrays(batch)),
            bundle_d=self.bundle_d, bundle_t=self.bundle_t)
        synchronize(self.device)  # TTFT: the prompts' KV is on the device

    def _extend_n_chunks(self, arrays) -> int:
        _, _, _, p_lens, _, cached = arrays
        return int(max(-(-(p - c) // self.extend_chunk) for p, c in zip(p_lens, cached)))

    def _extend_window(self, arrays, j: int) -> None:
        """Window ``j`` of the hits' suffixes: the [KB, W] prompt tokens at
        cached + j*W through both models. A row whose prompt is exhausted
        carries the sentinel table; a shorter tail is padded, its KV written
        past the prompt into the row's own pages (or the trash block)."""
        _, tables, prompts, p_lens, _, cached = arrays
        w = self.extend_chunk
        lens_now = cached + j * w
        live = lens_now < p_lens
        window = np.zeros((len(p_lens), w), np.int64)
        for r in np.nonzero(live)[0]:
            s0 = int(lens_now[r])
            take = min(w, int(p_lens[r]) - s0)
            window[r, :take] = prompts[r, s0:s0 + take]
        tabs = np.where(live[:, None], tables, self.allocator.num_blocks)
        self.state = _paged_extend_body(
            self.params_d, self.params_t, self.state, self._dev(tabs, torch.int32),
            self._dev(np.where(live, lens_now, 0), torch.int32), self._dev(window),
            bundle_d=self.bundle_d, bundle_t=self.bundle_t)

    def _finalize_admission(self, arrays, keys) -> None:
        self.state = _paged_finalize_body(self.state, *self._install_args(arrays, keys))

    def _dispatch_extend(self, batch: List[Admission]) -> None:
        """Prefix-cache hits: the first ``cached_len`` positions' KV already
        sits in shared pages; compute the suffix in ``extend_chunk``-token
        windows, then install the rows."""
        arrays, keys = self._admission_arrays(batch)
        for j in range(self._extend_n_chunks(arrays)):
            self._extend_window(arrays, j)
        self._finalize_admission(arrays, keys)
        synchronize(self.device)  # TTFT: the suffixes' KV is on the device

    def _dispatch_chunk(self) -> dict:
        self.state, pack = _paged_chunk_body(
            self.params_d, self.params_t, self.state, bundle_d=self.bundle_d,
            bundle_t=self.bundle_t, gamma=self.gamma, scfg=self.scfg,
            eos_token_id=self.eos_token_id, n_steps=self.steps_per_sync)
        return _unpack_chunk_meta(pack.cpu().numpy(), self.batch_rows, self.max_new_cap,
                                  self.t_max)

    def _harvest(self, hv: dict) -> None:
        """Keep the chunk's snapshot (the rows' lengths for table growth, and
        what a preempted row resumes from), complete the rows it finished,
        merging a resumed request's carried counters, free their pages and
        deactivate them."""
        self._last_harvest = hv
        self._unharvested.clear()
        for i, r in enumerate(self._row_req):
            if r is not None:
                self._row_len[i] = int(hv["cur_len"][i])
        fin = [i for i, r in enumerate(self._row_req) if r is not None and hv["done"][i]]
        for row in fin:
            req = self._row_req[row]
            p_len = req.prompt.shape[0]
            orig_plen = req.orig_prompt_len if req.orig_prompt_len is not None else p_len
            carry = req.carry or {}
            out = first_eos_truncate(hv["tokens"][row], p_len, int(hv["cur_len"][row]),
                                     self.eos_token_id)
            steps = int(hv["steps"][row])
            now = time.perf_counter()
            details = {
                "ttft_s": req.prefill_time - req.submit_time,
                "latency_s": now - req.submit_time,
                "acc_len": carry.get("acc_len", []) + hv["acc_len_hist"][row][:steps].tolist(),
                "acc_rate": (carry.get("acc_rate_sum", 0.0) + float(hv["acc_rate_sum"][row]))
                / max(carry.get("gamma_steps", 0) + steps * self.gamma, 1),
                "target_call_times": carry.get("steps", 0) + steps,
                "approx_call_times": carry.get("steps", 0) + steps,
                "accepted_count": carry.get("accepted", 0) + int(hv["accepted"][row]),
                "resample_count": carry.get("resamples", 0) + int(hv["resamples"][row]),
                "target_sample_count": carry.get("bonus", 0) + int(hv["bonus"][row]),
                "tokens_generated": len(out) - orig_plen,
                "prefix_cached_tokens": carry.get("prefix_cached_tokens", req.cached_len),
            }
            self.completions[req.rid] = Completion(req.rid, out, orig_plen, details)
            self.allocator.free(self._row_blocks[row])
            self._commit_pages -= self._row_commit[row]
            self._row_commit[row] = 0
            self._row_req[row] = None
            self._row_blocks[row] = None
        if fin:
            self.state.active[torch.as_tensor(fin, device=self.device)] = False

    def _prepare_chunk(self) -> None:
        self._admit()
        self._ensure_runway()
        self._flush_maintenance()

    def step(self) -> int:
        """Admit, grow tables, run one chunk, harvest. Returns the rows
        still busy."""
        self._prepare_chunk()
        if self.num_active:
            self._harvest(self._dispatch_chunk())
        return self.num_active

    def run_until_idle(self, max_steps: int = 10_000) -> int:
        """Step until no request is queued or running; returns the chunks run."""
        steps = 0
        while steps < max_steps:
            self._prepare_chunk()
            if not self.num_active:
                break
            self._harvest(self._dispatch_chunk())
            steps += 1
        return steps

    def result(self, rid: int) -> Optional[Completion]:
        return self.completions.pop(rid, None)

    def partial_result(self, rid: int) -> Optional[np.ndarray]:
        """Tokens committed so far (prompt + new, not yet EOS-truncated) of a
        request still on a row; None otherwise. One small device read."""
        for row, req in enumerate(self._row_req):
            if req is not None and req.rid == rid:
                row_t = torch.cat([self.state.cur_len[row:row + 1], self.state.tokens[row]])
                host = row_t.cpu().numpy()
                return host[1:1 + int(host[0])].astype(np.int32)
        return None
