"""Paged continuous-batching engine: speculative decoding of many requests
at once over a shared block-pool KV cache (counterpart of
``llmspeculativesampling_tpu/serve/paged.py``).

The draft and verify phases run batch-level (one batched forward with
per-row block tables and lengths, ``models/llama.py``'s paged path, whose
attention is the paged flash-decode kernel) and the accept/resample math runs
per row: the step is ``serve/batched.py``'s, which the slotted engine shares. Each row draws from
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
* **SARATHI chunked prefill** (``chunked_prefill=True``): while some row is
  decoding, a cold prompt whose uncached suffix exceeds ``extend_chunk``
  is staged: only the draft is prefilled up front, in draft-only extend
  windows, and the row enters the step loop at ``cur_len = cached + 1``
  with ``prefill_to = p_len``. The decode rows' own verify passes then
  compute its target KV, ``gamma + prefill_extra`` prompt tokens a step,
  with its stream key frozen, so its decode stream is the monolithic
  engine's. ``prefill_extra`` widens every verify window by that many
  tokens. B3 takes windows of at most 32 new tokens
  (``kernels/flash_decode.py``): ``gamma + 1 + prefill_extra`` or
  ``extend_chunk`` above 32 sends those forwards to the plain path.
* **Adaptive gamma** (``adaptive_gamma=(g1, g2, ...)``): the draft depth is
  picked from measured throughput, per epoch of completed requests
  (``adaptive_gamma_mode="epoch"``, the default) or per chunk
  (``"chunk"``). Pages are sized for the deepest arm.

``mesh`` (a ``parallel.sharding.Mesh``, every rank of it running the
engine in lockstep, as ``serve/multihost.py`` drives it) shards the params
Megatron-style over tp and the pools' kv heads with them; the forwards sum
over tp and give every rank the full vocab, so every host decision is
replicated. A data-parallel axis above 1 raises ``NotImplementedError``
(ROADMAP A16 step 2), and so does adaptive gamma across ranks: its
controller decides from each host's own clock.

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
    finished on the device; a staged row's when the host sees its prefill
    complete, as in JAX;
  * the adaptive-gamma controller's chunk wall is the gap between two
    harvests while chunks run back to back (JAX: between two fetches of
    its one-deep pipeline);
  * a completion's ``acc_rate`` divides by the drafts the row made (each
    chunk's steps times that chunk's gamma), where JAX takes the current
    gamma for all of them: the same under a fixed gamma.
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
)
from ..core.config import resolve_device, synchronize
from ..engine.types import ModelBundle, first_eos_truncate, pad_prompt
from ..models.llama import unstack_layers
from ..ops.sampling import SamplingConfig, dist_map, row_keys
from ..parallel.sharding import require_dp1, shard_for, shard_paged_state
from .batched import (
    BatchState,
    accept_rows,
    admit_rows,
    commit_rows,
    draft_phase_batched,
    run_steps,
    verify_phase_batched,
)
from .scheduler import Completion, Request


@dataclasses.dataclass
class PagedBatchState(BatchState):
    """``BatchState`` over paged caches (``draft_cache``/``target_cache``:
    PagedKVCache / QuantPagedKVCache, batch B), plus ``prefill_to``."""

    # rows with cur_len < prefill_to are still prefilling (SARATHI): each
    # step their verify window carries the next prompt tokens through the
    # batched target forward, they sample nothing and their stream key
    # stays frozen. prefill_to == p_len for rows prefilled at admission.
    prefill_to: torch.Tensor    # [B] int64


def _gate(cache, ok: torch.Tensor):
    """A view of ``cache`` whose rows outside ``ok`` hold the sentinel table:
    their writes land in the trash block."""
    sentinel = torch.full_like(cache.block_tables, cache.num_blocks)
    return dataclasses.replace(
        cache, block_tables=torch.where(ok[:, None], cache.block_tables, sentinel))


def _paged_spec_step(bundle_d, bundle_t, params_d, params_t, scfg, gamma, eos_token_id,
                     state: PagedBatchState, prefill_extra: int = 0) -> PagedBatchState:
    """One speculative step of every row. Dead rows (inactive or done) run
    through the batched forwards too; their tables are gated to the
    sentinel for the step, so they cannot write into pages a live row owns
    (a harvested row's table still names freed blocks), and every field of
    theirs keeps its value.

    Rows still prefilling (``cur_len < prefill_to``) have their draft table
    gated too (the draft must not write its samples over their prefilled
    draft KV) and their prompt restored into the verify window, which is
    their prefill: they advance gamma+prefill_extra prompt tokens, record
    no statistics and no ``done``, and keep their stream key, so their
    decode draws are those of a row prefilled at admission."""
    tokens, cur_len = state.tokens, state.cur_len
    live = state.active & ~state.done
    prefilling = cur_len < state.prefill_to
    tokens2, draft_cache, q_stack, drafts, keys = draft_phase_batched(
        bundle_d, params_d, scfg, gamma, tokens, cur_len,
        _gate(state.draft_cache, live & ~prefilling), state.key)
    tokens2 = torch.where(prefilling[:, None], tokens, tokens2)
    p_stack, target_cache = verify_phase_batched(
        bundle_t, params_t, scfg, gamma, tokens2, cur_len, _gate(state.target_cache, live),
        extra=prefill_extra)
    if prefill_extra:
        p_stack = dist_map(lambda a: a[:, :gamma + 1], p_stack)
    # the gates are per-step views: the carried caches keep the real tables
    draft_cache = dataclasses.replace(draft_cache, block_tables=state.draft_cache.block_tables)
    target_cache = dataclasses.replace(target_cache, block_tables=state.target_cache.block_tables)

    tokens3, new_len, n, all_acc, acc_step, keys = accept_rows(
        gamma, tokens2, cur_len, q_stack, drafts, p_stack, keys)
    new_len = torch.where(prefilling, torch.minimum(cur_len + gamma + prefill_extra,
                                                    state.prefill_to), new_len)
    tokens3 = torch.where(prefilling[:, None], tokens, tokens3)
    keys = torch.where(prefilling[:, None], state.key, keys)
    return commit_rows(state, tokens3, new_len, n, all_acc, acc_step, keys, eos_token_id, live,
                       live & ~prefilling, draft_cache=draft_cache, target_cache=target_cache)


def _paged_chunk_body(params_d, params_t, state: PagedBatchState, *, bundle_d, bundle_t,
                      gamma: int, scfg: SamplingConfig, eos_token_id: int, n_steps: int,
                      prefill_extra: int = 0):
    """Up to ``n_steps`` steps; the chunk ends early once no row is live,
    read with one small device read (``live.any()``) before each step.
    Returns (state, packed metadata), the metadata with the chunk's
    accepted-token and step deltas, which feed the adaptive-gamma
    controller."""
    a0, s0 = state.accepted.sum(), state.steps.sum()
    state = run_steps(state, n_steps, lambda st: _paged_spec_step(
        bundle_d, bundle_t, params_d, params_t, scfg, gamma, eos_token_id, st, prefill_extra))
    return state, _pack_chunk_meta(state, state.accepted.sum() - a0, state.steps.sum() - s0)


def _pack_chunk_meta(state: PagedBatchState, acc_delta, step_delta) -> torch.Tensor:
    """Everything the host reads after a chunk, as one flat int32 vector
    (one device-to-host copy): [cur_len b | done b | steps b | accepted b |
    resamples b | bonus b | acc_rate_sum (f32 bits) b | acc_delta 1 |
    step_delta 1 | key b*2 | acc_len_hist b*h | tokens b*t], JAX's layout.
    ``key`` is each row's evolved stream key (both words below 2**32),
    which a preempted request resumes from."""
    def f(x):
        return x.to(torch.int32).reshape(-1)

    return torch.cat([
        f(state.cur_len), f(state.done), f(state.steps), f(state.accepted),
        f(state.resamples), f(state.bonus),
        state.acc_rate_sum.float().contiguous().view(torch.int32),
        f(acc_delta), f(step_delta),
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
        "acc_delta": int(take(1)[0]), "step_delta": int(take(1)[0]),
        "key": take(b * 2, (b, 2)).view(np.uint32).astype(np.int64),
        "acc_len_hist": take(b * h, (b, h)), "tokens": take(b * t, (b, t)),
    }


def _admit_tables(state: PagedBatchState, rows, tables) -> None:
    """Install admitted rows' block tables and zero their lengths, in place."""
    for cache in (state.draft_cache, state.target_cache):
        cache.block_tables[rows] = tables
        cache.lengths[rows] = 0


def _install_state(state: PagedBatchState, rows, prompts, p_lens, max_news, keys,
                   cur0=None) -> None:
    """Install admitted rows' scheduler metadata in place (``admit_rows``)
    and their ``prefill_to = p_len``. ``cur_len`` starts at ``cur0``
    (default p_len); a staged row passes cached_len + 1 and enters the step
    loop mid-prompt, ``prefill_to`` marking where its prefill ends."""
    admit_rows(state, rows, prompts, p_lens, max_news, keys, cur0)
    state.prefill_to[rows] = p_lens


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


def _paged_draft_extend_body(params_d, state: PagedBatchState, tables, lens_now, window, *,
                             bundle_d: ModelBundle) -> PagedBatchState:
    """A draft-only extend window of a staged admission (SARATHI): the
    target KV of a staged prompt is computed later, inside the decode
    chunks' verify passes; the draft is prefilled up front through these
    windows (``_paged_extend_body``'s, draft only, also planned
    batch-invariant) so the row's first decode step has its whole prefix."""
    view = dataclasses.replace(state.draft_cache, block_tables=tables, lengths=lens_now)
    bundle_d.forward(params_d, bundle_d.cfg, window, view, batch_invariant=True)
    return state


def _paged_finalize_body(state: PagedBatchState, rows, tables, prompts, p_lens, max_news,
                         keys, cur0=None) -> PagedBatchState:
    """Install rows whose KV is already in the pools (prefix-cache hits after
    their extend windows) or whose target KV the decode chunks will compute
    (staged rows, ``cur0`` < p_lens): the prefill's bookkeeping without its
    forwards."""
    _admit_tables(state, rows, tables)
    _install_state(state, rows, prompts, p_lens, max_news, keys, cur0)
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
        adaptive_gamma_mode: str = "epoch",
        mesh=None,
        device=None,
    ):
        require_dp1(mesh, "PagedEngine(mesh=...)")
        if mesh is not None and mesh.size > 1 and adaptive_gamma:
            raise NotImplementedError(
                "PagedEngine(mesh=..., adaptive_gamma=...): the controller picks gamma from "
                "each rank's own clock, so ranks in lockstep would diverge")
        if adaptive_gamma_mode not in ("epoch", "chunk"):
            raise ValueError(f"adaptive_gamma_mode={adaptive_gamma_mode!r}")
        self.device = resolve_device(device)
        self.mesh = mesh
        params_d, params_t = shard_for(bundle_d, params_d, mesh), shard_for(bundle_t, params_t, mesh)
        self.bundle_d, self.params_d = bundle_d.for_params(params_d), unstack_layers(params_d)
        self.bundle_t, self.params_t = bundle_t.for_params(params_t), unstack_layers(params_t)
        self.batch_rows = batch_rows
        self.page = page
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
        self.chunked_prefill = bool(chunked_prefill)
        self.prefill_extra = int(prefill_extra)
        self.interleaved_chunks = 0  # chunks that carried a row still prefilling
        max_pages = max_pages_per_req or num_blocks
        if max_pages > num_blocks:
            raise ValueError(f"max_pages_per_req={max_pages} exceeds the {num_blocks}-block pool")
        alloc_cls = SharedPageAllocator if self.prefix_cache else PageAllocator
        self.allocator = alloc_cls(num_blocks, page, max_pages)
        self.t_max = max_pages * page

        # adaptive gamma (JAX serve/paged.py:774-874): the candidate depths,
        # the per-chunk rates (the exploration prior and, in chunk mode, the
        # choice) and the epoch controller's state. Epoch mode ramps on the
        # shallowest arm, chunk mode starts on the middle one.
        self._gamma_choices = tuple(sorted(adaptive_gamma)) if adaptive_gamma else None
        self._ag_mode = adaptive_gamma_mode
        self._acc_ema = None        # per-token acceptance estimate (reporting)
        self._arm_rate: dict = {}   # gamma -> EMA committed tokens/s of its chunks
        self._arm_visits: dict = {}
        self._chunk_count = 0
        self._chunk_arm = (gamma, 1)  # the running chunk's (gamma, live rows)
        self._last_fetch_t: Optional[float] = None
        self._ep_rate: dict = {}    # gamma -> EMA completed tok/s of its epochs
        self._ep_size = max(batch_rows, 4)
        self._ep_tokens = 0
        self._ep_completions = 0
        self._ep_start: Optional[float] = None
        self._ep_phase = "ramp"     # ramp | explore | exploit | probe
        self._ep_count = 0
        self._ep_reprobe_every = 16
        self._ep_wall_cap = 1.6
        self._ep_hysteresis = 1.12
        self._ep_incumbent = None
        self._ramp_chunks = 0
        self._ramp_rotations = 2
        self._best_wall_pc = None
        self._ep_history: list = []
        self._resync = False        # hold admissions until a full wave is free
        self.gamma = self._first_arm() if self._gamma_choices else gamma
        # every worst-case size takes the deepest arm
        self._gam_max = max(self._gamma_choices) if self._gamma_choices else gamma
        # a chunk's worst-case advance plus its verify overrun: the most a
        # row's length can pass its last known value by the chunk's end
        self._chunk_runway = self.steps_per_sync * (self._gam_max + 1) + self._gam_max + 1

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
            prefill_to=zeros(b),
            accepted=zeros(b), resamples=zeros(b), bonus=zeros(b), steps=zeros(b),
            acc_rate_sum=zeros(b, dtype=torch.float32),
            acc_len_hist=zeros(b, max_new_cap),
        )
        if mesh is not None:
            self.state = shard_paged_state(self.state, mesh)
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
        # each row's steps at the last harvest and the drafts it made since
        # admission (steps times each chunk's gamma): acc_rate's denominator
        self._row_steps: list[int] = [0] * b
        self._row_drafted: list[int] = [0] * b
        # staged rows' prompt pages, registered in the prefix cache once
        # their prefill completes: row -> (request, hashes, blocks)
        self._pending_reg: dict = {}

    def _first_arm(self) -> int:
        arms = self._gamma_choices
        return arms[0] if self._ag_mode == "epoch" else arms[len(arms) // 2]

    # --------------------------------------------------------------- interface
    def warmup(self, prompt_lens=(8,)) -> None:
        """Run JAX's warm-up traffic (``serve/paged.py::warmup``) before live
        traffic: for each prompt length, admission waves of 1, 2, 4 and 8
        requests and their chunks, each adaptive arm, a prefix-cache hit
        and, with chunked prefill, a staged admission. Nothing is compiled
        per shape here, but the first launches happen now: the kernels
        build, B1 encodes its tensor maps, the allocator grows. Leaves the
        gamma controller pristine and the rid sequence where it was."""
        rng = np.random.default_rng(0)
        rid0 = self._next_rid
        rids = []
        for g in self._gamma_choices or ():
            self.gamma = g
            rids.append(self.submit(rng.integers(2, 100, size=8), 2))
            self.run_until_idle()
        kbs = [kb for kb in (1, 2, 4, 8) if kb <= self.batch_rows] or [1]
        for p_len in prompt_lens:
            for kb in kbs:
                rids += [self.submit(rng.integers(2, 100, size=max(int(p_len), 2)), 2)
                         for _ in range(kb)]
                self.run_until_idle()
            if self.prefix_cache and int(p_len) >= self.page + 2:
                same = rng.integers(2, 100, size=int(p_len))
                for _ in range(2):
                    rids.append(self.submit(same, 2))
                    self.run_until_idle()
        if self.chunked_prefill:
            # staging engages only while some row decodes: park one that
            # outlives a chunk (its budget above one chunk's worst-case
            # advance, within max_new_cap, which submit would clamp it to),
            # then submit a prompt longer than two extend windows
            park_new = max(min(self.steps_per_sync * (self._gam_max + 1) + 8, self.max_new_cap,
                               self.t_max - 8 - self._gam_max - 1), 2)
            rids.append(self.submit(rng.integers(2, 100, size=8), park_new))
            self.step()
            rids.append(self.submit(rng.integers(2, 100, size=2 * self.extend_chunk + 2), 2))
            self.run_until_idle()
        for r in rids:
            self.completions.pop(r, None)
        if self._gamma_choices:
            # reset after all warm-up traffic: its completions closed epochs
            self._arm_rate.clear()
            self._arm_visits.clear()
            self._chunk_count = 0
            self._acc_ema = None
            self._ep_rate.clear()
            self._ep_phase = "ramp"
            self._ep_count = 0
            self._best_wall_pc = None
            self._ep_history = []
            self._resync = False
            self._ep_incumbent = None
            self._ramp_chunks = 0
            self._epoch_reset()
            self._last_fetch_t = None
            self.gamma = self._first_arm()
        # the rid keys a request's stream: live traffic keeps its numbering
        self._next_rid = rid0

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
        if ids.shape[0] + max_new + self._gam_max + 1 > self.t_max:
            raise ValueError("request exceeds max pages per request")
        self._pending.append(Request(rid, ids, max_new, time.perf_counter()))

    def submit_request(self, req: Request) -> None:
        """Enqueue a request as it stands, a resumable one from
        :meth:`drain_requests` included: its committed tokens, evolved
        stream key and counters carry on."""
        self._pending.append(req)

    def drain_requests(self) -> List[Request]:
        """Empty the engine into resumable requests: preempt every running
        row (each resumes from the last chunk's snapshot, or restarts when
        it has run no step, as a row still prefilling has), then hand back
        and clear the queue. Staged rows' pages are never registered."""
        for row in range(self.batch_rows):
            if self._row_req[row] is not None:
                self._preempt_row(row)
        out = list(self._pending)
        self._pending.clear()
        return out

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
        worst = p_len + req.max_new_tokens + self._gam_max + 1
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
        token budget. With chunked prefill, while some row decodes, a
        request whose uncached suffix exceeds ``extend_chunk`` is staged;
        the rest take one prefill (misses) or their extend windows (hits),
        and their prompt pages are registered at once. After an arm switch
        of the epoch controller, admission holds until a full wave of rows
        is free (``_resync``) and the epoch restarts there."""
        free_rows = [i for i, r in enumerate(self._row_req) if r is None]
        if self._resync:
            if len(free_rows) < min(self.batch_rows, len(self._pending)):
                return
            self._resync = False
            self._ep_tokens = 0
            self._ep_completions = 0
            self._ep_start = None
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
            # staging protects decoding rows from a prompt forward's stall;
            # with none decoding, the monolithic prefill is faster
            decoding = any(r is not None and self._row_len[row] >= len(r.prompt)
                           for row, r in enumerate(self._row_req))
            inline, staged = [], []
            for e in batch:
                stage = (self.chunked_prefill and decoding
                         and e.p_len - e.cached_len > self.extend_chunk)
                (staged if stage else inline).append(e)
            misses = [e for e in inline if e.cached_len == 0]
            hits = [e for e in inline if e.cached_len > 0]
            if misses:
                self._dispatch_prefill(misses)
            if hits:
                self._dispatch_extend(hits)
            if staged:
                self._stage_admission(staged)
            now = time.perf_counter()
            for e in inline:
                if e.req.prefill_time is None:  # a resumed request keeps its TTFT
                    e.req.prefill_time = now
                self._install_row(e, e.p_len)
                if e.hashes:
                    self.allocator.register(e.hashes, e.blocks[:len(e.hashes)])

    def _install_row(self, e: Admission, row_len: int) -> None:
        """The host's bookkeeping of an admitted row. The admission installed
        its state, so a deactivation still pending for the row's previous
        request (one drained by ``drain_requests``) must not reach it."""
        self._deact_rows.discard(e.row)
        e.req.cached_len = e.cached_len
        self._row_req[e.row] = e.req
        self._row_blocks[e.row] = e.blocks
        self._row_len[e.row] = row_len
        self._row_steps[e.row] = 0
        self._row_drafted[e.row] = 0
        self._unharvested.add(e.row)

    # ------------------------------------------------- SARATHI chunked prefill
    def _stage_admission(self, batch: List[Admission]) -> None:
        """Admit cold prompts that ride the decode chunks (JAX
        ``_stage_admission``): the draft is prefilled now, in draft-only
        extend windows; the rows are installed at ``cur_len = cached + 1``
        (the +1 keeps the verify's rollback writes, at cur_len - 1, out of
        shared pages) with ``prefill_to = p_len``, and the chunks' verify
        passes compute their target KV. TTFT is stamped, and the prompt
        pages registered, once ``_harvest`` sees the prefill complete."""
        arrays, keys = self._admission_arrays(batch)
        for j in range(self._extend_n_chunks(arrays)):
            self._extend_window(arrays, j, draft_only=True)
        _, _, _, p_lens, _, cached = arrays
        cur0 = np.minimum(cached + 1, p_lens)
        self._finalize_admission(arrays, keys, cur0)
        for e, c0 in zip(batch, cur0):
            self._install_row(e, int(c0))
            if e.hashes:
                self._pending_reg[e.row] = (e.req, e.hashes, list(e.blocks[:len(e.hashes)]))

    def _n_prefilling(self) -> int:
        """Rows still prefilling, as the host sees them."""
        return sum(1 for row, req in enumerate(self._row_req)
                   if req is not None and self._row_len[row] < len(req.prompt))

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
                       len(req.prompt) + req.max_new_tokens + self._gam_max + 1, self.t_max)
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
        distribution unchanged). A row without one restarts its request, as
        a staged row still prefilling does (it has run no step); its pages
        are never registered.

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
                "gamma_steps": prev.get("gamma_steps", 0) + self._row_drafted[row],
                "prefix_cached_tokens": prev.get("prefix_cached_tokens", req.cached_len),
                "target_total": prev.get("target_total", orig_plen + req.max_new_tokens),
            }
            resume = Request(
                req.rid, hv["tokens"][row][:cur].astype(np.int32),
                max(carry["target_total"] - cur, 0), req.submit_time,
                prefill_time=req.prefill_time, resume_key=hv["key"][row].copy(), carry=carry,
                orig_prompt_len=orig_plen)
        self.allocator.free(self._row_blocks[row])
        self._pending_reg.pop(row, None)
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

    def _extend_window(self, arrays, j: int, draft_only: bool = False) -> None:
        """Window ``j`` of the suffixes: the [KB, W] prompt tokens at
        cached + j*W through both models, or the draft alone for a staged
        admission. A row whose prompt is exhausted carries the sentinel
        table; a shorter tail is padded, its KV written past the prompt into
        the row's own pages (or the trash block)."""
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
        args = (self.state, self._dev(tabs, torch.int32),
                self._dev(np.where(live, lens_now, 0), torch.int32), self._dev(window))
        if draft_only:
            self.state = _paged_draft_extend_body(self.params_d, *args, bundle_d=self.bundle_d)
        else:
            self.state = _paged_extend_body(self.params_d, self.params_t, *args,
                                            bundle_d=self.bundle_d, bundle_t=self.bundle_t)

    def _finalize_admission(self, arrays, keys, cur0=None) -> None:
        self.state = _paged_finalize_body(
            self.state, *self._install_args(arrays, keys),
            None if cur0 is None else self._dev(cur0))

    def _dispatch_extend(self, batch: List[Admission]) -> None:
        """Prefix-cache hits: the first ``cached_len`` positions' KV already
        sits in shared pages; compute the suffix in ``extend_chunk``-token
        windows, then install the rows."""
        arrays, keys = self._admission_arrays(batch)
        for j in range(self._extend_n_chunks(arrays)):
            self._extend_window(arrays, j)
        self._finalize_admission(arrays, keys)
        synchronize(self.device)  # TTFT: the suffixes' KV is on the device

    def _dispatch_chunk(self) -> torch.Tensor:
        """Run one chunk at the controller's gamma; returns its packed
        metadata. In epoch mode the first dispatch opens the epoch, and the
        ramp epoch rotates the arms chunk by chunk (``_ramp_rotations``
        cycles), then settles on the best per-chunk rate."""
        if self._gamma_choices and self._ag_mode == "epoch":
            if self._ep_start is None:
                self._ep_start = time.perf_counter()
            if self._ep_phase == "ramp":
                arms = self._gamma_choices
                k = self._ramp_chunks
                self._ramp_chunks = k + 1
                if k < self._ramp_rotations * len(arms):
                    self.gamma = arms[k % len(arms)]
                else:
                    self.gamma = max(arms, key=lambda g: self._arm_rate.get(g, float("-inf")))
        self._chunk_arm = (self.gamma, max(self.num_active, 1))
        self.state, pack = _paged_chunk_body(
            self.params_d, self.params_t, self.state, bundle_d=self.bundle_d,
            bundle_t=self.bundle_t, gamma=self.gamma, scfg=self.scfg,
            eos_token_id=self.eos_token_id, n_steps=self.steps_per_sync,
            prefill_extra=self.prefill_extra)
        return pack

    def _meta_np(self, pack: torch.Tensor) -> dict:
        """Read a chunk's packed metadata (the one device-to-host copy) and
        feed the gamma controller: the chunk's accepted and step deltas and
        its wall, the gap since the previous read (None after an idle step)
        times the live rows, as JAX normalises it."""
        hv = _unpack_chunk_meta(pack.cpu().numpy(), self.batch_rows, self.max_new_cap,
                                self.t_max)
        g, live = self._chunk_arm
        now = time.perf_counter()
        wall = None if self._last_fetch_t is None else max(now - self._last_fetch_t, 1e-9) * live
        self._last_fetch_t = now
        self._update_gamma(float(hv["acc_delta"]), float(hv["step_delta"]), g, wall)
        return hv

    def _harvest(self, hv: dict) -> None:
        """Keep the chunk's snapshot (the rows' lengths for table growth, and
        what a preempted row resumes from), stamp the TTFT of staged rows
        whose prefill it completed and register their prompt pages, complete
        the rows it finished, merging a resumed request's carried counters,
        free their pages and deactivate them."""
        self._last_harvest = hv
        self._unharvested.clear()
        g = self._chunk_arm[0]
        for i, r in enumerate(self._row_req):
            if r is None:
                continue
            self._row_len[i] = int(hv["cur_len"][i])
            steps = int(hv["steps"][i])
            self._row_drafted[i] += (steps - self._row_steps[i]) * g
            self._row_steps[i] = steps
            if r.prefill_time is None and self._row_len[i] >= len(r.prompt):
                r.prefill_time = time.perf_counter()
        for row, (req, hashes, blocks) in list(self._pending_reg.items()):
            if self._row_req[row] is not req:
                del self._pending_reg[row]
            elif self._row_len[row] >= len(req.prompt):
                self.allocator.register(hashes, blocks)
                del self._pending_reg[row]
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
                "ttft_s": (req.prefill_time if req.prefill_time is not None else now)
                - req.submit_time,
                "latency_s": now - req.submit_time,
                "acc_len": carry.get("acc_len", []) + hv["acc_len_hist"][row][:steps].tolist(),
                "acc_rate": (carry.get("acc_rate_sum", 0.0) + float(hv["acc_rate_sum"][row]))
                / max(carry.get("gamma_steps", 0) + self._row_drafted[row], 1),
                "target_call_times": carry.get("steps", 0) + steps,
                "approx_call_times": carry.get("steps", 0) + steps,
                "accepted_count": carry.get("accepted", 0) + int(hv["accepted"][row]),
                "resample_count": carry.get("resamples", 0) + int(hv["resamples"][row]),
                "target_sample_count": carry.get("bonus", 0) + int(hv["bonus"][row]),
                "tokens_generated": len(out) - orig_plen,
                "prefix_cached_tokens": carry.get("prefix_cached_tokens", req.cached_len),
            }
            self.completions[req.rid] = Completion(req.rid, out, orig_plen, details)
            if self._gamma_choices and self._ag_mode == "epoch" and not self._resync:
                # this residency's tokens only: a resumed request's earlier
                # ones belong to an earlier epoch; during the hold after an
                # arm switch the drain belongs to no arm
                self._ep_tokens += max(len(out) - p_len, 0)
                self._ep_completions += 1
            self.allocator.free(self._row_blocks[row])
            self._commit_pages -= self._row_commit[row]
            self._row_commit[row] = 0
            self._row_req[row] = None
            self._row_blocks[row] = None
        if fin:
            self.state.active[torch.as_tensor(fin, device=self.device)] = False

    # ---------------------------------------------------------- adaptive gamma
    def _update_gamma(self, acc_delta: float, step_delta: float, used_gamma: int,
                      wall: Optional[float]) -> None:
        """Per-chunk feedback (JAX ``_update_gamma``): the acceptance
        estimate (E[n] = a(1-a^g)/(1-a) inverted by bisection, for
        reporting), each arm's EMA of committed tokens per chunk wall, and
        in chunk mode the choice: every arm measured twice, then the best,
        with the runner-up every 8th chunk."""
        if not self._gamma_choices or step_delta <= 0:
            return
        mean_n = acc_delta / step_delta
        g = used_gamma
        lo, hi = 1e-4, 1.0 - 1e-4
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            if mid * (1.0 - mid**g) / (1.0 - mid) < mean_n:
                lo = mid
            else:
                hi = mid
        a = 0.5 * (lo + hi)
        self._acc_ema = a if self._acc_ema is None else 0.7 * self._acc_ema + 0.3 * a
        if wall and wall > 0:
            # committed tokens ~= accepted + one bonus or resample a round
            rate = (acc_delta + step_delta) / wall
            prev = self._arm_rate.get(used_gamma)
            self._arm_rate[used_gamma] = rate if prev is None else 0.6 * prev + 0.4 * rate
            self._arm_visits[used_gamma] = self._arm_visits.get(used_gamma, 0) + 1
        self._chunk_count += 1
        if self._ag_mode == "epoch":
            return  # the epoch controller alone picks the arm (_epoch_tick)
        hungry = [g for g in self._gamma_choices if self._arm_visits.get(g, 0) < 2]
        if hungry:
            self.gamma = hungry[0]
            return
        ranked = sorted(self._gamma_choices, key=lambda g: self._arm_rate.get(g, float("-inf")),
                        reverse=True)
        self.gamma = ranked[1] if self._chunk_count % 8 == 0 and len(ranked) > 1 else ranked[0]

    def _epoch_reset(self) -> None:
        """Drop the open epoch's partial count (the engine went idle);
        learned rates survive."""
        self._ep_tokens = 0
        self._ep_completions = 0
        self._ep_start = None

    def _epoch_tick(self) -> None:
        """Epoch mode (JAX ``_epoch_tick``): close the epoch once a full row
        turnover has completed (or, exploring, once its wall passes
        ``_ep_wall_cap`` times the best pace), credit the arm with the
        epoch's completed tokens per second (the ramp's arm-mixed epoch
        credits none), and pick the next arm: unexplored arms no deeper than
        the best per-chunk rate first, then the incumbent (a challenger
        must beat it by ``_ep_hysteresis``), probing the others every
        ``_ep_reprobe_every`` epochs. An arm switch holds admission until a
        full wave of rows is free."""
        if not self._gamma_choices or self._ag_mode != "epoch" or self._resync:
            return
        now = time.perf_counter()
        if self._ep_start is None:
            return  # no work dispatched yet (_dispatch_chunk opens it)
        wall = now - self._ep_start
        capped = (self._ep_phase in ("ramp", "explore", "probe")
                  and self._best_wall_pc is not None
                  and wall > self._ep_wall_cap * self._best_wall_pc * self._ep_size)
        if self._ep_completions < self._ep_size and not capped:
            return
        rate = self._ep_tokens / max(wall, 1e-9)
        ramp_mixed = self._ep_phase == "ramp"
        self._ep_history.append({
            "gamma": "mixed" if ramp_mixed else self.gamma,
            "phase": self._ep_phase,
            "completions": self._ep_completions,
            "wall_s": round(wall, 3),
            "tok_per_s": round(rate, 1),
            "capped": capped,
        })
        if not ramp_mixed:
            prev = self._ep_rate.get(self.gamma)
            self._ep_rate[self.gamma] = rate if prev is None else 0.5 * prev + 0.5 * rate
        if not capped and self._ep_completions > 0:
            wpc = wall / self._ep_completions
            if self._best_wall_pc is None or wpc < self._best_wall_pc:
                self._best_wall_pc = wpc
        self._ep_count += 1
        prior = sorted(self._gamma_choices, key=lambda g: self._arm_rate.get(g, float("-inf")),
                       reverse=True)
        chunk_best = prior[0]
        unexplored = [g for g in prior if g not in self._ep_rate
                      and (g <= chunk_best or self._arm_rate.get(g) is None)]
        prev_gamma = self.gamma
        if unexplored:
            self.gamma = unexplored[0]
            self._ep_phase = "explore"
        else:
            ranked = sorted((g for g in self._gamma_choices if g in self._ep_rate),
                            key=lambda g: self._ep_rate[g], reverse=True)
            inc = self._ep_incumbent
            if inc not in self._gamma_choices or inc not in self._ep_rate:
                inc = ranked[0]
            elif (ranked[0] != inc
                  and self._ep_rate[ranked[0]] > self._ep_hysteresis * self._ep_rate[inc]):
                inc = ranked[0]
            self._ep_incumbent = inc
            others = [g for g in prior if g != inc]
            if others and self._ep_count % self._ep_reprobe_every == 0:
                idx = (self._ep_count // self._ep_reprobe_every - 1) % len(others)
                self.gamma = others[idx]
                self._ep_phase = "probe"
            else:
                self.gamma = inc
                self._ep_phase = "exploit"
        if self.gamma != prev_gamma:
            self._resync = True
        self._ep_tokens = 0
        self._ep_completions = 0
        self._ep_start = now

    def adaptive_stats(self) -> dict:
        """A snapshot of the gamma controller."""
        return {
            "mode": self._ag_mode if self._gamma_choices else "fixed",
            "gamma": self.gamma,
            "incumbent": self._ep_incumbent if self._ep_incumbent is not None else self.gamma,
            "acc_ema": self._acc_ema,
            "epoch_rates": dict(self._ep_rate),
            "chunk_rates": dict(self._arm_rate),
            "epoch_phase": self._ep_phase,
            "epochs": self._ep_count,
            "epoch_history": list(self._ep_history),
        }

    # -------------------------------------------------------------------- loop
    def _prepare_chunk(self) -> None:
        self._admit()
        self._ensure_runway()
        self._flush_maintenance()

    def _run_chunk(self) -> None:
        if self._n_prefilling():
            self.interleaved_chunks += 1
        self._harvest(self._meta_np(self._dispatch_chunk()))
        self._epoch_tick()

    def _idle(self) -> None:
        """Nothing runs: the open epoch and the chunk wall restart with the
        next chunk."""
        self._epoch_reset()
        self._last_fetch_t = None

    def step(self) -> int:
        """Admit, grow tables, run one chunk, harvest. Returns the rows
        still busy."""
        self._prepare_chunk()
        if self.num_active:
            self._run_chunk()
        else:
            self._idle()
        return self.num_active

    def run_until_idle(self, max_steps: int = 10_000) -> int:
        """Step until no request is queued or running; returns the chunks run."""
        steps = 0
        while steps < max_steps:
            self._prepare_chunk()
            if not self.num_active:
                self._idle()
                break
            self._run_chunk()
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
