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
A batch of cold prompts is prefilled padded to a power of two rows, as
JAX's, over the static buffers of its (padded rows, bucket) shape
(``_dispatch_prefill``); on the card without a mesh, a padded batch within
the prefill token budget replays one captured graph of both models'
forwards. A lone prompt over the budget, the CPU and meshes run those
forwards eagerly, as prefix-cache hits and staged admissions run theirs.
A chunk is one captured step replayed on the card
(``serve/batched.py::run_chunk``; one graph per gamma arm and
``prefill_extra``) until a device flag says no row is live, read one step
behind. ``run_until_idle`` is JAX's one-deep pipeline: chunk k+1 is
dispatched before chunk k's metadata (copied into pinned memory behind it)
is read, and the host's view of each row (length, done) lags the device by
up to two chunks: the tables' runway covers two chunks, and every harvest,
preemption resume and prefix registration is gated on the row's occupancy
generation (``_row_gen``), so late metadata never touches a row's next
occupant. ``step()`` reads its own chunk at once (the server and the
lockstep drivers drive it). Host-to-device copies leave pinned memory
without blocking, so nothing between a dispatch and the previous chunk's
harvest waits for the card.

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
over tp and give every rank the full vocab. Over dp the rows and the block
pool split statically (JAX ``serve/paged.py``'s dp design): row r lives on
dp shard ``r // (B/dp)``, over that shard's own ``N/dp``-block pool, whose
host allocator hands out shard-local block ids; params are replicated.
Every rank runs the whole host plan (every shard's allocator, JAX's single
controller), and its device holds only its shard: it dispatches its own
segment of each admission and runs the chunk over its own rows, with no
cross-dp collective inside a chunk, a prefill or an extend window. The
only exchange across dp is the gather of each chunk's packed metadata
(``parallel/distributed.py::host_fetch``), merged shard by shard, so every
host decision is the same on every rank. A shard's rows share prefix
pages only with that shard's rows, and a preempted row is its own
shard's youngest. Adaptive gamma reads rank 0's clock on every rank
(``rank0_clock``: one broadcast a chunk), so the ranks pick the same arm.

Differences from the JAX engine that do not change what it computes:
  * only a cold prefill's batch is padded to a power of two (a pad row
    holds filler tokens and the sentinel table, so it writes the trash
    block); extend windows and staged admissions run their real rows alone;
  * dead rows, unused table slots, an extend window's padding and the rows
    it has exhausted write into the pools' trash block (``cache/paged.py``)
    where JAX drops the write;
  * TTFT is the time the admission prefill (or the extend) finished on
    the device, read from an event recorded behind it at the first harvest
    that finds it complete (no host synchronize), where JAX stamps the
    dispatch; a staged row's when the host sees its prefill complete, as in
    JAX;
  * the adaptive-gamma controller's chunk wall is the gap between two
    metadata fetches, as in JAX's pipeline, under ``step()`` too (JAX's
    ``step()`` measures none: its log of unread chunks is empty at every
    dispatch);
  * a completion's ``acc_rate`` divides by the drafts the row made (each
    chunk's steps times that chunk's gamma), where JAX takes the current
    gamma for all of them: the same under a fixed gamma.

Under a ``torch.profiler`` session the loop records its spans
(``utils/profiling.py::span``): ``paged.admit`` (admission, table growth,
the maintenance flush), with a ``paged.prefill`` for each admission
batch's dispatch (its device interval between two events on the stream;
``graph`` 1 when it replayed a captured prefill, else 0), and
``paged.harvest`` (the metadata read, the harvest, the epoch tick).
``prefill_replays`` and ``prefill_eager`` count the admission dispatches
that replayed a graph and those that ran eagerly.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
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
from ..core.config import resolve_device
from ..engine import device_loop
from ..engine.speculative import draft_phase_batched, verify_phase_batched
from ..engine.types import ModelBundle, first_eos_truncate, pad_prompt
from ..models.llama import unstack_layers
from ..ops.sampling import SamplingConfig, dist_map, row_keys
from ..parallel.distributed import rank0_clock
from ..parallel.sharding import (
    DP_AXIS,
    local_heads,
    place,
    require_divides,
    shard_for,
    shard_paged_state,
)
from ..utils.profiling import span
from .batched import (
    BatchState,
    DeviceClock,
    MetaCopies,
    accept_rows,
    admit_rows,
    commit_rows,
    run_chunk,
    stamp_prefills,
    to_device,
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
    """One speculative step of every row, in place (a function of tensors
    only: the captured serving step); returns ``state``. Dead rows
    (inactive or done) run through the batched forwards too; their tables are gated to the
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

    tokens3, new_len, n, all_acc, acc_step, keys = accept_rows(
        gamma, tokens2, cur_len, q_stack, drafts, p_stack, keys)
    new_len = torch.where(prefilling, torch.minimum(cur_len + gamma + prefill_extra,
                                                    state.prefill_to), new_len)
    tokens3 = torch.where(prefilling[:, None], tokens, tokens3)
    keys = torch.where(prefilling[:, None], state.key, keys)
    commit_rows(state, tokens3, new_len, n, all_acc, acc_step, keys, eos_token_id, live,
                live & ~prefilling, draft_cache.lengths, target_cache.lengths)
    return state


def _paged_chunk_body(params_d, params_t, state: PagedBatchState, *, bundle_d, bundle_t,
                      gamma: int, scfg: SamplingConfig, eos_token_id: int, n_steps: int,
                      prefill_extra: int = 0, replay: bool = False):
    """Up to ``n_steps`` steps, ending once no row is live
    (``serve/batched.py::run_chunk``: on the card one captured step per
    gamma and ``prefill_extra``, replayed with the device flag read one
    step behind). Returns (state, packed metadata), the metadata with the
    chunk's accepted-token and step deltas, which feed the adaptive-gamma
    controller."""
    a0, s0 = state.accepted.sum(), state.steps.sum()
    run_chunk(("serve_paged", bundle_d, bundle_t, gamma, prefill_extra, scfg, eos_token_id),
              (params_d, params_t), state,
              lambda st: _paged_spec_step(bundle_d, bundle_t, params_d, params_t, scfg, gamma,
                                          eos_token_id, st, prefill_extra), n_steps, replay)
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
        cache.lengths.index_fill_(0, rows, 0)


def _install_state(state: PagedBatchState, rows, prompts, p_lens, max_news, keys,
                   cur0=None) -> None:
    """Install admitted rows' scheduler metadata in place (``admit_rows``)
    and their ``prefill_to = p_len``. ``cur_len`` starts at ``cur0``
    (default p_len); a staged row passes cached_len + 1 and enters the step
    loop mid-prompt, ``prefill_to`` marking where its prefill ends."""
    admit_rows(state, rows, prompts, p_lens, max_news, keys, cur0)
    state.prefill_to[rows] = p_lens


def _paged_prefill_forwards(params_d, params_t, state: PagedBatchState, tables, zeros, prompts,
                            *, bundle_d: ModelBundle, bundle_t: ModelBundle) -> None:
    """An admission's pool writes: one batched prefill forward per model of
    ``prompts`` [K, bucket] over a K-row view of the state's pools with
    ``tables`` [K, P] and empty rows (``zeros`` [K]). Block tables of
    different requests are disjoint, so the rows write disjoint pages (a
    pad row's sentinel table, the trash block). A function of tensors only:
    the captured admission prefill."""
    for bundle, params, cache in ((bundle_d, params_d, state.draft_cache),
                                  (bundle_t, params_t, state.target_cache)):
        view = dataclasses.replace(cache, block_tables=tables, lengths=zeros)
        bundle.forward(params, bundle.cfg, prompts, view, paged_prefill=True)


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
    card unless ``device="cpu"``; the params must lie on that device.
    ``mesh`` above dp 1 needs ``batch_rows`` and ``num_blocks`` divisible
    by dp and ``max_pages_per_req`` within a shard's ``num_blocks/dp``."""

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
        # the admission prefill's static buffers and graphs, (padded rows,
        # bucket) -> entry; the graphs share one memory pool: they replay one
        # at a time on the engine's stream, and what they write lands in the
        # pools and the state
        self._graph_prefill = self.device.type == "cuda" and mesh is None
        self._prefill_graphs: dict = {}
        self._prefill_pool = None
        self.prefill_replays = 0  # admission dispatches that replayed a captured prefill
        self.prefill_eager = 0    # admission dispatches that ran eagerly
        # dp (JAX serve/paged.py:896-923): rows [s*B/dp, (s+1)*B/dp) live on
        # shard s over its own N/dp-block pool; this rank's device holds
        # shard ``_shard``, its host every shard's allocator
        self.dp = mesh.dp if mesh is not None else 1
        self._shard = mesh.dp_rank if mesh is not None else 0
        self._rows_local = require_divides(batch_rows, mesh, "batch_rows")
        blocks_local = require_divides(num_blocks, mesh, "num_blocks")
        max_pages = max_pages_per_req or num_blocks
        if max_pages > blocks_local:
            raise ValueError(f"max_pages_per_req={max_pages} exceeds the {blocks_local}-block pool"
                             + (f" of a dp={self.dp} shard" if self.dp > 1 else ""))
        alloc_cls = SharedPageAllocator if self.prefix_cache else PageAllocator
        self._allocs = [alloc_cls(blocks_local, page, max_pages) for _ in range(self.dp)]
        self.allocator = self._allocs[0]  # the pool's (dp shard 0's above dp 1)
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
        # (gamma, live rows) of each dispatched chunk whose metadata is unread
        self._chunk_log: collections.deque = collections.deque()
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

        # this rank's shard, built at its local size: its rows, its pool
        # half (a trash block of its own, so the sentinel is blocks_local)
        # and its kv heads
        dev, bl = self.device, self._rows_local

        def pool(cfg):
            return init_paged_cache(cfg.num_layers, blocks_local, local_heads(cfg, mesh)[1], page,
                                    cfg.head_dim, bl, max_pages, cfg.torch_dtype, quant=kv_quant,
                                    device=dev)

        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.state = PagedBatchState(
            tokens=zeros(bl, self.t_max),
            cur_len=torch.full((bl,), 2, dtype=torch.long, device=dev),
            draft_cache=pool(bundle_d.cfg),
            target_cache=pool(bundle_t.cfg),
            key=zeros(bl, 2),
            active=zeros(bl, dtype=torch.bool),
            done=torch.ones((bl,), dtype=torch.bool, device=dev),
            target_len=torch.full((bl,), self.t_max, dtype=torch.long, device=dev),
            prefill_to=zeros(bl),
            accepted=zeros(bl), resamples=zeros(bl), bonus=zeros(bl), steps=zeros(bl),
            acc_rate_sum=zeros(bl, dtype=torch.float32),
            acc_len_hist=zeros(bl, max_new_cap),
        )
        self._tag_state()
        b = batch_rows  # the host's view: every shard's rows
        self._next_rid = 0
        self._pending: collections.deque[Request] = collections.deque()
        self._row_req: list[Optional[Request]] = [None] * b
        self._row_blocks: list[Optional[list]] = [None] * b
        # occupancy generation per row (admission and preemption bump it):
        # metadata of a chunk dispatched under an earlier occupancy never
        # updates, harvests or resumes the current one
        self._row_gen: list[int] = [0] * b
        self.completions: dict[int, Completion] = {}
        # on-demand paging: the host's view of each row's length and done
        # flag (the last harvest's, up to two chunks behind the device under
        # the pipeline), the worst-case pages each row and all rows commit,
        # rows to deactivate and whether the device's tables are behind the
        # host's
        self._row_len: list[int] = [0] * b
        self._row_done: list[bool] = [False] * b
        self._row_commit: list[int] = [0] * b
        self._commit_pages = [0] * self.dp  # per shard
        self._deact_rows: set = set()
        self._tables_dirty = False
        self._last_harvest: Optional[dict] = None
        self._last_harvest_gens: Optional[tuple] = None  # the generations it was read under
        self.preemptions = 0
        self.masked_steps = 0  # chunk steps that found no live row
        self._meta = MetaCopies(self.device, mesh)
        self._clock_dev = DeviceClock(self.device)
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

    def _clock(self) -> float:
        """The controller's clock: with adaptive gamma, rank 0's on every
        rank of a mesh (one broadcast); else the local one, which nothing
        decides from."""
        if not self._gamma_choices:
            return time.perf_counter()
        return rank0_clock(self.mesh, self.device)

    def _tag_state(self) -> None:
        """Tag this rank's state with its placement (``.sharding``), as the
        shard of a ``(dp, tp)`` layout, so ``host_fetch`` reads it whole."""
        if self.mesh is not None:
            self.state = shard_paged_state(self.state, self.mesh, local=True)

    def _shard_of(self, row: int) -> int:
        return row // self._rows_local

    def _alloc_of(self, row: int):
        return self._allocs[self._shard_of(row)]

    def _local_rows(self, rows) -> list:
        """This rank's rows among ``rows``, as local row ids."""
        lo = self._shard * self._rows_local
        return [r - lo for r in rows if self._shard_of(r) == self._shard]

    # --------------------------------------------------------------- interface
    def warmup(self, prompt_lens=(8,)) -> None:
        """Run JAX's warm-up traffic (``serve/paged.py::warmup``) before live
        traffic: for each prompt length, admission waves of 1, 2, 4 and 8
        requests (the padded shapes of the captured prefill, each captured
        now when it fits the budget) and their chunks, each adaptive arm, a
        prefix-cache hit and, with chunked prefill, a staged admission. The
        first launches happen now too: the kernels build, B1 encodes its
        tensor maps, the allocator grows. Leaves the gamma controller
        pristine and the rid sequence where it was."""
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

    def _reserve(self, req: Request, p_len: int, hashes: List[bytes], shard: int):
        """Pages to admit ``req`` in dp shard ``shard``: its worst case, or on
        demand its prompt plus a two-chunk runway, sharing the longest
        prefix chain registered in that shard when the prefix cache is on.
        Returns (blocks, cached_len, committed pages), or None (and holds
        nothing) while the shard's pool or, on demand, its commitment
        watermark cannot take it: the shard's rows' worst-case pages, this
        one's included, must stay within ``overcommit`` times its pool.
        Shared pages are charged to their first holder only."""
        alloc = self._allocs[shard]
        worst = p_len + req.max_new_tokens + self._gam_max + 1
        total = min(worst, p_len + 2 * self._chunk_runway) if self.on_demand else worst
        if self.prefix_cache:
            got = alloc.alloc_shared(total, hashes)
            if got is None:
                return None
            blocks, cached_len = got
        else:
            blocks, cached_len = alloc.alloc(total), 0
            if blocks is None:
                return None
        if not self.on_demand:
            return blocks, cached_len, 0
        commit = alloc.pages_needed(worst) - cached_len // self.page
        if self._commit_pages[shard] + commit > alloc.num_blocks * self.overcommit:
            alloc.free(blocks)
            return None
        return blocks, cached_len, commit

    def _admit(self) -> None:
        """Admit queued requests in FIFO order while a row and their pages
        are free: batches of up to 8 of one prompt bucket whose row count
        padded to a power of two, times the bucket, stays within the prefill
        token budget. A request tries each dp shard that has a free row, in
        row order, with that shard's pages (JAX ``_admit``): one full shard
        does not hold the queue while another has room. With chunked prefill, while some row decodes, a
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
                # the batch padded to a power of two rows stays within the budget
                kb_next = 1 << len(batch).bit_length()
                if batch and kb_next * bucket > self.prefill_token_budget:
                    break
                hashes = prompt_page_hashes(nxt.prompt, self.page) if self.prefix_cache else []
                row = got = None
                for shard in dict.fromkeys(self._shard_of(r) for r in free_rows):
                    got = self._reserve(nxt, p_len, hashes, shard)
                    if got is not None:
                        row = next(r for r in free_rows if self._shard_of(r) == shard)
                        break
                if got is None:
                    break  # every shard with a free row is short: keep it queued
                blocks, cached_len, commit = got
                self._pending.popleft()
                free_rows.remove(row)
                self._row_commit[row] = commit
                self._commit_pages[self._shard_of(row)] += commit
                batch.append(Admission(row, nxt, padded.reshape(-1), p_len, blocks, cached_len,
                                       hashes))
            if not batch:
                break
            # staging protects decoding rows from a prompt forward's stall;
            # with none decoding, the monolithic prefill is faster
            decoding = any(r is not None and self._row_len[row] >= len(r.prompt)
                           and not self._row_done[row] for row, r in enumerate(self._row_req))
            inline, staged = [], []
            for e in batch:
                stage = (self.chunked_prefill and decoding
                         and e.p_len - e.cached_len > self.extend_chunk)
                (staged if stage else inline).append(e)
            misses = [e for e in inline if e.cached_len == 0]
            hits = [e for e in inline if e.cached_len > 0]
            for part, dispatch in ((misses, self._dispatch_prefill),
                                   (hits, self._dispatch_extend),
                                   (staged, self._stage_admission)):
                if part:
                    with span("paged.prefill", device=self._clock_dev) as sp:
                        replayed = bool(dispatch(part))
                        sp.set(graph=int(replayed))
                    if replayed:
                        self.prefill_replays += 1
                    else:
                        self.prefill_eager += 1
            mark = self._clock_dev.mark()  # behind the prefills and the extend windows
            for e in inline:
                if e.req.prefill_time is None and e.req.prefill_mark is None:
                    e.req.prefill_mark = mark  # a resumed request keeps its TTFT
                self._install_row(e, e.p_len)
                if e.hashes:  # in the row's shard: its pages live in that pool
                    self._alloc_of(e.row).register(e.hashes, e.blocks[:len(e.hashes)])

    def _install_row(self, e: Admission, row_len: int) -> None:
        """The host's bookkeeping of an admitted row. The admission installed
        its state, so a deactivation still pending for the row's previous
        request (one drained by ``drain_requests``) must not reach it."""
        self._deact_rows.discard(e.row)
        e.req.cached_len = e.cached_len
        self._row_req[e.row] = e.req
        self._row_blocks[e.row] = e.blocks
        self._row_gen[e.row] += 1
        self._row_len[e.row] = row_len
        self._row_done[e.row] = False
        self._row_steps[e.row] = 0
        self._row_drafted[e.row] = 0

    # ------------------------------------------------- SARATHI chunked prefill
    def _stage_admission(self, batch: List[Admission]) -> None:
        """Admit cold prompts that ride the decode chunks (JAX
        ``_stage_admission``): the draft is prefilled now, in draft-only
        extend windows; the rows are installed at ``cur_len = cached + 1``
        (the +1 keeps the verify's rollback writes, at cur_len - 1, out of
        shared pages) with ``prefill_to = p_len``, and the chunks' verify
        passes compute their target KV. TTFT is stamped, and the prompt
        pages registered, once ``_harvest`` sees the prefill complete."""
        seg = self._admission_arrays(batch)
        if seg is not None:
            arrays, keys = seg
            for j in range(self._extend_n_chunks(arrays)):
                self._extend_window(arrays, j, draft_only=True)
            _, _, _, p_lens, _, cached = arrays
            self._finalize_admission(arrays, keys, np.minimum(cached + 1, p_lens))
        for e in batch:
            self._install_row(e, min(e.cached_len + 1, e.p_len))
            if e.hashes:
                self._pending_reg[e.row] = (e.req, e.hashes, list(e.blocks[:len(e.hashes)]))

    def _n_prefilling(self) -> int:
        """Rows still prefilling, as the host sees them."""
        return sum(1 for row, req in enumerate(self._row_req)
                   if req is not None and self._row_len[row] < len(req.prompt))

    # ------------------------------------------------------- on-demand paging
    def _ensure_runway(self) -> None:
        """Grow each running row's table to cover two chunks past its last
        known length (the harvest's view lags the device by up to two
        chunks under the pipeline), capped at its worst case (the admission
        commitment's basis, so overcommit 1.0 never preempts) and at the
        table's width. Rows known done are skipped. When the row's shard
        pool is empty, preempt that shard's youngest running row."""
        if not self.on_demand:
            return
        for row in range(self.batch_rows):
            req = self._row_req[row]
            if req is None or self._row_done[row]:
                continue
            need = min(self._row_len[row] + 2 * self._chunk_runway,
                       len(req.prompt) + req.max_new_tokens + self._gam_max + 1, self.t_max)
            while (self._row_req[row] is not None
                   and len(self._row_blocks[row]) * self.page < need):
                alloc = self._alloc_of(row)
                blk = alloc.alloc_one()
                if blk is not None:
                    self._row_blocks[row].append(blk)
                    self._tables_dirty = True
                    continue
                victim = self._pick_victim(self._shard_of(row))
                if victim is None:
                    break  # nothing to preempt; the next chunk's harvest frees rows
                if victim == row and alloc.num_blocks * self.page < need:
                    raise RuntimeError(f"request {req.rid} needs {need} cache positions but the "
                                       f"pool holds {alloc.num_blocks * self.page}")
                self._preempt_row(victim)  # the needy row itself exits the loop

    def _pick_victim(self, shard: int) -> Optional[int]:
        """The youngest (highest-rid) running row of dp shard ``shard``, the
        one whose pool is short, rows known done excluded: first come,
        first served, and a resumed request (an old rid) is protected.
        None when no row qualifies."""
        lo = shard * self._rows_local
        rows = [r for r in range(lo, lo + self._rows_local)
                if self._row_req[r] is not None and not self._row_done[r]]
        return max(rows, key=lambda r: self._row_req[r].rid) if rows else None

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

        The snapshot is the last harvest's, taken under the row's current
        occupancy generation only (JAX's guard against its one-deep
        pipeline); the chunk in flight may have gone further, and the
        resumed run redoes that work from the snapshot's key. That chunk may
        still write the freed pages: the stream orders those writes before
        any later owner's, and no position is read before its owner writes
        it."""
        req = self._row_req[row]
        hv, gens = self._last_harvest, self._last_harvest_gens
        resume = req
        if (hv is not None and gens is not None and gens[row] == self._row_gen[row]
                and int(hv["steps"][row]) > 0):
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
                prefill_time=req.prefill_time, prefill_mark=req.prefill_mark,
                resume_key=hv["key"][row].copy(), carry=carry, orig_prompt_len=orig_plen)
        self._alloc_of(row).free(self._row_blocks[row])
        self._pending_reg.pop(row, None)
        self._commit_pages[self._shard_of(row)] -= self._row_commit[row]
        self._row_commit[row] = 0
        self._row_req[row] = None
        self._row_blocks[row] = None
        self._row_gen[row] += 1
        self._row_done[row] = False
        self._deact_rows.add(row)
        self._tables_dirty = True
        self._pending.appendleft(resume)
        self.preemptions += 1

    def _flush_maintenance(self) -> None:
        """Send this rank's rows' tables (shard-local block ids; one
        host-to-device copy) and their pending deactivations to the device
        before the next chunk."""
        if not (self._tables_dirty or self._deact_rows):
            return
        alloc, lo = self._allocs[self._shard], self._shard * self._rows_local
        tables = np.stack([alloc.table_row(b or [])
                           for b in self._row_blocks[lo:lo + self._rows_local]])
        deact = np.zeros((self._rows_local,), bool)
        deact[self._local_rows(self._deact_rows)] = True
        self.state = _paged_maintain_body(
            self.state, self._dev(tables, torch.int32), self._dev(deact, torch.bool))
        self._deact_rows.clear()
        self._tables_dirty = False

    # ---------------------------------------------------------------- dispatch
    def _admission_arrays(self, batch: List[Admission]):
        """Host arrays of this rank's segment of an admission batch (the
        entries whose row lives in its dp shard; JAX's dp-segmented layout
        without the padding): local rows [K], shard-local tables [K, P],
        prompts [K, bucket], p_lens [K], max_news [K], cached lengths [K];
        and the rows' stream keys [K, 2] on the device: (seed, rid)'s, or a
        resumed request's evolved key. None when the segment is empty: the
        rank then dispatches nothing."""
        batch = [e for e in batch if self._shard_of(e.row) == self._shard]
        if not batch:
            return None
        keys = row_keys(self.seed, [e.req.rid for e in batch])  # on the host
        for i, e in enumerate(batch):
            if e.req.resume_key is not None:
                keys[i] = torch.as_tensor(e.req.resume_key, dtype=torch.long)
        keys = self._dev(keys)
        alloc = self._allocs[self._shard]
        arrays = (
            np.asarray(self._local_rows([e.row for e in batch])),
            np.stack([alloc.table_row(e.blocks) for e in batch]),
            np.stack([e.prompt for e in batch]),
            np.asarray([e.p_len for e in batch]),
            np.asarray([e.req.max_new_tokens for e in batch]),
            np.asarray([e.cached_len for e in batch]),
        )
        return arrays, keys

    def _dev(self, x, dtype=torch.long) -> torch.Tensor:
        return to_device(x, dtype, self.device)

    def _install_args(self, arrays, keys):
        """(rows, tables, prompts, p_lens, max_news, keys) on the device."""
        rows, tables, prompts, p_lens, max_news, _ = arrays
        return (self._dev(rows), self._dev(tables, torch.int32), self._dev(prompts),
                self._dev(p_lens), self._dev(max_news), keys)

    def _dispatch_prefill(self, batch: List[Admission]) -> bool:
        """Cold misses: both models' prefill forwards over the batch padded
        to the next power of two rows, K_pad (JAX's ``kbs``; a pad row has a
        filler prompt and the sentinel table), in the static buffers of its
        (K_pad, bucket) entry, then the real rows' install. On the card
        without a mesh, a padded batch within the prefill token budget
        replays the entry's graph (``device_loop.run_once``: the first use of
        a shape runs eagerly, then is captured); a lone prompt over the
        budget (bound by the card), the CPU and meshes run the forwards
        eagerly. Returns whether a graph was replayed."""
        seg = self._admission_arrays(batch)
        if seg is None:
            return False
        (rows, tables, prompts, p_lens, max_news, _), keys = seg
        k, bucket = prompts.shape
        k_pad = 1 << (k - 1).bit_length()
        entry = self._prefill_entry(k_pad, bucket)
        buf_prompts, buf_tables, zeros = entry.state
        pad = ((0, k_pad - k), (0, 0))
        sentinel = self._allocs[self._shard].num_blocks
        buf_prompts.copy_(self._dev(np.pad(prompts, pad)))
        buf_tables.copy_(self._dev(np.pad(tables, pad, constant_values=sentinel), torch.int32))
        replayed = device_loop.run_once(
            entry, functools.partial(_paged_prefill_forwards, self.params_d, self.params_t,
                                     self.state, buf_tables, zeros, buf_prompts,
                                     bundle_d=self.bundle_d, bundle_t=self.bundle_t),
            self.device, self._graph_prefill and k_pad * bucket <= self.prefill_token_budget,
            self._prefill_pool)
        self.state = _paged_finalize_body(self.state, self._dev(rows), buf_tables[:k],
                                          buf_prompts[:k], self._dev(p_lens),
                                          self._dev(max_news), keys)
        return replayed

    def _prefill_entry(self, k_pad: int, bucket: int):
        """The static buffers (prompts [k_pad, bucket], tables [k_pad, P],
        zero lengths [k_pad]) and the graph of one padded admission shape."""
        entry = self._prefill_graphs.get((k_pad, bucket))
        if entry is None:
            if self._prefill_pool is None and self.device.type == "cuda":
                self._prefill_pool = torch.cuda.graph_pool_handle()
            dev, p = self.device, self.state.target_cache.block_tables.shape[1]
            entry = self._prefill_graphs[(k_pad, bucket)] = device_loop._Entry((
                torch.zeros((k_pad, bucket), dtype=torch.long, device=dev),
                torch.zeros((k_pad, p), dtype=torch.int32, device=dev),
                torch.zeros((k_pad,), dtype=torch.int32, device=dev)), [])
        return entry

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
        tabs = np.where(live[:, None], tables, self._allocs[self._shard].num_blocks)
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
        seg = self._admission_arrays(batch)
        if seg is None:
            return
        arrays, keys = seg
        for j in range(self._extend_n_chunks(arrays)):
            self._extend_window(arrays, j)
        self._finalize_admission(arrays, keys)

    def _dispatch_chunk(self) -> torch.Tensor:
        """Run one chunk at the controller's gamma; returns its packed
        metadata. In epoch mode the first dispatch opens the epoch, and the
        ramp epoch rotates the arms chunk by chunk (``_ramp_rotations``
        cycles), then settles on the best per-chunk rate."""
        if self._gamma_choices and self._ag_mode == "epoch":
            if self._ep_start is None:
                self._ep_start = self._clock()
            if self._ep_phase == "ramp":
                arms = self._gamma_choices
                k = self._ramp_chunks
                self._ramp_chunks = k + 1
                if k < self._ramp_rotations * len(arms):
                    self.gamma = arms[k % len(arms)]
                else:
                    self.gamma = max(arms, key=lambda g: self._arm_rate.get(g, float("-inf")))
        self._chunk_log.append((self.gamma, max(self.num_active, 1)))
        self.state, pack = _paged_chunk_body(
            self.params_d, self.params_t, self.state, bundle_d=self.bundle_d,
            bundle_t=self.bundle_t, gamma=self.gamma, scfg=self.scfg,
            eos_token_id=self.eos_token_id, n_steps=self.steps_per_sync,
            prefill_extra=self.prefill_extra,
            replay=self.device.type == "cuda" and self.mesh is None)
        self.masked_steps += device_loop.last_chunk[1]
        self._tag_state()
        if self.mesh is not None and pack is not None:  # this rank's segment of the rows
            place(pack, (DP_AXIS,), self.mesh, local=True)
        return pack

    def _meta_np(self, ticket) -> dict:
        """Read the oldest unread chunk's packed metadata (its device-to-host
        copy, started at dispatch; gathered across dp: every shard's
        segment, merged as JAX's ``_meta_np`` does) and feed the gamma
        controller: the shards' summed accepted and step deltas and the
        chunk's wall, the gap since the previous read (None after an idle
        step) times the live rows, as JAX normalises it, on rank 0's clock.
        The chunk's gamma rides along under "gamma"."""
        bl, h, t = self._rows_local, self.max_new_cap, self.t_max
        shards = [_unpack_chunk_meta(seg, bl, h, t)
                  for seg in self._meta.fetch(ticket).reshape(self.dp, -1)]
        hv = {k: np.concatenate([sh[k] for sh in shards]) for k in shards[0]
              if k not in ("acc_delta", "step_delta")}
        g, live = self._chunk_log.popleft()
        hv["gamma"] = g
        now = self._clock()
        wall = None if self._last_fetch_t is None else max(now - self._last_fetch_t, 1e-9) * live
        self._last_fetch_t = now
        self._update_gamma(float(sum(sh["acc_delta"] for sh in shards)),
                           float(sum(sh["step_delta"] for sh in shards)), g, wall)
        return hv

    def _harvest(self, hv: dict, gens: tuple) -> None:
        """Keep the chunk's snapshot and the row generations it was read
        under (``gens``, recorded at its dispatch). For each row still in
        the occupancy the chunk ran: its length and done flag (for table
        growth and preemption), its drafts, the TTFT of a staged row whose
        prefill the chunk completed, and its deferred prefix pages; then
        complete the rows it finished, merging a resumed request's carried
        counters, free their pages and deactivate them. Metadata of an
        earlier occupancy (a row preempted or refilled since its dispatch)
        touches nothing. Also stamps the TTFT of every admission prefill the
        device has completed."""
        self._last_harvest, self._last_harvest_gens = hv, gens
        stamp_prefills(self._clock_dev, self._row_req)
        g = hv["gamma"]
        mine = [i for i, r in enumerate(self._row_req)
                if r is not None and gens[i] == self._row_gen[i]]
        for i in mine:
            r = self._row_req[i]
            self._row_len[i] = int(hv["cur_len"][i])
            self._row_done[i] = bool(hv["done"][i])
            steps = int(hv["steps"][i])
            self._row_drafted[i] += (steps - self._row_steps[i]) * g
            self._row_steps[i] = steps
            if (r.prefill_time is None and r.prefill_mark is None
                    and self._row_len[i] >= len(r.prompt)):
                r.prefill_time = time.perf_counter()  # a staged row: its prefill just completed
        for row, (req, hashes, blocks) in list(self._pending_reg.items()):
            if self._row_req[row] is not req:
                del self._pending_reg[row]
            elif self._row_len[row] >= len(req.prompt):
                self._alloc_of(row).register(hashes, blocks)
                del self._pending_reg[row]
        fin = [i for i in mine if hv["done"][i]]
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
            self._alloc_of(row).free(self._row_blocks[row])
            self._commit_pages[self._shard_of(row)] -= self._row_commit[row]
            self._row_commit[row] = 0
            self._row_req[row] = None
            self._row_blocks[row] = None
        local = self._local_rows(fin)
        if local:
            self.state.active.index_fill_(0, self._dev(local), False)

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

    def _epoch_tick(self, now: Optional[float] = None) -> None:
        """Epoch mode (JAX ``_epoch_tick``): close the epoch once a full row
        turnover has completed (or, exploring, once its wall passes
        ``_ep_wall_cap`` times the best pace), credit the arm with the
        epoch's completed tokens per second (the ramp's arm-mixed epoch
        credits none), and pick the next arm: unexplored arms no deeper than
        the best per-chunk rate first, then the incumbent (a challenger
        must beat it by ``_ep_hysteresis``), probing the others every
        ``_ep_reprobe_every`` epochs. An arm switch holds admission until a
        full wave of rows is free. ``now``: the chunk read's clock, else
        read here (rank 0's)."""
        if not self._gamma_choices or self._ag_mode != "epoch" or self._resync:
            return
        if now is None:
            now = self._clock()
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
        with span("paged.admit"):
            self._admit()
            self._ensure_runway()
            self._flush_maintenance()

    def _start_chunk(self):
        """Dispatch a chunk and start its metadata's copy; returns (ticket,
        the row generations at its dispatch)."""
        if self._n_prefilling():
            self.interleaved_chunks += 1
        gens = tuple(self._row_gen)
        return self._meta.start(self._dispatch_chunk()), gens

    def _finish_chunk(self, inflight) -> None:
        with span("paged.harvest"):
            ticket, gens = inflight
            self._harvest(self._meta_np(ticket), gens)
            self._epoch_tick(self._last_fetch_t)

    def _idle(self) -> None:
        """Nothing runs: the open epoch and the chunk wall restart with the
        next chunk."""
        self._epoch_reset()
        self._last_fetch_t = None

    def step(self) -> int:
        """Admit, grow tables, run one chunk, harvest it: synchronous, as
        JAX's ``step`` (the server and the lockstep drivers drive it).
        Returns the rows still busy."""
        self._prepare_chunk()
        if self.num_active:
            self._finish_chunk(self._start_chunk())
        else:
            self._idle()
        return self.num_active

    def run_until_idle(self, max_steps: int = 10_000) -> int:
        """Drain the queue with JAX's one-chunk-deep pipeline: admit, grow
        tables, dispatch chunk k+1 and start the copy of its metadata, THEN
        read chunk k's and harvest it under the row generations recorded at
        its dispatch, so the card runs chunk k+1 while the host harvests
        chunk k. Under a mesh every rank keeps this order (dispatch, then
        ``host_fetch``). Stops when nothing was dispatched and nothing is in
        flight; returns the chunks run."""
        steps = 0
        inflight = None
        while steps < max_steps:
            self._prepare_chunk()
            dispatched = None
            if self.num_active:
                dispatched = self._start_chunk()
                steps += 1
            if inflight is not None:
                self._finish_chunk(inflight)
            inflight = dispatched
            if inflight is None:
                self._idle()
                break
        if inflight is not None:
            self._finish_chunk(inflight)
        return steps

    def result(self, rid: int) -> Optional[Completion]:
        return self.completions.pop(rid, None)

    def partial_result(self, rid: int) -> Optional[np.ndarray]:
        """Tokens committed so far (prompt + new, not yet EOS-truncated) of a
        request still on a row; None otherwise. From the last harvest's
        merged metadata (the same on every rank, whichever dp shard holds
        the row), or the row's prompt up to its installed length when no
        harvest has read the row since admission: under ``run_until_idle``'s
        pipeline the device may be one chunk ahead of it."""
        for row, req in enumerate(self._row_req):
            if req is not None and req.rid == rid:
                hv, gens = self._last_harvest, self._last_harvest_gens
                if hv is None or gens[row] != self._row_gen[row]:
                    return np.asarray(req.prompt[:self._row_len[row]], np.int32)
                return hv["tokens"][row][:int(hv["cur_len"][row])].astype(np.int32)
        return None
