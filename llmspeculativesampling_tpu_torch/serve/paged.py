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

This is the engine's batched step and admission with worst-case page
reservation: a request is admitted when a row and the pages of its whole
worst-case length (prompt + max_new + gamma + 1) are free, prefilled in one
batched forward per model, decoded in ``steps_per_sync``-step chunks with
one packed metadata read per chunk, and harvested (pages freed) when done.
Not ported yet, each raising ``NotImplementedError`` in the constructor:
on-demand paging and preemption (``on_demand``), the prefix cache
(``prefix_cache``), SARATHI chunked prefill (``chunked_prefill``,
``prefill_extra``), adaptive gamma (``adaptive_gamma``) and the
data-parallel mesh (``mesh``).

Differences from the JAX engine that do not change what it computes:
  * the host loop runs eagerly: a chunk ends early when no row is live by
    one small device read (``live.any()``) per step, where JAX exits its
    ``while_loop`` on the device, and each chunk's packed metadata is read
    synchronously, where JAX overlaps the read with the next chunk;
  * an admission batch is not padded to a power of two (nothing is
    compiled per shape), so no padding row exists;
  * dead rows and unused table slots write into the pools' trash block
    (``cache/paged.py``) where JAX drops the write;
  * TTFT is stamped once the admission prefill has finished on the device.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..cache.paged import PageAllocator, init_paged_cache, rollback_rows
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
    resamples b | bonus b | acc_rate_sum (f32 bits) b | acc_len_hist b*h |
    tokens b*t]. The JAX layout also carries the adaptive-gamma deltas and
    the PRNG keys for preemption, neither ported yet."""
    def f(x):
        return x.to(torch.int32).reshape(-1)

    return torch.cat([
        f(state.cur_len), f(state.done), f(state.steps), f(state.accepted),
        f(state.resamples), f(state.bonus),
        state.acc_rate_sum.float().contiguous().view(torch.int32),
        f(state.acc_len_hist), f(state.tokens),
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


# options of the JAX engine that later slices port (ROADMAP "Still to port")
_NOT_YET = {
    "on_demand": "A14 step 2 (on-demand paging and preemption)",
    "prefix_cache": "A12/A14 step 4 (prefix cache)",
    "chunked_prefill": "A14 step 5 (SARATHI chunked prefill)",
    "prefill_extra": "A14 step 5 (SARATHI chunked prefill)",
    "adaptive_gamma": "A14 step 6 (adaptive gamma)",
    "mesh": "A16 (data-parallel mesh)",
}


class PagedEngine:
    """Continuous batching over a paged (optionally int8) KV pool.

    ``submit`` enqueues; ``step`` admits into free rows when the request's
    pages are free, runs one chunk of ``steps_per_sync`` speculative steps
    over every row and harvests finished requests (their pages return to
    the pool); ``run_until_idle`` repeats until the queue drains. Runs on the
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
        on_demand: bool = False,
        prefix_cache: bool = False,
        chunked_prefill: bool = False,
        prefill_extra: int = 0,
        adaptive_gamma=None,
        mesh=None,
        device=None,
    ):
        later = dict(on_demand=on_demand, prefix_cache=prefix_cache,
                     chunked_prefill=chunked_prefill, prefill_extra=prefill_extra,
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
        max_pages = max_pages_per_req or num_blocks
        if max_pages > num_blocks:
            raise ValueError(f"max_pages_per_req={max_pages} exceeds the {num_blocks}-block pool")
        self.allocator = PageAllocator(num_blocks, page, max_pages)
        self.t_max = max_pages * page

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

    def _admit(self) -> None:
        """Admit queued requests in FIFO order while a row and the pages of
        the request's worst case are free: batches of up to 8 of one prompt
        bucket within the prefill token budget, one prefill each."""
        free_rows = [i for i, r in enumerate(self._row_req) if r is None]
        while free_rows and self._pending:
            batch = []  # (row, req, padded prompt, p_len, blocks)
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
                blocks = self.allocator.alloc(p_len + nxt.max_new_tokens + self.gamma + 1)
                if blocks is None:
                    break  # the pool is short: keep it queued
                self._pending.popleft()
                batch.append((free_rows.pop(0), nxt, padded.reshape(-1), p_len, blocks))
            if not batch:
                break
            self._dispatch_prefill(batch)
            now = time.perf_counter()
            for row, req, _, _, blocks in batch:
                req.prefill_time = now
                self._row_req[row] = req
                self._row_blocks[row] = blocks

    def _admission_arrays(self, batch):
        """Admission tensors on the device: rows [K], tables [K, P],
        prompts [K, bucket], p_lens [K], max_news [K], stream keys [K, 2]."""
        dev = self.device

        def t(x, dtype=torch.long):
            return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev)

        return (
            t([e[0] for e in batch]),
            t(np.stack([self.allocator.table_row(e[4]) for e in batch]), torch.int32),
            t(np.stack([e[2] for e in batch])),
            t([e[3] for e in batch]),
            t([e[1].max_new_tokens for e in batch]),
            row_keys(self.seed, [e[1].rid for e in batch], device=dev),
        )

    def _dispatch_prefill(self, batch) -> None:
        self.state = _paged_prefill_body(
            self.params_d, self.params_t, self.state, *self._admission_arrays(batch),
            bundle_d=self.bundle_d, bundle_t=self.bundle_t)
        synchronize(self.device)  # TTFT: the prompts' KV is on the device

    def _dispatch_chunk(self) -> dict:
        self.state, pack = _paged_chunk_body(
            self.params_d, self.params_t, self.state, bundle_d=self.bundle_d,
            bundle_t=self.bundle_t, gamma=self.gamma, scfg=self.scfg,
            eos_token_id=self.eos_token_id, n_steps=self.steps_per_sync)
        return _unpack_chunk_meta(pack.cpu().numpy(), self.batch_rows, self.max_new_cap,
                                  self.t_max)

    def _harvest(self, hv: dict) -> None:
        """Complete the rows the chunk finished, free their pages and
        deactivate them."""
        fin = [i for i, r in enumerate(self._row_req) if r is not None and hv["done"][i]]
        for row in fin:
            req = self._row_req[row]
            p_len = req.prompt.shape[0]
            out = first_eos_truncate(hv["tokens"][row], p_len, int(hv["cur_len"][row]),
                                     self.eos_token_id)
            steps = int(hv["steps"][row])
            now = time.perf_counter()
            details = {
                "ttft_s": req.prefill_time - req.submit_time,
                "latency_s": now - req.submit_time,
                "acc_len": hv["acc_len_hist"][row][:steps].tolist(),
                "acc_rate": float(hv["acc_rate_sum"][row]) / max(steps * self.gamma, 1),
                "target_call_times": steps,
                "approx_call_times": steps,
                "accepted_count": int(hv["accepted"][row]),
                "resample_count": int(hv["resamples"][row]),
                "target_sample_count": int(hv["bonus"][row]),
                "tokens_generated": len(out) - p_len,
                "prefix_cached_tokens": 0,
            }
            self.completions[req.rid] = Completion(req.rid, out, p_len, details)
            self.allocator.free(self._row_blocks[row])
            self._row_req[row] = None
            self._row_blocks[row] = None
        if fin:
            self.state.active[torch.as_tensor(fin, device=self.device)] = False

    def step(self) -> int:
        """Admit, run one chunk, harvest. Returns the rows still busy."""
        self._admit()
        if self.num_active:
            self._harvest(self._dispatch_chunk())
        return self.num_active

    def run_until_idle(self, max_steps: int = 10_000) -> int:
        """Step until no request is queued or running; returns the chunks run."""
        steps = 0
        while steps < max_steps:
            self._admit()
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
