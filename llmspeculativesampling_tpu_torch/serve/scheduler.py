"""Slot-based continuous batching, and the request and completion records of
both serving engines (counterpart of
``llmspeculativesampling_tpu/serve/scheduler.py``).

:class:`ContinuousBatchingEngine` decodes a static batch of ``num_slots``
slots in lockstep over one contiguous KV cache ``[L, S, H_kv, S_max, D]``
per model whose per-slot lengths live on the device
(``cache/kvcache.py``): the batched speculative step of
``serve/batched.py`` (draft, one target verify over every slot's window,
accept per slot) runs through the flash-decode kernel with per-row lengths,
so the target verify is one ``[S * (gamma + 1)]``-token forward. A host
scheduler admits queued requests into free slots: same-bucket runs of up to
8 prompts are prefilled together into fresh rows at length 0, then copied
into their slots. Finished slots stop advancing under the step's keep gate
and keep computing until a new request takes them; a slot's whole lifetime
touches only its own rows of the cache.

Differences from the JAX engine that do not change what it computes:
  * the step loop runs on the host: a chunk of ``steps_per_sync`` steps
    ends early on one small device read (``live.any()``) a step, where JAX
    exits its ``while_loop`` on the device, and each chunk's packed
    metadata is read before the next chunk runs, where JAX's
    ``run_until_idle`` overlaps the read with the next chunk (the one-deep
    pipeline, not ported: ROADMAP A-queue item 6);
  * the admission prefill runs into rows as wide as the prompt bucket
    (positions past it are never read) and plans its W8A16 calls
    batch-invariant, so a request's prefill gives the same bits whatever
    requests are admitted with it;
  * per-request streams come from ``ops/sampling.py::row_keys(seed, rid)``,
    the counterpart of ``fold_in(admit_key, rid)``;
  * TTFT is stamped once the admission prefill has finished on the device.

``mesh`` (a ``parallel.sharding.Mesh``, every rank of it running the
engine in lockstep, as ``serve/multihost.py`` drives it) shards the params
Megatron-style over tp and the caches' kv heads with them; the forwards sum
over tp and give every rank the full vocab, so each host read is
replicated. A data-parallel axis above 1 raises ``NotImplementedError``
(ROADMAP A16 step 2).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..cache.kvcache import install_rows, rollback_rows
from ..core.config import resolve_device, synchronize
from ..engine.types import ModelBundle, first_eos_truncate, pad_prompt
from ..models.llama import unstack_layers
from ..ops.sampling import SamplingConfig, row_keys
from ..parallel.sharding import require_dp1, shard_for, shard_serving_state
from .batched import (
    BatchState,
    accept_rows,
    admit_rows,
    commit_rows,
    draft_phase_batched,
    run_steps,
    verify_phase_batched,
)

ADMIT_CAP = 8  # prompts a prefill at most: its activations must fit beside the weights


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray       # [P] int32
    max_new_tokens: int
    submit_time: float
    prefill_time: Optional[float] = None
    cached_len: int = 0      # prompt positions served from the prefix cache
    # preemption resume (the paged engine's on-demand paging): a preempted
    # request requeues with its committed tokens as the prompt, the row's
    # evolved stream key (so the continuation replays the preempted run)
    # and its detail counters so far
    resume_key: Optional[np.ndarray] = None   # [2] stream key
    carry: Optional[dict] = None              # accumulated details
    orig_prompt_len: Optional[int] = None     # the user's prompt length


@dataclasses.dataclass
class Completion:
    rid: int
    output_ids: np.ndarray   # prompt + generation, EOS-truncated
    prompt_len: int
    details: dict


def _slot_spec_step(bundle_d, bundle_t, params_d, params_t, scfg, gamma: int, eos_token_id: int,
                    state: BatchState) -> BatchState:
    """One speculative step of every slot. Each slot's rows belong to it
    alone, so finished and idle slots run through the forwards ungated:
    they write only their own rows, and every field of theirs keeps its
    value (JAX ``_batched_spec_step``'s ``keep``)."""
    live = state.active & ~state.done
    tokens2, draft_cache, q_stack, drafts, keys = draft_phase_batched(
        bundle_d, params_d, scfg, gamma, state.tokens, state.cur_len, state.draft_cache, state.key)
    p_stack, target_cache = verify_phase_batched(
        bundle_t, params_t, scfg, gamma, tokens2, state.cur_len, state.target_cache)
    tokens3, new_len, n, all_acc, acc_step, keys = accept_rows(
        gamma, tokens2, state.cur_len, q_stack, drafts, p_stack, keys)
    return commit_rows(state, tokens3, new_len, n, all_acc, acc_step, keys, eos_token_id, live,
                       live, draft_cache=draft_cache, target_cache=target_cache)


def _batched_spec_step(params_d, params_t, state: BatchState, *, bundle_d, bundle_t, gamma: int,
                       scfg: SamplingConfig, eos_token_id: int, n_steps: int = 1):
    """Up to ``n_steps`` steps of every slot (one chunk; it ends early once
    no slot is live). Returns (state, packed metadata)."""
    state = run_steps(state, n_steps, lambda st: _slot_spec_step(
        bundle_d, bundle_t, params_d, params_t, scfg, gamma, eos_token_id, st))
    return state, _pack_slot_meta(state)


def _pack_slot_meta(state: BatchState) -> torch.Tensor:
    """The scheduling metadata and the whole harvest payload as one flat
    int32 vector, so a harvest is one device-to-host copy: [cur_len S |
    done S | steps S | accepted S | resamples S | bonus S | acc_rate_sum
    (f32 bits) S | acc_len_hist S*h | tokens S*t], JAX's layout."""
    def f(x):
        return x.to(torch.int32).reshape(-1)

    return torch.cat([
        f(state.cur_len), f(state.done), f(state.steps), f(state.accepted),
        f(state.resamples), f(state.bonus),
        state.acc_rate_sum.float().contiguous().view(torch.int32),
        f(state.acc_len_hist), f(state.tokens),
    ])


def _unpack_slot_meta(pack: np.ndarray, s: int, h: int, t: int) -> dict:
    """Host-side inverse of :func:`_pack_slot_meta`."""
    o = 0

    def take(n, shape=None):
        nonlocal o
        out = pack[o:o + n]
        o += n
        return out.reshape(shape) if shape else out

    return {
        "cur_len": take(s), "done": take(s).astype(bool), "steps": take(s),
        "accepted": take(s), "resamples": take(s), "bonus": take(s),
        "acc_rate_sum": take(s).view(np.float32),
        "acc_len_hist": take(s * h, (s, h)), "tokens": take(s * t, (s, t)),
    }


def _prefill_slots(params_d, params_t, state: BatchState, slots, prompts, p_lens, max_news, keys,
                   *, bundle_d: ModelBundle, bundle_t: ModelBundle) -> BatchState:
    """Admit K requests in one prefill per model (JAX ``_prefill_slot`` and
    ``_prefill_batch``): ``prompts`` [KB, P_bucket] (KB >= K, a power of
    two; the padding rows are computed and dropped) run into fresh zero
    rows at length 0, never a copy of the slots' current rows, with the
    W8A16 calls planned batch-invariant; the first K rows are then copied
    into ``slots`` [K] and the slots' state installed."""
    for bundle, params, cache in ((bundle_d, params_d, state.draft_cache),
                                  (bundle_t, params_t, state.target_cache)):
        fresh = bundle.make_cache(prompts.shape[0], prompts.shape[1], device=prompts.device)
        _, fresh = bundle.forward(params, bundle.cfg, prompts, fresh, batch_invariant=True)
        install_rows(cache, slots, fresh)
    admit_rows(state, slots, prompts[:slots.shape[0]], p_lens, max_news, keys)
    return state


class ContinuousBatchingEngine:
    """Slot-based continuous batching over one draft/target pair.

    ``submit`` enqueues; ``step`` admits into free slots, runs one chunk of
    ``steps_per_sync`` batched speculative steps over every slot and
    harvests finished requests; ``run_until_idle`` repeats until the queue
    drains. An int8 KV cache for the target comes from its bundle
    (``ModelBundle(kv_quant=True)``). Runs on the card unless
    ``device="cpu"``; the params must lie on that device."""

    def __init__(
        self,
        bundle_d: ModelBundle, params_d,
        bundle_t: ModelBundle, params_t,
        *,
        num_slots: int = 4,
        max_total_len: int = 1024,
        max_new_cap: int = 256,
        gamma: int = 4,
        eos_token_id: int = 2,
        temperature: float = 1.0,
        top_k: int = 20,
        top_p: float = 0.9,
        seed: int = 0,
        prompt_bucket: int = 64,
        steps_per_sync: int = 4,
        mesh=None,
        device=None,
    ):
        require_dp1(mesh, "ContinuousBatchingEngine(mesh=...)")
        for b in (bundle_d, bundle_t):
            # frozen slots compute up to gamma positions past max_total_len
            # (the cache clamps their writes); a learned position table
            # must cover them, since no length is read on the host
            if b.family == "opt" and max_total_len + gamma > b.cfg.max_position:
                raise ValueError(
                    f"max_total_len {max_total_len} + gamma {gamma} exceeds the "
                    f"{b.cfg.max_position} learned positions of the {b.family} model")
        self.device = resolve_device(device)
        self.mesh = mesh
        params_d, params_t = shard_for(bundle_d, params_d, mesh), shard_for(bundle_t, params_t, mesh)
        self.bundle_d, self.params_d = bundle_d.for_params(params_d), unstack_layers(params_d)
        self.bundle_t, self.params_t = bundle_t.for_params(params_t), unstack_layers(params_t)
        self.num_slots = num_slots
        self.max_total_len = max_total_len
        self.max_new_cap = max_new_cap
        self.gamma = gamma
        self.eos_token_id = eos_token_id
        self.scfg = SamplingConfig(temperature, top_k, top_p)
        self.seed = seed
        self.prompt_bucket = prompt_bucket
        self.steps_per_sync = max(1, int(steps_per_sync))

        s, dev = num_slots, self.device

        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def cache(bundle):
            return rollback_rows(bundle.make_cache(s, max_total_len, device=dev),
                                 zeros(s, dtype=torch.int32))

        self.state = BatchState(
            tokens=zeros(s, max_total_len),
            cur_len=torch.full((s,), 2, dtype=torch.long, device=dev),  # >= 2: idle slots are safe
            draft_cache=cache(bundle_d),
            target_cache=cache(bundle_t),
            key=zeros(s, 2),
            active=zeros(s, dtype=torch.bool),
            done=torch.ones((s,), dtype=torch.bool, device=dev),
            target_len=torch.full((s,), max_total_len, dtype=torch.long, device=dev),
            accepted=zeros(s), resamples=zeros(s), bonus=zeros(s), steps=zeros(s),
            acc_rate_sum=zeros(s, dtype=torch.float32),
            acc_len_hist=zeros(s, max_new_cap),
        )
        if mesh is not None:
            self.state = shard_serving_state(self.state, mesh)
        self._next_rid = 0
        self._pending: collections.deque[Request] = collections.deque()
        self._slot_req: list[Optional[Request]] = [None] * s
        # occupancy generation per slot: metadata recorded under a previous
        # occupant must never harvest the current one
        self._slot_gen: list[int] = [0] * s
        self._last_harvest: Optional[dict] = None
        self.completions: dict[int, Completion] = {}

    # --------------------------------------------------------------- interface
    def warmup(self, prompt_len: int = 8) -> None:
        """Run JAX's warm-up traffic before live traffic: a burst of
        ``num_slots + 1`` requests (the full-batch prefill and a lone one)
        and waves of 2, 4 and 8 (the admission sizes a trickle hits), each
        drained. Nothing is compiled per shape here, but the first launches
        happen now: the kernels build, B1 encodes its tensor maps, the
        allocator grows. Leaves the rid sequence where it was, so live
        traffic's streams do not depend on the warm-up."""
        rng = np.random.default_rng(0)
        rid0 = self._next_rid
        rids = []
        waves = [self.num_slots + 1] + [kb for kb in (2, 4, 8) if 1 < kb < self.num_slots]
        for n in waves:
            rids += [self.submit(rng.integers(2, 100, size=max(prompt_len, 2)), 2)
                     for _ in range(n)]
            self.run_until_idle()
        for r in rids:
            self.completions.pop(r, None)
        self._next_rid = rid0

    def submit(self, prompt_ids, max_new_tokens: int = 40) -> int:
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.shape[0] < 2:
            raise ValueError("prompt must have at least 2 tokens")
        max_new = min(int(max_new_tokens), self.max_new_cap)
        if ids.shape[0] + max_new + self.gamma + 1 > self.max_total_len:
            raise ValueError(
                f"prompt({ids.shape[0]}) + max_new({max_new}) exceeds "
                f"max_total_len={self.max_total_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(Request(rid, ids, max_new, time.perf_counter()))
        return rid

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _dev(self, x, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _admit(self) -> None:
        """Admit pending requests into free slots in FIFO order: runs of up
        to ``ADMIT_CAP`` sharing one prompt bucket, each prefilled at once
        (the weights are read once for the run), K rounded up to a power of
        two with the padding rows dropped."""
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        pairs = []
        while free and self._pending:
            pairs.append((free.pop(0), self._pending.popleft()))
        self._admit_pairs(pairs)

    def _admit_pairs(self, pairs) -> None:
        """Prefill ``pairs`` [(slot, request)] into their slots, in order:
        runs of up to ``ADMIT_CAP`` sharing one prompt bucket, one prefill
        a run."""
        i = 0
        while i < len(pairs):
            batch = []
            bucket = None
            while i < len(pairs) and len(batch) < ADMIT_CAP:
                slot, req = pairs[i]
                padded, p_len = pad_prompt(req.prompt, self.prompt_bucket)
                if bucket is None:
                    bucket = padded.shape[-1]
                elif padded.shape[-1] != bucket:
                    break
                batch.append((slot, req, padded.reshape(-1), p_len))
                i += 1
            self._dispatch_prefill(batch, bucket)
            now = time.perf_counter()
            for slot, req, _, _ in batch:
                req.prefill_time = now
                self._slot_req[slot] = req
                self._slot_gen[slot] += 1

    def _dispatch_prefill(self, batch, bucket: int) -> None:
        k = len(batch)
        prompts = np.zeros((1 << (k - 1).bit_length(), bucket), np.int64)
        for j, (_, _, padded, _) in enumerate(batch):
            prompts[j] = padded
        self.state = _prefill_slots(
            self.params_d, self.params_t, self.state,
            self._dev([slot for slot, _, _, _ in batch]), self._dev(prompts),
            self._dev([p_len for _, _, _, p_len in batch]),
            self._dev([req.max_new_tokens for _, req, _, _ in batch]),
            row_keys(self.seed, [req.rid for _, req, _, _ in batch], device=self.device),
            bundle_d=self.bundle_d, bundle_t=self.bundle_t)
        synchronize(self.device)  # TTFT: the prompts' KV is on the device

    def _dispatch_chunk(self) -> torch.Tensor:
        self.state, pack = _batched_spec_step(
            self.params_d, self.params_t, self.state, bundle_d=self.bundle_d,
            bundle_t=self.bundle_t, gamma=self.gamma, scfg=self.scfg,
            eos_token_id=self.eos_token_id, n_steps=self.steps_per_sync)
        return pack

    def _collect(self, pack: torch.Tensor, gens: tuple) -> None:
        """One device-to-host copy of the chunk's packed metadata, then the
        harvest."""
        m = _unpack_slot_meta(pack.cpu().numpy(), self.num_slots, self.max_new_cap,
                              self.max_total_len)
        self._last_harvest = m
        self._harvest(m["done"], m["cur_len"], gens)

    def _harvest(self, done: np.ndarray, cur_len: np.ndarray, gens: tuple) -> None:
        """Complete the finished slots from the chunk's metadata (whose
        result lanes are frozen once a slot is done) and free them.
        Metadata recorded under a previous occupancy generation never
        harvests the slot's new request."""
        fin = [s for s, r in enumerate(self._slot_req)
               if r is not None and done[s] and gens[s] == self._slot_gen[s]]
        if not fin:
            return
        hv = self._last_harvest
        for slot in fin:
            req = self._slot_req[slot]
            p_len = req.prompt.shape[0]
            out = first_eos_truncate(hv["tokens"][slot], p_len, int(cur_len[slot]),
                                     self.eos_token_id)
            steps = int(hv["steps"][slot])
            now = time.perf_counter()
            details = {
                "ttft_s": (req.prefill_time or now) - req.submit_time,
                "latency_s": now - req.submit_time,
                "acc_len": np.asarray(hv["acc_len_hist"][slot])[:steps].tolist(),
                "acc_rate": float(hv["acc_rate_sum"][slot]) / max(steps * self.gamma, 1),
                "target_call_times": steps,
                "approx_call_times": steps,
                "accepted_count": int(hv["accepted"][slot]),
                "resample_count": int(hv["resamples"][slot]),
                "target_sample_count": int(hv["bonus"][slot]),
                "tokens_generated": len(out) - p_len,
            }
            self.completions[req.rid] = Completion(req.rid, out, p_len, details)
            self._slot_req[slot] = None
        self.state.active[self._dev(fin)] = False

    def step(self) -> int:
        """Admit, run one chunk, harvest. Returns the slots still busy."""
        self._admit()
        if self.num_active:
            self._collect(self._dispatch_chunk(), tuple(self._slot_gen))
        return self.num_active

    def run_until_idle(self, max_steps: int = 10_000) -> int:
        """Step until no request is queued or running; returns the chunks run."""
        steps = 0
        while steps < max_steps:
            self._admit()
            if not self.num_active:
                break
            self._collect(self._dispatch_chunk(), tuple(self._slot_gen))
            steps += 1
        return steps

    def result(self, rid: int) -> Optional[Completion]:
        return self.completions.pop(rid, None)

    def partial_result(self, rid: int) -> Optional[np.ndarray]:
        """Tokens committed so far (prompt + new, not yet EOS-truncated) of a
        request still on a slot, monotone across chunks; None otherwise. One
        small device read."""
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.rid == rid:
                row = torch.cat([self.state.cur_len[slot:slot + 1], self.state.tokens[slot]])
                host = row.cpu().numpy()
                return host[1:1 + int(host[0])].astype(np.int32)
        return None
