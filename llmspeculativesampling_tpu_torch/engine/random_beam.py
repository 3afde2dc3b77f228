"""Random-width beam sampling with the target model only
(counterpart of ``llmspeculativesampling_tpu/engine/random_beam.py``).

Each step draws a width k in [min_num_beams, max_num_beams] and samples k
beams without replacement from the joint beam x vocab distribution
``norm_logits(log_softmax(logits) + beam_scores)``; the cache and the rows
are reordered by parent; rows that end in EOS become candidates scored by
their length-normalised log-probability and are killed; the run stops when
every beam is dead, and returns the best candidate.

The state holds a fixed ``max_num_beams`` rows. The width is realised by
drawing a full ordering without replacement (Gumbel top-k) and killing rows
>= k, as the JAX engine does; the best candidate is a running arg-max on
the device. As in JAX (``_random_beam_device``) the whole generation runs
in the device loop (``engine/device_loop.py``): the state lives in static
buffers, one step (:func:`_rb_step`) is a function of tensors only whose
draws (the width, the ordering) come from one counter stream, and on the
card it is captured once into a CUDA graph and replayed until every beam
is dead or the budget is spent. The merge of the surviving beams runs once,
eagerly, after the loop.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import torch

from ..cache.kvcache import rollback_rows, select_rows_
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import (
    SamplingConfig,
    joint_topk_from_logp,
    norm_logits,
    prob_of_topk,
    randint_u,
    row_uniform,
    sample_k_topk_u,
    sample_k_u,
    topk_draw_width,
    use_sparse,
)
from . import device_loop
from .device_loop import scalar
from .phases import calibrate_phase_times
from .types import ModelBundle, aligned_total, pad_prompt

_DEAD = -1e30
_DONE_THRES = -10000.0


@dataclasses.dataclass
class RandomBeamState:
    """A random-width beam generation on the device (the carry of JAX's
    ``_random_beam_device`` loop)."""

    row_tokens: torch.Tensor    # [kmax, T] int64: each beam's sequence
    p_len: torch.Tensor         # [] int32: the prompt's length
    cur_len: torch.Tensor       # [] int32
    total: torch.Tensor         # [] int32
    cache: object               # kmax rows, per-row device lengths
    last_logits: torch.Tensor   # [kmax, V] f32: what the next tokens are drawn from
    beam_scores: torch.Tensor   # [kmax] f32: _DEAD for a dead beam
    key: torch.Tensor           # [1, 2]
    best_tokens: torch.Tensor   # [T] int64: the best EOS-finished candidate
    best_score: torch.Tensor    # [] f32
    best_len: torch.Tensor      # [] int32
    stop: torch.Tensor          # [] bool: JAX's cond negated


def _rb_stop(st: RandomBeamState) -> torch.Tensor:
    return (st.cur_len >= st.total) | (st.beam_scores.max() < _DONE_THRES)


def _rb_state(bundle, kmax: int, max_total: int, device) -> RandomBeamState:
    """A zeroed :class:`RandomBeamState` of ``max_total`` positions."""
    i32 = torch.int32
    cache = bundle.make_cache(kmax, max_total, device=device)
    return RandomBeamState(
        row_tokens=torch.zeros((kmax, max_total), dtype=torch.long, device=device),
        p_len=scalar(0, i32, device), cur_len=scalar(0, i32, device),
        total=scalar(0, i32, device),
        cache=dataclasses.replace(cache, lengths=torch.zeros((kmax,), dtype=i32, device=device)),
        last_logits=torch.zeros((kmax, bundle.cfg.vocab_size), dtype=torch.float32, device=device),
        beam_scores=torch.zeros((kmax,), dtype=torch.float32, device=device),
        key=torch.zeros((1, 2), dtype=torch.long, device=device),
        best_tokens=torch.zeros((max_total,), dtype=torch.long, device=device),
        best_score=scalar(_DEAD, torch.float32, device), best_len=scalar(0, i32, device),
        stop=scalar(False, torch.bool, device),
    )


def _rb_start(bundle, params, prompt_t, p_len: int, total: int, key,
              st: RandomBeamState) -> None:
    """Reset ``st`` and prefill the padded prompt ``prompt_t`` [1, P] into
    every row (eager: the bucket varies); the rows' lengths end at
    ``p_len``. The forwards gather the vocab, under a ``tp_mesh`` too: the
    joint takes a full-vocab log-softmax."""
    kmax = st.row_tokens.shape[0]
    st.row_tokens.zero_()
    st.row_tokens[:, :prompt_t.shape[1]] = prompt_t
    st.cache.lengths.zero_()
    logits, _ = bundle.forward(params, bundle.cfg, prompt_t.expand(kmax, -1), st.cache)
    st.cache.lengths.fill_(p_len)
    st.last_logits.copy_(logits[:, p_len - 1])
    st.p_len.fill_(p_len)
    st.cur_len.fill_(p_len)
    st.total.fill_(total)
    st.key.copy_(key)
    st.beam_scores.zero_()
    st.best_tokens.zero_()
    st.best_score.fill_(_DEAD)
    st.best_len.zero_()
    st.stop.copy_(_rb_stop(st))


def _rb_step(bundle, params, scfg, min_num_beams: int, max_num_beams: int, eos_token_id: int,
             st: RandomBeamState) -> None:
    """One token on every beam of ``st``, in place (JAX
    ``_random_beam_device``'s body): draw a width and a full ordering of
    the joint, reorder the cache and the rows by parent, turn EOS rows into
    candidates and kill them, and run the one-token forward. A finished
    state changes nothing the merge reads; its forward stays at
    ``min(cur_len, total - 1)``, inside the buffers."""
    kmax, vocab = max_num_beams, bundle.cfg.vocab_size
    cur = st.cur_len.long()
    active = ~_rb_stop(st)
    cw = torch.minimum(cur, st.total.long() - 1)
    token_logp = torch.log_softmax(st.last_logits, dim=-1)
    u_w, key = row_uniform(st.key, 1)
    k_width = randint_u(u_w[0, 0], min_num_beams, max_num_beams)
    if use_sparse(scfg):
        # candidate-space joint: per-row top-k and a merge, no [K*V] sort
        d = joint_topk_from_logp(token_logp, st.beam_scores, scfg)
        u, key = row_uniform(key, topk_draw_width(d, kmax))
        t = sample_k_topk_u(d, u[0], kmax)  # a full ordering without replacement
        t_prob = prob_of_topk(d, t)
    else:
        last_p = norm_logits((token_logp + st.beam_scores[:, None]).reshape(1, -1), scfg)[0]
        u, key = row_uniform(key, last_p.shape[0])
        t = sample_k_u(last_p[None], u, kmax)[0]
        t_prob = last_p[t]
    parent = torch.div(t, vocab, rounding_mode="floor")
    token = t % vocab
    alive = torch.arange(kmax, device=t.device) < k_width
    new_scores = torch.where(alive, torch.log(t_prob + 1e-30), torch.full_like(t_prob, _DEAD))

    select_rows_(st.cache, parent)
    rows = st.row_tokens.index_select(0, parent)
    rows.scatter_(1, cw.expand(kmax, 1), token[:, None])
    new_len = cur + 1

    # rows ending in EOS become candidates, then die
    ended = alive & (token == eos_token_id)
    norm = new_scores / (new_len - st.p_len).clamp(min=1).float()
    cand_score = torch.where(ended, norm, torch.full_like(norm, _DEAD))
    cbest = torch.argmax(cand_score)
    best = cand_score.index_select(0, cbest.reshape(1))[0]  # not cand_score[cbest]: a host read
    improved = active & (best > st.best_score)
    st.best_tokens.copy_(torch.where(improved, rows.index_select(0, cbest.reshape(1))[0],
                                     st.best_tokens))
    st.best_score.copy_(torch.where(improved, best, st.best_score))
    st.best_len.copy_(torch.where(improved, new_len, st.best_len.long()))
    new_scores = torch.where(ended, torch.full_like(new_scores, _DEAD), new_scores)

    logits, _ = bundle.forward(params, bundle.cfg, token[:, None],
                               rollback_rows(st.cache, cw.expand(kmax)))
    st.row_tokens.copy_(torch.where(active, rows, st.row_tokens))
    st.beam_scores.copy_(torch.where(active, new_scores, st.beam_scores))
    st.last_logits.copy_(torch.where(active, logits[:, 0], st.last_logits))
    st.cur_len.copy_(torch.where(active, new_len, cur))
    st.key.copy_(torch.where(active, key, st.key))
    st.stop.copy_(_rb_stop(st))


def random_width_beam_generate(
    bundle: ModelBundle,
    params,
    prompt,
    max_new_tokens: int,
    *,
    max_num_beams: int = 4,
    min_num_beams: int = 1,
    eos_token_id: int,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    details: bool = False,
    tp_mesh=None,
    device=None,
):
    """Target-only random-width beam sampling (the reference's
    ``random_width_beam_sampling``). Returns the best candidate as numpy
    int32 [T] (prompt included); with ``details=True`` also the timing
    dict of the reference's target-only blocks. ``tp_mesh``: see
    ``engine/speculative.py::speculative_generate``; the joint takes a
    full-vocab log-softmax, so the forwards give the full vocab."""
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle = bundle.for_params(params)
    pu = unstack_layers(params)
    kmax = max_num_beams
    prompt_padded, p_len = pad_prompt(prompt)
    p_bucket = prompt_padded.shape[1]
    max_total = aligned_total(p_bucket + max_new_tokens + 1)
    total = p_len + max_new_tokens
    device_loop.check_positions(bundle, max(p_bucket, total))
    key = device_loop.stream_key(gen, dev)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    st = device_loop.run(
        ("random_beam", bundle, kmax, min_num_beams, max_total, scfg, eos_token_id), (params,),
        functools.partial(_rb_state, bundle, kmax, max_total, dev),
        functools.partial(_rb_start, bundle, pu, prompt_t, p_len, total, key),
        functools.partial(_rb_step, bundle, pu, scfg, min_num_beams, kmax, eos_token_id),
        max_new_tokens, replay=dev.type == "cuda" and tp_mesh is None)

    # the surviving beams are candidates too
    cur_len = st.cur_len.long()
    norm = st.beam_scores / (cur_len - p_len).clamp(min=1).float()
    fbest = torch.argmax(norm)
    improved = norm[fbest] > st.best_score
    best_tokens = torch.where(improved, st.row_tokens[fbest], st.best_tokens)
    best_len = torch.where(improved, cur_len, st.best_len.long())
    n_out, cur_len = torch.stack([best_len, cur_len]).tolist()
    out = best_tokens[:n_out].cpu().numpy().astype("int32")
    wall = time.perf_counter() - t0
    if not details:
        return out
    n_gen = max(len(out) - p_len, 1)
    steps = cur_len - p_len
    # target-only: the approx side of the reference's block schema is zero
    _, t_fwd = calibrate_phase_times(
        bundle, pu, bundle, pu, draft_rows=kmax, verify_rows=kmax, gamma=1,
        verify_tokens=1, max_total=max_total, device=dev,
    )
    target = min(steps * t_fwd, wall) if wall > 0 else steps * t_fwd
    return out, {
        "total_time": wall,
        "tokens_generated": len(out) - p_len,
        "s_per_token": wall / n_gen,
        "tokens_per_s": n_gen / wall if wall > 0 else float("nan"),
        "target_call_times": steps,
        "approx_call_times": 0,
        "approx_time": 0.0,
        "target_time": target,
        "other_time": max(wall - target, 0.0),
        "phase_split_method": "calibrated",
    }
