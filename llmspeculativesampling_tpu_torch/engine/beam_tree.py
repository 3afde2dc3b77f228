"""Beam speculative sampling over token trees
(counterpart of ``llmspeculativesampling_tpu/engine/beam_tree.py``).

* ``beam_speculative_v2_generate`` (the reference's
  ``beam_speculative_sampling_v2``, the flagship): the draft beam-samples
  gamma steps (``engine/beam_draft.py``); ONE target forward verifies the
  anchor plus every tree node under an ancestor mask; the walk picks a
  dynamic width per level from the acceptance DP (``ops/dp.py``), takes
  the beams in order accepting with ``p/(q+1e-6) > r`` and updating the
  residual joint ``max_fn(p - q)`` on each reject, and resamples the next
  tokens from the level joint or the residual; the target cache is
  compacted to the accepted path (``cache/kvcache.py::compact_tree_paths``)
  and the draft cache rebuilt from the k/v the draft captured.
* ``beam_speculative_generate`` (the reference's ``beam_speculative_sampling``,
  "v1"): the same tree, rescored by an always-accept walk (the reference's
  ``p/(q+1e-5) > r - 1``) over ``num_beams`` parallel committed prefixes,
  resampling ``num_beams`` continuations from the warped target joint, with
  EOS candidate collection.

The tree forward goes through the flash-decode kernel (B2) when the tree's
N+1 = gamma*num_beams+1 tokens fit its S_new <= 32; with it, B2 attends the
new block under an additive [R, N+1, N+1] ancestor bias. Larger trees take
the einsum path, as in the JAX package.

As in JAX (``_beam_tree_device``) the whole generation runs in the device
loop (``engine/device_loop.py``): the :class:`TreeState` lives in static
buffers with per-row device lengths, one step (:func:`_tree_step`: draft,
tree verify, walk, commit, EOS bookkeeping) is a function of tensors only
whose draws all come from one counter stream, and on the card it is
captured once into a CUDA graph and replayed until the state says stop. The
commit takes the target's committed rows by root with a whole-row take (the
rows differ, so a window take would not be exact), compacts the accepted
path at the device position, and rebuilds the draft rows from the k/v the
draft captured. The final candidates are merged once, eagerly, after the
loop.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional

import torch

from ..cache.kvcache import (compact_tree_paths, rollback, rollback_rows, select_rows_,
                             write_positions)
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.dp import acceptance_alphas, get_expect_cnt_by_thres, num_accept_distribution
from ..ops.sampling import (
    SamplingConfig,
    TopKDist,
    acceptance_alphas_topk,
    dist_norm,
    joint_topk_from_dists,
    max_fn,
    norm_logits,
    rewarp_topk,
    row_uniform,
    sample_k_topk_u,
    sample_k_u,
    sample_topk_u,
    sample_u,
    topk_draw_width,
    use_sparse,
)
from . import device_loop
from .beam_draft import beam_draft
from .device_loop import scalar, scatter_where_
from .phases import fill_phase_split
from .types import ModelBundle, aligned_total, pad_prompt

_NEG = -1e30


# --------------------------------------------------------------- tree core
def ancestor_matrix(step_beam_idx: torch.Tensor, gamma: int, b: int) -> torch.Tensor:
    """A [N, N] bool, N = gamma*b: A[j1, j2] <=> node j2 is an ancestor of
    node j1 or j1 itself (node (s, beam) has flat id s*b + beam)."""
    eye = torch.eye(gamma * b, dtype=torch.bool, device=step_beam_idx.device)
    rows, prev = [], None
    for s in range(gamma):
        self_hot = eye[s * b:(s + 1) * b]
        prev = self_hot if s == 0 else prev[step_beam_idx[s]] | self_hot
        rows.append(prev)
    return torch.cat(rows, dim=0)


def tree_verify(bundle, params, scfg, gamma, num_beams, row_tokens, cur_len, cache,
                node_tokens, node_roots, anc):
    """One tree-attention target forward over [anchor] + N nodes for each of
    the R committed rows. Returns (p_root [R, ...], p_nodes [N, ...], cache):
    warped distributions; p_root[r] conditions on row r, p_nodes[j] on node
    j's path (read from batch row ``node_roots[j]``). ``cur_len`` is a host
    int (a cache with a host length) or a device scalar (per-row device
    lengths, no host read)."""
    r_rows = row_tokens.shape[0]
    n = gamma * num_beams
    dev = row_tokens.device
    c = torch.as_tensor(cur_len, device=dev).long().reshape(())
    if isinstance(cur_len, torch.Tensor):
        cache = rollback_rows(cache, (c - 1).expand(r_rows))
    else:
        cache = rollback(cache, cur_len - 1)
    anchor = row_tokens.gather(1, (c - 1).expand(r_rows, 1))
    vin = torch.cat([anchor, node_tokens[None].expand(r_rows, n)], dim=1)
    # block mask [N+1, N+1]: the anchor visible to all, nodes see their ancestors
    block = torch.zeros((n + 1, n + 1), dtype=torch.bool, device=dev)
    block[:, 0] = True
    block[1:, 1:] = anc
    block = block[None].expand(r_rows, n + 1, n + 1)
    node_s = torch.arange(gamma, device=dev).repeat_interleave(num_beams)  # level of node j
    positions = torch.cat([(c - 1).reshape(1), c + node_s])
    positions = positions[None].expand(r_rows, n + 1)
    logits, cache = bundle.forward(params, bundle.cfg, vin, cache, positions=positions,
                                   tree_mask=block, tp_mesh=scfg.tp_mesh)
    rr = node_roots.clamp(0, r_rows - 1)
    cols = torch.arange(n, device=dev) + 1
    if use_sparse(scfg):
        d = dist_norm(logits, scfg)  # idx/probs [R, N+1, k]
        return (TopKDist(d.idx[:, 0], d.probs[:, 0]), TopKDist(d.idx[rr, cols], d.probs[rr, cols]),
                cache)
    probs = norm_logits(logits, scfg)  # [R, N+1, V]
    return probs[:, 0], probs[rr, cols], cache


def backtrack_path(step_beam_idx, step_next_tok, parent, level_end, gamma: int, b: int):
    """From parent row(s) ``parent`` (scalar or [R]) at level
    ``level_end-1``, walk the parent pointers back to the root. Returns
    (path_rows [..., gamma], path_tokens [..., gamma], path_nodes [...,
    gamma], root [...]); entries at s >= level_end are junk (callers mask
    them); when level_end == 0 ``parent`` is already a root row."""
    dev = step_beam_idx.device
    level_end = torch.as_tensor(level_end, device=dev)
    cur = torch.as_tensor(parent, device=dev).long()
    rows: List[torch.Tensor] = [cur] * gamma
    for s in range(gamma - 1, -1, -1):
        on = s <= level_end - 1
        rows[s] = torch.where(on, cur, torch.zeros_like(cur))
        cur = torch.where(on, step_beam_idx[s][cur.clamp(0, b - 1)], cur)
    path_rows = torch.stack(rows, dim=-1)
    levels = torch.arange(gamma, device=dev)
    path_tokens = step_next_tok[levels, path_rows]
    return path_rows, path_tokens, levels * b + path_rows, cur


# ------------------------------------------------------------ shared state
@dataclasses.dataclass
class TreeState:
    """A tree generation on the device (JAX's ``TreeState``, the carry of
    ``_beam_tree_device``): every field a static buffer that a step updates
    in place."""

    row_tokens: torch.Tensor    # [R, T] int64: the committed parallel prefixes
    p_len: torch.Tensor         # [] int32: the prompt's length
    cur_len: torch.Tensor       # [] int32: committed positions (every row)
    total: torch.Tensor         # [] int32: prompt length + max_new_tokens
    draft_cache: object         # committed draft cache: B rows (slot pattern), device lengths
    target_cache: object        # committed target cache: R rows, device lengths
    beam_scores: torch.Tensor   # [B] f32: the committed rows' scores (carried in v1)
    key: torch.Tensor           # [1, 2] the counter stream every draw comes from
    done: torch.Tensor          # [] bool: the EOS bookkeeping ended the run
    first: torch.Tensor         # [] bool: v1's first-step valid-beam special case
    accepted: torch.Tensor      # [] int32: accepted levels
    steps: torch.Tensor         # [] int32
    rate_sum: torch.Tensor      # [] f32: the acc_rate numerator
    rate_cnt: torch.Tensor      # [] int32: its denominator (gamma a step)
    best_tokens: torch.Tensor   # [T] int64: the best EOS-finished candidate
    best_len: torch.Tensor      # [] int32
    best_score: torch.Tensor    # [] f32
    alive: torch.Tensor         # [R] bool: a row not yet EOS-finished
    acc_len_hist: torch.Tensor  # [max_new_tokens] int32: levels accepted a step
    expect_hist: torch.Tensor   # [max_new_tokens, gamma] int32: v2's width a level (-1 inactive)
    stop: torch.Tensor          # [] bool: JAX's cond negated (cur_len >= total, or done)


def _slot_pattern(b: int, r: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(b, device=device), max=r - 1)


def _tree_state(bundle_d, bundle_t, num_beams: int, r_slots: int, gamma: int, max_total: int,
                max_new: int, device) -> TreeState:
    """A zeroed :class:`TreeState` of ``max_total`` positions."""
    i32 = torch.int32

    def cache(bundle, rows):
        c = bundle.make_cache(rows, max_total, device=device)
        return dataclasses.replace(c, lengths=torch.zeros((rows,), dtype=i32, device=device))

    hist = max(max_new, 1)
    return TreeState(
        row_tokens=torch.zeros((r_slots, max_total), dtype=torch.long, device=device),
        p_len=scalar(0, i32, device), cur_len=scalar(0, i32, device),
        total=scalar(0, i32, device),
        draft_cache=cache(bundle_d, num_beams), target_cache=cache(bundle_t, r_slots),
        beam_scores=torch.zeros((num_beams,), dtype=torch.float32, device=device),
        key=torch.zeros((1, 2), dtype=torch.long, device=device),
        done=scalar(False, torch.bool, device), first=scalar(True, torch.bool, device),
        accepted=scalar(0, i32, device), steps=scalar(0, i32, device),
        rate_sum=scalar(0.0, torch.float32, device), rate_cnt=scalar(0, i32, device),
        best_tokens=torch.zeros((max_total,), dtype=torch.long, device=device),
        best_len=scalar(0, i32, device), best_score=scalar(_NEG, torch.float32, device),
        alive=torch.ones((r_slots,), dtype=torch.bool, device=device),
        acc_len_hist=torch.zeros((hist,), dtype=i32, device=device),
        expect_hist=torch.full((hist, gamma), -1, dtype=i32, device=device),
        stop=scalar(False, torch.bool, device),
    )


def _tree_start(bundle_d, params_d, bundle_t, params_t, prompt_t, p_len: int, total: int, key,
                tp_mesh, st: TreeState) -> None:
    """Reset ``st`` and prefill the padded prompt ``prompt_t`` [1, P] into
    every row of both caches (eager: the bucket varies)."""
    st.row_tokens.zero_()
    st.row_tokens[:, :prompt_t.shape[1]] = prompt_t
    for bundle, params, cache, mesh in ((bundle_d, params_d, st.draft_cache, None),
                                        (bundle_t, params_t, st.target_cache, tp_mesh)):
        cache.lengths.zero_()
        bundle.forward(params, bundle.cfg, prompt_t.expand(cache.lengths.shape[0], -1), cache,
                       tp_mesh=mesh)
        cache.lengths.fill_(p_len)
    st.p_len.fill_(p_len)
    st.cur_len.fill_(p_len)
    st.total.fill_(total)
    st.key.copy_(key)
    st.first.fill_(True)
    st.best_score.fill_(_NEG)
    st.alive.fill_(True)
    st.expect_hist.fill_(-1)
    for t in (st.beam_scores, st.done, st.accepted, st.steps, st.rate_sum, st.rate_cnt,
              st.best_tokens, st.best_len, st.acc_len_hist):
        t.zero_()
    st.stop.copy_(device_loop.finished(st))


def _commit(st: TreeState, res, t, max_l, new_scores_full, active, cw, gamma: int,
            num_beams: int, r_slots: int, vocab: int) -> None:
    """Commit the R slots in place (JAX's ``_commit``): tokens, the target
    cache's tree compaction, the draft cache's rebuild. ``t`` [R] are the
    slots' flat next ids, ``cw`` the committed length where the step's
    forwards sat. ``st.draft_cache`` still holds the committed rows from
    before the draft (slot pattern): the rebuild takes its rows by root and
    overlays the captured anchor and node k/v of the accepted paths. On a
    finished state (``active`` false) nothing the finish reads changes."""
    b = num_beams
    dev = cw.device
    parent, token = torch.div(t, vocab, rounding_mode="floor"), t % vocab
    path_rows, path_tokens, path_nodes, roots = backtrack_path(
        res.step_beam_idx, res.step_next_tok, parent, max_l, gamma, b)
    # when max_l == 0 the "parent" indexes the roots directly
    roots = torch.where(max_l == 0, parent, roots).clamp(0, r_slots - 1)
    j = torch.arange(gamma, device=dev)
    svalid = j < max_l
    new_len = cw + max_l + 1

    # tokens: the roots' rows, the accepted path at [cw, cw + max_l), the
    # next token at new_len - 1 (max_total leaves room past any window)
    rows = st.row_tokens.index_select(0, roots)
    pos = (cw + j).expand(r_slots, gamma)
    rows.scatter_(1, pos, torch.where(svalid, path_tokens, rows.gather(1, pos)))
    rows.scatter_(1, (new_len - 1).expand(r_slots, 1), token[:, None])
    st.row_tokens.copy_(torch.where(active, rows, st.row_tokens))
    st.beam_scores.copy_(torch.where(active, new_scores_full, st.beam_scores))
    st.cur_len.copy_(torch.where(active, new_len, st.cur_len.long()))

    # target: the roots' whole rows (one slot: the root is row 0), then the
    # accepted path compacted (node j sits at cw + j, the anchor at cw - 1)
    tc = st.target_cache
    if r_slots > 1:
        select_rows_(tc, roots)
    compact_tree_paths(tc, path_nodes, svalid.expand(r_slots, gamma), cw)
    tc.lengths.copy_((cw + max_l).expand(r_slots))

    # draft: the roots' committed rows + the anchor window and the path's nodes
    slot = _slot_pattern(b, r_slots, dev)
    rows_map = roots.index_select(0, slot)
    dc = st.draft_cache
    select_rows_(dc, rows_map)
    write_positions(dc, tuple(a.index_select(1, rows_map) for a in res.anchor_kv), cw - 2)
    if gamma > 1:  # node entry s < gamma-1 at cw + s where s < max_l
        pr = path_rows.index_select(0, slot)  # [B, gamma]
        nodes = tuple(torch.cat([res.node_kv[s][i].index_select(1, pr[:, s])
                                 for s in range(gamma - 1)], dim=3)
                      for i in range(len(res.anchor_kv)))
        write_positions(dc, nodes, cw, valid=j[:gamma - 1] < max_l)
    dc.lengths.copy_(torch.clamp(cw + max_l - 1, min=2).expand(b))


def _eos_bookkeeping(st: TreeState, eos_token_id: int, r_slots: int, active) -> None:
    """Candidate collection and termination (JAX's ``_eos_bookkeeping``),
    in place and masked by ``active``: a row whose generated tokens hold an
    EOS becomes a candidate (its first EOS ends it), scored by its
    length-normalised score, and dies; the run is done when no row lives
    (one slot: when it holds an EOS)."""
    seqs = st.row_tokens
    dev = seqs.device
    cur, p_len = st.cur_len.long(), st.p_len.long()
    pos = torch.arange(seqs.shape[1], device=dev)
    hits = ((pos >= p_len) & (pos < cur))[None] & (seqs == eos_token_id)
    has_eos = hits.any(dim=1)
    cand_len = torch.where(has_eos, torch.argmax(hits.int(), dim=1) + 1, cur)
    norm = st.beam_scores[:r_slots] / (cand_len - p_len).clamp(min=1).float()
    cand = torch.where(has_eos & st.alive, norm, torch.full_like(norm, _NEG))
    cb = torch.argmax(cand).reshape(1)  # a 0-dim index would be read on the host
    best = cand.index_select(0, cb)[0]
    improved = active & (best > st.best_score)
    st.best_tokens.copy_(torch.where(improved, seqs.index_select(0, cb)[0], st.best_tokens))
    st.best_len.copy_(torch.where(improved, cand_len.index_select(0, cb)[0], st.best_len.long()))
    st.best_score.copy_(torch.where(improved, best, st.best_score))
    alive = st.alive & ~has_eos
    done = has_eos[0] if r_slots == 1 else ~alive.any()
    st.alive.copy_(torch.where(active, alive, st.alive))
    st.done.copy_(st.done | (active & done))


# ------------------------------------------------------------------ walks
def _uniforms(src, n: int):
    """``n`` uniforms [1, n] from ``src`` and the advanced source: the
    step's counter-stream key [1, 2] (``ops/sampling.py::row_uniform``), or
    a ``torch.Generator`` (advanced in place)."""
    if isinstance(src, torch.Generator):
        return torch.rand((1, n), generator=src, device=src.device), src
    return row_uniform(src, n)


def _level_rows(p_root, p_nodes, i, b, r_slots):
    """The per-row target dists feeding level i: the roots (padded with
    zero rows to b) at level 0, else the nodes of level i-1."""
    if i > 0:
        return (TopKDist(p_nodes.idx[(i - 1) * b:i * b], p_nodes.probs[(i - 1) * b:i * b])
                if isinstance(p_nodes, TopKDist) else p_nodes[(i - 1) * b:i * b])
    if isinstance(p_root, TopKDist):
        if r_slots >= b:
            return TopKDist(p_root.idx[:b], p_root.probs[:b])
        pad = b - r_slots
        return TopKDist(torch.cat([p_root.idx, torch.zeros_like(p_root.idx[:1]).expand(pad, -1)]),
                        torch.cat([p_root.probs, torch.zeros_like(p_root.probs[:1]).expand(pad, -1)]))
    if r_slots >= b:
        return p_root[:b]
    return torch.cat([p_root, torch.zeros_like(p_root[:1]).expand(b - r_slots, -1)])


def _prob_at(dist: TopKDist, flat_ids: torch.Tensor) -> torch.Tensor:
    """Mass at each flat id ([n]) under a flat-candidate joint dist ([K])."""
    hit = dist.idx[None, :] == flat_ids[:, None]
    return torch.where(hit, dist.probs[None, :], torch.zeros((), device=hit.device)).sum(-1)


def _expect_cnt(p_next, q, b, expect_thres, min_num_beams, sparse):
    """The level's width from the acceptance DP (reference :254-267)."""
    alphas = acceptance_alphas_topk(p_next, q, b) if sparse else acceptance_alphas(p_next, q, b)
    probs_k, expect = num_accept_distribution(alphas, b)
    if expect_thres < 0:
        cnt = torch.floor(expect).long()
    else:
        cnt = get_expect_cnt_by_thres(torch.cat([probs_k[1:], probs_k[:1]]), expect_thres)
    return torch.clamp(cnt, min=min_num_beams)


def _partial_tokens(t_fail, t_resid, f_accept, f_sample_idx, f_acc_cnt, num_beams, r_slots):
    """Continuations after a failed level: the accepted sample ids first,
    one residual draw, the rest joint draws (reference :430-446); a single
    slot takes the residual draw."""
    if r_slots == 1:
        return t_resid.reshape(1).expand(num_beams)
    order = torch.argsort((~f_accept).long(), stable=True)
    slots = torch.arange(num_beams, device=t_fail.device)
    t = torch.where(slots < f_acc_cnt, f_sample_idx[order], t_fail)
    return torch.where(slots == f_acc_cnt, t_resid, t)


def _v2_walk(scfg, gamma, num_beams, vocab, expect_thres, min_num_beams,
             res, p_root, p_nodes, r_slots, key):
    """Dynamic-width DP walk over dense [b*V] joints (reference :188-337).
    Returns (t [b] flat ids, max_l, all_acc, new_scores [r_slots],
    rate_sum, expect_levels [gamma], key), all on the device. ``key`` is
    the counter stream (or a ``torch.Generator``) the draws come from, as
    many uniforms as JAX's draws take."""
    b = num_beams
    dev = p_root.device
    u, key = _uniforms(key, gamma * b)
    rmat = u.reshape(gamma, b)
    active = torch.ones((), dtype=torch.bool, device=dev)
    max_l = torch.zeros((), dtype=torch.long, device=dev)
    valid = torch.arange(b, device=dev) < r_slots
    beam_scores = torch.zeros((b,), dtype=torch.float32, device=dev)
    f_p_next = torch.zeros((b * vocab,), dtype=torch.float32, device=dev)
    f_resid = torch.zeros_like(f_p_next)
    f_sample_idx = torch.zeros((b,), dtype=torch.long, device=dev)
    f_accept = torch.zeros((b,), dtype=torch.bool, device=dev)
    f_acc_cnt = torch.zeros((), dtype=torch.long, device=dev)
    rate_sum = torch.zeros((), dtype=torch.float32, device=dev)
    levels = []
    for i in range(gamma):
        parent_idx = res.step_beam_idx[i]
        cur_p = _level_rows(p_root, p_nodes, i, b, r_slots)
        from_valid = valid[parent_idx]
        logj = torch.where(valid[:, None], torch.log(cur_p + 1e-30) + beam_scores[:, None],
                           torch.full_like(cur_p, _NEG))
        p_next = norm_logits(logj.reshape(1, -1), scfg)[0]  # [b*V] warped (:231)
        q_prob = torch.where(valid[:, None], res.step_joint_q[i].reshape(b, vocab),
                             torch.zeros((), device=dev)).reshape(-1)
        sample_idx = parent_idx * vocab + res.step_next_tok[i]
        q_scores = res.step_chosen_q[i]
        expect_cnt = _expect_cnt(p_next, q_prob, b, expect_thres, min_num_beams, False)
        levels.append(torch.where(active, expect_cnt, -1))

        # sequential accept over the beams with residual updates (:277-303);
        # a 0-dim index would be read on the host: gather a 1-element slice
        cur_prob, acc_cnt, accept = p_next, torch.zeros_like(max_l), []
        for j in range(b):
            a = from_valid[j] & (acc_cnt < expect_cnt) & (
                cur_prob.gather(0, sample_idx[j:j + 1])[0] / (q_scores[j] + 1e-6) > rmat[i, j])
            cur_prob = torch.where(a, p_next, max_fn(cur_prob - q_prob))
            acc_cnt = acc_cnt + a.long()
            accept.append(a)
        accept = torch.stack(accept)

        level_ok = acc_cnt >= expect_cnt
        advance, fail_now = active & level_ok, active & ~level_ok
        p_sc = torch.where(accept, p_next[sample_idx], torch.zeros((), device=dev))
        beam_scores = torch.where(advance, torch.log(p_sc + 1e-30), beam_scores)
        valid = torch.where(advance, accept, valid)
        max_l = max_l + advance.long()
        rate_sum = rate_sum + torch.where(active, accept.float().mean(), 0.0)
        f_p_next = torch.where(fail_now, p_next, f_p_next)
        f_resid = torch.where(fail_now, cur_prob, f_resid)
        f_sample_idx = torch.where(fail_now, sample_idx, f_sample_idx)
        f_accept = torch.where(fail_now, accept, f_accept)
        f_acc_cnt = torch.where(fail_now, acc_cnt, f_acc_cnt)
        active = active & level_ok

    all_acc = active
    # all accepted: the final joint over the last level's surviving beams (:344-350)
    cur_p = p_nodes[(gamma - 1) * b:gamma * b]
    logj = torch.where(valid[:, None], torch.log(cur_p + 1e-30) + beam_scores[:, None],
                       torch.full_like(cur_p, _NEG))
    p_final = norm_logits(logj.reshape(1, -1), scfg)[0]
    u, key = _uniforms(key, b * vocab)
    t_all = sample_k_u(p_final[None], u, num_beams)[0]
    u, key = _uniforms(key, b * vocab)
    t_fail = sample_k_u(f_p_next[None], u, num_beams)[0]
    u, key = _uniforms(key, b * vocab)
    t_resid = sample_u(f_resid[None], u)[0]
    t_partial = _partial_tokens(t_fail, t_resid, f_accept, f_sample_idx, f_acc_cnt, num_beams,
                                r_slots)
    t = torch.where(all_acc, t_all, t_partial)
    score_src = torch.where(all_acc, p_final, f_p_next)
    new_scores = torch.log(score_src[t] + 1e-30)[:r_slots]
    return t, max_l, all_acc, new_scores, rate_sum, torch.stack(levels), key


def _v2_walk_sparse(scfg, gamma, num_beams, vocab, expect_thres, min_num_beams,
                    res, p_root, p_nodes, r_slots, key):
    """:func:`_v2_walk` in candidate space: every per-level state lives on
    <= top_k candidates instead of [b*V]; exact up to the dense path's
    1e-30 log floor on zero-prob entries."""
    b = num_beams
    dev = p_root.probs.device
    u, key = _uniforms(key, gamma * b)
    rmat = u.reshape(gamma, b)
    kk = p_root.probs.shape[-1]
    active = torch.ones((), dtype=torch.bool, device=dev)
    max_l = torch.zeros((), dtype=torch.long, device=dev)
    valid = torch.arange(b, device=dev) < r_slots
    beam_scores = torch.zeros((b,), dtype=torch.float32, device=dev)
    f_dist = TopKDist(torch.zeros((kk,), dtype=torch.long, device=dev),
                      torch.zeros((kk,), dtype=torch.float32, device=dev))
    f_resid = torch.zeros((kk,), dtype=torch.float32, device=dev)
    f_sample_idx = torch.zeros((b,), dtype=torch.long, device=dev)
    f_accept = torch.zeros((b,), dtype=torch.bool, device=dev)
    f_acc_cnt = torch.zeros((), dtype=torch.long, device=dev)
    rate_sum = torch.zeros((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)
    levels = []
    qd = res.step_joint_q  # TopKDist [gamma, B*k] (sparse beam draft)
    for i in range(gamma):
        parent_idx = res.step_beam_idx[i]
        rows = _level_rows(p_root, p_nodes, i, b, r_slots)
        from_valid = valid[parent_idx]
        p_next = joint_topk_from_dists(rows, beam_scores, valid, scfg, vocab)
        q_row = TopKDist(qd.idx[i], torch.where(valid[qd.idx[i] // vocab], qd.probs[i], zero))
        sample_idx = parent_idx * vocab + res.step_next_tok[i]
        q_scores = res.step_chosen_q[i]
        expect_cnt = _expect_cnt(p_next, q_row, b, expect_thres, min_num_beams, True)
        levels.append(torch.where(active, expect_cnt, -1))

        # q's mass at p_next's candidates (constant over the level)
        q_at_p = torch.where(p_next.idx[:, None] == q_row.idx[None, :], q_row.probs[None, :],
                             zero).sum(-1)
        p_at_samples = _prob_at(p_next, sample_idx)  # [b]
        cur_probs, acc_cnt, accept = p_next.probs, torch.zeros_like(max_l), []
        for j in range(b):
            p_score = torch.where(p_next.idx == sample_idx[j], cur_probs, zero).sum()
            a = from_valid[j] & (acc_cnt < expect_cnt) & (
                p_score / (q_scores[j] + 1e-6) > rmat[i, j])
            resid = torch.clamp(cur_probs - q_at_p, min=0.0)
            resid = resid / (resid.sum() + 1e-6)
            cur_probs = torch.where(a, p_next.probs, resid)
            acc_cnt = acc_cnt + a.long()
            accept.append(a)
        accept = torch.stack(accept)

        level_ok = acc_cnt >= expect_cnt
        advance, fail_now = active & level_ok, active & ~level_ok
        p_sc = torch.where(accept, p_at_samples, zero)
        beam_scores = torch.where(advance, torch.log(p_sc + 1e-30), beam_scores)
        valid = torch.where(advance, accept, valid)
        max_l = max_l + advance.long()
        rate_sum = rate_sum + torch.where(active, accept.float().mean(), 0.0)
        f_dist = TopKDist(torch.where(fail_now, p_next.idx, f_dist.idx),
                          torch.where(fail_now, p_next.probs, f_dist.probs))
        f_resid = torch.where(fail_now, cur_probs, f_resid)
        f_sample_idx = torch.where(fail_now, sample_idx, f_sample_idx)
        f_accept = torch.where(fail_now, accept, f_accept)
        f_acc_cnt = torch.where(fail_now, acc_cnt, f_acc_cnt)
        active = active & level_ok

    all_acc = active
    p_final = joint_topk_from_dists(_level_rows(p_root, p_nodes, gamma, b, r_slots), beam_scores,
                                    valid, scfg, vocab)
    u, key = _uniforms(key, topk_draw_width(p_final, num_beams))
    t_all = sample_k_topk_u(p_final, u[0], num_beams)
    u, key = _uniforms(key, topk_draw_width(f_dist, num_beams))
    t_fail = sample_k_topk_u(f_dist, u[0], num_beams)
    u, key = _uniforms(key, kk)
    t_resid = sample_topk_u(TopKDist(f_dist.idx, f_resid), u[0])
    t_partial = _partial_tokens(t_fail, t_resid, f_accept, f_sample_idx, f_acc_cnt, num_beams,
                                r_slots)
    t = torch.where(all_acc, t_all, t_partial)
    score = torch.where(all_acc, _prob_at(p_final, t), _prob_at(f_dist, t))
    new_scores = torch.log(score + 1e-30)[:r_slots]
    return t, max_l, all_acc, new_scores, rate_sum, torch.stack(levels), key


def _v1_start(state, b: int, dev):
    """(first, the walk's starting validity, its starting scores): on the
    first step only beam 0 is valid (every committed row is the same),
    afterwards every row (reference :772-778). ``state.first`` is a device
    bool (or a host one)."""
    first = torch.as_tensor(state.first, device=dev)
    valid = torch.where(first, torch.arange(b, device=dev) == 0,
                        torch.ones((b,), dtype=torch.bool, device=dev))
    return first, valid, torch.where(first, torch.zeros((), device=dev), state.beam_scores)


def _v1_walk(scfg, gamma, num_beams, vocab, min_num_beams, res, p_root, p_nodes, state,
             r_slots, key):
    """Always-accept rescoring walk over dense joints (reference :772-892,
    with its r-1 quirk). Returns (t, max_l, all_acc, new_scores, rate_sum,
    key)."""
    b = num_beams
    dev = p_root.device
    u, key = _uniforms(key, gamma)
    rmat = u[0] - 1.0  # below any ratio
    active = torch.ones((), dtype=torch.bool, device=dev)
    max_l = torch.zeros((), dtype=torch.long, device=dev)
    first, valid, beam_scores = _v1_start(state, b, dev)
    f_p_next = torch.zeros((b * vocab,), dtype=torch.float32, device=dev)
    rate_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(gamma):
        parent_idx = res.step_beam_idx[i]
        if i == 0:
            parent_idx = torch.where(first, torch.zeros_like(parent_idx), parent_idx)  # :797
        cur_p = _level_rows(p_root, p_nodes, i, b, r_slots)
        from_valid = valid[parent_idx]
        logj = torch.where(valid[:, None], torch.log(cur_p + 1e-30) + beam_scores[:, None],
                           torch.full_like(cur_p, _NEG))
        p_next = torch.softmax(logj.reshape(-1), dim=-1)  # plain softmax (:826)
        sample_idx = parent_idx * vocab + res.step_next_tok[i]
        p_sc = torch.where(from_valid, p_next[sample_idx], torch.zeros((), device=dev))
        accept = (p_sc / (res.step_chosen_q[i] + 1e-5)) > rmat[i]  # :847
        accept = torch.where(from_valid.any(), accept, from_valid)  # :864-866
        level_ok = accept.long().sum() >= min_num_beams
        advance = active & level_ok
        beam_scores = torch.where(advance, torch.log(p_sc + 1e-30), beam_scores)
        valid = torch.where(advance, accept, valid)
        max_l = max_l + advance.long()
        rate_sum = rate_sum + torch.where(active, accept.float().mean(), 0.0)
        f_p_next = torch.where(active, p_next, f_p_next)  # the last active level's joint
        active = active & level_ok

    all_acc = active
    cur_p = p_nodes[(gamma - 1) * b:gamma * b]
    logj = torch.where(valid[:, None], torch.log(cur_p + 1e-30) + beam_scores[:, None],
                       torch.full_like(cur_p, _NEG))
    joint = torch.where(all_acc, logj.reshape(-1), torch.log(f_p_next + 1e-30))
    p_resample = norm_logits(joint.reshape(1, -1), scfg)[0]  # warped (:908/:975)
    u, key = _uniforms(key, b * vocab)
    t = sample_k_u(p_resample[None], u, num_beams)[0]
    new_scores = torch.log(p_resample[t] + 1e-30)[:r_slots]
    return t, max_l, all_acc, new_scores, rate_sum, key


def _v1_walk_sparse(scfg, gamma, num_beams, vocab, min_num_beams, res, p_root, p_nodes, state,
                    r_slots, key):
    """:func:`_v1_walk` on the warped rows' candidate support (the plain
    joint softmax already has support <= b*k because the rows are
    warped)."""
    b = num_beams
    dev = p_root.probs.device
    u, key = _uniforms(key, gamma)
    rmat = u[0] - 1.0  # below any ratio
    nall = b * p_root.probs.shape[-1]
    plain = SamplingConfig(1.0, 0, 0.0)  # plain softmax at accept (:826)
    active = torch.ones((), dtype=torch.bool, device=dev)
    max_l = torch.zeros((), dtype=torch.long, device=dev)
    first, valid, beam_scores = _v1_start(state, b, dev)
    f_dist = TopKDist(torch.zeros((nall,), dtype=torch.long, device=dev),
                      torch.zeros((nall,), dtype=torch.float32, device=dev))
    rate_sum = torch.zeros((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)
    for i in range(gamma):
        parent_idx = res.step_beam_idx[i]
        if i == 0:
            parent_idx = torch.where(first, torch.zeros_like(parent_idx), parent_idx)  # :797
        rows = _level_rows(p_root, p_nodes, i, b, r_slots)
        from_valid = valid[parent_idx]
        p_next = joint_topk_from_dists(rows, beam_scores, valid, plain, vocab, out_k=nall)
        sample_idx = parent_idx * vocab + res.step_next_tok[i]
        p_sc = torch.where(from_valid, _prob_at(p_next, sample_idx), zero)
        accept = (p_sc / (res.step_chosen_q[i] + 1e-5)) > rmat[i]  # :847
        accept = torch.where(from_valid.any(), accept, from_valid)  # :864-866
        level_ok = accept.long().sum() >= min_num_beams
        advance = active & level_ok
        beam_scores = torch.where(advance, torch.log(p_sc + 1e-30), beam_scores)
        valid = torch.where(advance, accept, valid)
        max_l = max_l + advance.long()
        rate_sum = rate_sum + torch.where(active, accept.float().mean(), 0.0)
        f_dist = TopKDist(torch.where(active, p_next.idx, f_dist.idx),
                          torch.where(active, p_next.probs, f_dist.probs))
        active = active & level_ok

    all_acc = active
    last = joint_topk_from_dists(_level_rows(p_root, p_nodes, gamma, b, r_slots), beam_scores,
                                 valid, plain, vocab, out_k=nall)
    sel = TopKDist(torch.where(all_acc, last.idx, f_dist.idx),
                   torch.where(all_acc, last.probs, f_dist.probs))
    p_resample = rewarp_topk(sel, scfg)  # warped (:908/:975)
    u, key = _uniforms(key, topk_draw_width(p_resample, num_beams))
    t = sample_k_topk_u(p_resample, u[0], num_beams)
    new_scores = torch.log(_prob_at(p_resample, t) + 1e-30)[:r_slots]
    return t, max_l, all_acc, new_scores, rate_sum, key


# ----------------------------------------------------------------- engines
def _tree_step(mode, bundle_d, params_d, bundle_t, params_t, scfg, gamma: int, num_beams: int,
               r_slots: int, expect_thres: float, min_num_beams: int, eos_token_id: int,
               st: TreeState) -> None:
    """One draft + tree verify + walk + commit + EOS bookkeeping on ``st``,
    in place (JAX ``_beam_tree_device``'s body), with no host read. The
    forwards sit at ``cw = min(cur_len, total - 1)``, which is ``cur_len`` on
    a live state; a finished state commits nothing the finish reads."""
    b = num_beams
    vocab = bundle_t.cfg.vocab_size
    dev = st.row_tokens.device
    active = ~st.stop
    cw = torch.minimum(st.cur_len.long(), st.total.long() - 1)
    slot = _slot_pattern(b, r_slots, dev)
    init_scores = torch.where(torch.arange(b, device=dev) < r_slots, 0.0, float("-inf"))
    # st.draft_cache keeps its committed rows for the commit: the draft's
    # reorders gather into caches of their own (shared_prefix=False)
    res = beam_draft(bundle_d, params_d, scfg, gamma, b, st.row_tokens.index_select(0, slot), cw,
                     st.draft_cache, st.key, init_beam_scores=init_scores, init_root=slot,
                     capture_kv=True)
    anc = ancestor_matrix(res.step_beam_idx, gamma, b)
    p_root, p_nodes, _ = tree_verify(
        bundle_t, params_t, scfg, gamma, b, st.row_tokens, cw, st.target_cache,
        res.step_next_tok.reshape(-1), res.step_root.reshape(-1), anc)
    sparse = use_sparse(scfg)
    if mode == "v2":
        walk = _v2_walk_sparse if sparse else _v2_walk
        t, max_l, _, new_scores, rate_sum, levels, key = walk(
            scfg, gamma, b, vocab, expect_thres, min_num_beams, res, p_root, p_nodes, r_slots,
            res.key)
    else:
        walk = _v1_walk_sparse if sparse else _v1_walk
        t, max_l, _, new_scores, rate_sum, key = walk(
            scfg, gamma, b, vocab, min_num_beams, res, p_root, p_nodes, st, r_slots, res.key)
        levels = torch.full((gamma,), -1, dtype=torch.long, device=dev)
    full_scores = torch.cat([new_scores, torch.zeros((b - r_slots,), device=dev)])
    col = st.steps.long().clamp(max=st.acc_len_hist.shape[0] - 1).reshape(1)
    _commit(st, res, t[:r_slots], max_l, full_scores, active, cw, gamma, b, r_slots, vocab)
    scatter_where_(st.acc_len_hist, col, max_l.reshape(1), active)
    st.expect_hist.index_copy_(0, col, torch.where(active, levels[None].to(torch.int32),
                                                   st.expect_hist.index_select(0, col)))
    st.first.copy_(st.first & ~active)
    st.accepted.add_(torch.where(active, max_l, 0).to(torch.int32))
    st.steps.add_(active.to(torch.int32))
    st.rate_sum.copy_(torch.where(active, st.rate_sum + rate_sum, st.rate_sum))
    st.rate_cnt.add_(active.to(torch.int32) * gamma)
    st.key.copy_(torch.where(active, key, st.key))
    _eos_bookkeeping(st, eos_token_id, r_slots, active)
    st.stop.copy_(device_loop.finished(st))


def _run_tree(mode, bundle_d, params_d, bundle_t, params_t, prompt, max_new_tokens, *,
              gamma, num_beams, min_num_beams, extra_sample_cnt, expect_thres, eos_token_id,
              temperature, top_k, top_p, generator, details, tp_mesh, device):
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle_d, bundle_t = bundle_d.for_params(params_d), bundle_t.for_params(params_t)
    pd, pt = unstack_layers(params_d), unstack_layers(params_t)
    prompt_padded, p_len = pad_prompt(prompt)
    if p_len < 2:
        raise ValueError("prompt must have at least 2 tokens")
    p_bucket = prompt_padded.shape[1]
    # room for a finished state's step too: its windows reach total + gamma
    # + gamma*num_beams positions
    max_total = aligned_total(p_bucket + max_new_tokens + gamma + num_beams * gamma + 2)
    b = num_beams
    r_slots = num_beams if mode == "v1" else max(extra_sample_cnt, 1)
    total = p_len + max_new_tokens
    for bundle in (bundle_d, bundle_t):
        device_loop.check_positions(bundle, max(p_bucket, total + gamma - 1))
    expect_thres, min_num_beams = float(expect_thres), int(min_num_beams)
    key = device_loop.stream_key(gen, dev)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    st = device_loop.run(
        ("beam_" + mode, bundle_d, bundle_t, gamma, b, r_slots, min_num_beams, expect_thres,
         max_total, max_new_tokens, scfg, eos_token_id),
        (params_d, params_t),
        functools.partial(_tree_state, bundle_d, bundle_t, b, r_slots, gamma, max_total,
                          max_new_tokens, dev),
        functools.partial(_tree_start, bundle_d, pd, bundle_t, pt, prompt_t, p_len, total, key,
                          tp_mesh),
        functools.partial(_tree_step, mode, bundle_d, pd, bundle_t, pt, scfg, gamma, b, r_slots,
                          expect_thres, min_num_beams, eos_token_id),
        max_new_tokens, replay=dev.type == "cuda" and tp_mesh is None)

    # the final candidates: surviving rows by normalized score (:536-548)
    cur_len = st.cur_len.long()
    norm = st.beam_scores[:r_slots] / (cur_len - p_len).clamp(min=1).float()
    norm = torch.where(st.alive, norm, torch.full_like(norm, _NEG))
    fb = torch.argmax(norm).reshape(1)
    improved = norm.index_select(0, fb)[0] > st.best_score
    best_tokens = torch.where(improved, st.row_tokens.index_select(0, fb)[0], st.best_tokens)
    best_len = torch.where(improved, cur_len, st.best_len.long())
    n_out, steps, accepted, rate_cnt = torch.stack(
        [best_len, st.steps.long(), st.accepted.long(), st.rate_cnt.long()]).tolist()
    out = best_tokens[:n_out].cpu().numpy().astype("int32")
    synchronize(dev)
    wall = time.perf_counter() - t0
    if not details:
        return out
    acc_list = st.acc_len_hist[:steps].tolist()
    eh2d = st.expect_hist[:steps].cpu().numpy().astype("int64")
    # reference num_beams_list: acc_cnt per advanced level (== expect_cnt
    # there) + extra_sample_cnt (v2) / num_beams (v1) on the failing level;
    # v1 reports num_beams per level, as the JAX engine does
    nbl = []
    for s in range(steps):
        lvl = acc_list[s]
        if mode == "v2":
            nbl += [int(x) for x in eh2d[s][:lvl]]
            if lvl < gamma and int((eh2d[s] >= 0).sum()) > lvl:
                nbl.append(int(r_slots))
        else:
            nbl += [int(num_beams)] * (lvl + (lvl < gamma))
    eh = eh2d.reshape(-1)
    n_gen = max(len(out) - p_len, 0)
    d = {
        "total_time": wall,
        "accepted_count": accepted,
        "acc_rate": float(st.rate_sum) / max(rate_cnt, 1),
        "target_call_times": steps,
        "approx_call_times": steps,
        "acc_len": acc_list,
        "expect_cnt_list": eh[eh >= 0].tolist() if mode == "v2" else [],
        "num_beams_list": nbl,
        # the width DP runs inside the step on the device: no separate phase
        "compute_expect_time": 0.0,
        "tokens_generated": n_gen,
        "tokens_per_s": n_gen / wall if wall > 0 else float("nan"),
    }
    fill_phase_split(
        d, wall, steps, bundle_d, pd, bundle_t, pt,
        draft_rows=num_beams, verify_rows=r_slots, gamma=gamma,
        verify_tokens=gamma * num_beams + 1, max_total=max_total, device=dev,
    )
    return out, d


def beam_speculative_generate(
    bundle_d: ModelBundle, params_d, bundle_t: ModelBundle, params_t, prompt, max_new_tokens, *,
    gamma: int = 4, width: int = 8, num_beams: int = 8, min_num_beams: int = 1,
    eos_token_id: int, temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
    generator: Optional[torch.Generator] = None, random_seed=None, details: bool = False,
    tp_mesh=None, device=None,
):
    """beam_speculative_sampling ("v1"): tree-verified beam speculative
    decoding with the always-accept rescore. Returns numpy int32 [T]
    (prompt included); with ``details=True`` also the reference-schema dict.

    ``width`` is taken for signature parity: in the reference it only sets
    the draft's ``num_return_sequences`` while the walk iterates
    ``num_beams``; the tree's branch factor here is ``num_beams``. ``tp_mesh``:
    see ``engine/speculative.py::speculative_generate``."""
    del width, random_seed
    return _run_tree(
        "v1", bundle_d, params_d, bundle_t, params_t, prompt, max_new_tokens,
        gamma=gamma, num_beams=num_beams, min_num_beams=min_num_beams, extra_sample_cnt=-1,
        expect_thres=0.7, eos_token_id=eos_token_id, temperature=temperature, top_k=top_k,
        top_p=top_p, generator=generator, details=details, tp_mesh=tp_mesh, device=device,
    )


def beam_speculative_v2_generate(
    bundle_d: ModelBundle, params_d, bundle_t: ModelBundle, params_t, prompt, max_new_tokens, *,
    gamma: int = 4, width: int = 8, num_beams: int = 8, min_num_beams: int = 1,
    extra_sample_cnt: int = -1, expect_thres: float = 0.7,
    eos_token_id: int, temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
    generator: Optional[torch.Generator] = None, random_seed=None, details: bool = False,
    tp_mesh=None, device=None,
):
    """beam_speculative_sampling_v2 (the flagship): tree-verified beam
    speculative decoding with the dynamic-width walk. ``extra_sample_cnt``
    (-1: ``num_beams``) is the number of committed rows carried between
    steps. ``width`` is taken for signature parity (see
    :func:`beam_speculative_generate`)."""
    del width, random_seed
    if extra_sample_cnt == -1:
        extra_sample_cnt = num_beams
    return _run_tree(
        "v2", bundle_d, params_d, bundle_t, params_t, prompt, max_new_tokens,
        gamma=gamma, num_beams=num_beams, min_num_beams=min_num_beams,
        extra_sample_cnt=extra_sample_cnt, expect_thres=expect_thres, eos_token_id=eos_token_id,
        temperature=temperature, top_k=top_k, top_p=top_p, generator=generator, details=details,
        tp_mesh=tp_mesh, device=device,
    )
