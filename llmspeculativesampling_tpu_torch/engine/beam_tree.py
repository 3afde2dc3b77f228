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

The JAX engine is one ``lax.while_loop``; here a host loop runs steps of
fixed shapes (num_beams draft rows, r_slots x (N+1) tree tokens) and reads
the device ONCE a step, after the walk: the accepted depth, the committed
tokens of every row, their roots and scores, which the host keeps in a
mirror of the rows for the EOS bookkeeping and the output. The walks draw
from ``generator``; the beam draft from a counter stream seeded once from it
(``device_loop.stream_key``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..cache.kvcache import compact_tree_paths, rollback, select_rows, write_positions
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
    sample,
    sample_k,
    sample_k_topk,
    sample_topk,
    use_sparse,
)
from . import device_loop
from .beam_draft import beam_draft
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


def tree_verify(bundle, params, scfg, gamma, num_beams, row_tokens, cur_len: int, cache,
                node_tokens, node_roots, anc):
    """One tree-attention target forward over [anchor] + N nodes for each of
    the R committed rows. Returns (p_root [R, ...], p_nodes [N, ...], cache):
    warped distributions; p_root[r] conditions on row r, p_nodes[j] on node
    j's path (read from batch row ``node_roots[j]``)."""
    r_rows = row_tokens.shape[0]
    n = gamma * num_beams
    dev = row_tokens.device
    cache = rollback(cache, cur_len - 1)
    anchor = row_tokens[:, cur_len - 1:cur_len]
    vin = torch.cat([anchor, node_tokens[None].expand(r_rows, n)], dim=1)
    # block mask [N+1, N+1]: the anchor visible to all, nodes see their ancestors
    block = torch.zeros((n + 1, n + 1), dtype=torch.bool, device=dev)
    block[:, 0] = True
    block[1:, 1:] = anc
    block = block[None].expand(r_rows, n + 1, n + 1)
    node_s = torch.arange(gamma, device=dev).repeat_interleave(num_beams)  # level of node j
    positions = torch.cat([torch.full((1,), cur_len - 1, device=dev), cur_len + node_s])
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
    row_tokens: torch.Tensor  # [R, T] committed parallel prefixes (device)
    rows_host: np.ndarray     # the same rows on the host
    cur_len: int
    draft_cache: object       # committed draft cache (B rows, slot pattern)
    target_cache: object      # committed target cache (R rows)
    beam_scores: torch.Tensor  # [B] committed row scores (carried in v1)
    scores_host: np.ndarray   # float32 [R]: beam_scores[:R] on the host
    alive: np.ndarray         # [R] row not yet EOS-finished
    best_tokens: np.ndarray   # best finished candidate (EOS bookkeeping)
    key: torch.Tensor         # [1, 2] the beam draft's counter stream
    best_len: int = 0
    best_score: np.float32 = np.float32(_NEG)
    done: bool = False
    first: bool = True        # v1's first-iteration valid-beam special case
    accepted: int = 0
    steps: int = 0
    rate_sum: float = 0.0
    rate_cnt: int = 0
    acc_len_hist: list = dataclasses.field(default_factory=list)  # levels accepted a step
    expect_hist: list = dataclasses.field(default_factory=list)   # v2 expect_cnt a level


def _slot_pattern(b: int, r: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(b, device=device), max=r - 1)


def _commit(state: TreeState, res, roots, path_rows, path_tokens, path_nodes, token,
            max_l: int, new_scores_full, gamma, num_beams, r_slots):
    """Commit the R slots on the device: tokens, the target cache's tree
    compaction, the draft cache's rebuild. ``state.draft_cache`` must be the
    committed cache from before the draft (its rows follow the slot
    pattern): the rebuild selects its prefix rows and overlays the captured
    anchor and node k/v of the accepted paths."""
    cur_len = state.cur_len
    dev = state.row_tokens.device
    new_len = cur_len + max_l + 1

    rows = state.row_tokens[roots]
    rows[:, cur_len:cur_len + max_l] = path_tokens[:, :max_l]
    rows[:, new_len - 1] = token

    # target: row-select by root, compact the accepted path (node j sits at
    # cache position cur_len + j, the anchor at cur_len-1)
    valid = (torch.arange(gamma, device=dev) < max_l)[None].expand(r_slots, gamma)
    tc = compact_tree_paths(select_rows(state.target_cache, roots), path_nodes, valid, cur_len,
                            new_length=cur_len + max_l)

    # draft: committed rows by root + the anchor window and the path's nodes
    slot = _slot_pattern(num_beams, r_slots, dev)
    rows_map = roots[slot]
    dc = select_rows(state.draft_cache, rows_map)
    write_positions(dc, tuple(a[:, rows_map] for a in res.anchor_kv), cur_len - 2)
    pr = path_rows[slot]  # [B, gamma]
    for s in range(min(max_l, gamma - 1)):
        write_positions(dc, tuple(x[:, pr[:, s]] for x in res.node_kv[s]), cur_len + s)
    dc = rollback(dc, max(cur_len + max_l - 1, 2))
    return dataclasses.replace(state, row_tokens=rows, cur_len=new_len, draft_cache=dc,
                               target_cache=tc, beam_scores=new_scores_full)


def _eos_bookkeeping(state: TreeState, eos_token_id: int, prompt_len: int, r_slots: int):
    """Candidate collection and termination, on the host mirror."""
    seqs = state.rows_host
    pos = np.arange(seqs.shape[1])
    gen_mask = (pos[None] >= prompt_len) & (pos[None] < state.cur_len)
    eos_hits = gen_mask & (seqs == eos_token_id)
    has_eos = eos_hits.any(axis=1)
    cand_len = np.where(has_eos, np.argmax(eos_hits, axis=1) + 1, state.cur_len)
    norm = state.scores_host / np.maximum(cand_len - prompt_len, 1).astype(np.float32)
    cand_score = np.where(has_eos & state.alive, norm, np.float32(_NEG)).astype(np.float32)
    cb = int(np.argmax(cand_score))
    if cand_score[cb] > state.best_score:
        state.best_tokens = seqs[cb].copy()
        state.best_len = int(cand_len[cb])
        state.best_score = cand_score[cb]
    state.alive = state.alive & ~has_eos
    done = bool(has_eos[0]) if r_slots == 1 else not state.alive.any()
    state.done = state.done or done
    return state


# ------------------------------------------------------------------ walks
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
             res, p_root, p_nodes, r_slots, generator):
    """Dynamic-width DP walk over dense [b*V] joints (reference :188-337).
    Returns (t [b] flat ids, max_l, all_acc, new_scores [r_slots],
    rate_sum, expect_levels [gamma]), all on the device."""
    b = num_beams
    dev = p_root.device
    rmat = torch.rand((gamma, b), generator=generator, device=dev)
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

        # sequential accept over the beams with residual updates (:277-303)
        cur_prob, acc_cnt, accept = p_next, torch.zeros_like(max_l), []
        for j in range(b):
            a = from_valid[j] & (acc_cnt < expect_cnt) & (
                cur_prob[sample_idx[j]] / (q_scores[j] + 1e-6) > rmat[i, j])
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
    t_all = sample_k(generator, p_final[None], num_beams)[0]
    t_fail = sample_k(generator, f_p_next[None], num_beams)[0]
    t_resid = sample(generator, f_resid[None])[0]
    t_partial = _partial_tokens(t_fail, t_resid, f_accept, f_sample_idx, f_acc_cnt, num_beams,
                                r_slots)
    t = torch.where(all_acc, t_all, t_partial)
    score_src = torch.where(all_acc, p_final, f_p_next)
    new_scores = torch.log(score_src[t] + 1e-30)[:r_slots]
    return t, max_l, all_acc, new_scores, rate_sum, torch.stack(levels)


def _v2_walk_sparse(scfg, gamma, num_beams, vocab, expect_thres, min_num_beams,
                    res, p_root, p_nodes, r_slots, generator):
    """:func:`_v2_walk` in candidate space: every per-level state lives on
    <= top_k candidates instead of [b*V]; exact up to the dense path's
    1e-30 log floor on zero-prob entries."""
    b = num_beams
    dev = p_root.probs.device
    rmat = torch.rand((gamma, b), generator=generator, device=dev)
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
    t_all = sample_k_topk(generator, p_final, num_beams)
    t_fail = sample_k_topk(generator, f_dist, num_beams)
    t_resid = sample_topk(generator, TopKDist(f_dist.idx, f_resid))
    t_partial = _partial_tokens(t_fail, t_resid, f_accept, f_sample_idx, f_acc_cnt, num_beams,
                                r_slots)
    t = torch.where(all_acc, t_all, t_partial)
    score = torch.where(all_acc, _prob_at(p_final, t), _prob_at(f_dist, t))
    new_scores = torch.log(score + 1e-30)[:r_slots]
    return t, max_l, all_acc, new_scores, rate_sum, torch.stack(levels)


def _v1_start(state: TreeState, b: int, dev):
    """The walk's starting validity and scores: on the first step only beam
    0 is valid (every committed row is the same), afterwards every row
    (reference :772-778)."""
    if state.first:
        return (torch.arange(b, device=dev) == 0,
                torch.zeros((b,), dtype=torch.float32, device=dev))
    return torch.ones((b,), dtype=torch.bool, device=dev), state.beam_scores


def _v1_walk(scfg, gamma, num_beams, vocab, min_num_beams, res, p_root, p_nodes, state,
             r_slots, generator):
    """Always-accept rescoring walk over dense joints (reference :772-892,
    with its r-1 quirk). Returns (t, max_l, all_acc, new_scores, rate_sum)."""
    b = num_beams
    dev = p_root.device
    rmat = torch.rand((gamma,), generator=generator, device=dev) - 1.0  # below any ratio
    active = torch.ones((), dtype=torch.bool, device=dev)
    max_l = torch.zeros((), dtype=torch.long, device=dev)
    valid, beam_scores = _v1_start(state, b, dev)
    f_p_next = torch.zeros((b * vocab,), dtype=torch.float32, device=dev)
    rate_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(gamma):
        parent_idx = res.step_beam_idx[i]
        if i == 0 and state.first:
            parent_idx = torch.zeros_like(parent_idx)  # :797
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
    t = sample_k(generator, p_resample[None], num_beams)[0]
    new_scores = torch.log(p_resample[t] + 1e-30)[:r_slots]
    return t, max_l, all_acc, new_scores, rate_sum


def _v1_walk_sparse(scfg, gamma, num_beams, vocab, min_num_beams, res, p_root, p_nodes, state,
                    r_slots, generator):
    """:func:`_v1_walk` on the warped rows' candidate support (the plain
    joint softmax already has support <= b*k because the rows are
    warped)."""
    b = num_beams
    dev = p_root.probs.device
    rmat = torch.rand((gamma,), generator=generator, device=dev) - 1.0  # below any ratio
    nall = b * p_root.probs.shape[-1]
    plain = SamplingConfig(1.0, 0, 0.0)  # plain softmax at accept (:826)
    active = torch.ones((), dtype=torch.bool, device=dev)
    max_l = torch.zeros((), dtype=torch.long, device=dev)
    valid, beam_scores = _v1_start(state, b, dev)
    f_dist = TopKDist(torch.zeros((nall,), dtype=torch.long, device=dev),
                      torch.zeros((nall,), dtype=torch.float32, device=dev))
    rate_sum = torch.zeros((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), device=dev)
    for i in range(gamma):
        parent_idx = res.step_beam_idx[i]
        if i == 0 and state.first:
            parent_idx = torch.zeros_like(parent_idx)  # :797
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
    t = sample_k_topk(generator, p_resample, num_beams)
    new_scores = torch.log(_prob_at(p_resample, t) + 1e-30)[:r_slots]
    return t, max_l, all_acc, new_scores, rate_sum


# ----------------------------------------------------------------- engines
def _tree_step(state: TreeState, mode, bundle_d, params_d, bundle_t, params_t, scfg, *, gamma,
               num_beams, r_slots, expect_thres, min_num_beams, eos_token_id, prompt_len,
               generator):
    """One draft + tree verify + walk + commit, with one host read."""
    b = num_beams
    vocab = bundle_t.cfg.vocab_size
    dev = state.row_tokens.device
    slot = _slot_pattern(b, r_slots, dev)
    init_scores = torch.where(torch.arange(b, device=dev) < r_slots, 0.0, float("-inf"))
    res = beam_draft(bundle_d, params_d, scfg, gamma, b, state.row_tokens[slot], state.cur_len,
                     state.draft_cache, state.key, init_beam_scores=init_scores, init_root=slot,
                     capture_kv=True)
    state.key = res.key
    anc = ancestor_matrix(res.step_beam_idx, gamma, b)
    p_root, p_nodes, target_cache = tree_verify(
        bundle_t, params_t, scfg, gamma, b, state.row_tokens, state.cur_len, state.target_cache,
        res.step_next_tok.reshape(-1), res.step_root.reshape(-1), anc)
    # state.draft_cache stays the committed cache from before the draft, for _commit
    state.target_cache = target_cache
    sparse = use_sparse(scfg)
    if mode == "v2":
        walk = _v2_walk_sparse if sparse else _v2_walk
        t, max_l, _, new_scores, rate_sum, levels = walk(
            scfg, gamma, b, vocab, expect_thres, min_num_beams, res, p_root, p_nodes, r_slots,
            generator)
    else:
        walk = _v1_walk_sparse if sparse else _v1_walk
        t, max_l, _, new_scores, rate_sum = walk(
            scfg, gamma, b, vocab, min_num_beams, res, p_root, p_nodes, state, r_slots, generator)
        levels = torch.full((gamma,), -1, dtype=torch.long, device=dev)
    t = t[:r_slots]
    parent, token = torch.div(t, vocab, rounding_mode="floor"), t % vocab
    path_rows, path_tokens, path_nodes, roots = backtrack_path(
        res.step_beam_idx, res.step_next_tok, parent, max_l, gamma, b)
    # when max_l == 0 the "parent" indexes the roots directly
    roots = torch.where(max_l == 0, parent, roots).clamp(0, r_slots - 1)

    # the one host read of the step
    host = torch.cat([max_l.reshape(1).double(), rate_sum.reshape(1).double(), levels.double(),
                      token.double(), roots.double(), path_tokens.reshape(-1).double(),
                      new_scores.double()]).cpu().numpy()
    n_l = int(host[0])
    o = 2 + gamma
    token_h = host[o:o + r_slots].astype(np.int64)
    roots_h = host[o + r_slots:o + 2 * r_slots].astype(np.int64)
    o += 2 * r_slots
    path_h = host[o:o + r_slots * gamma].reshape(r_slots, gamma).astype(np.int64)
    scores_h = host[o + r_slots * gamma:].astype(np.float32)

    full_scores = torch.zeros((b,), dtype=torch.float32, device=dev)
    full_scores[:r_slots] = new_scores
    cur_len = state.cur_len
    state = _commit(state, res, roots, path_rows, path_tokens, path_nodes, token, n_l,
                    full_scores, gamma, b, r_slots)
    rows = state.rows_host[roots_h]
    rows[:, cur_len:cur_len + n_l] = path_h[:, :n_l]
    rows[:, cur_len + n_l] = token_h
    state.rows_host = rows
    state.scores_host = scores_h
    state.first = False
    state.accepted += n_l
    state.steps += 1
    state.rate_sum += float(host[1])
    state.rate_cnt += gamma
    state.acc_len_hist.append(n_l)
    state.expect_hist.append(host[2:2 + gamma].astype(np.int64))
    return _eos_bookkeeping(state, eos_token_id, prompt_len, r_slots)


def _run_tree(mode, bundle_d, params_d, bundle_t, params_t, prompt, max_new_tokens, *,
              gamma, num_beams, min_num_beams, extra_sample_cnt, expect_thres, eos_token_id,
              temperature, top_k, top_p, generator, details, tp_mesh, device):
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle_d, bundle_t = bundle_d.for_params(params_d), bundle_t.for_params(params_t)
    params_d, params_t = unstack_layers(params_d), unstack_layers(params_t)
    prompt_padded, p_len = pad_prompt(prompt)
    if p_len < 2:
        raise ValueError("prompt must have at least 2 tokens")
    max_total = aligned_total(prompt_padded.shape[1] + max_new_tokens + gamma
                              + num_beams * gamma + 2)
    b = num_beams
    r_slots = num_beams if mode == "v1" else max(extra_sample_cnt, 1)

    synchronize(dev)
    t0 = time.perf_counter()
    draft_cache = bundle_d.make_cache(b, max_total, device=dev)
    target_cache = bundle_t.make_cache(r_slots, max_total, device=dev)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)
    width = prompt_t.shape[1]
    row_tokens = torch.zeros((r_slots, max_total), dtype=torch.long, device=dev)
    row_tokens[:, :width] = prompt_t
    rows_host = np.zeros((r_slots, max_total), np.int64)
    rows_host[:, :width] = prompt_padded[0]
    _, draft_cache = bundle_d.forward(params_d, bundle_d.cfg, prompt_t.expand(b, width),
                                      draft_cache)
    _, target_cache = bundle_t.forward(params_t, bundle_t.cfg, prompt_t.expand(r_slots, width),
                                       target_cache, tp_mesh=tp_mesh)
    state = TreeState(
        row_tokens=row_tokens, rows_host=rows_host, cur_len=p_len, draft_cache=draft_cache,
        target_cache=target_cache, beam_scores=torch.zeros((b,), dtype=torch.float32, device=dev),
        scores_host=np.zeros((r_slots,), np.float32), alive=np.ones((r_slots,), bool),
        best_tokens=np.zeros((max_total,), np.int64), key=device_loop.stream_key(gen, dev))
    total = p_len + max_new_tokens
    while state.cur_len < total and not state.done:
        state = _tree_step(
            state, mode, bundle_d, params_d, bundle_t, params_t, scfg, gamma=gamma,
            num_beams=num_beams, r_slots=r_slots, expect_thres=float(expect_thres),
            min_num_beams=int(min_num_beams), eos_token_id=eos_token_id, prompt_len=p_len,
            generator=gen)

    # the final candidates: surviving rows by normalized score (:536-548)
    norm = state.scores_host / np.float32(max(state.cur_len - p_len, 1))
    norm = np.where(state.alive, norm, np.float32(_NEG)).astype(np.float32)
    fb = int(np.argmax(norm))
    if norm[fb] > state.best_score:
        state.best_tokens, state.best_len = state.rows_host[fb], state.cur_len
    synchronize(dev)
    wall = time.perf_counter() - t0
    out = state.best_tokens[:state.best_len].astype("int32")
    if not details:
        return out
    steps = state.steps
    eh2d = np.asarray(state.expect_hist, np.int64).reshape(steps, gamma)
    acc_list = list(state.acc_len_hist)
    # reference num_beams_list: acc_cnt per advanced level (== expect_cnt
    # there) + extra_sample_cnt (v2) / num_beams (v1) on the failing level;
    # v1 reports num_beams per level, as the JAX engine does
    nbl = []
    for st in range(steps):
        lvl = acc_list[st]
        if mode == "v2":
            nbl += [int(x) for x in eh2d[st][:lvl]]
            if lvl < gamma and int((eh2d[st] >= 0).sum()) > lvl:
                nbl.append(int(r_slots))
        else:
            nbl += [int(num_beams)] * (lvl + (lvl < gamma))
    eh = eh2d.reshape(-1)
    n_gen = max(len(out) - p_len, 0)
    d = {
        "total_time": wall,
        "accepted_count": state.accepted,
        "acc_rate": state.rate_sum / max(state.rate_cnt, 1),
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
        d, wall, steps, bundle_d, params_d, bundle_t, params_t,
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
