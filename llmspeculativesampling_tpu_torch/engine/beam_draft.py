"""Beam-sample drafting with intermediate capture
(counterpart of ``llmspeculativesampling_tpu/engine/beam_draft.py``).

At each of gamma steps the next ``num_beams`` beams are drawn without
replacement from the joint beam x vocab distribution
``softmax(rowwarp(log_softmax(logits)) + beam_scores)``; a beam's score
becomes its chosen joint log-score clamped at -1e10; the cache and every
per-path buffer are reordered by parent, so row w of every output refers to
the same path (the reference leaves ``seq_scores`` unordered, a row
misalignment the JAX engine fixes and this port keeps fixed). Per-step
intermediates are captured for the tree verifier: parent row, next token,
chosen joint probability, the joint itself, per-beam distributions and the
root (input row) of each node.

``capture_kv=True`` also keeps the k/v each draft forward writes (the
2-position anchor window, then one position per node), so an accepted
path's draft cache can be rebuilt by an ancestor gather instead of keeping
a full cache per step.

The JAX scan over the gamma steps is a Python loop here; every shape is
fixed (``num_beams`` rows, 2 tokens on the first forward, 1 after), the
committed length is a position on the device, and nothing is read back to
the host, so the draft runs inside a captured step (``engine/beam_spec.py``,
``engine/beam_tree.py``).
Random draws come from the counter stream of ``keys`` (``ops/sampling.py::
row_uniform``), advanced and returned as JAX returns ``res.key``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..cache.kvcache import read_positions, rollback_rows, select_rows, select_rows_
from ..ops.sampling import (
    SamplingConfig,
    TopKDist,
    dist_concat,
    joint_rowwarp_dense,
    joint_rowwarp_topk,
    prob_of_topk,
    row_uniform,
    sample_k_topk_u,
    sample_k_u,
    topk_draw_width,
    use_sparse,
)
from .speculative import rows_window

_SCORE_CLAMP = -1e10


class BeamDraftResult(NamedTuple):
    tail: torch.Tensor           # [B, gamma] drafted tokens per final beam path
    beam_scores: torch.Tensor    # [B] final joint log-scores (clamped)
    seq_q: torch.Tensor          # [B, gamma] chosen joint sampling prob along each path
    root: torch.Tensor           # [B] step-0 ancestor row of each final beam
    step_beam_idx: torch.Tensor  # [gamma, B] parent row at each step
    step_next_tok: torch.Tensor  # [gamma, B]
    step_chosen_q: torch.Tensor  # [gamma, B] chosen joint prob (step arrangement)
    step_joint_q: object         # per-step joint: dense [gamma, B*V], or a flat-id
                                 # TopKDist [gamma, B*k] with top-k warping
    perbeam_probs: torch.Tensor  # [B, gamma, V] per-beam normalized dist along each path
    step_root: torch.Tensor      # [gamma, B] root of each node (step arrangement)
    cache: object
    key: Optional[torch.Tensor] = None  # [1, 2] the stream's key after the draft's draws
    # capture_kv=True (else None): the cache buffers' slices
    # (``cache.kvcache.kv_buffers`` order) at the 2-position anchor window
    # cur_len-2..cur_len-1, in the initial row arrangement, and per node
    # entry s < gamma-1 the position cur_len+s of node (s, b)
    anchor_kv: Optional[tuple] = None  # each [L, B, H, 2(, D)]
    node_kv: Optional[list] = None     # gamma-1 tuples, each buffer [L, B, H, 1(, D)]


def beam_draft(
    bundle,
    params,
    scfg: SamplingConfig,
    gamma: int,
    num_beams: int,
    row_tokens: torch.Tensor,  # [num_beams, T] committed buffer per row
    cur_len,
    cache,
    keys: torch.Tensor,
    init_beam_scores: Optional[torch.Tensor] = None,
    init_root: Optional[torch.Tensor] = None,
    capture_kv: bool = False,
    shared_prefix: bool = False,
) -> BeamDraftResult:
    """gamma-step beam-sample draft over ``num_beams`` rows.

    ``cur_len`` is the committed length, a host int or a device scalar;
    the draft re-feeds positions cur_len-2, cur_len-1 of every row (the
    cache's per-row lengths are reset there) and writes up to
    cur_len+gamma-2. ``keys`` [1, 2] is the stream the draws come from.
    Rows may hold different committed prefixes; ``init_beam_scores`` marks
    padding rows with -inf. The joint is warped with top-k/top-p but not
    temperature, as the reference's beam sampler's warper list.

    ``shared_prefix``: every row holds the same committed prefix (one
    winner re-broadcast). Then a reorder by parent moves only the window the
    draft writes, in place in ``cache``'s own buffers; otherwise every step
    gathers whole rows into a new cache and ``cache`` keeps its rows (but
    for the re-fed window, which the first forward writes into it)."""
    cfg = bundle.cfg
    b = num_beams
    vocab = cfg.vocab_size
    dev = row_tokens.device
    joint_cfg = SamplingConfig(1.0, scfg.top_k, scfg.top_p)
    sparse = use_sparse(joint_cfg)
    # a host int is filled in on the card, not copied (a copy would wait for it)
    start = (cur_len.long().reshape(()) if isinstance(cur_len, torch.Tensor)
             else torch.full((), cur_len, dtype=torch.long, device=dev)) - 2

    beam_scores = (init_beam_scores.float() if init_beam_scores is not None
                   else torch.zeros((b,), dtype=torch.float32, device=dev))
    root = init_root if init_root is not None else torch.arange(b, device=dev)
    tail = torch.zeros((b, gamma), dtype=torch.long, device=dev)
    seq_q = torch.zeros((b, gamma), dtype=torch.float32, device=dev)
    probs_buf = torch.zeros((b, gamma, vocab), dtype=torch.float32, device=dev)

    # first forward: the 2-token re-derivation window (an idempotent rewrite)
    starts = start.expand(b)
    logits, cache = bundle.forward(params, cfg, rows_window(row_tokens, starts, 2),
                                   rollback_rows(cache, starts))
    logits_b = logits[:, -1]
    anchor_kv = read_positions(cache, cur_len - 2, 2) if capture_kv else None
    node_kv = [] if capture_kv else None

    parents, toks, chosen, joints, roots = [], [], [], [], []
    for step in range(gamma):
        if step > 0:
            logits, cache = bundle.forward(params, cfg, tail[:, step - 1:step], cache)
            logits_b = logits[:, 0]
            if capture_kv:  # this forward wrote node (step-1, b) at cur_len-1+step
                node_kv.append(read_positions(cache, cur_len - 1 + step, 1))
        logp = torch.log_softmax(logits_b.float(), dim=-1)  # [B, V]
        joint = logp + beam_scores[:, None]
        # the reference warps PER BEAM ROW before the flat softmax, so the
        # joint's support is the union of per-beam nuclei
        if sparse:
            q_dist = joint_rowwarp_topk(logp, beam_scores, joint_cfg)
            u, keys = row_uniform(keys, topk_draw_width(q_dist, b))
            t = sample_k_topk_u(q_dist, u[0], b)  # [B] without replacement
            chosen_q = prob_of_topk(q_dist, t)
        else:
            q_dist = joint_rowwarp_dense(logp, beam_scores, joint_cfg)  # [B*V]
            u, keys = row_uniform(keys, q_dist.shape[0])
            t = sample_k_u(q_dist[None], u, b)[0]
            chosen_q = q_dist[t]
        parent = torch.div(t, vocab, rounding_mode="floor")
        next_tok = t % vocab
        beam_scores = torch.clamp(joint[parent, next_tok], min=_SCORE_CLAMP)

        if shared_prefix:
            select_rows_(cache, parent, start, gamma + 1)
        else:
            cache = select_rows(cache, parent)
        tail = tail[parent]
        tail[:, step] = next_tok
        seq_q = seq_q[parent]
        seq_q[:, step] = chosen_q
        perbeam = torch.softmax(logp, dim=-1)
        probs_buf = probs_buf[parent]
        probs_buf[:, step] = perbeam[parent]
        root = root[parent]
        parents.append(parent)
        toks.append(next_tok)
        chosen.append(chosen_q)
        joints.append(TopKDist(q_dist.idx[None], q_dist.probs[None]) if sparse else q_dist[None])
        roots.append(root)

    return BeamDraftResult(
        tail=tail, beam_scores=beam_scores, seq_q=seq_q, root=root,
        step_beam_idx=torch.stack(parents), step_next_tok=torch.stack(toks),
        step_chosen_q=torch.stack(chosen), step_joint_q=dist_concat(joints, axis=0),
        perbeam_probs=probs_buf, step_root=torch.stack(roots), cache=cache, key=keys,
        anchor_kv=anchor_kv, node_kv=node_kv,
    )


def top_width(result: BeamDraftResult, width: int):
    """Keep the ``width`` best final beams by joint score, with every
    per-path buffer re-selected consistently. Returns (tail [width, gamma],
    scores [width], seq_q [width, gamma], perbeam_probs [width, gamma, V],
    original row ids)."""
    scores, idx = torch.topk(result.beam_scores, width)
    return result.tail[idx], scores, result.seq_q[idx], result.perbeam_probs[idx], idx
