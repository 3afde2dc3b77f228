"""Big-Little Decoder (BiLD) policy
(counterpart of ``llmspeculativesampling_tpu/engine/bild.py``).

The small model decodes one token a step until its largest token
probability drops below ``fallback_thres`` or ``gamma`` unchecked tokens
have piled up; then ONE target forward scores every unchecked token, the
first position whose target NLL exceeds ``rollback_thres`` rolls the
sequence back, and the target samples the next token from its own
distribution there.

The check re-processes a fixed window of gamma+1 tokens ending at the
newest token (an idempotent k/v rewrite; positions before the last check
are masked out of the NLL test), so its shape never depends on how many
tokens are unchecked.

As in JAX (``_bild_device``) the whole generation runs in the device loop
(``engine/device_loop.py``), its state in static buffers (:class:`BildState`)
and every draw from one counter stream. JAX's body is one small-model
decode with the check under ``lax.cond``; a replayed graph cannot skip a
branch, so one step here (:func:`_bild_step`) is a macro-step that ends in
the check: gamma decodes, each live only while the state runs and no check
is pending, then the check, live only when one is pending. Right after a
check the unchecked count is 0 and each decode adds one, so a check falls
due within gamma decodes: a step does the work of JAX's iterations up to
and including the next check, in the same order. A masked decode re-feeds
the last committed token at its own position (the same k/v, bit for bit)
and writes nothing else.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import torch

from ..cache.kvcache import kv_buffers, rollback_rows
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import (SamplingConfig, TopKDist, dist_norm, dist_prob_of, dist_sample_u,
                            dist_take, dist_width, row_uniform)
from . import device_loop
from .device_loop import scalar, scatter_where_
from .phases import calibrate_phase_times
from .speculative import rows_window
from .types import ModelBundle, aligned_total, first_eos_truncate, pad_prompt


@dataclasses.dataclass
class BildState:
    """A BiLD generation on the device (the carry of JAX's ``_bild_device``
    loop, with ``pending``: a decoded token whose check is due)."""

    tokens: torch.Tensor        # [1, T] int64
    cur_len: torch.Tensor       # [] int32: committed positions (the pending token not counted)
    total: torch.Tensor         # [] int32: prompt length + max_new_tokens
    draft_cache: object         # 1 row, device lengths
    target_cache: object        # 1 row, device lengths
    key: torch.Tensor           # [1, 2] the counter stream every draw comes from
    done: torch.Tensor          # [] bool: EOS among the committed tokens
    pending: torch.Tensor       # [] bool: tokens[cur_len] was decoded and awaits its check
    last_check: torch.Tensor    # [] int32: the first position the next check tests
    acc_sum: torch.Tensor       # [] int32: unchecked tokens accepted by the checks
    check_cnt: torch.Tensor     # [] int32: target checks
    small_cnt: torch.Tensor     # [] int32: small-model decodes (the live ones)
    hist: torch.Tensor          # [max_new_tokens + 1] int32: accepted tokens a check
    stop: torch.Tensor          # [] bool: JAX's cond negated (cur_len >= total, or done)


def check_window(p_win, tokens, start, last_check, new_len, rollback_thres: float):
    """The NLL test of one check. ``p_win`` [w, ...] are the target's
    distributions for positions start+1 .. start+w; the test covers the
    positions i in [last_check, new_len-2], each scoring token i+1. Returns
    (n, row): the rollback point n (the first bad position, or new_len-1
    when none is bad) and its row n - start in ``p_win``, device scalars
    like ``start``, ``last_check`` and ``new_len``."""
    dev = tokens.device
    w = (p_win.probs if isinstance(p_win, TopKDist) else p_win).shape[0]
    pos_i = start + torch.arange(w, device=dev)
    next_tok = tokens[0, (pos_i + 1).clamp(0, tokens.shape[1] - 1)]
    p_next = dist_prob_of(p_win, next_tok)
    in_range = (pos_i >= last_check) & (pos_i <= new_len - 2)
    bad = in_range & (-torch.log(p_next + 1e-30) > rollback_thres)
    first_bad = torch.argmax(bad.int())  # the first bad row (0 when none is)
    n = torch.where(bad.any(), start + first_bad, new_len - 1)
    return n, (n - start).clamp(0, w - 1)


def _bild_state(bundle_d, bundle_t, max_total: int, max_new: int, device) -> BildState:
    """A zeroed :class:`BildState` of ``max_total`` positions."""
    i32 = torch.int32

    def cache(bundle):
        c = bundle.make_cache(1, max_total, device=device)
        return dataclasses.replace(c, lengths=torch.zeros((1,), dtype=i32, device=device))

    return BildState(
        tokens=torch.zeros((1, max_total), dtype=torch.long, device=device),
        cur_len=scalar(0, i32, device), total=scalar(0, i32, device),
        draft_cache=cache(bundle_d), target_cache=cache(bundle_t),
        key=torch.zeros((1, 2), dtype=torch.long, device=device),
        done=scalar(False, torch.bool, device), pending=scalar(False, torch.bool, device),
        last_check=scalar(0, i32, device), acc_sum=scalar(0, i32, device),
        check_cnt=scalar(0, i32, device), small_cnt=scalar(0, i32, device),
        hist=torch.zeros((max_new + 1,), dtype=i32, device=device),
        stop=scalar(False, torch.bool, device),
    )


def _bild_start(bundle_d, params_d, bundle_t, params_t, prompt_t, p_len: int, total: int, key,
                tp_mesh, st: BildState) -> None:
    """Reset ``st`` and prefill the padded prompt ``prompt_t`` [1, P] into
    both caches (eager: the bucket varies). A check that keeps every token
    leaves the draft's k/v of the last small token unwritten, and the next
    decode attends to that position as it stands, as JAX's does on the
    fresh cache of each call: the draft cache is zeroed, so a reused state
    holds what a fresh one would."""
    st.tokens.zero_()
    st.tokens[:, :prompt_t.shape[1]] = prompt_t
    for buf in kv_buffers(st.draft_cache):
        buf.zero_()
    for bundle, params, cache in ((bundle_d, params_d, st.draft_cache),
                                  (bundle_t, params_t, st.target_cache)):
        cache.lengths.zero_()
        bundle.forward(params, bundle.cfg, prompt_t, cache, tp_mesh=tp_mesh)
        cache.lengths.fill_(p_len)
    st.cur_len.fill_(p_len)
    st.total.fill_(total)
    st.key.copy_(key)
    st.last_check.fill_(p_len - 1)
    for t in (st.done, st.pending, st.acc_sum, st.check_cnt, st.small_cnt, st.hist):
        t.zero_()
    st.stop.copy_(device_loop.finished(st))


def _decode(bundle_d, params_d, scfg, gamma: int, fallback_thres: float, eos_token_id: int,
            st: BildState) -> None:
    """One small-model decode (JAX's body up to ``need_check``), live while
    the state runs and no check is pending. A decode that needs no check
    commits its token; one that does leaves it pending. The forward sits at
    ``cw = min(cur_len, total - 1)``: a masked one re-feeds the last
    committed token at its own position."""
    live = ~st.stop & ~st.pending
    cur = st.cur_len.long()
    cw = torch.minimum(cur, st.total.long() - 1).reshape(1)
    logits, _ = bundle_d.forward(params_d, bundle_d.cfg, rows_window(st.tokens, cw - 1, 1),
                                 rollback_rows(st.draft_cache, cw - 1), tp_mesh=scfg.tp_mesh)
    q = dist_norm(logits[:, 0], scfg)
    u, key = row_uniform(st.key, dist_width(q))
    x = dist_sample_u(q, u)  # [1]
    scatter_where_(st.tokens[0], cw, x, live)
    q_max = (q.probs if isinstance(q, TopKDist) else q).max()
    new_len = cur + 1
    need = (q_max < fallback_thres) | (new_len - st.last_check.long() - 1 >= gamma)
    commit = live & ~need
    st.pending.copy_(st.pending | (live & need))
    st.small_cnt.add_(live.to(torch.int32))
    st.key.copy_(torch.where(live, key, st.key))
    st.cur_len.copy_(torch.where(commit, new_len, cur))
    st.done.copy_(st.done | (commit & (x[0] == eos_token_id)))
    st.stop.copy_(device_loop.finished(st))


def _check(bundle_t, params_t, scfg, gamma: int, rollback_thres: float, eos_token_id: int,
           st: BildState) -> None:
    """The target check of the pending token (JAX's ``do_check``), live only
    when one is pending: the window forward, the NLL test, the target's
    token at the rollback point, the EOS test over the committed tokens."""
    w = gamma + 1
    live = st.pending & ~st.stop
    cur = st.cur_len.long()
    new_len = torch.minimum(cur, st.total.long() - 1) + 1
    start = (new_len - w).clamp(min=0)
    logits, _ = bundle_t.forward(params_t, bundle_t.cfg,
                                 rows_window(st.tokens, start.reshape(1), w),
                                 rollback_rows(st.target_cache, start.reshape(1)),
                                 tp_mesh=scfg.tp_mesh)
    p_win = dist_norm(logits[0], scfg)
    last_check = st.last_check.long()
    n, row = check_window(p_win, st.tokens, start, last_check, new_len, rollback_thres)
    u, key = row_uniform(st.key, dist_width(p_win))
    t = dist_sample_u(dist_take(p_win, row.reshape(1)), u)  # the target's own token at n+1
    scatter_where_(st.tokens[0], (n + 1).reshape(1), t, live)
    # EOS among the committed tokens [cur_len, n + 2) (empty after a rollback)
    pos = torch.arange(st.tokens.shape[1], device=cur.device)
    eos_now = ((pos >= cur) & (pos < n + 2) & (st.tokens[0] == eos_token_id)).any()
    col = st.check_cnt.long().clamp(max=st.hist.shape[0] - 1).reshape(1)
    scatter_where_(st.hist, col, (n - last_check).reshape(1), live)
    st.check_cnt.add_(live.to(torch.int32))
    st.acc_sum.add_(torch.where(live, n - last_check, 0).to(torch.int32))
    st.last_check.copy_(torch.where(live, n + 1, last_check))
    st.target_cache.lengths.copy_(torch.where(live, n + 1, st.target_cache.lengths.long()))
    st.cur_len.copy_(torch.where(live, n + 2, cur))
    st.done.copy_(st.done | (live & eos_now))
    st.key.copy_(torch.where(live, key, st.key))
    st.pending.copy_(st.pending & ~live)
    st.stop.copy_(device_loop.finished(st))


def _bild_step(bundle_d, params_d, bundle_t, params_t, scfg, gamma: int, fallback_thres: float,
               rollback_thres: float, eos_token_id: int, st: BildState) -> None:
    """One macro-step on ``st``, in place: gamma small-model decodes, then
    the check they made due. No host read; a no-op on a finished state."""
    for _ in range(gamma):
        _decode(bundle_d, params_d, scfg, gamma, fallback_thres, eos_token_id, st)
    _check(bundle_t, params_t, scfg, gamma, rollback_thres, eos_token_id, st)


def bild_generate(
    bundle_d: ModelBundle,
    params_d,
    bundle_t: ModelBundle,
    params_t,
    prompt,
    max_new_tokens: int,
    *,
    gamma: int = 10,
    fallback_thres: float = 0.6,
    rollback_thres: float = 5.0,
    eos_token_id: int,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    random_seed: Optional[int] = None,
    details: bool = False,
    tp_mesh=None,
    device=None,
):
    """BiLD policy decode (the reference's ``BiLD_sampling``). Returns
    numpy int32 [T] (prompt included, cut after the first generated EOS);
    with ``details=True`` also the reference-schema dict.

    ``random_seed`` is accepted for signature parity: the reference never
    consumes it in BiLD, whose policy is threshold-driven. ``tp_mesh``: see
    ``engine/speculative.py::speculative_generate``."""
    del random_seed
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle_d, bundle_t = bundle_d.for_params(params_d), bundle_t.for_params(params_t)
    pd, pt = unstack_layers(params_d), unstack_layers(params_t)
    prompt_padded, p_len = pad_prompt(prompt)
    p_bucket = prompt_padded.shape[1]
    max_total = aligned_total(p_bucket + max_new_tokens + 2)
    total = p_len + max_new_tokens
    for bundle in (bundle_d, bundle_t):
        device_loop.check_positions(bundle, max(p_bucket, total))
    fallback_thres, rollback_thres = float(fallback_thres), float(rollback_thres)
    key = device_loop.stream_key(gen, dev)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    # every macro-step commits at least one token: max_new_tokens bound them
    st = device_loop.run(
        ("bild", bundle_d, bundle_t, gamma, fallback_thres, rollback_thres, max_total,
         max_new_tokens, scfg, eos_token_id),
        (params_d, params_t),
        functools.partial(_bild_state, bundle_d, bundle_t, max_total, max_new_tokens, dev),
        functools.partial(_bild_start, bundle_d, pd, bundle_t, pt, prompt_t, p_len, total, key,
                          tp_mesh),
        functools.partial(_bild_step, bundle_d, pd, bundle_t, pt, scfg, gamma, fallback_thres,
                          rollback_thres, eos_token_id),
        max_new_tokens, replay=dev.type == "cuda" and tp_mesh is None)
    tokens = st.tokens.cpu().numpy()
    cur_len, checks, small_cnt, acc_sum = torch.stack(
        [st.cur_len, st.check_cnt, st.small_cnt, st.acc_sum]).tolist()
    out = first_eos_truncate(tokens, p_len, cur_len, eos_token_id).astype("int32")
    wall = time.perf_counter() - t0
    if not details:
        return out
    d = {
        "total_time": wall,
        # the reference declares acc_rate for BiLD but never appends to it,
        # so it reports the mean of an empty list: NaN, kept for the schema
        "acc_rate": float("nan"),
        "acc_len": st.hist[:checks].tolist(),
        "accepted_count": acc_sum,
        "target_call_times": checks,
        "approx_call_times": small_cnt,
        "tokens_generated": len(out) - p_len,
        "tokens_per_s": (len(out) - p_len) / wall if wall > 0 else float("nan"),
    }
    # approx phase = small_cnt single-token forwards; target phase = checks
    # window forwards of gamma+1 tokens
    t_draft, t_verify = calibrate_phase_times(
        bundle_d, pd, bundle_t, pt,
        draft_rows=1, verify_rows=1, gamma=1, verify_tokens=gamma + 1, max_total=max_total,
        device=dev,
    )
    approx, target = small_cnt * t_draft, checks * t_verify
    if approx + target > wall > 0:
        scale = wall / (approx + target)
        approx, target = approx * scale, target * scale
    d.update(approx_time=approx, target_time=target, other_time=max(wall - approx - target, 0.0),
             target_model_time=target, target_pre_cache_time=0.0, target_post_prob_time=0.0,
             phase_split_method="calibrated")
    return out, d
