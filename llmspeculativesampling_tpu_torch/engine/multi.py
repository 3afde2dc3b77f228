"""Multi-candidate speculative sampling
(counterpart of ``llmspeculativesampling_tpu/engine/multi.py``).

The ``iid`` strategy runs here; ``beam`` and ``acc_beam`` delegate to the
beam-draft engine (``engine/beam_spec.py``), as in the JAX package.

The draft proposes ``width`` candidate continuations i.i.d. (the prefix
repeated ``width`` times in the batch, one counter stream a row); ONE
batched target forward verifies every candidate; each candidate scores its
leading run of accepted tokens (r < min(1, p/q)); the longest wins (the
first such index). The winner's batch row is re-broadcast into every cache
row; on a reject the next token is drawn from ``max_fn(p[choice, n] -
q[choice, n])``, on full acceptance from the target's bonus distribution.

As in JAX (``_multi_device``), the whole generation runs in the device loop
(``engine/device_loop.py``): the state lives in static buffers (both caches
at ``width`` rows with per-row device lengths), and one step
(:func:`_multi_step`: draft, verify, accept, a masked commit and the
re-broadcast) is a function of tensors only, captured once into a CUDA
graph on the card and replayed until the state says stop. The
re-broadcast copies only the window the step wrote (the draft's
``[cw-2, cw+gamma)``, the target's ``[cw-1, cw+gamma]``): below it every
row already holds the committed prefix, so each row equals JAX's full
row take at every position below its length.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import torch

from ..cache.kvcache import select_rows_
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import (
    SamplingConfig,
    TopKDist,
    dist_map,
    dist_pad_zero_rows,
    dist_prob_of,
    dist_residual,
    dist_sample_u,
    dist_take,
    dist_width,
    row_uniform,
)
from . import device_loop
from .beam_spec import multi_beam_generate
from .device_loop import WinnerState, commit_winner, winner_start, winner_state
from .phases import fill_phase_split
from .speculative import draft_phase_batched, verify_phase_batched
from .types import ModelBundle, aligned_total, pad_prompt


def _accept(gamma, q_stack, cand, p_stack, r, u_t):
    """Vectorized accept over width x gamma with accept uniforms ``r`` [w,
    gamma] and the next token's uniforms ``u_t`` (one draw's width).
    Returns (max_l, choice, t, rate_sum), device scalars: the winner's
    leading accepts, its row, the next token (residual resample, or bonus
    on full acceptance) and the sum of min(1, p/q) over all drafted tokens
    (q == 0 counts 0)."""
    q_sel = dist_prob_of(q_stack, cand)  # [w, gamma]
    p_sel = dist_prob_of(dist_map(lambda x: x[:, :gamma], p_stack), cand)
    ratio = torch.clamp(p_sel / q_sel, max=1.0)
    accept = r < ratio  # strict '<', as the reference's multi engine
    cur_l = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # [w]
    choice = torch.argmax(cur_l)  # the first longest
    max_l = dist_take(cur_l, choice)  # not cur_l[choice]: a 0-dim index is read on the host

    q_choice = dist_take(q_stack, choice)
    p_choice = dist_take(p_stack, choice)
    p_n = dist_take(p_choice, max_l)
    resid = dist_residual(p_n, dist_take(dist_pad_zero_rows(q_choice, 1), max_l))
    # a degenerate residual falls back to p (reference :1660-1664)
    if isinstance(resid, TopKDist):
        degenerate = resid.probs.sum() < 1e-6
        resid = TopKDist(torch.where(degenerate, p_n.idx, resid.idx),
                         torch.where(degenerate, p_n.probs, resid.probs))
    else:
        resid = torch.where(resid.sum() < 1e-6, p_n, resid)
    t_res = dist_sample_u(resid, u_t)
    t_bonus = dist_sample_u(dist_take(p_choice, gamma), u_t)
    t = torch.where(max_l == gamma, t_bonus, t_res)
    rate = torch.where(q_sel > 0, ratio, torch.zeros_like(ratio))
    return max_l, choice, t, rate.sum()


def _multi_step(bundle_d, params_d, bundle_t, params_t, scfg, gamma: int, width: int,
                eos_token_id: int, st: WinnerState) -> None:
    """One multi-candidate step on ``st``, in place (JAX ``_multi_device``'s
    body). The windows sit at ``cw = min(cur_len, total - 1)``; a finished
    state commits nothing (``device_loop.commit_winner``) while its forwards
    stay inside the buffers."""
    cur = st.cur_len.long()
    active = ~st.done & (cur < st.total)
    cw = torch.minimum(cur, st.total.long() - 1).reshape(1)
    rows_cw = cw.expand(width)
    tokens, _, q_stack, cand, keys = draft_phase_batched(
        bundle_d, params_d, scfg, gamma, st.tokens.expand(width, -1), rows_cw, st.draft_cache,
        st.key)
    p_stack, _ = verify_phase_batched(bundle_t, params_t, scfg, gamma, tokens, rows_cw,
                                      st.target_cache)
    r = st.fixed_r
    if r is None:
        r, keys = row_uniform(keys, gamma)
    u_t, keys = row_uniform(keys, dist_width(p_stack))
    max_l, choice, t, rate = _accept(gamma, q_stack, cand, p_stack, r, u_t[0])
    commit_winner(st, cur, cw[0], active, dist_take(cand, choice), max_l, t, rate, keys,
                  eos_token_id)
    # re-broadcast the winning row into every cache row (the written windows)
    sel = choice.expand(width)
    select_rows_(st.draft_cache, sel, cw - 2, gamma + 2)
    select_rows_(st.target_cache, sel, cw - 1, gamma + 2)


def multi_speculative_generate(
    bundle_d: ModelBundle,
    params_d,
    bundle_t: ModelBundle,
    params_t,
    prompt,
    max_new_tokens: int,
    *,
    gamma: int = 4,
    width: int = 4,
    strategy: str = "iid",
    num_beams: Optional[int] = None,
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
    """Multi-candidate speculative sampling. Returns numpy int32 [T]
    (prompt included, cut after the first generated EOS); with
    ``details=True`` also the reference-schema dict. ``strategy='iid'``
    runs here; 'beam' and 'acc_beam' delegate to the beam-draft engine
    (:func:`engine.beam_spec.multi_beam_generate`, ``num_beams`` defaulting
    to max(4, width)); 'diverse' raises as the reference does.
    ``random_seed`` reuses one fixed uniform for every accept test (the
    reference's reseed-before-every-draw quirk). ``tp_mesh``: see
    ``engine/speculative.py::speculative_generate``."""
    if strategy == "diverse":
        raise NotImplementedError("diverse strategy (reference :1510)")
    if strategy in ("beam", "acc_beam"):
        return multi_beam_generate(
            bundle_d, params_d, bundle_t, params_t, prompt, max_new_tokens,
            gamma=gamma, width=width, num_beams=num_beams,
            eos_token_id=eos_token_id, temperature=temperature, top_k=top_k, top_p=top_p,
            generator=generator, random_seed=random_seed, details=details, tp_mesh=tp_mesh,
            device=device,
        )
    if strategy != "iid":
        raise RuntimeError("Strategy not implemented " + strategy)
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle_d, bundle_t = bundle_d.for_params(params_d), bundle_t.for_params(params_t)
    pd, pt = unstack_layers(params_d), unstack_layers(params_t)
    prompt_padded, p_len = pad_prompt(prompt)
    if p_len < 2:
        raise ValueError("prompt must have at least 2 tokens")
    p_bucket = prompt_padded.shape[1]
    max_total = aligned_total(p_bucket + max_new_tokens + gamma + 1)
    total = p_len + max_new_tokens
    for bundle in (bundle_d, bundle_t):
        device_loop.check_positions(bundle, max(p_bucket, total + gamma - 1))
    fixed_r = None
    if random_seed is not None:
        g0 = torch.Generator().manual_seed(int(random_seed))
        fixed_r = torch.rand((), generator=g0).expand(width, gamma)
    key = device_loop.stream_key(gen, dev, rows=width)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    st = device_loop.run(
        ("multi", bundle_d, bundle_t, gamma, width, max_total, max_new_tokens, scfg, eos_token_id,
         fixed_r is not None),
        (params_d, params_t),
        functools.partial(winner_state, bundle_d, bundle_t, width, width, gamma, width, max_total,
                          max_new_tokens, fixed_r is not None, dev),
        functools.partial(winner_start, bundle_d, pd, bundle_t, pt, prompt_t, p_len, total, key,
                          fixed_r, tp_mesh),
        functools.partial(_multi_step, bundle_d, pd, bundle_t, pt, scfg, gamma, width,
                          eos_token_id),
        max_new_tokens, replay=dev.type == "cuda" and tp_mesh is None)
    out, steps, accepted, acc_len, rate_total = device_loop.winner_result(st, p_len, eos_token_id)
    wall = time.perf_counter() - t0
    if not details:
        return out
    d = {
        "total_time": wall,
        "acc_len": acc_len,
        "accepted_count": accepted,
        "acc_rate": rate_total / max(steps * width * gamma, 1),
        "target_call_times": steps,
        "approx_call_times": steps,
        "tokens_generated": len(out) - p_len,
        "tokens_per_s": (len(out) - p_len) / wall if wall > 0 else float("nan"),
    }
    fill_phase_split(
        d, wall, steps, bundle_d, pd, bundle_t, pt,
        draft_rows=width, verify_rows=width, gamma=gamma, verify_tokens=gamma + 1,
        max_total=max_total, device=dev,
    )
    return out, d
