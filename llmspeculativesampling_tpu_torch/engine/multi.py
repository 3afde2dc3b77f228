"""Multi-candidate speculative sampling
(counterpart of ``llmspeculativesampling_tpu/engine/multi.py``).

The ``iid`` strategy runs here; ``beam`` and ``acc_beam`` delegate to the
beam-draft engine (``engine/beam_spec.py``), as in the JAX package.

The draft proposes ``width`` candidate continuations i.i.d. (the prefix
repeated ``width`` times in the batch); ONE batched target forward verifies
every candidate; each candidate scores its leading run of accepted tokens
(r < min(1, p/q)); the longest wins (the first such index). The winner's
batch row is re-broadcast into every cache row; on a reject the next token
is drawn from ``max_fn(p[choice, n] - q[choice, n])``, on full acceptance
from the target's bonus distribution.

Both caches hold ``width`` rows for the whole run. The JAX engine's
``lax.while_loop`` is a host loop here, with fixed shapes within a step
(``width`` draft rows; ``width`` x (gamma+1) verify tokens) and ONE host
read a step: the winner's accept count, its tokens and the next token.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..cache.kvcache import rollback, select_rows
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import (
    SamplingConfig,
    TopKDist,
    dist_map,
    dist_norm,
    dist_pad_zero_rows,
    dist_prob_of,
    dist_residual,
    dist_sample,
    dist_take,
    sample,
)
from .beam_spec import multi_beam_generate
from .phases import fill_phase_split
from .types import ModelBundle, aligned_total, first_eos_truncate, pad_prompt


def _draft_candidates(bundle, params, scfg, gamma, width, tokens, cur_len, cache, generator):
    """``width`` iid gamma-token drafts from the committed prefix. Returns
    (q_stack [w, gamma, ...], cand [w, gamma], cache)."""
    cache = rollback(cache, cur_len - 2)
    first_in = tokens[:, cur_len - 2:cur_len].expand(width, 2)
    logits, cache = bundle.forward(params, bundle.cfg, first_in, cache)
    q = dist_norm(logits[:, -1], scfg)  # [w, ...]
    x = dist_sample(generator, q)  # [w]
    qs, xs = [q], [x]
    for _ in range(gamma - 1):
        logits, cache = bundle.forward(params, bundle.cfg, x[:, None], cache)
        q = dist_norm(logits[:, 0], scfg)
        x = dist_sample(generator, q)
        qs.append(q)
        xs.append(x)
    if isinstance(qs[0], TopKDist):
        q_stack = TopKDist(torch.stack([d.idx for d in qs], 1), torch.stack([d.probs for d in qs], 1))
    else:
        q_stack = torch.stack(qs, 1)
    return q_stack, torch.stack(xs, 1), cache


def _accept(scfg, gamma, q_stack, cand, p_stack, generator, fixed_r):
    """Vectorized accept over width x gamma. Returns (max_l, choice, t,
    rate_sum), device scalars: the winner's leading accepts, its row, the
    next token (residual resample, or bonus on full acceptance) and the
    sum of min(1, p/q) over all drafted tokens (q == 0 counts 0)."""
    del scfg
    w = cand.shape[0]
    dev = cand.device
    q_sel = dist_prob_of(q_stack, cand)  # [w, gamma]
    p_sel = dist_prob_of(dist_map(lambda x: x[:, :gamma], p_stack), cand)
    ratio = torch.clamp(p_sel / q_sel, max=1.0)
    r = fixed_r if fixed_r is not None else torch.rand((w, gamma), generator=generator, device=dev)
    accept = r < ratio  # strict '<', as the reference's multi engine
    cur_l = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # [w]
    choice = torch.argmax(cur_l)  # the first longest
    max_l = cur_l[choice]

    q_choice = dist_take(q_stack, choice)
    p_choice = dist_take(p_stack, choice)
    p_n = dist_take(p_choice, max_l)
    q_l = dist_take(dist_pad_zero_rows(q_choice, 1), max_l)
    resid = dist_residual(p_n, q_l)
    # a degenerate residual falls back to p (reference :1660-1664)
    if isinstance(resid, TopKDist):
        degenerate = resid.probs.sum() < 1e-6
        resid = TopKDist(torch.where(degenerate, p_n.idx, resid.idx),
                         torch.where(degenerate, p_n.probs, resid.probs))
        t_res = dist_sample(generator, resid)
        t_bonus = dist_sample(generator, dist_take(p_choice, gamma))
    else:
        resid = torch.where(resid.sum() < 1e-6, p_n, resid)
        t_res = sample(generator, resid[None])[0]
        t_bonus = sample(generator, p_choice[gamma][None])[0]
    t = torch.where(max_l == gamma, t_bonus, t_res)
    rate = torch.where(q_sel > 0, ratio, torch.zeros_like(ratio))
    return max_l, choice, t, rate.sum()


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
    device=None,
):
    """Multi-candidate speculative sampling. Returns numpy int32 [T]
    (prompt included, cut after the first generated EOS); with
    ``details=True`` also the reference-schema dict. ``strategy='iid'``
    runs here; 'beam' and 'acc_beam' delegate to the beam-draft engine
    (:func:`engine.beam_spec.multi_beam_generate`, ``num_beams`` defaulting
    to max(4, width)); 'diverse' raises as the reference does.
    ``random_seed`` reuses one fixed uniform for every accept test (the
    reference's reseed-before-every-draw quirk)."""
    if strategy == "diverse":
        raise NotImplementedError("diverse strategy (reference :1510)")
    if strategy in ("beam", "acc_beam"):
        return multi_beam_generate(
            bundle_d, params_d, bundle_t, params_t, prompt, max_new_tokens,
            gamma=gamma, width=width, num_beams=num_beams,
            eos_token_id=eos_token_id, temperature=temperature, top_k=top_k, top_p=top_p,
            generator=generator, random_seed=random_seed, details=details, device=device,
        )
    if strategy != "iid":
        raise RuntimeError("Strategy not implemented " + strategy)
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    params_d, params_t = unstack_layers(params_d), unstack_layers(params_t)
    prompt_padded, p_len = pad_prompt(prompt)
    if p_len < 2:
        raise ValueError("prompt must have at least 2 tokens")
    max_total = aligned_total(prompt_padded.shape[1] + max_new_tokens + gamma + 1)
    fixed_r = None
    if random_seed is not None:
        g0 = torch.Generator().manual_seed(int(random_seed))
        fixed_r = torch.rand((), generator=g0).expand(width, gamma).to(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    draft_cache = bundle_d.make_cache(width, max_total, device=dev)
    target_cache = bundle_t.make_cache(width, max_total, device=dev)
    tokens = torch.zeros((1, max_total), dtype=torch.long, device=dev)
    host = np.zeros(max_total, np.int64)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)
    tokens[:, :prompt_t.shape[1]] = prompt_t
    host[:prompt_padded.shape[1]] = prompt_padded[0]
    rep = prompt_t.expand(width, prompt_t.shape[1])
    _, draft_cache = bundle_d.forward(params_d, bundle_d.cfg, rep, draft_cache)
    _, target_cache = bundle_t.forward(params_t, bundle_t.cfg, rep, target_cache)

    total = p_len + max_new_tokens
    cur_len = p_len
    acc_len = []
    rate_sum = torch.zeros((), dtype=torch.float32, device=dev)
    while cur_len < total:
        q_stack, cand, draft_cache = _draft_candidates(
            bundle_d, params_d, scfg, gamma, width, tokens, cur_len, draft_cache, gen)
        target_cache = rollback(target_cache, cur_len - 1)
        vin = torch.cat([tokens[:, cur_len - 1:cur_len].expand(width, 1), cand], dim=1)
        logits, target_cache = bundle_t.forward(params_t, bundle_t.cfg, vin, target_cache)
        p_stack = dist_norm(logits, scfg)  # [w, gamma+1, ...]
        max_l, choice, t, rate = _accept(scfg, gamma, q_stack, cand, p_stack, gen, fixed_r)
        rate_sum += rate
        win = cand[choice]  # [gamma]
        tokens[0, cur_len:cur_len + gamma] = win
        tokens[0].scatter_(0, (cur_len + max_l).reshape(1), t.reshape(1))
        # re-broadcast the winning row into every cache row
        sel = choice.expand(width)
        draft_cache = select_rows(draft_cache, sel)
        target_cache = select_rows(target_cache, sel)
        # the one host read of the step: accept count, next token, winner
        h = torch.cat([max_l.reshape(1), t.reshape(1), win]).tolist()
        n_acc = int(h[0])
        window = h[2:2 + n_acc] + [h[1]]
        host[cur_len:cur_len + n_acc + 1] = window
        acc_len.append(n_acc)
        cur_len += n_acc + 1
        if eos_token_id in window:
            break
    rate_total = float(rate_sum)
    wall = time.perf_counter() - t0
    out = first_eos_truncate(host, p_len, cur_len, eos_token_id).astype("int32")
    if not details:
        return out
    steps = len(acc_len)
    d = {
        "total_time": wall,
        "acc_len": acc_len,
        "accepted_count": sum(acc_len),
        "acc_rate": rate_total / max(steps * width * gamma, 1),
        "target_call_times": steps,
        "approx_call_times": steps,
        "tokens_generated": len(out) - p_len,
        "tokens_per_s": (len(out) - p_len) / wall if wall > 0 else float("nan"),
    }
    fill_phase_split(
        d, wall, steps, bundle_d, params_d, bundle_t, params_t,
        draft_rows=width, verify_rows=width, gamma=gamma, verify_tokens=gamma + 1,
        max_total=max_total, device=dev,
    )
    return out, d
