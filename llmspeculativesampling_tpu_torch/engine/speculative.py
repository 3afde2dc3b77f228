"""Speculative sampling
(counterpart of ``llmspeculativesampling_tpu/engine/speculative.py``).

Draft gamma tokens with the small model, verify them with ONE target
forward over gamma+1 tokens, accept draft i iff r_i <= p_i(x_i)/q_i(x_i),
resample ``max_fn(p - q)`` at the first reject or take a bonus target
sample when all are accepted; EOS truncation and the same ``details``
schema as the JAX engine.

"Rollback" moves no data: each step re-derives both caches' lengths from
``cur_len`` (draft: cur_len-2, target: cur_len-1) and rewrites the last
positions in place (k/v of a position depend only on tokens at positions
<= it, which are final).

The JAX engine runs the whole generation as one device program. Here the
outer loop runs on the host and reads the device once per speculative step
(the accept count and the committed window, for ``cur_len`` and EOS);
keeping the count on the device and capturing the step in a CUDA graph is
later work.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..cache.kvcache import rollback
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import (
    SamplingConfig,
    dist_concat,
    dist_map,
    dist_norm,
    dist_pad_zero_rows,
    dist_prob_of,
    dist_residual,
    dist_sample,
    dist_sample_u,
    dist_take,
)
from .phases import fill_phase_split
from .types import ModelBundle, aligned_total, first_eos_truncate, pad_prompt


def draft_phase(bundle, params, scfg, gamma, tokens, cur_len: int, cache, generator):
    """gamma-token draft. Writes the drafts into ``tokens`` [1, T_max] (in
    place) at [cur_len, cur_len+gamma) and returns (tokens, cache, q_stack
    [gamma, ...], drafts [gamma]).

    The first forward re-feeds positions cur_len-2, cur_len-1 so the cache
    rollback is only the length reset; the remaining gamma-1 steps are
    single-token forwards."""
    cfg = bundle.cfg
    cache = rollback(cache, cur_len - 2)
    logits, cache = bundle.forward(params, cfg, tokens[:, cur_len - 2:cur_len], cache,
                                   tp_mesh=scfg.tp_mesh)
    q = dist_norm(logits[:, -1], scfg)
    x = dist_sample(generator, q)  # [1]
    qs, xs = [q], [x]
    for _ in range(gamma - 1):
        logits, cache = bundle.forward(params, cfg, x[:, None], cache, tp_mesh=scfg.tp_mesh)
        q = dist_norm(logits[:, 0], scfg)
        x = dist_sample(generator, q)
        qs.append(q)
        xs.append(x)
    drafts = torch.cat(xs)
    tokens[0, cur_len:cur_len + gamma] = drafts
    return tokens, cache, dist_concat(qs, axis=0), drafts


def verify_phase(bundle, params, scfg, gamma, tokens, cur_len: int, cache):
    """One target forward over the gamma+1 tail tokens -> (p_stack [g+1, ...], cache)."""
    cache = rollback(cache, cur_len - 1)
    logits, cache = bundle.forward(params, bundle.cfg, tokens[:, cur_len - 1:cur_len + gamma], cache,
                                   tp_mesh=scfg.tp_mesh)
    return dist_norm(logits[0], scfg), cache


def accept_phase(scfg, gamma, eos_token_id, tokens, cur_len, q_stack, drafts, p_stack,
                 generator, fixed_r=None):
    """Vectorized accept/resample. Returns (tokens, new_len, t, n, all_acc,
    acc_rate_step), all but ``tokens`` as device scalars; ``t`` is written
    into ``tokens`` at new_len-1 (in place). ``fixed_r`` [gamma] replaces
    the accept uniforms."""
    del scfg, eos_token_id
    dev = drafts.device
    q_sel = dist_prob_of(q_stack, drafts)
    p_sel = dist_prob_of(dist_take(p_stack, torch.arange(gamma, device=dev)), drafts)
    ratio = p_sel / q_sel
    if fixed_r is not None:
        r = torch.as_tensor(fixed_r, dtype=torch.float32, device=dev)
    else:
        r = torch.rand((gamma,), generator=generator, device=dev)
    accept = r <= ratio
    n = torch.cumprod(accept.long(), dim=0).sum()  # leading accepts, 0..gamma

    p_n = dist_take(p_stack, n)
    q_n = dist_take(dist_pad_zero_rows(q_stack, 1), n)
    t_resample = dist_sample(generator, dist_residual(p_n, q_n))
    t_bonus = dist_sample(generator, dist_take(p_stack, gamma))
    all_acc = n == gamma
    t = torch.where(all_acc, t_bonus, t_resample)

    new_len = cur_len + n + 1
    tokens[0].scatter_(0, (new_len - 1).reshape(1), t.reshape(1).to(tokens.dtype))
    acc_rate_step = torch.clamp(ratio, max=1.0).sum()
    return tokens, new_len, t, n, all_acc, acc_rate_step


def _take_rows(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x [B, R, ...] -> x[b, n[b]] [B, ...]."""
    idx = n.reshape(-1, 1, *([1] * (x.dim() - 2))).expand(x.shape[0], 1, *x.shape[2:])
    return torch.gather(x, 1, idx)[:, 0]


def accept_phase_rows(gamma, tokens, cur_len, q_stack, drafts, p_stack, r, u_t):
    """:func:`accept_phase` for B independent rows at once (the JAX paged
    engine vmaps ``accept_phase`` over rows). ``q_stack`` [B, gamma, ...],
    ``drafts`` [B, gamma], ``p_stack`` [B, gamma+1, ...], per-row
    ``cur_len`` [B]; ``r`` [B, gamma] are the accept uniforms and ``u_t``
    the uniforms of the resample/bonus draw (one draw's width per row).
    Writes each row's token ``t`` into ``tokens`` [B, T] at new_len-1 (in
    place, clamped into the buffer) and returns (tokens, new_len, t, n,
    all_acc, acc_rate_step), each [B] on the device."""
    q_sel = dist_prob_of(q_stack, drafts)
    p_sel = dist_prob_of(dist_map(lambda x: x[:, :gamma], p_stack), drafts)
    ratio = p_sel / q_sel
    accept = r <= ratio
    n = torch.cumprod(accept.long(), dim=1).sum(dim=1)  # leading accepts, 0..gamma

    p_n = dist_map(lambda x: _take_rows(x, n), p_stack)
    q_n = dist_map(lambda x: _take_rows(x, n), dist_pad_zero_rows(q_stack, 1, axis=1))
    t_resample = dist_sample_u(dist_residual(p_n, q_n), u_t)
    t_bonus = dist_sample_u(dist_map(lambda x: x[:, gamma], p_stack), u_t)
    all_acc = n == gamma
    t = torch.where(all_acc, t_bonus, t_resample)

    new_len = cur_len + n + 1
    col = (new_len - 1).clamp(0, tokens.shape[1] - 1)
    tokens.scatter_(1, col[:, None], t[:, None].to(tokens.dtype))
    acc_rate_step = torch.clamp(ratio, max=1.0).sum(dim=1)
    return tokens, new_len, t, n, all_acc, acc_rate_step


def speculative_generate(
    bundle_d: ModelBundle,
    params_d,
    bundle_t: ModelBundle,
    params_t,
    prompt,
    max_new_tokens: int,
    *,
    gamma: int = 4,
    eos_token_id: int,
    pad_token_id: Optional[int] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    random_seed: Optional[int] = None,
    details: bool = False,
    stepwise: bool = False,
    verbose: bool = False,
    tp_mesh=None,
    device=None,
):
    """Speculative sampling with KV rollback. Returns numpy int32 [T]
    (prompt included, cut after the first generated EOS); with
    ``details=True`` also the reference-schema dict.

    ``stepwise=True`` times each phase with a device synchronize and fills
    the measured approx/target/other split; otherwise the split is
    calibrated (engine/phases.py). ``verbose`` prints the per-token stream
    and implies ``stepwise``. ``random_seed`` reuses one fixed uniform for
    every accept test (the reference's reseed-before-every-draw quirk).

    Params sharded over a tensor-parallel mesh (``parallel/sharding.py``)
    run on every rank of it, each with a generator made from the same
    seed; ``tp_mesh`` (that mesh) samples from vocab-sharded logits
    (``ops/sampling.py::norm_logits_topk_tp``) instead of gathered ones,
    with the same result."""
    del pad_token_id
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle_d, bundle_t = bundle_d.for_params(params_d), bundle_t.for_params(params_t)
    params_d, params_t = unstack_layers(params_d), unstack_layers(params_t)
    prompt_padded, p_len = pad_prompt(prompt)
    if p_len < 2:
        raise ValueError("prompt must have at least 2 tokens")
    max_total = aligned_total(prompt_padded.shape[1] + max_new_tokens + gamma + 1)
    stepwise = stepwise or verbose
    fixed_r = None
    if random_seed is not None:
        g0 = torch.Generator().manual_seed(int(random_seed))
        fixed_r = torch.rand((), generator=g0).expand(gamma).to(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    draft_cache = bundle_d.make_cache(1, max_total, device=dev)
    target_cache = bundle_t.make_cache(1, max_total, device=dev)
    tokens = torch.zeros((1, max_total), dtype=torch.long, device=dev)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)
    tokens[:, : prompt_t.shape[1]] = prompt_t
    _, draft_cache = bundle_d.forward(params_d, bundle_d.cfg, prompt_t, draft_cache, tp_mesh=tp_mesh)
    _, target_cache = bundle_t.forward(params_t, bundle_t.cfg, prompt_t, target_cache,
                                       tp_mesh=tp_mesh)

    total = p_len + max_new_tokens
    cur_len = p_len
    acc_len, steps = [], 0
    acc_rate_sum = torch.zeros((), dtype=torch.float32, device=dev)
    approx_t = target_t = 0.0
    while cur_len < total:
        ta = time.perf_counter()
        tokens, draft_cache, q_stack, drafts = draft_phase(
            bundle_d, params_d, scfg, gamma, tokens, cur_len, draft_cache, gen)
        if stepwise:
            synchronize(dev)
        tb = time.perf_counter()
        p_stack, target_cache = verify_phase(
            bundle_t, params_t, scfg, gamma, tokens, cur_len, target_cache)
        if stepwise:
            synchronize(dev)
        tc = time.perf_counter()
        tokens, _, _, n, _, acc_step = accept_phase(
            scfg, gamma, eos_token_id, tokens, cur_len, q_stack, drafts, p_stack, gen, fixed_r)
        acc_rate_sum += acc_step
        # the one host read of the step: accept count + committed window
        host = torch.cat([n.reshape(1), tokens[0, cur_len:cur_len + gamma + 1]]).tolist()
        n_acc = int(host[0])
        window = host[1:n_acc + 2]  # accepted drafts + the resampled/bonus token
        approx_t += tb - ta
        target_t += tc - tb
        steps += 1
        acc_len.append(n_acc)
        if verbose:
            _print_step(window, n_acc, gamma, cur_len + n_acc)
        cur_len += n_acc + 1
        if eos_token_id in window:
            break
    out_tokens = tokens.cpu().numpy()
    acc_rate_total = float(acc_rate_sum)
    wall = time.perf_counter() - t0
    drafted = steps * gamma
    if verbose:
        print(f"generated tokens numbers {cur_len - p_len}, accepted_count {sum(acc_len)}")
        print(f"Acc rate: {acc_rate_total / max(drafted, 1)}")
        print("approx model time", approx_t)
        print("target model time", target_t)
        print("other time", wall - approx_t - target_t)
        print("acc len", float(np.mean(acc_len)) if acc_len else 0.0, len(acc_len), acc_len)

    out = first_eos_truncate(out_tokens, p_len, cur_len, eos_token_id).astype("int32")
    if not details:
        return out
    n_gen = len(out) - p_len
    if stepwise:
        return out, {
            "total_time": wall,
            "approx_time": approx_t,
            "target_time": target_t,
            "other_time": wall - approx_t - target_t,
            "target_model_time": target_t,
            "target_pre_cache_time": 0.0,
            "target_post_prob_time": 0.0,
            "phase_split_method": "measured",
            "acc_len": acc_len,
            "acc_rate": acc_rate_total / max(drafted, 1),
            "target_call_times": steps,
            "approx_call_times": steps,
            "tokens_generated": n_gen,
            "tokens_per_s": n_gen / wall if wall > 0 else float("nan"),
        }
    accepted = sum(acc_len)
    bonus = sum(1 for a in acc_len if a == gamma)
    d = {
        "total_time": wall,
        "acc_len": acc_len,
        "acc_rate": acc_rate_total / max(drafted, 1),
        "target_call_times": steps,
        "approx_call_times": steps,
        "accepted_count": accepted,
        "resample_count": steps - bonus,
        "target_sample_count": bonus,
        "tokens_generated": n_gen,
        "tokens_per_s": n_gen / wall if wall > 0 else float("nan"),
    }
    fill_phase_split(
        d, wall, steps, bundle_d, params_d, bundle_t, params_t,
        draft_rows=1, verify_rows=1, gamma=gamma, verify_tokens=gamma + 1,
        max_total=max_total, device=dev,
    )
    return out, d


def _print_step(window, n_acc, gamma, pos):
    """Reference per-token stream: accepted guesses red, reject-resample
    blue, bonus sample magenta."""
    for j in window[:n_acc]:
        print(f"approx guess accepted {int(j)}: \033[31m{int(j)}\033[0m")
    t_tok = int(window[n_acc])
    if n_acc == gamma:
        print(f"target samples {pos}: \033[35m{t_tok}\033[0m")
    else:
        print(f"target resamples at position {pos}: \033[34m{t_tok}\033[0m")
