"""Beam-drafted speculative algorithms: multi-beam and MJSD
(counterpart of ``llmspeculativesampling_tpu/engine/beam_spec.py``).

* ``multi_beam_generate`` (the reference's
  ``multi_speculative_sampling(strategy='beam')``): the draft beam-samples
  ``num_beams`` paths (``engine/beam_draft.py``) and keeps the ``width``
  best; each candidate is verified token by token with r < min(1, p/q),
  q being the draft's per-beam distribution along the path; the longest
  leading-accepted candidate wins; a reject resamples ``max_fn(p - q)``
  (p where that is empty), full acceptance takes a bonus target sample.
* ``mjsd_generate`` (the reference's ``mjsd_speculative_sampling``,
  multi-token joint speculative decoding): candidates are scored by the
  cumulative joint ratio exp(sum_i log p_i) / seq_q_i against the fixed
  ``accept_thres``; a candidate's length is the LAST index whose ratio
  clears it; the longest wins; a reject samples ``max_fn(p)`` (the plain
  target distribution, as the reference does), full acceptance a bonus.

A step is one beam draft, ONE target forward over ``width`` rows x
(gamma+1) tokens under the causal mask, the accept rule, the residual or
bonus sample, and the winner's row re-broadcast into both caches
(``select_rows``). The JAX ``lax.while_loop`` is a host loop here with
fixed shapes a step and ONE host read a step, after the accept: the
winner's accept count, its tokens and the next token. Committed k/v need
no snapshot: the winner's path is a cache row, and the next step's
windows re-derive the boundary positions.
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
    dist_prob_of,
    dist_sample,
    dist_take,
    max_fn,
)
from .beam_draft import beam_draft, top_width
from .phases import fill_phase_split
from .types import ModelBundle, aligned_total, first_eos_truncate, pad_prompt


def leading_accept(generator, p_sel, q_sel, fixed_r=None):
    """The multi-beam rule: the leading run of r < min(1, p/q) per
    candidate. ``p_sel``/``q_sel`` [w, gamma]; returns lengths [w]."""
    ratio = torch.clamp(p_sel / (q_sel + 1e-20), max=1.0)
    r = fixed_r if fixed_r is not None else torch.rand(
        p_sel.shape, generator=generator, device=p_sel.device)
    return torch.cumprod((r < ratio).long(), dim=1).sum(dim=1)


def mjsd_accept(accept_thres: float, p_sel, seq_q):
    """The MJSD rule: the last index whose cumulative joint ratio
    exp(sum log p) / seq_q clears ``accept_thres``; length = that index + 1
    (0 when none does). ``p_sel``/``seq_q`` [w, gamma]; returns [w]."""
    ok = accept_thres <= mjsd_rate(p_sel, seq_q)
    idx = torch.arange(1, p_sel.shape[1] + 1, device=p_sel.device)
    return torch.where(ok, idx, torch.zeros_like(idx)).amax(dim=1)


def mjsd_rate(p_sel, seq_q):
    """min(1, exp(cumsum log p) / seq_q) [w, gamma]."""
    cum_logp = torch.cumsum(torch.log(p_sel + 1e-30), dim=1)
    return torch.clamp(torch.exp(cum_logp) / (seq_q + 1e-30), max=1.0)


def residual(mode: str, p_l, q_l):
    """The reject distribution at the first unaccepted position. ``p_l``
    is the target's (dense [V] or a TopKDist), ``q_l`` the winner's dense
    per-beam draft distribution there ([V], zeros past the last draft).
    Beam mode: ``max_fn(p - q)``, on p's support when sparse, falling back
    to p when it is empty. MJSD: ``max_fn(p)``."""
    if isinstance(p_l, TopKDist):
        if mode != "beam":
            return TopKDist(p_l.idx, max_fn(p_l.probs))
        wres = torch.clamp(p_l.probs - q_l[p_l.idx], min=0.0)
        rp = wres / (wres.sum() + 1e-6)
        return TopKDist(p_l.idx, torch.where(rp.sum() < 1e-6, p_l.probs, rp))
    if mode != "beam":
        return max_fn(p_l)
    resid = max_fn(p_l - q_l)
    return torch.where(resid.sum() < 1e-6, p_l, resid)


def _run(
    mode, bundle_d, params_d, bundle_t, params_t, prompt, max_new_tokens, *,
    gamma, width, num_beams, accept_thres, eos_token_id, temperature, top_k, top_p,
    generator, details, random_seed, ref_row_compat, tp_mesh, device,
):
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle_d, bundle_t = bundle_d.for_params(params_d), bundle_t.for_params(params_t)
    params_d, params_t = unstack_layers(params_d), unstack_layers(params_t)
    cfg_t = bundle_t.cfg
    nb, w = num_beams, width
    prompt_padded, p_len = pad_prompt(prompt)
    if p_len < 2:
        raise ValueError("prompt must have at least 2 tokens")
    max_total = aligned_total(prompt_padded.shape[1] + max_new_tokens + gamma + 1)
    fixed_r = None
    if random_seed is not None and mode == "beam":
        # the reference reseeds before every accept draw: every r is one
        # fixed uniform. MJSD's accept uses r = accept_thres, so the seed
        # has no effect there, as in the reference.
        g0 = torch.Generator().manual_seed(int(random_seed))
        fixed_r = torch.rand((), generator=g0).expand(w, gamma).to(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    draft_cache = bundle_d.make_cache(nb, max_total, device=dev)
    target_cache = bundle_t.make_cache(w, max_total, device=dev)
    tokens = torch.zeros((1, max_total), dtype=torch.long, device=dev)
    host = np.zeros(max_total, np.int64)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)
    tokens[:, :prompt_t.shape[1]] = prompt_t
    host[:prompt_padded.shape[1]] = prompt_padded[0]
    _, draft_cache = bundle_d.forward(params_d, bundle_d.cfg, prompt_t.expand(nb, -1), draft_cache)
    _, target_cache = bundle_t.forward(params_t, cfg_t, prompt_t.expand(w, -1), target_cache,
                                       tp_mesh=tp_mesh)
    zero_row = torch.zeros((1, cfg_t.vocab_size), dtype=torch.float32, device=dev)

    total = p_len + max_new_tokens
    cur_len = p_len
    acc_len = []
    rate_sum = torch.zeros((), dtype=torch.float32, device=dev)
    while cur_len < total:
        res = beam_draft(bundle_d, params_d, scfg, gamma, nb, tokens.expand(nb, -1), cur_len,
                         draft_cache, gen)
        draft_cache = res.cache
        cand, _, seq_q, perbeam_q, orig_rows = top_width(res, w)  # [w, gamma], ..., [w, gamma, V]
        if ref_row_compat:
            # The reference's bug, reproduced for differential runs: it
            # sorts the candidates by joint score but hands the verify its
            # q buffers in final-beam ROW order, the per-beam rows
            # parent-gathered and the joint ones never gathered at all.
            perbeam_q = res.perbeam_probs[:w]
            seq_q = res.step_chosen_q.T[:w]

        # verify: one batched target forward over the w candidates
        target_cache = rollback(target_cache, cur_len - 1)
        vin = torch.cat([tokens[:, cur_len - 1:cur_len].expand(w, 1), cand], dim=1)
        logits, target_cache = bundle_t.forward(params_t, cfg_t, vin, target_cache, tp_mesh=tp_mesh)
        p_stack = dist_norm(logits, scfg)  # [w, gamma+1, ...]
        p_sel = dist_prob_of(dist_map(lambda x: x[:, :gamma], p_stack), cand)  # [w, gamma]
        if mode == "beam":
            q_sel = torch.gather(perbeam_q, 2, cand[..., None])[..., 0]
            lens = leading_accept(gen, p_sel, q_sel, fixed_r)
            rate = torch.clamp(p_sel / (q_sel + 1e-20), max=1.0)
        else:
            lens = mjsd_accept(accept_thres, p_sel, seq_q)
            rate = mjsd_rate(p_sel, seq_q)
        rate_sum += rate.sum()
        choice = torch.argmax(lens)  # the first longest
        max_l = lens[choice]
        win = dist_take(cand, choice)
        tokens[0, cur_len:cur_len + gamma] = win

        p_choice = dist_take(p_stack, choice)
        q_l = dist_take(torch.cat([dist_take(perbeam_q, choice), zero_row]), max_l)
        t_res = dist_sample(gen, residual(mode, dist_take(p_choice, max_l), q_l))
        t_bonus = dist_sample(gen, dist_take(p_choice, gamma))
        t = torch.where(max_l == gamma, t_bonus, t_res)
        tokens[0].scatter_(0, (cur_len + max_l).reshape(1), t.reshape(1))

        # the winner's row re-broadcast into every row of both caches
        draft_cache = select_rows(draft_cache, dist_take(orig_rows, choice).expand(nb))
        target_cache = select_rows(target_cache, choice.expand(w))
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
        "acc_rate": rate_total / max(steps * w * gamma, 1),
        "target_call_times": steps,
        "approx_call_times": steps,
        "tokens_generated": len(out) - p_len,
        "tokens_per_s": (len(out) - p_len) / wall if wall > 0 else float("nan"),
    }
    fill_phase_split(
        d, wall, steps, bundle_d, params_d, bundle_t, params_t,
        draft_rows=nb, verify_rows=w, gamma=gamma, verify_tokens=gamma + 1,
        max_total=max_total, device=dev,
    )
    return out, d


def multi_beam_generate(
    bundle_d: ModelBundle, params_d, bundle_t: ModelBundle, params_t, prompt,
    max_new_tokens: int, *,
    gamma: int = 4, width: int = 4, num_beams: Optional[int] = None,
    eos_token_id: int, temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
    generator: Optional[torch.Generator] = None, random_seed: Optional[int] = None,
    details: bool = False, ref_row_compat: bool = False, tp_mesh=None, device=None,
):
    """``multi_speculative_sampling(strategy='beam')``. Returns numpy int32
    [T] (prompt included, cut after the first generated EOS); with
    ``details=True`` also the reference-schema dict. ``random_seed`` reuses
    one fixed uniform for every accept test; ``ref_row_compat=True``
    reproduces the reference's q-buffer row misalignment (differential
    runs only). ``tp_mesh``: see
    ``engine/speculative.py::speculative_generate``."""
    return _run(
        "beam", bundle_d, params_d, bundle_t, params_t, prompt, max_new_tokens,
        gamma=gamma, width=width, num_beams=num_beams or max(4, width), accept_thres=0.0,
        eos_token_id=eos_token_id, temperature=temperature, top_k=top_k, top_p=top_p,
        generator=generator, details=details, random_seed=random_seed,
        ref_row_compat=ref_row_compat, tp_mesh=tp_mesh, device=device,
    )


def mjsd_generate(
    bundle_d: ModelBundle, params_d, bundle_t: ModelBundle, params_t, prompt,
    max_new_tokens: int, *,
    gamma: int = 4, width: int = 8, num_beams: int = 8, accept_thres: float = 0.1,
    eos_token_id: int, temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
    generator: Optional[torch.Generator] = None, random_seed: Optional[int] = None,
    details: bool = False, ref_row_compat: bool = False, tp_mesh=None, device=None,
):
    """``mjsd_speculative_sampling`` (multi-token joint accept). Returns
    as :func:`multi_beam_generate`. ``random_seed`` is accepted for
    signature parity: the reference's accept uses the deterministic
    r = accept_thres, so the seed has no effect, here or there."""
    return _run(
        "mjsd", bundle_d, params_d, bundle_t, params_t, prompt, max_new_tokens,
        gamma=gamma, width=width, num_beams=num_beams, accept_thres=accept_thres,
        eos_token_id=eos_token_id, temperature=temperature, top_k=top_k, top_p=top_p,
        generator=generator, details=details, random_seed=random_seed,
        ref_row_compat=ref_row_compat, tp_mesh=tp_mesh, device=device,
    )
