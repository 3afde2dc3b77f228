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

A step (:func:`_beam_spec_step`) is one beam draft, ONE target forward
over ``width`` rows x (gamma+1) tokens under the causal mask, the accept
rule, the residual or bonus sample, a masked commit, and the winner's row
re-broadcast into both caches. As in JAX (``_beam_spec_device``) the whole
generation runs in the device loop (``engine/device_loop.py``): the state
lives in static buffers with per-row device lengths, every draw comes from
one counter stream, and on the card the step is captured once into a CUDA
graph and replayed until the state says stop. Committed k/v need no
snapshot: the winner's path is a cache row, and the next step's windows
re-derive the boundary positions. Every row holds the committed prefix
when a step starts, so the beam draft's reorders and the re-broadcast move
only the window the step wrote (``beam_draft(shared_prefix=True)``).
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import torch

from ..cache.kvcache import rollback_rows, select_rows_
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import (
    SamplingConfig,
    TopKDist,
    dist_map,
    dist_norm,
    dist_prob_of,
    dist_sample_u,
    dist_take,
    dist_width,
    max_fn,
    row_uniform,
)
from . import device_loop
from .beam_draft import beam_draft, top_width
from .device_loop import WinnerState, commit_winner, winner_start, winner_state
from .phases import fill_phase_split
from .speculative import rows_window
from .types import ModelBundle, aligned_total, pad_prompt


def leading_accept(generator, p_sel, q_sel, fixed_r=None):
    """The multi-beam rule: the leading run of r < min(1, p/q) per
    candidate. ``p_sel``/``q_sel`` [w, gamma]; returns lengths [w]. The
    accept uniforms are ``fixed_r`` [w, gamma] when given (the engine's
    step passes its stream's), else drawn from ``generator``."""
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


def _beam_spec_step(mode, bundle_d, params_d, bundle_t, params_t, scfg, gamma: int, width: int,
                    num_beams: int, accept_thres: float, ref_row_compat: bool, eos_token_id: int,
                    st: WinnerState) -> None:
    """One beam-drafted step on ``st``, in place (JAX ``_beam_spec_device``'s
    body). The windows sit at ``cw = min(cur_len, total - 1)``; a finished
    state commits nothing (``device_loop.commit_winner``) while its forwards
    stay inside the buffers."""
    w, nb = width, num_beams
    cur = st.cur_len.long()
    active = ~st.done & (cur < st.total)
    cw = torch.minimum(cur, st.total.long() - 1).reshape(1)
    res = beam_draft(bundle_d, params_d, scfg, gamma, nb, st.tokens.expand(nb, -1), cw[0],
                     st.draft_cache, st.key, shared_prefix=True)
    cand, _, seq_q, perbeam_q, orig_rows = top_width(res, w)  # [w, gamma], ..., [w, gamma, V]
    if ref_row_compat:
        # The reference's bug, reproduced for differential runs: it sorts
        # the candidates by joint score but hands the verify its q buffers
        # in final-beam ROW order, the per-beam rows parent-gathered and the
        # joint ones never gathered at all.
        perbeam_q = res.perbeam_probs[:w]
        seq_q = res.step_chosen_q.T[:w]

    # verify: one batched target forward over the w candidates
    vin = torch.cat([rows_window(st.tokens, cw - 1, 1).expand(w, 1), cand], dim=1)
    logits, _ = bundle_t.forward(params_t, bundle_t.cfg, vin,
                                 rollback_rows(st.target_cache, (cw - 1).expand(w)),
                                 tp_mesh=scfg.tp_mesh)
    p_stack = dist_norm(logits, scfg)  # [w, gamma+1, ...]
    p_sel = dist_prob_of(dist_map(lambda x: x[:, :gamma], p_stack), cand)  # [w, gamma]
    key = res.key
    if mode == "beam":
        q_sel = torch.gather(perbeam_q, 2, cand[..., None])[..., 0]
        r = st.fixed_r
        if r is None:
            r, key = row_uniform(key, w * gamma)
            r = r.reshape(w, gamma)
        lens = leading_accept(None, p_sel, q_sel, r)
        rate = torch.clamp(p_sel / (q_sel + 1e-20), max=1.0)
    else:
        lens = mjsd_accept(accept_thres, p_sel, seq_q)
        rate = mjsd_rate(p_sel, seq_q)
    choice = torch.argmax(lens)  # the first longest
    max_l = dist_take(lens, choice)

    p_choice = dist_take(p_stack, choice)
    zero_row = torch.zeros((1, perbeam_q.shape[-1]), dtype=torch.float32, device=cw.device)
    q_l = dist_take(torch.cat([dist_take(perbeam_q, choice), zero_row]), max_l)
    u_t, key = row_uniform(key, dist_width(p_stack))
    t_res = dist_sample_u(residual(mode, dist_take(p_choice, max_l), q_l), u_t[0])
    t_bonus = dist_sample_u(dist_take(p_choice, gamma), u_t[0])
    t = torch.where(max_l == gamma, t_bonus, t_res)
    commit_winner(st, cur, cw[0], active, dist_take(cand, choice), max_l, t, rate.sum(), key,
                  eos_token_id)
    # the winner's row re-broadcast into every row of both caches (the written windows)
    select_rows_(st.draft_cache, dist_take(orig_rows, choice).expand(nb), cw - 2, gamma + 2)
    select_rows_(st.target_cache, choice.expand(w), cw - 1, gamma + 2)


def _run(
    mode, bundle_d, params_d, bundle_t, params_t, prompt, max_new_tokens, *,
    gamma, width, num_beams, accept_thres, eos_token_id, temperature, top_k, top_p,
    generator, details, random_seed, ref_row_compat, tp_mesh, device,
):
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle_d, bundle_t = bundle_d.for_params(params_d), bundle_t.for_params(params_t)
    pd, pt = unstack_layers(params_d), unstack_layers(params_t)
    nb, w = num_beams, width
    prompt_padded, p_len = pad_prompt(prompt)
    if p_len < 2:
        raise ValueError("prompt must have at least 2 tokens")
    p_bucket = prompt_padded.shape[1]
    max_total = aligned_total(p_bucket + max_new_tokens + gamma + 1)
    total = p_len + max_new_tokens
    for bundle in (bundle_d, bundle_t):
        device_loop.check_positions(bundle, max(p_bucket, total + gamma - 1))
    fixed_r = None
    if random_seed is not None and mode == "beam":
        # the reference reseeds before every accept draw: every r is one
        # fixed uniform. MJSD's accept uses r = accept_thres, so the seed
        # has no effect there, as in the reference.
        g0 = torch.Generator().manual_seed(int(random_seed))
        fixed_r = torch.rand((), generator=g0).expand(w, gamma)
    key = device_loop.stream_key(gen, dev)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    st = device_loop.run(
        (mode, bundle_d, bundle_t, gamma, w, nb, max_total, max_new_tokens, scfg, eos_token_id,
         float(accept_thres), ref_row_compat, fixed_r is not None),
        (params_d, params_t),
        functools.partial(winner_state, bundle_d, bundle_t, nb, w, gamma, 1, max_total,
                          max_new_tokens, fixed_r is not None, dev),
        functools.partial(winner_start, bundle_d, pd, bundle_t, pt, prompt_t, p_len, total, key,
                          fixed_r, tp_mesh),
        functools.partial(_beam_spec_step, mode, bundle_d, pd, bundle_t, pt, scfg, gamma, w, nb,
                          float(accept_thres), ref_row_compat, eos_token_id),
        max_new_tokens, replay=dev.type == "cuda" and tp_mesh is None)
    out, steps, accepted, acc_len, rate_total = device_loop.winner_result(st, p_len, eos_token_id)
    wall = time.perf_counter() - t0
    if not details:
        return out
    d = {
        "total_time": wall,
        "acc_len": acc_len,
        "accepted_count": accepted,
        "acc_rate": rate_total / max(steps * w * gamma, 1),
        "target_call_times": steps,
        "approx_call_times": steps,
        "tokens_generated": len(out) - p_len,
        "tokens_per_s": (len(out) - p_len) / wall if wall > 0 else float("nan"),
    }
    fill_phase_split(
        d, wall, steps, bundle_d, pd, bundle_t, pt,
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
