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
the device. The JAX ``lax.while_loop`` is a host loop here that reads the
device once a step: whether any beam is alive.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..cache.kvcache import rollback, select_rows
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import (
    SamplingConfig,
    joint_topk_from_logp,
    norm_logits,
    prob_of_topk,
    sample_k,
    sample_k_topk,
    use_sparse,
)
from .phases import calibrate_phase_times
from .types import ModelBundle, aligned_total, pad_prompt

_DEAD = -1e30
_DONE_THRES = -10000.0


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
    device=None,
):
    """Target-only random-width beam sampling (the reference's
    ``random_width_beam_sampling``). Returns the best candidate as numpy
    int32 [T] (prompt included); with ``details=True`` also the timing
    dict of the reference's target-only blocks."""
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    params = unstack_layers(params)
    cfg = bundle.cfg
    kmax, vocab = max_num_beams, cfg.vocab_size
    prompt_padded, p_len = pad_prompt(prompt)
    max_total = aligned_total(prompt_padded.shape[1] + max_new_tokens + 1)

    synchronize(dev)
    t0 = time.perf_counter()
    cache = bundle.make_cache(kmax, max_total, device=dev)
    row_tokens = torch.zeros((kmax, max_total), dtype=torch.long, device=dev)
    row_tokens[:, :prompt_padded.shape[1]] = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)
    logits, cache = bundle.forward(params, cfg, row_tokens[:, :prompt_padded.shape[1]], cache)
    cache = rollback(cache, p_len)
    last_logits = logits[:, p_len - 1]
    beam_scores = torch.zeros((kmax,), dtype=torch.float32, device=dev)
    best_tokens = torch.zeros((max_total,), dtype=torch.long, device=dev)
    best_score = torch.full((), _DEAD, dtype=torch.float32, device=dev)
    best_len = torch.zeros((), dtype=torch.long, device=dev)
    rows = torch.arange(kmax, device=dev)

    total = p_len + max_new_tokens
    cur_len = p_len
    while cur_len < total:
        token_logp = torch.log_softmax(last_logits.float(), dim=-1)
        k_width = torch.randint(min_num_beams, max_num_beams + 1, (), generator=gen, device=dev)
        if use_sparse(scfg):
            # candidate-space joint: per-row top-k and a merge, no [K*V] sort
            d = joint_topk_from_logp(token_logp, beam_scores, scfg)
            t = sample_k_topk(gen, d, kmax)  # a full ordering without replacement
            t_prob = prob_of_topk(d, t)
        else:
            last_p = norm_logits((token_logp + beam_scores[:, None]).reshape(1, -1), scfg)[0]
            t = sample_k(gen, last_p[None], kmax)[0]
            t_prob = last_p[t]
        parent = torch.div(t, vocab, rounding_mode="floor")
        token = t % vocab
        active = rows < k_width
        new_scores = torch.where(active, torch.log(t_prob + 1e-30), torch.full_like(t_prob, _DEAD))

        cache = select_rows(cache, parent)
        row_tokens = row_tokens[parent]
        row_tokens[:, cur_len] = token
        cur_len += 1

        # rows ending in EOS become candidates, then die
        finished = active & (token == eos_token_id)
        cand_score = torch.where(finished, new_scores / max(cur_len - p_len, 1),
                                 torch.full_like(new_scores, _DEAD))
        cbest = torch.argmax(cand_score)
        improved = cand_score[cbest] > best_score
        best_tokens = torch.where(improved, row_tokens[cbest], best_tokens)
        best_score = torch.where(improved, cand_score[cbest], best_score)
        best_len = torch.where(improved, torch.full_like(best_len, cur_len), best_len)
        beam_scores = torch.where(finished, torch.full_like(new_scores, _DEAD), new_scores)

        logits, cache = bundle.forward(params, cfg, row_tokens[:, cur_len - 1:cur_len], cache)
        last_logits = logits[:, 0]
        # the one host read of the step: is any beam alive?
        if not bool(beam_scores.max() >= _DONE_THRES):
            break

    # the surviving beams are candidates too
    norm = beam_scores / max(cur_len - p_len, 1)
    fbest = torch.argmax(norm)
    improved = norm[fbest] > best_score
    best_tokens = torch.where(improved, row_tokens[fbest], best_tokens)
    best_len = torch.where(improved, torch.full_like(best_len, cur_len), best_len)
    out = best_tokens[:int(best_len)].cpu().numpy().astype("int32")
    wall = time.perf_counter() - t0
    if not details:
        return out
    n_gen = max(len(out) - p_len, 1)
    steps = cur_len - p_len
    # target-only: the approx side of the reference's block schema is zero
    _, t_fwd = calibrate_phase_times(
        bundle, params, bundle, params, draft_rows=kmax, verify_rows=kmax, gamma=1,
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
