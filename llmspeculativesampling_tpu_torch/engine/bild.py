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
tokens are unchecked. The JAX engine runs the check under ``lax.cond``;
here the host branches. Each small-model step reads the device once (its
token and whether a check is due, together); a check reads once more (the
rollback point and the target's token), because the target cache's length
is a host int.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..cache.kvcache import rollback
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import SamplingConfig, TopKDist, dist_norm, dist_prob_of, dist_sample, dist_take
from .phases import calibrate_phase_times
from .types import ModelBundle, aligned_total, first_eos_truncate, pad_prompt


def check_window(p_win, tokens, start: int, last_check: int, new_len: int, rollback_thres: float):
    """The NLL test of one check. ``p_win`` [w, ...] are the target's
    distributions for positions start+1 .. start+w; the test covers the
    positions i in [last_check, new_len-2], each scoring token i+1. Returns
    (n, row): the rollback point n (the first bad position, or new_len-1
    when none is bad) and its row n - start in ``p_win``, device scalars."""
    dev = tokens.device
    w = (p_win.probs if isinstance(p_win, TopKDist) else p_win).shape[0]
    pos_i = start + torch.arange(w, device=dev)
    next_tok = tokens[0, (pos_i + 1).clamp(0, tokens.shape[1] - 1)]
    p_next = dist_prob_of(p_win, next_tok)
    in_range = (pos_i >= last_check) & (pos_i <= new_len - 2)
    bad = in_range & (-torch.log(p_next + 1e-30) > rollback_thres)
    first_bad = torch.argmax(bad.int())  # the first bad row (0 when none is)
    n = torch.where(bad.any(), start + first_bad, torch.full_like(first_bad, new_len - 1))
    return n, (n - start).clamp(0, w - 1)


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
    params_d, params_t = unstack_layers(params_d), unstack_layers(params_t)
    cfg_d, cfg_t = bundle_d.cfg, bundle_t.cfg
    prompt_padded, p_len = pad_prompt(prompt)
    max_total = aligned_total(prompt_padded.shape[1] + max_new_tokens + 2)
    w = gamma + 1  # the check window

    synchronize(dev)
    t0 = time.perf_counter()
    draft_cache = bundle_d.make_cache(1, max_total, device=dev)
    target_cache = bundle_t.make_cache(1, max_total, device=dev)
    tokens = torch.zeros((1, max_total), dtype=torch.long, device=dev)
    host = np.zeros(max_total, np.int64)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)
    tokens[:, :prompt_t.shape[1]] = prompt_t
    host[:prompt_padded.shape[1]] = prompt_padded[0]
    _, draft_cache = bundle_d.forward(params_d, cfg_d, prompt_t, draft_cache, tp_mesh=tp_mesh)
    _, target_cache = bundle_t.forward(params_t, cfg_t, prompt_t, target_cache, tp_mesh=tp_mesh)

    total = p_len + max_new_tokens
    cur_len, last_check = p_len, p_len - 1
    hist, small_cnt = [], 0
    while cur_len < total:
        # the small model decodes one token
        draft_cache = rollback(draft_cache, cur_len - 1)
        logits, draft_cache = bundle_d.forward(params_d, cfg_d, tokens[:, cur_len - 1:cur_len],
                                               draft_cache, tp_mesh=tp_mesh)
        q = dist_norm(logits[:, 0], scfg)
        x = dist_sample(gen, q)  # [1]
        tokens[:, cur_len] = x
        q_max = (q.probs if isinstance(q, TopKDist) else q).max()
        h = torch.stack([x[0], (q_max < fallback_thres).long()]).tolist()
        host[cur_len] = int(h[0])
        new_len = cur_len + 1
        small_cnt += 1
        if h[1] or (new_len - last_check - 1) >= gamma:
            # the target checks every unchecked token in one window forward
            start = max(new_len - w, 0)
            target_cache = rollback(target_cache, start)
            logits, target_cache = bundle_t.forward(params_t, cfg_t, tokens[:, start:start + w],
                                                    target_cache, tp_mesh=tp_mesh)
            p_win = dist_norm(logits[0], scfg)
            n, row = check_window(p_win, tokens, start, last_check, new_len, rollback_thres)
            t = dist_sample(gen, dist_take(p_win, row[None]))  # the target's own token at n+1
            tokens[0].scatter_(0, (n + 1).reshape(1), t)
            n_host, t_host = torch.cat([n.reshape(1), t]).tolist()
            host[n_host + 1] = t_host
            target_cache = rollback(target_cache, n_host + 1)
            hist.append(n_host - last_check)
            last_check, out_len = n_host + 1, n_host + 2
        else:
            out_len = new_len
        # EOS among the committed tokens [cur_len, out_len) (empty after a rollback)
        done = eos_token_id in host[cur_len:out_len]
        cur_len = out_len
        if done:
            break
    wall = time.perf_counter() - t0
    out = first_eos_truncate(host, p_len, cur_len, eos_token_id).astype("int32")
    if not details:
        return out
    checks = len(hist)
    d = {
        "total_time": wall,
        # the reference declares acc_rate for BiLD but never appends to it,
        # so it reports the mean of an empty list: NaN, kept for the schema
        "acc_rate": float("nan"),
        "acc_len": hist,
        "accepted_count": sum(hist),
        "target_call_times": checks,
        "approx_call_times": small_cnt,
        "tokens_generated": len(out) - p_len,
        "tokens_per_s": (len(out) - p_len) / wall if wall > 0 else float("nan"),
    }
    # approx phase = small_cnt single-token forwards; target phase = checks
    # window forwards of gamma+1 tokens
    t_draft, t_verify = calibrate_phase_times(
        bundle_d, params_d, bundle_t, params_t,
        draft_rows=1, verify_rows=1, gamma=1, verify_tokens=w, max_total=max_total, device=dev,
    )
    approx, target = small_cnt * t_draft, checks * t_verify
    if approx + target > wall > 0:
        scale = wall / (approx + target)
        approx, target = approx * scale, target * scale
    d.update(approx_time=approx, target_time=target, other_time=max(wall - approx - target, 0.0),
             target_model_time=target, target_pre_cache_time=0.0, target_post_prob_time=0.0,
             phase_split_method="calibrated")
    return out, d
