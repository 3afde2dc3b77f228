"""DeepMind-style speculative sampling without a KV cache
(counterpart of ``llmspeculativesampling_tpu/engine/speculative_v2.py``).

Every round re-runs both models over the whole committed prefix: gamma
draft forwards, each over the tokens before the position it samples, then
one target forward whose last gamma+1 rows verify the drafts. The accept /
residual math is the cached engine's
(:func:`engine.speculative.accept_phase`); the distributions are the dense
``norm_logits`` ones at every top_k, as in the JAX engine.

The JAX engine forwards the whole static buffer ``[0, max_total_len)``
through a fresh cache each time. Attention is causal, so the rows read
here are the same when only the live prefix is forwarded, and that is what
this engine does. Each model keeps ONE cache, rolled back to 0 before every
forward (positions past the new block are masked, exactly as in a fresh
cache), instead of allocating a cache a forward. Those blocks are longer
than the flash-decode kernel's S_new <= 32, so the forward takes the
einsum attention: this engine runs the W8A16 matmul (B1) at a new M every
round and never B2, as in the JAX package.

The JAX ``lax.while_loop`` is a host loop here that reads the device once
a round, after the accept: the accept count and the committed window.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..cache.kvcache import rollback
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import SamplingConfig, norm_logits, sample
from .phases import fill_phase_split
from .speculative import accept_phase
from .types import ModelBundle, aligned_total, first_eos_truncate, pad_prompt


def prefix_logits(bundle, params, tokens, n: int, cache):
    """Logits [1, n, V] of a forward over ``tokens[:, :n]`` from an empty
    cache: ``cache`` is rolled back to 0 and rewritten in place, so one
    cache serves every forward of a run."""
    logits, _ = bundle.forward(params, bundle.cfg, tokens[:, :n], rollback(cache, 0))
    return logits


def speculative_generate_v2(
    bundle_d: ModelBundle,
    params_d,
    bundle_t: ModelBundle,
    params_t,
    prompt,
    max_new_tokens: int,
    *,
    gamma: int = 4,
    eos_token_id: int,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    random_seed: Optional[int] = None,
    details: bool = False,
    device=None,
):
    """Speculative sampling without a KV cache (the reference's
    ``speculative_sampling_v2``). Returns numpy int32 [T] (prompt included,
    cut after the first generated EOS); with ``details=True`` also the
    reference-schema dict. ``random_seed`` reuses one fixed uniform for
    every accept test (the reference's reseed-before-every-draw quirk)."""
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    params_d, params_t = unstack_layers(params_d), unstack_layers(params_t)
    prompt_padded, p_len = pad_prompt(prompt)
    max_total = aligned_total(prompt_padded.shape[1] + max_new_tokens + gamma + 1)
    fixed_r = None
    if random_seed is not None:
        g0 = torch.Generator().manual_seed(int(random_seed))
        fixed_r = torch.rand((), generator=g0).expand(gamma).to(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    draft_cache = bundle_d.make_cache(1, max_total, device=dev)
    target_cache = bundle_t.make_cache(1, max_total, device=dev)
    tokens = torch.zeros((1, max_total), dtype=torch.long, device=dev)
    host = np.zeros(max_total, np.int64)
    tokens[:, :prompt_padded.shape[1]] = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)
    host[:prompt_padded.shape[1]] = prompt_padded[0]

    total = p_len + max_new_tokens
    cur_len = p_len
    acc_len = []
    rate_sum = torch.zeros((), dtype=torch.float32, device=dev)
    while cur_len < total:
        qs, xs = [], []
        for pos in range(cur_len, cur_len + gamma):
            logits = prefix_logits(bundle_d, params_d, tokens, pos, draft_cache)
            q = norm_logits(logits[:, -1], scfg)
            x = sample(gen, q)
            tokens[:, pos] = x
            qs.append(q)
            xs.append(x)
        logits = prefix_logits(bundle_t, params_t, tokens, cur_len + gamma, target_cache)
        p_stack = norm_logits(logits[0, cur_len - 1:], scfg)  # [gamma+1, V]
        tokens, _, _, n, _, acc_step = accept_phase(
            scfg, gamma, eos_token_id, tokens, cur_len, torch.cat(qs), torch.cat(xs),
            p_stack, gen, fixed_r)
        rate_sum += acc_step
        # the one host read of the round: accept count + committed window
        h = torch.cat([n.reshape(1), tokens[0, cur_len:cur_len + gamma + 1]]).tolist()
        n_acc = int(h[0])
        window = h[1:n_acc + 2]
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
        "acc_rate": rate_total / max(steps * gamma, 1),
        "accepted_count": sum(acc_len),
        "target_call_times": steps,
        "approx_call_times": steps,
        "tokens_generated": len(out) - p_len,
        "tokens_per_s": (len(out) - p_len) / wall if wall > 0 else float("nan"),
    }
    fill_phase_split(
        d, wall, steps, bundle_d, params_d, bundle_t, params_t,
        draft_rows=1, verify_rows=1, gamma=gamma, verify_tokens=gamma + 1,
        max_total=max_total, device=dev, draft_mode="full",
    )
    return out, d
