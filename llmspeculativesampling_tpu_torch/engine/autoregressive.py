"""Autoregressive baseline decoder
(counterpart of ``llmspeculativesampling_tpu/engine/autoregressive.py``).

Prefill the padded prompt bucket, roll the cache back to the true prompt
length, then 1-token forwards with the sampling pipeline, until
``max_new_tokens`` or EOS. The loop runs on the host and reads the device
only every ``EOS_CHECK_EVERY`` tokens (to stop at EOS): tokens sampled
after an EOS are cut by :func:`first_eos_truncate`, so the output equals a
loop that stops at the EOS itself.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..cache.kvcache import rollback
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import SamplingConfig, dist_norm, dist_sample
from .types import ModelBundle, aligned_total, first_eos_truncate, pad_prompt

EOS_CHECK_EVERY = 16


def autoregressive_generate(
    bundle: ModelBundle,
    params,
    prompt,
    max_new_tokens: int,
    *,
    eos_token_id: int,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    pad_token_id: Optional[int] = None,
    details: bool = False,
    tp_mesh=None,
    device=None,
):
    """Generate ``max_new_tokens`` tokens. Returns numpy int32 [T] (prompt
    included, cut after the first generated EOS); with ``details=True`` also
    the timing dict (``total_time``, ``tokens_generated``, ``s_per_token``,
    ``tokens_per_s``). ``tp_mesh``: see
    ``engine/speculative.py::speculative_generate``."""
    del pad_token_id
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle = bundle.for_params(params)
    params = unstack_layers(params)
    cfg = bundle.cfg
    prompt_padded, p_len = pad_prompt(prompt)
    max_total = aligned_total(prompt_padded.shape[1] + max_new_tokens)

    synchronize(dev)
    t0 = time.perf_counter()
    cache = bundle.make_cache(1, max_total, device=dev)
    tokens = torch.zeros((1, max_total), dtype=torch.long, device=dev)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)
    tokens[:, : prompt_t.shape[1]] = prompt_t
    logits, cache = bundle.forward(params, cfg, prompt_t, cache, tp_mesh=tp_mesh)
    cache = rollback(cache, p_len)
    last_logits = logits[:, p_len - 1]

    total = p_len + max_new_tokens
    cur_len = p_len
    while cur_len < total:
        t = dist_sample(gen, dist_norm(last_logits, scfg))  # [1]
        tokens[:, cur_len] = t
        cur_len += 1
        if (cur_len - p_len) % EOS_CHECK_EVERY == 0 or cur_len == total:
            if bool((tokens[0, p_len:cur_len] == eos_token_id).any()):
                break
        if cur_len < total:
            logits, cache = bundle.forward(params, cfg, t[:, None], cache, tp_mesh=tp_mesh)
            last_logits = logits[:, 0]
    out_tokens = tokens.cpu().numpy()
    wall = time.perf_counter() - t0

    out = first_eos_truncate(out_tokens, p_len, cur_len, eos_token_id).astype("int32")
    if not details:
        return out
    n_gen = max(len(out) - p_len, 1)
    d = {
        "total_time": wall,
        "tokens_generated": len(out) - p_len,
        "s_per_token": wall / n_gen,
        "tokens_per_s": n_gen / wall,
    }
    return out, d
