"""Autoregressive baseline decoder
(counterpart of ``llmspeculativesampling_tpu/engine/autoregressive.py``).

Prefill the padded prompt bucket, then 1-token forwards with the sampling
pipeline, until ``max_new_tokens`` or EOS. As JAX's ``_ar_generate_device``,
the decode loop runs on the device (``engine/device_loop.py``): one step
(:func:`_ar_step`: sample, write at ``cur_len``, one-token forward) is a
function of tensors only, with EOS and the budget checked on the device
every token, and on the card it is a replayed CUDA graph; under
``tp_mesh`` it runs eagerly with one read a token. Draws come from the
counter-based stream of ``ops/sampling.py``, seeded once from the caller's
generator.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import torch

from ..cache.kvcache import rollback_rows
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import SamplingConfig, dist_norm
from . import device_loop
from .device_loop import ARState, finished, scalar, scatter_where_
from .speculative import sample_rows
from .types import ModelBundle, aligned_total, first_eos_truncate, pad_prompt


def _ar_state(bundle, max_total: int, vocab: int, device) -> ARState:
    """A zeroed :class:`ARState` of ``max_total`` positions over ``vocab``
    logits (a rank's slice under ``tp_mesh``)."""
    return ARState(
        tokens=torch.zeros((1, max_total), dtype=torch.long, device=device),
        cur_len=scalar(0, torch.int32, device), total=scalar(0, torch.int32, device),
        cache=rollback_rows(bundle.make_cache(1, max_total, device=device), [0]),
        key=torch.zeros((1, 2), dtype=torch.long, device=device),
        last_logits=torch.zeros((1, vocab), dtype=torch.float32, device=device),
        done=scalar(False, torch.bool, device), stop=scalar(False, torch.bool, device),
    )


def _ar_start(bundle, params, prompt_t, p_len: int, total: int, key, tp_mesh,
              st: ARState) -> None:
    """Reset ``st``, prefill the padded prompt ``prompt_t`` [1, P] into its
    cache and keep the logits at the last prompt position."""
    st.tokens.zero_()
    st.tokens[:, :prompt_t.shape[1]] = prompt_t
    st.cache.lengths.zero_()
    logits, _ = bundle.forward(params, bundle.cfg, prompt_t, st.cache, tp_mesh=tp_mesh)
    st.last_logits.copy_(logits[:, p_len - 1])
    st.cur_len.fill_(p_len)
    st.total.fill_(total)
    st.key.copy_(key)
    st.done.zero_()
    st.stop.copy_(finished(st))


def _ar_step(bundle, params, scfg, eos_token_id: int, st: ARState) -> None:
    """One token on ``st``, in place: sample from ``last_logits``, write it
    at ``cur_len``, run the one-token forward there. A finished state
    writes nothing the caller reads (its forward runs at ``min(cur_len,
    total - 1)``, inside the buffers)."""
    cur = st.cur_len.long()
    active = ~st.done & (cur < st.total)
    cw = torch.minimum(cur, st.total.long() - 1).reshape(1)
    t, key = sample_rows(dist_norm(st.last_logits, scfg), st.key)  # [1]
    scatter_where_(st.tokens[0], cw, t, active)
    logits, cache = bundle.forward(params, bundle.cfg, t[:, None], rollback_rows(st.cache, cw),
                                   tp_mesh=scfg.tp_mesh)
    st.last_logits.copy_(torch.where(active, logits[:, 0], st.last_logits))
    st.cache.lengths.copy_(cache.lengths)
    st.done.copy_(st.done | (active & (t[0] == eos_token_id)))
    st.cur_len.copy_(torch.where(active, cur + 1, cur))
    st.key.copy_(torch.where(active, key, st.key))
    st.stop.copy_(finished(st))


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
    ``tokens_per_s``). ``generator`` seeds the random stream (one 32-bit
    draw). ``tp_mesh``: see ``engine/speculative.py::speculative_generate``."""
    del pad_token_id
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle = bundle.for_params(params)
    pu = unstack_layers(params)
    prompt_padded, p_len = pad_prompt(prompt)
    p_bucket = prompt_padded.shape[1]
    max_total = aligned_total(p_bucket + max_new_tokens)
    total = p_len + max_new_tokens
    device_loop.check_positions(bundle, max(p_bucket, total))
    key = device_loop.stream_key(gen, dev)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)
    vocab = bundle.cfg.vocab_size // (tp_mesh.tp if tp_mesh is not None else 1)

    synchronize(dev)
    t0 = time.perf_counter()
    st = device_loop.run(
        ("ar", bundle, max_total, scfg, eos_token_id), (params,),
        functools.partial(_ar_state, bundle, max_total, vocab, dev),
        functools.partial(_ar_start, bundle, pu, prompt_t, p_len, total, key, tp_mesh),
        functools.partial(_ar_step, bundle, pu, scfg, eos_token_id), max_new_tokens,
        replay=dev.type == "cuda" and tp_mesh is None)
    out_tokens = st.tokens.cpu().numpy()
    cur_len = int(st.cur_len)
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
