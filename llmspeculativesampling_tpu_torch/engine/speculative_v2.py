"""DeepMind-style speculative sampling without a KV cache
(counterpart of ``llmspeculativesampling_tpu/engine/speculative_v2.py``).

Every round re-runs both models over the whole committed prefix: gamma
draft forwards, each read at the row before the position it samples, then
one target forward whose rows ``cur_len - 1 .. cur_len + gamma - 1`` verify
the drafts. The accept / residual math is the cached engine's
(:func:`engine.speculative.accept_rows_core`); the distributions are the
dense ``norm_logits`` ones at every top_k, as in the JAX engine.

As in JAX (``_spec_v2_device``), the whole generation runs in the device
loop (``engine/device_loop.py``) on a :class:`device_loop.WinnerState` of
one row: the token buffer, the lengths, the counters and ``stop`` are
static device buffers, and one step (:func:`_v2_step`) is a function of
tensors only, captured once into a CUDA graph on the card and replayed
until the state says stop, the host reading the stop flag one step
behind. Each forward covers the whole static buffer ``[0, max_total)``
from an empty cache (each model keeps one, with a device length that
stays 0, so nothing is allocated a forward): causal attention makes the
rows read equal to a forward over the live prefix
(:func:`prefix_logits`), and the width stays static. Those blocks are
longer than the flash-decode kernel's S_new <= 32, so the forward takes
the einsum attention: this engine runs the W8A16 matmul (B1) at M =
``max_total`` and never B2, as in the JAX package. The rows a round reads
are gathered at device positions, so no step reads the device on the
host.

Every draw comes from the counter-based stream of ``ops/sampling.py``
(``row_uniform``), seeded once from the caller's generator; on the CPU and
under ``tp_mesh`` the same step runs eagerly with one read a step.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import torch

from ..cache.kvcache import rollback
from ..core.config import resolve_device, synchronize
from ..models.llama import unstack_layers
from ..ops.sampling import SamplingConfig, norm_logits, row_uniform, sample_u
from . import device_loop
from .device_loop import WinnerState, commit_winner, finished, winner_state
from .phases import fill_phase_split
from .speculative import accept_rows_core
from .types import ModelBundle, aligned_total, pad_prompt


def prefix_logits(bundle, params, tokens, n: int, cache):
    """Logits [1, n, V] of a forward over ``tokens[:, :n]`` from an empty
    cache: ``cache`` is rolled back to 0 and rewritten in place. The
    live-prefix form of a round's forward, whose rows equal the full
    buffer's (the tests and the profile hold them side by side)."""
    logits, _ = bundle.forward(params, bundle.cfg, tokens[:, :n], rollback(cache, 0))
    return logits


def _rows_at(bundle, params, tokens: torch.Tensor, cache, rows: torch.Tensor) -> torch.Tensor:
    """Logits [1, len(rows), V] at device positions ``rows`` of a forward
    over the whole buffer ``tokens`` [1, max_total] through ``cache``, whose
    device length is 0 (a fresh cache: the forward writes every position
    and reads only the block)."""
    logits, _ = bundle.forward(params, bundle.cfg, tokens, cache)
    return logits.index_select(1, rows)


def _v2_start(prompt_t, p_len: int, total: int, key, fixed_r, st: WinnerState) -> None:
    """Reset ``st`` to the padded prompt ``prompt_t`` [1, P]; nothing is
    prefilled (every round forwards the whole buffer)."""
    st.tokens.zero_()
    st.tokens[:, :prompt_t.shape[1]] = prompt_t
    st.cur_len.fill_(p_len)
    st.total.fill_(total)
    st.key.copy_(key)
    if fixed_r is not None:
        st.fixed_r.copy_(fixed_r)
    for t in (st.done, st.accepted, st.steps, st.rate_sum, st.acc_len_hist,
              st.draft_cache.lengths, st.target_cache.lengths):
        t.zero_()
    st.stop.copy_(finished(st))


def _v2_step(bundle_d, params_d, bundle_t, params_t, scfg, gamma: int, eos_token_id: int,
             st: WinnerState) -> None:
    """One round on ``st``, in place (the body of JAX ``_spec_v2_device``'s
    ``while_loop``). The drafts are written into a copy of the buffer at
    ``cw = min(cur_len, total - 1)`` (cur_len on a live state); a finished
    state commits nothing (``device_loop.commit_winner``), while its
    forwards stay inside the buffer."""
    cur = st.cur_len.long()
    active = ~st.done & (cur < st.total)
    cw = torch.minimum(cur, st.total.long() - 1).reshape(1)
    tokens = st.tokens.clone()
    key = st.key
    qs, xs = [], []
    for i in range(gamma):
        logits = _rows_at(bundle_d, params_d, tokens, st.draft_cache, cw + i - 1)
        q = norm_logits(logits[:, 0], scfg)
        u, key = row_uniform(key, q.shape[-1])
        x = sample_u(q, u)
        tokens.scatter_(1, (cw + i).reshape(1, 1), x.reshape(1, 1))
        qs.append(q)
        xs.append(x)
    window = cw - 1 + torch.arange(gamma + 1, device=cw.device)
    p_stack = norm_logits(_rows_at(bundle_t, params_t, tokens, st.target_cache, window), scfg)
    q_stack, drafts = torch.stack(qs, dim=1), torch.stack(xs, dim=1)  # [1, gamma, V], [1, gamma]
    r = st.fixed_r
    if r is None:
        r, key = row_uniform(key, gamma)
    u_t, key = row_uniform(key, p_stack.shape[-1])
    t, n, _, acc_step = accept_rows_core(gamma, q_stack, drafts, p_stack, r, u_t)
    commit_winner(st, cur, cw[0], active, drafts[0], n[0], t[0], acc_step[0], key, eos_token_id)


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
    tp_mesh=None,
    device=None,
):
    """Speculative sampling without a KV cache (the reference's
    ``speculative_sampling_v2``). Returns numpy int32 [T] (prompt included,
    cut after the first generated EOS); with ``details=True`` also the
    reference-schema dict. The generation runs in the device loop (see the
    module docstring); ``generator`` seeds its random stream (one 32-bit
    draw). ``random_seed`` reuses one fixed uniform for every accept test
    (the reference's reseed-before-every-draw quirk). ``tp_mesh``: see
    ``engine/speculative.py::speculative_generate``; every distribution
    here is dense, so the forwards give the full vocab, and the step runs
    eagerly."""
    dev = resolve_device(device)
    scfg = SamplingConfig(temperature, top_k, top_p, tp_mesh=tp_mesh)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    bundle_d, bundle_t = bundle_d.for_params(params_d), bundle_t.for_params(params_t)
    pd, pt = unstack_layers(params_d), unstack_layers(params_t)
    prompt_padded, p_len = pad_prompt(prompt)
    max_total = aligned_total(prompt_padded.shape[1] + max_new_tokens + gamma + 1)
    total = p_len + max_new_tokens
    for bundle in (bundle_d, bundle_t):
        device_loop.check_positions(bundle, max_total)
    fixed_r = None
    if random_seed is not None:
        g0 = torch.Generator().manual_seed(int(random_seed))
        fixed_r = torch.rand((), generator=g0).expand(1, gamma)
    key = device_loop.stream_key(gen, dev)
    prompt_t = torch.as_tensor(prompt_padded, dtype=torch.long).to(dev)

    synchronize(dev)
    t0 = time.perf_counter()
    st = device_loop.run(
        ("spec_v2", bundle_d, bundle_t, gamma, max_total, max_new_tokens, scfg, eos_token_id,
         fixed_r is not None),
        (params_d, params_t),
        functools.partial(winner_state, bundle_d, bundle_t, 1, 1, gamma, 1, max_total,
                          max_new_tokens, fixed_r is not None, dev),
        functools.partial(_v2_start, prompt_t, p_len, total, key, fixed_r),
        functools.partial(_v2_step, bundle_d, pd, bundle_t, pt, scfg, gamma, eos_token_id),
        max_new_tokens, replay=dev.type == "cuda" and tp_mesh is None)
    out, steps, accepted, acc_len, rate_total = device_loop.winner_result(st, p_len, eos_token_id)
    wall = time.perf_counter() - t0
    if not details:
        return out
    d = {
        "total_time": wall,
        "acc_len": acc_len,
        "acc_rate": rate_total / max(steps * gamma, 1),
        "accepted_count": accepted,
        "target_call_times": steps,
        "approx_call_times": steps,
        "tokens_generated": len(out) - p_len,
        "tokens_per_s": (len(out) - p_len) / wall if wall > 0 else float("nan"),
    }
    fill_phase_split(
        d, wall, steps, bundle_d, pd, bundle_t, pt,
        draft_rows=1, verify_rows=1, gamma=gamma, verify_tokens=gamma + 1,
        max_total=max_total, device=dev, draft_mode="full",
    )
    return out, d
