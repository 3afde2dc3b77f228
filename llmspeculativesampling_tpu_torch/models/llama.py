"""Llama decoder (counterpart of ``llmspeculativesampling_tpu/models/llama.py``).

A function of a param dict, like the JAX module: per-layer weights are
stacked on a leading ``L`` axis (``params["layers"][name]`` is ``[L, ...]``,
quant leaves ``{"q": [L, K, N], "s": [L, N]}``). :func:`unstack_layers`
turns that into a list of per-layer views once, so a forward does not
re-index every weight; :func:`forward` takes either form.

Attention dispatch follows the JAX forward: a new block of at most 32
tokens (decode, verify, tree steps) writes the cache first and then runs
the flash-decode kernel over the live prefix plus the new block; a longer
block (the prefill) takes the einsum path over ``[0, S_max)`` with a mask.
A contiguous cache with per-row ``lengths`` on the device (the slot
engine, ``serve/scheduler.py``) takes the same two paths by row: the
flash-decode kernel gets the lengths as they are and each row's block lands
at its own length; the einsum path masks each row at its length. A paged
cache (``cache/paged.py``, the paged serving path) has per-row lengths on
the device too: short blocks go to the paged flash-decode kernel, longer
ones to the gather path, and ``paged_prefill=True`` runs block-only causal
attention over empty rows. The TPU-only floors of the JAX gates
(``s_max >= 2*block_t``, ``head_dim >= 64``, ``page % 128 == 0``, a TPU
backend) do not carry over. Matmuls accumulate in fp32, softmax and RMSNorm
run in fp32, activations stay in the config dtype.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from ..cache import paged as paged_cache
from ..cache.kvcache import (
    grad_safe,
    layer_slices,
    update_and_read_layer,
    write_layer,
    write_layer_quant,
)
from ..core.config import LlamaConfig, resolve_device
from ..kernels import flash_decode
from ..kernels.paged_flash_decode import paged_flash_decode_attention
from ..parallel.comm import all_reduce, logits_over, row_parallel
from ..parallel.sharding import local_heads, mesh_of
from .linear import linear, lm_head_logits

_MASK_VALUE = -1e30


def block_bias(s_new: int, tree_mask: Optional[torch.Tensor], batch: int, device,
               window: Optional[int] = None) -> torch.Tensor:
    """Additive [B, S_new, S_new] bias over the new block: causal, or the
    tree mask; a ``window`` also hides tokens ``window`` or more before the
    query."""
    if tree_mask is None:
        vis = torch.ones((s_new, s_new), dtype=torch.bool, device=device).tril()
        vis = vis[None].expand(batch, s_new, s_new)
    else:
        vis = tree_mask.to(device=device, dtype=torch.bool)
    if window is not None:
        idx = torch.arange(s_new, device=device)
        vis = vis & ((idx[:, None] - idx[None, :]) < window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(vis, zero, torch.full_like(zero, _MASK_VALUE)).contiguous()


def flash_layer_attention(q, k, v, cache_slices, length, lengths, bias_blk, scale,
                          window: int = 0):
    """One layer's attention through the flash-decode kernel. ``q``/``k``/``v``:
    [B, S, H, D] fresh projections, passed to the kernel as [B, H, S, D]
    views (no copy). Writes the new block into the layer's cache buffers at
    ``length`` (the host int, or per-row lengths on the device; in place),
    then attends over the live prefix
    (``lengths``, int32 [B] on the device) plus the new block, read from
    ``k``/``v`` and not back from the cache. Returns ctx [B, S, hidden]: on
    the card the kernel writes [B, S, H, D] memory, so this is a view.
    ``window`` > 0 lets a query at position t see cached positions > t -
    window only. The kernel has no backward pass: under grad only CPU
    tensors (the plain version) get through."""
    b, s = q.shape[0], q.shape[1]
    kn, vn, qh = k.transpose(1, 2), v.transpose(1, 2), q.transpose(1, 2)
    if len(cache_slices) == 4:
        k_q_l, k_s_l, v_q_l, v_s_l = write_layer_quant(*cache_slices, length, kn, vn)
        ctx = flash_decode.flash_decode_attention(
            qh, kn, vn, k_q_l, v_q_l, lengths, bias_blk, scale=scale, k_scales=k_s_l,
            v_scales=v_s_l, window=window)
    else:
        k_l, v_l = write_layer(cache_slices[0], cache_slices[1], length, kn, vn)
        ctx = flash_decode.flash_decode_attention(qh, kn, vn, grad_safe(k_l), grad_safe(v_l),
                                                  lengths, bias_blk, scale=scale, window=window)
    return ctx.transpose(1, 2).reshape(b, s, -1)


def paged_flash_layer_attention(q, k, v, slices, block_tables, lengths, bias_blk, scale,
                                batch_invariant: bool, window: int = 0):
    """One layer's attention through the paged flash-decode kernel.
    ``q``/``k``/``v``: [B, S, H, D] fresh projections, passed as [B, H, S, D]
    views. Writes the new block into the layer's pools at each row's
    ``lengths`` (in place), then attends over the live prefix, read page by
    page through ``block_tables``, plus the new block read from ``k``/``v``.
    ``batch_invariant`` plans the kernel's grid without the batch;
    ``window`` as in :func:`flash_layer_attention`. Returns ctx [B, S,
    hidden] (a view on the card, as above)."""
    b, s = q.shape[0], q.shape[1]
    kn, vn, qh = k.transpose(1, 2), v.transpose(1, 2), q.transpose(1, 2)
    paged_cache.paged_write_layer(slices, block_tables, lengths, kn, vn)
    if len(slices) == 4:
        k_q, k_s, v_q, v_s = slices
        ctx = paged_flash_decode_attention(
            qh, kn, vn, k_q, v_q, block_tables, lengths, bias_blk,
            scale=scale, k_scales=k_s, v_scales=v_s, batch_invariant=batch_invariant,
            window=window)
    else:
        ctx = paged_flash_decode_attention(
            qh, kn, vn, slices[0], slices[1], block_tables, lengths, bias_blk, scale=scale,
            batch_invariant=batch_invariant, window=window)
    return ctx.transpose(1, 2).reshape(b, s, -1)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def yarn_inv_freq(head_dim: int, theta: float, factor: float, original_max: int,
                  beta_fast: float, beta_slow: float, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies [D/2] (Peng et al. 2023, arXiv:2309.00071;
    transformers' ``_compute_yarn_parameters``, truncated correction range):
    each frequency's blend of extrapolation (``1 / theta**(2i/D)``) and
    interpolation (that over ``factor``), a linear ramp over the dimensions
    between the correction dims of ``beta_fast`` and ``beta_slow`` rotations
    within ``original_max`` positions. Built on ``device`` (no host copy)."""
    def corr(rot):
        return head_dim * math.log(original_max / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low, high = max(math.floor(corr(beta_fast)), 0), min(math.ceil(corr(beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                          / head_dim)
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    extrapolate = 1 - ramp
    return (1.0 / (factor * pos_freqs)) * (1 - extrapolate) + (1.0 / pos_freqs) * extrapolate


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                scaling: Optional[tuple] = None, max_position: int = 0):
    """cos/sin tables [B, S, D] for positions [B, S]; ``scaling`` is None,
    ("linear"|"dynamic", factor), as in the JAX module, or ("yarn", factor,
    original_max_position_embeddings, beta_fast, beta_slow,
    attention_factor): :func:`yarn_inv_freq`, cos and sin times the
    attention factor (so q and k each carry it)."""
    pos = positions.float()
    if scaling is not None and scaling[0] == "yarn":
        _, factor, original, beta_fast, beta_slow, attention_factor = scaling
        inv_freq = yarn_inv_freq(head_dim, theta, factor, original, beta_fast, beta_slow,
                                 positions.device)
        angles = pos[..., None] * inv_freq
        angles = torch.cat([angles, angles], dim=-1)
        return torch.cos(angles) * attention_factor, torch.sin(angles) * attention_factor
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)  # no host copy
    if scaling is not None:
        kind, factor = scaling
        if kind == "linear":
            pos = pos / float(factor)
        elif kind == "dynamic":
            seq_len = positions.max().float() + 1.0
            dyn = base * ((factor * seq_len / max_position) - (factor - 1.0)) ** (
                head_dim / (head_dim - 2))
            base = torch.where(seq_len > max_position, dyn, base)
        else:
            raise ValueError(f"unknown rope scaling kind {kind!r}")
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (base ** exps)
    angles = pos[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, D] (rotate_half convention)."""
    half = x.shape[-1] // 2
    xf = x.float()
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, :, None, :] + rotated * sin[:, :, None, :]).to(x.dtype)


def attention_mask(length, s_new: int, s_max: int, tree_mask: Optional[torch.Tensor],
                   batch: int, device, window: Optional[int] = None) -> torch.Tensor:
    """Boolean visibility [B, S_new, S_max]: prefix < length fully visible,
    the new block causal or per ``tree_mask``, later positions dead; a
    ``window`` hides positions ``window`` or more before the query's
    (``length`` + its index). ``length`` is an int (every row) or a
    per-row [B] tensor."""
    kv_pos = torch.arange(s_max, device=device)[None, None, :]
    q_idx = torch.arange(s_new, device=device)[None, :, None]
    if isinstance(length, torch.Tensor):  # a host int stays one: no copy to the card
        length = length.to(device).reshape(-1, 1, 1)
    prefix_vis = kv_pos < length
    in_block = (kv_pos >= length) & (kv_pos < length + s_new)
    if window is not None:
        recent = kv_pos > length + q_idx - window
        prefix_vis = prefix_vis & recent
        in_block = in_block & recent
    if tree_mask is None:
        vis = prefix_vis | (in_block & ((kv_pos - length) <= q_idx))
        return vis.expand(batch, s_new, s_max)
    col = (kv_pos - length).clamp(0, s_new - 1).expand(batch, s_new, s_max)
    tree_full = torch.gather(tree_mask.to(device=device, dtype=torch.bool), 2, col)
    return prefix_vis.expand(batch, s_new, s_max) | (in_block.expand(batch, s_new, s_max) & tree_full)


def unstack_layers(params: dict) -> dict:
    """Shallow copy of ``params`` whose ``layers`` is a list of per-layer
    dicts of views (no data is copied)."""
    layers = params["layers"]
    if isinstance(layers, list):
        return params

    def take(v, i):
        return {kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i]

    n = next(iter(layers.values()))
    n = (n["q"] if isinstance(n, dict) else n).shape[0]
    return {**params, "layers": [{k: take(v, i) for k, v in layers.items()} for i in range(n)]}


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """One forward's attention dispatch over ``cache``, shared by every
    layer (and by ``models/opt.py``): which path the new block of ``s``
    tokens takes, the cache length (a host int for the contiguous cache,
    else None; per-row ``lengths`` on the device for the kernels, the
    paged cache and a contiguous cache that carries them), each token's
    default ``offset`` for its position, and the additive biases."""

    paged: bool
    use_flash: bool
    paged_prefill: bool
    batch_invariant: bool  # B1, the dense head and B3 planned without the batch
    length: Optional[int]
    lengths: Optional[torch.Tensor]
    offset: object
    bias_blk: Optional[torch.Tensor]  # [B, S, S], the flash and block-only paths
    bias: Optional[torch.Tensor]      # [B, 1, S, S_max], the einsum paths
    # the window layers' (``attention_plan(window=)``): their window and biases
    window: Optional[int] = None
    bias_blk_win: Optional[torch.Tensor] = None
    bias_win: Optional[torch.Tensor] = None

    @property
    def write_at(self):
        """Where a contiguous cache takes the new block: the host length,
        else each row's device length."""
        return self.lengths if self.length is None else self.length


def attention_plan(cache, s: int, batch: int, device, flash: str,
                   tree_mask: Optional[torch.Tensor], paged_prefill: bool,
                   batch_invariant: bool = False, window: Optional[int] = None) -> AttentionPlan:
    """The attention dispatch of a block of ``s`` tokens (see the module
    docstring); ``paged_prefill`` implies ``batch_invariant``. ``window``
    also builds the biases of layers that attend to their last ``window``
    positions only (``layer_attention(window=)``)."""
    paged = paged_cache.is_paged(cache)
    if paged_prefill and not paged:
        raise ValueError("paged_prefill needs a paged cache")
    if paged:
        length, lengths = None, cache.lengths
        s_max = cache.max_pages * cache.page
        offset = lengths.long()[:, None]
        use_flash = not paged_prefill and flash_decode.should_use(s, flash)
    elif cache.lengths is not None:
        length, lengths = None, cache.lengths
        s_max = cache.max_len
        offset = lengths.long()[:, None]
        use_flash = flash_decode.should_use(s, flash)
    else:
        length, lengths = int(cache.length), None
        s_max = cache.max_len
        offset = length
        use_flash = flash_decode.should_use(s, flash)
    bias_blk = bias = bias_blk_win = bias_win = None
    if use_flash or paged_prefill:
        bias_blk = block_bias(s, tree_mask, batch, device)
        if window is not None:
            bias_blk_win = block_bias(s, tree_mask, batch, device, window)
        if length is not None:
            lengths = torch.full((batch,), length, dtype=torch.int32, device=device)
    else:
        at = lengths if length is None else length
        mask = attention_mask(at, s, s_max, tree_mask, batch, device)
        bias = torch.where(mask, 0.0, _MASK_VALUE).float()[:, None]  # [B,1,S,S_max]
        if window is not None:
            mask = attention_mask(at, s, s_max, tree_mask, batch, device, window)
            bias_win = torch.where(mask, 0.0, _MASK_VALUE).float()[:, None]
    return AttentionPlan(paged, use_flash, paged_prefill, paged_prefill or batch_invariant, length,
                         lengths, offset, bias_blk, bias, window, bias_blk_win, bias_win)


def layer_attention(plan: AttentionPlan, cache, li: int, q, k, v, scale: float,
                    dtype, window: Optional[int] = None) -> torch.Tensor:
    """Layer ``li``'s attention: ``q`` [B, S, H, D] and ``k``/``v`` [B, S,
    Hkv, D] fresh projections (positions applied) are written into the
    cache in place and attended to with the prefix, by the path ``plan``
    chose. ``window`` (the plan's): the query at position t sees positions
    > t - window only; None: every position before it. Returns ctx [B, S,
    H * D] in ``dtype``."""
    b, s, n_heads, head_dim = q.shape
    n_kv = k.shape[2]
    bias_blk, bias, w = plan.bias_blk, plan.bias, 0
    if window is not None:
        if window != plan.window:
            raise ValueError(f"window {window}: the plan was built for {plan.window}")
        bias_blk, bias, w = plan.bias_blk_win, plan.bias_win, window
    if plan.paged:
        slices = paged_cache.layer_slices(cache, li)
        if plan.use_flash:
            return paged_flash_layer_attention(q, k, v, slices, cache.block_tables, plan.lengths,
                                               bias_blk, scale, plan.batch_invariant, w)
    else:
        slices = layer_slices(cache, li)
        if plan.use_flash:
            return flash_layer_attention(q, k, v, slices, plan.write_at, plan.lengths,
                                         bias_blk, scale, w)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    if plan.paged_prefill:
        # empty rows: the new block attends to itself only
        paged_cache.paged_write_layer(slices, cache.block_tables, plan.lengths, kh, vh)
        k_all, v_all, att_bias = kh, vh, bias_blk[:, None]
    elif plan.paged:
        k_all, v_all = paged_cache.paged_update_and_read_layer(
            slices, cache.block_tables, plan.lengths, kh, vh, dtype)
        att_bias = bias
    else:
        _, k_all, v_all = update_and_read_layer(slices, plan.write_at, kh, vh, dtype)
        att_bias = bias
    qh = q.transpose(1, 2).reshape(b, n_kv, n_heads // n_kv, s, head_dim)
    scores = torch.einsum("bhgsd,bhtd->bhgst", qh.float(), k_all.float())
    scores = scores * scale + att_bias[:, :, None]
    probs = torch.softmax(scores, dim=-1).to(dtype)
    ctx = torch.einsum("bhgst,bhtd->bhgsd", probs.float(), v_all.float())
    ctx = ctx.to(dtype).reshape(b, n_heads, s, head_dim)
    return ctx.transpose(1, 2).reshape(b, s, n_heads * head_dim)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, mesh, dtype) -> torch.Tensor:
    """Embedding rows of ``tokens`` in ``dtype``. On a vocab-parallel shard
    (``mesh``), this rank's rows ``[V/tp]`` give the ids in its range and
    zeros elsewhere, summed over tp in fp32: each sum has one nonzero term,
    so it is exact."""
    if mesh is None:
        return embed[tokens].to(dtype)
    n = embed.shape[0]
    local = tokens - mesh.tp_rank * n
    hit = (local >= 0) & (local < n)
    rows = embed[local.clamp(0, n - 1)].float()
    rows = torch.where(hit[..., None], rows, torch.zeros((), device=rows.device))
    return all_reduce(rows, mesh).to(dtype)


def advance(plan: AttentionPlan, cache, s: int):
    """The cache after a forward of ``s`` tokens: length (or every row's
    device length) += s."""
    if plan.length is None:
        return dataclasses.replace(cache, lengths=plan.lengths + s)
    return dataclasses.replace(cache, length=plan.length + s)


def forward(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    cache,
    positions: Optional[torch.Tensor] = None,
    tree_mask: Optional[torch.Tensor] = None,
    paged_prefill: bool = False,
    batch_invariant: bool = False,
    tp_mesh=None,
) -> Tuple[torch.Tensor, object]:
    """Run the decoder over ``tokens`` [B, S] given ``cache``.

    Writes the S new positions' k/v at the cache's length (in place) and
    returns (logits [B, S, V] float32, cache with length += S). A paged
    cache, or a contiguous one with per-row ``lengths``, advances every
    row's length on the device; each row's positions start at its length.

    ``paged_prefill=True`` (paged caches only) declares every row empty
    (lengths 0): attention runs block-only over the new tokens, as the JAX
    package's admission prefill does, and reads nothing from the pools. Its
    W8A16 calls are planned batch-invariant, so a request's prefill gives
    the same bits whatever requests are admitted with it.
    ``batch_invariant=True`` plans B1, the dense head and the paged kernel
    batch-invariant on any block (the prefix cache's extend windows).

    A tree sharded over a tensor-parallel mesh (``parallel/sharding.py``)
    runs this rank's heads, MLP columns and vocab rows against a cache at
    its kv heads: the embedding and the row-parallel ``wo``/``w_down``
    (fp32 partials) are summed over tp. The logits are the full vocab
    (gathered), or with ``tp_mesh`` this rank's vocab slice, as
    ``ops/sampling.py::norm_logits_topk_tp`` takes them
    (``parallel/comm.py::logits_over``)."""
    b, s = tokens.shape
    dev = tokens.device
    dtype = cfg.torch_dtype
    mesh = mesh_of(params)
    n_heads, n_kv = local_heads(cfg, mesh)
    layers = unstack_layers(params)["layers"]
    plan = attention_plan(cache, s, b, dev, cfg.flash, tree_mask, paged_prefill, batch_invariant)
    if positions is None:
        positions = (plan.offset + torch.arange(s, device=dev)[None]).expand(b, s)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, cfg.max_position)

    h = embed_tokens(params["embed"], tokens, mesh, dtype)
    scale = 1.0 / math.sqrt(cfg.head_dim)

    lin = functools.partial(linear, batch_invariant=plan.batch_invariant)
    row = lin if mesh is None else (
        lambda x, w: row_parallel(lin(x, w, out_dtype=torch.float32), mesh, dtype))
    for li, lp in enumerate(layers):
        r = rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps)
        q = lin(r, lp["wq"], lp.get("bq")).reshape(b, s, n_heads, cfg.head_dim)
        k = lin(r, lp["wk"], lp.get("bk")).reshape(b, s, n_kv, cfg.head_dim)
        v = lin(r, lp["wv"], lp.get("bv")).reshape(b, s, n_kv, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        ctx = layer_attention(plan, cache, li, q, k, v, scale, dtype)
        h = h + row(ctx, lp["wo"])

        r = rms_norm(h, lp["ln_mlp"], cfg.rms_norm_eps)
        gate = torch.nn.functional.silu(lin(r, lp["w_gate"]).float()).to(dtype)
        up = lin(r, lp["w_up"])
        h = h + row(gate * up, lp["w_down"])

    h = rms_norm(h, params["ln_final"], cfg.rms_norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = lm_head_logits(h, head, batch_invariant=plan.batch_invariant)
    return logits_over(logits, mesh, tp_mesh), advance(plan, cache, s)


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Random init (tests and benchmarks without checkpoints)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    h, i, v, n = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    kvh = cfg.num_kv_heads * cfg.head_dim

    def rnd(shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.02).to(dt)

    layers = {
        "wq": rnd((n, h, h)), "wk": rnd((n, h, kvh)), "wv": rnd((n, h, kvh)),
        "wo": rnd((n, h, h)), "w_gate": rnd((n, h, i)), "w_up": rnd((n, h, i)),
        "w_down": rnd((n, i, h)),
        "ln_attn": torch.ones((n, h), dtype=dt, device=dev),
        "ln_mlp": torch.ones((n, h), dtype=dt, device=dev),
    }
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((n, h), dtype=dt, device=dev)
        layers["bk"] = torch.zeros((n, kvh), dtype=dt, device=dev)
        layers["bv"] = torch.zeros((n, kvh), dtype=dt, device=dev)
    params = {"embed": rnd((v, h)), "layers": layers,
              "ln_final": torch.ones((h,), dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = rnd((v, h))
    return params
