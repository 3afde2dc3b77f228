"""Static-shape KV cache with O(1) rollback
(counterpart of ``llmspeculativesampling_tpu/cache/kvcache.py``).

* ``k``/``v`` are fixed ``[L, B, H_kv, S_max, D]`` buffers allocated once;
  the int8 variant holds int8 ``k_q``/``v_q`` and fp32 per-(b, h, position)
  scales ``[L, B, H_kv, S_max]``.
* ``length`` is a host int: positions ``>= length`` are dead. Rollback
  replaces the pointer and moves no data. The engines' host loops know
  every length, so no device round trip is needed to read it.
* Unlike the JAX package, whose arrays are immutable, writes go **in
  place** into the preallocated buffers: a cache returned by
  :func:`rollback` or by a forward shares its buffers with the cache it
  came from.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.config import resolve_device


@dataclasses.dataclass
class KVCache:
    """``k``/``v``: [num_layers, batch, kv_heads, max_len, head_dim]."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[1]


@dataclasses.dataclass
class QuantKVCache:
    """Int8 KV cache: int8 ``k_q``/``v_q`` [L, B, H_kv, S_max, D] and fp32
    scales ``k_s``/``v_s`` [L, B, H_kv, S_max]."""

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_s: torch.Tensor
    v_s: torch.Tensor
    length: int

    @property
    def max_len(self) -> int:
        return self.k_q.shape[3]

    @property
    def batch(self) -> int:
        return self.k_q.shape[1]


def init_cache(num_layers, batch, num_kv_heads, max_len, head_dim,
               dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
    dev = resolve_device(device)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev), 0)


def init_quant_cache(num_layers, batch, num_kv_heads, max_len, head_dim,
                     device=None) -> QuantKVCache:
    shape = (num_layers, batch, num_kv_heads, max_len, head_dim)
    dev = resolve_device(device)
    return QuantKVCache(
        k_q=torch.zeros(shape, dtype=torch.int8, device=dev),
        v_q=torch.zeros(shape, dtype=torch.int8, device=dev),
        k_s=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        v_s=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        length=0,
    )


def rollback(cache, new_length: int):
    """Truncate to ``new_length`` positions: only the pointer moves."""
    return dataclasses.replace(cache, length=int(new_length))


def kv_buffers(cache) -> tuple:
    """The cache's buffers: dense (k, v); int8 (k_q, v_q, k_s, v_s). Every
    buffer has positions on dim 3."""
    if isinstance(cache, QuantKVCache):
        return (cache.k_q, cache.v_q, cache.k_s, cache.v_s)
    return (cache.k, cache.v)


def read_positions(cache, start: int, size: int) -> tuple:
    """Copies of positions [start, start+size) of every buffer (the window
    clamped into the cache, as ``dynamic_slice`` does)."""
    st = _start(start, size, cache.max_len)
    return tuple(b[:, :, :, st:st + size].clone() for b in kv_buffers(cache))


def write_positions(cache, parts: tuple, start: int):
    """Write ``parts`` (one per buffer, as :func:`read_positions` returns)
    at ``start`` of every buffer, in place."""
    for buf, part in zip(kv_buffers(cache), parts):
        st = _start(start, part.shape[3], buf.shape[3])
        buf[:, :, :, st:st + part.shape[3]] = part.to(buf.dtype)
    return cache


def compact_tree_paths(cache, path_idx: torch.Tensor, path_valid: torch.Tensor, prefix_len: int,
                       new_length: Optional[int] = None):
    """Compact a tree-layout tail to one accepted path per row, in place.

    Positions ``< prefix_len`` stay; output tail slot j of row b takes the
    k/v (and scales) of tail offset ``path_idx[b, j]``, zeroed where
    ``path_valid[b, j]`` is false, written at ``prefix_len + j``. The new
    length is ``prefix_len + sum(path_valid[0])``: pass it as
    ``new_length`` when the host knows it, or the count is read from the
    device. ``path_idx`` int [B, T], ``path_valid`` bool [B, T]."""
    t = path_idx.shape[1]
    dev = kv_buffers(cache)[0].device
    src = prefix_len + path_idx.to(device=dev, dtype=torch.long)  # [B, T] absolute
    rows = torch.arange(src.shape[0], device=dev)[:, None].expand_as(src)
    valid = path_valid.to(device=dev, dtype=torch.bool)
    st = _start(prefix_len, t, cache.max_len)
    for buf in kv_buffers(cache):
        g = buf[:, rows, :, src]  # [B, T, L, H(, D)]
        g = g.permute(2, 0, 3, 1, 4) if buf.dim() == 5 else g.permute(2, 0, 3, 1)
        mask = valid[None, :, None, :, None] if buf.dim() == 5 else valid[None, :, None, :]
        buf[:, :, :, st:st + t] = torch.where(mask, g, torch.zeros((), dtype=buf.dtype, device=dev))
    if new_length is None:
        new_length = prefix_len + int(valid[0].sum())
    return rollback(cache, new_length)


def _map_kv(cache, fn):
    if isinstance(cache, QuantKVCache):
        return QuantKVCache(fn(cache.k_q), fn(cache.v_q), fn(cache.k_s), fn(cache.v_s), cache.length)
    return KVCache(fn(cache.k), fn(cache.v), cache.length)


def select_rows(cache, row_idx: torch.Tensor):
    """Gather/duplicate batch rows (a new cache; buffers are copied)."""
    idx = row_idx.to(dtype=torch.long, device=(cache.k_q if isinstance(cache, QuantKVCache) else cache.k).device)
    return _map_kv(cache, lambda x: x.index_select(1, idx))


def repeat_rows(cache, repeats: int):
    """Duplicate every row ``repeats`` times (a new cache)."""
    return _map_kv(cache, lambda x: x.repeat_interleave(repeats, dim=1))


def _start(start: int, s: int, s_max: int) -> int:
    # dynamic_update_slice semantics: the window is clamped to fit
    return max(0, min(int(start), s_max - s))


def write_layer(cache_k_l, cache_v_l, start: int, k_new, v_new) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ``S`` new positions of one layer at ``start``, in place.

    ``cache_[kv]_l``: [B, H_kv, S_max, D]; ``[kv]_new``: [B, H_kv, S, D]."""
    s = k_new.shape[2]
    st = _start(start, s, cache_k_l.shape[2])
    cache_k_l[:, :, st:st + s] = k_new.to(cache_k_l.dtype)
    cache_v_l[:, :, st:st + s] = v_new.to(cache_v_l.dtype)
    return cache_k_l, cache_v_l


def _quantize_kv(x: torch.Tensor):
    """Per-(b, h, position) symmetric int8 over the head_dim axis."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def write_layer_quant(k_q_l, k_s_l, v_q_l, v_s_l, start: int, k_new, v_new):
    """Quantize and write ``S`` new positions of one layer, in place."""
    s = k_new.shape[2]
    st = _start(start, s, k_q_l.shape[2])
    kq, ks = _quantize_kv(k_new)
    vq, vs = _quantize_kv(v_new)
    k_q_l[:, :, st:st + s] = kq
    v_q_l[:, :, st:st + s] = vq
    k_s_l[:, :, st:st + s] = ks
    v_s_l[:, :, st:st + s] = vs
    return k_q_l, k_s_l, v_q_l, v_s_l


def dequant_layer(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s[..., None]).to(dtype)


def layer_slices(cache, layer: int):
    """One layer's buffers (views): dense (k, v); int8 (k_q, k_s, v_q, v_s)."""
    if isinstance(cache, QuantKVCache):
        return (cache.k_q[layer], cache.k_s[layer], cache.v_q[layer], cache.v_s[layer])
    return (cache.k[layer], cache.v[layer])


def update_and_read_layer(slices, length: int, k_new, v_new, dtype):
    """Write the new block, then return (slices, k_all, v_all) with k_all/v_all
    in compute dtype [B, H, S_max, D]."""
    if len(slices) == 4:
        k_q_l, k_s_l, v_q_l, v_s_l = write_layer_quant(*slices, length, k_new, v_new)
        return slices, dequant_layer(k_q_l, k_s_l, dtype), dequant_layer(v_q_l, v_s_l, dtype)
    k_l, v_l = write_layer(slices[0], slices[1], length, k_new, v_new)
    return slices, k_l, v_l
