"""Static-shape KV cache with O(1) rollback
(counterpart of ``llmspeculativesampling_tpu/cache/kvcache.py``).

* ``k``/``v`` are fixed ``[L, B, H_kv, S_max, D]`` buffers allocated once;
  the int8 variant holds int8 ``k_q``/``v_q`` and fp32 per-(b, h, position)
  scales ``[L, B, H_kv, S_max]``.
* ``length`` is a host int: positions ``>= length`` are dead. Rollback
  replaces the pointer and moves no data. A host loop that knows every
  length needs no device round trip to read it.
* ``lengths`` (optional) is an int32 ``[B]`` tensor on the device: a cache
  whose rows are independent sequences (the slot engine,
  ``serve/scheduler.py``), or a device-loop state (``engine/device_loop.py``),
  carries one length a row there and never reads it on the host.
  :func:`read_positions`, :func:`write_positions` and
  :func:`compact_tree_paths` also take a device position for the same
  reason. Then ``length`` is unused: writes land at each row's
  length (:func:`write_layer` with a tensor start, one indexed write a
  buffer), :func:`rollback_rows` moves the pointers, and
  :func:`install_rows` copies freshly prefilled rows into place. This is
  the port's form of the JAX slot engine's vmapped per-slot cache.
* Unlike the JAX package, whose arrays are immutable, writes go **in
  place** into the preallocated buffers: a cache returned by
  :func:`rollback` or by a forward shares its buffers with the cache it
  came from. Under autograd a layer's view of the stacked buffers shares
  their version counter, which the next layer's write bumps: what a layer
  attends to is copied first there (:func:`grad_safe`), so a forward
  stays differentiable.
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
    lengths: Optional[torch.Tensor] = None  # int32 [B] per-row lengths, or None

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
    lengths: Optional[torch.Tensor] = None

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


def rollback_rows(cache, new_lengths):
    """Per-row truncation to ``new_lengths`` [B], contiguous or paged: only
    the pointers move. A host-int contiguous cache takes device lengths
    here."""
    dev = kv_buffers(cache)[0].device if cache.lengths is None else cache.lengths.device
    return dataclasses.replace(cache, lengths=torch.as_tensor(new_lengths, device=dev).to(
        torch.int32))


def install_rows(cache, rows: torch.Tensor, fresh) -> None:
    """Copy the first ``len(rows)`` rows of ``fresh`` (a cache of the same
    model, e.g. just prefilled from length 0) into rows ``rows`` of
    ``cache``, positions ``[0, fresh.max_len)``, in place. Later positions
    keep what they held: no row reads past its length."""
    n = rows.shape[0]
    for big, small in zip(kv_buffers(cache), kv_buffers(fresh)):
        big[:, rows, :, :small.shape[3]] = small[:, :n]


def kv_buffers(cache) -> tuple:
    """The cache's buffers: dense (k, v); int8 (k_q, v_q, k_s, v_s). Every
    buffer has positions on dim 3."""
    if isinstance(cache, QuantKVCache):
        return (cache.k_q, cache.v_q, cache.k_s, cache.v_s)
    return (cache.k, cache.v)


def read_positions(cache, start, size: int) -> tuple:
    """Copies of positions [start, start+size) of every buffer (the window
    clamped into the cache, as ``dynamic_slice`` does). ``start`` is a host
    int or a device scalar (no host read: a captured step gathers there)."""
    if isinstance(start, torch.Tensor):
        pos = _window(start, size, cache.max_len)
        return tuple(b.index_select(3, pos) for b in kv_buffers(cache))
    st = _start(start, size, cache.max_len)
    return tuple(b[:, :, :, st:st + size].clone() for b in kv_buffers(cache))


def write_positions(cache, parts: tuple, start, valid: Optional[torch.Tensor] = None):
    """Write ``parts`` (one per buffer, as :func:`read_positions` returns)
    at ``start`` of every buffer, in place (the window clamped, as
    ``dynamic_update_slice`` does). With a device scalar ``start`` the write
    is one ``index_copy_`` a buffer, and ``valid`` (bool [size], optional)
    keeps a position's old value where it is false."""
    for buf, part in zip(kv_buffers(cache), parts):
        size = part.shape[3]
        if isinstance(start, torch.Tensor):
            pos = _window(start, size, buf.shape[3])
            part = part.to(buf.dtype)
            if valid is not None:
                mask = valid.reshape((1, 1, 1, size) + (1,) * (buf.dim() - 4))
                part = torch.where(mask, part, buf.index_select(3, pos))
            buf.index_copy_(3, pos, part)
        else:
            if valid is not None:
                raise ValueError("valid needs a device start")
            st = _start(start, size, buf.shape[3])
            buf[:, :, :, st:st + size] = part.to(buf.dtype)
    return cache


def compact_tree_paths(cache, path_idx: torch.Tensor, path_valid: torch.Tensor, prefix_len,
                       new_length=None):
    """Compact a tree-layout tail to one accepted path per row, in place.

    Positions ``< prefix_len`` stay; output tail slot j of row b takes the
    k/v (and scales) of tail offset ``path_idx[b, j]``, zeroed where
    ``path_valid[b, j]`` is false, written at ``prefix_len + j``.
    ``path_idx`` int [B, T], ``path_valid`` bool [B, T].

    ``prefix_len`` is a host int, or a device scalar (a captured step: the
    window is gathered and written at that position, no host read). The new
    length is ``prefix_len + sum(path_valid[0])``: a host int (pass it as
    ``new_length`` when the host knows it, or the count is read from the
    device), or with a device ``prefix_len`` per-row device lengths
    (``new_length`` a device scalar, or the count of each row's valid
    slots)."""
    t = path_idx.shape[1]
    dev = kv_buffers(cache)[0].device
    on_device = isinstance(prefix_len, torch.Tensor)
    prefix = prefix_len.long().reshape(()) if on_device else prefix_len
    src = prefix + path_idx.to(device=dev, dtype=torch.long)  # [B, T] absolute
    rows = torch.arange(src.shape[0], device=dev)[:, None].expand_as(src)
    valid = path_valid.to(device=dev, dtype=torch.bool)
    pos = _window(prefix, t, cache.max_len) if on_device else None
    st = None if on_device else _start(prefix_len, t, cache.max_len)
    for buf in kv_buffers(cache):
        g = buf[:, rows, :, src]  # [B, T, L, H(, D)]
        g = g.permute(2, 0, 3, 1, 4) if buf.dim() == 5 else g.permute(2, 0, 3, 1)
        mask = valid[None, :, None, :, None] if buf.dim() == 5 else valid[None, :, None, :]
        g = torch.where(mask, g, torch.zeros((), dtype=buf.dtype, device=dev))
        if on_device:
            buf.index_copy_(3, pos, g)
        else:
            buf[:, :, :, st:st + t] = g
    if on_device:
        if new_length is None:
            new_length = prefix + valid.sum(dim=1)
        return rollback_rows(cache, torch.as_tensor(new_length, device=dev).expand(src.shape[0]))
    if new_length is None:
        new_length = prefix_len + int(valid[0].sum())
    return rollback(cache, new_length)


def _map_kv(cache, fn, lengths_fn):
    lengths = None if cache.lengths is None else lengths_fn(cache.lengths)
    if isinstance(cache, QuantKVCache):
        return QuantKVCache(fn(cache.k_q), fn(cache.v_q), fn(cache.k_s), fn(cache.v_s), cache.length,
                            lengths)
    return KVCache(fn(cache.k), fn(cache.v), cache.length, lengths)


def select_rows(cache, row_idx: torch.Tensor):
    """Gather/duplicate batch rows (a new cache; buffers are copied, per-row
    lengths follow their rows)."""
    idx = row_idx.to(dtype=torch.long, device=kv_buffers(cache)[0].device)
    return _map_kv(cache, lambda x: x.index_select(1, idx), lambda n: n.index_select(0, idx))


def select_rows_(cache, row_idx: torch.Tensor, start=None, size: int = 0) -> None:
    """:func:`select_rows` in place: row b of every buffer (and of the
    per-row lengths) takes row ``row_idx[b]``, in the cache's own buffers,
    so a captured step's state keeps its addresses. With ``start`` (a host
    int or a device scalar), only positions ``[start, start+size)`` move
    (clamped into the buffer): below them the selected rows must already
    agree, as they do where one winner was re-broadcast into every row."""
    dev = kv_buffers(cache)[0].device
    idx = row_idx.to(dtype=torch.long, device=dev)
    for buf in kv_buffers(cache):
        if start is None:
            buf.copy_(buf.index_select(1, idx))
        else:
            pos = (torch.as_tensor(start, device=dev).long().reshape(())
                   + torch.arange(size, device=dev)).clamp(0, buf.shape[3] - 1)
            buf.index_copy_(3, pos, buf.index_select(3, pos).index_select(1, idx))
    if cache.lengths is not None:
        cache.lengths.copy_(cache.lengths.index_select(0, idx))


def repeat_rows(cache, repeats: int):
    """Duplicate every row ``repeats`` times (a new cache)."""
    return _map_kv(cache, lambda x: x.repeat_interleave(repeats, dim=1),
                   lambda n: n.repeat_interleave(repeats))


def _start(start: int, s: int, s_max: int) -> int:
    # dynamic_update_slice semantics: the window is clamped to fit
    return max(0, min(int(start), s_max - s))


def _window(start: torch.Tensor, s: int, s_max: int) -> torch.Tensor:
    """The positions [start, start+s) of a device scalar ``start``, the
    window clamped to fit as :func:`_start` clamps a host int (int64 [s])."""
    st = start.long().reshape(()).clamp(0, s_max - s)
    return st + torch.arange(s, device=start.device)


def _write(buf: torch.Tensor, part: torch.Tensor, start) -> None:
    """Write ``part`` [B, H, S(, D)] into ``buf`` [B, H, S_max(, D)] at
    ``start``, in place: a host int (every row), or a per-row int tensor
    [B] on the device (one indexed write). Each row's window is clamped
    into the buffer, as ``dynamic_update_slice`` clamps it (under the JAX
    slot engine's vmap, row by row)."""
    s = part.shape[2]
    if isinstance(start, torch.Tensor):
        st = start.to(device=buf.device, dtype=torch.long).clamp(0, buf.shape[2] - s)
        pos = st[:, None] + torch.arange(s, device=buf.device)[None, :]
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, :, pos] = part.transpose(1, 2).to(buf.dtype)
    else:
        st = _start(start, s, buf.shape[2])
        buf[:, :, st:st + s] = part.to(buf.dtype)


def write_layer(cache_k_l, cache_v_l, start, k_new, v_new) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ``S`` new positions of one layer at ``start`` (a host int, or
    per-row lengths [B] on the device), in place.

    ``cache_[kv]_l``: [B, H_kv, S_max, D]; ``[kv]_new``: [B, H_kv, S, D]."""
    _write(cache_k_l, k_new, start)
    _write(cache_v_l, v_new, start)
    return cache_k_l, cache_v_l


def _quantize_kv(x: torch.Tensor):
    """Per-(b, h, position) symmetric int8 over the head_dim axis."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def write_layer_quant(k_q_l, k_s_l, v_q_l, v_s_l, start, k_new, v_new):
    """Quantize and write ``S`` new positions of one layer at ``start`` (as
    :func:`write_layer`), in place."""
    kq, ks = _quantize_kv(k_new)
    vq, vs = _quantize_kv(v_new)
    for buf, part in ((k_q_l, kq), (v_q_l, vq), (k_s_l, ks), (v_s_l, vs)):
        _write(buf, part, start)
    return k_q_l, k_s_l, v_q_l, v_s_l


def dequant_layer(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s[..., None]).to(dtype)


def layer_slices(cache, layer: int):
    """One layer's buffers (views): dense (k, v); int8 (k_q, k_s, v_q, v_s)."""
    if isinstance(cache, QuantKVCache):
        return (cache.k_q[layer], cache.k_s[layer], cache.v_q[layer], cache.v_s[layer])
    return (cache.k[layer], cache.v[layer])


def grad_safe(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied when grad mode is on and it requires grad. A layer's
    view of the stacked ``[L, ...]`` buffers shares their version counter;
    an op that saves the view for its backward would find it bumped by the
    next layer's in-place write. The copy is saved instead, and the
    gradient still flows through the write into the new block."""
    return t.clone() if torch.is_grad_enabled() and t.requires_grad else t


def update_and_read_layer(slices, length, k_new, v_new, dtype):
    """Write the new block at ``length`` (a host int, or per-row lengths
    [B] on the device), then return (slices, k_all, v_all) with k_all/v_all
    in compute dtype [B, H, S_max, D] (copies under grad, :func:`grad_safe`)."""
    if len(slices) == 4:
        k_q_l, k_s_l, v_q_l, v_s_l = write_layer_quant(*slices, length, k_new, v_new)
        return slices, dequant_layer(k_q_l, k_s_l, dtype), dequant_layer(v_q_l, v_s_l, dtype)
    k_l, v_l = write_layer(slices[0], slices[1], length, k_new, v_new)
    return slices, grad_safe(k_l), grad_safe(v_l)
