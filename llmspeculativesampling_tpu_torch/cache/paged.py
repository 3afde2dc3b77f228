"""Paged KV cache: a shared block pool plus per-row block tables
(counterpart of ``llmspeculativesampling_tpu/cache/paged.py``).

Layout (per model):
  * pools ``k``/``v``: ``[L, N+1, H_kv, page, D]`` (the int8 variant holds
    int8 ``k_q``/``v_q`` and fp32 per-position scales ``[L, N+1, H_kv,
    page]``), allocated once;
  * ``block_tables``: ``[B, max_pages]`` int32 on the device: position ``p``
    of row ``b`` lives in block ``block_tables[b, p // page]`` at offset
    ``p % page``;
  * ``lengths``: ``[B]`` int32 on the device, the per-row live positions
    (rollback moves only this pointer).

Block ``N`` is the **trash block**, the port's form of the JAX package's
out-of-range sentinel. JAX drops a scatter to block ``N`` (``mode="drop"``)
and clips a gather; in PyTorch an out-of-range index is an error (on the
card a device-side assert), so every write that JAX would drop lands in the
trash block instead: rows whose table holds the sentinel (dead rows, unused
table slots) and positions past the table's width. No live row reads it,
because reads stop at ``lengths[b]`` and a live row's blocks below its
length are real.

Unlike the JAX package, pool writes go **in place**, one layer at a time,
before that layer's attention: the paged kernel reads the new block from
``k_new``/``v_new`` and never reads positions ``>= lengths[b]``, so the
deferred all-layers write (``paged_write_layers``), which exists for XLA's
buffer aliasing, has no counterpart here.

The block allocator (:class:`PageAllocator`) is host-side, as in JAX.
``SharedPageAllocator`` and ``prompt_page_hashes`` (the prefix cache) are
not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import resolve_device
from ..kernels.paged_flash_decode import gather_pages
from .kvcache import _quantize_kv


@dataclasses.dataclass
class PagedKVCache:
    """Dense paged cache. ``k``/``v``: [L, N+1, H_kv, page, D] (block N is
    the trash block); ``block_tables``: [B, max_pages] int32;
    ``lengths``: [B] int32."""

    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor

    @property
    def page(self) -> int:
        return self.k.shape[3]

    @property
    def num_blocks(self) -> int:
        """Allocatable blocks (the trash block excluded); also the sentinel id."""
        return self.k.shape[1] - 1

    @property
    def max_pages(self) -> int:
        return self.block_tables.shape[1]


@dataclasses.dataclass
class QuantPagedKVCache:
    """Int8 paged cache: int8 pools plus fp32 per-(block, head, position)
    scales; same table/length semantics as :class:`PagedKVCache`."""

    k_q: torch.Tensor  # [L, N+1, H, page, D] int8
    v_q: torch.Tensor
    k_s: torch.Tensor  # [L, N+1, H, page] f32
    v_s: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor

    @property
    def page(self) -> int:
        return self.k_q.shape[3]

    @property
    def num_blocks(self) -> int:
        return self.k_q.shape[1] - 1

    @property
    def max_pages(self) -> int:
        return self.block_tables.shape[1]


def init_paged_cache(num_layers: int, num_blocks: int, num_kv_heads: int, page: int,
                     head_dim: int, batch: int, max_pages: int, dtype=torch.bfloat16,
                     quant: bool = False, device=None):
    """Allocate the pool (``num_blocks`` blocks plus the trash block) and an
    all-sentinel table."""
    dev = resolve_device(device)
    shape = (num_layers, num_blocks + 1, num_kv_heads, page, head_dim)
    tables = torch.full((batch, max_pages), num_blocks, dtype=torch.int32, device=dev)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if quant:
        return QuantPagedKVCache(
            k_q=torch.zeros(shape, dtype=torch.int8, device=dev),
            v_q=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_s=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            v_s=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            block_tables=tables, lengths=lengths,
        )
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=dtype, device=dev), tables, lengths)


def is_paged(cache) -> bool:
    return isinstance(cache, (PagedKVCache, QuantPagedKVCache))


def rollback_rows(cache, new_lengths):
    """Per-row truncation: only the length pointers move."""
    lens = torch.as_tensor(new_lengths, device=cache.lengths.device).to(torch.int32)
    return dataclasses.replace(cache, lengths=lens)


def set_row_table(cache, row: int, table_row, length: int):
    """Install a request's block table (``[max_pages]``, sentinel-padded)
    into ``row`` and reset its length, in place; returns the cache."""
    cache.block_tables[row] = torch.as_tensor(np.asarray(table_row), dtype=torch.int32)
    cache.lengths[row] = int(length)
    return cache


def layer_slices(cache, layer: int):
    """One layer's pools (views): dense (k, v); int8 (k_q, k_s, v_q, v_s)."""
    if isinstance(cache, QuantPagedKVCache):
        return (cache.k_q[layer], cache.k_s[layer], cache.v_q[layer], cache.v_s[layer])
    return (cache.k[layer], cache.v[layer])


def _dest_indices(block_tables: torch.Tensor, lengths: torch.Tensor, s_new: int, page: int,
                  trash: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(blk [B, S], off [B, S]) pool coordinates of every row's next
    ``s_new`` positions. Sentinel entries and positions past the table's
    width map to the trash block (the writes JAX drops)."""
    pos = lengths.long()[:, None] + torch.arange(s_new, device=lengths.device)[None, :]
    pidx = pos // page
    width = block_tables.shape[1]
    blk = torch.gather(block_tables.long(), 1, pidx.clamp(0, width - 1))
    blk = torch.where(pidx < width, blk, torch.full_like(blk, trash)).clamp(0, trash)
    return blk, pos % page


def paged_write_layer(slices, block_tables, lengths, k_new, v_new) -> None:
    """Write one layer's new block ``[B, H, S, D]`` at each row's next S
    positions, in place (int8 pools quantize per position over D)."""
    _, h, s, _ = k_new.shape
    page = slices[0].shape[2]
    blk, off = _dest_indices(block_tables, lengths, s, page, slices[0].shape[0] - 1)
    idx = (blk[:, :, None], torch.arange(h, device=blk.device)[None, None, :], off[:, :, None])
    kt, vt = k_new.transpose(1, 2), v_new.transpose(1, 2)  # [B, S, H, D]
    if len(slices) == 4:
        k_q, k_s, v_q, v_s = slices
        kq, ks = _quantize_kv(kt)
        vq, vs = _quantize_kv(vt)
        k_q[idx], k_s[idx], v_q[idx], v_s[idx] = kq, ks, vq, vs
    else:
        k_pool, v_pool = slices
        k_pool[idx] = kt.to(k_pool.dtype)
        v_pool[idx] = vt.to(v_pool.dtype)


def paged_update_and_read_layer(slices, block_tables, lengths, k_new, v_new, dtype):
    """The gather path (the reference, and blocks of more than 32 tokens):
    write the new block, then gather each row's pages into a contiguous
    ``[B, H, max_pages*page, D]`` view in ``dtype``. Returns (k_all, v_all)."""
    paged_write_layer(slices, block_tables, lengths, k_new, v_new)
    if len(slices) == 4:
        k_q, k_s, v_q, v_s = slices
        return tuple((gather_pages(q, block_tables).float()
                      * gather_pages(sc, block_tables)[..., None]).to(dtype)
                     for q, sc in ((k_q, k_s), (v_q, v_s)))
    return tuple(gather_pages(pool, block_tables).to(dtype) for pool in slices)


class PageAllocator:
    """Host-side free-list allocator over the pool's block ids. Block id
    ``num_blocks`` (the trash block) is the sentinel for unused table slots."""

    def __init__(self, num_blocks: int, page: int, max_pages: int):
        self.num_blocks = num_blocks
        self.page = page
        self.max_pages = max_pages
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def pages_needed(self, total_len: int) -> int:
        return -(-total_len // self.page)

    def alloc(self, total_len: int) -> Optional[List[int]]:
        """Reserve blocks for ``total_len`` positions; None when the pool
        (or the table width) cannot hold them."""
        n = self.pages_needed(total_len)
        if n > self.max_pages or n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: List[int]) -> None:
        self._free.extend(reversed(blocks))

    def table_row(self, blocks: List[int]) -> np.ndarray:
        row = np.full((self.max_pages,), self.num_blocks, np.int32)
        row[: len(blocks)] = blocks
        return row
