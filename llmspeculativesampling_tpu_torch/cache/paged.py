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

The block allocators are host-side, as in JAX: :class:`PageAllocator`, a
free list, and :class:`SharedPageAllocator`, which adds the prefix cache
(refcounted pages shared under :func:`prompt_page_hashes`' chained hashes,
freed registered pages parked in an LRU until allocation needs them).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import resolve_device
from ..kernels.paged_flash_decode import gather_pages
from .kvcache import _quantize_kv, rollback_rows  # noqa: F401 (re-exported)


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

    @property
    def available_blocks(self) -> int:
        """Blocks an allocation can take (here the free list; the shared
        allocator adds its parked pages): ``num_blocks`` once every request
        has finished."""
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

    def alloc_one(self) -> Optional[int]:
        """One more block for a growing request (on-demand paging); None
        when the pool is empty."""
        return self._free.pop() if self._free else None

    def free(self, blocks: List[int]) -> None:
        self._free.extend(reversed(blocks))

    def table_row(self, blocks: List[int]) -> np.ndarray:
        row = np.full((self.max_pages,), self.num_blocks, np.int32)
        row[: len(blocks)] = blocks
        return row


def prompt_page_hashes(prompt_ids, page: int, reserve_tail: int = 2) -> List[bytes]:
    """Chained sha256 hashes of a prompt's shareable full pages: page ``i``'s
    hash covers every token before ``(i+1)*page`` (as int32 bytes), so a
    page is shared only under an identical prefix, at the same positions.
    The last ``reserve_tail`` prompt positions are never shareable: the
    paged engine's draft re-feeds from ``cur_len - 2``
    (``serve/paged.py::_draft_phase_batched``), rewriting them in pages the
    request must own."""
    ids = np.asarray(prompt_ids, np.int32).reshape(-1)
    n_shareable = max(ids.shape[0] - reserve_tail, 0) // page
    out: List[bytes] = []
    h = hashlib.sha256()
    for i in range(n_shareable):
        h.update(ids[i * page:(i + 1) * page].tobytes())
        out.append(h.digest())
    return out


class SharedPageAllocator(PageAllocator):
    """Refcounted allocator with a registry of prompt-prefix pages (automatic
    prefix caching). ``lookup`` finds the longest registered chain of a
    prompt's page hashes; ``alloc_shared`` references those blocks instead of
    recomputing their KV. A registered block whose last reference is freed
    parks in an LRU *evictable* pool and is reclaimed only when an
    allocation finds the free list empty, so a hot system prompt's KV
    outlives its requests."""

    def __init__(self, num_blocks: int, page: int, max_pages: int):
        super().__init__(num_blocks, page, max_pages)
        self._ref = {}          # block -> live references
        self._by_hash = {}      # page-chain hash -> block
        self._block_hash = {}   # block -> its registry hash
        self._evictable = {}    # block -> None; insertion order = LRU order
        self.hits = 0           # pages served from the registry
        self.misses = 0         # shareable pages that had to be computed

    @property
    def available_blocks(self) -> int:
        return len(self._free) + len(self._evictable)

    def _take_block(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if self._evictable:
            blk = next(iter(self._evictable))  # least recently parked
            del self._evictable[blk]
            h = self._block_hash.pop(blk, None)
            if h is not None:
                self._by_hash.pop(h, None)
            return blk
        return None

    def lookup(self, hashes: List[bytes]) -> List[int]:
        """Blocks of the longest prefix of ``hashes`` in the registry."""
        chain: List[int] = []
        for h in hashes:
            blk = self._by_hash.get(h)
            if blk is None:
                break
            chain.append(blk)
        return chain

    def alloc_shared(self, total_len: int,
                     hashes: List[bytes]) -> Optional[Tuple[List[int], int]]:
        """Pages for ``total_len`` positions, the longest registered chain of
        ``hashes`` shared: ``(blocks, cached_len)``, whose first
        ``cached_len // page`` blocks already hold the prefix's KV. None
        when the table width or the pool cannot hold the rest."""
        n = self.pages_needed(total_len)
        if n > self.max_pages:
            return None
        shared = self.lookup(hashes)[:n]
        n_own = n - len(shared)
        if n_own > self.available_blocks:
            return None
        blocks = []
        for blk in shared:
            self._evictable.pop(blk, None)  # revived if parked
            self._ref[blk] = self._ref.get(blk, 0) + 1
            blocks.append(blk)
        for _ in range(n_own):
            blk = self._take_block()
            self._ref[blk] = 1
            blocks.append(blk)
        self.hits += len(shared)
        self.misses += max(min(len(hashes), n) - len(shared), 0)
        return blocks, len(shared) * self.page

    def alloc(self, total_len: int) -> Optional[List[int]]:
        got = self.alloc_shared(total_len, [])
        return got[0] if got is not None else None

    def alloc_one(self) -> Optional[int]:
        """One more block for a growing request; may evict a parked page."""
        blk = self._take_block()
        if blk is not None:
            self._ref[blk] = 1
        return blk

    def register(self, hashes: List[bytes], blocks: List[int]) -> None:
        """Publish a request's computed prefix pages (``blocks[i]`` holds the
        page of chain hash ``hashes[i]``). The first writer wins: a
        concurrent identical prompt keeps its copy unpublished."""
        for h, blk in zip(hashes, blocks):
            if h in self._by_hash or blk in self._block_hash:
                continue
            self._by_hash[h] = blk
            self._block_hash[blk] = h

    def free(self, blocks: List[int]) -> None:
        """Drop one reference a block; a registered block whose last
        reference goes parks as the most recently used evictable page."""
        for blk in blocks:
            r = self._ref.get(blk, 1) - 1
            if r > 0:
                self._ref[blk] = r
                continue
            self._ref.pop(blk, None)
            if blk in self._block_hash:
                self._evictable.pop(blk, None)
                self._evictable[blk] = None
            else:
                self._free.append(blk)
