"""Paged flash-decode attention: the prefix is read page by page from a
shared block pool through per-row block tables, dense or int8 KV.

Counterpart of ``paged_flash_decode_attention`` in
``llmspeculativesampling_tpu/kernels/flash_decode.py``. The TPU kernel it
replaces is ``_paged_flash_call`` (``pl.pallas_call`` with body
``_make_kernel(paged=True)``); on Hopper it is the ``Paged`` layout of
``csrc/flash_decode.cu``, which shares its split-KV body with the
contiguous kernel; a split never crosses a page and looks its block up
once (``flash_decode.plan`` cuts each page into splits). The TPU-only floors
and workarounds (``page % 128 == 0``, ``page <= 512``, lane folding, the
1-column new-block pad, the q-row pad, pad-to-128 pools) are not carried
over: any page size and any head size of ``HEAD_DIMS`` run.

:func:`paged_flash_decode_attention` launches the CUDA kernel for CUDA
tensors, or raises; :func:`paged_flash_decode_ref`, the plain PyTorch
version, serves CPU tensors and is the oracle.
``paged_flash_decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_decode import flash_decode_ref, launch_common


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[N, H, page, ...] pool (or scales) + [B, P] tables -> each row's pages
    as one contiguous [B, H, P*page, ...] tensor (table ids clamped into the
    pool)."""
    g = pool[tables.long().clamp(0, pool.shape[0] - 1)]  # [B, P, H, page, ...]
    b, p, h, pg = g.shape[:4]
    return g.transpose(1, 2).reshape(b, h, p * pg, *g.shape[4:])


def paged_flash_decode_ref(
    q, k_new, v_new, k_pool, v_pool, block_tables, lengths, block_bias, *,
    scale: float, k_scales=None, v_scales=None,
):
    """Plain version: gather each row's pages into a contiguous view, then
    the contiguous plain version (fp32, scales applied per position)."""
    ks = vs = None
    if k_scales is not None:
        ks, vs = gather_pages(k_scales, block_tables), gather_pages(v_scales, block_tables)
    return flash_decode_ref(
        q, k_new, v_new, gather_pages(k_pool, block_tables), gather_pages(v_pool, block_tables),
        lengths, block_bias, scale=scale, k_scales=ks, v_scales=vs,
    )


def _launch(q, k_new, v_new, k_pool, v_pool, block_tables, lengths, block_bias, scale,
            k_scales, v_scales, batch_invariant=False):
    bsz = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != bsz:
        raise ValueError(f"block tables must be [B={bsz}, P], got {tuple(block_tables.shape)}")
    dev = q.device
    tables = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    lens = lengths.to(device=dev, dtype=torch.int32).reshape(-1).expand(bsz).contiguous()
    out = launch_common(q, k_new, v_new, k_pool, v_pool, lens, block_bias, scale, k_scales,
                        v_scales, page=k_pool.shape[2], pages=tables.shape[1], tables=tables,
                        batch_invariant=batch_invariant)
    paged_flash_decode_attention.launches += 1
    return out


def paged_flash_decode_attention(
    q: torch.Tensor,        # [B, Hq, S_new, D]
    k_new: torch.Tensor,    # [B, Hkv, S_new, D]
    v_new: torch.Tensor,
    k_pool: torch.Tensor,   # [N, Hkv, page, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32: position p of row b -> block [b, p // page]
    lengths: torch.Tensor,       # [B] int32 live prefix positions per row
    block_bias: torch.Tensor,    # [B, S_new, S_new] f32 additive (0 / -1e30)
    *,
    scale: float,
    k_scales: Optional[torch.Tensor] = None,  # [N, Hkv, page] f32 (int8 pool)
    v_scales: Optional[torch.Tensor] = None,
    batch_invariant: bool = False,
) -> torch.Tensor:
    """Context [B, Hq, S_new, D] in q's dtype. Only positions < lengths[b]
    of row b are read; table ids are clamped into the pool. CPU tensors
    take the plain version; CUDA tensors the kernel, whose grid
    ``batch_invariant`` plans without the batch, so a row's bits do not
    depend on the rows beside it (``flash_decode.plan``)."""
    if q.device.type == "cpu":
        return paged_flash_decode_ref(
            q, k_new, v_new, k_pool, v_pool, block_tables, lengths, block_bias,
            scale=scale, k_scales=k_scales, v_scales=v_scales,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_new, v_new, k_pool, v_pool, block_tables, lengths, block_bias, scale,
                   k_scales, v_scales, batch_invariant)


paged_flash_decode_attention.launches = 0
