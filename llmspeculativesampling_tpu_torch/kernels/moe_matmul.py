"""B4: the grouped W8A16 product of a routed expert layer, and the
routing's alignment that feeds it (``csrc/moe_matmul.cu``).

It replaces no TPU kernel: the JAX package has no expert layer. It exists
because one B1 call per expert cannot be captured in the port's serving
steps (the rows each expert gets change from step to step) and would be
5,376 launches a Mellum 2 forward. Its source note says what bounds it:
the expert weights' bytes at the serving verify, operations at a long
prefill.

:func:`expert_align` sorts a forward's (token, expert) pairs by expert into
a static worst-case number of slots, each expert's segment padded to the
row tile (:func:`row_tile`), as vLLM's ``moe_align_block_size`` does, and
adds each expert's pairs to a per-(layer, expert) total. :func:`grouped_int8_matmul`
runs every live tile's rows (gathered into expert order by the caller)
against its expert's int8 codes and scales. Neither reads anything back to
the host, so both can be captured in a CUDA graph.

CUDA tensors launch the kernels or raise; CPU tensors take the plain
versions (:func:`expert_align_ref`, :func:`grouped_int8_matmul_ref`), which
are the oracles the kernels are held against. ``expert_align.launches``
and ``grouped_int8_matmul.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .int8_matmul import int8_matmul_ref

ROW_TILES = (64, 128)
BK = 64  # k-rows of a pipeline chunk: an expert's K is a multiple of it on the card


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_tile(pairs: int, experts: int) -> int:
    """The row tile of a forward with ``pairs`` (token, expert) pairs: 64
    while the mean expert gets at most 64 rows (the verify), else 128 (a
    prefill), so an expert's weights are read by few tiles."""
    return ROW_TILES[0] if pairs <= ROW_TILES[0] * experts else ROW_TILES[1]


def slot_count(pairs: int, experts: int, mt: int) -> int:
    """Slots of the worst case: every expert's segment padded by mt - 1."""
    return _cdiv(pairs + experts * (mt - 1), mt) * mt


class Routing(NamedTuple):
    """One forward's pairs in expert order: ``rows`` int32 [slots], the token
    row each slot reads (0 for a pad slot, whose output is never read);
    ``inv`` int32 [T * k], the slot of pair (token t, choice j) at t * k +
    j; ``tile_expert`` int32 [slots / mt], each row tile's expert; ``live``
    int32 [1], the tiles in use; ``mt`` the row tile."""

    rows: torch.Tensor
    inv: torch.Tensor
    tile_expert: torch.Tensor
    live: torch.Tensor
    mt: int


def expert_align_ref(ids: torch.Tensor, experts: int, mt: int,
                     totals: Optional[torch.Tensor] = None) -> Routing:
    """Plain version (CPU): pairs sorted stably by expert."""
    t, k = ids.shape
    flat = ids.reshape(-1).long()
    n = flat.numel()
    counts = torch.bincount(flat, minlength=experts)
    padded = (counts + mt - 1) // mt * mt
    seg = torch.cumsum(padded, 0) - padded
    first = torch.cumsum(counts, 0) - counts
    order = torch.argsort(flat, stable=True)
    e_sorted = flat[order]
    inv = torch.empty(n, dtype=torch.long)
    inv[order] = seg[e_sorted] + torch.arange(n) - first[e_sorted]
    slots = slot_count(n, experts, mt)
    rows = torch.zeros(slots, dtype=torch.int32)
    rows[inv] = (torch.arange(n) // k).int()
    live = int(padded.sum()) // mt
    tile_expert = torch.zeros(slots // mt, dtype=torch.int32)
    tile_expert[:live] = torch.repeat_interleave(torch.arange(experts), padded // mt).int()
    if totals is not None:
        totals += counts.to(totals.dtype)
    return Routing(rows, inv.int(), tile_expert, torch.tensor([live], dtype=torch.int32), mt)


def expert_align(ids: torch.Tensor, experts: int, mt: int,
                 totals: Optional[torch.Tensor] = None) -> Routing:
    """``ids`` int64 [T, k] (each token's experts, distinct) -> the
    :class:`Routing` of row tile ``mt``; adds each expert's pair count to
    ``totals`` int64 [E] in the same launch when given."""
    if ids.device.type == "cpu":
        return expert_align_ref(ids, experts, mt, totals)
    if ids.device.type != "cuda":
        raise ValueError(f"unsupported device {ids.device}")
    t, k = ids.shape
    n, dev = t * k, ids.device
    slots = slot_count(n, experts, mt)
    rows = torch.empty(slots, dtype=torch.int32, device=dev)
    inv = torch.empty(n, dtype=torch.int32, device=dev)
    tile_expert = torch.empty(slots // mt, dtype=torch.int32, device=dev)
    live = torch.empty(1, dtype=torch.int32, device=dev)
    if totals is not None and (totals.dtype != torch.int64 or totals.numel() != experts
                               or not totals.is_contiguous() or totals.device != dev):
        raise ValueError("totals must be a contiguous int64 [E] on ids' device")
    ids = ids.to(torch.int64).contiguous()
    err = _lib().expert_align(ids.data_ptr(), n, k, experts, mt, slots, rows.data_ptr(),
                              inv.data_ptr(), tile_expert.data_ptr(), live.data_ptr(),
                              totals.data_ptr() if totals is not None else None,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "expert_align")
    expert_align.launches += 1
    return Routing(rows, inv, tile_expert, live, mt)


def grouped_int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                            routing: Routing, out_dtype=None) -> torch.Tensor:
    """Plain version (CPU): each live tile's rows through B1's plain version
    with its expert's codes and scales; rows of dead tiles are 0."""
    mt = routing.mt
    out = torch.zeros((x.shape[0], w_q.shape[-1]), dtype=out_dtype or x.dtype)
    for tile in range(int(routing.live[0])):
        e = int(routing.tile_expert[tile])
        rows = slice(tile * mt, (tile + 1) * mt)
        out[rows] = int8_matmul_ref(x[rows], w_q[e], scale[e], out_dtype)
    return out


def grouped_int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                        routing: Routing, out_dtype=None) -> torch.Tensor:
    """``x`` [slots, K] in expert order (``x[routing.rows]``), ``w_q`` int8
    [E, K, N], ``scale`` [E, N] -> [slots, N] in ``out_dtype`` (x's dtype by
    default; float32 keeps the sums unrounded): the rows of each live tile
    through its expert's dequantized weight; rows of dead tiles are left
    unwritten on the card."""
    if x.device.type == "cpu":
        return grouped_int8_matmul_ref(x, w_q, scale, routing, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _build.refuse_grad("grouped_int8_matmul", x, scale)
    out_dtype = out_dtype or x.dtype
    m, k = x.shape
    e, _, n = w_q.shape
    if w_q.dtype != torch.int8:
        raise NotImplementedError(f"B4 takes int8 weights, got {w_q.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the output must be bfloat16 or float32, got {out_dtype}")
    if k % BK or n % 16 or m != routing.rows.numel() or m % routing.mt:
        raise ValueError(f"B4 needs K % {BK} == 0, N % 16 == 0 and the routing's slots; got "
                         f"K={k} N={n} M={m}")
    xb = x.to(torch.bfloat16).contiguous()
    w = w_q.contiguous()
    s = scale.to(torch.float32).contiguous()
    if xb.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w_q must be 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = _lib().expert_matmul(xb.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                               routing.tile_expert.data_ptr(), routing.live.data_ptr(), m, k, n,
                               e, routing.mt, int(out_dtype == torch.float32),
                               torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "expert_matmul")
    grouped_int8_matmul.launches += 1
    return out


def _lib():
    lib = _build.load("moe_matmul")
    if not lib.expert_matmul.argtypes:
        lib.expert_init.restype = ctypes.c_int
        _build.check(lib.expert_init(), "expert_init")  # shared-memory limits, once per load
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.expert_align.argtypes = [p, i, i, i, i, i, p, p, p, p, p, p]
        lib.expert_matmul.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.expert_align.restype = lib.expert_matmul.restype = ctypes.c_int
    return lib


expert_align.launches = 0
grouped_int8_matmul.launches = 0
