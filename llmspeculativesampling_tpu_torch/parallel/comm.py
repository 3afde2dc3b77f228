"""The tensor-parallel collectives (no JAX counterpart: GSPMD inserts these
for the JAX package from the sharding annotations).

Two primitives only, ``all_reduce`` and ``broadcast``, so that the same
code runs under NCCL (one card a rank) and under gloo, which takes CUDA
tensors for just these two: that is how two ranks share one card, where
NCCL refuses to run. A gather is an all_reduce of a zero-filled buffer in
which each rank writes its own slot, exact for values and integer ids
alike (every sum has one nonzero term).

A failed collective raises :class:`CollectiveError`, so a caller can tell a
lost peer from its own errors (``serve/multihost.py``). ``COUNTS`` holds the
calls and the elements moved per primitive, for the tests.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.distributed as dist

COUNTS = collections.defaultdict(lambda: [0, 0])  # op -> [calls, elements]


class CollectiveError(RuntimeError):
    """A collective failed in the transport: a peer is gone or unreachable."""


def reset_counts() -> None:
    COUNTS.clear()


def _run(op: str, fn, x: torch.Tensor, group) -> None:
    c = COUNTS[op]
    c[0] += 1
    c[1] += x.numel()
    try:
        fn(x, group=group)
    except (RuntimeError, OSError) as e:
        raise CollectiveError(f"{op} failed: {e}") from e


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``x`` over the tp group of ``mesh``, in place; returns ``x``. A
    no-op without a mesh or at tp 1."""
    if mesh is None or mesh.tp == 1:
        return x
    _run("all_reduce", dist.all_reduce, x, mesh.tp_group)
    return x


def broadcast(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` from global rank 0 to every rank of ``group``, in place."""
    _run("broadcast", lambda t, group: dist.broadcast(t, 0, group=group), x, group)
    return x


def gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every tp rank's ``x`` [..., n] along the last axis in
    rank order -> [..., tp * n] on every rank."""
    if mesh is None or mesh.tp == 1:
        return x
    buf = x.new_zeros(x.shape[:-1] + (mesh.tp, x.shape[-1]))
    buf[..., mesh.tp_rank, :] = x
    return all_reduce(buf, mesh).reshape(*x.shape[:-1], -1)


def vocab_slice(logits: torch.Tensor, mesh) -> torch.Tensor:
    """This tp rank's contiguous slice of full-vocab ``logits`` (a view)."""
    n = logits.shape[-1] // mesh.tp
    return logits.narrow(-1, mesh.tp_rank * n, n)


def logits_over(logits: torch.Tensor, params_mesh, tp_mesh) -> torch.Tensor:
    """A forward's logits as its caller asked for them. ``tp_mesh=None``:
    the full vocab (gathered when the params are vocab-sharded, as GSPMD
    does for a global array). A mesh: this rank's vocab slice, the form
    ``ops/sampling.py::norm_logits_topk_tp`` takes (sliced from the full
    logits of a whole tree)."""
    if tp_mesh is None:
        return gather_last(logits, params_mesh)
    if params_mesh is None:
        return vocab_slice(logits, tp_mesh) if tp_mesh.tp > 1 else logits
    if params_mesh is not tp_mesh:
        raise ValueError("tp_mesh is not the mesh the params are sharded over")
    return logits


def row_parallel(y: torch.Tensor, mesh, dtype: torch.dtype,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Finish a row-parallel projection: sum the fp32 partials ``y`` over tp,
    then cast to ``dtype`` and add the (replicated) bias once."""
    y = all_reduce(y, mesh).to(dtype)
    return y if bias is None else y + bias.to(dtype)
