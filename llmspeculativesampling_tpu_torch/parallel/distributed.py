"""The multi-process runtime (counterpart of
``llmspeculativesampling_tpu/parallel/distributed.py``).

One process per rank over ``torch.distributed``: :func:`initialize_cluster`
joins the process group, :func:`global_mesh` lays the ranks out as a
``(dp, tp)`` mesh, :func:`host_fetch` brings a tree of tensors to host
numpy. The backend is NCCL when every local rank has a card of its own and
gloo otherwise: on the CPU, and when ranks share one card (NCCL refuses
two ranks on a device; gloo takes CUDA tensors for the collectives the
port uses, ``parallel/comm.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .sharding import Mesh, make_mesh

_HOST_GROUP = []


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def default_backend(num_processes: int) -> str:
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the process group; a no-op for one process. Reads torch's
    standard ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` when
    the arguments are absent. Returns this process's rank."""
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    if num_processes in (None, 1):
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    dist.init_process_group(default_backend(num_processes),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def host_group():
    """The gloo group over every rank that carries host values (the
    lockstep plans of ``serve/multihost.py``): the default group under
    gloo, else one built once (a collective on first use)."""
    if not _HOST_GROUP:
        _HOST_GROUP.append(None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo"))
    return _HOST_GROUP[0]


def host_fetch(tree):
    """A tree (dicts, lists, tuples) of tensors as host numpy. At dp 1
    every rank already holds each replicated value."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: host_fetch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_fetch(v) for v in tree)
    return np.asarray(tree) if isinstance(tree, (int, float)) else tree


def global_mesh(dp: int = 1, tp: Optional[int] = None) -> Mesh:
    """A ``(dp, tp)`` mesh over every rank of the cluster, TP innermost."""
    return make_mesh(dp, tp)
