"""The multi-process runtime (counterpart of
``llmspeculativesampling_tpu/parallel/distributed.py``).

One process per rank over ``torch.distributed``: :func:`initialize_cluster`
joins the process group, :func:`global_mesh` lays the ranks out as a
``(dp, tp)`` mesh, :func:`host_fetch` brings a tree of tensors to host
numpy (gathered across dp), :func:`rank0_clock` gives every rank rank 0's
clock. The backend is NCCL when every local rank has a card of its own and
gloo otherwise: on the CPU, and when ranks share one card (NCCL refuses
two ranks on a device; gloo takes CUDA tensors for the collectives the
port uses, ``parallel/comm.py``).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .comm import broadcast, gather_rows
from .sharding import DP_AXIS, Mesh, make_mesh

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


def _whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` gathered across dp on the dimension its ``.sharding`` spec
    names ``DP_AXIS`` (as is otherwise; a tp split stays this rank's)."""
    sh = getattr(x, "sharding", None)
    if sh is None or sh.mesh.dp == 1 or DP_AXIS not in sh.spec:
        return x
    d = sh.spec.index(DP_AXIS)
    return gather_rows(x.movedim(d, 0).contiguous(), sh.mesh).movedim(0, d)


def host_fetch(tree):
    """A tree (dicts, lists, tuples) of tensors as host numpy (JAX
    ``host_fetch``). A tensor split over dp (its ``.sharding`` spec names
    ``DP_AXIS``) is gathered across dp and returned whole on every rank:
    a collective, which every rank of the mesh calls at the same point, as
    the lockstep serving loop guarantees. Replicated values are local."""
    if isinstance(tree, torch.Tensor):
        return _whole(tree).detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: host_fetch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_fetch(v) for v in tree)
    return np.asarray(tree) if isinstance(tree, (int, float)) else tree


def rank0_clock(mesh: Optional[Mesh], device: torch.device) -> float:
    """Global rank 0's ``time.perf_counter()`` on every rank of ``mesh``
    (one broadcast over the whole mesh; the local clock without a mesh or
    on one rank), so that host decisions taken from a clock, as the
    adaptive-gamma controller's are, agree across ranks in lockstep."""
    now = time.perf_counter()
    if mesh is None or mesh.size == 1:
        return now
    t = torch.tensor([now if process_index() == 0 else 0.0], dtype=torch.float64, device=device)
    return float(broadcast(t).item())


def global_mesh(dp: int = 1, tp: Optional[int] = None) -> Mesh:
    """A ``(dp, tp)`` mesh over every rank of the cluster, TP innermost."""
    return make_mesh(dp, tp)
