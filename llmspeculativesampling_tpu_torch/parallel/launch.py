"""Run one function on N ranks (no JAX counterpart: the JAX package starts
its workers with ``scripts/multihost_worker.py``).

:func:`launch` spawns ``nprocs`` processes with ``torch.multiprocessing``,
joins them in a gloo process group on a free loopback port, runs the case
``"module:function"`` on each with the same arguments and returns the
ranks' results in rank order. Gloo serves both settings it is for: ranks on
the CPU, and ranks that share one card (``device="cuda"``: every rank on
``cuda:0``). Each rank has the same time limit, so a hang fails instead of
stalling; a rank that raises fails the launch; a rank that exits without a
result (a kill drill) is a :class:`RankExit` where ``allow_exit`` says so.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import pickle
import socket
import sys
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the process group's own timeout: above any heartbeat a case sets, so the
# case's watchdog, not the transport, is what notices a lost peer
PG_TIMEOUT_S = 1800.0


@dataclasses.dataclass
class RankExit:
    """A rank that ended without a result, and its exit code."""

    rank: int
    exitcode: int


class RankError(RuntimeError):
    """A rank raised, ended unexpectedly or ran out of time."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(case: str, rank: int, nprocs: int, port: int, device: str, args, queue) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(nprocs),
                      RANK=str(rank))
    code = 1
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        else:
            torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=nprocs,
                                rank=rank, timeout=timedelta(seconds=PG_TIMEOUT_S))
        module, fn = case.split(":")
        out = getattr(importlib.import_module(module), fn)(*args)
        # plain pickle: a tensor goes by value, not as a shared-memory handle
        # that would die with this process
        queue.put((rank, "ok", pickle.dumps(out)))
        code = 0
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        # no teardown: a process group with a lost peer can hang in it
        os._exit(code)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def launch(case: str, nprocs: int = 2, args: tuple = (), *, timeout_s: float = 300.0,
           device: str = "cpu", allow_exit: bool = False) -> list:
    """Run ``case`` ("module:function", importable) on ``nprocs`` ranks and
    return each rank's return value (picklable) in rank order. Every rank
    gets ``timeout_s``."""
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(case, r, nprocs, port, device, args, queue))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    results: dict = {}
    try:
        while len(results) < nprocs:
            while not queue.empty():
                rank, status, payload = queue.get()
                if status == "error":
                    raise RankError(f"rank {rank} of {case} failed:\n{payload}")
                results[rank] = pickle.loads(payload)
            for r, p in enumerate(procs):
                if r not in results and not p.is_alive() and queue.empty():
                    if not allow_exit:
                        raise RankError(f"rank {r} of {case} exited with {p.exitcode} "
                                        "without a result")
                    results[r] = RankExit(r, p.exitcode)
            if time.monotonic() > deadline:
                late = [r for r in range(nprocs) if r not in results]
                raise RankError(f"ranks {late} of {case} exceeded {timeout_s} s")
            time.sleep(0.02)
    finally:
        _stop(procs)
    return [results[r] for r in range(nprocs)]
