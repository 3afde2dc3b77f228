"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. Nothing is built at
import: the first call that needs a kernel builds it, so CPU-only callers
(the tests) never touch ``nvcc``. Libraries land in ``build/kernels/`` at
the root of the checkout (git-ignored), named by a hash of the source and
flags (the shared ``csrc/*.cuh`` headers included), so an edited source
rebuilds and an unchanged one is reused.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code. No kernel has a backward pass:
:func:`refuse_grad` makes a wrapper raise where autograd would need one,
rather than return an output that silently cuts the gradient.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each build (kept beside the library
# as lib<name>_<hash>.log), for the smoke log
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    # the shared headers count as part of every source (B1 and B4 share a body)
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; returns (proc, tmp, out)."""
    out = _target(name)
    nvcc = _nvcc()  # before the temporary file: a missing nvcc leaves nothing behind
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    BUILD_LOGS[name] = log


def build(names: Iterable[str]) -> None:
    """Compile every missing library among ``names``, all nvcc processes
    started together."""
    with _LOCK:
        todo = [n for n in names if not _target(n).exists()]
        for n in set(names) - set(todo):  # built before: its report lies beside it
            report = _target(n).with_suffix(".log")
            if report.exists():
                BUILD_LOGS[n] = report.read_text()
        started = [(n, *_start(n)) for n in todo]
        try:
            for n, proc, tmp, out in started:
                _finish(n, proc, tmp, out)
        finally:
            for _, proc, _, _ in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and an input of the kernel ``what`` requires
    grad: its output would carry no ``grad_fn``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward pass, and an input requires grad; "
            "run it under torch.no_grad(), or differentiate the plain PyTorch path "
            "(blocks longer than 32 tokens, or CPU tensors)")
