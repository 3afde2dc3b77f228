"""Shared helpers of the ``tests/test_torch_*.py`` files: carry JAX params
and arrays across to the PyTorch port on the CPU, bit for bit."""

import jax
import numpy as np
import pytest
import torch

from llmspeculativesampling_tpu_torch.core.convert import params_from_numpy


def to_port(tree):
    """JAX param tree (or array) -> the port's CPU tensors, bits unchanged."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def to_np(x) -> np.ndarray:
    """A torch tensor or JAX array -> float32/int numpy for comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "V" or a.dtype.name == "bfloat16" else a


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = to_np(got).astype(np.float64), to_np(ref).astype(np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for a module of tiny-tensor tests: it is the
    fastest setting for them, and it keeps the workers of a parallel test
    run from oversubscribing the cores (each thread pool spins on its
    barriers). Import it into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
