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


def fixed_noise(shape) -> np.ndarray:
    """A deterministic stand-in for Gumbel noise of ``shape``: the Gumbel
    quantiles of a golden-ratio sequence over the flat positions (distinct
    values, so no draw ties), float32."""
    n = int(np.prod(shape, dtype=np.int64))
    u = (np.arange(n, dtype=np.float64) * 0.6180339887498949 + 0.1234) % 1.0
    u = np.clip(u, 1e-6, 1.0 - 1e-6)
    return (-np.log(-np.log(u))).astype(np.float32).reshape(shape)


def patch_noise(monkeypatch, uniform=None):
    """Make every draw of both packages deterministic and equal: the
    Gumbel noise of their samplers (JAX's ``gumbel``, which
    ``categorical`` uses, and the port's ``_gumbel_of``) becomes
    :func:`fixed_noise` of the draw's shape, so each draw is the argmax
    (or the top n) of log-probs plus the same noise on both sides.
    ``uniform`` (a float) also fixes JAX's uniform draws, for the accept
    tests a ``random_seed`` pins on the port's side."""
    import jax.numpy as jnp

    from llmspeculativesampling_tpu_torch.ops import sampling as ts

    def gumbel(key, shape=(), dtype=jnp.float32, *a, **k):
        return jnp.asarray(fixed_noise(tuple(shape)), dtype)

    for mod in (jax.random, jax._src.random):
        monkeypatch.setattr(mod, "gumbel", gumbel)
    monkeypatch.setattr(ts, "_gumbel_of", lambda u: torch.as_tensor(fixed_noise(tuple(u.shape)),
                                                                     device=u.device))
    if uniform is not None:
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.full(
            tuple(shape), uniform, jnp.float32))
