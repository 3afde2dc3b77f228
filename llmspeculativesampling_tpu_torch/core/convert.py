"""Bit-exact bridge from a JAX param tree (numpy leaves) to the port's params.

The caller turns JAX arrays into numpy first
(``jax.tree.map(np.asarray, params)``), so this module never sees JAX.
The tree keeps its structure: stacked ``[L, ...]`` layer leaves, ``{"q",
"s"}`` quant leaves (``q`` ``[..., K, N]``), a dense ``lm_head`` ``[V, H]``
or quantized ``{"q": [H, V], "s": [V]}``, and optional ``bq/bk/bv``.

bf16 needs care: ``np.asarray`` of a JAX bf16 array is an ``ml_dtypes``
bfloat16 array, which ``torch.from_numpy`` refuses. Its bits are viewed as
``uint16`` and the tensor re-viewed as ``torch.bfloat16``; float8 e4m3 goes
the same way through ``uint8``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device

# numpy dtype name (ml_dtypes' names included) -> (bit-carrier, torch dtype)
_BITCAST = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One numpy array (or scalar) -> tensor on ``device``, bits unchanged."""
    a = np.asarray(a)
    carrier = _BITCAST.get(a.dtype.name)
    if carrier is not None:
        t = torch.from_numpy(np.ascontiguousarray(a).view(carrier[0]).copy())
        t = t.view(carrier[1])
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(resolve_device(device))


def params_from_numpy(tree, device=None):
    """Map :func:`tensor_from_numpy` over nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)
