"""Engine-level shared types and helpers
(counterpart of ``llmspeculativesampling_tpu/engine/types.py``; the numpy
helpers are this package's own copies)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..cache.kvcache import init_cache, init_quant_cache
from ..parallel.sharding import local_heads, mesh_of


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Static half of a model: config + forward function.

    ``forward(params, cfg, tokens, cache, positions=None, tree_mask=None,
    tp_mesh=None)`` -> (logits_f32 [B,S,V], cache). ``kv_quant=True``
    selects the int8 KV cache. ``mesh`` (a tensor-parallel mesh, set by
    :meth:`for_params`) makes the caches hold this rank's kv heads."""

    family: str
    cfg: object
    forward: Callable
    kv_quant: bool = False
    mesh: Optional[object] = None

    def for_params(self, params) -> "ModelBundle":
        """This bundle with the mesh ``params`` are sharded over (itself for
        a whole tree), so its caches fit the sharded forward."""
        mesh = mesh_of(params)
        return self if mesh is self.mesh else dataclasses.replace(self, mesh=mesh)

    def make_cache(self, batch: int, max_len: int, device=None):
        c = self.cfg
        window = getattr(c, "sliding_window", None)
        if window is not None and max_len > window and not hasattr(c, "layer_window"):
            raise ValueError(
                f"cache max_len {max_len} exceeds the model's sliding "
                f"window {window}: this decoder implements full attention "
                "and matches the checkpoint only within the window"
            )
        n_kv = local_heads(c, self.mesh)[1]
        if self.kv_quant:
            return init_quant_cache(c.num_layers, batch, n_kv, max_len, c.head_dim, device=device)
        return init_cache(c.num_layers, batch, n_kv, max_len, c.head_dim, c.torch_dtype,
                          device=device)


def aligned_total(n: int, multiple: int = 128) -> int:
    """Round a cache allocation up to a multiple of 128 positions."""
    return -(-n // multiple) * multiple


def pad_prompt(prompt, bucket_multiple: int = 64):
    """Right-pad a [P] (or [1,P]) id list to a static bucket.
    Returns (padded [1, bucket] int32 numpy, true_len int)."""
    ids = np.asarray(prompt, dtype=np.int32).reshape(-1)
    p = ids.shape[0]
    bucket = max(bucket_multiple, -(-p // bucket_multiple) * bucket_multiple)
    out = np.zeros((1, bucket), np.int32)
    out[0, :p] = ids
    return out, p


def first_eos_truncate(tokens: np.ndarray, prompt_len: int, total_len: int, eos_token_id: int) -> np.ndarray:
    """Truncate at the first EOS *after* the prompt, keeping the EOS."""
    seq = np.asarray(tokens).reshape(-1)[:total_len]
    gen = seq[prompt_len:]
    hits = np.nonzero(gen == eos_token_id)[0]
    if hits.size:
        return seq[: prompt_len + hits[0] + 1]
    return seq
