"""Mesh and sharding rules (counterpart of
``llmspeculativesampling_tpu/parallel/sharding.py``).

A :class:`Mesh` is a ``(dp, tp)`` grid of ``torch.distributed`` ranks, TP
innermost, with this rank's coordinates and its tensor- and data-parallel
process groups. The spec tables are JAX's, leaf for leaf: Megatron column-parallel
qkv/gate/up/fc1 (and Qwen2's qkv biases), row-parallel o/down/fc2,
vocab-parallel ``embed``/``lm_head``, everything else replicated. A spec
is a tuple of axis names or ``None``, one per dimension, as ``P(...)``.

Where JAX places a global array on the mesh and GSPMD inserts the
collectives, here :func:`shard_params` gives each rank a contiguous copy of
its own slice of every leaf, and the forward issues the collectives itself
(``parallel/comm.py``, ``models/llama.py``). Every leaf of a sharded tree
carries ``.sharding`` (a :class:`NamedSharding`), as a JAX array does; the
forward learns its mesh from the embedding's (:func:`mesh_of`).

The data-parallel axis splits the serving state, never the params (which
are replicated over dp): a rank's rows, slots and its ``N/dp``-block half
of each pool (JAX's ``shard_paged_state`` and ``shard_serving_state``).
A serving engine builds each rank's state at its local size and tags it
(``local=True``), so peak memory is one shard's; the whole-state form
narrows a global state, as JAX's placements cut a global array.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..quant.core import QUANT_LEAF_Q, QUANT_LEAF_S, is_quantized_leaf

DP_AXIS = "dp"
TP_AXIS = "tp"

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(eq=False)
class Mesh:
    """A ``(dp, tp)`` grid of ranks. ``ranks[d, t]`` is the global rank at
    (dp index d, tp index t); ``coords`` are this rank's; ``tp_group`` is
    the process group of this rank's tp row, ``ranks[d, :]`` (None when tp
    is 1), and ``dp_group`` that of its tp column, ``ranks[:, t]`` (None
    when dp is 1)."""

    ranks: np.ndarray
    rank: int
    tp_group: object = None
    dp_group: object = None

    axis_names = (DP_AXIS, TP_AXIS)

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.ranks.shape[0], TP_AXIS: self.ranks.shape[1]}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def coords(self) -> Tuple[int, int]:
        d, t = np.argwhere(self.ranks == self.rank)[0]
        return int(d), int(t)

    @property
    def tp(self) -> int:
        return self.ranks.shape[1]

    @property
    def dp(self) -> int:
        return self.ranks.shape[0]

    @property
    def tp_rank(self) -> int:
        return self.coords[1]

    @property
    def dp_rank(self) -> int:
        return self.coords[0]


class NamedSharding(NamedTuple):
    """Where a leaf lives: the mesh and its spec (JAX's ``NamedSharding``)."""

    mesh: Mesh
    spec: Spec


def make_mesh(dp: int = 1, tp: Optional[int] = None) -> Mesh:
    """A ``(dp, tp)`` mesh over every rank of the default process group (one
    rank without one), TP innermost. A collective: every rank calls it, in
    the same order, since each tp row's and each dp column's group is built
    with ``dist.new_group`` by all ranks, rows first."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if tp is None:
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"dp*tp={dp * tp} != {world} ranks")
    ranks = np.arange(world).reshape(dp, tp)

    def groups(lines):
        mine = None
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                mine = group
        return mine

    return Mesh(ranks, rank, groups(ranks) if tp > 1 else None, groups(ranks.T) if dp > 1 else None)


def llama_param_specs(cfg) -> dict:
    """Megatron TP: column-parallel qkv/gate/up, row-parallel o/down,
    vocab-parallel embedding and head; the leading axis of layer weights
    is the stacked layer index (replicated)."""
    col = (None, None, TP_AXIS)  # [L, in, out]: out over tp
    row = (None, TP_AXIS, None)  # [L, in, out]: in over tp
    layers = {
        "wq": col, "wk": col, "wv": col, "wo": row,
        "w_gate": col, "w_up": col, "w_down": row,
        "ln_attn": (None, None), "ln_mlp": (None, None),
    }
    if getattr(cfg, "qkv_bias", False):  # Qwen2: the biases follow the column split
        layers["bq"] = (None, TP_AXIS)
        layers["bk"] = (None, TP_AXIS)
        layers["bv"] = (None, TP_AXIS)
    return {
        "embed": (TP_AXIS, None),
        "lm_head": (TP_AXIS, None),
        "ln_final": (None,),
        "layers": layers,
    }


def opt_param_specs(cfg) -> dict:
    del cfg
    col = (None, None, TP_AXIS)
    row = (None, TP_AXIS, None)
    vec_col = (None, TP_AXIS)
    rep = (None, None)
    return {
        "embed": (TP_AXIS, None),
        "embed_pos": (None, None),
        "layers": {
            "wq": col, "bq": vec_col, "wk": col, "bk": vec_col,
            "wv": col, "bv": vec_col, "wo": row, "bo": rep,
            "ln_attn_w": rep, "ln_attn_b": rep,
            "fc1_w": col, "fc1_b": vec_col, "fc2_w": row, "fc2_b": rep,
            "ln_mlp_w": rep, "ln_mlp_b": rep,
        },
        "ln_final_w": (None,), "ln_final_b": (None,),
    }


def param_specs(family: str, cfg) -> dict:
    return llama_param_specs(cfg) if family == "llama" else opt_param_specs(cfg)


def quant_leaf_spec(spec: Spec) -> dict:
    """The spec of a quantized weight ``{"q": [..., K, N], "s": [..., N]}``
    from its dense ``[..., K, N]`` spec: ``q`` keeps it, ``s`` drops K."""
    spec = tuple(spec)
    s_spec = spec[:-2] + spec[-1:] if len(spec) >= 2 else spec
    return {QUANT_LEAF_Q: spec, QUANT_LEAF_S: s_spec}


def cache_spec() -> Spec:
    """KV cache data [L, B, H_kv, S_max, D]: heads over tp, batch over dp."""
    return (None, DP_AXIS, TP_AXIS, None, None)


def cache_scale_spec() -> Spec:
    """Int8-cache scales [L, B, H_kv, S_max] (no head_dim axis)."""
    return (None, DP_AXIS, TP_AXIS, None)


def place(x: torch.Tensor, spec: Spec, mesh: Mesh, name: str = "",
          local: bool = False) -> torch.Tensor:
    """This rank's slice of ``x`` under ``spec``: a contiguous copy when a
    dimension is split (the full tensor is not kept alive), else a new
    tensor object on the same storage. Tags it with ``.sharding``. A
    dimension that its axis does not divide raises, naming the leaf.
    ``local``: ``x`` already is this rank's slice, and is only tagged."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    if local:
        x.sharding = NamedSharding(mesh, spec)
        return x
    coords = dict(zip(Mesh.axis_names, mesh.coords))
    out = x
    for d, axis in enumerate(spec):
        n = mesh.shape[axis] if axis is not None else 1
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"{name or 'leaf'}: dimension {d} ({x.shape[d]}) is not divisible "
                             f"by {axis}={n}")
        size = x.shape[d] // n
        out = out.narrow(d, coords[axis] * size, size)
    out = out.clone(memory_format=torch.contiguous_format) if out is not x else x.detach()
    out.sharding = NamedSharding(mesh, spec)
    return out


def shard_params(params: dict, specs: dict, mesh: Mesh) -> dict:
    """This rank's shard of a param tree under ``specs``. A quantized
    ``{"q", "s"}`` leaf takes its dense weight's spec through
    :func:`quant_leaf_spec`, so one table serves dense and int8 trees; the
    quantized ``lm_head``, stored transposed ``[H, V]``, takes its spec
    reversed. Leaves without a spec (``specs`` may be a strict subtree) are
    replicated."""

    def walk(p, s, name):
        if is_quantized_leaf(p) and isinstance(s, tuple):
            qs = quant_leaf_spec(s)
            return {k: place(p[k], qs[k], mesh, f"{name}.{k}") for k in (QUANT_LEAF_Q, QUANT_LEAF_S)}
        if isinstance(p, dict):
            return {k: walk(v, s[k], f"{name}.{k}") if k in s else place(v, (), mesh)
                    for k, v in p.items()}
        return place(p, s, mesh, name)

    out = {}
    for k, v in params.items():
        if k in specs:
            s = specs[k]
            if k == "lm_head" and is_quantized_leaf(v):
                s = tuple(reversed(s))
            out[k] = walk(v, s, k)
        else:
            out[k] = walk(v, (), k) if isinstance(v, dict) else place(v, (), mesh, k)
    return out


def shard_for(bundle, params: dict, mesh: Optional[Mesh]) -> dict:
    """``params`` sharded over ``mesh`` under its bundle's family specs: as
    given without a mesh or when already sharded over this one."""
    if mesh is None or mesh_of(params) is mesh:
        return params
    return shard_params(params, param_specs(bundle.family, bundle.cfg), mesh)


def mesh_of(params) -> Optional[Mesh]:
    """The mesh a param tree was sharded over (None for a whole tree)."""
    sh = getattr(params.get("embed"), "sharding", None) if isinstance(params, dict) else None
    return sh.mesh if sh is not None else None


def local_heads(cfg, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(query heads, kv heads) of one rank's shard."""
    tp = mesh.tp if mesh is not None else 1
    n_kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    if cfg.num_heads % tp or n_kv % tp:
        raise ValueError(f"tp={tp} must divide the {cfg.num_heads} heads and {n_kv} kv heads")
    return cfg.num_heads // tp, n_kv // tp


def _shard_fields(obj, specs_by_ndim: dict, mesh: Mesh, local: bool):
    """A dataclass with every tensor field placed by its rank (dims)."""
    changes = {}
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        if isinstance(x, torch.Tensor) and x.dim() in specs_by_ndim:
            changes[f.name] = place(x, specs_by_ndim[x.dim()], mesh, f.name, local)
    return dataclasses.replace(obj, **changes)


def _rows_spec(x: torch.Tensor) -> Spec:
    return (DP_AXIS,) + (None,) * (x.dim() - 1)


def require_divides(n: int, mesh: Optional[Mesh], what: str) -> int:
    """``n // dp``; raises unless dp divides ``n`` (JAX asserts it)."""
    dp = mesh.dp if mesh is not None else 1
    if n % dp:
        raise ValueError(f"{what}={n} must divide over dp={dp}")
    return n // dp


def shard_cache(cache, mesh: Mesh, local: bool = False):
    """A (dense or int8) contiguous KV cache ``[L, B, H_kv, S_max, D]`` at
    this rank's rows (batch over dp) and kv heads (over tp); per-row
    lengths ``[B]`` follow their rows over dp (JAX's ``slot_cache_place``)."""
    specs = {5: cache_spec(), 4: cache_scale_spec(), 1: (DP_AXIS,)}
    return _shard_fields(cache, specs, mesh, local)


def _shard_rows(state, mesh: Mesh, local: bool, **caches):
    """Every row lane of a serving state over dp on its first axis, and the
    given caches as placed."""
    changes = dict(caches)
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        if f.name not in caches and isinstance(x, torch.Tensor):
            changes[f.name] = place(x, _rows_spec(x), mesh, f.name, local)
    return dataclasses.replace(state, **changes)


def shard_serving_state(state, mesh: Mesh, local: bool = False):
    """The slot engine's ``BatchState`` on the mesh (JAX
    ``shard_serving_state``): the slot axis of every lane and cache over
    dp, cache kv heads over tp. ``num_slots % dp`` must be 0."""
    if not local:
        require_divides(state.cur_len.shape[0], mesh, "num_slots")
    return _shard_rows(state, mesh, local,
                       draft_cache=shard_cache(state.draft_cache, mesh, local),
                       target_cache=shard_cache(state.target_cache, mesh, local))


POOL_SPEC = (None, DP_AXIS, TP_AXIS, None, None)  # [L, N+1, H_kv, page, D]
POOL_SCALE_SPEC = (None, DP_AXIS, TP_AXIS, None)  # [L, N+1, H_kv, page]


def _shard_pool(cache, mesh: Mesh, local: bool):
    """A paged cache on the mesh (JAX ``shard_paged_state``'s ``place_pool``):
    pool blocks over dp and kv heads over tp, tables ``[B, P]`` and
    lengths over dp on rows. A whole pool ``[L, N+1, ...]`` gives each dp
    rank its ``N/dp`` blocks plus a trash block of its own, so the sentinel
    is ``N/dp`` there; table values are not rewritten (a whole state's
    are the sentinel's, or shard-local ids)."""
    if not local and mesh.dp > 1:
        fields = {}
        for f in dataclasses.fields(cache):
            x = getattr(cache, f.name)
            if x.dim() >= 4:
                n = require_divides(x.shape[1] - 1, mesh, "num_blocks")
                fields[f.name] = torch.cat([x.narrow(1, mesh.dp_rank * n, n), x[:, n * mesh.dp:]], 1)
        cache = dataclasses.replace(cache, **fields)
        specs = {5: (None, None, TP_AXIS, None, None), 4: (None, None, TP_AXIS, None),
                 2: (DP_AXIS, None), 1: (DP_AXIS,)}
        out = _shard_fields(cache, specs, mesh, False)
        for f in dataclasses.fields(out):  # the blocks are this rank's now
            x = getattr(out, f.name)
            if x.dim() >= 4:
                x.sharding = NamedSharding(mesh, POOL_SPEC if x.dim() == 5 else POOL_SCALE_SPEC)
        return out
    return _shard_fields(cache, {5: POOL_SPEC, 4: POOL_SCALE_SPEC, 2: (DP_AXIS, None),
                                 1: (DP_AXIS,)}, mesh, local)


def shard_paged_state(state, mesh: Mesh, local: bool = False):
    """The paged engine's state on the mesh (JAX ``shard_paged_state``):
    pools ``[L, N+1, H_kv, page, D]`` (int8 scales drop D) at this rank's
    blocks (over dp) and kv heads (over tp); block tables, lengths and
    every row lane over dp on rows."""
    if not local:
        require_divides(state.cur_len.shape[0], mesh, "batch_rows")
    return _shard_rows(state, mesh, local,
                       draft_cache=_shard_pool(state.draft_cache, mesh, local),
                       target_cache=_shard_pool(state.target_cache, mesh, local))
