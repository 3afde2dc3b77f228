"""Distribution layer (counterpart of ``llmspeculativesampling_tpu/parallel``):
the ``(dp, tp)`` mesh over ``torch.distributed``, the sharding rules, the
multi-process runtime, the tensor-parallel collectives (``comm.py``) and a
rank launcher (``launch.py``)."""

from .distributed import global_mesh, initialize_cluster
from .sharding import (
    DP_AXIS,
    TP_AXIS,
    cache_scale_spec,
    cache_spec,
    llama_param_specs,
    make_mesh,
    opt_param_specs,
    param_specs,
    quant_leaf_spec,
    shard_cache,
    shard_params,
)

__all__ = [
    "DP_AXIS",
    "TP_AXIS",
    "cache_scale_spec",
    "cache_spec",
    "global_mesh",
    "initialize_cluster",
    "llama_param_specs",
    "make_mesh",
    "opt_param_specs",
    "param_specs",
    "quant_leaf_spec",
    "shard_cache",
    "shard_params",
]
