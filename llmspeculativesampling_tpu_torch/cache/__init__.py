"""KV caches: the static-shape contiguous cache with O(1) rollback, dense
and int8 (counterpart of ``llmspeculativesampling_tpu/cache``), and the
paged pool (``cache/paged.py``)."""

from .kvcache import (
    KVCache,
    QuantKVCache,
    compact_tree_paths,
    init_cache,
    init_quant_cache,
    repeat_rows,
    rollback,
    select_rows,
    write_layer,
    write_layer_quant,
)

__all__ = [
    "KVCache",
    "QuantKVCache",
    "compact_tree_paths",
    "init_cache",
    "init_quant_cache",
    "repeat_rows",
    "rollback",
    "select_rows",
    "write_layer",
    "write_layer_quant",
]
