"""Distribution layer: sharding rules on a DeviceMesh + sequence-parallel
attention.  Counterpart of ``repro.parallel``; ``param_shardings``'s
counterpart is the trio ``shard_leaf``, ``gather_leaf`` and
``reduce_grad``."""

from repro_torch.parallel.sharding import (
    batch_specs,
    cache_specs,
    dp_axes,
    gather_leaf,
    param_specs,
    reduce_grad,
    shard_leaf,
)
from repro_torch.parallel.sp_attention import sp_decode_attention, sp_decode_attention_mla

__all__ = [
    "batch_specs",
    "cache_specs",
    "dp_axes",
    "gather_leaf",
    "param_specs",
    "reduce_grad",
    "shard_leaf",
    "sp_decode_attention",
    "sp_decode_attention_mla",
]
