"""Distributed variants of the DPP vocabulary on ``torch.distributed``.

Counterpart of ``repro.core.dpp_sharded``.  Each rank holds one shard (a
block of the leading axis) and calls the primitive with the same process
group; the cross-shard step is a collective on that group, where the JAX
package names a ``shard_map`` mesh axis.  ``group=None`` is the default
group, as everywhere in ``torch.distributed``.

* Global Scan = local inclusive scan + the exclusive prefix of the shard
  totals (one all-gather of a scalar per shard).
* Global ReduceByKey over a small, globally known segment space = local
  ReduceByKey (the ``segment_reduce`` kernel on the card) + all-reduce;
  no distributed sort.
* The convergence AND is an all-reduce MIN on an int32 flag: NCCL cannot
  reduce ``bool``.

Every collective is blocking and runs on the tensors' device: gloo for
CPU tensors, NCCL for CUDA tensors (one device per rank).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import dpp

Tensor = torch.Tensor
Group = Optional[dist.ProcessGroup]

_REDUCE_OPS = {"add": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _reduce_op(op: str):
    try:
        return _REDUCE_OPS[op]
    except KeyError:
        raise ValueError(f"unknown op {op!r}; have {tuple(_REDUCE_OPS)}") from None


def global_scan(values: Tensor, group: Group, *, exclusive: bool = False) -> Tensor:
    """Prefix sum across the concatenation of every rank's ``values``
    (leading axis, in rank order).

    The result has ``torch.cumsum``'s dtype (int64 for integer and bool
    inputs) on every rank, an empty shard included: its total is built in
    that dtype, so the exchange sees one dtype whatever the occupancy.
    """
    local_inc = torch.cumsum(values, dim=0)
    if values.shape[0] > 0:
        local_total = local_inc[-1].contiguous()
    else:
        local_total = torch.zeros(values.shape[1:], dtype=local_inc.dtype, device=values.device)
    totals = [torch.empty_like(local_total) for _ in range(dist.get_world_size(group))]
    dist.all_gather(totals, local_total, group=group)
    rank = dist.get_rank(group)
    carry = torch.zeros_like(local_total)
    for t in totals[:rank]:
        carry = carry + t
    out = local_inc + carry
    if exclusive:
        out = out - values
    return out


def global_reduce(values: Tensor, group: Group, op: str = "add") -> Tensor:
    """One aggregate (``add``, ``min`` or ``max``) over every element of
    every rank, as a 0-d tensor on each rank."""
    rop = _reduce_op(op)
    local = {"add": torch.sum, "min": torch.min, "max": torch.max}[op](values).reshape(())
    local = local.clone()
    dist.all_reduce(local, op=rop, group=group)
    return local


def global_reduce_by_key(
    segment_ids: Tensor,
    values: Tensor,
    num_segments: int,
    group: Group,
    op: str = "add",
    *,
    backend: Optional[str] = None,
) -> Tensor:
    """Segmented reduction over a global segment id space: every rank
    returns the whole ``(num_segments,)`` result.

    The local reduction goes through ``dpp.reduce_by_key`` (the kernel
    dispatch applies per rank); only the all-reduce crosses ranks.
    """
    rop = _reduce_op(op)
    local = dpp.reduce_by_key(segment_ids, values, num_segments, op=op, backend=backend)
    dist.all_reduce(local, op=rop, group=group)
    return local


def global_all_converged(local_flags: Tensor, group: Group) -> Tensor:
    """AND of every rank's flags, as a 0-d bool tensor on each rank."""
    flag = torch.all(local_flags).to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return flag[0] > 0


def shard_bounds(total: int, group: Group) -> Tuple[int, int]:
    """``(start, stop)`` of this rank's slice of a length-``total`` global
    array under equal block partitioning (the partitioner pads the last
    shard)."""
    per = -(-total // dist.get_world_size(group))
    start = dist.get_rank(group) * per
    return start, min(start + per, total)


__all__ = [
    "global_scan",
    "global_reduce",
    "global_reduce_by_key",
    "global_all_converged",
    "shard_bounds",
]
