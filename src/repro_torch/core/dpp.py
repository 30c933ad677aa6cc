"""Data-parallel primitives (DPPs): the paper's building-block vocabulary,
the part of it the segmentation path uses, on PyTorch tensors.

Counterpart of ``repro.core.dpp``.  PyTorch has dynamic shapes, but the
compacting primitives keep the reference's padded form (a full-length
array plus a ``count``) so that arrays built from them, such as the hood
arrays, have the reference's shapes.

``reduce_by_key`` is the one primitive with a kernel behind it: float
``add``/``min`` go through ``kernels.ops.segment_reduce`` (the CUDA kernel
for a CUDA tensor) at any segment count; integer values stay on
``index_add_``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Tensor = torch.Tensor

_INT64_MAX = 2**63 - 1


def sort_by_key(keys: Tensor, *values: Tensor) -> Tuple[Tensor, ...]:
    """SortByKey: stable ascending sort of ``keys`` carrying ``values``."""
    sorted_keys, order = torch.sort(keys, stable=True)
    return (sorted_keys,) + tuple(v[order] for v in values)


def compound_key(
    major: Tensor, minor: Tensor, minor_span: int, *, major_span: Optional[int] = None
) -> Tensor:
    """Pack (major, minor) int pairs into one sortable int64 key.

    ``minor_span`` is an exclusive bound on ``minor``.  When ``major_span``
    (exclusive bound on ``major``) is given, the packed key space is
    checked against int64 and an overflow raises instead of mis-sorting.
    The reference packs into int32 unless JAX's 64-bit mode is on; PyTorch
    always has int64, so the bound here is 2**63 - 1.
    """
    if major_span is not None:
        max_key = int(major_span) * int(minor_span) - 1
        if max_key > _INT64_MAX:
            raise OverflowError(
                f"compound_key space {major_span} x {minor_span} does not fit int64"
            )
    return major.to(torch.int64) * minor_span + minor.to(torch.int64)


def reduce_by_key(
    segment_ids: Tensor,
    values: Tensor,
    num_segments: int,
    op: str = "add",
    *,
    backend: Optional[str] = None,
) -> Tensor:
    """ReduceByKey into ``num_segments`` buckets; ids outside
    ``[0, num_segments)`` are dropped.

    Float ``add``/``min`` dispatch to ``kops.segment_reduce`` with
    ``backend`` (ids as int32, the kernel's id type); integer ``add`` runs
    on ``index_add_``.
    """
    if op not in ("add", "min"):
        raise ValueError(f"unknown reduce_by_key op: {op}")
    if values.is_floating_point():
        return kops.segment_reduce(
            values, segment_ids.to(torch.int32), num_segments, op, backend=backend
        )
    if op != "add":
        raise ValueError(f"integer reduce_by_key supports 'add' only, got {op!r}")
    return kref.keyed_sum(values, segment_ids, num_segments)


def unique_(sorted_values: Tensor, *, fill: Any = 0) -> Tuple[Tensor, Tensor]:
    """Unique: drop adjacent duplicates from a sorted 1-D tensor.

    Returns ``(padded_uniques, count)``: the input's length, the first
    ``count`` lanes holding the uniques in order and the rest ``fill``.
    """
    n = sorted_values.shape[0]
    uniq = torch.unique_consecutive(sorted_values)
    out = torch.full((n,), fill, dtype=sorted_values.dtype, device=sorted_values.device)
    out[: uniq.shape[0]] = uniq
    return out, torch.tensor(uniq.shape[0], device=sorted_values.device)


def counts_to_offsets(counts: Tensor) -> Tensor:
    """CSR offsets from per-row counts: length ``n + 1``, int32."""
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64, device=counts.device)
    offsets[1:] = torch.cumsum(counts.to(torch.int64), 0)
    return offsets.to(torch.int32)


def expand_with_rank(counts: Tensor, total: int) -> Tuple[Tensor, Tensor]:
    """The DPP expand idiom: for ``total`` output lanes, the row each lane
    belongs to (row ``i`` repeated ``counts[i]`` times) and its rank within
    the row.  Lanes beyond ``sum(counts)`` get row ``len(counts)`` (an
    out-of-range sentinel) and rank 0.
    """
    n = counts.shape[0]
    dev = counts.device
    counts = counts.to(torch.int64)
    src = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    if src.shape[0] > total:
        raise ValueError(f"expand: sum(counts) = {src.shape[0]} exceeds total = {total}")
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(src.shape[0], device=dev) - starts[src]
    pad = total - src.shape[0]
    src = torch.cat([src, torch.full((pad,), n, dtype=torch.int64, device=dev)])
    rank = torch.cat([rank, torch.zeros((pad,), dtype=torch.int64, device=dev)])
    return src.to(torch.int32), rank.to(torch.int32)


__all__ = [
    "sort_by_key",
    "compound_key",
    "reduce_by_key",
    "unique_",
    "counts_to_offsets",
    "expand_with_rank",
]
